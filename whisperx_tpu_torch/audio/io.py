"""Host-side audio ingest: decode → mono float32 → 16 kHz.

Port of ``whisperx_tpu/audio/io.py`` (reference loader: whisperx/audio.py:
25-65): any input becomes a 1-D float32 numpy waveform in [-1, 1] at 16 kHz.
Decode is I/O, not device compute, so it stays on the host; the
implementation prefers, in order:

1. the native C++ decoder/resampler (``whisperx_tpu_torch.native``) — WAV
   parse + windowed-sinc polyphase resample,
2. the ``ffmpeg`` CLI with the identical s16le pipe contract the reference
   uses, when the binary exists,
3. a pure-numpy RIFF/WAVE parser + scipy polyphase resampler.

``LAST_DECODER`` names the route the latest ``load_audio`` call took
("native", "ffmpeg", "numpy", "npy" or "array").
"""

from __future__ import annotations

import os
import shutil
import struct
import subprocess
from typing import Optional

import numpy as np

from .constants import SAMPLE_RATE

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE

LAST_DECODER: Optional[str] = None


def _decode_wav_bytes(data: bytes) -> tuple[np.ndarray, int]:
    """Parse a RIFF/WAVE byte string → (float32 samples [frames, channels], rate)."""
    if len(data) < 12 or data[:4] not in (b"RIFF", b"RIFX"):
        raise ValueError("not a RIFF/WAVE file")
    big_endian = data[:4] == b"RIFX"
    if data[8:12] != b"WAVE":
        raise ValueError("RIFF file is not WAVE")
    bo = ">" if big_endian else "<"

    pos = 12
    fmt = None
    raw: Optional[bytes] = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack(bo + "I", data[pos + 4 : pos + 8])
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            (tag, channels, rate, _byte_rate, block_align, bits) = struct.unpack(
                bo + "HHIIHH", body[:16]
            )
            if tag == _WAVE_FORMAT_EXTENSIBLE and size >= 40:
                # SubFormat GUID's first two bytes carry the real format tag.
                (tag,) = struct.unpack(bo + "H", body[24:26])
            fmt = (tag, channels, rate, block_align, bits)
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned

    if fmt is None or raw is None:
        raise ValueError("WAVE file missing fmt or data chunk")
    tag, channels, rate, _block_align, bits = fmt
    if channels <= 0:
        raise ValueError("WAVE file has no channels")

    e = ">" if big_endian else "<"
    if tag == _WAVE_FORMAT_IEEE_FLOAT:
        dtype = np.dtype(e + ("f4" if bits == 32 else "f8"))
        samples = np.frombuffer(raw, dtype).astype(np.float32)
    elif tag == _WAVE_FORMAT_PCM:
        if bits == 8:  # 8-bit WAV is unsigned
            samples = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            samples = np.frombuffer(raw, np.dtype(e + "i2")).astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, np.uint8)
            b = b[: (len(b) // 3) * 3].reshape(-1, 3)
            if big_endian:
                b = b[:, ::-1]
            as_i32 = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            as_i32 = (as_i32 << 8) >> 8  # sign-extend
            samples = as_i32.astype(np.float32) / 8388608.0
        elif bits == 32:
            samples = np.frombuffer(raw, np.dtype(e + "i4")).astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"unsupported PCM bit depth: {bits}")
    else:
        raise ValueError(f"unsupported WAVE format tag: 0x{tag:04x}")

    frames = len(samples) // channels
    return samples[: frames * channels].reshape(frames, channels), rate


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample 1-D float32 audio (Kaiser-windowed sinc)."""
    if orig_sr == target_sr:
        return audio.astype(np.float32, copy=False)
    from math import gcd

    g = gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    try:
        from ..native import resample_poly as native_resample

        out = native_resample(audio.astype(np.float32, copy=False), up, down)
        if out is not None:
            return out
    except Exception:
        pass
    from scipy.signal import resample_poly

    return resample_poly(audio.astype(np.float64), up, down).astype(np.float32)


def _load_via_ffmpeg(file: str, sr: int) -> np.ndarray:
    """Identical pipe contract to the reference (whisperx/audio.py:44-61)."""
    cmd = [
        "ffmpeg", "-nostdin", "-threads", "0", "-i", file,
        "-f", "s16le", "-ac", "1", "-acodec", "pcm_s16le", "-ar", str(sr), "-",
    ]
    try:
        out = subprocess.run(cmd, capture_output=True, check=True).stdout
    except subprocess.CalledProcessError as e:  # pragma: no cover
        raise RuntimeError(f"Failed to load audio: {e.stderr.decode()}") from e
    return np.frombuffer(out, np.int16).flatten().astype(np.float32) / 32768.0


def load_audio(file, sr: int = SAMPLE_RATE) -> np.ndarray:
    """Open an audio file and return a mono float32 waveform at `sr` Hz.

    Accepts WAV (any common encoding), ``.npy`` arrays of raw float samples,
    or — when the ffmpeg binary is present — anything ffmpeg can decode.
    """
    global LAST_DECODER
    if isinstance(file, np.ndarray):
        LAST_DECODER = "array"
        return file.astype(np.float32, copy=False)
    file = os.fspath(file)

    if file.endswith(".npy"):
        LAST_DECODER = "npy"
        audio = np.load(file).astype(np.float32)
        if audio.ndim > 1:
            audio = audio.mean(axis=-1)
        return audio

    try:
        from ..native import decode_wav as native_decode

        decoded = native_decode(file)
    except Exception:
        decoded = None
    if decoded is not None:
        LAST_DECODER = "native"
        samples, rate = decoded
    else:
        try:
            with open(file, "rb") as f:
                data = f.read()
            samples, rate = _decode_wav_bytes(data)
            LAST_DECODER = "numpy"
        except ValueError:
            if shutil.which("ffmpeg"):
                LAST_DECODER = "ffmpeg"
                return _load_via_ffmpeg(file, sr)
            raise

    mono = samples.mean(axis=1) if samples.ndim > 1 and samples.shape[1] > 1 else samples.reshape(-1)
    return resample(np.ascontiguousarray(mono, dtype=np.float32), rate, sr)


class AudioPrefetcher:
    """Iterate (path, waveform) with background ingest of upcoming files.

    Wraps the native C++ ingest pool (native/__init__.py:IngestPool — the
    DataLoader-workers equivalent, reference whisperx/asr.py:158-171): while
    the card processes file i, files i+1..i+lookahead decode/downmix/resample
    on host threads. Files the native decoder cannot handle (non-WAV
    containers, .npy) fall back to the synchronous :func:`load_audio` path;
    with no native lib at all this is a plain sequential loop.
    """

    def __init__(self, paths, *, sr: int = SAMPLE_RATE, lookahead: int = 2, threads: int = 2):
        self.paths = list(paths)
        self.sr = sr
        self.lookahead = max(1, lookahead)
        self._jobs = {}
        self._pool = None
        try:
            from ..native import IngestPool

            if self.paths:
                self._pool = IngestPool(threads)
        except Exception:
            self._pool = None

    def _submit(self, idx: int) -> None:
        path = self.paths[idx]
        if self._pool is not None and not str(path).endswith(".npy"):
            self._jobs[idx] = self._pool.submit(path, self.sr)

    def __iter__(self):
        for i in range(min(self.lookahead, len(self.paths))):
            self._submit(i)
        try:
            for i, path in enumerate(self.paths):
                ahead = i + self.lookahead
                if ahead < len(self.paths):
                    self._submit(ahead)
                audio = None
                job = self._jobs.pop(i, None)
                if job is not None:
                    audio = self._pool.get(job)  # None → native decode failed
                if audio is None:
                    audio = load_audio(path, self.sr)
                yield path, audio
        finally:
            self.close()

    def close(self):
        if self._pool is not None:
            self._pool.close()
            self._pool = None


def write_wav(path: str, audio: np.ndarray, sr: int = SAMPLE_RATE) -> None:
    """Write mono float32 audio as 16-bit PCM WAV (test fixtures, debugging)."""
    pcm = np.clip(np.round(np.asarray(audio, dtype=np.float64) * 32768.0), -32768, 32767).astype("<i2")
    body = pcm.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16))
        f.write(b"data" + struct.pack("<I", len(body)) + body)


def pad_or_trim(array, length: int | None = None, *, axis: int = -1):
    """Pad with zeros or truncate `array` to `length` along `axis`.

    Same contract as reference whisperx/audio.py:68-91, on numpy arrays and
    torch tensors alike (a tensor stays on its device).
    """
    from .constants import N_SAMPLES

    if length is None:
        length = N_SAMPLES
    cur = array.shape[axis]
    if cur > length:
        sl = [slice(None)] * array.ndim
        sl[axis] = slice(0, length)
        return array[tuple(sl)]
    if cur < length:
        if isinstance(array, np.ndarray):
            pad_widths = [(0, 0)] * array.ndim
            pad_widths[axis] = (0, length - cur)
            return np.pad(array, pad_widths)
        import torch.nn.functional as F

        # F.pad lists (left, right) pairs from the last dim backwards.
        ax = axis % array.ndim
        pads = [0, 0] * (array.ndim - 1 - ax) + [0, length - cur]
        return F.pad(array, pads)
    return array


def pcm16(audio: np.ndarray) -> np.ndarray:
    """float32 [-1, 1] → int16 PCM for half-size device uploads.

    Audio decoded through the s16le contract (reference audio.py:44-61: ffmpeg
    pipes s16le, /32768) lies exactly on the int16 grid, so this round-trips
    bit-exactly; synthetic float audio quantizes at -90 dB. Device-side code
    (``log_mel_spectrogram``, the alignment forward) divides integer input by
    32768 on the device.
    """
    return np.clip(np.round(audio * 32768.0), -32768, 32767).astype(np.int16)
