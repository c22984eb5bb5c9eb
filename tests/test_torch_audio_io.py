"""whisperx_tpu_torch's audio ingest against the JAX package's: load_audio on
every WAV encoding the parser reads, resampling, .npy input, the native C++
decoder and resampler (each package builds its own copy), pad_or_trim and
the WAV writer."""

import struct

import numpy as np
import pytest
import torch

from whisperx_tpu import native as j_native
from whisperx_tpu.audio import io as jio
from whisperx_tpu_torch import native as t_native
from whisperx_tpu_torch.audio import io as tio

SR = 16000


def _signal(n, channels=1, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = 0.5 * np.sin(2 * np.pi * 440 * t)[:, None] + 0.05 * rng.standard_normal((n, channels))
    return np.clip(x, -0.99, 0.99)


def _write(path, x, *, rate=SR, bits=16, fmt="pcm", big_endian=False, extensible=False):
    """RIFF/RIFX WAVE writer for the encodings the decoders read."""
    n, channels = x.shape
    e = ">" if big_endian else "<"
    if fmt == "float":
        tag, body = 3, x.astype(e + ("f4" if bits == 32 else "f8")).tobytes()
    elif bits == 8:
        tag, body = 1, np.round(x * 127 + 128).astype(np.uint8).tobytes()
    elif bits == 24:
        v = np.round(x * 8388607).astype(np.int32).reshape(-1)
        b = np.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF], axis=1).astype(np.uint8)
        tag, body = 1, (b[:, ::-1] if big_endian else b).tobytes()
    else:
        tag, body = 1, np.round(x * (2 ** (bits - 1) - 1)).astype(e + f"i{bits // 8}").tobytes()
    block = channels * bits // 8
    if extensible:
        fmt_body = struct.pack(e + "HHIIHH", 0xFFFE, channels, rate, rate * block, block, bits)
        guid = struct.pack(e + "H", tag) + b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"
        fmt_body += struct.pack(e + "HHI", 22, bits, 0) + guid
    else:
        fmt_body = struct.pack(e + "HHIIHH", tag, channels, rate, rate * block, block, bits)
    with open(path, "wb") as f:
        f.write((b"RIFX" if big_endian else b"RIFF") + struct.pack(e + "I", 4 + 8 + len(fmt_body) + 8 + len(body)) + b"WAVE")
        f.write(b"fmt " + struct.pack(e + "I", len(fmt_body)) + fmt_body)
        f.write(b"data" + struct.pack(e + "I", len(body)) + body)
    return str(path)


CASES = {
    "pcm8": dict(bits=8),
    "pcm16": dict(bits=16),
    "pcm24": dict(bits=24),
    "pcm32": dict(bits=32),
    "float32": dict(bits=32, fmt="float"),
    "stereo pcm16": dict(bits=16, channels=2),
    "rifx pcm16": dict(bits=16, big_endian=True),
    "rifx pcm24": dict(bits=24, big_endian=True),
    "extensible pcm24": dict(bits=24, extensible=True),
    "extensible float32 stereo": dict(bits=32, fmt="float", extensible=True, channels=2),
    "44.1 kHz pcm16, resampled": dict(bits=16, rate=44100),
    "8 kHz stereo float32, resampled": dict(bits=32, fmt="float", rate=8000, channels=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_load_audio_equal(tmp_path, case):
    kw = dict(CASES[case])
    channels = kw.pop("channels", 1)
    rate = kw.get("rate", SR)
    path = _write(tmp_path / "a.wav", _signal(rate // 2 + 7, channels), **kw)
    got = tio.load_audio(path)
    want = jio.load_audio(path)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert len(got) == pytest.approx((rate // 2 + 7) * SR / rate, abs=1)
    with open(path, "rb") as f:
        data = f.read()
    (g, g_rate), (w, w_rate) = tio._decode_wav_bytes(data), jio._decode_wav_bytes(data)
    assert g_rate == w_rate == rate
    np.testing.assert_array_equal(g, w)


def test_numpy_fallback_equal(tmp_path, monkeypatch):
    """Without the native library both packages take the numpy parser and
    scipy's resampler."""
    path = _write(tmp_path / "b.wav", _signal(30_000, 2), bits=24, rate=44100)
    monkeypatch.setattr(t_native, "decode_wav", lambda p: None)
    monkeypatch.setattr(t_native, "resample_poly", lambda *a: None)
    monkeypatch.setattr(j_native, "decode_wav", lambda p: None)
    monkeypatch.setattr(j_native, "resample_poly", lambda *a: None)
    got = tio.load_audio(path)
    assert tio.LAST_DECODER == "numpy"
    np.testing.assert_array_equal(got, jio.load_audio(path))


def test_npy_and_array_input(tmp_path):
    x = _signal(8000, 2).astype(np.float32)
    for arr in (x, x[:, 0]):
        p = tmp_path / f"a{arr.ndim}.npy"
        np.save(p, arr)
        np.testing.assert_array_equal(tio.load_audio(str(p)), jio.load_audio(str(p)))
        assert tio.LAST_DECODER == "npy"
    np.testing.assert_array_equal(tio.load_audio(x[:, 0]), jio.load_audio(x[:, 0]))
    assert tio.LAST_DECODER == "array"


def test_native_decoder_and_resampler_equal(tmp_path):
    assert t_native.available() and j_native.available()
    assert t_native._LIB_PATH != j_native._LIB_PATH
    path = _write(tmp_path / "c.wav", _signal(20_000, 2), bits=16)
    (g, gr), (w, wr) = t_native.decode_wav(path), j_native.decode_wav(path)
    assert gr == wr == SR and g.shape == (20_000, 2)
    np.testing.assert_array_equal(g, w)
    assert tio.load_audio(path) is not None and tio.LAST_DECODER == "native"
    x = _signal(44_100)[:, 0].astype(np.float32)
    for up, down in ((160, 441), (2, 1), (1, 3)):
        np.testing.assert_array_equal(t_native.resample_poly(x, up, down), j_native.resample_poly(x, up, down))
    assert t_native.decode_wav(str(tmp_path / "missing.wav")) is None


def test_prefetcher_equal(tmp_path):
    paths = []
    for i, rate in enumerate((16000, 8000, 44100)):
        paths.append(_write(tmp_path / f"p{i}.wav", _signal(rate // 3, 1, seed=i), rate=rate))
    np.save(tmp_path / "p.npy", _signal(5000)[:, 0].astype(np.float32))
    paths.append(str(tmp_path / "p.npy"))
    got = list(tio.AudioPrefetcher(paths, lookahead=2))
    want = list(jio.AudioPrefetcher(paths, lookahead=2))
    assert [p for p, _ in got] == [p for p, _ in want] == paths
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_write_wav_and_pcm16_equal(tmp_path):
    x = (_signal(12_345)[:, 0] * 1.5).astype(np.float32)  # clips at ±1
    tio.write_wav(str(tmp_path / "t.wav"), x)
    jio.write_wav(str(tmp_path / "j.wav"), x)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    np.testing.assert_array_equal(tio.pcm16(x), jio.pcm16(x))
    np.testing.assert_array_equal(tio.load_audio(str(tmp_path / "t.wav")), tio.pcm16(x) / np.float32(32768.0))


@pytest.mark.parametrize("length,axis", [(None, -1), (100, -1), (700, -1), (3, 0), (9, 0), (5, 1)])
def test_pad_or_trim_numpy_and_torch(length, axis):
    x = np.random.default_rng(1).standard_normal((5, 600)).astype(np.float32)
    want = jio.pad_or_trim(x, length, axis=axis)
    np.testing.assert_array_equal(tio.pad_or_trim(x, length, axis=axis), want)
    got = tio.pad_or_trim(torch.from_numpy(x), length, axis=axis)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)
    ints = tio.pcm16(x)
    got16 = tio.pad_or_trim(torch.from_numpy(ints), length, axis=axis)
    assert got16.dtype == torch.int16
    np.testing.assert_array_equal(got16.numpy(), jio.pad_or_trim(ints, length, axis=axis))
