"""Fused log-mel front end.

Port of ``whisperx_tpu/ops/pallas_mel.py:log_mel_pallas``: (B, n_samples)
audio → reflect-padded frames of 400 at hop 160 → windowed real DFT →
power → mel → log10 with a 1e-10 floor, then the per-row clip to max - 8 and
(x + 4) / 4, as (B, n_mels, n_samples // 160) fp32.

On a CUDA tensor :func:`log_mel_kernel` launches the hand-written Hopper
kernel ``csrc/log_mel.cu`` (or raises); on a CPU tensor it runs its plain
version, the port's ``audio/mel.py:log_mel_spectrogram``. The kernel runs
the DFT as a 20 x 20 Cooley-Tukey FFT and the filterbank as bands; the
tables it is handed are built here (:func:`fft_tables`, :func:`mel_bands`)
and the CPU tests check them.

Input scaling follows ``audio/mel.py``, which the decode path uses: int16 PCM
is divided by 32768 (on the card, inside the kernel). ``log_mel_pallas``
casts int16 to float32 *without* dividing, so the two agree on float input
only.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..audio.constants import HOP_LENGTH, N_FFT
from ..audio.mel import log_mel_spectrogram, mel_filters
from ..device import DeviceLike, resolve_device
from . import _build

FFT_RADIX = 20  # the kernel's real DFT of 400 is split as 20 x 20
MAX_TAPS = 16  # the kernel's widest mel band (14 bins at n_mels 80, 9 at 128)

# Kernel launches since the last reset (chip_smoke.py zeroes and reads it).
# One launch is one call: the tile kernel and its clip-and-scale epilogue.
launches = 0


@functools.cache
def fft_tables() -> tuple[np.ndarray, np.ndarray]:
    """The kernel's FFT tables, built in float64 and rounded to float32.

    Returns (dft20, tables): ``dft20`` (2, 20) is cos | sin of 2 pi j / 20
    (the coefficients of both stages' DFT-20s, exact zeros where they are
    zero); ``tables`` (1200,) is the periodic Hann window (400), then the
    twiddles W400^(n2 k1) = exp(-2 pi i n2 k1 / 400) as real (20 x 20) and
    imaginary (20 x 20) parts, laid out [k1][n2].
    """
    r = FFT_RADIX
    ang = 2.0 * np.pi * np.arange(r, dtype=np.float64) / r
    dft20 = np.stack([np.cos(ang), np.sin(ang)])
    dft20[np.abs(dft20) < 1e-12] = 0.0
    n = np.arange(N_FFT, dtype=np.float64)
    hann = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / N_FFT))
    k1, n2 = np.meshgrid(np.arange(r), np.arange(r), indexing="ij")
    tw = np.exp(-2j * np.pi * (n2 * k1) / N_FFT)
    tables = np.concatenate([hann, tw.real.ravel(), tw.imag.ravel()])
    return dft20.astype(np.float32), tables.astype(np.float32)


@functools.lru_cache(maxsize=None)
def mel_bands(n_mels: int) -> tuple[np.ndarray, np.ndarray]:
    """The filterbank as bands: (band (2, n_mels) int32: first bin | number of
    bins, taps (n_mels, 16) float32 zero-padded). Every filter's nonzero taps
    are one contiguous run of bins, so the band rebuilds ``mel_filters``."""
    filt = mel_filters(n_mels)
    band = np.zeros((2, n_mels), np.int32)
    taps = np.zeros((n_mels, MAX_TAPS), np.float32)
    for m, row in enumerate(filt):
        nz = np.flatnonzero(row)
        start, length = (int(nz[0]), int(nz[-1] - nz[0] + 1)) if nz.size else (0, 0)
        if length > MAX_TAPS:
            raise ValueError(f"mel band {m} of {n_mels} spans {length} bins; the kernel takes at most {MAX_TAPS}")
        band[:, m] = start, length
        taps[m, :length] = row[start : start + length]
    return band, taps


@functools.lru_cache(maxsize=8)
def _device_tables(n_mels: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(FFT tables (1200,), band (2, n_mels) int32, taps (n_mels, 16)) on ``device``."""
    band, taps = mel_bands(n_mels)
    return tuple(torch.from_numpy(a).to(device) for a in (fft_tables()[1], band, taps))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("log_mel")
    lib.log_mel.argtypes = (
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    )
    lib.log_mel.restype = ctypes.c_int
    return lib


def log_mel_kernel(audio, n_mels: int = 80, *, device: DeviceLike = None) -> torch.Tensor:
    """Whisper log-mel features through the fused kernel.

    Args:
      audio: (n_samples,) or (batch, n_samples) float in [-1, 1] or int16
        PCM, a numpy array or a tensor; n_samples a multiple of 160 and above
        200 (the reflect padding needs 200 samples on each side).
      n_mels: 80 or 128.
      device: where to compute; ``None`` means the card.

    Returns (n_mels, n_frames) or (batch, n_mels, n_frames) float32.
    """
    global launches
    dev = resolve_device(device)
    x = torch.as_tensor(audio)
    squeeze = x.ndim == 1
    x = x[None, :] if squeeze else x
    if not (x.ndim == 2 and x.shape[1] % HOP_LENGTH == 0 and x.shape[1] > N_FFT // 2):
        raise ValueError(f"log_mel_kernel: audio {tuple(x.shape)} must be (B, n) with n % 160 == 0 and n > 200")
    if x.dtype not in (torch.int16, torch.float32):
        x = x.float()
    x = x.to(dev).contiguous()
    if dev.type == "cpu":
        out = log_mel_spectrogram(x, n_mels=n_mels, device=dev)
        return out[0] if squeeze else out
    B, n = x.shape
    tables, band, taps = _device_tables(n_mels, dev)
    out = torch.empty((B, n_mels, n // HOP_LENGTH), dtype=torch.float32, device=dev)
    row_max = torch.empty((B,), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        code = lib.log_mel(
            x.data_ptr(),
            int(x.dtype == torch.int16),
            fft_tables()[0].ctypes.data,
            tables.data_ptr(),
            band.data_ptr(),
            taps.data_ptr(),
            out.data_ptr(),
            row_max.data_ptr(),
            B,
            n,
            n_mels,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, code, "log_mel")
    launches += 1
    return out[0] if squeeze else out
