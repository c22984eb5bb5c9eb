"""Fused log-mel front end.

Port of ``whisperx_tpu/ops/pallas_mel.py:log_mel_pallas``: (B, n_samples)
audio → reflect-padded frames of 400 at hop 160 → windowed real DFT →
power → mel → log10 with a 1e-10 floor, then the per-row clip to max - 8 and
(x + 4) / 4, as (B, n_mels, n_samples // 160) fp32.

On a CUDA tensor :func:`log_mel_kernel` launches the hand-written Hopper
kernel ``csrc/log_mel.cu`` (or raises); on a CPU tensor it runs its plain
version, the port's ``audio/mel.py:log_mel_spectrogram``.

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

from ..audio.constants import HOP_LENGTH, N_FFT, N_FREQS
from ..audio.mel import _dft_basis, log_mel_spectrogram, mel_filters
from ..device import DeviceLike, resolve_device
from . import _build

_BINS_PADDED = 224  # the kernel's bins per half (7 x 32 lanes)

# Kernel launches since the last reset (chip_smoke.py zeroes and reads it).
# One launch is one call: the tile kernel and its clip-and-scale epilogue.
launches = 0


@functools.lru_cache(maxsize=8)
def _tables(n_mels: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(basis (400, 2 x 224): cos | -sin, each zero-padded from 201 bins;
    filters transposed (201, n_mels)), fp32 on ``device``."""
    dft = _dft_basis()  # (400, 402)
    basis = np.zeros((N_FFT, 2 * _BINS_PADDED), np.float32)
    basis[:, :N_FREQS] = dft[:, :N_FREQS]
    basis[:, _BINS_PADDED : _BINS_PADDED + N_FREQS] = dft[:, N_FREQS:]
    filt = np.ascontiguousarray(mel_filters(n_mels).T)
    return torch.from_numpy(basis).to(device), torch.from_numpy(filt).to(device)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("log_mel")
    lib.log_mel.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
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
    basis, filt = _tables(n_mels, dev)
    out = torch.empty((B, n_mels, n // HOP_LENGTH), dtype=torch.float32, device=dev)
    row_max = torch.empty((B,), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        code = lib.log_mel(
            x.data_ptr(),
            int(x.dtype == torch.int16),
            basis.data_ptr(),
            filt.data_ptr(),
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
