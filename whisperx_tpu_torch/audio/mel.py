"""Log-mel front-end in PyTorch.

Port of ``whisperx_tpu/audio/mel.py:58-154`` (reference front-end:
whisperx/audio.py:112-159): centered reflect-padded Hann STFT (N_FFT=400,
HOP=160) with the final frame dropped, power spectrum, Slaney-normalized mel
projection, ``log10`` with a 1e-10 floor, per-sample clip to ``max - 8`` and
``(x + 4) / 4``.

The JAX package frames with one strided convolution. Here the frames come from
``unfold`` and the windowed real DFT is a ``matmul``: an fp32 convolution on
CUDA runs through cuDNN in TF32 by default (``torch.backends.cudnn.allow_tf32``
is True), which keeps about three decimal digits ahead of a ``log10``. A fp32
``matmul`` runs in full fp32 as long as
``torch.backends.cuda.matmul.allow_tf32`` keeps its default (False); callers
that turn TF32 on for matmuls change this function's numbers.

This is plain PyTorch, the front end by default, as in the JAX package. The
fused kernel (``ops/mel.py:log_mel_kernel``, the counterpart of
``ops/pallas_mel.py:log_mel_pallas``) computes the same function and uses
this one as its plain version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from .constants import HOP_LENGTH, N_FFT, N_FREQS, SAMPLE_RATE


def _hz_to_mel(freq: np.ndarray) -> np.ndarray:
    """Slaney-style (librosa default, htk=False) Hz→mel."""
    freq = np.asarray(freq, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = freq >= min_log_hz
    mels = np.where(log_t, min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep, mels)
    return mels


def _mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = mels >= min_log_mel
    return np.where(log_t, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


@functools.lru_cache(maxsize=None)
def mel_filters(n_mels: int, sr: int = SAMPLE_RATE, n_fft: int = N_FFT) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_mels, n_fft//2+1).

    Matches ``librosa.filters.mel(sr=16000, n_fft=400, n_mels=n_mels)`` — the
    matrices the reference ships as ``assets/mel_filters.npz``
    (whisperx/audio.py:94-109) — to float32 precision.
    """
    fmax = sr / 2.0
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(fmax), n_mels + 2))

    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney normalization: each filter integrates to ~constant energy.
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dft_basis(n_fft: int = N_FFT) -> np.ndarray:
    """Windowed real-DFT basis, shape (n_fft, 2*n_freqs): [cos | -sin] columns.

    ``frames @ basis`` yields the (real, imag) halves of the one-sided DFT of
    Hann-windowed frames; the periodic Hann window is folded into the basis.
    """
    n = np.arange(n_fft, dtype=np.float64)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))  # periodic Hann
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(n, k) / n_fft
    basis = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1)  # (n_fft, 2*n_freqs)
    return (basis * window[:, None]).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _tables(n_mels: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(DFT basis (n_fft, 2*n_freqs), mel filters transposed (n_freqs, n_mels))
    resident on ``device``."""
    basis = torch.from_numpy(_dft_basis()).to(device)
    filters_t = torch.from_numpy(mel_filters(n_mels)).t().contiguous().to(device)
    return basis, filters_t


@torch.inference_mode()
def log_mel_spectrogram(
    audio, n_mels: int = 80, padding: int = 0, *, device: DeviceLike = None
) -> torch.Tensor:
    """Whisper log-mel features.

    Args:
      audio: waveform (n_samples,) or (batch, n_samples), a numpy array or a
        tensor. float in [-1, 1], or int16 PCM (divided by 32768 on the
        device, so the upload is half the bytes). The sample count must be a
        multiple of HOP_LENGTH (30 s = 480000 on the standard path).
      n_mels: 80 (most models) or 128 (large-v3).
      padding: zero samples appended before the STFT.
      device: where to compute; ``None`` means the card.

    Returns:
      (n_mels, n_frames) or (batch, n_mels, n_frames) float32, where
      n_frames = (n_samples + padding) // HOP_LENGTH.
    """
    dev = resolve_device(device)
    x = torch.as_tensor(audio).to(dev)
    squeeze = x.ndim == 1
    x = x[None, :] if squeeze else x
    if x.dtype.is_floating_point:
        x = x.float()
    else:
        x = x.float() / 32768.0
    if padding > 0:
        x = F.pad(x, (0, padding))

    n_frames = x.shape[1] // HOP_LENGTH  # the final (n_frames+1)th frame is dropped
    half = N_FFT // 2
    # torch.stft(center=True) semantics: reflect padding of n_fft//2 per end.
    x = F.pad(x[:, None, :], (half, half), mode="reflect")[:, 0, :]
    frames = x.unfold(-1, N_FFT, HOP_LENGTH)[:, :n_frames]  # (B, T, n_fft)

    basis, filters_t = _tables(n_mels, dev)
    spec = torch.matmul(frames, basis)  # (B, T, 2*n_freqs)
    power = spec[..., :N_FREQS] ** 2 + spec[..., N_FREQS:] ** 2
    mel = torch.matmul(power, filters_t).transpose(1, 2)  # (B, n_mels, T)

    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    # Per-sample dynamic range clip (the reference computes mel per chunk).
    max_per_sample = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, max_per_sample - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return log_spec[0] if squeeze else log_spec
