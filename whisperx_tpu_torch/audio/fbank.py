"""Kaldi-style log-mel filterbank features (the speaker-embedding front end).

Port of ``whisperx_tpu/audio/fbank.py``. The reference's diarization rides
pyannote speaker-diarization-3.1 (whisperx/diarize.py:19,28), whose
embedding model (WeSpeaker ResNet34) consumes *kaldi* fbank features — a
different recipe from Whisper's log-mel (audio/mel.py): int16 scaling,
per-frame DC removal, pre-emphasis 0.97, hamming window, power spectrum
without FFT normalization, kaldi (HTK-scale) triangular mel banks over
20 Hz..Nyquist, natural log, and per-utterance mean normalization.

The tables (``_window``, ``_dft_basis``, ``kaldi_mel_banks``) are numpy and
the JAX package's own code. ``kaldi_fbank`` runs on the device of its input
tensor (or the one it is given): frames are an ``unfold``, and the
window→DFT→mel chain is two ``torch.matmul`` with the precomputed tables, as
the JAX package computes it outside any Pallas kernel.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

SAMPLE_RATE = 16000
FRAME_LENGTH = 400  # 25 ms
FRAME_SHIFT = 160  # 10 ms
PADDED_WINDOW = 512  # next power of two
PREEMPHASIS = 0.97
EPSILON = 1.1920928955078125e-07  # float32 machine eps (kaldi log floor)


def _window(window_type: str, n: int) -> np.ndarray:
    a = 2 * math.pi / (n - 1)
    i = np.arange(n)
    if window_type == "hamming":
        return 0.54 - 0.46 * np.cos(a * i)
    if window_type == "hanning":
        return 0.5 - 0.5 * np.cos(a * i)
    if window_type == "povey":  # kaldi default: hann ** 0.85
        return (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    raise ValueError(f"unknown window {window_type!r}")


@functools.lru_cache(maxsize=4)
def _dft_basis(window_type: str) -> np.ndarray:
    """(FRAME_LENGTH, 2*(PADDED_WINDOW//2+1)) windowed real-DFT basis.

    Zero-padding to 512 means only the first 400 rows of the padded DFT
    matter, so window ∘ DFT collapses into one (400, 514) matmul operand.
    """
    win = _window(window_type, FRAME_LENGTH)
    n_bins = PADDED_WINDOW // 2 + 1
    t = np.arange(FRAME_LENGTH)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2 * math.pi * t * k / PADDED_WINDOW
    basis = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1)  # (400, 2*257)
    return (basis * win[:, None]).astype(np.float32)


@functools.lru_cache(maxsize=4)
def kaldi_mel_banks(num_bins: int = 80, low_freq: float = 20.0, high_freq: float = 0.0):
    """(num_bins, PADDED_WINDOW//2+1) kaldi triangular mel filterbank.

    HTK mel scale 1127·ln(1+f/700); centers equally spaced in mel between
    low_freq and high_freq (≤0 → offset from Nyquist); the Nyquist bin never
    contributes (kaldi computes energies over fft/2 bins).
    """
    nyquist = SAMPLE_RATE / 2.0
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq

    def mel(f):
        return 1127.0 * np.log(1.0 + f / 700.0)

    mel_low, mel_high = mel(low_freq), mel(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    centers = mel_low + np.arange(num_bins + 2) * mel_delta  # edges+peaks

    n_fft_bins = PADDED_WINDOW // 2
    fft_freqs = np.arange(n_fft_bins) * (SAMPLE_RATE / PADDED_WINDOW)
    fft_mels = mel(fft_freqs)[None, :]  # (1, 256)

    left = centers[:-2, None]
    center = centers[1:-1, None]
    right = centers[2:, None]
    up = (fft_mels - left) / (center - left)
    down = (right - fft_mels) / (right - center)
    banks = np.maximum(0.0, np.minimum(up, down)).astype(np.float32)
    # Pad the (zero) Nyquist column so the matmul consumes all 257 bins.
    return np.concatenate([banks, np.zeros((num_bins, 1), np.float32)], axis=1)


@functools.lru_cache(maxsize=8)
def _tables(window_type: str, num_mel_bins: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(DFT basis (400, 514), mel banks transposed (257, num_mel_bins)) on ``device``."""
    basis = torch.from_numpy(_dft_basis(window_type)).to(device)
    banks_t = torch.from_numpy(kaldi_mel_banks(num_mel_bins)).t().contiguous().to(device)
    return basis, banks_t


@torch.inference_mode()
def kaldi_fbank(
    wavs,  # (B, T) float waveforms in [-1, 1]
    num_mel_bins: int = 80,
    window_type: str = "hamming",
    mean_norm: bool = True,
    *,
    device: DeviceLike = None,
) -> torch.Tensor:
    """(B, T) → (B, num_frames, num_mel_bins) kaldi log-fbank features, fp32.

    ``window_type="hamming"`` and int16 scaling match pyannote's WeSpeaker
    feature wrapper; ``mean_norm`` applies its per-window cepstral mean
    subtraction. snip_edges semantics: num_frames = 1 + (T-400)//160.
    A tensor stays on its device; a numpy array goes to ``device``
    (``None`` means the card).
    """
    if isinstance(wavs, torch.Tensor) and device is None:
        dev = wavs.device
    else:
        dev = resolve_device(device)
    x = torch.as_tensor(wavs).to(dev, torch.float32)
    if x.ndim == 1:
        x = x[None]
    x = x * 32768.0  # (1 << 15) int16 scaling

    frames = x.unfold(1, FRAME_LENGTH, FRAME_SHIFT)  # (B, F, 400)
    # Per-frame DC offset removal.
    frames = frames - frames.mean(dim=-1, keepdim=True)
    # Pre-emphasis x[i] -= 0.97·x[i-1] (kaldi convention: x[-1] ≡ x[0]).
    shifted = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = frames - PREEMPHASIS * shifted

    basis, banks_t = _tables(window_type, num_mel_bins, dev)
    spec = torch.matmul(frames, basis)  # (B, F, 514)
    n_bins = PADDED_WINDOW // 2 + 1
    power = spec[..., :n_bins] ** 2 + spec[..., n_bins:] ** 2
    feats = torch.log(torch.clamp(torch.matmul(power, banks_t), min=EPSILON))
    if mean_norm:
        feats = feats - feats.mean(dim=1, keepdim=True)
    return feats
