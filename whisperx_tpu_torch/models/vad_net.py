"""The PyanNet segmentation network (VAD and diarization segmentation).

Port of ``whisperx_tpu/models/vad_net.py`` as ``nn.Module``s:

  waveform → InstanceNorm → SincNet (sinc band-pass conv s10 → |·| → maxpool3
  → InstanceNorm → leaky-ReLU; two plain conv blocks) → 4-layer BiLSTM(128)
  → 2×Linear(128)+leaky-ReLU → Linear(num_classes) → sigmoid.

The modules carry the pyannote checkpoint's names (``sincnet.wav_norm1d``,
``sincnet.conv1d.<i>``, ``sincnet.norm1d.<i>``, ``lstm``, ``linear.<i>``,
``classifier``), so ``state_dict()`` is in the layout
``models/convert.py:convert_pyannet`` reads. Activations run NCT through the
SincNet and (B, T, C) through the LSTM. The sinc filterbank is built on the
device each call from (low_hz, band_hz), exactly as the JAX module builds it;
the LSTM is one ``nn.LSTM`` (PyTorch's gate order i, f, g, o, as the JAX
layer uses; each direction reads the same input and the two outputs are
concatenated). The convolutions and the LSTM are cuDNN calls on the card:
the JAX package runs them as XLA ops, outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# Conv stack geometry (matches the PyanNet SincNet recipe).
SINC_FILTERS = 80
SINC_KERNEL = 251
SINC_STRIDE = 10
FRAME_STEP = 270  # samples between output frames (10*3*3*3)
FRAME_SIZE = 991  # receptive field in samples


def num_frames(n_samples: int) -> int:
    t = (n_samples - SINC_KERNEL) // SINC_STRIDE + 1
    t = t // 3
    t = t - 4
    t = t // 3
    t = t - 4
    return t // 3


def frame_centers(n_samples: int, sample_rate: int = 16000) -> np.ndarray:
    """Center time (s) of each output frame's receptive field."""
    n = num_frames(n_samples)
    return ((np.arange(n) * FRAME_STEP) + FRAME_SIZE / 2) / sample_rate


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalization over time (affine), on (B, C, T):
    biased variance, eps 1e-5."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, unbiased=False, keepdim=True)
        return (x - mean) * torch.rsqrt(var + 1e-5) * self.weight[:, None] + self.bias[:, None]


def _mel_spaced_hz(n: int) -> np.ndarray:
    """n + 1 mel-spaced band edges (the standard SincNet init)."""
    low_hz, high_hz = 30.0, 16000 / 2 - 130.0
    mel = np.linspace(2595 * np.log10(1 + low_hz / 700), 2595 * np.log10(1 + high_hz / 700), n + 1)
    return 700 * (10 ** (mel / 2595) - 1)


class SincConv(nn.Module):
    """Learnable band-pass filterbank (SincNet); filters built on the device."""

    def __init__(
        self,
        filters: int = SINC_FILTERS,
        kernel: int = SINC_KERNEL,
        stride: int = SINC_STRIDE,
        sample_rate: int = 16000,
        min_low_hz: float = 50.0,
        min_band_hz: float = 50.0,
    ):
        super().__init__()
        hz = _mel_spaced_hz(filters)
        self.low_hz_ = nn.Parameter(torch.tensor(hz[:-1, None], dtype=torch.float32))
        self.band_hz_ = nn.Parameter(torch.tensor(np.diff(hz)[:, None], dtype=torch.float32))
        self.kernel, self.stride, self.sample_rate = kernel, stride, sample_rate
        self.min_low_hz, self.min_band_hz = min_low_hz, min_band_hz

    def filters(self) -> torch.Tensor:
        """(filters, kernel) band-pass filters."""
        low = self.min_low_hz + torch.abs(self.low_hz_)
        high = torch.clamp(low + self.min_band_hz + torch.abs(self.band_hz_), self.min_low_hz, self.sample_rate / 2)
        band = (high - low)[:, 0]

        half = (self.kernel - 1) // 2
        dev = self.low_hz_.device
        n = torch.arange(-half, 0, dtype=torch.float32, device=dev)[None, :]  # left half
        n_2pi = 2 * math.pi * n / self.sample_rate
        # Hamming window over the left half.
        window = 0.54 - 0.46 * torch.cos(
            2 * math.pi * torch.arange(half, dtype=torch.float32, device=dev) / self.kernel
        )[None, :]

        f_low = low * n_2pi  # (filters, half)
        f_high = high * n_2pi
        bp_left = ((torch.sin(f_high) - torch.sin(f_low)) / (n_2pi / 2)) * window
        bp_center = 2 * band[:, None]
        filters = torch.cat([bp_left, bp_center, bp_left.flip(-1)], dim=1)
        return filters / (2 * band[:, None])

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, 1, T) -> (B, filters, T')
        return F.conv1d(x.float(), self.filters()[:, None, :], stride=self.stride)


def _max_pool_time(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, C, T) max pool over time, stride k; the tail that fills no window
    is dropped."""
    return F.max_pool1d(x, k, k)


class SincNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.wav_norm1d = InstanceNorm(1)
        self.conv1d = nn.ModuleList([SincConv(), nn.Conv1d(SINC_FILTERS, 60, 5), nn.Conv1d(60, 60, 5)])
        self.norm1d = nn.ModuleList([InstanceNorm(c) for c in (SINC_FILTERS, 60, 60)])

    def forward(self, audio: torch.Tensor) -> torch.Tensor:  # (B, T) -> (B, 60, T')
        x = self.wav_norm1d(audio[:, None, :].float())
        x = torch.abs(self.conv1d[0](x))
        for i in range(3):
            if i:
                x = self.conv1d[i](x)
            x = F.leaky_relu(self.norm1d[i](_max_pool_time(x, 3)))
        return x


class PyanNetVAD(nn.Module):
    """Full segmentation net: waveform (B, T) → frame scores (B, T', C)."""

    def __init__(
        self,
        num_classes: int = 3,
        lstm_hidden: int = 128,
        lstm_layers: int = 4,
        linear_units: Sequence[int] = (128, 128),
    ):
        super().__init__()
        self.num_classes = num_classes
        self.sincnet = SincNet()
        self.lstm = nn.LSTM(60, lstm_hidden, num_layers=lstm_layers, bidirectional=True, batch_first=True)
        dims = [2 * lstm_hidden, *linear_units]
        self.linear = nn.ModuleList([nn.Linear(a, b) for a, b in zip(dims, dims[1:])])
        self.classifier = nn.Linear(dims[-1], num_classes)

    @property
    def device(self) -> torch.device:
        return self.classifier.weight.device

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        x = self.sincnet(audio).transpose(1, 2)  # (B, T', 60)
        x, _ = self.lstm(x.contiguous())
        for lin in self.linear:
            x = F.leaky_relu(lin(x))
        return torch.sigmoid(self.classifier(x))


def init_vad_params(seed: int = 0, num_classes: int = 3) -> dict:
    """Random PyanNet parameters in the JAX package's tree layout, drawn with
    numpy (seeded): the SincNet's mel-spaced init, norm scales ones, biases
    zeros, LSTM and dense weights normal at 1/sqrt(fan_in). The JAX package
    draws its init with JAX's PRNG, which only JAX reproduces; tests carry
    its tree across with ``models/convert.py:pyannet_from_jax`` instead."""
    lstm_layers = 4
    rng = np.random.default_rng(seed)

    def normal(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    def norm(c):
        return {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32)}

    hz = _mel_spaced_hz(SINC_FILTERS)
    params = {
        "wav_norm": norm(1),
        "sinc": {"low_hz": hz[:-1, None].astype(np.float32), "band_hz": np.diff(hz)[:, None].astype(np.float32)},
        "norm_0": norm(SINC_FILTERS),
        "lstm": {},
    }
    for i, (cin, cout) in enumerate(((SINC_FILTERS, 60), (60, 60))):
        params[f"conv_{i + 1}"] = {"kernel": normal((5, cin, cout), 5 * cin), "bias": np.zeros(cout, np.float32)}
        params[f"norm_{i + 1}"] = norm(cout)
    H = 128
    for layer in range(lstm_layers):
        D = 60 if layer == 0 else 2 * H
        for direction in ("fwd", "bwd"):
            params["lstm"][f"{direction}_{layer}"] = {
                "w_ih": normal((4 * H, D), D),
                "w_hh": normal((4 * H, H), H),
                "b_ih": np.zeros(4 * H, np.float32),
                "b_hh": np.zeros(4 * H, np.float32),
            }
    for i, (cin, cout) in enumerate(((2 * H, 128), (128, 128), (128, num_classes))):
        name = "classifier" if i == 2 else f"linear_{i}"
        params[name] = {"kernel": normal((cin, cout), cin), "bias": np.zeros(cout, np.float32)}
    return params

