"""Speaker-embedding extraction, on the device.

Port of ``whisperx_tpu/diarize/embed.py``. Two backends:

- ``ResNet34Embedding``: the WeSpeaker ResNet34 speaker network — the
  architecture behind the ``wespeaker-voxceleb-resnet34-LM`` checkpoint
  pyannote 3.1 ships: kaldi-fbank 80-mel "image" (freq × time), 3×3 conv
  stem, 4 residual stages of [3,4,6,3] BasicBlocks at 32/64/128/256
  channels, temporal statistics pooling (mean ‖ unbiased std, channel-major
  flatten) and a linear projection to 256-d. NCHW with ``nn.Conv2d`` and
  ``nn.BatchNorm2d`` in eval mode, under the WeSpeaker names (``conv1``,
  ``layer<s>.<b>.shortcut.<0|1>``, ``seg_1``), so ``state_dict()`` is the
  checkpoint's layout. The convolutions are cuDNN calls on the card; the JAX
  package runs them as XLA convolutions, outside any Pallas kernel.
- ``MelStatsEmbedding``: weight-free fallback (log-mel moment statistics +
  delta features) on the port's ``audio/mel.py`` front end, as the JAX
  package uses its ``audio/mel.py``.

A window batch runs in row chunks that bound the device memory
(``device.map_rows``; the JAX package pads it to a row granule for XLA's
compile signatures instead).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..audio.fbank import kaldi_fbank
from ..audio.mel import log_mel_spectrogram
from ..device import DeviceLike, map_rows, resolve_device


class WeSpeakerBasicBlock(nn.Module):
    """conv3x3-bn-relu-conv3x3-bn + (optional 1x1 projection) residual."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, channels, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(channels, eps=1e-5)
        self.conv2 = nn.Conv2d(channels, channels, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(channels, eps=1e-5)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_channels != channels:
            self.shortcut = nn.Sequential(
                nn.Conv2d(in_channels, channels, 1, stride, bias=False), nn.BatchNorm2d(channels, eps=1e-5)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(self.shortcut(x) + y)


class ResNet34Embedding(nn.Module):
    """WeSpeaker ResNet34: (B, T, F) fbank → (B, embed_dim) speaker embedding."""

    def __init__(
        self,
        embed_dim: int = 256,
        base_channels: int = 32,
        stage_blocks: Sequence[int] = (3, 4, 6, 3),
        two_emb_layer: bool = False,
        n_mels: int = 80,
    ):
        super().__init__()
        self.n_mels = n_mels
        self.conv1 = nn.Conv2d(1, base_channels, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(base_channels, eps=1e-5)
        ch_in = ch = base_channels
        freq = n_mels
        for s, blocks in enumerate(stage_blocks):
            layer = []
            for b in range(blocks):
                stride = 2 if (s > 0 and b == 0) else 1
                layer.append(WeSpeakerBasicBlock(ch_in, ch, stride))
                ch_in = ch
            if s > 0:
                freq = (freq - 1) // 2 + 1
            setattr(self, f"layer{s + 1}", nn.Sequential(*layer))
            ch *= 2
        self.n_stages = len(stage_blocks)
        self.seg_1 = nn.Linear(2 * ch_in * freq, embed_dim)
        self.two_emb_layer = two_emb_layer
        if two_emb_layer:
            self.seg_bn_1 = nn.BatchNorm1d(embed_dim, eps=1e-5)
            self.seg_2 = nn.Linear(embed_dim, embed_dim)

    @property
    def device(self) -> torch.device:
        return self.seg_1.weight.device

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = feats.transpose(1, 2)[:, None]  # (B, T, F) → (B, 1, F, T)
        x = F.relu(self.bn1(self.conv1(x)))
        for s in range(self.n_stages):
            x = getattr(self, f"layer{s + 1}")(x)
        # Temporal statistics pooling, channel-major flatten:
        # (B, C, F', T') → (B, C·F') for the mean and the unbiased std.
        mean = x.mean(dim=-1).flatten(1)
        std = torch.sqrt(x.var(dim=-1, unbiased=True) + 1e-7).flatten(1)
        emb = self.seg_1(torch.cat([mean, std], dim=-1))
        if self.two_emb_layer:
            emb = self.seg_2(self.seg_bn_1(F.relu(emb)))
        return emb


class NeuralSpeakerEmbedding:
    """Batched window → embedding inference: kaldi fbank (hamming, CMN) — the
    WeSpeaker front end — then the net, then L2 normalization."""

    def __init__(self, model: ResNet34Embedding, mesh=None):
        self.model = model.eval()
        self.mesh = mesh  # data-parallel window batches when set

    def _fwd(self, wavs: torch.Tensor) -> torch.Tensor:
        emb = self.model(kaldi_fbank(wavs, num_mel_bins=self.model.n_mels))
        return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)

    def __call__(self, windows: np.ndarray) -> np.ndarray:  # (B, T) -> (B, D)
        return map_rows(self._fwd, windows, self.model.device, self.mesh)


def _melstats_fwd(wavs: torch.Tensor) -> torch.Tensor:
    feats = log_mel_spectrogram(wavs, device=wavs.device).transpose(1, 2)  # (B, T, 80)
    mean = feats.mean(dim=1)
    std = feats.std(dim=1, unbiased=False)
    delta = feats[:, 1:] - feats[:, :-1]
    dmean = delta.abs().mean(dim=1)
    # Spectral centroid-ish summary per frame bank.
    emb = torch.cat([mean, std, dmean], dim=-1)
    emb = emb - emb.mean(dim=-1, keepdim=True)
    return emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-8)


class MelStatsEmbedding:
    """Weight-free embedding: log-mel moments + deltas, L2-normalized.
    ``device=None`` means the card."""

    def __init__(self, device: DeviceLike = None, mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh  # data-parallel window batches when set

    def __call__(self, windows: np.ndarray) -> np.ndarray:
        return map_rows(_melstats_fwd, windows, self.device, self.mesh)


def init_resnet34_params(seed: int = 0, embed_dim: int = 256, stage_blocks=(3, 4, 6, 3)) -> dict:
    """Random WeSpeaker r34 variables in the JAX package's tree layout
    ({"params", "batch_stats"}, Flax kernel layouts), equal to the JAX
    package's ``init_resnet34_params(seed, ...)``: scales and variances ones,
    biases and means zeros, every kernel normal × 0.05 from
    ``np.random.default_rng(seed)``, drawn in the order JAX flattens the
    tree (sorted keys), at 32 base channels and 80 fbank bins. Build the
    module with ``models/convert.py:resnet34_from_jax``."""
    rng = np.random.default_rng(seed)
    base, n_mels = 32, 80

    def bn(c):
        return ({"bias": np.zeros(c, np.float32), "scale": np.ones(c, np.float32)},
                {"mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32)})

    # Shapes, then the kernels' draws in sorted-key order.
    params: dict = {}
    stats: dict = {}
    kernels: dict = {("conv1",): (3, 3, 1, base)}
    params["bn1"], stats["bn1"] = bn(base)
    ch_in = ch = base
    freq = n_mels
    for s, blocks in enumerate(stage_blocks):
        for b in range(blocks):
            stride = 2 if (s > 0 and b == 0) else 1
            name = f"layer{s + 1}_{b}"
            params[name], stats[name] = {}, {}
            kernels[(name, "conv1")] = (3, 3, ch_in, ch)
            kernels[(name, "conv2")] = (3, 3, ch, ch)
            params[name]["bn1"], stats[name]["bn1"] = bn(ch)
            params[name]["bn2"], stats[name]["bn2"] = bn(ch)
            if stride != 1 or ch_in != ch:
                kernels[(name, "shortcut_conv")] = (1, 1, ch_in, ch)
                params[name]["shortcut_bn"], stats[name]["shortcut_bn"] = bn(ch)
            ch_in = ch
        if s > 0:
            freq = (freq - 1) // 2 + 1
        ch *= 2
    kernels[("seg_1",)] = (2 * ch_in * freq, embed_dim)
    params["seg_1"] = {"bias": np.zeros(embed_dim, np.float32)}
    for path in sorted(kernels):
        node = params
        for key in path:
            node = node.setdefault(key, {})
        node["kernel"] = (rng.standard_normal(kernels[path]) * 0.05).astype(np.float32)
    return {"batch_stats": stats, "params": params}
