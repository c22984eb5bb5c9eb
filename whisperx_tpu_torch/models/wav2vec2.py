"""wav2vec2 CTC model as ``nn.Module``s: the forced-alignment emission network.

Port of ``whisperx_tpu/models/wav2vec2.py`` (HF ``Wav2Vec2ForCTC`` graph:
"group"-norm base and "layer"-norm large feature extractors, the grouped
convolutional positional embedding, post-LN or stable pre-LN encoder layers,
the CTC head). Parameter names follow the JAX package's Flax tree
(``feature_extractor.conv_<i>.kernel``, ``layers.<i>.attention.q_proj``...)
so ``models/convert.py:wav2vec2_from_jax`` maps one onto the other leaf by
leaf. All parameters are inference-only.

Numerics follow the Flax module: ``dtype`` is the compute type, parameters
stay fp32 (or int8 with per-channel scales in the transformer's projections
of the ``quantized`` model, :func:`quantize_wav2vec2`) and are cast where
Flax casts them, the norms run in fp32, the CTC
logits come out in fp32. ``models/whisper.py:Dense`` returns fp32 (Whisper's
precision rule); this module rounds each projection's output to the compute
type at once, so that its residual stream stays in that type, as Flax's
does. Batches carry ``sample_lengths``: padded samples are
zeroed, the GroupNorm of base models runs over all frames (padded ones too,
as Flax's does), and padded frames are excluded as attention keys.

Differences in mechanism, not in value:
- Convolutions run as ``unfold`` + ``matmul`` (``models/whisper.py:Conv``).
- The feature extractor ports the ``"conv"`` semantics of ``StridedConv1D``.
  Its ``"matmul"``/``"s2d"`` arms and ``WHISPERX_CONV_IMPL`` were TPU A/B
  probes of the same function and are not ported.
- The int8 model's projections are ``models/whisper.py:Dense``: those of at
  most 256 rows with both widths multiples of 128 (short alignment batches)
  go through ``ops/int8_mm.py``, as they go through the Pallas kernel in the
  JAX package.

Under a ``mesh`` the transformer's attention (local heads, row-parallel
``out_proj``) and feed-forward (local hidden units, row-parallel ``output``)
split over the "model" axis as ``models/whisper.py``'s do; ``lm_head``, the
feature extractor and the positional conv stay whole on every rank.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.attention import fused_self_attention
from .configs import Wav2Vec2Config
from ..parallel.mesh import mesh_device, model_group
from .whisper import Conv, Dense, LayerNorm, _param, local_heads, split_factor

NEG_MASK = -1e9


class GroupNorm(nn.Module):
    """Flax ``nn.GroupNorm`` with one channel per group (base models' norm
    after the first conv), in fp32 over all T frames."""

    def __init__(self, dim: int, device: DeviceLike, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = _param((dim,), torch.float32, device)
        self.bias = _param((dim,), torch.float32, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, C)
        y = F.group_norm(x.float().transpose(1, 2), x.shape[-1], self.scale, self.bias, eps=self.eps)
        return y.transpose(1, 2)


class ConvFeatureExtractor(nn.Module):
    """Strided 1-D conv stack: raw 16 kHz audio → 512-d frames at 50 Hz."""

    def __init__(self, config: Wav2Vec2Config, *, dtype, device):
        super().__init__()
        cfg = config
        self.config, self.dtype = cfg, dtype
        cin = 1
        for i, (dim, kernel, stride) in enumerate(cfg.conv_layers):
            self.add_module(f"conv_{i}", Conv(cin, dim, kernel, stride, use_bias=cfg.conv_bias, dtype=dtype, device=device))
            if cfg.feat_extract_norm == "group" and i == 0:
                self.add_module(f"norm_{i}", GroupNorm(dim, device))
            elif cfg.feat_extract_norm == "layer":
                self.add_module(f"norm_{i}", LayerNorm(dim, device, eps=cfg.layer_norm_eps))
            cin = dim

    def forward(self, audio: torch.Tensor) -> torch.Tensor:  # (B, T) -> (B, T', C)
        x = audio[:, :, None].to(self.dtype)
        for i in range(len(self.config.conv_layers)):
            x = getattr(self, f"conv_{i}")(x)
            norm = getattr(self, f"norm_{i}", None)
            if norm is not None:
                x = norm(x)
            x = F.gelu(x.to(self.dtype))
        return x


class ConvPositionalEmbedding(nn.Module):
    """Grouped conv positional encoding (kernel 128, groups 16) + GELU."""

    def __init__(self, config: Wav2Vec2Config, *, dtype, device):
        super().__init__()
        k = config.num_conv_pos_embeddings
        self.even = k % 2 == 0
        self.conv = Conv(
            config.hidden_size, config.hidden_size, k, padding=k // 2,
            groups=config.num_conv_pos_embedding_groups, dtype=dtype, device=device,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, D)
        h = self.conv(x)
        if self.even:  # even kernel: trim the extra right frame (HF parity)
            h = h[:, :-1, :]
        return F.gelu(h)


class W2VAttention(nn.Module):
    def __init__(self, config: Wav2Vec2Config, *, dtype, quantized: bool = False, group=None, device):
        super().__init__()
        d = config.hidden_size
        self.head_dim = d // config.num_heads
        self.num_heads = local_heads(d, config.num_heads, group)  # this rank's heads
        width = self.num_heads * self.head_dim
        self.dtype = dtype
        kw = dict(dtype=dtype, quantized=quantized, device=device)
        self.q_proj = Dense(d, width, **kw)
        self.k_proj = Dense(d, width, **kw)
        self.v_proj = Dense(d, width, **kw)
        self.out_proj = Dense(width, d, reduce_group=group if width != d else None, **kw)

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor]) -> torch.Tensor:
        B, T, _ = x.shape
        H, Dh = self.num_heads, self.head_dim
        scale = Dh**-0.25
        dt = self.dtype
        q = self.q_proj(x).to(dt).reshape(B, T, H, Dh) * scale
        k = self.k_proj(x).to(dt).reshape(B, T, H, Dh) * scale
        v = self.v_proj(x).to(dt).reshape(B, T, H, Dh)
        out = fused_self_attention(q, k, v, pad_mask, neg_mask=NEG_MASK)
        return self.out_proj(out.reshape(B, T, H * Dh)).to(dt)


class W2VFeedForward(nn.Module):
    def __init__(self, config: Wav2Vec2Config, *, dtype, quantized: bool = False, group=None, device):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, quantized=quantized, device=device)
        F_ = config.intermediate_size
        hidden = F_ // split_factor(F_, group)
        self.intermediate = Dense(config.hidden_size, hidden, **kw)
        self.output = Dense(hidden, config.hidden_size, reduce_group=group if hidden != F_ else None, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output(F.gelu(self.intermediate(x).to(self.dtype))).to(self.dtype)


class W2VEncoderLayer(nn.Module):
    def __init__(self, config: Wav2Vec2Config, *, dtype, quantized: bool = False, group=None, device):
        super().__init__()
        self.config, self.dtype = config, dtype
        eps = config.layer_norm_eps
        self.attention = W2VAttention(config, dtype=dtype, quantized=quantized, group=group, device=device)
        self.layer_norm = LayerNorm(config.hidden_size, device, eps=eps)
        self.feed_forward = W2VFeedForward(config, dtype=dtype, quantized=quantized, group=group, device=device)
        self.final_layer_norm = LayerNorm(config.hidden_size, device, eps=eps)

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor]) -> torch.Tensor:
        if self.config.do_stable_layer_norm:  # pre-LN (large/xlsr)
            x = x + self.attention(self.layer_norm(x).to(self.dtype), pad_mask)
            x = x + self.feed_forward(self.final_layer_norm(x).to(self.dtype))
        else:  # post-LN (base)
            x = self.layer_norm(x + self.attention(x, pad_mask)).to(self.dtype)
            x = self.final_layer_norm(x + self.feed_forward(x)).to(self.dtype)
        return x


class Wav2Vec2ForCTC(nn.Module):
    """Full CTC model: conv features → projection → transformer → vocab logits.

    ``attn_impl`` takes "auto" alone, and only for callers that still pass
    it: the attention path follows from its tensors
    (``ops/attention.py:resolve_attn_impl``). ``quantized``: int8
    weight-only projections in the transformer and ``feat_projection``
    (the convolutions and the ``lm_head`` emissions projection stay fp).
    ``device=None`` means the card (the rank's device under a ``mesh``, whose
    "model" axis the transformer splits over).
    """

    def __init__(
        self,
        config: Wav2Vec2Config,
        *,
        dtype: torch.dtype = torch.float32,
        quantized: bool = False,
        attn_impl: str = "auto",
        device: DeviceLike = None,
        mesh=None,
    ):
        super().__init__()
        if attn_impl != "auto":
            raise ValueError(f"attn_impl={attn_impl!r}: the encoder's attention path follows from its tensors")
        device = resolve_device(mesh_device(mesh) if device is None and mesh is not None else device)
        group = model_group(mesh)
        cfg = config
        self.config, self.dtype, self.quantized = cfg, dtype, quantized
        eps = cfg.layer_norm_eps
        self.feature_extractor = ConvFeatureExtractor(cfg, dtype=dtype, device=device)
        self.feat_layer_norm = LayerNorm(cfg.conv_layers[-1][0], device, eps=eps)
        self.feat_projection = Dense(cfg.conv_layers[-1][0], cfg.hidden_size, dtype=dtype, quantized=quantized, device=device)
        self.pos_conv_embed = ConvPositionalEmbedding(cfg, dtype=dtype, device=device)
        self.encoder_layer_norm = LayerNorm(cfg.hidden_size, device, eps=eps)
        self.layers = nn.ModuleList(
            W2VEncoderLayer(cfg, dtype=dtype, quantized=quantized, group=group, device=device)
            for _ in range(cfg.num_layers)
        )
        self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size, dtype=dtype, device=device)

    @property
    def device(self) -> torch.device:
        return self.lm_head.kernel.device

    def forward(self, audio: torch.Tensor, sample_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T) float32 in [-1, 1] → (B, T', vocab) fp32 logits.

        ``sample_lengths`` (B,) masks padded samples in batched mode; the
        logits at padded frames come from masked attention keys and a zeroed
        conv input (:meth:`feature_lengths` gives the valid frame counts).
        """
        cfg = self.config
        if sample_lengths is not None:
            t_idx = torch.arange(audio.shape[1], device=audio.device)[None, :]
            audio = torch.where(t_idx < sample_lengths[:, None], audio, 0.0)

        feats = self.feature_extractor(audio)  # (B, T', C)
        pad_mask = None
        if sample_lengths is not None:
            frame_len = self.feature_lengths(sample_lengths)
            pad_mask = torch.arange(feats.shape[1], device=feats.device)[None, :] < frame_len[:, None]

        x = self.feat_layer_norm(feats)
        x = self.feat_projection(x.to(self.dtype)).to(self.dtype)
        x = x + self.pos_conv_embed(x)
        if not cfg.do_stable_layer_norm:
            x = self.encoder_layer_norm(x).to(self.dtype)
        for layer in self.layers:
            x = layer(x, pad_mask)
        if cfg.do_stable_layer_norm:
            x = self.encoder_layer_norm(x).to(self.dtype)
        return self.lm_head(x).float()

    def feature_lengths(self, sample_lengths):
        """Conv-stack output length for given input sample counts (a tensor
        or an int)."""
        n = sample_lengths
        for _, kernel, stride in self.config.conv_layers:
            n = (n - kernel) // stride + 1
        return n


# ---- host-side parameter trees (numpy, in the JAX package's layout) --------


def param_shapes(config: Wav2Vec2Config) -> dict:
    """Shapes of the fp parameter tree the JAX ``Wav2Vec2ForCTC`` creates."""
    cfg = config
    D, F_ = cfg.hidden_size, cfg.intermediate_size

    def dense(i, o):
        return {"kernel": (i, o), "bias": (o,)}

    def ln(d):
        return {"scale": (d,), "bias": (d,)}

    fe, cin = {}, 1
    for i, (dim, kernel, _) in enumerate(cfg.conv_layers):
        fe[f"conv_{i}"] = {"kernel": (kernel, cin, dim), **({"bias": (dim,)} if cfg.conv_bias else {})}
        if cfg.feat_extract_norm == "layer" or i == 0:
            fe[f"norm_{i}"] = ln(dim)
        cin = dim
    k, g = cfg.num_conv_pos_embeddings, cfg.num_conv_pos_embedding_groups
    tree = {
        "feature_extractor": fe,
        "feat_layer_norm": ln(cin),
        "feat_projection": dense(cin, D),
        "pos_conv_embed": {"conv": {"kernel": (k, D // g, D), "bias": (D,)}},
        "encoder_layer_norm": ln(D),
        "lm_head": dense(D, cfg.vocab_size),
    }
    for i in range(cfg.num_layers):
        tree[f"layers_{i}"] = {
            "attention": {n: dense(D, D) for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "layer_norm": ln(D),
            "feed_forward": {"intermediate": dense(D, F_), "output": dense(F_, D)},
            "final_layer_norm": ln(D),
        }
    return tree


def random_params(config: Wav2Vec2Config, seed: int = 0) -> dict:
    """Random fp32 parameter tree in the Flax layout, drawn with numpy: norm
    scales ones, biases zeros, kernels normal with std 1/sqrt(fan_in) (the
    scale of Flax's LeCun-normal init; not its bits, which only JAX draws)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for name in sorted(node):
            child = node[name]
            if isinstance(child, dict):
                out[name] = walk(child)
            elif name == "scale":
                out[name] = np.ones(child, np.float32)
            elif name == "bias":
                out[name] = np.zeros(child, np.float32)
            else:
                fan_in = int(np.prod(child[:-1]))
                out[name] = (rng.standard_normal(child) / np.sqrt(fan_in)).astype(np.float32)
        return out

    return walk(param_shapes(config))


def quantize_wav2vec2_params(params: dict) -> dict:
    """Host-side tree transform of ``whisperx_tpu/models/wav2vec2.py:
    quantize_wav2vec2``: every rank-2 kernel becomes symmetric
    per-output-channel int8 (``models/whisper.py:quantize_params``, no
    embedding table); the conv kernels (rank 3) and ``lm_head`` stay fp."""
    from .whisper import quantize_params

    qparams = quantize_params(params, embedding_keys=())
    qparams["lm_head"] = params["lm_head"]  # the emissions head stays fp
    return qparams


def quantize_wav2vec2(model: Wav2Vec2ForCTC) -> Wav2Vec2ForCTC:
    """fp model → the int8 weight-only model on the same device, with the
    same compute dtype (its tree through :func:`quantize_wav2vec2_params`)."""
    from .convert import wav2vec2_from_jax, whisper_to_jax  # convert imports this module

    params = quantize_wav2vec2_params(whisper_to_jax(model))
    return wav2vec2_from_jax(params, model.config, dtype=model.dtype, device=model.device)
