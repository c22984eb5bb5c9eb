"""Whisper encoder-decoder as ``nn.Module``s.

Port of ``whisperx_tpu/models/whisper.py``. Parameter names follow the JAX
package's tree (``kernel``, ``kernel_scale``, ``bias``, ``scale``,
``token_embedding``...), with ``layers.<i>`` for Flax's ``layers_<i>``, so
``models/convert.py:whisper_from_jax`` maps one onto the other leaf by leaf.
Parameters are created inference-only (``requires_grad=False``);
:meth:`Whisper.trainable` turns a float model into a trainable one
(``train.py``).

Numerics: ``dtype`` is the compute type (fp32 or bf16), parameters keep the
type they were stored in and are cast at the products that read them. One
precision rule holds for every compute type: a value is rounded to ``dtype``
only as the input of a product (a projection's input and weight, q, k and v
going into attention, the probabilities going into their product with V,
the self cache and cross K/V); every product accumulates and returns fp32,
and everything between products (biases, GELU, LayerNorm, the residual
stream, the positional embeddings) stays fp32. An fp32 model is therefore
computed as before, and a bf16 one as whisperX's float16 computes it, at
bf16's significand only where a tensor core reads a value. The JAX module
keeps its residual stream and GELU in the compute type.

Differences in mechanism, not in value:
- The self-attention KV cache is a per-layer dict of tensors written in place
  at ``cache_index`` (JAX's ``dynamic_update_slice`` returns a new buffer),
  with ``index_copy_`` along the time axis. ``cache_index`` may be a Python
  int or a 0-d int64 tensor on the model's device: the decode loop's
  position lives on the device, so that a step reads nothing back to the
  host and can be captured into a CUDA graph (``decode/search.py``). A
  decode step of a bf16 model with an int8 or bf16 cache on the card stores
  and attends in one launch a layer, reading only the filled slots
  (``ops/self_attn_decode.py:resolve_self_attn_impl``); the JAX package
  runs the store and both einsums over the whole cache in XLA.
- The encoder convolutions run as ``unfold`` + ``matmul``: an fp32
  convolution on CUDA would go through cuDNN in TF32 by default.
- int8 projections with at most 256 rows (every decoder projection in a beam
  step) go through ``ops/int8_mm.py``, whose wrapper launches the Hopper
  kernel on CUDA tensors; decode-step cross attention over ``FlatCrossKV``
  goes through ``ops/cross_attn.py``, which the engine builds by default on
  the card for a bf16 model with int8 or bf16 cross K/V
  (``decode/engine.py:resolve_cross_impl``; the JAX package's TPU default is
  the einsum, which here would cast each layer's whole K and V to bf16 every
  step); the encoder's self-attention through
  ``ops/attention.py:fused_self_attention``, which launches
  ``ops/flash_attn.py``'s kernel on the card for a bf16 model with heads of
  64 (the JAX package's default is "xla", which here would write (B, H, T, T)
  fp32 logits).
- int4 values (``Dense(quant_bits=4)`` kernels, the int4 KV cache and cross
  K/V) are stored packed two to a byte (:data:`PACKED_INT4`, see
  ``ops/quant.py:pack_int4``): torch has no int4 type. They are unpacked where the JAX
  code casts its int4 arrays, and the products then run on the same values.
  int4 projections never go through ``ops/int8_mm.py``: the JAX package
  computes them with an XLA ``dot``.

Tensor parallelism (``Whisper(mesh=...)``, built by ``models/convert.py:
whisper_from_jax(..., mesh=)`` from ``parallel/partition.py``'s slices):
where pjit splits the JAX package's arrays over the mesh's "model" axis,
each rank here holds the local slice and calls the collectives itself, in
the Megatron layout. Attention runs ``n_head / n_model`` local heads (the
caches and scale planes hold only those), fc1 ``4d / n_model`` hidden units;
the row-parallel projections (``attn/out``, ``cross_attn/out``, ``mlp/fc2``)
all-reduce fp32 partial products over the group (:meth:`Dense.
_row_parallel`); a vocab-split token embedding looks up its own rows and
all-reduces, and its logits are gathered before the search. A dimension that
does not divide ``n_model`` stays whole, as ``shard_params`` keeps it.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.attention import attend, fused_self_attention, matmul_f32
from ..ops.cross_attn import cross_attention_decode
from ..ops.int8_mm import MAX_ROWS, int8_matmul
from ..ops.quant import PACKED_INT4, quantize_kv, unpack_int4
from ..ops.self_attn_decode import resolve_self_attn_impl, self_attention_decode, self_attention_plain
from ..parallel.mesh import gather_cat, mesh_device, model_group
from .configs import WhisperConfig

NEG_MASK = -1e9  # large-negative instead of -inf: keeps softmax NaN-free for
# all-masked rows (unwritten cache slots) in bf16/fp32 alike.

Cache = dict


class FlatCrossKV(NamedTuple):
    """Cross-attention K/V in the kernel's layout: values flat (B, S, D),
    per-(token, head) scales (B, H, S) fp32."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor


def flat_cross_kv(k: torch.Tensor, v: torch.Tensor, kv_int8: bool) -> FlatCrossKV:
    """(B, S, H, Dh) K/V → FlatCrossKV, int8-quantized or bf16.

    Without int8 the values are stored in bf16: the Pallas kernel converts
    its K/V to bf16 before both products, so the function is unchanged.
    """
    B, S, H, Dh = k.shape
    if kv_int8:
        qk, ks = quantize_kv(k)
        qv, vs = quantize_kv(v)
    else:
        qk, qv = k.to(torch.bfloat16), v.to(torch.bfloat16)
        ks = vs = torch.ones((B, S, H, 1), dtype=torch.float32, device=k.device)

    def t(s):  # (B, S, H, 1) → (B, H, S)
        return s[..., 0].transpose(1, 2).contiguous()

    return FlatCrossKV(
        qk.reshape(B, S, H * Dh).contiguous(), qv.reshape(B, S, H * Dh).contiguous(), t(ks), t(vs)
    )


def use_int8_kernel(x: torch.Tensor, features: int) -> bool:
    """The routing rule of ``whisperx_tpu/models/whisper.py:_use_pallas_int8``:
    at most ``MAX_ROWS`` rows and both widths multiples of 128."""
    rows = x.numel() // x.shape[-1]
    return rows <= MAX_ROWS and features % 128 == 0 and x.shape[-1] % 128 == 0


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device), requires_grad=False)


def split_factor(width: int, group) -> int:
    """How many ways a dimension of ``width`` splits over the tensor-parallel
    ``group``: its size where that divides ``width``, else 1 (the dimension
    stays whole, as ``parallel/partition.py:shard_params`` keeps it)."""
    n = 1 if group is None else dist.get_world_size(group)
    return n if width % n == 0 else 1


def local_heads(d_model: int, n_head: int, group) -> int:
    """Attention heads a rank of ``group`` runs: all of them, or
    ``n_head / n`` where the projections split ``n`` ways. Raises where the
    split would cut a head (the port splits attention by whole heads)."""
    tp = split_factor(d_model, group)
    if n_head % tp:
        raise ValueError(f"{n_head} heads of width {d_model // n_head} do not split over {tp} ranks")
    return n_head // tp


class Dense(nn.Module):
    """Projection with an optional int8 or int4 weight-only mode.

    ``kernel`` is (in_features, features), the layout the int8 kernel reads;
    with ``quant_bits=4`` it is (in_features / 2, features) of
    :data:`PACKED_INT4`, packed along in_features. Quantized modules add a
    per-output-channel fp32 ``kernel_scale``. With ``reduce_group`` the
    projection is row-parallel: ``in_features`` is this rank's slice of the
    input dim, and the output is summed over the group.
    """

    def __init__(
        self,
        in_features: int,
        features: int,
        *,
        use_bias: bool = True,
        dtype: torch.dtype = torch.float32,
        quantized: bool = False,
        quant_bits: int = 8,
        reduce_group=None,
        device: DeviceLike,
    ):
        super().__init__()
        if quant_bits not in (8, 4):
            raise ValueError(f"quant_bits={quant_bits}: expected 8 or 4")
        self.in_features = in_features
        self.features = features
        self.dtype = dtype
        self.quantized = quantized
        self.quant_bits = quant_bits
        self.reduce_group = reduce_group
        if quantized and quant_bits == 4:
            self.kernel = _param((in_features // 2, features), PACKED_INT4, device)
        else:
            self.kernel = _param((in_features, features), torch.int8 if quantized else torch.float32, device)
        if quantized:
            self.kernel_scale = _param((features,), torch.float32, device)
        self.bias = _param((features,), torch.float32, device) if use_bias else None

    def _weight(self) -> torch.Tensor:
        return unpack_int4(self.kernel, dim=0) if self.quantized and self.quant_bits == 4 else self.kernel

    def _row_parallel(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's partial product in fp32, without the bias (through the
        int8 kernel where :func:`use_int8_kernel` holds), all-reduced over
        the group; then the bias, once, in fp32."""
        if self.quantized and self.quant_bits == 8 and use_int8_kernel(x, self.features):
            lead = x.shape[:-1]
            x2 = x.reshape(-1, self.in_features)
            y = int8_matmul(x2, self.kernel, self.kernel_scale, None, out_dtype=torch.float32).reshape(*lead, self.features)
        else:
            y = matmul_f32(x.to(self.dtype), self._weight().to(self.dtype))
            if self.quantized:
                y = y * self.kernel_scale
        dist.all_reduce(y, group=self.reduce_group)
        return y if self.bias is None else y + self.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """fp32 ``x @ kernel (* kernel_scale) + bias``: x and the kernel
        enter the product in ``dtype``, the product and the bias stay fp32
        (the module docstring's precision rule)."""
        if self.reduce_group is not None:
            return self._row_parallel(x)
        if self.quantized and self.quant_bits == 8 and use_int8_kernel(x, self.features):
            lead = x.shape[:-1]
            y = int8_matmul(
                x.reshape(-1, self.in_features), self.kernel, self.kernel_scale, self.bias, out_dtype=torch.float32
            )
            return y.reshape(*lead, self.features)
        y = matmul_f32(x.to(self.dtype), self._weight().to(self.dtype))
        if self.quantized:
            y = y * self.kernel_scale
        return y if self.bias is None else y + self.bias


class LayerNorm(nn.Module):
    """fp32 LayerNorm (Flax names ``scale``/``bias``, epsilon 1e-5 by default)."""

    def __init__(self, dim: int, device: DeviceLike, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = _param((dim,), torch.float32, device)
        self.bias = _param((dim,), torch.float32, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.scale, self.bias, eps=self.eps)


class Conv(nn.Module):
    """1-D convolution over time, channels last like Flax's ``nn.Conv``:
    (B, T, Cin) → (B, T', Cout), zero ``padding`` on both ends of time.
    ``kernel`` is torch's (Cout, Cin / groups, W).

    Runs as ``unfold`` + ``matmul`` (one product per group): an fp32 model
    never meets cuDNN's default TF32 convolution, and no path depends on a
    backend's grouped or low-precision convolution (PyTorch's CPU bf16
    grouped ``conv1d`` returned wrong values in the port's wav2vec2 tests).
    Returns ``dtype`` values: wav2vec2's feature extractor keeps its
    (B, T, 512) activations, which set its memory peak, in the compute
    type. Whisper's encoder takes :class:`AudioConv`.
    """

    def __init__(self, cin, cout, width, stride=1, *, padding=0, groups=1, use_bias=True, dtype, device):
        super().__init__()
        self.stride, self.padding, self.groups, self.dtype = stride, padding, groups, dtype
        self.kernel = _param((cout, cin // groups, width), torch.float32, device)
        self.bias = _param((cout,), torch.float32, device) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        O, Ig, W = self.kernel.shape
        G = self.groups
        x = x.to(self.dtype)
        if self.padding:
            x = F.pad(x, (0, 0, self.padding, self.padding))
        cols = x.unfold(1, W, self.stride)  # (B, T', Cin, W): cols[b, t, c, j] = x[b, t*s + j, c]
        B, T = cols.shape[:2]
        w = self.kernel.to(self.dtype).reshape(G, O // G, Ig * W)
        ys = [self._product(cols[:, :, g * Ig : (g + 1) * Ig].reshape(B, T, Ig * W), w[g].t()) for g in range(G)]
        y = ys[0] if G == 1 else torch.cat(ys, dim=-1)
        return y if self.bias is None else y + self.bias.to(y.dtype)

    _product = staticmethod(torch.matmul)


class AudioConv(Conv):
    """Whisper's front-end convolution under the precision rule: the
    products accumulate and return fp32, and the bias is added in fp32, so
    that GELU and the positional embedding act on fp32 values."""

    _product = staticmethod(matmul_f32)


class MultiHeadAttention(nn.Module):
    """Attention with an optional static KV cache and precomputed cross K/V.

    Under a tensor-parallel ``group`` the module runs its rank's
    :func:`local_heads`: q/k/v project to ``width = n_head * head_dim``
    local columns and ``out`` is row-parallel."""

    def __init__(
        self,
        d_model: int,
        n_head: int,
        *,
        dtype: torch.dtype,
        quantized: bool,
        quant_bits: int = 8,
        fused_qkv: bool = False,
        group=None,
        device: DeviceLike,
    ):
        super().__init__()
        self.d_model = d_model
        self.head_dim = d_model // n_head
        self.n_head = local_heads(d_model, n_head, group)  # this rank's heads
        self.width = self.n_head * self.head_dim
        self.dtype = dtype
        self.fused_qkv = fused_qkv
        kw = dict(dtype=dtype, quantized=quantized, quant_bits=quant_bits, device=device)
        if fused_qkv and self.width != d_model:
            raise ValueError("fused QKV is not split under tensor parallelism; load the unfused tree")
        if fused_qkv:
            self.qkv = Dense(d_model, 3 * d_model, **kw)
        else:
            self.query = Dense(d_model, self.width, **kw)
            self.key = Dense(d_model, self.width, use_bias=False, **kw)
            self.value = Dense(d_model, self.width, **kw)
        self.out = Dense(self.width, d_model, reduce_group=group if self.width != d_model else None, **kw)

    def _split(self, h: torch.Tensor) -> torch.Tensor:  # (B, T, D) -> (B, T, H, Dh)
        return h.reshape(h.shape[0], h.shape[1], self.n_head, self.head_dim)

    def _project_qkv(self, x: torch.Tensor):
        if self.fused_qkv:
            y = self.qkv(x)
            D = self.width
            return y[..., :D], y[..., D : 2 * D], y[..., 2 * D :]
        return self.query(x), self.key(x), self.value(x)

    def compute_kv(self, src: torch.Tensor):
        """Project K/V once (cross-attention precompute), in fp32: the cache
        they go into sets their width (``decode/engine.py:_cross_kv``)."""
        return self._split(self.key(src)), self._split(self.value(src))

    def forward(
        self,
        x: torch.Tensor,  # (B, T_q, D)
        *,
        mask: Optional[torch.Tensor] = None,  # additive, broadcastable to (B,H,Tq,Tkv)
        cache: Optional[dict] = None,  # per-layer {"k","v"[,"k_scale","v_scale"]} (B, T, H, ·)
        cache_index: Optional[torch.Tensor] = None,  # (T_q,) int64: the cache slots of the queries
        precomputed_kv=None,
    ):
        head_dim = self.head_dim
        scale = head_dim**-0.25

        # Kernel cross attention: beam queries fold into the G axis.
        if isinstance(precomputed_kv, FlatCrossKV):
            fkv = precomputed_kv
            Bkv = fkv.k.shape[0]
            Tq = x.shape[1]
            group = x.shape[0] // Bkv
            q = self.query(x) * (head_dim**-0.5)  # full 1/sqrt(Dh), then one rounding
            q = q.reshape(Bkv, group * Tq, self.width).to(torch.bfloat16).contiguous()
            out = cross_attention_decode(q, fkv.k, fkv.v, fkv.k_scale, fkv.v_scale)
            out = out.to(self.dtype).reshape(x.shape[0], Tq, self.width)
            return self.out(out), None

        dt = self.dtype
        if precomputed_kv is not None:  # cross attention on the einsum route
            q = (self._split(self.query(x)) * scale).to(dt)
            ks = vs = None
            if len(precomputed_kv) == 4:  # int8/int4 cross KV: (k, k_scale, v, v_scale)
                k, ks, v, vs = precomputed_kv
            else:
                k, v = precomputed_kv
            return self.out(attend(q, k, v, ks, vs, mask, dt)), None

        qp, kp, vp = self._project_qkv(x)
        if cache is not None:
            # The decoder: the new tokens go into the static cache at
            # cache_index, then attend over it; one token a row on the card
            # takes the kernel (ops/self_attn_decode.py).
            route = resolve_self_attn_impl(x.device, dt, cache["k"].dtype, head_dim, x.shape[1])
            attend_cached = self_attention_decode if route == "kernel" else self_attention_plain
            return self.out(attend_cached(qp, kp, vp, cache, cache_index, mask, dt)), cache

        q = self._split(qp) * scale
        k, v = self._split(kp), self._split(vp)
        # Encoder path: full bidirectional self-attention, no cache. q, k and
        # v are scaled in fp32 and rounded once, at the kernel's input.
        if mask is None and x.shape[1] > 1:
            out = fused_self_attention(q.to(dt), (k * scale).to(dt), v.to(dt))
            return self.out(out.reshape(x.shape[0], x.shape[1], self.width)), None
        return self.out(attend(q.to(dt), k, v, None, None, mask, dt)), None


class MLP(nn.Module):
    """fc1 → GELU → fc2, GELU on fc1's fp32 output (fc2 rounds its input);
    under a tensor-parallel ``group`` fc1 holds this rank's hidden units and
    fc2 is row-parallel."""

    def __init__(self, d_model: int, *, dtype, quantized, quant_bits=8, group=None, device):
        super().__init__()
        kw = dict(dtype=dtype, quantized=quantized, quant_bits=quant_bits, device=device)
        hidden = 4 * d_model // split_factor(4 * d_model, group)
        self.fc1 = Dense(d_model, hidden, **kw)
        self.fc2 = Dense(hidden, d_model, reduce_group=group if hidden != 4 * d_model else None, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class EncoderBlock(nn.Module):
    def __init__(
        self, d_model: int, n_head: int, *, dtype, quantized, quant_bits=8, fused_qkv, group=None, device
    ):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, quantized=quantized, quant_bits=quant_bits, group=group, device=device)
        self.attn_ln = LayerNorm(d_model, device)
        self.attn = MultiHeadAttention(d_model, n_head, fused_qkv=fused_qkv, **kw)
        self.mlp_ln = LayerNorm(d_model, device)
        self.mlp = MLP(d_model, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, _ = self.attn(self.attn_ln(x).to(self.dtype))
        x = x + h
        return x + self.mlp(self.mlp_ln(x).to(self.dtype))


class AudioEncoder(nn.Module):
    def __init__(
        self, config: WhisperConfig, *, dtype, quantized, quant_bits=8, fused_qkv, group=None, device
    ):
        super().__init__()
        cfg = config
        self.dtype = dtype
        D = cfg.n_audio_state
        self.conv1 = AudioConv(cfg.n_mels, D, 3, 1, padding=1, dtype=dtype, device=device)
        self.conv2 = AudioConv(D, D, 3, 2, padding=1, dtype=dtype, device=device)
        self.layers = nn.ModuleList(
            EncoderBlock(
                D, cfg.n_audio_head, dtype=dtype, quantized=quantized, quant_bits=quant_bits, fused_qkv=fused_qkv,
                group=group, device=device,
            )
            for _ in range(cfg.n_audio_layer)
        )
        self.ln_post = LayerNorm(D, device)
        self.positional_embedding = _param((cfg.n_audio_ctx, D), torch.float32, device)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, n_mels, 3000) log-mel → (B, 1500, D) audio states, in the
        compute dtype: they are only ever the input of the cross K/V
        projections. The residual stream between is fp32."""
        x = mel.to(self.dtype).transpose(1, 2)  # (B, T, n_mels): conv over time
        x = F.gelu(self.conv1(x))
        x = F.gelu(self.conv2(x))
        x = x + self.positional_embedding[None, : x.shape[1]]
        for block in self.layers:
            x = block(x)
        return self.ln_post(x).to(self.dtype)


class DecoderBlock(nn.Module):
    def __init__(self, d_model: int, n_head: int, *, dtype, quantized, quant_bits=8, fused_qkv, group=None, device):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, quantized=quantized, quant_bits=quant_bits, group=group, device=device)
        self.attn_ln = LayerNorm(d_model, device)
        self.attn = MultiHeadAttention(d_model, n_head, fused_qkv=fused_qkv, **kw)
        self.cross_attn_ln = LayerNorm(d_model, device)
        self.cross_attn = MultiHeadAttention(d_model, n_head, **kw)
        self.mlp_ln = LayerNorm(d_model, device)
        self.mlp = MLP(d_model, **kw)

    def forward(self, x, *, self_cache, cache_index, cross_kv, self_mask):
        h, new_self_cache = self.attn(
            self.attn_ln(x).to(self.dtype), mask=self_mask, cache=self_cache, cache_index=cache_index
        )
        x = x + h
        h, _ = self.cross_attn(self.cross_attn_ln(x).to(self.dtype), precomputed_kv=cross_kv)
        x = x + h
        return x + self.mlp(self.mlp_ln(x).to(self.dtype)), new_self_cache

    def compute_cross_kv(self, audio_states: torch.Tensor):
        return self.cross_attn.compute_kv(audio_states)


class TextDecoder(nn.Module):
    """Token embedding → decoder blocks → tied logits. Under a
    tensor-parallel ``group`` whose size divides ``n_vocab``, the embedding
    holds this rank's ``n_vocab / n`` rows, starting at ``vocab_start``."""

    def __init__(self, config: WhisperConfig, *, dtype, quantized, quant_bits=8, fused_qkv, group=None, device):
        super().__init__()
        cfg = config
        self.dtype = dtype
        self.quantized = quantized
        D = cfg.n_text_state
        vocab_tp = split_factor(cfg.n_vocab, group)
        self.vocab_group = group if vocab_tp > 1 else None
        rows = cfg.n_vocab // vocab_tp
        self.vocab_start = rows * dist.get_rank(group) if self.vocab_group is not None else 0
        if quantized:
            # Per-row int8 embedding table (int4 models too); the row scales
            # commute with the tied logits product.
            self.token_embedding = _param((rows, D), torch.int8, device)
            self.token_embedding_scale = _param((rows,), torch.float32, device)
        else:
            self.token_embedding = _param((rows, D), torch.float32, device)
        self.positional_embedding = _param((cfg.n_text_ctx, D), torch.float32, device)
        self.layers = nn.ModuleList(
            DecoderBlock(
                D, cfg.n_text_head, dtype=dtype, quantized=quantized, quant_bits=quant_bits, fused_qkv=fused_qkv,
                group=group, device=device,
            )
            for _ in range(cfg.n_text_layer)
        )
        self.ln = LayerNorm(D, device)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token rows in fp32, the residual stream's type. A vocab-split
        table looks up the ids in its own rows, zeros the others and
        all-reduces: exactly one rank contributes each row, so the sum is
        the unsplit lookup."""
        emb = self.token_embedding
        ids = tokens
        if self.vocab_group is not None:
            ids = tokens - self.vocab_start
            mine = (ids >= 0) & (ids < emb.shape[0])
            ids = torch.where(mine, ids, 0)
        x = emb[ids].float()
        if self.quantized:
            x = x * self.token_embedding_scale[ids][..., None]
        if self.vocab_group is not None:
            x = torch.where(mine[..., None], x, 0.0)
            dist.all_reduce(x, group=self.vocab_group)
        return x

    def forward(self, tokens: torch.Tensor, cache: Cache, cache_index: Union[int, torch.Tensor]):
        """Decode ``tokens`` (B, T) starting at absolute position ``cache_index``
        (a Python int, or a 0-d int64 tensor on the model's device: then
        nothing is read back to the host).

        Serves prompt ingestion (T = prompt length) and stepping (T = 1).
        Returns (logits (B, T, V) fp32, cache).
        """
        T = tokens.shape[1]
        emb = self.token_embedding
        x = self._embed(tokens)
        positions = cache_index + torch.arange(T, device=tokens.device)
        x = x + self.positional_embedding.index_select(0, positions)

        # Causal mask against the static cache: the query at absolute position
        # cache_index + t sees cache slots [0, cache_index + t]. The kernel's
        # route reads only those slots and not the mask.
        cache_len = cache["self"][0]["k"].shape[1]
        k_pos = torch.arange(cache_len, device=tokens.device)[None, :]
        self_mask = torch.where(k_pos <= positions[:, None], 0.0, NEG_MASK).to(torch.float32)

        new_self = []
        for i, block in enumerate(self.layers):
            x, layer_cache = block(
                x,
                self_cache=cache["self"][i],
                cache_index=positions,
                cross_kv=cache["cross"][i],
                self_mask=self_mask,
            )
            new_self.append(layer_cache)

        x = self.ln(x)
        # int8 → fp32 is exact, so the quantized table skips the cast to dtype.
        table = emb if self.quantized else emb.to(self.dtype)
        logits = matmul_f32(x.to(self.dtype), table.t())
        if self.quantized:
            logits = logits * self.token_embedding_scale[None, None, :]
        # A vocab-split table gives this rank's columns; the search needs all.
        logits = gather_cat(logits, -1, self.vocab_group)
        return logits, {"self": new_self, "cross": cache["cross"]}

    def compute_cross_kv(self, audio_states: torch.Tensor):
        return [block.compute_cross_kv(audio_states) for block in self.layers]


class Whisper(nn.Module):
    """Encoder + decoder under one parameter tree.

    ``quantized``: False | True (both stacks) | "decoder" | "encoder";
    ``quant_bits``: 8 or 4, the quantized projections' width.
    ``fused_qkv``: one (D, 3D) projection for every self-attention block;
    pair with :func:`fuse_qkv_params`. ``attn_impl`` takes "auto" alone,
    and only for callers that still pass it: the encoder's attention path
    follows from its tensors (``ops/attention.py:resolve_attn_impl``).
    ``device=None`` means the card (the rank's device under a ``mesh``).
    ``mesh``: a ``parallel.make_mesh`` mesh whose "model" axis the module
    splits over (module docstring);
    ``tp_group`` is that axis's process group, None without a split.
    """

    def __init__(
        self,
        config: WhisperConfig,
        *,
        dtype: torch.dtype = torch.float32,
        quantized: Union[bool, str] = False,
        quant_bits: int = 8,
        fused_qkv: bool = False,
        attn_impl: str = "auto",
        device: DeviceLike = None,
        mesh=None,
    ):
        super().__init__()
        if attn_impl != "auto":
            raise ValueError(f"attn_impl={attn_impl!r}: the encoder's attention path follows from its tensors")
        device = resolve_device(mesh_device(mesh) if device is None and mesh is not None else device)
        self.mesh = mesh
        self.tp_group = group = model_group(mesh)
        self.config = config
        self.dtype = dtype
        self.quantized = quantized
        self.quant_bits = quant_bits
        self.fused_qkv = fused_qkv
        q_enc = quantized is True or quantized == "encoder"
        q_dec = quantized is True or quantized == "decoder"
        kw = dict(dtype=dtype, quant_bits=quant_bits, fused_qkv=fused_qkv, group=group, device=device)
        self.encoder = AudioEncoder(config, quantized=q_enc, **kw)
        self.decoder = TextDecoder(config, quantized=q_dec, **kw)
        # Captured device decode loops by shape key (decode/engine.py), least recently used first.
        self.decode_loops: OrderedDict = OrderedDict()

    @property
    def device(self) -> torch.device:
        return self.decoder.positional_embedding.device

    def trainable(self, flag: bool = True) -> "Whisper":
        """Turn ``requires_grad`` on (or off) for every parameter, so that
        :meth:`forward` under autograd gives their gradients. Only a float
        model trains: a quantized one raises (its int8 leaves have no
        gradient, as in the JAX package's training step)."""
        if flag and self.quantized:
            raise ValueError(f"a quantized Whisper (quantized={self.quantized!r}) cannot be trained; load float weights")
        for p in self.parameters():
            p.requires_grad_(flag)
        return self

    def forward(self, mel: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced forward pass: (B, n_mels, 3000), (B, T) → (B, T, V)."""
        audio_states = self.encoder(mel)
        cache = self.empty_cache(tokens.shape[0])
        cache["cross"] = self.decoder.compute_cross_kv(audio_states)
        logits, _ = self.decoder(tokens, cache, 0)
        return logits

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        return self.encoder(mel)

    def decode_step(self, tokens: torch.Tensor, cache: Cache, cache_index: Union[int, torch.Tensor]):
        return self.decoder(tokens, cache, cache_index)

    def compute_cross_kv(self, audio_states: torch.Tensor):
        return self.decoder.compute_cross_kv(audio_states)

    def empty_cache(
        self, batch: int, cache_dtype: Optional[torch.dtype] = None, cache_len: int = 0
    ) -> Cache:
        """Zeroed self-attention cache: a per-layer list of (B, T, H, Dh)
        buffer dicts. ``cache_dtype`` int8 or :data:`PACKED_INT4` ((B, T, H,
        Dh / 2), packed along Dh) adds per-token scale planes (B, T, H, 1).
        ``cache_len`` trims T below n_text_ctx; "cross" is filled by the
        engine."""
        cfg = self.config
        dt = cache_dtype or self.dtype
        attn = self.decoder.layers[0].attn
        shape = (batch, cache_len or cfg.n_text_ctx, attn.n_head, attn.head_dim)
        vshape = shape[:-1] + (attn.head_dim // 2,) if dt == PACKED_INT4 else shape
        dev = self.device

        def one_layer():
            layer = {
                "k": torch.zeros(vshape, dtype=dt, device=dev),
                "v": torch.zeros(vshape, dtype=dt, device=dev),
            }
            if dt in (torch.int8, PACKED_INT4):
                sshape = shape[:-1] + (1,)
                layer["k_scale"] = torch.zeros(sshape, dtype=torch.float32, device=dev)
                layer["v_scale"] = torch.zeros(sshape, dtype=torch.float32, device=dev)
            return layer

        L = cfg.n_text_layer
        return {"self": [one_layer() for _ in range(L)], "cross": [None] * L}


# ---- host-side parameter trees (numpy, in the JAX package's layout) --------


def _dense_shapes(i: int, o: int, bias: bool = True) -> dict:
    d = {"kernel": (i, o)}
    if bias:
        d["bias"] = (o,)
    return d


def _ln_shapes(d: int) -> dict:
    return {"scale": (d,), "bias": (d,)}


def _attn_shapes(d: int) -> dict:
    return {
        "query": _dense_shapes(d, d),
        "key": _dense_shapes(d, d, bias=False),
        "value": _dense_shapes(d, d),
        "out": _dense_shapes(d, d),
    }


def _mlp_shapes(d: int) -> dict:
    return {"fc1": _dense_shapes(d, 4 * d), "fc2": _dense_shapes(4 * d, d)}


def param_shapes(config: WhisperConfig) -> dict:
    """Shapes of the fp parameter tree the JAX ``Whisper`` module creates."""
    cfg = config
    De, Dd = cfg.n_audio_state, cfg.n_text_state
    encoder = {
        "conv1": {"kernel": (3, cfg.n_mels, De), "bias": (De,)},
        "conv2": {"kernel": (3, De, De), "bias": (De,)},
        "ln_post": _ln_shapes(De),
        "positional_embedding": (cfg.n_audio_ctx, De),
    }
    for i in range(cfg.n_audio_layer):
        encoder[f"layers_{i}"] = {
            "attn_ln": _ln_shapes(De),
            "attn": _attn_shapes(De),
            "mlp_ln": _ln_shapes(De),
            "mlp": _mlp_shapes(De),
        }
    decoder = {
        "token_embedding": (cfg.n_vocab, Dd),
        "positional_embedding": (cfg.n_text_ctx, Dd),
        "ln": _ln_shapes(Dd),
    }
    for i in range(cfg.n_text_layer):
        decoder[f"layers_{i}"] = {
            "attn_ln": _ln_shapes(Dd),
            "attn": _attn_shapes(Dd),
            "cross_attn_ln": _ln_shapes(Dd),
            "cross_attn": _attn_shapes(Dd),
            "mlp_ln": _ln_shapes(Dd),
            "mlp": _mlp_shapes(Dd),
        }
    return {"encoder": encoder, "decoder": decoder}


def random_params(config: WhisperConfig, seed: int = 0, scale: float = 0.02) -> dict:
    """Random fp32 parameter tree, equal leaf for leaf to the JAX package's
    ``init_whisper_params(config, seed)`` (``random_params_like``): leaves
    drawn in JAX's flattening order (sorted keys, depth first); LayerNorm
    scales ones, biases zeros, everything else normal * ``scale``."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for name in sorted(node):
            child = node[name]
            if isinstance(child, dict):
                out[name] = walk(child)
            elif name == "scale" or name.endswith("_scale"):
                out[name] = np.ones(child, np.float32)
            elif name == "bias":
                out[name] = np.zeros(child, np.float32)
            else:
                out[name] = (rng.standard_normal(child) * scale).astype(np.float32)
        return out

    return walk(param_shapes(config))


def quantize_params(
    params: dict, *, embedding_keys: tuple[str, ...] = ("token_embedding",), scope: str = "all", bits: int = 8
) -> dict:
    """Host-side tree transform: fp kernels → (int kernel, kernel_scale).

    Port of ``whisperx_tpu/models/whisper.py:quantize_params``. Every rank-2
    "kernel" leaf becomes symmetric per-output-channel int8, or int4 with
    ``bits=4`` (int8 arrays of values in [-7, 7], where the JAX tree holds
    int4 ones: ``load_jax_params`` packs them); conv kernels (rank 3) stay
    fp; token embeddings become per-row int8 at either width. ``scope``:
    "all" or one top-level subtree name ("decoder"/"encoder").
    """
    if scope != "all":
        return {
            name: quantize_params(child, embedding_keys=embedding_keys, bits=bits) if name == scope else child
            for name, child in params.items()
        }
    qmax = 7 if bits == 4 else 127

    def walk(node):
        out = {}
        for name, child in node.items():
            if isinstance(child, dict):
                out[name] = walk(child)
                continue
            arr = np.asarray(child)
            if name == "kernel" and arr.ndim == 2:
                arr = arr.astype(np.float32)
                s = np.maximum(np.max(np.abs(arr), axis=0) / qmax, 1e-12)
                out[name] = np.clip(np.round(arr / s), -qmax, qmax).astype(np.int8)
                out["kernel_scale"] = s.astype(np.float32)
            elif name in embedding_keys and arr.ndim == 2:
                arr = arr.astype(np.float32)
                s = np.maximum(np.max(np.abs(arr), axis=1, keepdims=True) / 127.0, 1e-12)
                out[name] = np.clip(np.round(arr / s), -127, 127).astype(np.int8)
                out[name + "_scale"] = s[:, 0].astype(np.float32)
            else:
                out[name] = child
        return out

    return walk(params)


def fuse_qkv_params(params: dict) -> dict:
    """Host-side tree transform: self-attention {query,key,value} → one qkv.

    Port of ``whisperx_tpu/models/whisper.py:fuse_qkv_params``: kernels (int8,
    int8-valued int4 or fp) and kernel scales concatenate along the output
    dim in q|k|v order; the key projection has no bias, so its bias slot is
    zeros. Cross-attention subtrees stay unfused.
    """

    def fuse(attn: dict) -> dict:
        q, k, v = attn["query"], attn["key"], attn["value"]

        def cat(name):
            return np.concatenate([np.asarray(q[name]), np.asarray(k[name]), np.asarray(v[name])], axis=-1)

        qkv = {"kernel": cat("kernel")}
        if "kernel_scale" in q:
            qkv["kernel_scale"] = cat("kernel_scale")
        qb = np.asarray(q["bias"])
        qkv["bias"] = np.concatenate([qb, np.zeros_like(qb), np.asarray(v["bias"])], axis=-1)
        out = {name: child for name, child in attn.items() if name not in ("query", "key", "value")}
        out["qkv"] = qkv
        return out

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for name, child in node.items():
            if name == "attn" and isinstance(child, dict) and "query" in child:
                out[name] = fuse({k: walk(c) for k, c in child.items()})
            else:
                out[name] = walk(child)
        return out

    return walk(params)
