"""Bidirectional self-attention for the encoder stacks.

Port of ``whisperx_tpu/ops/attention.py``. :func:`fused_self_attention`
dispatches between two paths for (B, T, H, Dh) q, k, v whose q and k each
carry Dh**-0.25:

- "xla": :func:`_naive`, matmul → fp32 softmax → matmul as XLA runs it, with
  an optional (B, T) key mask applied as an additive ``neg_mask``. The logits
  are materialized ((B, H, T, T) fp32: 1.44 GB per layer at large-v2 batch 8).
- "flash": ``ops/flash_attn.py``, the hand-written Hopper flash kernel (on
  CPU tensors its plain version), which never materializes the logits.

:func:`resolve_attn_impl` picks the path from the call's tensors: the kernel
where they are in its contract, bf16 on a CUDA device with heads of
:data:`~.flash_attn.HEAD_DIM`. Everywhere else, the CPU and fp32 models
among them, "xla", the JAX package's default.

:func:`attend` is the decoders' plain attention of a few queries over K/V
that may be int8 or packed int4 with per-(token, head) scales: the cached
self-attention's plain version (``ops/self_attn_decode.py``), the
cross-attention's einsum route and the encoders' masked or one-frame calls.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attn import HEAD_DIM, flash_attention
from .quant import PACKED_INT4, unpack_int4


def resolve_attn_impl(device, dtype: torch.dtype, head_dim: int) -> str:
    """"flash" where the call's q, k, v are on a CUDA ``device``, of
    ``dtype`` bf16 and ``head_dim`` 64 (the kernel's contract): there the
    kernel reads q, k and v once, where "xla" writes and reads (B, H, T, T)
    fp32 logits, their softmax and its bf16 copy. Elsewhere "xla", the JAX
    package's default (``whisperx_tpu/ops/attention.py:41-64``)."""
    kernel = torch.device(device).type == "cuda" and dtype == torch.bfloat16 and head_dim == HEAD_DIM
    return "flash" if kernel else "xla"


class _BmmF32(torch.autograd.Function):
    """``bmm(a, b, out_dtype=float32)`` with a gradient (the overload has no
    derivative of its own). The backward is what the CPU route's autograd
    gives: the fp32 gradient times the other operand in fp32, rounded to
    each operand's type."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype)
        return da, db


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.to(a.dtype)`` accumulated and returned in fp32: JAX's
    ``preferred_element_type=float32``. ``a`` is (..., M, K), ``b`` is
    (..., K, N) with the same leading dims, or (K, N).

    bf16 on CUDA goes to ``bmm(..., out_dtype=float32)`` (tensor cores,
    fp32 accumulation; differentiable through :class:`_BmmF32`); everything
    else is an fp32 ``matmul`` of the same values.
    """
    b = b.to(a.dtype)
    if not (a.is_cuda and a.dtype == torch.bfloat16):
        return torch.matmul(a.float(), b.float())
    lead = a.shape[:-2]
    a3 = a.reshape(-1, *a.shape[-2:])
    b3 = b[None] if b.ndim == 2 else b.reshape(-1, *b.shape[-2:])
    if b.ndim == 2:
        a3 = a3.reshape(1, -1, a.shape[-1])
    if torch.is_grad_enabled() and (a3.requires_grad or b3.requires_grad):
        out = _BmmF32.apply(a3, b3)
    else:
        out = torch.bmm(a3, b3, out_dtype=torch.float32)
    return out.reshape(*lead, a.shape[-2], b.shape[-1])


def attend(
    q: torch.Tensor,  # (B, Tq, H, Dh) in dtype, carrying Dh**-0.25
    k: torch.Tensor,  # (Bkv, Tk, H, Dh), or packed int4 (Bkv, Tk, H, Dh / 2)
    v: torch.Tensor,
    ks: Optional[torch.Tensor],  # (Bkv, Tk, H, 1) fp32 scales of int8/int4 k, else None
    vs: Optional[torch.Tensor],
    mask: Optional[torch.Tensor],  # additive, broadcastable to (Bkv, H, Tq, Tk)
    dtype: torch.dtype,
) -> torch.Tensor:
    """Attention of ``q`` over ``k``/``v`` → (B, Tq, H * Dh) in ``dtype``.

    int8/int4 K/V carry per-(token, head) scales that commute with both
    contractions, so they scale the logits and the weights instead of
    dequantizing the cache. Beam grouping: K/V shared by the beams of one
    batch element (B = group * Bkv) fold the beams into the query-time
    axis."""
    if k.dtype == PACKED_INT4:  # int4 cache or cross K/V: unpacked once per use
        k, v = unpack_int4(k), unpack_int4(v)
    rows, Tq, H, Dh = q.shape
    group = rows // k.shape[0]
    if group > 1:
        q = q.reshape(k.shape[0], group * Tq, H, Dh)

    logits = matmul_f32(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1))  # (B, H, Tq, Tk)
    logits = logits * Dh**-0.25
    if ks is not None:
        logits = logits * ks[..., 0].transpose(1, 2)[:, :, None, :]
    if mask is not None:
        logits = logits + mask
    weights = torch.softmax(logits, dim=-1)
    if vs is not None:
        weights = weights * vs[..., 0].transpose(1, 2)[:, :, None, :]
    out = torch.matmul(weights.to(dtype), v.to(dtype).permute(0, 2, 1, 3))  # (B, H, Tq, Dh)
    return out.permute(0, 2, 1, 3).reshape(rows, Tq, H * Dh)


def _naive(
    q: torch.Tensor,  # (B, T, H, Dh), pre-scaled by Dh**-0.25
    k: torch.Tensor,  # (B, T, H, Dh), pre-scaled by Dh**-0.25
    v: torch.Tensor,  # (B, T, H, Dh)
    pad_mask: Optional[torch.Tensor],  # (B, T), nonzero = valid key
    neg_mask: float,
) -> torch.Tensor:
    """The reference's path (``whisperx_tpu/ops/attention.py:67-72``):
    fp32 logits, additive ``neg_mask`` on excluded keys, fp32 softmax, the
    weights rounded to v's type before the V product."""
    logits = matmul_f32(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1))  # (B, H, T, T)
    if pad_mask is not None:
        add = torch.where(pad_mask.bool(), 0.0, neg_mask).to(device=logits.device, dtype=torch.float32)
        logits = logits + add[:, None, None, :]
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(w, v.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)


def fused_self_attention(
    q: torch.Tensor,  # (B, T, H, Dh), pre-scaled
    k: torch.Tensor,  # (B, T, H, Dh), pre-scaled
    v: torch.Tensor,  # (B, T, H, Dh)
    pad_mask: Optional[torch.Tensor] = None,  # (B, T) bool/int, 1 = valid key
    *,
    neg_mask: float = -1e9,
) -> torch.Tensor:
    """Bidirectional self-attention, (B, T, H, Dh) → (B, T, H, Dh), on the
    path :func:`resolve_attn_impl` gives for these tensors."""
    if resolve_attn_impl(q.device, q.dtype, q.shape[-1]) == "xla":
        return _naive(q, k, v, pad_mask, neg_mask)
    return flash_attention(q, k, v, pad_mask)
