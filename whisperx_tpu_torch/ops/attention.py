"""Bidirectional self-attention for the encoder stacks.

Port of the path ``whisperx_tpu/ops/attention.py:fused_self_attention``
takes, ``_naive`` (``:67-72``): ``resolve_attn_impl`` always returns "xla",
so the flash branch is not on the ported path (it is queued as a kernel of
its own). Plain matmul → fp32 softmax → matmul, as XLA runs it; the logits
are materialized ((B, H, T, T) fp32: 1.44 GB per layer at large-v2 batch 8).
"""

from __future__ import annotations

import torch


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.to(a.dtype)`` accumulated and returned in fp32: JAX's
    ``preferred_element_type=float32``. ``a`` is (..., M, K), ``b`` is
    (..., K, N) with the same leading dims, or (K, N).

    bf16 on CUDA goes to ``bmm(..., out_dtype=float32)`` (tensor cores,
    fp32 accumulation); everything else is an fp32 ``matmul`` of the same
    values.
    """
    b = b.to(a.dtype)
    if not (a.is_cuda and a.dtype == torch.bfloat16):
        return torch.matmul(a.float(), b.float())
    lead = a.shape[:-2]
    a3 = a.reshape(-1, *a.shape[-2:])
    b3 = b[None] if b.ndim == 2 else b.reshape(-1, *b.shape[-2:])
    if b.ndim == 2:
        a3 = a3.reshape(1, -1, a.shape[-1])
    out = torch.bmm(a3, b3, out_dtype=torch.float32)
    return out.reshape(*lead, a.shape[-2], b.shape[-1])


def self_attention(
    q: torch.Tensor,  # (B, T, H, Dh), pre-scaled by Dh**-0.25
    k: torch.Tensor,  # (B, T, H, Dh), pre-scaled by Dh**-0.25
    v: torch.Tensor,  # (B, T, H, Dh)
) -> torch.Tensor:
    """Bidirectional self-attention without a key mask (Whisper's encoder),
    (B, T, H, Dh) → (B, T, H, Dh)."""
    logits = matmul_f32(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1))  # (B, H, T, T)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(w, v.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)
