"""Flash self-attention for the encoder stacks.

Port of the flash branch of ``whisperx_tpu/ops/attention.py:
fused_self_attention`` (the stock Pallas TPU kernel, ``:90-123``):
bidirectional softmax(q kᵀ) v over (B, T, H, 64) bf16 tensors whose q and k
each carry Dh**-0.25 (so no further scale), with an optional (B, T) key mask
(1 = valid key). Excluded keys get no weight, as the reference's additive
-1e9 gives them; every query row, padded ones too, attends the valid keys.

On a CUDA tensor :func:`flash_attention` launches the hand-written Hopper
kernel ``csrc/flash_attn.cu`` (or raises); on a CPU tensor it runs
:func:`flash_attention_plain`, the kernel's function in plain PyTorch. Both
take bf16 only and raise on anything else: a float32 model uses the "xla"
path of ``ops/attention.py``.

Numerics differ from the reference's naive path by design: the reference
rounds the *normalised* weights to bf16 before the V product, the kernel
rounds exp(s - m) and divides by the fp32 sum at the end. Both are within
2e-3 of the fp32 function at unit-scale inputs (``tests/test_torch_attention.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build

HEAD_DIM = 64

# Kernel launches since the last reset (chip_smoke.py zeroes and reads it).
launches = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pad_mask: Optional[torch.Tensor]) -> None:
    if not (q.ndim == 4 and k.shape == q.shape and v.shape == q.shape):
        raise ValueError(f"flash_attention: q, k, v must share a (B, T, H, Dh) shape: {_describe(q, k, v)}")
    B, T, H, Dh = q.shape
    if Dh != HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {Dh} is not supported: the kernel takes Dh = {HEAD_DIM}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(
            f"flash_attention takes bf16 q, k, v, got {q.dtype}, {k.dtype}, {v.dtype}; "
            "a float32 model runs the 'xla' attention"
        )
    if pad_mask is not None and tuple(pad_mask.shape) != (B, T):
        raise ValueError(f"flash_attention: pad_mask must be (B, T) = {(B, T)}, got {tuple(pad_mask.shape)}")


def flash_attention_plain(
    q: torch.Tensor,  # (B, T, H, 64) bf16, pre-scaled
    k: torch.Tensor,  # (B, T, H, 64) bf16, pre-scaled
    v: torch.Tensor,  # (B, T, H, 64) bf16
    pad_mask: Optional[torch.Tensor] = None,  # (B, T), nonzero = valid key
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the CPU path and its oracle):
    fp32 logits, excluded keys at -inf, p = exp(s - max) rounded to bf16 for
    the V product, the fp32 sum of p divided out at the end, bf16 out. A row
    without a valid key gives zeros."""
    _check(q, k, v, pad_mask)
    s = torch.matmul(q.float().permute(0, 2, 1, 3), k.float().permute(0, 2, 3, 1))  # (B, H, T, T)
    if pad_mask is not None:
        s = s.masked_fill(~pad_mask.bool()[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(torch.bfloat16).float(), v.float().permute(0, 2, 1, 3))
    o = torch.where(l > 0, o / l, torch.zeros_like(o))
    return o.permute(0, 2, 1, 3).to(torch.bfloat16)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attn")
    lib.flash_attn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 8 + [ctypes.c_void_p]
    )
    lib.flash_attn.restype = ctypes.c_int
    return lib


def _describe(*tensors) -> str:
    return ", ".join(f"{tuple(t.shape)} {t.dtype} {t.device} strides={t.stride()}" for t in tensors)


def _kernel_layout(t: torch.Tensor) -> bool:
    """Head and head dim contiguous, 16-byte aligned rows."""
    sb, st, sh, sd = t.stride()
    return sd == 1 and sh == HEAD_DIM and st % 8 == 0 and sb % 8 == 0 and t.data_ptr() % 16 == 0


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pad_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Bidirectional self-attention, (B, T, H, 64) bf16 → (B, T, H, 64) bf16.

    Raises ValueError/TypeError for operands outside the contract (shapes,
    a head dim other than 64, a type other than bf16); on CUDA also for
    tensors on different devices or whose head rows are not contiguous and
    16-byte aligned (batch and time strides are free).
    """
    global launches
    _check(q, k, v, pad_mask)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, pad_mask)
    B, T, H, _ = q.shape
    mask = None if pad_mask is None else pad_mask.to(device=q.device, dtype=torch.bool).contiguous()
    if not (
        q.device.type == "cuda"
        and all(t.device == q.device and _kernel_layout(t) for t in (q, k, v))
        and (mask is None or mask.device == q.device)
    ):
        raise ValueError(f"flash_attention: operands outside the kernel's contract: {_describe(q, k, v)}")
    out = torch.empty((B, T, H, HEAD_DIM), dtype=torch.bfloat16, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        code = lib.flash_attn(
            q.data_ptr(),
            k.data_ptr(),
            v.data_ptr(),
            None if mask is None else mask.data_ptr(),
            out.data_ptr(),
            B,
            T,
            H,
            q.stride(0),
            q.stride(1),
            k.stride(0),
            k.stride(1),
            v.stride(0),
            v.stride(1),
            out.stride(0),
            out.stride(1),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, code, "flash_attn")
    launches += 1
    return out
