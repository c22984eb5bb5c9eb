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

Under autograd (an input that requires grad, grad mode on) the call goes
through :class:`FlashAttention`, the port of the stock kernel's
``custom_vjp``: its forward also writes each query row's log-sum-exp, and
its backward launches the two kernels of ``csrc/flash_attn_bwd.cu`` (dQ,
then dK/dV) on CUDA tensors and :func:`flash_attention_backward_plain` on
CPU tensors. Without grad nothing but the output is written.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build

HEAD_DIM = 64

# Kernel launches since the last reset (chip_smoke.py zeroes and reads them):
# the forward kernel (every launch, with or without lse), the forward
# launches that also wrote lse (the training path), and the two backward
# kernels.
launches = 0
launches_lse = 0
launches_bwd_dq = 0
launches_bwd_dkv = 0


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


def flash_attention_fwd_plain(
    q: torch.Tensor,  # (B, T, H, 64) bf16, pre-scaled
    k: torch.Tensor,  # (B, T, H, 64) bf16, pre-scaled
    v: torch.Tensor,  # (B, T, H, 64) bf16
    pad_mask: Optional[torch.Tensor] = None,  # (B, T), nonzero = valid key
) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch (the CPU path and its
    oracle): fp32 logits, excluded keys at -inf, p = exp(s - max) rounded to
    bf16 for the V product, the fp32 sum l of p divided out at the end, bf16
    out; and lse = max + ln(l), (B, H, T) fp32. A row without a valid key
    gives zeros and lse -inf."""
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
    lse = torch.where(l > 0, m + torch.log(l), float("-inf"))[..., 0]
    return o.permute(0, 2, 1, 3).to(torch.bfloat16).contiguous(), lse


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pad_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`flash_attention_fwd_plain`'s output alone."""
    return flash_attention_fwd_plain(q, k, v, pad_mask)[0]


def flash_attention_backward_plain(
    q: torch.Tensor,  # (B, T, H, 64) bf16, pre-scaled
    k: torch.Tensor,  # (B, T, H, 64) bf16, pre-scaled
    v: torch.Tensor,  # (B, T, H, 64) bf16
    out: torch.Tensor,  # (B, T, H, 64) bf16, the forward's output
    lse: torch.Tensor,  # (B, H, T) fp32, the forward's log-sum-exp
    dout: torch.Tensor,  # (B, T, H, 64), the output's gradient
    pad_mask: Optional[torch.Tensor] = None,  # (B, T), nonzero = valid key
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' function in plain PyTorch (the CPU path and
    their oracle), with their rounding points: P = exp(S - lse) in fp32 (0
    for an excluded key and for a row without a valid key), D = Σ dout·out,
    dV = bf16(P)ᵀ dO, dS = P (dO Vᵀ - D), dK = bf16(dS)ᵀ Q, dQ = bf16(dS) K,
    fp32 sums, bf16 (dq, dk, dv)."""
    _check(q, k, v, pad_mask)
    qf, kf, vf, of, dof = (t.float().permute(0, 2, 1, 3) for t in (q, k, v, out, dout))  # (B, H, T, 64)
    s = torch.matmul(qf, kf.transpose(-1, -2))
    keep = torch.isfinite(lse)[..., None]  # (B, H, T, 1): the row has a valid key
    if pad_mask is not None:
        keep = keep & pad_mask.bool()[:, None, None, :]
    p = torch.where(keep, torch.exp(s - torch.where(torch.isfinite(lse), lse, 0.0)[..., None]), 0.0)
    delta = (of * dof).sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.to(torch.bfloat16).float().transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    ds = ds.to(torch.bfloat16).float()
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dq = torch.matmul(ds, kf)
    return tuple(t.permute(0, 2, 1, 3).to(torch.bfloat16).contiguous() for t in (dq, dk, dv))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attn")
    lib.flash_attn.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 8 + [ctypes.c_void_p]
    )
    lib.flash_attn.restype = ctypes.c_int
    return lib


@functools.cache
def _lib_bwd() -> ctypes.CDLL:
    lib = _build.load("flash_attn_bwd")
    for fn in (lib.flash_attn_bwd_dq, lib.flash_attn_bwd_dkv):
        fn.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    lib.flash_attn_bwd_resources.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
    lib.flash_attn_bwd_resources.restype = ctypes.c_int
    return lib


def bwd_resources() -> dict:
    """What each backward kernel holds on the card (CUDA only): registers a
    thread as compiled, spilled bytes a thread and dynamic shared memory a
    CTA, from ``cudaFuncGetAttributes`` and the kernels' layouts."""
    lib = _lib_bwd()
    out = {}
    for which, name in enumerate(("flash_attention_bwd_dq", "flash_attention_bwd_dkv")):
        vals = [ctypes.c_int() for _ in range(3)]
        _build.check(lib, lib.flash_attn_bwd_resources(which, *(ctypes.byref(v) for v in vals)), name)
        out[name] = dict(zip(("registers", "spill_bytes", "smem_bytes"), (v.value for v in vals)))
    return out


def _describe(*tensors) -> str:
    return ", ".join(f"{tuple(t.shape)} {t.dtype} {t.device} strides={t.stride()}" for t in tensors)


def _kernel_layout(t: torch.Tensor) -> bool:
    """Head and head dim contiguous, 16-byte aligned rows (the stride of a
    dimension of size 1 is never stepped, so it is free)."""
    B, T, H, _ = t.shape
    sb, st, sh, sd = t.stride()
    return (
        sd == 1
        and (H == 1 or sh == HEAD_DIM)
        and (T == 1 or st % 8 == 0)
        and (B == 1 or sb % 8 == 0)
        and t.data_ptr() % 16 == 0
    )


def _cuda_operands(q, k, v, pad_mask, *more):
    """The mask as a contiguous bool array on q's device; raises unless
    every tensor lies on q's CUDA device in the kernels' layout (``more``:
    out and dout, bf16 of q's shape)."""
    mask = None if pad_mask is None else pad_mask.to(device=q.device, dtype=torch.bool).contiguous()
    if not (
        q.device.type == "cuda"
        and all(t.shape == q.shape and t.dtype == torch.bfloat16 for t in more)
        and all(t.device == q.device and _kernel_layout(t) for t in (q, k, v, *more))
    ):
        raise ValueError(f"flash_attention: operands outside the kernel's contract: {_describe(q, k, v, *more)}")
    return mask


def _row_stats(t: torch.Tensor, q: torch.Tensor, what: str) -> torch.Tensor:
    """A (B, H, T) fp32 row statistic (lse, D) on q's device, contiguous."""
    B, T, H, _ = q.shape
    if tuple(t.shape) != (B, H, T) or t.dtype != torch.float32 or t.device != q.device:
        raise ValueError(f"flash_attention: {what} must be (B, H, T) = {(B, H, T)} fp32 on {q.device}: {_describe(t)}")
    return t.contiguous()


def _forward(q, k, v, pad_mask, with_lse: bool):
    """One launch of the forward kernel: (out, lse or None)."""
    global launches, launches_lse
    B, T, H, _ = q.shape
    mask = _cuda_operands(q, k, v, pad_mask)
    out = torch.empty((B, T, H, HEAD_DIM), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device) if with_lse else None
    lib = _lib()
    with torch.cuda.device(q.device):
        code = lib.flash_attn(
            q.data_ptr(),
            k.data_ptr(),
            v.data_ptr(),
            None if mask is None else mask.data_ptr(),
            out.data_ptr(),
            None if lse is None else lse.data_ptr(),
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
    launches_lse += with_lse
    return out, lse


def _strides(*tensors) -> ctypes.Array:
    return (ctypes.c_longlong * (2 * len(tensors)))(*(s for t in tensors for s in t.stride()[:2]))


def flash_attention_bwd_dq(q, k, v, out, dout, lse, pad_mask=None) -> tuple[torch.Tensor, torch.Tensor]:
    """dQ kernel (CUDA tensors only): (dq (B, T, H, 64) bf16, D (B, H, T)
    fp32, the Σ dout·out per row that :func:`flash_attention_bwd_dkv`
    reads)."""
    global launches_bwd_dq
    _check(q, k, v, pad_mask)
    B, T, H, _ = q.shape
    mask = _cuda_operands(q, k, v, pad_mask, out, dout)
    lse = _row_stats(lse, q, "lse")
    dq = torch.empty((B, T, H, HEAD_DIM), dtype=torch.bfloat16, device=q.device)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    lib = _lib_bwd()
    with torch.cuda.device(q.device):
        code = lib.flash_attn_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            None if mask is None else mask.data_ptr(), dq.data_ptr(), delta.data_ptr(), B, T, H,
            _strides(q, k, v, out, dout), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, code, "flash_attn_bwd_dq")
    launches_bwd_dq += 1
    return dq, delta


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, pad_mask=None) -> tuple[torch.Tensor, torch.Tensor]:
    """dK/dV kernel (CUDA tensors only), after :func:`flash_attention_bwd_dq`
    gave ``delta``: (dk, dv), (B, T, H, 64) bf16."""
    global launches_bwd_dkv
    _check(q, k, v, pad_mask)
    B, T, H, _ = q.shape
    mask = _cuda_operands(q, k, v, pad_mask, dout)
    lse, delta = _row_stats(lse, q, "lse"), _row_stats(delta, q, "delta")
    dk = torch.empty((B, T, H, HEAD_DIM), dtype=torch.bfloat16, device=q.device)
    dv = torch.empty_like(dk)
    lib = _lib_bwd()
    with torch.cuda.device(q.device):
        code = lib.flash_attn_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            None if mask is None else mask.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, T, H,
            _strides(q, k, v, dout, dout), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, code, "flash_attn_bwd_dkv")
    launches_bwd_dkv += 1
    return dk, dv


def flash_attention_backward(q, k, v, out, lse, dout, pad_mask=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention`: the two backward kernels on
    CUDA tensors (dQ first, then dK/dV), the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, out, lse, dout, pad_mask)
    out, dout = (t if _kernel_layout(t) else t.contiguous() for t in (out, dout))
    dq, delta = flash_attention_bwd_dq(q, k, v, out, dout, lse, pad_mask)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, pad_mask)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with a gradient (the stock kernel's ``custom_vjp``):
    the forward keeps (q, k, v, out, lse) and the mask, the backward gives
    (dq, dk, dv). The mask takes no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, pad_mask):
        if q.device.type == "cpu":
            out, lse = flash_attention_fwd_plain(q, k, v, pad_mask)
        else:
            out, lse = _forward(q, k, v, pad_mask, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, pad_mask)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, pad_mask = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout, pad_mask)
        return dq, dk, dv, None


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
    16-byte aligned (batch and time strides are free). Differentiable in
    q, k and v through :class:`FlashAttention`.
    """
    _check(q, k, v, pad_mask)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, pad_mask)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, pad_mask)
    return _forward(q, k, v, pad_mask, with_lse=False)[0]
