"""Decode-step cross attention over int8 (or bf16) encoder K/V.

Port of ``whisperx_tpu/ops/pallas_cross_attn.py:cross_attention_decode``.
Per batch element, G query rows (pre-scaled by 1/sqrt(Dh)) attend over S
keys: logits times ``k_scale``, fp32 softmax, weights times ``v_scale`` and
rounded to bf16 (as the Pallas kernel does before its V product), then the
weighted sum of V in fp32. Layouts are the JAX package's flat ones
(``models/whisper.py:FlatCrossKV``).

On a CUDA tensor :func:`cross_attention_decode` launches the hand-written
Hopper kernel ``csrc/cross_attn.cu`` (or raises); on a CPU tensor it runs
:func:`cross_attention_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

HEAD_DIM = 64
_MAX_SMEM_BYTES = 232_448  # per-block dynamic shared memory on Hopper

# Kernel launches since the last reset (chip_smoke.py zeroes and reads it).
launches = 0


def cross_attention_plain(
    q: torch.Tensor,  # (B, G, D) bf16
    k: torch.Tensor,  # (B, S, D) int8 or bf16
    v: torch.Tensor,  # (B, S, D) int8 or bf16
    k_scale: torch.Tensor,  # (B, H, S) fp32
    v_scale: torch.Tensor,  # (B, H, S) fp32
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the CPU path and its oracle)."""
    B, G, D = q.shape
    S = k.shape[1]
    H = k_scale.shape[1]
    qh = q.float().reshape(B, G, H, HEAD_DIM).permute(0, 2, 1, 3)  # (B, H, G, Dh)
    kh = k.float().reshape(B, S, H, HEAD_DIM).permute(0, 2, 3, 1)  # (B, H, Dh, S)
    vh = v.float().reshape(B, S, H, HEAD_DIM).permute(0, 2, 1, 3)  # (B, H, S, Dh)
    logits = torch.matmul(qh, kh) * k_scale.float()[:, :, None, :]
    w = torch.softmax(logits, dim=-1) * v_scale.float()[:, :, None, :]
    w = w.to(torch.bfloat16).float()
    out = torch.matmul(w, vh)  # (B, H, G, Dh)
    return out.permute(0, 2, 1, 3).reshape(B, G, D)


@functools.lru_cache(maxsize=None)
def _smem_bytes(lib: ctypes.CDLL, S: int, kv_int8: bool) -> int:
    return lib.cross_attn_smem_bytes(S, int(kv_int8))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("cross_attn")
    lib.cross_attn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.cross_attn.restype = ctypes.c_int
    lib.cross_attn_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.cross_attn_smem_bytes.restype = ctypes.c_longlong
    return lib


def _describe(*tensors) -> str:
    return ", ".join(f"{tuple(t.shape)} {t.dtype} {t.device} contiguous={t.is_contiguous()}" for t in tensors)


def cross_attention_decode(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
) -> torch.Tensor:
    """Fused decode-step cross attention; returns (B, G, D) fp32.

    ``q`` must already carry the full 1/sqrt(Dh) logit scaling. Head dim 64
    and an even head count, as the Pallas kernel requires. Raises ValueError
    for operands outside the contract; on CUDA also for q not bf16, K/V not
    both int8 or both bf16, scales not fp32, operands not contiguous, on
    another device, or shapes that need more shared memory than a block has.
    """
    global launches
    B, G, D = q.shape
    S = k.shape[1]
    H = k_scale.shape[1]
    if not (
        D % 128 == 0 and D == H * HEAD_DIM and H % 2 == 0
        and k.shape == (B, S, D) and v.shape == (B, S, D)
        and k_scale.shape == (B, H, S) and v_scale.shape == (B, H, S)
    ):
        raise ValueError(f"cross_attention_decode: shapes outside the contract: {_describe(q, k, v, k_scale, v_scale)}")
    if q.device.type == "cpu":
        return cross_attention_plain(q, k, v, k_scale, v_scale)
    tensors = (q, k, v, k_scale, v_scale)
    if not (
        q.device.type == "cuda"
        and q.dtype == torch.bfloat16
        and k.dtype == v.dtype
        and k.dtype in (torch.int8, torch.bfloat16)
        and k_scale.dtype == torch.float32
        and v_scale.dtype == torch.float32
        and all(t.device == q.device and t.is_contiguous() for t in tensors)
        and k.data_ptr() % 16 == 0
        and v.data_ptr() % 16 == 0
    ):
        raise ValueError(f"cross_attention_decode: operands outside the kernel's contract: {_describe(*tensors)}")
    lib = _lib()
    smem = _smem_bytes(lib, S, k.dtype == torch.int8)
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(f"cross_attention_decode: S={S} needs {smem} B of shared memory per block")

    out = torch.empty((B, G, D), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        code = lib.cross_attn(
            q.data_ptr(),
            k.data_ptr(),
            v.data_ptr(),
            k_scale.data_ptr(),
            v_scale.data_ptr(),
            out.data_ptr(),
            B,
            G,
            S,
            H,
            int(k.dtype == torch.int8),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, code, "cross_attn")
    launches += 1
    return out
