"""Weight-only int8 matmul for the decode path.

Port of ``whisperx_tpu/ops/pallas_int8_mm.py:int8_matmul``:
``y = (bf16(x) @ bf16(w_int8)) * scale + bias`` with fp32 accumulation and
an fp32 epilogue, cast to ``out_dtype``. ``x`` is always rounded to bf16,
as the Pallas kernel does, even for an fp32 model.

On a CUDA tensor :func:`int8_matmul` launches the hand-written Hopper kernel
``csrc/int8_mm.cu`` (or raises); on a CPU tensor it runs
:func:`int8_matmul_plain`, the same function in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build

# Max rows the kernel accepts (beam decode: batch*beams; prompts: batch*P).
# Above this, callers use the dequantize-and-matmul path.
MAX_ROWS = 256
_TILE = 64  # the kernel's M, N and K tile
_TARGET_CTAS = 264  # about two CTAs per SM of an H100's 132
_MAX_SPLITS = 8  # the K splits of one output tile form one (portable-size) cluster

# Kernel launches since the last reset (chip_smoke.py zeroes and reads it).
launches = 0


def int8_matmul_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the CPU path and its oracle)."""
    y = torch.matmul(x.to(torch.bfloat16).float(), w.float()) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


@functools.lru_cache(maxsize=None)
def split_k(M: int, K: int, N: int) -> tuple[int, int]:
    """(splits, K tiles per split): split K across up to ``_MAX_SPLITS`` CTAs
    until the grid holds about ``_TARGET_CTAS`` CTAs. Every split gets at
    least one K tile."""
    k_tiles = K // _TILE
    tiles = (N // _TILE) * math.ceil(M / _TILE)
    want = max(1, min(k_tiles, _MAX_SPLITS, math.ceil(_TARGET_CTAS / tiles)))
    per_split = math.ceil(k_tiles / want)
    return math.ceil(k_tiles / per_split), per_split


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("int8_mm")
    lib.int8_mm.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.int8_mm.restype = ctypes.c_int
    return lib


def _bad_args(x, w, scale, bias, out_dtype) -> bool:
    N = w.shape[1]
    return not (
        x.shape[1] % _TILE == 0
        and w.dtype == torch.int8
        and w.is_contiguous()
        and w.data_ptr() % 16 == 0
        and w.device == x.device
        and scale.dtype == torch.float32
        and scale.shape == (N,)
        and scale.is_contiguous()
        and scale.device == x.device
        and (
            bias is None
            or (bias.dtype == torch.float32 and bias.shape == (N,) and bias.is_contiguous() and bias.device == x.device)
        )
        and out_dtype in (torch.bfloat16, torch.float32)
    )


def _describe(*tensors) -> str:
    return ", ".join(
        "None" if t is None else f"{tuple(t.shape)} {t.dtype} {t.device} contiguous={t.is_contiguous()}"
        for t in tensors
    )


def int8_matmul(
    x: torch.Tensor,  # (M, K), M <= MAX_ROWS
    w: torch.Tensor,  # (K, N) int8
    scale: torch.Tensor,  # (N,) fp32 per output channel
    bias: Optional[torch.Tensor] = None,  # (N,) fp32
    *,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """y = (bf16(x) @ dequant(w)) * scale + bias; the kernel on CUDA tensors.

    Raises ValueError for operands outside the contract: 2-D x and w,
    M <= MAX_ROWS, N % 128 == 0; on CUDA also K % 64 == 0, a contiguous
    16-byte-aligned int8 w, contiguous fp32 scale/bias of shape (N,), all on
    x's device, out_dtype bf16 or fp32.
    """
    global launches
    if not (x.ndim == 2 and w.ndim == 2 and x.shape[1] == w.shape[0] and 0 < x.shape[0] <= MAX_ROWS
            and w.shape[1] % 128 == 0):
        raise ValueError(f"int8_matmul: shapes outside the contract: x, w = {_describe(x, w)}")
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w, scale, bias, out_dtype=out_dtype)
    if x.device.type != "cuda" or _bad_args(x, w, scale, bias, out_dtype):
        raise ValueError(
            f"int8_matmul: operands outside the kernel's contract (out_dtype {out_dtype}): "
            f"x, w, scale, bias = {_describe(x, w, scale, bias)}"
        )
    M, K = x.shape
    N = w.shape[1]
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:
        raise ValueError("int8_matmul: x must start on a 16-byte boundary")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    splits, per_split = split_k(M, K, N)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.int8_mm(
            xb.data_ptr(),
            w.data_ptr(),
            scale.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            out.data_ptr(),
            M,
            K,
            N,
            splits,
            per_split,
            int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, code, "int8_mm")
    launches += 1
    return out
