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
from typing import NamedTuple, Optional

import torch

from . import _build

# Max rows the kernel accepts (beam decode: batch*beams; prompts: batch*P).
# Above this, callers use the dequantize-and-matmul path.
MAX_ROWS = 256
_TILE_N = 128  # output channels per CTA (csrc/int8_mm.cu BN)
_CHUNK_K = 64  # K rows per chunk (BK)
_MAX_BM = 64  # x rows per CTA (MAX_BM)
_MAX_SPLITS = 8  # the K splits of one slab form one (portable-size) cluster
_SMS = 132  # streaming multiprocessors of an H100 SXM
_MAX_SMEM_BYTES = 232_448  # per-block dynamic shared memory on Hopper

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


class LaunchPlan(NamedTuple):
    """Grid (N / 128, m_blocks, splits); each CTA owns 128 channels, ``bm``
    x rows and ``chunks_per_split`` 64-row chunks of K, loaded through
    ``slots`` buffers (one pass when slots == chunks_per_split)."""

    bm: int
    m_blocks: int
    splits: int
    chunks_per_split: int
    slots: int
    smem_bytes: int


def smem_bytes(bm: int, slots: int, splits: int) -> int:
    """csrc/int8_mm.cu:Layout.total: W chunks (8 KB) + x chunks (bm rows of
    144 B) per slot, or three K quarters' fp32 tiles (bm x 132) if larger;
    the slab's scales and biases; one mbarrier per slot and one for the
    partial rows; with split K, the partial rows received from the cluster
    (splits x ceil(bm / splits) rows of 128 fp32); + 1 KB to align the base."""
    data = slots * (_CHUNK_K * _TILE_N + bm * (_CHUNK_K * 2 + 16))
    bar = max(data, 3 * bm * (_TILE_N + 4) * 4) + 2 * _TILE_N * 4
    recv = -(-(bar + 8 * (slots + 1)) // 16) * 16
    return recv + (splits * -(-bm // splits) * _TILE_N * 4 if splits > 1 else 0) + 1024


def launch_plan(M: int, K: int, N: int, max_clusters=None) -> LaunchPlan:
    """About one CTA per SM: x rows in blocks of <= 64, then K split across
    up to ``_MAX_SPLITS`` CTAs (a cluster) until the grid holds ~``_SMS``
    CTAs or a CTA's whole K range fits in shared memory. Every split holds
    at least one chunk. ``max_clusters(bm, slots, splits)``, where given,
    says how many clusters the card holds at once; the split is then cut
    until the grid's clusters all fit (one wave)."""
    m_blocks = math.ceil(M / _MAX_BM)
    bm = 8 * math.ceil(math.ceil(M / m_blocks) / 8)
    k_chunks = K // _CHUNK_K
    slabs = (N // _TILE_N) * m_blocks
    want = max(1, min(_MAX_SPLITS, k_chunks, round(_SMS / slabs)))
    while True:
        cps = math.ceil(k_chunks / want)
        splits = math.ceil(k_chunks / cps)
        if smem_bytes(bm, cps, splits) <= _MAX_SMEM_BYTES or want >= min(_MAX_SPLITS, k_chunks):
            break
        want += 1
    while max_clusters is not None and splits > 1 and smem_bytes(bm, cps, splits) <= _MAX_SMEM_BYTES:
        if slabs <= max_clusters(bm, cps, splits):
            break
        cps = math.ceil(k_chunks / (splits - 1))  # one split fewer, until the clusters fit
        splits = math.ceil(k_chunks / cps)
    slots = cps
    while smem_bytes(bm, slots, splits) > _MAX_SMEM_BYTES:
        slots -= 1
    return LaunchPlan(bm, m_blocks, splits, cps, slots, smem_bytes(bm, slots, splits))


@functools.lru_cache(maxsize=None)
def _card_plan(M: int, K: int, N: int) -> LaunchPlan:
    return launch_plan(M, K, N, max_clusters=_lib().int8_mm_max_clusters)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("int8_mm")
    lib.int8_mm.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.int8_mm.restype = ctypes.c_int
    lib.int8_mm_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.int8_mm_smem_bytes.restype = ctypes.c_longlong
    lib.int8_mm_max_clusters.argtypes = [ctypes.c_int] * 3
    lib.int8_mm_max_clusters.restype = ctypes.c_int
    return lib


def _bad_args(x, w, scale, bias, out_dtype) -> bool:
    N = w.shape[1]
    return not (
        x.shape[1] % _CHUNK_K == 0
        and w.dtype == torch.int8
        and w.is_contiguous()
        and w.data_ptr() % 16 == 0
        and w.device == x.device
        and scale.dtype == torch.float32
        and scale.shape == (N,)
        and scale.is_contiguous()
        and scale.data_ptr() % 16 == 0
        and scale.device == x.device
        and (
            bias is None
            or (bias.dtype == torch.float32 and bias.shape == (N,) and bias.is_contiguous()
                and bias.data_ptr() % 16 == 0 and bias.device == x.device)
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
    16-byte-aligned int8 w, contiguous 16-byte-aligned fp32 scale/bias of
    shape (N,), all on x's device, out_dtype bf16 or fp32.
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
    plan = _card_plan(M, K, N)
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
            plan.bm,
            plan.m_blocks,
            plan.splits,
            plan.chunks_per_split,
            plan.slots,
            int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, code, "int8_mm")
    launches += 1
    return out
