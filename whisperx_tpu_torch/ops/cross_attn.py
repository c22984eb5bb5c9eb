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
import math
from typing import NamedTuple

import torch

from . import _build

HEAD_DIM = 64
_CHUNK = 64  # positions per TMA box (csrc/cross_attn.cu CHUNK)
_RING = 4  # chunk slots (RING)
_QB = 8  # query rows per pass (QB)
_WARPS = 4  # warps per CTA (WARPS)
_MAX_CLUSTER = 8  # CTAs per (b, h): one portable-size cluster
# Positions a CTA takes before S is split: a split S rescales partial sums,
# whose last-ulp differences can turn the bf16 rounding of a weight, which
# costs ~|v| / S^2 (2e-4 at S = 65): only long rows are split.
_MIN_ROWS = 256
_MAX_SMEM_BYTES = 232_448  # per-block dynamic shared memory on Hopper

# Kernel launches since the last reset (chip_smoke.py zeroes and reads it).
launches = 0


class LaunchPlan(NamedTuple):
    """Grid (cluster, H, B): ``cluster`` CTAs per (b, h), each owning
    ``rows_pad`` consecutive positions (the last one the rest of S)."""

    cluster: int
    rows_pad: int
    smem_bytes: int


def smem_bytes(rows_pad: int, kv_int8: bool) -> int:
    """csrc/cross_attn.cu:Layout.total: the chunk ring, the fp32 logits of 8
    query rows (or the warps' partial outputs, if larger), both scale rows,
    the partial outputs and (max, sum) pairs received from the cluster, the
    mbarriers, + 1 KB to align the base."""
    row = HEAD_DIM * (1 if kv_int8 else 2)
    lg = max(_QB * (rows_pad + 4) * 4, _WARPS * _QB * HEAD_DIM * 4)
    recv = (_QB * HEAD_DIM + _MAX_CLUSTER) * 4
    return _RING * _CHUNK * row + lg + 2 * rows_pad * 4 + recv + _MAX_CLUSTER * _QB * 2 * 4 + 2 * _RING * 8 + 1024


def launch_plan(B: int, S: int, H: int, kv_int8: bool, max_clusters=None) -> LaunchPlan:
    """Split S over a cluster of up to ``_MAX_CLUSTER`` CTAs of about
    ``_MIN_ROWS`` positions or more: the largest split that fits in shared
    memory and, where ``max_clusters(rows_pad, cluster)`` says how many
    clusters the card holds at once, whose B * H clusters all fit (one wave);
    else the largest that fits. Raises ValueError if no split fits."""
    fits = []
    for cluster in range(min(_MAX_CLUSTER, math.ceil(S / _MIN_ROWS)), 0, -1):
        rows_pad = _CHUNK * math.ceil(math.ceil(S / cluster) / _CHUNK)
        cluster = math.ceil(S / rows_pad)
        smem = smem_bytes(rows_pad, kv_int8)
        if smem > _MAX_SMEM_BYTES:
            continue
        fits.append(LaunchPlan(cluster, rows_pad, smem))
        if max_clusters is None or B * H <= max_clusters(rows_pad, cluster):
            return fits[-1]
    if not fits:
        raise ValueError(f"cross_attention_decode: S={S} needs more shared memory per block than there is")
    return fits[0]


@functools.lru_cache(maxsize=None)
def _card_plan(B: int, S: int, H: int, kv_int8: bool) -> LaunchPlan:
    lib = _lib()
    return launch_plan(B, S, H, kv_int8, lambda rows, cluster: lib.cross_attn_max_clusters(rows, cluster, int(kv_int8)))


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


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("cross_attn")
    lib.cross_attn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.cross_attn.restype = ctypes.c_int
    lib.cross_attn_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.cross_attn_smem_bytes.restype = ctypes.c_longlong
    lib.cross_attn_max_clusters.argtypes = [ctypes.c_int] * 3
    lib.cross_attn_max_clusters.restype = ctypes.c_int
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
    another device, not 16-byte aligned, or an S whose logits need more
    shared memory than a block has (S beyond ~36,000 positions).
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
        and all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    ):
        raise ValueError(f"cross_attention_decode: operands outside the kernel's contract: {_describe(*tensors)}")
    plan = _card_plan(B, S, H, k.dtype == torch.int8)
    lib = _lib()

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
            plan.cluster,
            plan.rows_pad,
            int(k.dtype == torch.int8),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, code, "cross_attn")
    launches += 1
    return out
