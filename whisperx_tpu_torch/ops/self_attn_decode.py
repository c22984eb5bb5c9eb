"""The decoder's self-attention over its static self cache.

Port of the cached branch of ``whisperx_tpu/models/whisper.py``'s
``MultiHeadAttention`` (``:400-446``), which XLA runs on the TPU: the new
tokens' k and v go into the cache at their positions (int8 or int4 with
per-(token, head) scales, or the cache's float type), then each query
attends causally over the cache: fp32 logits of the q and k rounded to the
compute type, times Dh^-0.5 (as Dh^-0.25 on each side) and the k scales, an
fp32 softmax, the weights times the v scales rounded to the compute type,
and the V product accumulated in fp32.

:func:`self_attention_plain` is that in plain PyTorch: every route but the
kernel's, and the kernel's oracle. :func:`self_attention_decode` launches
the hand-written Hopper kernel ``csrc/self_attn_decode.cu`` on a CUDA
tensor (or raises), and runs the plain version on a CPU tensor.
:func:`resolve_self_attn_impl` is the rule between the two.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from .attention import attend
from .quant import PACKED_INT4, store_kv

HEAD_DIM = 64
MAX_SLOTS = 448  # Whisper's n_text_ctx: the longest self cache

# Kernel launches since the last reset (chip_smoke.py zeroes and reads it).
launches = 0


def resolve_self_attn_impl(device, dtype: torch.dtype, cache_dtype: torch.dtype, head_dim: int, tokens: int) -> str:
    """"kernel" where the step is in the kernel's contract: a CUDA
    ``device``, bf16 compute, a self cache of int8 or bf16, heads of 64 and
    one query token a row. There the kernel reads each filled slot once,
    where the plain version casts the whole cache to bf16 and runs 36
    small kernels a layer. Elsewhere "plain": the CPU, fp32 models, the
    packed int4 cache and the prompt pass (more than one token)."""
    kernel = (
        torch.device(device).type == "cuda"
        and dtype == torch.bfloat16
        and cache_dtype in (torch.int8, torch.bfloat16)
        and head_dim == HEAD_DIM
        and tokens == 1
    )
    return "kernel" if kernel else "plain"


def self_attention_plain(
    q: torch.Tensor,  # (rows, T, width) fp32 projections
    k: torch.Tensor,
    v: torch.Tensor,
    cache: dict,  # one layer's {"k", "v"[, "k_scale", "v_scale"]}, (rows, S, H, ·)
    positions: torch.Tensor,  # (T,) int64: the cache slots of the tokens
    mask: Optional[torch.Tensor],  # additive (T, S): query t sees slots [0, positions[t]]
    dtype: torch.dtype,
) -> torch.Tensor:
    """Store k and v at ``positions`` (quantized for an int8 or packed
    int4 cache, else cast to the cache's type), then attend with q scaled
    by Dh**-0.25 in fp32 and rounded to ``dtype`` once. Returns (rows, T,
    width) in ``dtype``; the cache is written in place."""
    rows, T, width = q.shape
    H = cache["k"].shape[2]
    Dh = width // H
    scale = Dh**-0.25
    q = (q.reshape(rows, T, H, Dh) * scale).to(dtype)
    k, v = k.reshape(rows, T, H, Dh), v.reshape(rows, T, H, Dh)
    ks = vs = None
    if cache["k"].dtype in (torch.int8, PACKED_INT4):
        bits = 4 if cache["k"].dtype == PACKED_INT4 else 8
        qk, kss = store_kv(k, bits)
        qv, vss = store_kv(v, bits)
        for name, val in (("k", qk), ("v", qv), ("k_scale", kss), ("v_scale", vss)):
            cache[name].index_copy_(1, positions, val)
        ks, vs = cache["k_scale"], cache["v_scale"]
    else:
        cache["k"].index_copy_(1, positions, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, positions, v.to(cache["v"].dtype))
    return attend(q, cache["k"], cache["v"], ks, vs, mask, dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("self_attn_decode")
    lib.self_attn_decode.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    lib.self_attn_decode.restype = ctypes.c_int
    return lib


def _describe(*tensors) -> str:
    return ", ".join(
        f"{tuple(t.shape)} {t.dtype} {t.device} strides={t.stride()}" for t in tensors if t is not None
    )


def self_attention_decode(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cache: dict,
    positions: torch.Tensor,
    mask: torch.Tensor,
    dtype: torch.dtype,
) -> torch.Tensor:
    """:func:`self_attention_plain` for one token a row: (rows, 1, width)
    fp32 q, k and v (views of a fused projection's output are taken as
    they are), one layer's int8 or bf16 ``cache`` of S ≤ 448 slots and
    heads of 64, bf16 ``dtype``. Returns (rows, 1, width) bf16 and writes
    slot ``positions[0]`` of the cache.

    On the card the kernel reads the position on the device and only the
    slots up to it, so ``mask`` is not read; a CPU tensor runs the plain
    version. Raises ValueError for operands outside the
    contract; on CUDA also for q, k, v not fp32 or without unit stride in
    their last dim or with unequal row strides, a cache not contiguous or
    not 16-byte aligned, scales not fp32, or operands on another device.
    """
    global launches
    rows, T, width = q.shape
    ck, cv = cache["k"], cache["v"]
    S, H = ck.shape[1], ck.shape[2]
    kv_int8 = ck.dtype == torch.int8
    ks, vs = (cache["k_scale"], cache["v_scale"]) if kv_int8 else (None, None)
    if not (
        T == 1
        and dtype == torch.bfloat16
        and ck.dtype in (torch.int8, torch.bfloat16)
        and cv.dtype == ck.dtype
        and k.shape == q.shape == v.shape
        and ck.shape == cv.shape == (rows, S, H, HEAD_DIM)
        and width == H * HEAD_DIM
        and 1 <= S <= MAX_SLOTS
        and positions.shape == (1,)
        and (not kv_int8 or ks.shape == vs.shape == (rows, S, H, 1))
    ):
        raise ValueError(
            f"self_attention_decode: operands outside the contract ({dtype}): "
            f"{_describe(q, k, v, ck, cv, ks, vs, positions)}"
        )
    if q.device.type == "cpu":
        return self_attention_plain(q, k, v, cache, positions, mask, dtype)
    caches = [t for t in (ck, cv, ks, vs) if t is not None]
    if not (
        q.device.type == "cuda"
        and all(t.dtype == torch.float32 and t.stride(-1) == 1 and t.stride(0) == q.stride(0) for t in (q, k, v))
        and positions.dtype == torch.int64
        and all(t.device == q.device for t in (k, v, positions, *caches))
        and all(t.is_contiguous() for t in caches)
        and all(t.dtype == torch.float32 for t in caches[2:])
        and ck.data_ptr() % 16 == 0
        and cv.data_ptr() % 16 == 0
    ):
        raise ValueError(
            f"self_attention_decode: operands outside the kernel's contract: "
            f"{_describe(q, k, v, ck, cv, ks, vs, positions)}"
        )
    lib = _lib()
    out = torch.empty((rows, 1, width), dtype=torch.bfloat16, device=q.device)
    with torch.cuda.device(q.device):
        code = lib.self_attn_decode(
            q.data_ptr(),
            k.data_ptr(),
            v.data_ptr(),
            q.stride(0),
            ck.data_ptr(),
            cv.data_ptr(),
            ks.data_ptr() if kv_int8 else None,
            vs.data_ptr() if kv_int8 else None,
            positions.data_ptr(),
            out.data_ptr(),
            rows,
            H,
            S,
            int(kv_int8),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, code, "self_attn_decode")
    launches += 1
    return out
