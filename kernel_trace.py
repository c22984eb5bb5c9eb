#!/usr/bin/env python3
"""Phase timeline of the decode kernels (csrc/int8_mm.cu, csrc/cross_attn.cu)
on one CUDA card.

Run from the root of a checkout: ``python3 kernel_trace.py``. Builds a traced
copy of each kernel (``nvcc -DKERNEL_TRACE``: thread 0 of every CTA writes
%globaltimer at each phase of its work), runs it once at each large-v2
decode shape with the L2 cache flushed first, and prints, per phase, the
median and the latest CTA in microseconds after the first CTA started. The
production libraries are built without the stamps.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np

PHASES = {
    "int8_mm": ("entry", "loads issued", "chunk 0 in", "products done", "K quarters summed", "partials in",
                "stored"),
    "cross_attn": ("entry", "scales in", "logits done", "exchange 1", "weights done", "P V done", "exchange 2",
                   "end"),
}


def traced_lib(name: str) -> ctypes.CDLL:
    from whisperx_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"lib{name}-trace.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-DKERNEL_TRACE", "-o", str(out), str(_build.CSRC_DIR / f"{name}.cu")]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    lib.set_trace.argtypes = [ctypes.c_void_p]
    return lib


def report(torch, name: str, what: str, lib, ctas: int, call) -> None:
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    buf = torch.zeros((ctas, 8), dtype=torch.int64, device="cuda")
    assert lib.set_trace(buf.data_ptr()) == 0
    call()  # warm-up: tensor maps, library set-up
    buf.zero_()
    flush.zero_()  # weights cold in HBM, as in the decode step
    torch.cuda.synchronize()
    call()
    torch.cuda.synchronize()
    t = buf.cpu().numpy().astype(np.float64)
    t0 = t[:, 0].min()
    cells = []
    for i, phase in enumerate(PHASES[name]):
        col = t[:, i]
        col = (col[col > 0] - t0) / 1e3
        if col.size:
            cells.append(f"{phase} {np.median(col):.2f}/{col.max():.2f}")
    print(f"{name} {what} ({ctas} CTAs), us after the first CTA's entry, median/latest: " + "; ".join(cells), flush=True)


def run(torch, libs_list) -> None:
    from whisperx_tpu_torch.models.whisper import flat_cross_kv
    from whisperx_tpu_torch.ops import _build, cross_attn, int8_mm

    libs = dict(zip(PHASES, libs_list))
    load = _build.load
    _build.load = lambda name: libs[name]
    for cached in (int8_mm._lib, int8_mm._card_plan, cross_attn._lib, cross_attn._card_plan):
        cached.cache_clear()
    try:
        _ = int8_mm._lib(), cross_attn._lib()
    finally:
        _build.load = load
    gen = torch.Generator(device="cuda").manual_seed(0)
    for K, N in ((1280, 3840), (1280, 1280), (1280, 5120), (5120, 1280)):
        M = 40
        x = torch.randn((M, K), device="cuda", generator=gen).bfloat16()
        w = torch.randint(-127, 128, (K, N), device="cuda", generator=gen, dtype=torch.int8)
        s = torch.rand((N,), device="cuda", generator=gen)
        p = int8_mm._card_plan(M, K, N)  # the plan the wrapper launches
        report(torch, "int8_mm", f"M={M} K={K} N={N}", libs["int8_mm"], N // 128 * p.m_blocks * p.splits,
               lambda: int8_mm.int8_matmul(x, w, s))
    B, G, S, H = 8, 5, 1500, 20
    q = (torch.randn((B, G, H * 64), device="cuda", generator=gen) * 0.05).bfloat16()
    f = flat_cross_kv(torch.randn((B, S, H, 64), device="cuda", generator=gen),
                      torch.randn((B, S, H, 64), device="cuda", generator=gen), True)
    p = cross_attn._card_plan(B, S, H, True)  # the plan the wrapper launches
    print(f"cross_attn: the card holds {cross_attn._lib().cross_attn_max_clusters(p.rows_pad, p.cluster, 1)} "
          f"clusters of {p.cluster} at once (grid {B * H} clusters)")
    report(torch, "cross_attn", f"B={B} G={G} S={S} H={H} int8", libs["cross_attn"], p.cluster * H * B,
           lambda: cross_attn.cross_attention_decode(q, *f))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_trace: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    run(torch, [traced_lib(name) for name in PHASES])
    return 0


if __name__ == "__main__":
    sys.exit(main())
