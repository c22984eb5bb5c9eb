#!/usr/bin/env python3
"""Time variants of the flash backward kernels against the source as it stands.

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 kernel_variants.py 'six=STAGES = 4;->STAGES = 6;' 'name=old->new|old2->new2' ...

Each argument names a variant of ``whisperx_tpu_torch/csrc/flash_attn_bwd.cu``
made by plain text substitution (``old->new``, several joined by ``|``). Every
variant and the unchanged source ("base") are built in parallel into
``whisperx_tpu_torch/_build/variants/``, checked bit for bit against "base" on
the training shape (Whisper large-v2 encoder, B 2, T 1500, H 20), and timed
there in turns (base, v1, ..., vn, vn, ..., v1, base): the device ms of the dQ
and the dK/dV kernel by CUDA-graph replay, three layers' operands rotating.
Prints each variant's ptxas register and spill lines, one line per timing
and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

import chip_smoke
from whisperx_tpu_torch.ops import _build, flash_attn


def build(variants: dict[str, str]) -> dict[str, ctypes.CDLL]:
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants.items():
        src = out_dir / f"flash_attn_bwd_{name}.cu"
        src.write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o", str(src.with_suffix(".so")), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), src)
    libs = {}
    for name, (proc, src) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        usage = [ln.split("ptxas info    : ")[-1].strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]
        print(f"{name}: " + "; ".join(usage), flush=True)
        lib = ctypes.CDLL(str(src.with_suffix(".so")))
        for fn in (lib.flash_attn_bwd_dq, lib.flash_attn_bwd_dkv):
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    source = (_build.CSRC_DIR / "flash_attn_bwd.cu").read_text()
    variants = {"base": source}
    for spec in sys.argv[1:]:
        name, subs = spec.split("=", 1)
        text = source
        for sub in subs.split("|"):
            old, new = sub.split("->")
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        variants[name] = text
    libs = build(variants)

    gen = torch.Generator(device="cuda").manual_seed(4)
    B, T, H = chip_smoke.TRAIN_SHAPE
    sets = []
    for _ in range(3):
        q, k = ((torch.randn((B, T, H, 64), device="cuda", generator=gen) * 0.35).bfloat16() for _ in range(2))
        v, dout = (torch.randn((B, T, H, 64), device="cuda", generator=gen).bfloat16() for _ in range(2))
        out, lse = flash_attn._forward(q, k, v, None, with_lse=True)
        sets.append((q, k, v, dout, out, lse))
    q, k, v, dout, out, lse = sets[0]
    want = None
    for name in [*libs, *reversed(libs)]:
        flash_attn._lib_bwd = lambda lib=libs[name]: lib  # the wrappers call _lib_bwd() at each launch
        got = flash_attn.flash_attention_backward(q, k, v, out, lse, dout)
        want = got if want is None else want
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        deltas = [flash_attn.flash_attention_bwd_dq(*s[:3], s[4], s[3], s[5])[1] for s in sets]
        ms_dq = chip_smoke.graph_ms(torch, lambda: [flash_attn.flash_attention_bwd_dq(*s[:3], s[4], s[3], s[5]) for s in sets], 20) / 3
        ms_dkv = chip_smoke.graph_ms(
            torch, lambda: [flash_attn.flash_attention_bwd_dkv(*s[:4], s[5], d) for s, d in zip(sets, deltas)], 20
        ) / 3
        print(f"{name}: dQ {ms_dq:.4f} ms, dK/dV {ms_dkv:.4f} ms, pair {ms_dq + ms_dkv:.4f} ms; bit-equal to base: {same}", flush=True)
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
