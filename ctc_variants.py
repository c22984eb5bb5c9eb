#!/usr/bin/env python3
"""Time variants of the CTC alignment kernel against the source as it stands.

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 ctc_variants.py [--plans 64x1,64x2] [--n 448,1280] [--parent DIR] 'name=old->new ;; old2->new2' ...

Each argument names a variant of ``whisperx_tpu_torch/csrc/ctc_align.cu``
made by plain text substitution (``old->new``, several joined by `` ;; ``). Every
variant and the unchanged source ("base") are built in parallel into
``whisperx_tpu_torch/_build/variants/`` and checked against the plain version
at the alignment path's shapes (chip_smoke.py phase 2: B 8, T 1,499, N 448,
V 32): the trellis bit for bit in trellis mode, the five outputs of align
mode (probs to 1e-6 relative). A variant that drops part of the work to
time it reports what differs instead of failing. Then each is timed at that
shape in turns (base, v1, ..., vn, vn, ..., v1, base): device ms of one
align-mode and one trellis-mode call by CUDA-graph replay, three operand sets
rotating, while nvidia-smi samples the SM clock. Variants named ``cycles*``
print their t_start output (a variant that stores a cycle count there).
``--plans KxW,...`` also times the unchanged source (and ``cycles*``; a
plan a source refuses is reported) at each given plan (K columns a lane, W
computing warps, several only at K 64; ``ops/ctc.py:plan_for``) in place of
``launch_plan``'s. ``--n N,...`` times the unchanged source in align mode at
each token count N (B 8, T 1,499, V 32, n_len N less a tenth, the
transcript's ids repeated), and with ``--parent DIR`` the wrapper
``whisperx_tpu_torch.ops.ctc.ctc_align_batch_device`` of another checkout
at DIR (its own kernel, built there) on the same operands in the same call,
in turns (base, parent, parent, base), its outputs held to the plain
version's. Prints each variant's ptxas register and spill lines, the two
probes (T dependent shuffle steps of a warp; T barriered steps of a
480-thread CTA), the card's name and power limit, and writes the SASS of
"base" to ``chiprun_out/ctc_variants/base.sass`` when ``cuobjdump`` exists.
"""

from __future__ import annotations

import ctypes
import importlib
import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke
from whisperx_tpu_torch.ops import _build, ctc


def build(variants: dict[str, str]) -> dict[str, ctypes.CDLL]:
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants.items():
        src = out_dir / f"ctc_align_{name}.cu"
        src.write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(src.with_suffix(".so")), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), src)
    libs = {}
    sass_dir = Path("chiprun_out/ctc_variants")
    cuobjdump = shutil.which("cuobjdump") or str(Path(_build.nvcc_path()).with_name("cuobjdump"))
    for name, (proc, src) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        usage = [ln.split("ptxas info    : ")[-1].strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]
        print(f"{name}: " + "; ".join(usage), flush=True)
        if name == "base" and Path(cuobjdump).exists():
            sass_dir.mkdir(parents=True, exist_ok=True)
            sass = subprocess.run([cuobjdump, "-sass", str(src.with_suffix(".so"))], capture_output=True, text=True)
            (sass_dir / f"{name}.sass").write_text(sass.stdout)
        libs[name] = ctc.declare(ctypes.CDLL(str(src.with_suffix(".so"))))
        libs[name].error_string.argtypes = [ctypes.c_int]
        libs[name].error_string.restype = ctypes.c_char_p
    return libs


def variant_sources(source: str, specs: list[str]) -> dict[str, str]:
    """{"base": source, name: source with each ``old->new`` of the spec
    ``name=old->new ;; old2->new2`` replaced}."""
    variants = {"base": source}
    for spec in specs:
        name, subs = spec.split("=", 1)
        text = source
        for sub in subs.split(" ;; "):
            old, new = sub.split("->", 1)
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        variants[name] = text
    return variants


def parent_ctc(root: Path):
    """``whisperx_tpu_torch.ops.ctc`` of the checkout at ``root``, imported
    as the package ``ctc_parent`` (its imports inside the package are
    relative, so it builds and loads its own kernel under ``root``)."""
    pkg = root / "whisperx_tpu_torch"
    spec = importlib.util.spec_from_file_location("ctc_parent", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules["ctc_parent"] = module
    spec.loader.exec_module(module)
    return importlib.import_module("ctc_parent.ops.ctc")


def time_token_counts(counts: list[int], parent) -> None:
    """Align-mode ms of the source as it stands (and of ``parent``'s
    wrapper) at B 8, T 1,499, V 32 and each token count."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    ids, V, T, _, t_path = chip_smoke.ctc_alignment_case()
    for N in counts:
        n_len = N - N // 10
        sets = [chip_smoke.ctc_operands(torch, gen, ids, V, T, N, t_path, [n_len] * len(t_path)) for _ in range(3)]
        want = ctc.ctc_align_batch_device_plain(*sets[0])
        runs = {"base": ctc.ctc_align_batch_device}
        if parent is not None:
            runs["parent"] = parent.ctc_align_batch_device
        for name, fn in runs.items():
            got = fn(*sets[0])
            same = all(torch.equal(g, w) for g, w in zip(got, want) if g.dtype != torch.float32)
            same = same and bool(torch.allclose(got[1], want[1], rtol=1e-6, atol=0))
            print(f"{name} at N {N} (n_len {n_len}): like the plain version: {same}", flush=True)
        for name in [*runs, *reversed(runs)]:
            ms = chip_smoke.graph_ms(torch, lambda fn=runs[name]: [fn(*a) for a in sets], 20) / 3
            print(f"{name} at N {N}: align mode {ms:.4f} ms ({1e6 * ms / T:.1f} ns a row)", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("ctc_variants: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    plans, counts, parent = [], [], None
    while args[:1] in (["--plans"], ["--n"], ["--parent"]):
        flag, value, args = args[0], args[1], args[2:]
        if flag == "--plans":
            plans = [tuple(int(x) for x in p.split("x")) for p in value.split(",")]
        elif flag == "--n":
            counts = [int(n) for n in value.split(",")]
        else:
            parent = parent_ctc(Path(value).resolve())
    libs = build(variant_sources((_build.CSRC_DIR / "ctc_align.cu").read_text(), args))

    gen = torch.Generator(device="cuda").manual_seed(4)
    ids, V, T, N, t_path = chip_smoke.ctc_alignment_case()
    sets = [chip_smoke.ctc_operands(torch, gen, ids, V, T, N, t_path, [len(ids)] * len(t_path)) for _ in range(3)]
    want = ctc.ctc_align_batch_device_plain(*sets[0])
    want_trellis = ctc.ctc_trellis_batch_plain(*sets[0])
    for name, lib in libs.items():
        ctc._lib = lambda lib=lib: lib  # the wrappers call _lib() at each launch
        got = ctc.ctc_align_batch_device(*sets[0])
        trellis = ctc.ctc_trellis_batch(*sets[0])
        torch.cuda.synchronize()
        same = {n: bool(torch.equal(g, w)) for n, g, w in zip(("token_idx", "active", "success", "t_start"),
                                                                 (got[0], *got[2:]), (want[0], *want[2:]))}
        same["probs"] = bool(torch.allclose(got[1], want[1], rtol=1e-6, atol=0))
        same["trellis"] = bool(torch.equal(trellis, want_trellis))
        print(f"{name}: like the plain version: {same}" + (f"; t_start {got[4].tolist()}" if name != "base" else ""),
              flush=True)
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw", "--format=csv,noheader",
                            "-lms", "200"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    for name in [*libs, *reversed(libs)]:
        ctc._lib = lambda lib=libs[name]: lib
        align_ms = chip_smoke.graph_ms(torch, lambda: [ctc.ctc_align_batch_device(*a) for a in sets], 20) / 3
        trellis_ms = chip_smoke.graph_ms(torch, lambda: [ctc.ctc_trellis_batch(*a) for a in sets], 20) / 3
        print(f"{name}: align mode {align_ms:.4f} ms, trellis mode {trellis_ms:.4f} ms "
              f"({1e6 * align_ms / T:.1f} ns a row)", flush=True)
    default_plan = ctc.launch_plan
    for slots, warps in [*plans, *reversed(plans)]:
        ctc.launch_plan = lambda T_, N_, V_, align=True: ctc.plan_for(T_, N_, V_, align, slots, warps)
        for name in [n for n in libs if n == "base" or n.startswith("cycles")]:
            ctc._lib = lambda lib=libs[name]: lib
            try:
                got = ctc.ctc_align_batch_device(*sets[0])
            except RuntimeError as e:  # a plan this variant's source refuses
                print(f"{name} at {slots} columns a lane x {warps} warps: {e}", flush=True)
                continue
            same = all(torch.equal(g, w) for g, w in zip(got, want) if g.dtype != torch.float32)
            align_ms = chip_smoke.graph_ms(torch, lambda: [ctc.ctc_align_batch_device(*a) for a in sets], 20) / 3
            trellis_ms = chip_smoke.graph_ms(torch, lambda: [ctc.ctc_trellis_batch(*a) for a in sets], 20) / 3
            print(f"{name} at {slots} columns a lane x {warps} warps: align mode {align_ms:.4f} ms, trellis mode "
                  f"{trellis_ms:.4f} ms ({1e6 * align_ms / T:.1f} ns a row); bit-equal to the plain version: {same}"
                  + (f"; t_start {got[4].tolist()}" if name != "base" else ""), flush=True)
    ctc.launch_plan = default_plan
    ctc._lib = lambda lib=libs["base"]: lib
    time_token_counts(counts, parent)
    B = len(t_path)
    print(f"probes, {B} at T {T}: shuffle steps {ctc.shuffle_steps_ms(B, T):.4f} ms, "
          f"barrier steps (480 threads) {ctc.barrier_steps_ms(B, T, 480):.4f} ms")
    smi.terminate()
    clocks = [ln.split(",")[0].strip() for ln in smi.communicate()[0].splitlines() if ln.strip()]
    print(f"SM clock while timing (nvidia-smi every 200 ms): {sorted(set(clocks))}")
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
