#!/usr/bin/env python3
"""The benchmark of ``whisperx_tpu_torch``: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA card. Builds
the cell's configuration with weights drawn from the seed, writes the
seed's WAV files under ``TMPDIR``, warms up on one file of the cell's
traffic, then transcribes and aligns files one after another for
``--seconds`` (``benchlib/runner.py``), judges a sample of what the window
produced against the plain reference (``benchlib/check.py``) and prints,
as its last line, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, last, the ``check`` numbers beside their
limits (also the last lines of standard error).

Exits non-zero with no result when no CUDA card is visible, when the card
count is below the cell's, or when JAX or the JAX package got loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

FORBIDDEN = ("jax", "jaxlib", "flax", "whisperx_tpu")


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``whisperx_tpu_torch`` is the port, not the package)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    import whisperx_tpu_torch  # noqa: F401  the system under test; a copy of the benchmark alone stops here
    from benchlib import runner, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: the cell needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible", file=sys.stderr)
        return 2
    line = runner.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)
    bad = loaded_forbidden()
    if bad:
        print(f"perfbench: modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
