#!/usr/bin/env python3
"""Readings that the check's limits are set from, on the card at a cell's
own size: for each seed, a short window of the cell's own load, then each
number of the check for the program (its outputs against the reference) and
for the control (the reference one precision step below each model's,
the configuration's ``check.control``: int4 weights for int8, fp8 for
bfloat16, put in the program's place on the same chunks: its own beam
search, emissions and walk). One JSON line a seed.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 --seconds 16

The benchmark's own runs never run this.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def readings(cell, seed: int, seconds: float, device: str, log) -> dict:
    from benchlib import check, runner

    workdir = tempfile.mkdtemp(prefix="perfbench-control-", dir=os.environ.get("TMPDIR"))
    try:
        session = runner.Session(cell, seed, device, workdir, log)
        record = session.window(seconds, False)
        t = time.perf_counter()
        out, detail = check.readings(cell, seed, session.files, record.files, device, ("exact", "control"), True)
        log(f"seed {seed}: the readings took {time.perf_counter() - t:.3f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {"seed": seed, "files": len(record.files), "program": out["exact"], "control": out["control"],
            "control_precision": cell.config["check"]["control"], "detail": detail}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=16.0)
    args = ap.parse_args(argv)

    import torch

    from benchlib import spec

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = readings(cell, seed, args.seconds, "cuda", lambda m: print(m, file=sys.stderr, flush=True))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
