#!/usr/bin/env python3
"""The decode kernels of two checkouts side by side on one CUDA card.

Run from the root of a checkout: ``python3 kernel_ab.py OTHER_CHECKOUT``
(for example the parent commit unpacked with ``git archive`` into a
directory that ``.gitignore`` lists). In turns (this, other, other, this),
each in a fresh process, it runs that checkout's own ``chip_smoke.py``
timing of ``int8_matmul`` and ``cross_attention_decode`` (device ms under
CUDA graph replay, beside the PyTorch library call), and then times on the
host clock how long Python takes to issue the same calls while the card is
kept busy by a long sleep kernel, so that no call waits for the card: the
host cost per call, the median of five repeats.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time


def measure() -> None:
    """Run inside a checkout (the current directory): one line per kernel."""
    import torch

    import chip_smoke
    from whisperx_tpu_torch.models.whisper import flat_cross_kv
    from whisperx_tpu_torch.ops import cross_attn, int8_mm

    card = chip_smoke.card_line()
    for phase in (chip_smoke.int8_mm_phase, chip_smoke.cross_attn_phase):
        r = phase(torch, card)
        print(f"  {r['name']}: device {r['ms']:.5f} ms (library {r['library_ms']:.5f} ms, plain {r['plain_ms']:.5f} ms); "
              f"eager calls from Python {r['eager_ms']:.5f} ms", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    D = 1280
    layer = [(D, 3 * D), (D, D), (D, D), (D, D), (D, 4 * D), (4 * D, D)]
    mm_ops = [(torch.randn((40, K), device="cuda", generator=gen).bfloat16(),
               torch.randint(-127, 128, (K, N), device="cuda", generator=gen, dtype=torch.int8),
               torch.rand((N,), device="cuda", generator=gen), torch.randn((N,), device="cuda", generator=gen))
              for _ in range(8) for K, N in layer]
    q = (torch.randn((8, 5, D), device="cuda", generator=gen) * 0.05).bfloat16()
    f = flat_cross_kv(torch.randn((8, 1500, 20, 64), device="cuda", generator=gen),
                      torch.randn((8, 1500, 20, 64), device="cuda", generator=gen), True)

    def host_us(fn, calls):
        fn()  # set-up: libraries, tensor maps, launch plans
        torch.cuda.synchronize()
        runs = []
        for _ in range(5):
            torch.cuda._sleep(2_000_000_000)  # ~1 s of device time: no call below waits for the card
            t0 = time.perf_counter()
            fn()
            runs.append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
        return statistics.median(runs)

    def mm():
        for _ in range(10):
            for ops in mm_ops:
                int8_mm.int8_matmul(*ops)

    def ca():
        for _ in range(320):
            cross_attn.cross_attention_decode(q, *f)

    print(f"  host cost: int8_matmul {host_us(mm, 10 * len(mm_ops)):.2f} us/call, "
          f"cross_attention_decode {host_us(ca, 320):.2f} us/call", flush=True)


def main() -> int:
    if len(sys.argv) != 2 or not os.path.isdir(sys.argv[1]):
        print(__doc__, file=sys.stderr)
        return 2
    here, other = ".", sys.argv[1]
    for root in (here, other, other, here):
        print(f"{root}:", flush=True)
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure"], cwd=root,
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stderr[-2000:], file=sys.stderr)
            return 1
        print("\n".join(ln for ln in out.stdout.splitlines() if ln.startswith("  ")), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--measure"]:
        sys.path.insert(0, os.getcwd())  # that checkout's chip_smoke.py and package
        measure()
        sys.exit(0)
    sys.exit(main())
