"""What the profiler's trace of part of a window says: device busy time as
the union of device activity intervals, device time and event counts by
kernel name, and the longest idle gaps labelled by what the host was doing.
"""

from __future__ import annotations

import bisect
import contextlib

import torch

WINDOW = "traced"  # the benchmark range around the traced files


@contextlib.contextmanager
def span(name: str, on: bool):
    """A host range the trace can label idle gaps by (only while tracing)."""
    if not on:
        yield
        return
    with torch.profiler.record_function(f"perfbench.{name}"):
        yield


def start():
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def _union(intervals: list) -> tuple:
    """Total length of the union of (start, end) intervals, and the gaps
    between the merged runs as (start, end)."""
    total, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


def summarize(prof) -> dict:
    """Reduce a stopped profiler: ``busy_s`` (union of device activity inside
    the benchmark's ``traced`` range, the host interval of the traced
    files), ``window_s`` (that range's length), ``kernels`` {name: [events,
    seconds]} and the ``breakdown`` (ten heaviest device operations, ten
    longest idle gaps by the innermost benchmark range and the last host
    operation before them)."""
    events = list(prof.events())
    cuda = torch.autograd.DeviceType.CUDA
    window = [e.time_range for e in events if e.device_type != cuda and e.name == f"perfbench.{WINDOW}"]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} '{WINDOW}' ranges, expected one")
    w0, w1 = window[0].start, window[0].end
    device, host = [], []
    for e in events:
        tr = e.time_range
        if e.device_type == cuda:
            if getattr(e, "is_user_annotation", False):
                continue
            s, t = max(tr.start, w0), min(tr.end, w1)
            if t > s:
                device.append((s, t, e.name))
        elif tr.end > w0 and tr.start < w1:
            host.append((tr.start, tr.end, e.name))
    busy_us, gaps = _union([(s, t) for s, t, _ in device])
    kernels: dict = {}
    for s, t, name in device:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (t - s) / 1e6
    ranges = [(s, t, n[len("perfbench."):]) for s, t, n in host if n.startswith("perfbench.")]
    ops = sorted((s, n) for s, t, n in host if not n.startswith("perfbench."))
    op_starts = [s for s, _ in ops]

    def label(g0, g1):
        mid = (g0 + g1) / 2
        inner = [r for r in ranges if r[0] <= mid <= r[1] and r[2] != WINDOW]
        where = min(inner, key=lambda r: r[1] - r[0])[2] if inner else WINDOW
        i = bisect.bisect_right(op_starts, g0)
        return f"{where} after {ops[i - 1][1] if i else 'start'}"

    first = min((s for s, _, _ in device), default=w0)
    last = max((t for _, t, _ in device), default=w1)
    edges = [(w0, first), (last, w1)] if device else [(w0, w1)]
    longest = sorted([g for g in gaps + edges if g[1] > g[0]], key=lambda g: g[0] - g[1])[:10]
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "kernels": kernels,
        "breakdown": {
            "device_ops": [[n, k[1]] for n, k in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]],
            "idle_gaps": [[label(a, b), (b - a) / 1e6] for a, b in longest],
        },
    }
