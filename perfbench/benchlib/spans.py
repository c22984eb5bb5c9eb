"""The program's span log (``whisperx_tpu_torch.utils.telemetry.spans()``)
as the per-layer readers see it: the requests of the window's untraced
files.

The window runs its files one after another, untraced last, and after the
window only the plain reference runs: so the last ``transcribe`` and the
last ``align`` roots, one of each per untraced file, are those files'
requests. Their ``audio_s`` counts are held to the files' lengths.
"""

from __future__ import annotations

import math


def requests(record):
    """{"transcribe": [...], "align": [...]}: for each untraced file, in
    order, the spans of its request (the root first). None where there is
    nothing to read: no untraced file, or a program without a span log."""
    from whisperx_tpu_torch.utils import telemetry

    files = record.untraced
    if not files or not hasattr(telemetry, "spans"):
        return None
    log = telemetry.spans()
    if telemetry.dropped():
        raise RuntimeError(f"the span log dropped {telemetry.dropped()} spans: the window's requests are not whole")
    by_request: dict = {}
    for s in log:
        by_request.setdefault(s.request_id, []).append(s)
    out = {}
    for name in ("transcribe", "align"):
        roots = [s for s in log if s.name == name and s.parent_id is None and s.request_id is not None]
        if len(roots) < len(files):
            raise RuntimeError(f"{len(roots)} '{name}' requests in the span log, {len(files)} untraced files")
        roots = roots[-len(files):]
        for f, root in zip(files, roots):
            audio_s = root.counts.get("audio_s", math.nan)
            if root.end_ns is None or not math.isclose(audio_s, f.seconds, rel_tol=1e-9):
                raise RuntimeError(f"'{name}' request {root.request_id}: audio_s {audio_s}, end {root.end_ns}; "
                                   f"untraced file {f.order} holds {f.seconds} s")
        out[name] = [by_request[root.request_id] for root in roots]
    return out


def named(reqs: list, name: str) -> list:
    """The spans called ``name`` in a list of requests."""
    return [s for req in reqs for s in req if s.name == name]


def device_ms(spans: list) -> float:
    """The summed device time of device spans; every one must be resolved
    (the window has ended, so each end event has completed)."""
    pending = [s for s in spans if s.device_ms is None]
    if pending:
        raise RuntimeError(f"{len(pending)} device spans unresolved after the window ({pending[0].name})")
    return sum(s.device_ms for s in spans)
