"""Observability: the port's span log and its stage timers.

The span log is one process-wide record, in memory, of where a request's
time goes. A span has a name, an id, its parent's id (the span current in
the calling context when it began), the id of the request it belongs to,
host start and end (``time.perf_counter_ns``) and a small dict of counts.
Each ``WhisperPipeline.transcribe`` and ``align`` / ``align_begin`` call
opens a root span with a new request id; every span below it carries that
id. The log is a ring of :data:`CAPACITY` spans; :func:`dropped` counts the
spans it let go.

A device span (``device=`` a CUDA device) also records a timing event on
that device's current stream as it begins and as it ends. Its device
milliseconds are read once the end event has completed, without waiting for
it: :func:`resolve` reads what has completed and leaves the rest pending,
and runs where the host already waits for the card and whenever the log is
read (:func:`spans`). A device span makes no host synchronization and no
copy from the device. On the CPU, where the work is synchronous, a device
span's device time is its host time.

While a torch profiler records, every span also enters
``torch.profiler.record_function("wx.<name>")``, so the program's phases
appear in the profiler's trace beside the device's activity, on its clock.

:class:`PipelineTelemetry` keeps the per-stage timers (seconds, calls and
audio seconds: the north-star metric is audio-seconds processed per
second); each stage also writes a span of the same name.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass
from types import MappingProxyType
from typing import Dict, Mapping, Optional

import torch

logger = logging.getLogger("whisperx_tpu_torch")

# Spans the log keeps: the oldest goes when a new one arrives.
CAPACITY = 65536


@dataclass(frozen=True)
class SpanRecord:
    """A span as :func:`spans` reads it. ``end_ns`` is None while the span
    is open; ``device`` names the device of a device span (None for a host
    span) and ``device_ms`` its device time, None while its end event is
    pending."""

    name: str
    span_id: int
    parent_id: Optional[int]
    request_id: Optional[int]
    start_ns: int
    end_ns: Optional[int]
    counts: Mapping[str, float]
    device: Optional[str]
    device_ms: Optional[float]

    @property
    def host_ms(self) -> Optional[float]:
        return None if self.end_ns is None else (self.end_ns - self.start_ns) / 1e6


class Span:
    """A span as it is written: :func:`begin` returns one; the writer may
    add to ``counts`` until the log is read."""

    __slots__ = ("name", "span_id", "parent_id", "request_id", "start_ns", "end_ns", "counts", "device",
                 "device_ms", "events", "range")

    def __init__(self, name, parent: Optional["Span"], root: bool, device, counts):
        self.name = name
        self.span_id = next(_span_ids)
        self.parent_id = None if root or parent is None else parent.span_id
        self.request_id = next(_request_ids) if root else (parent.request_id if parent is not None else None)
        self.counts = counts
        self.device = None if device is None else torch.device(device)
        self.end_ns = self.device_ms = self.events = self.range = None

    def record(self) -> SpanRecord:
        return SpanRecord(self.name, self.span_id, self.parent_id, self.request_id, self.start_ns, self.end_ns,
                          MappingProxyType(dict(self.counts)), None if self.device is None else str(self.device),
                          self.device_ms)


_span_ids = itertools.count(1)
_request_ids = itertools.count(1)
_lock = threading.Lock()
_log: deque = deque(maxlen=CAPACITY)
_pending: deque = deque(maxlen=CAPACITY)  # CUDA spans whose end event has not been seen complete
_dropped = 0
_current: contextvars.ContextVar = contextvars.ContextVar("whisperx_tpu_torch_span", default=None)


def _device_event(device: torch.device):
    """A timing event recorded on ``device``'s current stream."""
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


def begin(name: str, *, device=None, root: bool = False, **counts) -> Span:
    """Open a span under the current one (a root with a new request id with
    ``root``); it is not made current (see :func:`within`). ``device``:
    make it a device span on that device."""
    global _dropped
    span = Span(name, _current.get(), root, device, counts)
    if torch.autograd.profiler._is_profiler_enabled:
        span.range = torch.profiler.record_function(f"wx.{name}")
        span.range.__enter__()
    span.start_ns = time.perf_counter_ns()
    if span.device is not None and span.device.type == "cuda":
        span.events = [_device_event(span.device), None]
    with _lock:
        _dropped += len(_log) == _log.maxlen
        _log.append(span)
    return span


def end(span: Span, at: Optional[Span] = None) -> None:
    """Close ``span`` now, or with ``at`` where the span ``at`` began (on
    the device too: the two share that event)."""
    if at is not None:
        span.end_ns = at.start_ns
    else:
        span.end_ns = time.perf_counter_ns()
    if span.events is not None:
        span.events[1] = at.events[0] if at is not None and at.events is not None else _device_event(span.device)
        _pending.append(span)
    elif span.device is not None:
        span.device_ms = (span.end_ns - span.start_ns) / 1e6
    if span.range is not None:
        span.range.__exit__(None, None, None)
        span.range = None


@contextlib.contextmanager
def within(span: Optional[Span]):
    """Make ``span`` the current span (the parent of spans begun inside)."""
    token = _current.set(span)
    try:
        yield span
    finally:
        _current.reset(token)


@contextlib.contextmanager
def span(name: str, *, device=None, root: bool = False, **counts):
    """A span around the block, current inside it."""
    s = begin(name, device=device, root=root, **counts)
    try:
        with within(s):
            yield s
    finally:
        end(s)


def resolve() -> None:
    """Read the device time of each pending device span whose end event has
    completed; leave the others pending. Never waits for the device."""
    for _ in range(len(_pending)):
        s = _pending.popleft()
        start, stop = s.events
        if stop.query() and start.query():
            s.device_ms = start.elapsed_time(stop)
            s.events = None
        else:
            _pending.append(s)


def spans() -> list:
    """The log, oldest first, as :class:`SpanRecord` s (device spans
    resolved as far as they have completed)."""
    resolve()
    with _lock:
        return [s.record() for s in _log]


def dropped() -> int:
    """Spans the ring let go since the process started."""
    return _dropped


@dataclass
class StageStats:
    seconds: float = 0.0
    calls: int = 0
    audio_seconds: float = 0.0

    @property
    def realtime_factor(self) -> float:
        return self.audio_seconds / self.seconds if self.seconds > 0 else 0.0


class PipelineTelemetry:
    """Accumulates per-stage timings across a pipeline run."""

    def __init__(self):
        self.stages: Dict[str, StageStats] = {}

    @contextlib.contextmanager
    def stage(self, name: str, audio_seconds: float = 0.0):
        stats = self.stages.setdefault(name, StageStats())
        t0 = time.perf_counter()
        try:
            with span(name):
                yield stats
        finally:
            dt = time.perf_counter() - t0
            stats.seconds += dt
            stats.calls += 1
            stats.audio_seconds += audio_seconds
            logger.debug(
                "stage=%s dt=%.3fs audio=%.1fs xRT=%.1f",
                name, dt, audio_seconds, audio_seconds / dt if dt > 0 else 0,
            )

    def record(self, name: str, seconds: float, audio_seconds: float = 0.0, span: Optional[Span] = None):
        """Accumulate an externally-timed stage (non-context-manager form).
        Its span: ``span`` (an open span of that stage, closed here), else a
        new one of ``seconds`` that ends now."""
        stats = self.stages.setdefault(name, StageStats())
        stats.seconds += seconds
        stats.calls += 1
        stats.audio_seconds += audio_seconds
        if span is None:
            span = begin(name)
            end(span)
            span.start_ns = span.end_ns - int(seconds * 1e9)
        else:
            end(span)
        logger.debug(
            "stage=%s dt=%.3fs audio=%.1fs xRT=%.1f",
            name, seconds, audio_seconds, audio_seconds / seconds if seconds > 0 else 0,
        )

    def report(self) -> dict:
        return {
            name: {
                "seconds": round(s.seconds, 4),
                "calls": s.calls,
                "audio_seconds": round(s.audio_seconds, 2),
                "x_realtime": round(s.realtime_factor, 2),
            }
            for name, s in self.stages.items()
        }


# Process-wide collector for the stages that run outside a pipeline instance
# (align(), diarization), so telemetry.GLOBAL.report() covers the whole job.
GLOBAL = PipelineTelemetry()
