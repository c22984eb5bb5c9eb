"""Observability: stage timers and audio-seconds/s counters.

A copy of ``whisperx_tpu/utils/telemetry.py`` (tests hold the counters
equal): per-stage wall-clock and realtime-factor counters (the north-star
metric is audio-seconds processed per second) and structured logging. Its
``profiler_trace`` wraps ``jax.profiler`` and is not carried over.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from dataclasses import dataclass
from typing import Dict

logger = logging.getLogger("whisperx_tpu_torch")


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

    def record(self, name: str, seconds: float, audio_seconds: float = 0.0):
        """Accumulate an externally-timed stage (non-context-manager form)."""
        stats = self.stages.setdefault(name, StageStats())
        stats.seconds += seconds
        stats.calls += 1
        stats.audio_seconds += audio_seconds
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

    def log_report(self):
        logger.info("pipeline stats: %s", json.dumps(self.report()))


# Process-wide collector for the stages that run outside a pipeline instance
# (align(), diarization), so telemetry.GLOBAL.report() covers the whole job.
GLOBAL = PipelineTelemetry()


def configure_logging(level: str = "INFO", structured: bool = False):
    """Install a handler for the framework logger (idempotent)."""
    handler = logging.StreamHandler()
    if structured:
        class JsonFormatter(logging.Formatter):
            def format(self, record):
                return json.dumps(
                    {
                        "t": round(record.created, 3),
                        "level": record.levelname,
                        "logger": record.name,
                        "msg": record.getMessage(),
                    }
                )

        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
    logger.handlers[:] = [handler]
    logger.setLevel(level)
    return logger
