"""One run of one cell: set-up, the closed-loop window, the check, the line.

Set-up builds the system from the seed, writes the seed's WAV files under
``TMPDIR`` and sends a warm-up file of the traffic's own kind through the
whole path. The window then transcribes and aligns the traffic's files one
after another, each starting when the last one has its words, until
``seconds`` have passed; the file in flight then is finished and counted,
and the window ends at its last word.

With ``trace`` the first files of the window run under ``torch.profiler``
(device busy time, kernel times); the per-layer metrics read host spans,
the program's stage timers and counters from the files after them, which
run untraced. After the window the peak memory is read, the program is
dropped, and the plain reference judges a sample of what the window
produced (``check.py``).
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import check, spec, trace
from .system import System, served_ids
from .traffic import Generator, write_wav

# The traced part of a --trace 1 window: the files that start within the
# first TRACE_SHARE of the window, at most TRACE_SECONDS of it.
TRACE_SECONDS = 12.0
TRACE_SHARE = 1 / 3


@dataclass
class FileRecord:
    order: int  # position in the window
    index: int  # position in the traffic's cycle
    seconds: float  # audio length
    chunks: list  # (start, end) of each chunk, as transcribe returned them
    tokens: list  # served token ids of each chunk
    scores: list  # the program's summed log-prob of each chunk's served tokens (its DecodeResult.sum_logprobs)
    words: list  # each chunk's [(word, start, end, score)], None where alignment fell back
    texts: list  # the transcript aligned to each chunk
    batches: int  # decode batches
    wall: dict  # host seconds: ingest, transcribe, align, total
    stages: dict  # the program's stage timers over this file: vad, asr_decode, align
    traced: bool = False


@dataclass
class RunRecord:
    """What the per-layer readers see."""

    cell: spec.Cell
    files: list  # the window's FileRecords
    trace: dict = field(default_factory=dict)  # trace.summarize() of the traced files
    counters: dict = field(default_factory=dict)  # the program's launch counts over the traced files

    @property
    def untraced(self) -> list:
        return [f for f in self.files if not f.traced]

    @property
    def traced(self) -> list:
        return [f for f in self.files if f.traced]


def process(system: System, gen: Generator, path: str, index: int, order: int, traced: bool) -> FileRecord:
    """The timed path for one file: load_audio → transcribe → align of the
    seed's transcript of each chunk."""
    before = system.stage_seconds()
    t0 = time.perf_counter()
    with trace.span("load_audio", traced):
        audio = system.load(path)
    t1 = time.perf_counter()
    with trace.span("transcribe", traced):
        result = system.transcribe(audio)
    t2 = time.perf_counter()
    segs = result["segments"]
    texts = [gen.transcript(index, k, s["end"] - s["start"]) for k, s in enumerate(segs)]
    with trace.span("align", traced):
        aligned = system.align([dict(s, text=t) for s, t in zip(segs, texts)], audio)
    t3 = time.perf_counter()
    after = system.stage_seconds()
    words = check.chunk_words(aligned, len(segs))
    batch = system.config["decode"]["batch_size"]
    return FileRecord(
        order=order, index=index, seconds=len(audio) / 16000.0,
        chunks=[(s["start"], s["end"]) for s in segs],
        tokens=[served_ids(s["text"]) for s in segs],
        scores=system.scores(len(segs)),
        words=words, texts=texts, batches=-(-len(segs) // batch),
        wall={"ingest": t1 - t0, "transcribe": t2 - t1, "align": t3 - t2, "total": t3 - t0},
        stages={k: after.get(k, 0.0) - before.get(k, 0.0) for k in after},
        traced=traced,
    )


def _launch_counters(read: bool) -> dict:
    """The program's kernel launch counters: zeroed (``read`` False) or read
    (wrapper launches + launches inside device-loop graphs)."""
    from whisperx_tpu_torch.ops import graph_loop

    if not read:
        for mod in graph_loop.COUNTERS.values():
            mod.launches = 0
        graph_loop.reset_counts()
        return {}
    loops = graph_loop.kernel_launches() if torch.cuda.is_available() else {}
    return {name: mod.launches + loops.get(name, 0) for name, mod in graph_loop.COUNTERS.items()}


def card() -> dict:
    """The card's name, count and power limit."""
    import subprocess

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=30)
        out["power_limit_w"] = float(q.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        out["power_limit_w"] = None
    return out


class Session:
    """Set-up of one run: the system from the seed, the seed's WAV files
    under ``workdir``, and a warm-up file sent through the whole path."""

    def __init__(self, cell: spec.Cell, seed: int, device: str, workdir: str, log):
        t = time.perf_counter()
        self.cell, self.device, self.log = cell, device, log
        self.system = System(cell.config, seed, device)
        self.gen = Generator(cell.traffic, seed)
        self.files = [self.gen.file(i) for i in range(len(self.gen.cycle))]
        self.paths = [os.path.join(workdir, f"{f.index}.wav") for f in self.files]
        for f, path in zip(self.files, self.paths):
            write_wav(path, f.pcm)
        warm = os.path.join(workdir, "warm.wav")
        write_wav(warm, self.gen.file(-1).pcm)
        self.built_s = time.perf_counter() - t
        process(self.system, self.gen, warm, -1, -1, False)
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        self.warm_s = time.perf_counter() - t - self.built_s

    def window(self, seconds: float, traced_run: bool) -> RunRecord:
        """Files one after another until ``seconds`` have passed and the last
        one has its words. With ``traced_run`` the files that start within
        the first ``min(TRACE_SECONDS, TRACE_SHARE * seconds)`` run under the
        profiler, and then ``seconds`` more of untraced files follow, which
        the host-side per-layer metrics read."""
        records, prof, counters = [], None, {}
        trace_until = min(TRACE_SECONDS, TRACE_SHARE * seconds) if traced_run else 0.0
        state = "before" if traced_run else "done"  # the profiler: before, on, done
        t0 = time.perf_counter()
        k = 0
        while True:
            tracing = state != "done" and time.perf_counter() - t0 < trace_until
            if tracing and state == "before":
                _launch_counters(read=False)
                prof = trace.start()
                window = torch.profiler.record_function(f"perfbench.{trace.WINDOW}")
                window.__enter__()
                state = "on"
            elif state == "on" and not tracing:
                window.__exit__(None, None, None)
                counters = _launch_counters(read=True)
                prof.stop()
                state = "done"
                t0 = time.perf_counter()  # the untraced part's own window starts
            i = k % len(self.files)
            records.append(process(self.system, self.gen, self.paths[i], i, k, tracing))
            k += 1
            if state == "done" and time.perf_counter() - t0 >= seconds:
                break
        self.window_s = time.perf_counter() - t0
        self.peak = torch.cuda.max_memory_allocated() if self.device == "cuda" else 0
        ends = np.cumsum([r.wall["total"] for r in records if not r.traced])
        self.log(f"window {self.window_s:.3f} s: {len(records)} files, {sum(r.seconds for r in records):.1f} audio-s, "
                 f"{sum(len(r.chunks) for r in records)} chunks, {sum(r.batches for r in records)} decode batches; "
                 f"untraced files end at {np.round(ends, 2).tolist()} s")
        summary = trace.summarize(prof) if prof is not None else {}
        self.system.close()
        return RunRecord(cell=self.cell, files=records, trace=summary, counters=counters)


def run(cell: spec.Cell, seed: int, seconds: float, traced_run: bool, device: str = "cuda",
        t_process: float = None, log=None) -> dict:
    """One run; returns the result line's object (``correct`` decided by the
    check). ``device`` "cpu" runs the program's plain versions (tests)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    t_process = t_process if t_process is not None else time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="perfbench-", dir=os.environ.get("TMPDIR"))
    try:
        t = time.perf_counter()
        session = Session(cell, seed, device, workdir, log)
        setup_s = time.perf_counter() - t_process
        log(f"set-up {setup_s:.3f} s: imports {t - t_process:.3f}, system + audio {session.built_s:.3f}, "
            f"warm-up file {session.warm_s:.3f}")
        record = session.window(seconds, traced_run)
        t = time.perf_counter()
        verdict = check.judge(cell, seed, session.files, record.files, device)
        log(f"check: the reference took {time.perf_counter() - t:.3f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if traced_run:
        metrics = {}
        for m in cell.per_layer:
            value = spec.load_metric(m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        audio_s = sum(r.seconds for r in record.files)
        values = {"audio_s_per_s": audio_s / session.window_s, "setup_s": setup_s}
        if device == "cuda":  # the card's memory; a CPU run has none to read
            values["peak_mem_gib"] = session.peak / 2**30
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end if m["name"] in values}
    dev = card() if device == "cuda" else {"platform": "cpu", "kind": "cpu", "count": 0}
    dev["memory_peak_bytes"] = int(session.peak)
    line = {"correct": verdict["correct"], "attempted": len(record.files), "failed": verdict["failed"],
            "metrics": metrics, "device": dev}
    if traced_run:
        dev["busy_s"], dev["window_s"] = record.trace["busy_s"], record.trace["window_s"]
        line["breakdown"] = record.trace["breakdown"]
    line["check"] = verdict["numbers"]
    for name, n in verdict["numbers"].items():  # the last lines of standard error
        log(f"check {name}: {n['value']:.6g} (limit {n['limit']})")
    return line
