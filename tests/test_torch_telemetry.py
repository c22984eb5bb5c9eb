"""The port's span log (``whisperx_tpu_torch/utils/telemetry.py``): nesting,
request ids, the ring's bound, device spans read without waiting, the
profiler's ``wx.*`` ranges, and the spans the pipeline and the aligner
write for each file, on the CPU at tiny widths."""

import collections
import dataclasses
import types

import numpy as np
import pytest
import torch

from whisperx_tpu_torch.utils import telemetry

torch.set_num_threads(2)

SR = 16000


def new_spans(after: int) -> list:
    return [s for s in telemetry.spans() if s.span_id > after]


def last_id() -> int:
    with telemetry.span("mark") as s:
        pass
    return s.span_id


def test_spans_nest_under_the_current_span_and_share_the_root_request():
    start = last_id()
    with telemetry.span("outer", root=True, audio_s=3.0) as outer:
        with telemetry.span("mid") as mid:
            inner = telemetry.begin("inner", rows=2)
            telemetry.end(inner)
        with telemetry.within(mid):
            late = telemetry.begin("late")
        telemetry.end(late)
    loose = telemetry.begin("loose")
    telemetry.end(loose)
    got = {s.name: s for s in new_spans(start)}
    assert got["outer"].parent_id is None and got["outer"].request_id is not None
    assert got["mid"].parent_id == outer.span_id
    assert got["inner"].parent_id == got["late"].parent_id == mid.span_id
    assert {got[n].request_id for n in ("outer", "mid", "inner", "late")} == {outer.request_id}
    assert got["loose"].parent_id is None and got["loose"].request_id is None
    assert dict(got["outer"].counts) == {"audio_s": 3.0} and dict(got["inner"].counts) == {"rows": 2}
    assert all(s.end_ns >= s.start_ns and s.host_ms >= 0 for s in got.values())
    assert got["outer"].device is None and got["outer"].device_ms is None  # a host span
    assert [s.span_id for s in new_spans(start)] == sorted(s.span_id for s in got.values())  # oldest first


def test_each_root_opens_a_new_request_and_a_root_inside_a_request_too():
    with telemetry.span("a", root=True) as a:
        with telemetry.span("b", root=True) as b:
            with telemetry.span("c") as c:
                pass
    assert len({a.request_id, b.request_id}) == 2
    assert b.parent_id is None and c.request_id == b.request_id and c.parent_id == b.span_id


def test_ring_keeps_the_newest_spans_and_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(telemetry, "_log", collections.deque(maxlen=4))
    monkeypatch.setattr(telemetry, "_dropped", 0)
    ids = []
    for i in range(7):
        with telemetry.span(f"s{i}") as s:
            ids.append(s.span_id)
    assert [s.span_id for s in telemetry.spans()] == ids[-4:]
    assert telemetry.dropped() == 3


class FakeEvent:
    """A timing event that completes when told to and fails if anything
    waits for it."""

    def __init__(self, t_ms: float):
        self.t_ms, self.done = t_ms, False

    def query(self) -> bool:
        return self.done

    def elapsed_time(self, other) -> float:
        assert self.done and other.done, "elapsed_time of an event not completed"
        return other.t_ms - self.t_ms

    def synchronize(self):
        raise AssertionError("a device span waited for its event")

    wait = synchronize


def test_device_spans_resolve_lazily_without_waiting(monkeypatch):
    events = []

    def record(device):
        events.append(FakeEvent(10.0 * len(events)))
        return events[-1]

    monkeypatch.setattr(telemetry, "_device_event", record)
    monkeypatch.setattr(torch.cuda, "synchronize", FakeEvent.synchronize)
    first = telemetry.begin("first", device="cuda")
    second = telemetry.begin("second", device="cuda")
    telemetry.end(first, at=second)  # ends where the second begins: one shared event
    telemetry.end(second)
    assert len(events) == 3 and first.events[1] is second.events[0]
    read = {s.span_id: s for s in telemetry.spans()}  # neither waits nor raises
    assert read[first.span_id].device_ms is None and read[second.span_id].device_ms is None
    assert read[first.span_id].device == "cuda" and read[first.span_id].end_ns == second.start_ns
    events[0].done = events[1].done = True
    read = {s.span_id: s for s in telemetry.spans()}
    assert read[first.span_id].device_ms == 10.0 and read[second.span_id].device_ms is None  # still pending
    events[2].done = True
    telemetry.resolve()
    assert {s.span_id: s for s in telemetry.spans()}[second.span_id].device_ms == 10.0


def test_a_cpu_device_span_reads_its_host_time():
    with telemetry.span("work", device="cpu") as s:
        sum(range(10000))
    rec = {r.span_id: r for r in telemetry.spans()}[s.span_id]
    assert rec.device == "cpu" and rec.device_ms == rec.host_ms > 0


def test_stage_timers_write_spans_and_report_as_before():
    tel = telemetry.PipelineTelemetry()
    start = last_id()
    with telemetry.span("request", root=True) as root:
        with tel.stage("vad", audio_seconds=5.0) as stats:
            pass
    open_root = telemetry.begin("align", root=True)
    tel.record("align", seconds=2.0, audio_seconds=60.0, span=open_root)
    tel.record("diarize", seconds=0.5)
    got = {s.name: s for s in new_spans(start)}
    assert got["vad"].parent_id == root.span_id and got["vad"].request_id == root.request_id
    assert got["align"].span_id == open_root.span_id and got["align"].end_ns is not None  # closed by record
    assert got["diarize"].end_ns - got["diarize"].start_ns == 500_000_000
    assert stats.calls == 1 and tel.report()["align"] == {"seconds": 2.0, "calls": 1, "audio_seconds": 60.0,
                                                          "x_realtime": 30.0}


def test_profiler_ranges_only_while_it_records():
    from torch.profiler import ProfilerActivity, profile

    with telemetry.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.span("inside"):
            with telemetry.span("nested"):
                pass
        opened = telemetry.begin("opened")
        telemetry.end(opened)
    after = telemetry.begin("after")
    telemetry.end(after)
    names = {e.name for e in prof.events()}
    assert {"wx.inside", "wx.nested", "wx.opened"} <= names and "wx.before" not in names
    assert after.range is None and opened.range is None


def test_a_library_load_writes_one_build_span(monkeypatch, tmp_path):
    from whisperx_tpu_torch.ops import _build

    (tmp_path / "fake.cu").write_text("")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "build", lambda names: {n: {} for n in names})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: types.SimpleNamespace(error_string=types.SimpleNamespace()))
    monkeypatch.setattr(_build, "_libs", {})
    start = last_id()
    _build.load("fake")
    _build.load("fake")  # loaded once
    got = [s for s in new_spans(start) if s.name == "build.load"]
    assert len(got) == 1 and dict(got[0].counts) == {"built": 1}


def test_decode_result_gives_a_device_loop_its_steps_on_the_first_read():
    from whisperx_tpu_torch.decode.engine import DecodeResult

    span = telemetry.begin("decode.loop")
    telemetry.end(span)
    stats = torch.tensor([[-1.0, -2.0], [3.0, 4.0], [0.1, 0.2], [7.0, 7.0]])
    result = DecodeResult(torch.zeros((2, 4), dtype=torch.int32), stats, span)
    assert "steps" not in span.counts
    assert result.lengths.tolist() == [3, 4] and span.counts["steps"] == 7


# -- the pipeline and the aligner, per file ------------------------------------


def speech_islands(n: int, gap_s: float = 3.0) -> np.ndarray:
    """n tone-burst islands apart: n VAD chunks at chunk_size=5."""
    rng = np.random.default_rng(0)
    parts = []
    for i in range(n):
        t = np.arange(int((1.5 + 0.3 * i) * SR)) / SR
        x = 0.3 * np.sin(2 * np.pi * (180.0 + 40 * i) * t) * (1 + 0.5 * np.sin(2 * np.pi * 3.1 * t))
        x = x + 0.05 * rng.standard_normal(len(t))
        parts += [np.zeros(SR // 2), x, np.zeros(SR // 2), np.zeros(int(gap_s * SR))]
    return np.concatenate(parts).astype(np.float32)


@pytest.fixture(scope="module")
def pipeline_spans():
    """One file through transcribe (5 chunks, batches of 2, beam 2) and
    align on the tiny CPU models: (result, aligned, spans of each request,
    host loop steps run, chunks, align batches)."""
    from whisperx_tpu_torch.align import alignment
    from whisperx_tpu_torch.decode import search
    from whisperx_tpu_torch.pipeline.asr import load_test_pipeline

    p = load_test_pipeline(language="en", beam_size=2, device="cpu")
    am = dataclasses.replace(alignment.test_align_model(device="cpu"), max_batch=2)
    audio = speech_islands(5)
    bodies = [0]
    body = search.BeamLoop.body

    def counted(self):
        bodies[0] += 1
        body(self)

    search.BeamLoop.body = counted
    try:
        start = last_id()
        result = p.transcribe(audio, batch_size=2, chunk_size=5)
    finally:
        search.BeamLoop.body = body
    segs = [dict(s, text=f"word{i} more words") for i, s in enumerate(result["segments"])]
    aligned = alignment.align(segs, am, {"language": "en", "dictionary": am.dictionary}, audio, "cpu")
    log = new_spans(start)
    roots = {s.name: s for s in log if s.parent_id is None and s.request_id is not None}
    requests = {name: [s for s in log if s.request_id == root.request_id] for name, root in roots.items()}
    return result, aligned, requests, bodies[0], len(audio) / SR


def test_transcribe_writes_its_span_tree(pipeline_spans):
    result, _, requests, bodies, audio_s = pipeline_spans
    spans = requests["transcribe"]
    root = spans[0]
    by_name = collections.defaultdict(list)
    for s in spans:
        by_name[s.name].append(s)
    chunks = len(result["segments"])
    assert chunks == 5 and root.name == "transcribe" and root.counts["audio_s"] == audio_s
    (vad,), (decode,) = by_name["vad"], by_name["asr_decode"]
    assert vad.parent_id == decode.parent_id == root.span_id
    batches = by_name["asr.batch"]
    assert len(batches) == 3 and all(b.parent_id == decode.span_id for b in batches)
    assert sum(b.counts["rows_valid"] for b in batches) == chunks and {b.counts["rows"] for b in batches} == {2}
    for b in batches:
        kids = [s.name for s in spans if s.parent_id == b.span_id]
        assert kids == ["asr.prepare", "decode.loop", "asr.fetch", "asr.detokenize"]
    prepare, loops = by_name["asr.prepare"], by_name["decode.loop"]
    for prep, loop in zip(prepare, loops):
        assert prep.end_ns == loop.start_ns and prep.device == loop.device == "cpu"
        assert prep.device_ms == prep.host_ms and loop.device_ms == loop.host_ms
        assert prep.counts["flash_launches"] == 0  # the CPU runs no kernel
    assert sum(s.counts["steps"] for s in loops) == bodies and all(s.counts["steps"] >= 1 for s in loops)
    assert all(s.end_ns is not None for s in spans)


def test_align_writes_its_span_tree(pipeline_spans):
    result, aligned, requests, _, audio_s = pipeline_spans
    spans = requests["align"]
    root = spans[0]
    assert root.name == "align" and root.counts["audio_s"] == audio_s and root.end_ns is not None
    assert all(s.parent_id == root.span_id for s in spans[1:])
    names = [s.name for s in spans[1:]]
    emissions = [s for s in spans if s.name == "align.emissions"]
    ctc = [s for s in spans if s.name == "align.ctc"]
    # 5 segments in batches of 2: rows on the halving ladder (2, 2, 1 of 2 → 1).
    assert len(emissions) == len(ctc) == names.count("align.fetch") == 3
    assert names.count("align.aggregate") == 4  # each batch's paths, then the words and sentences
    assert sum(s.counts["rows_valid"] for s in emissions) == len(result["segments"])
    for e, c in zip(emissions, ctc):
        assert e.end_ns == c.start_ns and dict(e.counts) == dict(c.counts, flash_launches=0)  # the CPU runs no kernel
        assert e.device_ms is not None and c.device_ms is not None
    assert len(aligned["segments"]) >= 1
