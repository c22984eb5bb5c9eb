"""The per-layer metrics that read the program's span log
(``benchlib/spans.py``), on a tiny traced window on the CPU: what each
reads there, and that they refuse requests that are not the window's
untraced files."""

import dataclasses
import math

import pytest

import tiny
from benchlib import runner, spec, spans

READERS = ("decode_loop_ms_per_step", "asr_prepare_ms_per_batch", "align_host_ms_per_audio_min", "device_idle_share")


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    session = runner.Session(tiny.cell(), 2**31 + 11, "cpu", str(tmp_path_factory.mktemp("spans")), lambda m: None)
    return session.window(2.0, True)


def test_readers_read_the_untraced_files_requests(record):
    files = record.untraced
    reqs = spans.requests(record)
    assert [r[0].counts["audio_s"] for r in reqs["transcribe"]] == [f.seconds for f in files]
    assert len(spans.named(reqs["transcribe"], "asr.batch")) == sum(f.batches for f in files)
    values = {name: spec.load_metric(name).read(record) for name in READERS}
    loops = spans.named(reqs["transcribe"], "decode.loop")
    assert values["decode_loop_ms_per_step"] == pytest.approx(
        sum(s.device_ms for s in loops) / sum(s.counts["steps"] for s in loops))
    for name in ("decode_loop_ms_per_step", "asr_prepare_ms_per_batch", "align_host_ms_per_audio_min"):
        assert values[name] > 0 and math.isfinite(values[name])
    assert values["device_idle_share"] is None  # host time only: the CPU has no card to be idle


def test_readers_refuse_requests_that_are_not_the_untraced_files(record):
    longer = [dataclasses.replace(f, seconds=f.seconds + 1.0) for f in record.files]
    more = record.files + [dataclasses.replace(f, order=f.order + 1000) for f in record.untraced] * 50
    for files in (longer, more):
        broken = dataclasses.replace(record, files=files)
        for name in READERS:
            with pytest.raises(RuntimeError):
                spec.load_metric(name).read(broken)


def test_readers_read_nothing_from_a_program_without_a_span_log(record, monkeypatch):
    from whisperx_tpu_torch.utils import telemetry

    monkeypatch.delattr(telemetry, "spans")
    assert all(spec.load_metric(name).read(record) is None for name in READERS)
