"""The decode step's byte counts match counts made by hand, and the
per-layer metric that reads them takes each width from what the span
counts."""

from types import SimpleNamespace

import pytest

from benchlib import spans, spec, step_bytes

V2 = spec.load_cell("large-v2-int8.longform-dense").config
TURBO = spec.load_cell("large-v3-turbo-bf16.longform-dense").config


def test_large_v2_int8_step_by_hand():
    # position 10 (11 filled slots), 8 audio rows x 5 beams; int8 weights,
    # int8 caches with an fp32 scale a token and head (20 heads)
    weights = 32 * (3 * 1280 * 1280 + 1280 * 1280 + 1280 * 1280 + 1280 * 1280 + 2 * 1280 * 5120) + 51865 * 1280
    cross = 32 * 2 * 8 * 1500 * (1280 + 4 * 20)
    cache = 32 * 2 * 40 * 11 * (1280 + 4 * 20)
    logits = 40 * 51865 * 4
    assert step_bytes.beam_step(V2["whisper"], 40, 8, 10, 1, 1) == weights + cross + cache + logits == 1_891_466_400


def test_large_v3_turbo_bf16_step_by_hand():
    # 4 decoder layers, 51,866 tokens; bf16 weights and caches, no scales
    weights = 2 * (4 * (6 * 1280 * 1280 + 2 * 1280 * 5120) + 51866 * 1280)
    cross = 4 * 2 * 8 * 1500 * 1280 * 2
    cache = 4 * 2 * 40 * 11 * 1280 * 2
    logits = 40 * 51866 * 4
    assert step_bytes.beam_step(TURBO["whisper"], 40, 8, 10, 2, 2) == weights + cross + cache + logits == 579_347_520


def test_a_loop_sums_its_steps():
    w = TURBO["whisper"]
    assert step_bytes.beam_loop(w, 40, 8, 4, 3, 2, 2) == sum(step_bytes.beam_step(w, 40, 8, p, 2, 2) for p in (4, 5, 6))


def _record(cell, loops, monkeypatch):
    monkeypatch.setattr(spans, "requests", lambda record: {"transcribe": [loops], "align": []})
    return SimpleNamespace(cell=spec.load_cell(cell))


def _loop(steps, ms, **counts):
    return SimpleNamespace(name="decode.loop", counts=dict(steps=steps, **counts), device_ms=ms)


@pytest.mark.parametrize("cell,per_step,weight_bytes", [
    ("large-v2-int8.longform-dense", 192, 1), ("large-v3-turbo-bf16.longform-dense", 0, 2)])
def test_share_reads_the_weights_width_off_the_span(monkeypatch, cell, per_step, weight_bytes):
    metric = spec.load_metric("decode_loop_hbm_share")
    record = _record(cell, [_loop(111, 1000.0, int8_mm_per_step=per_step), _loop(111, 1100.0, int8_mm_per_step=per_step)],
                     monkeypatch)
    w = record.cell.config["whisper"]
    kv = 1 if record.cell.config["compute_type"] == "int8" else 2
    moved = 2 * step_bytes.beam_loop(w, 40, 8, 4, 111, weight_bytes, kv)
    assert metric.read(record) == pytest.approx(100 * moved / 2.1 / 3.35e12)


def test_share_reads_nothing_from_spans_without_the_count(monkeypatch):
    """A program whose loop span does not count int8_mm_per_step (the host
    loop, or a program from before the count) gives no reading."""
    metric = spec.load_metric("decode_loop_hbm_share")
    assert metric.read(_record("large-v3-turbo-bf16.longform-dense", [_loop(111, 1000.0)], monkeypatch)) is None
    assert metric.read(_record("large-v3-turbo-bf16.longform-dense", [], monkeypatch)) is None
