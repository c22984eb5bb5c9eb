"""The beam loop's share of the card's memory bandwidth (3.35 TB/s): the
bytes its steps must move (``benchlib/step_bytes.py``: the decoder's
weights and token table, the batch's cross K/V, the self cache's filled
slots, the logits) over the ``decode.loop`` spans' device time, in the
window's untraced files. A weight counts 1 byte where the captured step
launches ``int8_matmul`` (the span's ``int8_mm_per_step``) and 2 where it
does not; the caches count at the configuration's width (int8 for an int8
model, else bf16). Nothing to read where the spans lack that count."""

from benchlib import spans, step_bytes
from reference import tokens

NAME = "decode_loop_hbm_share"
UNIT = "%"
LAYER = "pipeline and decode: decode/search.py, ops/graph_loop.py, csrc/graph_loop.cu (the beam loop)"
SOURCE = "program_span"
BETTER = "higher"
MOVES = "audio_s_per_s"


def read(record):
    reqs = spans.requests(record)
    if reqs is None:
        return None
    loops = spans.named(reqs["transcribe"], "decode.loop")
    if not loops or any("int8_mm_per_step" not in s.counts for s in loops):
        return None
    cfg = record.cell.config
    w, d = cfg["whisper"], cfg["decode"]
    kv_bytes = 1 if cfg["compute_type"] == "int8" else 2
    start = len(tokens.prompt(w["vocab_size"]))
    moved = sum(
        step_bytes.beam_loop(w, d["beam_size"] * d["batch_size"], d["batch_size"], start, s.counts["steps"],
                             1 if s.counts["int8_mm_per_step"] else 2, kv_bytes)
        for s in loops
    )
    seconds = spans.device_ms(loops) / 1e3
    return 100.0 * moved / seconds / step_bytes.HBM_BYTES_PER_S if seconds else None
