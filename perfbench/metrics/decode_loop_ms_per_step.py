"""Device milliseconds a step of the decode loop: the ``decode.loop`` spans
of the window's untraced files (CUDA events recorded just before and just
after each WHILE-graph launch) over the steps those launches ran."""

from benchlib import spans

NAME = "decode_loop_ms_per_step"
UNIT = "ms/step"
LAYER = "pipeline and decode: decode/search.py, ops/graph_loop.py, csrc/graph_loop.cu (the beam loop)"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "audio_s_per_s"


def read(record):
    reqs = spans.requests(record)
    if reqs is None:
        return None
    loops = spans.named(reqs["transcribe"], "decode.loop")
    steps = sum(s.counts["steps"] for s in loops)
    return spans.device_ms(loops) / steps if steps else None
