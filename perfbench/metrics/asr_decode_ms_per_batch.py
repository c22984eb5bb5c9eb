"""Milliseconds of the pipeline's ``asr_decode`` stage a decode batch: log-mel,
encoder, prompt and cross K/V, the beam loop on the card and the host's
detokenization, over the window's untraced files."""

NAME = "asr_decode_ms_per_batch"
UNIT = "ms/batch"
LAYER = "pipeline and decode: pipeline/asr.py, decode/engine.py, decode/search.py, ops/graph_loop.py, models/whisper.py"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "audio_s_per_s"


def read(record):
    files = record.untraced
    batches = sum(f.batches for f in files)
    return 1e3 * sum(f.stages.get("asr_decode", 0.0) for f in files) / batches if batches else None
