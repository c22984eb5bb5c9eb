"""Milliseconds of ``align`` (telemetry record ``align``: wav2vec2 emissions,
the CTC kernel, host aggregation) a minute of aligned speech (the chunks'
audio), over the window's untraced files."""

NAME = "align_ms_per_audio_min"
UNIT = "ms/min"
LAYER = "alignment: align/alignment.py, models/wav2vec2.py, ops/ctc.py"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "audio_s_per_s"


def read(record):
    files = record.untraced
    minutes = sum(e - s for f in files for s, e in f.chunks) / 60.0
    return 1e3 * sum(f.stages.get("align", 0.0) for f in files) / minutes if minutes else None
