"""Milliseconds of the pipeline's ``vad`` stage (speech-band scores, cut and
merge, on the host) a minute of audio, over the window's untraced files."""

NAME = "vad_ms_per_audio_min"
UNIT = "ms/min"
LAYER = "VAD cut and merge: vad/model.py, vad/binarize.py"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "audio_s_per_s"


def read(record):
    files = record.untraced
    minutes = sum(f.seconds for f in files) / 60.0
    return 1e3 * sum(f.stages.get("vad", 0.0) for f in files) / minutes if minutes else None
