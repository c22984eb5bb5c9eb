"""Host milliseconds ``load_audio`` takes a minute of audio: the benchmark's
own span around the WAV decode, over the window's untraced files."""

NAME = "ingest_ms_per_audio_min"
UNIT = "ms/min"
LAYER = "ingest: audio/io.py load_audio, native/ WAV decoder"
SOURCE = "host_clock"
BETTER = "lower"
MOVES = "audio_s_per_s"


def read(record):
    files = record.untraced
    minutes = sum(f.seconds for f in files) / 60.0
    return 1e3 * sum(f.wall["ingest"] for f in files) / minutes if minutes else None
