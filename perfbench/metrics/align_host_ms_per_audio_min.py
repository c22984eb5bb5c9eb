"""Host milliseconds of alignment's aggregation (the ``align.aggregate``
spans: the fetched packs into CTC paths, then characters, words and
sentences) a minute of aligned speech (the chunks' audio), over the
window's untraced files."""

from benchlib import spans

NAME = "align_host_ms_per_audio_min"
UNIT = "ms/min"
LAYER = "alignment: align/alignment.py host aggregation"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "audio_s_per_s"


def read(record):
    reqs = spans.requests(record)
    minutes = sum(e - s for f in record.untraced for s, e in f.chunks) / 60.0
    if reqs is None or not minutes:
        return None
    return sum(s.host_ms for s in spans.named(reqs["align"], "align.aggregate")) / minutes
