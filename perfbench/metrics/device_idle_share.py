"""The card's idle share over the window's untraced files: one less the
device time of the program's device spans (``asr.prepare``,
``decode.loop``, ``align.emissions``, ``align.ctc``) over the files' host
seconds. A span counts as busy over its whole interval, and one whose start
event fires on an idle stream also counts the host's enqueue time, so this
is a floor on the true idle share. None without a card."""

from benchlib import spans

NAME = "device_idle_share"
UNIT = "share"
LAYER = "whole pipeline"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "audio_s_per_s"

BUSY = {"transcribe": ("asr.prepare", "decode.loop"), "align": ("align.emissions", "align.ctc")}


def read(record):
    reqs = spans.requests(record)
    if reqs is None:
        return None
    busy = [s for kind, names in BUSY.items() for name in names for s in spans.named(reqs[kind], name)]
    if not any(s.device.startswith("cuda") for s in busy):
        return None  # host time only: no card to be idle
    total_ms = 1e3 * sum(f.wall["total"] for f in record.untraced)
    return 1.0 - spans.device_ms(busy) / total_ms
