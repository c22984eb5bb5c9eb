"""The whole pipeline's share of the card's bf16 dense peak (989 TFLOP/s):
the model FLOPs the window's untraced files needed (encoder and cross K/V of
each chunk, the prompt and the beams at every step of the horizon with
their logits, wav2vec2 over each chunk's samples; padded rows left out)
over the host seconds those files took."""

from benchlib import flops
from reference import tokens

NAME = "pipeline_mfu"
UNIT = "%"
LAYER = "whole pipeline"
SOURCE = "host_clock"
BETTER = "higher"
MOVES = "audio_s_per_s"


def read(record):
    cfg = record.cell.config
    w, a, d = cfg["whisper"], cfg["wav2vec2"], cfg["decode"]
    files = record.untraced
    seconds = sum(f.wall["total"] for f in files)
    if not seconds:
        return None
    chunk = flops.whisper_chunk(w, len(tokens.prompt(w["vocab_size"])), d["beam_size"], d["max_new_tokens"])
    total = 0.0
    for f in files:
        total += chunk * len(f.chunks)
        for s, e in f.chunks:
            total += flops.wav2vec2_chunk(a, int(round(e, 3) * 16000) - int(round(s, 3) * 16000))
    return 100.0 * total / seconds / flops.BF16_FLOPS
