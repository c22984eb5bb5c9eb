"""Whisper's token layout and what a request allows the decoder to serve.

The prompt is <|startoftranscript|> <|en|> <|transcribe|>
<|notimestamps|>. The request suppresses every special token (end of
text included: the traffic bans it, so each chunk runs to the horizon),
every timestamp, and whisper's default non-speech symbols, which the
benchmark's byte codec encodes as single bytes; the first step also
suppresses the blank (" ").
"""

from __future__ import annotations

import torch

EOT = 50257  # multilingual vocabularies
NON_SPEECH = "\"#()*+/:;<=>@[\\]^_`{|}~-'"


def prompt(n_vocab: int) -> list:
    languages = 100 if n_vocab == 51866 else 99
    sot = EOT + 1
    translate = sot + languages + 1
    return [sot, sot + 1, translate + 1, translate + 5]  # sot, en, transcribe, notimestamps


def allowed(n_vocab: int, first: bool) -> torch.Tensor:
    ok = torch.zeros(n_vocab, dtype=torch.bool)
    ok[:EOT] = True
    ok[[ord(c) for c in NON_SPEECH]] = False
    if first:
        ok[ord(" ")] = False
    return ok


def masked_log_probs(logits: torch.Tensor, n_vocab: int, first: bool) -> torch.Tensor:
    """Log-softmax over the tokens the request allows."""
    ok = allowed(n_vocab, first).to(logits.device)
    return torch.log_softmax(logits.masked_fill(~ok, float("-inf")), dim=-1)
