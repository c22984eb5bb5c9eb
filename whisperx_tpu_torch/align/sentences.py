"""Host-side sentence splitting (the reference's nltk-punkt replacement).

The reference builds an *untrained* ``PunktSentenceTokenizer`` with a fixed
abbreviation list and takes ``span_tokenize`` spans
(whisperx/alignment.py:20,169-172). Untrained punkt has no collocation or
orthographic statistics, so its decisions reduce to a deterministic rule set;
this module implements those rules on plain ``re`` — no nltk import, no
model download — and is parity-tested against nltk punkt in
tests/test_align.py (nltk as a test oracle only). A copy of
``whisperx_tpu/align/sentences.py`` (tests hold the two equal).

Rules (untrained punkt first-pass annotation + the second-pass branches that
survive with empty statistics + boundary realignment):
- A run of ``.!?`` followed by whitespace (or end of text) closes a
  sentence; trailing closing quotes/brackets attach to it.
- A lone ``.`` does NOT close when the word before it is a known
  abbreviation (or a ``-``-suffixed form of one) or a single-letter initial.
- A lone ``.`` after a bare number closes only when the next word does not
  start lowercase (untrained ortho heuristic).
- ``..``/``...`` (ellipsis) never closes.
- The first span starts at offset 0 (leading whitespace included — punkt
  quirk); later spans start at the next non-space character; a whitespace-only
  tail produces no span.
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple

# Reference abbreviation list (whisperx/alignment.py:20).
PUNKT_ABBREVIATIONS = ("dr", "vs", "mr", "mrs", "prof")

# End punctuation run + attached closers, at a whitespace/end boundary.
_BOUNDARY_RE = re.compile(r"([.!?]+)([\"'\)\]\}”’»]*)(?=\s|$)")
# The whitespace-delimited token immediately before a candidate period.
_PREV_TOKEN_RE = re.compile(r"(\S+)$", re.UNICODE)
# Punkt's numeric token shape (type ##number##).
_NUMBER_RE = re.compile(r"-?[.,]?\d[\d,.-]*")
# Next-token characters whose ortho heuristic answers False (no break).
_ORTHO_FALSE_NEXT = ";,:.!?"


def _lone_period_breaks(text: str, punct_start: int, after: int, abbreviations) -> bool:
    """Untrained-punkt decision for a single '.' candidate at punct_start."""
    m = _PREV_TOKEN_RE.search(text, 0, punct_start)
    if not m:
        return True
    token = m.group(1).lower()
    if token in abbreviations or token.rsplit("-", 1)[-1] in abbreviations:
        return False
    # Single-letter initial ("J. Smith"): with no orthographic statistics the
    # downgrade branch always fires, so initials never break.
    if len(token) == 1 and token.isalpha():
        return False
    # Bare number: breaks only before a non-lowercase sentence starter.
    if _NUMBER_RE.fullmatch(token):
        rest = text[after:].lstrip()
        if rest and (rest[0].islower() or rest[0] in _ORTHO_FALSE_NEXT):
            return False
    return True


def sentence_spans(
    text: str, abbreviations: Sequence[str] = PUNKT_ABBREVIATIONS
) -> List[Tuple[int, int]]:
    """Split ``text`` into (start, end) sentence spans.

    Matches punkt ``span_tokenize`` span conventions: the first span starts
    at 0, later spans at the first non-space character after the previous
    sentence; each span ends after its closing punctuation (plus attached
    quotes/brackets); the final unpunctuated tail is its own span with
    trailing whitespace trimmed.
    """
    abbreviations = frozenset(a.lower() for a in abbreviations)
    spans: List[Tuple[int, int]] = []
    start = 0

    def emit(end: int) -> None:
        nonlocal start
        s = start
        if spans:  # punkt keeps leading whitespace only for the first span
            while s < end and text[s].isspace():
                s += 1
        if s < end:
            spans.append((s, end))
        start = end

    for m in _BOUNDARY_RE.finditer(text):
        punct = m.group(1)
        if punct == ".":
            if not _lone_period_breaks(text, m.start(), m.end(), abbreviations):
                continue
        elif set(punct) == {"."}:
            continue  # '..' / '...' ellipsis — punkt does not break here
        emit(m.end())

    # Trailing text without closing punctuation forms the last sentence.
    end = len(text)
    while end > start and text[end - 1].isspace():
        end -= 1
    emit(end)
    return spans
