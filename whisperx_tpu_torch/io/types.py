"""Data contracts between pipeline stages.

Mirrors the reference's TypedDict contracts (whisperx/types.py:4-58) so a user
of the reference finds identical result shapes; the dict keys are the public
API surface consumed by the writers and by downstream tools. A copy of
``whisperx_tpu/io/types.py``: the port keeps its own so it never imports the
JAX package (tests hold the two equal).
"""

from __future__ import annotations

from typing import List, Optional, TypedDict


class SingleWordSegment(TypedDict):
    """A single word of a speech."""

    word: str
    start: float
    end: float
    score: float


class SingleCharSegment(TypedDict):
    """A single char of a speech."""

    char: str
    start: float
    end: float
    score: float


class SingleSegment(TypedDict):
    """A single segment (up to multiple sentences) of a speech."""

    start: float
    end: float
    text: str


class SingleAlignedSegment(TypedDict):
    """A single segment of a speech with word alignment."""

    start: float
    end: float
    text: str
    words: List[SingleWordSegment]
    chars: Optional[List[SingleCharSegment]]


class TranscriptionResult(TypedDict):
    """A list of segments of a speech, with the detected/used language."""

    segments: List[SingleSegment]
    language: str


class AlignedTranscriptionResult(TypedDict):
    """Aligned segments plus the flat word list."""

    segments: List[SingleAlignedSegment]
    word_segments: List[SingleWordSegment]
