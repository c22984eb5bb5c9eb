"""Hysteresis binarization with min-cut, and the cut&merge chunking step.

This is the algorithmic heart of the whisperX design: arbitrary-length audio
becomes a *batch* of ≤chunk_size speech windows, never a long sequence
(reference whisperx/vad.py:61-195,264-311; the min-cut rule is the paper's
contribution). Implemented as pure functions over numpy score arrays — no
pyannote Annotation machinery — so they are unit-testable and trivially
portable to the host data-loading pipeline.

Semantics parity notes (all verified against the reference):
- hysteresis: activate when score > onset, deactivate when score < offset;
- min-cut: while active, if the running region exceeds ``max_duration``, cut
  at the minimum-score frame in the *second half* of the running window, so
  no piece is shorter than max_duration/2 (vad.py:150-159);
- a region active at the end of the stream is emitted as-is;
- regions shorter than ``min_duration_on`` are dropped;
- merge_chunks greedily packs consecutive speech turns into chunks of at most
  ``chunk_size`` seconds, starting a new chunk when the next turn would not
  fit (vad.py:292-310).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class SpeechTurn:
    start: float
    end: float

    @property
    def duration(self) -> float:
        return self.end - self.start


def binarize(
    scores: np.ndarray,  # (num_frames,) detection scores in [0, 1]
    timestamps: np.ndarray,  # (num_frames,) frame-center times, seconds
    *,
    onset: float = 0.5,
    offset: Optional[float] = None,
    min_duration_on: float = 0.0,
    min_duration_off: float = 0.0,
    pad_onset: float = 0.0,
    pad_offset: float = 0.0,
    max_duration: float = float("inf"),
) -> List[SpeechTurn]:
    """Binarize frame scores into speech turns (reference Binarize semantics)."""
    scores = np.asarray(scores, dtype=np.float64)
    timestamps = np.asarray(timestamps, dtype=np.float64)
    assert scores.shape == timestamps.shape and scores.ndim == 1
    if len(scores) == 0:
        return []

    offset = offset if offset is not None else onset
    turns: List[SpeechTurn] = []

    start = timestamps[0]
    is_active = scores[0] > onset
    # Running window of the currently-active region (scores + times).
    curr_scores = [scores[0]]
    curr_times = [start]
    t = start
    for t, y in zip(timestamps[1:], scores[1:]):
        if is_active:
            curr_duration = t - start
            if curr_duration > max_duration:
                # Min-cut: split at the lowest-score frame in the second half
                # of the running window (guarantees pieces ≥ max_duration/2).
                search_after = len(curr_scores) // 2
                cut_idx = search_after + int(np.argmin(curr_scores[search_after:]))
                cut_t = curr_times[cut_idx]
                turns.append(SpeechTurn(start - pad_onset, cut_t + pad_offset))
                start = cut_t
                curr_scores = curr_scores[cut_idx + 1 :]
                curr_times = curr_times[cut_idx + 1 :]
            elif y < offset:
                turns.append(SpeechTurn(start - pad_onset, t + pad_offset))
                start = t
                is_active = False
                curr_scores = []
                curr_times = []
            curr_scores.append(y)
            curr_times.append(t)
        else:
            if y > onset:
                start = t
                is_active = True
    if is_active:
        turns.append(SpeechTurn(start - pad_onset, t + pad_offset))

    # Padding can create overlaps; merge, filling gaps < min_duration_off.
    if (pad_onset > 0.0 or pad_offset > 0.0 or min_duration_off > 0.0) and turns:
        if max_duration < float("inf"):
            raise NotImplementedError("padding/gap-fill would break max_duration")
        merged = [turns[0]]
        for turn in turns[1:]:
            if turn.start - merged[-1].end < min_duration_off:
                merged[-1] = SpeechTurn(merged[-1].start, max(merged[-1].end, turn.end))
            else:
                merged.append(turn)
        turns = merged

    if min_duration_on > 0:
        turns = [s for s in turns if s.duration >= min_duration_on]
    return turns


def merge_chunks(
    turns: Sequence[SpeechTurn],
    chunk_size: float,
) -> List[dict]:
    """Greedily pack speech turns into ≤chunk_size batching windows.

    Returns [{"start", "end", "segments": [(s, e), ...]}, ...]; downstream
    slices audio by start/end (intra-chunk silence is kept — reference
    vad.py:292-310 contract).
    """
    assert chunk_size > 0
    if not turns:
        return []

    merged: List[dict] = []
    seg_idxs: List[tuple] = []
    curr_start = turns[0].start
    curr_end = turns[0].start

    for turn in turns:
        if turn.end - curr_start > chunk_size and curr_end - curr_start > 0:
            merged.append({"start": curr_start, "end": curr_end, "segments": seg_idxs})
            curr_start = turn.start
            seg_idxs = []
        curr_end = turn.end
        seg_idxs.append((turn.start, turn.end))
    merged.append({"start": curr_start, "end": curr_end, "segments": seg_idxs})
    return merged


def binarize_and_merge(
    scores: np.ndarray,
    timestamps: np.ndarray,
    *,
    chunk_size: float = 30.0,
    onset: float = 0.5,
    offset: Optional[float] = None,
) -> List[dict]:
    """VAD scores → batching chunks (reference merge_chunks entry contract)."""
    turns = binarize(
        scores, timestamps, onset=onset, offset=offset, max_duration=chunk_size
    )
    if not turns:
        return []
    return merge_chunks(turns, chunk_size)


def merge_vad(
    segments: Sequence[tuple],
    pad_onset: float = 0.0,
    pad_offset: float = 0.0,
    min_duration_off: float = 0.0,
    min_duration_on: float = 0.0,
) -> List[SpeechTurn]:
    """Merge raw (start, end) regions with padding/gap-fill (reference
    vad.py:243-262 helper; kept for API completeness)."""
    turns = sorted(
        (SpeechTurn(s - pad_onset, e + pad_offset) for s, e in segments),
        key=lambda t: t.start,
    )
    if (pad_onset > 0 or pad_offset > 0 or min_duration_off > 0) and turns:
        merged = [turns[0]]
        for turn in turns[1:]:
            if turn.start - merged[-1].end < min_duration_off:
                merged[-1] = SpeechTurn(merged[-1].start, max(merged[-1].end, turn.end))
            else:
                merged.append(turn)
        turns = merged
    if min_duration_on > 0:
        turns = [t for t in turns if t.duration >= min_duration_on]
    return list(turns)
