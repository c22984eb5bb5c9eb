"""Word-to-speaker assignment by maximal temporal intersection.

Same semantics as the reference (whisperx/diarize.py:35-67): for each segment
and each timestamped word, pick the speaker with the largest *summed* overlap
with the diarization turns; ``fill_nearest`` allows negative overlap (nearest
turn) when nothing intersects. Vectorized numpy over the turn table instead
of per-row pandas ops.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _best_speaker(starts, ends, speakers, t0: float, t1: float, fill_nearest: bool) -> Optional[str]:
    inter = np.minimum(ends, t1) - np.maximum(starts, t0)
    if not fill_nearest:
        mask = inter > 0
        if not mask.any():
            return None
        inter = inter[mask]
        spk = speakers[mask]
    else:
        spk = speakers
    # Sum per speaker, take the argmax (ties: first in sorted order, matching
    # pandas groupby().sum().sort_values(ascending=False)).
    uniq, idx = np.unique(spk, return_inverse=True)
    sums = np.zeros(len(uniq))
    np.add.at(sums, idx, inter)
    return str(uniq[np.argmax(sums)])


def assign_word_speakers(diarize_df, transcript_result, fill_nearest: bool = False):
    """Annotate segments and words with 'speaker' (reference API/behavior)."""
    starts = np.asarray(diarize_df["start"], dtype=np.float64)
    ends = np.asarray(diarize_df["end"], dtype=np.float64)
    speakers = np.asarray(diarize_df["speaker"]).astype(object)

    if len(starts) == 0:
        return transcript_result

    for seg in transcript_result["segments"]:
        speaker = _best_speaker(starts, ends, speakers, seg["start"], seg["end"], fill_nearest)
        if speaker is not None:
            seg["speaker"] = speaker
        for word in seg.get("words", []):
            if "start" in word:
                speaker = _best_speaker(
                    starts, ends, speakers, word["start"], word["end"], fill_nearest
                )
                if speaker is not None:
                    word["speaker"] = speaker
    return transcript_result


class Segment:
    """Plain (start, end, speaker) holder (reference diarize.py:70-74)."""

    def __init__(self, start, end, speaker=None):
        self.start = start
        self.end = end
        self.speaker = speaker
