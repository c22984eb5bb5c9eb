"""Language-aware subtitle post-processor.

Behavioral equivalent of the reference's SubtitlesProcessor
(whisperx/SubtitlesProcessor.py:34-226) — properly packaged here (the
reference version is dead code due to a broken absolute import at its line
2). Splits aligned segments into readable subtitle fragments at length
limits, language-specific commas, and conjunctions; estimates timestamps for
unaligned words at 0.25 s/char; writes srt or vtt.

Implementation note: the reference computes a list of split indices in one
pass and regenerates fragments in a second; here a single forward walk
(:class:`_FragmentScan`) heals timestamps, applies the three split rules
(length-overflow midpoint, trailing comma, leading conjunction) and emits
fragments as it goes. The split decisions and all constants are kept
behavior-identical — they ARE the output contract.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Union

from .conjunctions import get_comma, get_conjunctions

COMPLEX_SCRIPT_LANGUAGES = (
    "th", "lo", "my", "km", "am", "ko", "ja", "zh", "ti", "ta", "te",
    "kn", "ml", "hi", "ne", "mr", "ar", "fa", "ur", "ka",
)
NO_SPACE_LANGUAGES = ("zh", "ja")
SECONDS_PER_CHAR = 0.25  # fallback speaking-rate estimate
END_SNAP_GAP = 0.8  # snap a fragment's end to the next start within this gap

Word = Union[dict, str]


def format_timestamp(seconds: float, is_vtt: bool = False) -> str:
    assert seconds >= 0, "non-negative timestamp expected"
    ms = round(seconds * 1000.0)
    hours, ms = divmod(ms, 3_600_000)
    minutes, ms = divmod(ms, 60_000)
    secs, ms = divmod(ms, 1_000)
    sep = "." if is_vtt else ","
    return f"{hours:02d}:{minutes:02d}:{secs:02d}{sep}{ms:03d}"


def _text_of(word: Word) -> str:
    return word["word"] if isinstance(word, dict) else word


def _heal_word_times(words: List[Word], i: int, next_segment_start: Optional[float]) -> None:
    """Fill a word's missing start/end from its neighbors, else estimate.

    Priority: previous word's end → next word's start → the following
    segment's start (backing off 0.5 s when the gap exceeds 1 s) →
    SECONDS_PER_CHAR per character → zero.
    """
    word = words[i]
    prev_end = words[i - 1].get("end") if i > 0 and isinstance(words[i - 1], dict) else None
    next_start = (
        words[i + 1].get("start")
        if i < len(words) - 1 and isinstance(words[i + 1], dict)
        else None
    )

    if prev_end is not None:
        word["start"] = prev_end
        if next_start is not None:
            word["end"] = next_start
        elif next_segment_start:
            close = next_segment_start - prev_end <= 1
            word["end"] = next_segment_start if close else next_segment_start - 0.5
        else:
            word["end"] = word["start"] + len(word["word"]) * SECONDS_PER_CHAR
    elif next_start is not None:
        word["start"] = next_start - len(word["word"]) * SECONDS_PER_CHAR
        word["end"] = next_start
    elif next_segment_start:
        word["start"] = next_segment_start - 1
        word["end"] = next_segment_start - 0.5
    else:
        word["start"] = 0
        word["end"] = 0


@dataclass
class _FragmentScan:
    """Single forward walk over a segment's words, emitting cut indices at
    the three split triggers.

    State mirrors the reference's counters exactly, including its
    *inconsistent* length accounting (the output contract): the incremental
    counter charges every word text + joiner, while the lookahead total and
    the post-overflow recompute charge timed (dict) words their text only.
    Overflow splits cut at the midpoint between the last split and the
    overflowing word — a retroactive cut; words after the midpoint stay
    pending.
    """

    words: List[Word]
    step_len: List[int]  # incremental cost: text + joiner, every word
    raw_len: List[int]  # total/recompute cost: dict words pay text only
    max_line: int
    min_split: int
    comma: str
    conjunctions: frozenset
    line_start: int = 0  # reference's last_split_point
    line_chars: int = 0
    cuts: List[int] = field(default_factory=list)  # inclusive fragment ends

    def _cut(self, index: int) -> None:
        self.cuts.append(index)

    def walk(self) -> List[int]:
        remaining = sum(self.raw_len)
        for i, word in enumerate(self.words):
            wl = self.step_len[i]
            remaining -= wl
            before = self.line_chars  # chars on the line before this word
            self.line_chars += wl

            text = _text_of(word)
            if self.line_chars >= self.max_line:
                if before >= self.min_split:
                    mid = math.floor((self.line_start + i) / 2 + 0.5)
                    self._cut(mid)
                    self.line_start = mid + 1
                    self.line_chars = sum(self.raw_len[self.line_start : i + 1])
            elif (
                text.endswith(self.comma)
                and before >= self.min_split
                and remaining >= self.min_split
            ):
                self._cut(i)
                self.line_start = i + 1
                self.line_chars = 0
            elif (
                text.lower() in self.conjunctions
                and before >= self.min_split
                and remaining >= self.min_split
            ):
                self._cut(i - 1)  # the conjunction starts the next fragment
                self.line_start = i
                self.line_chars = wl
        return self.cuts


class SubtitlesProcessor:
    def __init__(
        self,
        segments,
        lang: str,
        max_line_length: int = 45,
        min_char_length_splitter: int = 30,
        is_vtt: bool = False,
    ):
        self.segments = segments
        self.lang = lang
        self.comma = get_comma(lang)
        self.conjunctions = frozenset(get_conjunctions(lang))
        self.is_vtt = is_vtt
        if lang in COMPLEX_SCRIPT_LANGUAGES:
            max_line_length, min_char_length_splitter = 30, 20
        self.max_line_length = max_line_length
        self.min_char_length_splitter = min_char_length_splitter
        self.joiner = "" if lang in NO_SPACE_LANGUAGES else " "

    # Kept as a method for API compatibility with the reference class.
    def estimate_timestamp_for_word(self, words, i, next_segment_start_time=None):
        _heal_word_times(words, i, next_segment_start_time)

    def _segment_fragments(self, segment: dict, next_segment_start) -> List[dict]:
        words: List[Word] = segment.get("words", segment["text"].split())
        space = 0 if self.lang in NO_SPACE_LANGUAGES else 1
        step_len = [len(_text_of(w)) + space for w in words]
        raw_len = [
            len(_text_of(w)) + (0 if isinstance(w, dict) else space) for w in words
        ]

        for i, w in enumerate(words):
            if isinstance(w, dict) and ("start" not in w or "end" not in w):
                _heal_word_times(words, i, next_segment_start)

        cuts = _FragmentScan(
            words,
            step_len,
            raw_len,
            self.max_line_length,
            self.min_char_length_splitter,
            self.comma,
            self.conjunctions,
        ).walk()

        # Materialize fragments between cuts; only the IMPLICIT tail fragment
        # (not a split cut that happens to land on the last word) snaps its
        # end to the next segment's start — in the reference a split point at
        # the last word had lookahead=None and never snapped.
        cut_set = set(cuts)
        fragments = []
        elapsed = segment["start"]
        total_time = segment["end"] - segment["start"]
        lo = 0
        for hi in cuts + [len(words) - 1]:
            if hi < lo:
                lo = hi + 1
                continue
            frag = words[lo : hi + 1]
            if isinstance(frag[0], dict):
                start = frag[0]["start"]
                end = frag[-1]["end"]
                if hi + 1 < len(words) and isinstance(words[hi + 1], dict):
                    upcoming = words[hi + 1].get("start")
                elif hi == len(words) - 1 and hi not in cut_set:
                    upcoming = next_segment_start
                else:
                    upcoming = None
                if upcoming is not None and (upcoming - end) <= END_SNAP_GAP:
                    end = upcoming
                text = self.joiner.join(w["word"] for w in frag)
            else:
                duration = (len(frag) / len(words)) * total_time
                start, end = elapsed, elapsed + duration
                elapsed += duration
                text = self.joiner.join(frag).strip()
            fragments.append(
                {"start": start, "end": end if end is not None else segment["end"], "text": text}
            )
            lo = hi + 1
        return fragments

    def process_segments(self, advanced_splitting: bool = True) -> List[dict]:
        subtitles = []
        for i, segment in enumerate(self.segments):
            next_start = self.segments[i + 1]["start"] if i + 1 < len(self.segments) else None
            if advanced_splitting:
                subtitles.extend(self._segment_fragments(segment, next_start))
            else:
                words = segment.get("words", [])
                for j, word in enumerate(words):
                    if "start" not in word or "end" not in word:
                        _heal_word_times(words, j, next_start)
                subtitles.append(
                    {"start": segment["start"], "end": segment["end"], "text": segment["text"]}
                )
        return subtitles

    def save(self, filename: str = "subtitles.srt", advanced_splitting: bool = True) -> int:
        subtitles = self.process_segments(advanced_splitting)
        with open(filename, "w", encoding="utf-8") as f:
            if self.is_vtt:
                f.write("WEBVTT\n\n")
            for idx, sub in enumerate(subtitles, 1):
                f.write(f"{idx}\n")
                f.write(
                    f"{format_timestamp(sub['start'], self.is_vtt)} --> "
                    f"{format_timestamp(sub['end'], self.is_vtt)}\n"
                )
                f.write(sub["text"].strip() + "\n\n")
        return len(subtitles)
