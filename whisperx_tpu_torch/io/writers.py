"""Transcript serialization: txt / vtt / srt / tsv / json / aud.

Output-format parity with the reference writers (whisperx/utils.py:192-431):
same file extensions, same cue layout, same word-grouping options
(``max_line_width``, ``max_line_count``, ``highlight_words``) and the same
``[SPEAKER]:`` prefixes — but structured here as a two-stage pure function:
word stream → subtitle blocks → cue tuples, so the grouping logic is unit
testable without touching the filesystem.
"""

from __future__ import annotations

import json
import os
import re
from typing import Callable, Iterator, Optional, TextIO

from ..utils import format_timestamp
from .languages import LANGUAGES_WITHOUT_SPACES


class ResultWriter:
    extension: str

    def __init__(self, output_dir: str):
        self.output_dir = output_dir

    def __call__(self, result: dict, audio_path: str, options: dict):
        base = os.path.splitext(os.path.basename(audio_path))[0]
        output_path = os.path.join(self.output_dir, base + "." + self.extension)
        with open(output_path, "w", encoding="utf-8") as f:
            self.write_result(result, file=f, options=options)

    def write_result(self, result: dict, file: TextIO, options: dict):
        raise NotImplementedError


class WriteTXT(ResultWriter):
    extension = "txt"

    def write_result(self, result: dict, file: TextIO, options: dict):
        for segment in result["segments"]:
            print(segment["text"].strip(), file=file, flush=True)


def _iter_subtitle_blocks(segments, max_line_width, max_line_count, preserve_segments):
    """Group the word stream into subtitle blocks.

    Yields ``(words, seg_times)`` where ``words`` is a list of word-timing
    dicts (word text already carries its line breaks) and ``seg_times`` holds
    the owning segment's ``(start, end, speaker)`` per word. Grouping rules:
    lines wrap at ``max_line_width`` chars; a block ends at ``max_line_count``
    lines, at a >3 s pause (only when segments aren't preserved), or at a
    segment boundary (only when they are).
    """
    width_cap = 1000 if max_line_width is None else max_line_width
    block: list[dict] = []
    seg_times: list[tuple] = []
    line_len = 0
    line_count = 1
    prev_start = segments[0]["start"] if segments else 0.0

    for segment in segments:
        for word_idx, timing in enumerate(segment["words"]):
            word = dict(timing)
            pause = (
                not preserve_segments
                and "start" in word
                and word["start"] - prev_start > 3.0
            )
            fits = line_len + len(word["word"]) <= width_cap
            at_seg_start = preserve_segments and word_idx == 0 and block

            if line_len > 0 and fits and not pause and not at_seg_start:
                line_len += len(word["word"])
            else:
                word["word"] = word["word"].strip()
                block_full = (
                    block
                    and max_line_count is not None
                    and (pause or line_count >= max_line_count)
                )
                if block_full or at_seg_start:
                    yield block, seg_times
                    block, seg_times = [], []
                    line_count = 1
                elif line_len > 0:
                    line_count += 1
                    word["word"] = "\n" + word["word"]
                line_len = len(word["word"].strip())

            block.append(word)
            seg_times.append((segment["start"], segment["end"], segment.get("speaker")))
            if "start" in word:
                prev_start = word["start"]

    if block:
        yield block, seg_times


class SubtitlesWriter(ResultWriter):
    always_include_hours: bool
    decimal_marker: str

    def format_timestamp(self, seconds: float) -> str:
        return format_timestamp(
            seconds=seconds,
            always_include_hours=self.always_include_hours,
            decimal_marker=self.decimal_marker,
        )

    def iterate_result(self, result: dict, options: dict) -> Iterator[tuple]:
        segments = result["segments"]
        if not segments:
            return

        if "words" not in segments[0]:
            # Segment-level cues (no alignment ran).
            for segment in segments:
                text = segment["text"].strip().replace("-->", "->")
                if "speaker" in segment:
                    text = f"[{segment['speaker']}]: {text}"
                yield (
                    self.format_timestamp(segment["start"]),
                    self.format_timestamp(segment["end"]),
                    text,
                )
            return

        raw_width: Optional[int] = options["max_line_width"]
        max_line_count: Optional[int] = options["max_line_count"]
        highlight_words: bool = options["highlight_words"]
        preserve_segments = max_line_count is None or raw_width is None
        joiner = "" if result.get("language") in LANGUAGES_WITHOUT_SPACES else " "

        for block, seg_times in _iter_subtitle_blocks(
            segments, raw_width, max_line_count, preserve_segments
        ):
            seg_start, seg_end, speaker = seg_times[0]
            cue_start = self.format_timestamp(seg_start)
            cue_end = self.format_timestamp(seg_end)
            text = joiner.join(w["word"] for w in block)
            prefix = f"[{speaker}]: " if speaker is not None else ""
            timed_words = [w for w in block if "start" in w]

            if highlight_words and timed_words:
                # One cue per word, underlining the active word.
                last = cue_start
                tokens = [w["word"] for w in block]
                for i, word in enumerate(block):
                    if "start" not in word:
                        continue
                    w_start = self.format_timestamp(word["start"])
                    w_end = self.format_timestamp(word["end"])
                    if last != w_start:
                        yield last, w_start, prefix + text
                    highlighted = " ".join(
                        re.sub(r"^(\s*)(.*)$", r"\1<u>\2</u>", tok) if j == i else tok
                        for j, tok in enumerate(tokens)
                    )
                    yield w_start, w_end, prefix + highlighted
                    last = w_end
            else:
                yield cue_start, cue_end, prefix + text


class WriteVTT(SubtitlesWriter):
    extension = "vtt"
    always_include_hours = False
    decimal_marker = "."

    def write_result(self, result: dict, file: TextIO, options: dict):
        print("WEBVTT\n", file=file)
        for start, end, text in self.iterate_result(result, options):
            print(f"{start} --> {end}\n{text}\n", file=file, flush=True)


class WriteSRT(SubtitlesWriter):
    extension = "srt"
    always_include_hours = True
    decimal_marker = ","

    def write_result(self, result: dict, file: TextIO, options: dict):
        for i, (start, end, text) in enumerate(self.iterate_result(result, options), start=1):
            print(f"{i}\n{start} --> {end}\n{text}\n", file=file, flush=True)


class WriteTSV(ResultWriter):
    """start/end in integer milliseconds, tab-separated (locale-proof)."""

    extension = "tsv"

    def write_result(self, result: dict, file: TextIO, options: dict):
        print("start", "end", "text", sep="\t", file=file)
        for segment in result["segments"]:
            print(round(1000 * segment["start"]), file=file, end="\t")
            print(round(1000 * segment["end"]), file=file, end="\t")
            print(segment["text"].strip().replace("\t", " "), file=file, flush=True)


class WriteAudacity(ResultWriter):
    """Audacity label track: seconds (not ms), tab-separated, no header."""

    extension = "aud"

    def write_result(self, result: dict, file: TextIO, options: dict):
        for segment in result["segments"]:
            speaker = f"[[{segment['speaker']}]]" if "speaker" in segment else ""
            print(segment["start"], file=file, end="\t")
            print(segment["end"], file=file, end="\t")
            print(speaker + segment["text"].strip().replace("\t", " "), file=file, flush=True)


class WriteJSON(ResultWriter):
    extension = "json"

    def write_result(self, result: dict, file: TextIO, options: dict):
        json.dump(result, file, ensure_ascii=False)


_WRITERS = {
    "txt": WriteTXT,
    "vtt": WriteVTT,
    "srt": WriteSRT,
    "tsv": WriteTSV,
    "json": WriteJSON,
}
_OPTIONAL_WRITERS = {"aud": WriteAudacity}


def get_writer(output_format: str, output_dir: str) -> Callable[[dict, str, dict], None]:
    if output_format == "all":
        all_writers = [w(output_dir) for w in _WRITERS.values()]

        def write_all(result: dict, audio_path: str, options: dict):
            for writer in all_writers:
                writer(result, audio_path, options)

        return write_all
    if output_format in _OPTIONAL_WRITERS:
        return _OPTIONAL_WRITERS[output_format](output_dir)
    return _WRITERS[output_format](output_dir)
