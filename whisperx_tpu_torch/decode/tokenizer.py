"""Whisper tokenizer: BPE text codec + the special-token control layout.

Replaces the faster-whisper tokenizer wrapper the reference uses
(whisperx/asr.py:6,196-205). The control-token layout (SOT, language block,
task tokens, timestamps) is a deterministic function of the vocabulary size,
so it is computed here instead of read from config — one source of truth for
greedy/beam decode, suppression masks, and language ID.

Two text backends:
- ``BPEBackend``: byte-level BPE loaded from local HF tokenizer files
  (tokenizer.json via the ``tokenizers`` lib, or vocab.json + merges.txt).
- ``ByteBackend``: latin-1 byte fallback used by unit tests and random-weight
  benchmarks — same id layout, no vocab files needed.

A copy of ``whisperx_tpu/decode/tokenizer.py``: the port keeps its own so it never
imports the JAX package (tests hold the two equal).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from functools import cached_property
from typing import Optional, Sequence

from ..io.languages import LANGUAGE_CODES, TO_LANGUAGE_CODE

# Symbols whose standalone tokens are suppressed by default ("non-speech"
# annotations like music notes and bracketed noises — the openai-whisper
# convention the reference inherits through CT2's default suppress set).
_NON_SPEECH_SYMBOLS = (
    '"', "#", "(", ")", "*", "+", "/", ":", ";", "<", "=", ">", "@", "[", "\\",
    "]", "^", "_", "`", "{", "|", "}", "~", "「", "」", "『", "』", "<<", ">>",
    "<<<", ">>>", "--", "---", "-(", "-[", "('", '("', "((", "))", "(((", ")))",
    "[[", "]]", "{{", "}}", "♪♪", "♪♪♪", "♩", "♪", "♫", "♬", "♭", "♮", "♯",
)


@dataclass(frozen=True)
class TokenLayout:
    """Control-token ids for a given vocab size / language count."""

    n_vocab: int
    num_languages: int
    eot: int
    sot: int
    translate: int
    transcribe: int
    sot_lm: int
    sot_prev: int
    no_speech: int
    no_timestamps: int
    timestamp_begin: int

    @property
    def language_tokens(self) -> range:
        return range(self.sot + 1, self.sot + 1 + self.num_languages)

    def language_token(self, code: str) -> int:
        code = TO_LANGUAGE_CODE.get(code, code)
        try:
            idx = LANGUAGE_CODES.index(code)
        except ValueError:
            raise KeyError(f"unknown language: {code!r}")
        if idx >= self.num_languages:
            raise KeyError(f"language {code!r} not in this model's {self.num_languages}-language vocab")
        return self.sot + 1 + idx

    def language_of(self, token: int) -> str:
        return LANGUAGE_CODES[token - self.sot - 1]

    def timestamp_token(self, seconds: float) -> int:
        return self.timestamp_begin + int(round(seconds / 0.02))


def token_layout(n_vocab: int, num_languages: Optional[int] = None) -> TokenLayout:
    """Whisper's published id layout: specials appended after the text vocab.

    Multilingual models place <|endoftext|> at 50257 (v3 layouts shift by one
    language), English-only at 50256; then <|startoftranscript|>, the language
    block, <|translate|>, <|transcribe|>, <|startoflm|>, <|startofprev|>,
    <|nospeech|>, <|notimestamps|>, and 1501 timestamp tokens (0.00–30.00 s in
    20 ms steps).
    """
    multilingual = n_vocab >= 51865
    if num_languages is None:
        num_languages = 100 if n_vocab == 51866 else 99
    eot = 50257 if multilingual else 50256
    sot = eot + 1
    translate = sot + num_languages + 1
    return TokenLayout(
        n_vocab=n_vocab,
        num_languages=num_languages,
        eot=eot,
        sot=sot,
        translate=translate,
        transcribe=translate + 1,
        sot_lm=translate + 2,
        sot_prev=translate + 3,
        no_speech=translate + 4,
        no_timestamps=translate + 5,
        timestamp_begin=translate + 6,
    )


class ByteBackend:
    """Latin-1 byte codec with the real id layout — for tests/benchmarks."""

    def __init__(self, n_vocab: int):
        self.n_vocab = n_vocab

    def encode(self, text: str) -> list[int]:
        return [b for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", errors="replace")

    def id_to_piece(self, i: int) -> str:
        return chr(i) if i < 256 else ""


class BPEBackend:
    """Byte-level BPE from local HF files (tokenizer.json or vocab+merges)."""

    def __init__(self, path: str):
        from tokenizers import Tokenizer

        tok_json = os.path.join(path, "tokenizer.json")
        if os.path.exists(tok_json):
            self._tok = Tokenizer.from_file(tok_json)
        else:
            from tokenizers.models import BPE
            from tokenizers import decoders, pre_tokenizers

            vocab_file = os.path.join(path, "vocab.json")
            merges_file = os.path.join(path, "merges.txt")
            self._tok = Tokenizer(BPE.from_file(vocab_file, merges_file))
            self._tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
            self._tok.decoder = decoders.ByteLevel()
        self.n_vocab = self._tok.get_vocab_size()

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text, add_special_tokens=False).ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=False)

    def id_to_piece(self, i: int) -> str:
        return self._tok.decode([i])


class WhisperTokenizer:
    """Text codec + control-token helpers for one model configuration."""

    def __init__(
        self,
        backend,
        n_vocab: int,
        num_languages: int = 99,
        *,
        language: Optional[str] = None,
        task: str = "transcribe",
    ):
        self.backend = backend
        self.layout = token_layout(n_vocab, num_languages)
        self.is_multilingual = n_vocab >= 51865
        self.language = TO_LANGUAGE_CODE.get(language, language) if language else None
        self.task = task

    # -- construction -------------------------------------------------------

    @classmethod
    def from_pretrained(
        cls, path: str, *, language: Optional[str] = None, task: str = "transcribe"
    ) -> "WhisperTokenizer":
        """Load from a local HF checkpoint dir (no network)."""
        cfg_file = os.path.join(path, "config.json")
        n_vocab = None
        if os.path.exists(cfg_file):
            with open(cfg_file) as f:
                n_vocab = json.load(f).get("vocab_size")
        backend = BPEBackend(path)
        if n_vocab is None:
            n_vocab = max(backend.n_vocab, 51865)
        num_languages = 100 if n_vocab == 51866 else 99
        return cls(backend, n_vocab, num_languages, language=language, task=task)

    @classmethod
    def dummy(
        cls, n_vocab: int = 51865, *, language: Optional[str] = "en", task: str = "transcribe"
    ) -> "WhisperTokenizer":
        num_languages = 100 if n_vocab == 51866 else 99
        return cls(ByteBackend(n_vocab), n_vocab, num_languages, language=language, task=task)

    # -- control tokens -----------------------------------------------------

    @property
    def eot(self) -> int:
        return self.layout.eot

    @property
    def sot(self) -> int:
        return self.layout.sot

    @property
    def sot_prev(self) -> int:
        return self.layout.sot_prev

    @property
    def no_timestamps(self) -> int:
        return self.layout.no_timestamps

    @property
    def timestamp_begin(self) -> int:
        return self.layout.timestamp_begin

    @property
    def no_speech(self) -> int:
        return self.layout.no_speech

    def sot_sequence(self, *, without_timestamps: bool = True) -> list[int]:
        """<|startoftranscript|> [<|lang|> <|task|>] [<|notimestamps|>]."""
        seq = [self.layout.sot]
        if self.is_multilingual:
            lang = self.language or "en"
            seq.append(self.layout.language_token(lang))
            seq.append(
                self.layout.translate if self.task == "translate" else self.layout.transcribe
            )
        if without_timestamps:
            seq.append(self.layout.no_timestamps)
        return seq

    @cached_property
    def non_speech_tokens(self) -> tuple[int, ...]:
        """Default suppress set: standalone noise/annotation symbol tokens.

        Mirrors the openai-whisper default suppression the reference gets via
        CT2's ``suppress_tokens=[-1]`` (whisperx/asr.py:60,313).
        """
        found = set()
        # "-" and "'" only in their bare form; symbols with and without space.
        for sym in ["-", "'"]:
            ids = self.backend.encode(sym)
            if len(ids) == 1:
                found.add(ids[0])
        for sym in _NON_SPEECH_SYMBOLS:
            for variant in (sym, " " + sym):
                ids = self.backend.encode(variant)
                if len(ids) == 1:
                    found.add(ids[0])
        return tuple(sorted(t for t in found if t < self.layout.eot))

    # -- text codec ---------------------------------------------------------

    def encode(self, text: str) -> list[int]:
        return self.backend.encode(text)

    def decode(self, ids: Sequence[int]) -> str:
        return self.backend.decode([i for i in ids if i < self.layout.eot])

    def decode_batch(self, batch: Sequence[Sequence[int]]) -> list[str]:
        return [self.decode(ids) for ids in batch]
