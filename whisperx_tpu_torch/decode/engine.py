"""Decode engine: binds the port's Whisper model to the search loops.

Port of ``whisperx_tpu/decode/engine.py``: mel features → encoder →
cross-KV precompute (optionally int8, optionally in the kernel's flat
layout) → prompt ingestion (with the no-speech probability at SOT) →
greedy or beam token loop. The JAX package jit-compiles each of these as one
program; here they run eagerly on the model's device. The weights live in
the model, so no call takes a parameter tree.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..models.whisper import Whisper, flat_cross_kv, quantize_kv
from .search import SearchOptions, beam_decode, greedy_decode
from .tokenizer import WhisperTokenizer


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


class DecodeResult:
    """Decode outputs: ``tokens`` (B, max_new) int32 and the per-row
    statistics packed as one (3, B) float32 buffer.

    Either may still be a device tensor (``generate(..., sync=False)``); the
    first read copies it to the host, which waits for the decode to finish.
    """

    def __init__(self, tokens, stats):
        self._tokens = tokens
        self._stats = stats  # [sum_logprobs, lengths, no_speech]

    def fetch(self) -> "DecodeResult":
        """Copy both buffers to the host (once)."""
        self._tokens, self._stats = _host(self._tokens), _host(self._stats)
        return self

    @property
    def tokens(self) -> np.ndarray:
        return self.fetch()._tokens

    @property
    def sum_logprobs(self) -> np.ndarray:
        return self.fetch()._stats[0]

    @property
    def lengths(self) -> np.ndarray:
        return self.fetch()._stats[1].astype(np.int32)

    @property
    def no_speech_probs(self) -> np.ndarray:
        return self.fetch()._stats[2]

    @property
    def avg_logprobs(self) -> np.ndarray:
        return self.sum_logprobs / np.maximum(self.lengths, 1)


_KV_DTYPES = ("model", "int8")


class WhisperEngine:
    """Greedy/beam decode over one model and tokenizer, on the model's device."""

    def __init__(self, model: Whisper, tokenizer: WhisperTokenizer):
        self.model = model
        self.tokenizer = tokenizer
        self.config = model.config

    @property
    def device(self) -> torch.device:
        return self.model.device

    # ---- building blocks ---------------------------------------------------

    def _encode(self, mel) -> torch.Tensor:
        return self.model.encode(torch.as_tensor(mel).to(self.device))

    def _cross_impl(self, opts: Optional[SearchOptions]) -> str:
        """Decode cross-attention impl: WHISPERX_CROSS_ATTN, then the options,
        then "xla" (the einsum path)."""
        env = os.environ.get("WHISPERX_CROSS_ATTN", "")
        if env in ("pallas", "xla"):
            return env
        pref = opts.cross_attn if opts is not None else "auto"
        if pref not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown cross_attn {pref!r}: expected auto|xla|pallas")
        return "xla" if pref == "auto" else pref

    @staticmethod
    def _kv_int8(opts: SearchOptions) -> bool:
        if opts.kv_cache_dtype not in _KV_DTYPES:
            raise NotImplementedError(
                f"kv_cache_dtype={opts.kv_cache_dtype!r} is not ported: expected one of {_KV_DTYPES}"
            )
        return opts.kv_cache_dtype == "int8"

    def _prompt_cache(
        self,
        audio_states: torch.Tensor,
        prompt_tokens: torch.Tensor,
        cache_len: int = 0,
        kv_int8: bool = False,
        cross_impl: str = "xla",
    ):
        """Run the prompt through the decoder.

        Returns (last-position logits, cache, no_speech_prob), where
        no_speech_prob is softmax(logits at the SOT position)[<|nospeech|>].
        """
        B = audio_states.shape[0]
        cache_dtype = torch.int8 if kv_int8 else None
        cache = self.model.empty_cache(B, cache_dtype=cache_dtype, cache_len=cache_len)
        cross = self.model.compute_cross_kv(audio_states)
        if cross_impl == "pallas":
            cross = [flat_cross_kv(k, v, kv_int8) for (k, v) in cross]
        elif kv_int8:
            cross = [(*quantize_kv(k), *quantize_kv(v)) for (k, v) in cross]
        cache["cross"] = cross
        logits, cache = self.model.decode_step(prompt_tokens, cache, 0)
        layout = self.tokenizer.layout
        sot_pos = int(torch.argmax((prompt_tokens[0] == layout.sot).int()))
        no_speech_prob = torch.softmax(logits[:, sot_pos], dim=-1)[:, layout.no_speech]
        return logits[:, -1], cache, no_speech_prob

    def _step_fn(self, cross):
        """Step closure over the loop-invariant cross K/V."""

        def step(tokens, self_cache, pos):
            logits, new_cache = self.model.decode_step(tokens, {"self": self_cache, "cross": cross}, pos)
            return logits, new_cache["self"]

        return step

    @staticmethod
    def _cache_len(prompt_len: int, opts: SearchOptions) -> int:
        # Self cache sized to the decode horizon, rounded up to 64.
        need = prompt_len + opts.max_new_tokens
        return min(448, -(-need // 64) * 64)

    # ---- end-to-end decode --------------------------------------------------

    @torch.inference_mode()
    def decode_greedy(self, mel, prompt_tokens, opts: SearchOptions, generator=None):
        """(B, n_mels, 3000) features + (B, P) prompt → greedy tokens."""
        prompt_tokens = prompt_tokens.to(self.device)
        audio_states = self._encode(mel)
        init_logits, cache, no_speech = self._prompt_cache(
            audio_states,
            prompt_tokens,
            self._cache_len(prompt_tokens.shape[1], opts),
            kv_int8=self._kv_int8(opts),
            cross_impl=self._cross_impl(opts),
        )
        tokens, sum_lp, lengths = greedy_decode(
            self._step_fn(cache["cross"]), init_logits, cache["self"], prompt_tokens.shape[1], opts, generator
        )
        return tokens, sum_lp, lengths, no_speech

    @torch.inference_mode()
    def decode_beam(self, mel, prompt_tokens, opts: SearchOptions):
        """(B, n_mels, 3000) features + (B, P) prompt → beam-searched tokens."""
        K = opts.beam_size
        prompt_tokens = prompt_tokens.to(self.device)
        audio_states = self._encode(mel)
        init_logits, cache, no_speech = self._prompt_cache(
            audio_states,
            prompt_tokens,
            self._cache_len(prompt_tokens.shape[1], opts),
            kv_int8=self._kv_int8(opts),
            cross_impl=self._cross_impl(opts),
        )
        # Replicate only the prompt-filled self cache per beam: (B, ...) →
        # (B*K, ...). Cross K/V stay per batch element.
        expanded = [{n: buf.repeat_interleave(K, dim=0) for n, buf in layer.items()} for layer in cache["self"]]
        tokens, sum_lp, lengths = beam_decode(
            self._step_fn(cache["cross"]), init_logits, expanded, prompt_tokens.shape[1], opts
        )
        return tokens, sum_lp, lengths, no_speech

    @torch.inference_mode()
    def language_logits(self, mel):
        """Logits over the language-token block at the SOT position."""
        layout = self.tokenizer.layout
        audio_states = self._encode(mel)
        sot = torch.full((audio_states.shape[0], 1), layout.sot, dtype=torch.long, device=self.device)
        logits, _, _ = self._prompt_cache(audio_states, sot)
        lang_ids = torch.arange(layout.sot + 1, layout.sot + 1 + layout.num_languages, device=self.device)
        return logits[:, lang_ids], lang_ids

    # ---- host-level API ----------------------------------------------------

    def detect_language(self, mel) -> list[tuple[str, float]]:
        """Per sample: (language code, probability of the argmax language)."""
        logits, lang_ids = self.language_logits(mel)
        probs = torch.softmax(logits, dim=-1)
        best_p, best = probs.max(dim=-1)
        layout = self.tokenizer.layout
        ids = lang_ids.cpu().numpy()
        return [(layout.language_of(int(ids[i])), float(p)) for i, p in zip(best.tolist(), best_p.tolist())]

    def build_options(
        self,
        *,
        beam_size: Optional[int] = 5,
        patience: float = 1.0,
        length_penalty: float = 1.0,
        temperature: float = 0.0,
        max_new_tokens: Optional[int] = None,
        suppress_tokens: Sequence[int] = (-1,),
        suppress_blank: bool = True,
        without_timestamps: bool = True,
        kv_cache_dtype: str = "model",
    ) -> SearchOptions:
        """Resolve reference-style options into SearchOptions.

        ``suppress_tokens=[-1]`` expands to the default non-speech set
        (whisperx/asr.py:313,336).
        """
        tok = self.tokenizer
        layout = tok.layout
        resolved: list[int] = []
        for t in suppress_tokens:
            if t == -1:
                resolved.extend(tok.non_speech_tokens)
            elif t >= 0:
                resolved.append(t)
        # Task/control tokens are always suppressed during generation.
        resolved.extend(
            [layout.sot, layout.sot_prev, layout.sot_lm, layout.translate, layout.transcribe, layout.no_speech]
        )
        resolved.extend(layout.language_tokens)

        banned: list[int] = []
        if without_timestamps:
            banned.extend(range(layout.timestamp_begin, layout.n_vocab))
            banned.append(layout.no_timestamps)

        max_new = max_new_tokens or (self.config.n_text_ctx // 2)
        return SearchOptions(
            beam_size=beam_size or 1,
            patience=patience,
            length_penalty=length_penalty,
            max_new_tokens=max_new,
            temperature=temperature,
            suppress_tokens=tuple(sorted(set(resolved))),
            suppress_blank=suppress_blank,
            blank_tokens=tuple(tok.encode(" ")),
            eot=layout.eot,
            banned_tokens=tuple(banned),
            kv_cache_dtype=kv_cache_dtype,
        )

    def build_prompt(
        self,
        batch: int,
        *,
        initial_prompt: Optional[str] = None,
        without_timestamps: bool = True,
        prefix_tokens: Sequence[int] = (),
    ) -> torch.Tensor:
        """Shared (batch, P) prompt for the whole batch (reference asr.py:40-45)."""
        tok = self.tokenizer
        prompt: list[int] = []
        if initial_prompt:
            prompt.append(tok.sot_prev)
            # Keep the last n_text_ctx//2 - 1 tokens (the JAX package's tail truncation).
            prompt.extend(tok.encode(" " + initial_prompt.strip())[-(self.config.n_text_ctx // 2 - 1) :])
        prompt.extend(tok.sot_sequence(without_timestamps=without_timestamps))
        prompt.extend(prefix_tokens)
        return torch.tensor(prompt, dtype=torch.long, device=self.device)[None, :].repeat(batch, 1)

    def prefix_tokens(self, prefix: Optional[str]) -> tuple:
        """Encode a decode ``prefix``: forced continuation context after the
        sot sequence, not part of the emitted text, truncated to the last
        ``n_text_ctx // 2 - 1`` tokens like initial_prompt."""
        if not prefix:
            return ()
        toks = self.tokenizer.encode(" " + prefix.strip())
        return tuple(toks[-(self.config.n_text_ctx // 2 - 1) :])

    def generate(
        self,
        mel,
        *,
        options: Optional[SearchOptions] = None,
        initial_prompt: Optional[str] = None,
        prefix: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
        sync: bool = True,
    ) -> DecodeResult:
        """Transcribe a (B, n_mels, 3000) feature batch; beam search when
        ``beam_size > 1`` at temperature 0, greedy/sampling otherwise.

        ``sync=False`` returns a result that still holds device tensors: the
        copy to the host (and the wait for the last launches) happens on the
        first read, so the caller can prepare and launch the next batch
        first."""
        opts = options or self.build_options()
        prompt = self.build_prompt(
            mel.shape[0], initial_prompt=initial_prompt, prefix_tokens=self.prefix_tokens(prefix)
        )
        if opts.beam_size > 1 and opts.temperature == 0.0:
            tokens, sum_lp, lengths, no_speech = self.decode_beam(mel, prompt, opts)
        else:
            tokens, sum_lp, lengths, no_speech = self.decode_greedy(mel, prompt, opts, generator)
        # One buffer for the per-row scalars: one copy to the host later.
        stats = torch.stack([sum_lp.float(), lengths.float(), no_speech.float()])
        result = DecodeResult(tokens.to(torch.int32), stats)
        return result.fetch() if sync else result

    def decode_text(self, result: DecodeResult) -> list[str]:
        return self.tokenizer.decode_batch([row.tolist() for row in np.asarray(result.tokens)])
