"""Decode engine: binds the port's Whisper model to the search loops.

Port of ``whisperx_tpu/decode/engine.py``: mel features → encoder →
cross-KV precompute (optionally int8 or int4, optionally in the kernel's
flat layout) → prompt ingestion (with the no-speech probability at SOT) →
greedy or beam token loop. The JAX package jit-compiles each of these as one
program; here the stages before the loop run eagerly on the model's device,
and the loop runs as one CUDA graph launch where
:meth:`WhisperEngine.uses_device_loop` says so (the host loop elsewhere).
The weights live in the model, so no call takes a parameter tree.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Optional, Sequence

import numpy as np
import torch

from ..models.whisper import Whisper, flat_cross_kv
from ..ops.cross_attn import HEAD_DIM
from ..ops.graph_loop import DeviceLoop
from ..ops.quant import PACKED_INT4, store_kv
from ..parallel.mesh import axis_index, gather_rows
from ..utils import telemetry
from .search import BeamLoop, GreedyLoop, LoopResult, SearchOptions, beam_decode, greedy_decode
from .tokenizer import WhisperTokenizer

# Captured device loops kept per model (``Whisper.decode_loops``), the least
# recently used dropped first. Each holds its static inputs: at large-v2,
# batch 8 x beam 5, ~1 GB of int8 cross K/V, ~0.4 GB of int8 self cache and
# as much again of reorder scratch.
MAX_DEVICE_LOOPS = 4


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


class DecodeResult:
    """Decode outputs: ``tokens`` (B, max_new) int32 and the per-row
    statistics packed as one (4, B) float32 buffer: sum_logprobs, lengths,
    no_speech and the steps the batch's loop ran (the same in each row).

    Either may still be a device tensor (``generate(..., sync=False)``); the
    first read copies it to the host, which waits for the decode to finish.
    ``loop_span``: the ``decode.loop`` telemetry span of the batch; the
    first read gives it its ``steps`` where the loop ran on the card.
    """

    def __init__(self, tokens, stats, loop_span=None, steps_column: int = 0):
        self._tokens = tokens
        self._stats = stats  # [sum_logprobs, lengths, no_speech, steps]
        self.loop_span = loop_span
        self._steps_column = steps_column  # a row of this process's loop

    def fetch(self) -> "DecodeResult":
        """Copy both buffers to the host (once)."""
        if isinstance(self._stats, torch.Tensor):
            self._tokens, self._stats = _host(self._tokens), _host(self._stats)
            if self.loop_span is not None:
                self.loop_span.counts.setdefault("steps", int(self._stats[3, self._steps_column]))
                telemetry.resolve()  # the loop has ended: read its events
        return self

    def gathered(self, mesh) -> "DecodeResult":
        """The rows of every rank of the mesh's "data" axis, in rank order
        (a collective: every rank calls it). Call before the first read."""
        return DecodeResult(gather_rows(mesh, self._tokens), gather_rows(mesh, self._stats, dim=1), self.loop_span,
                            axis_index(mesh, "data") * self._stats.shape[1])

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


# kv_cache_dtype → the width of the quantized self cache and cross K/V (0: the model's dtype).
_KV_BITS = {"model": 0, "int8": 8, "int4": 4}


def resolve_cross_impl(device, dtype: torch.dtype, kv_bits: int, width: int, n_head: int) -> str:
    """The decode cross-attention route: "pallas" (``ops/cross_attn.py``'s
    kernel) or "xla" (the einsum path), given a decoder layer's local
    ``width`` and ``n_head`` (a rank's heads under tensor parallelism). The
    kernel is taken where it computes the einsum path's function: on a CUDA
    device, bf16 compute (the kernel reads bf16 queries), cross K/V int8 or
    in the model's dtype, and shapes inside the kernel's contract (heads of
    64, an even head count, a width that is a multiple of 128). Elsewhere
    the einsum path, as the JAX package's TPU default is everywhere."""
    kernel = (
        torch.device(device).type == "cuda"
        and dtype == torch.bfloat16
        and kv_bits in (0, 8)
        and width == n_head * HEAD_DIM
        and n_head % 2 == 0
        and width % 128 == 0
    )
    return "pallas" if kernel else "xla"


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

    def _cross_impl(self, opts: SearchOptions) -> str:
        """Decode cross-attention route, :func:`resolve_cross_impl` over the
        model and the options. On the card that is the kernel (bf16 compute,
        int8 or bf16 cross K/V), where the JAX package's TPU default is the
        einsum: here the einsum casts each layer's whole K and V to bf16
        every step, and the kernel reads them once."""
        attn = self.model.decoder.layers[0].cross_attn
        return resolve_cross_impl(self.device, self.model.dtype, self._kv_bits(opts), attn.width, attn.n_head)

    @staticmethod
    def _kv_bits(opts: SearchOptions) -> int:
        if opts.kv_cache_dtype not in _KV_BITS:
            raise ValueError(f"kv_cache_dtype={opts.kv_cache_dtype!r}: expected one of {tuple(_KV_BITS)}")
        return _KV_BITS[opts.kv_cache_dtype]

    def _cross_kv(self, audio_states: torch.Tensor, kv_bits: int, cross_impl: str, out: Optional[list] = None) -> list:
        """Each decoder layer's cross K/V in the form the step reads: int8 or
        int4 with ``kv_bits``, the kernel's flat layout with
        ``cross_impl="pallas"``, else the model's dtype. Layer by layer, so
        that one layer's K/V at a time exists in the model's dtype. With
        ``out`` (a device loop's static buffers, :meth:`_loop_cross`) each
        layer lands in them and ``out`` is returned."""
        cross = []
        for i, block in enumerate(self.model.decoder.layers):
            k, v = block.compute_cross_kv(audio_states)
            if cross_impl == "pallas":
                # The kernel reads int8 K/V: an int4 request gets int8 cross
                # K/V while its self cache stays int4, as in the JAX package.
                kv = flat_cross_kv(k, v, kv_bits in (4, 8))
            elif kv_bits:
                kv = (*store_kv(k, kv_bits), *store_kv(v, kv_bits))
            else:
                kv = (k.to(self.model.dtype), v.to(self.model.dtype))
            if out is None:
                cross.append(kv)
            else:
                for dst, src in zip(out[i], kv):
                    dst.copy_(src)
        return cross if out is None else out

    def _prompt_cache(
        self,
        audio_states: torch.Tensor,
        prompt_tokens: torch.Tensor,
        cache_len: int = 0,
        kv_bits: int = 0,
        cross_impl: str = "xla",
        cross: Optional[list] = None,
    ):
        """Run the prompt through the decoder.

        Returns (last-position logits, cache, no_speech_prob), where
        no_speech_prob is softmax(logits at the SOT position)[<|nospeech|>].
        ``cross``: the buffers to write the cross K/V into (:meth:`_cross_kv`).
        """
        B = audio_states.shape[0]
        cache_dtype = {8: torch.int8, 4: PACKED_INT4}.get(kv_bits)
        cache = self.model.empty_cache(B, cache_dtype=cache_dtype, cache_len=cache_len)
        cache["cross"] = self._cross_kv(audio_states, kv_bits, cross_impl, out=cross)
        logits, cache = self.model.decode_step(prompt_tokens, cache, 0)
        layout = self.tokenizer.layout
        # The SOT position as a device index: no read back to the host.
        sot_pos = torch.argmax((prompt_tokens[0] == layout.sot).int()).reshape(1)
        no_speech_prob = torch.softmax(logits.index_select(1, sot_pos)[:, 0], dim=-1)[:, layout.no_speech]
        return logits[:, -1], cache, no_speech_prob

    def _step_fn(self, cross):
        """Step closure over the loop-invariant cross K/V. It holds the model
        by a weak reference: a device loop kept on the model
        (``Whisper.decode_loops``) keeps its step, and a strong one would
        make a cycle, so that a dropped model's card memory waited for the
        garbage collector."""
        model = weakref.ref(self.model)

        def step(tokens, self_cache, pos):
            logits, new_cache = model().decode_step(tokens, {"self": self_cache, "cross": cross}, pos)
            return logits, new_cache["self"]

        return step

    @staticmethod
    def _cache_len(prompt_len: int, opts: SearchOptions) -> int:
        # Self cache sized to the decode horizon, rounded up to 64.
        need = prompt_len + opts.max_new_tokens
        return min(448, -(-need // 64) * 64)

    # ---- the token loop ---------------------------------------------------

    def uses_device_loop(self, opts: SearchOptions) -> bool:
        """Which loop runs a decode. The device loop (one CUDA graph launch
        whose WHILE node tests the exit on the card, ``ops/graph_loop.py``)
        when both of these hold:

        - the model is on a CUDA device;
        - the model is whole (``tp_group is None``): gloo's collectives
          cannot be captured, and NCCL's inside a conditional body are not
          verified.

        Sampled decodes (temperature > 0) run there too: the draw is a
        counter-based function of the step (``search.draw_bits``). Otherwise
        the host loop (``search.run_host_loop``), which drives the same
        step.
        """
        return self.device.type == "cuda" and self.model.tp_group is None

    @staticmethod
    def _loop_options(opts: SearchOptions) -> SearchOptions:
        """The options a device loop is kept under: whether it samples, not
        at which temperature (1.0 stands for every temperature above 0),
        since the temperature is a static input written at each launch."""
        return dataclasses.replace(opts, temperature=float(opts.temperature > 0))

    def _loop_cross(self, key: tuple) -> Optional[list]:
        """The cross K/V buffers of the device loop kept for ``key`` (see
        :meth:`_device_loop`), or None before its first batch."""
        entry = self.model.decode_loops.get(key)
        return None if entry is None else entry[1]

    def _device_loop(self, key: tuple, init_logits, cache, temperature: float = 0.0, generator=None) -> LoopResult:
        """Run the loop of ``key`` = (kind, B, prompt length, options (see
        :meth:`_loop_options`), cross impl) as one graph launch and return
        (tokens, sum_lp, lengths) in new tensors, without reading the card.
        The graph and its static inputs are kept per key on the model (at
        most :data:`MAX_DEVICE_LOOPS`). The first batch's cross K/V become
        the loop's own; later batches write theirs into them
        (``_prompt_cache(cross=self._loop_cross(key))``). Each launch copies
        the batch's init logits and prompt-filled self cache into the loop's
        state, and for a sampling loop its ``temperature`` and the seed of
        ``generator``."""
        kind, B, prompt_len, opts, _ = key
        loops = self.model.decode_loops
        entry = loops.get(key)
        if entry is None:
            cross = cache["cross"]
            K = opts.beam_size if kind == "beam" else 1
            self_cache = [
                {n: buf.new_empty((B * K, *buf.shape[1:])) for n, buf in layer.items()} for layer in cache["self"]
            ]
            V = init_logits.shape[1]
            step_fn = self._step_fn(cross)
            if kind == "beam":
                loop = BeamLoop(step_fn, self_cache, B, V, prompt_len, opts)
            else:
                loop = GreedyLoop(step_fn, self_cache, B, V, prompt_len, opts)
            loop.start(init_logits, cache["self"])  # a real state for the warm-up step
            entry = loops[key] = (loop, cross, DeviceLoop(loop))
            while len(loops) > MAX_DEVICE_LOOPS:
                torch.cuda.current_stream(self.device).synchronize()  # no launch of the dropped graph in flight
                loops.popitem(last=False)[1][2].close()
        elif cache["cross"] is not entry[1]:
            raise ValueError("the batch's cross K/V must be written into the loop's buffers: _prompt_cache(cross=...)")
        loops.move_to_end(key)
        loop, _, graph = entry
        if kind == "beam":
            loop.start(init_logits, cache["self"])
        else:
            loop.start(init_logits, cache["self"], temperature=temperature, generator=generator)
        return loop.result(graph.launch())

    # ---- end-to-end decode --------------------------------------------------

    def _prepare(self, kind: str, mel, prompt_tokens: torch.Tensor, opts: SearchOptions):
        """Encoder and prompt: (init logits, cache, no_speech, key), where
        ``key`` is the device loop's (:meth:`_device_loop`) where
        :meth:`uses_device_loop` holds, else None (the host loop)."""
        cross_impl = self._cross_impl(opts)
        key = None
        if self.uses_device_loop(opts):
            key = (kind, prompt_tokens.shape[0], prompt_tokens.shape[1], self._loop_options(opts), cross_impl)
        init_logits, cache, no_speech = self._prompt_cache(
            self._encode(mel),
            prompt_tokens,
            self._cache_len(prompt_tokens.shape[1], opts),
            kv_bits=self._kv_bits(opts),
            cross_impl=cross_impl,
            cross=None if key is None else self._loop_cross(key),
        )
        return init_logits, cache, no_speech, key

    @torch.inference_mode()
    def decode_greedy(self, mel, prompt_tokens, opts: SearchOptions, generator=None) -> tuple[LoopResult, torch.Tensor]:
        """(B, n_mels, 3000) features + (B, P) prompt → (the loop's greedy
        tokens, sum_lp, lengths; the no-speech probabilities)."""
        prompt_tokens = prompt_tokens.to(self.device)
        init_logits, cache, no_speech, key = self._prepare("greedy", mel, prompt_tokens, opts)
        P = prompt_tokens.shape[1]
        if key is not None:
            out = self._device_loop(key, init_logits, cache, opts.temperature, generator)
        else:
            out = greedy_decode(
                self._step_fn(cache["cross"]), init_logits, cache["self"], P, opts, generator,
                group=self.model.tp_group,
            )
        return out, no_speech

    @torch.inference_mode()
    def decode_beam(self, mel, prompt_tokens, opts: SearchOptions) -> tuple[LoopResult, torch.Tensor]:
        """(B, n_mels, 3000) features + (B, P) prompt → (the loop's
        beam-searched tokens, sum_lp, lengths; the no-speech probabilities)."""
        K = opts.beam_size
        prompt_tokens = prompt_tokens.to(self.device)
        init_logits, cache, no_speech, key = self._prepare("beam", mel, prompt_tokens, opts)
        P = prompt_tokens.shape[1]
        if key is not None:
            out = self._device_loop(key, init_logits, cache)
        else:
            # Replicate only the prompt-filled self cache per beam: (B, ...)
            # → (B*K, ...). Cross K/V stay per batch element.
            expanded = [{n: buf.repeat_interleave(K, dim=0) for n, buf in layer.items()} for layer in cache["self"]]
            out = beam_decode(
                self._step_fn(cache["cross"]), init_logits, expanded, P, opts, group=self.model.tp_group,
            )
        return out, no_speech

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
        rows = torch.tensor(prompt, dtype=torch.long)[None, :].repeat(batch, 1)
        if self.device.type == "cuda":
            # From pinned memory without blocking: a copy from pageable
            # memory would wait for the loop of the batch still in flight.
            return rows.pin_memory().to(self.device, non_blocking=True)
        return rows.to(self.device)

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
        copy to the host (and the wait for the loop) happens on the first
        read, so the caller can prepare and launch the next batch first.
        With the device loop (:meth:`uses_device_loop`) nothing is read back
        before that: the call returns once the loop is enqueued."""
        opts = options or self.build_options()
        prompt = self.build_prompt(
            mel.shape[0], initial_prompt=initial_prompt, prefix_tokens=self.prefix_tokens(prefix)
        )
        if opts.beam_size > 1 and opts.temperature == 0.0:
            out, no_speech = self.decode_beam(mel, prompt, opts)
        else:
            out, no_speech = self.decode_greedy(mel, prompt, opts, generator)
        tokens, sum_lp, lengths = out
        # One buffer for the per-row scalars: one copy to the host later.
        stats = torch.stack([sum_lp.float(), lengths.float(), no_speech.float(), out.steps.expand_as(sum_lp)])
        result = DecodeResult(tokens.to(torch.int32), stats, out.span)
        return result.fetch() if sync else result

    def decode_text(self, result: DecodeResult) -> list[str]:
        return self.tokenizer.decode_batch([row.tolist() for row in np.asarray(result.tokens)])
