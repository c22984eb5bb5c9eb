"""The ASR pipeline: VAD cut & merge → batched transcription on the card.

Port of ``whisperx_tpu/pipeline/asr.py`` (reference pipeline:
whisperx/asr.py:88-357): the same ``load_model(...)`` surface, the same
``transcribe(audio, batch_size, ...)`` contract returning ``{"segments":
[{text, start, end}], "language"}``, the same lazy per-language tokenizer,
numeral suppression, VAD onset/offset defaults and opt-in temperature
fallback.

As in the JAX package, chunks are packed into fixed-size batches (the last
one zero-padded, its padding rows discarded), each batch is uploaded as int16
PCM and turned into log-mel features on the device, and one batch is kept in
flight while the host detokenizes the one before.

Differences: the weights live in the model, so the pipeline takes no
parameter tree, and a ``device`` argument says where it runs. ``mesh`` is
a ``parallel.make_mesh`` mesh over ``torch.distributed`` ranks, one process
per device: the model holds this rank's slice of the weights
(``whisper_from_jax(..., mesh=)``), every batch pads to a multiple of the
"data" axis, each rank decodes its own rows, and the rows are gathered back
so that every rank returns the whole transcript. ``load_model``'s
``mesh="auto"`` means no mesh: in the JAX package it builds one over the
devices of the process, and a process here drives one device; a mesh over
ranks is always explicit (the CLI shards its files over ranks and runs each
rank without one).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, replace
from typing import Any, List, Optional, Sequence, Union

import numpy as np
import torch

from ..audio.constants import N_SAMPLES, SAMPLE_RATE
from ..audio.io import load_audio, pad_or_trim, pcm16
from ..audio.mel import log_mel_spectrogram
from ..decode.engine import WhisperEngine
from ..decode.search import SearchOptions
from ..decode.tokenizer import WhisperTokenizer
from ..device import DeviceLike, resolve_device
from ..io.types import SingleSegment, TranscriptionResult
from ..ops import flash_attn
from ..parallel.mesh import axis_index, axis_size, mesh_device, shard_batch
from ..utils import telemetry
from ..utils.telemetry import PipelineTelemetry
from ..vad.model import EnergyVAD, VadPipeline, load_vad_model


@dataclass
class TranscriptionOptions:
    """Reference-compatible decode options (whisperx/asr.py:300-326 defaults).

    The batched path honors beam_size/patience/length_penalty/suppression and
    max_new_tokens. The temperature/threshold/best_of fields drive the
    opt-in quality gate (``enable_fallback``): failed chunks re-decode at the
    next temperature with ``best_of`` sampled candidates each, best avg
    logprob wins. The reference's batched path parses all of these but never
    implements them (whisperx/asr.py:53-62 does a single beam pass).
    """

    beam_size: int = 5
    best_of: int = 5
    patience: float = 1.0
    length_penalty: float = 1.0
    repetition_penalty: float = 1.0
    no_repeat_ngram_size: int = 0
    temperatures: Sequence[float] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
    compression_ratio_threshold: Optional[float] = 2.4
    log_prob_threshold: Optional[float] = -1.0
    no_speech_threshold: Optional[float] = 0.6
    condition_on_previous_text: bool = False
    prompt_reset_on_temperature: float = 0.5
    initial_prompt: Optional[str] = None
    prefix: Optional[str] = None
    suppress_blank: bool = True
    suppress_tokens: Sequence[int] = (-1,)
    without_timestamps: bool = True
    max_initial_timestamp: float = 0.0
    word_timestamps: bool = False
    prepend_punctuations: str = "\"'“¿([{-"
    append_punctuations: str = "\"'.。,，!！?？:：”)]}、"
    max_new_tokens: Optional[int] = None
    clip_timestamps: Optional[str] = None
    hallucination_silence_threshold: Optional[float] = None
    # With enable_fallback=True the pipeline implements the whisper-style
    # quality gate: failed chunks are re-decoded at the next temperature,
    # batched; silent chunks (<|nospeech|> + low logprob) are dropped.
    # Default False for reference-parity output.
    enable_fallback: bool = False


class WhisperPipeline:
    """End-to-end transcriber bound to one Whisper model + VAD scorer."""

    def __init__(
        self,
        engine: WhisperEngine,
        vad: VadPipeline,
        vad_params: dict,
        options: TranscriptionOptions,
        tokenizer: Optional[WhisperTokenizer] = None,
        language: Optional[str] = None,
        suppress_numerals: bool = False,
        mesh: Any = None,
        kv_cache_dtype: str = "model",
    ):
        if mesh is not None and axis_size(mesh, "model") > 1 and engine.model.mesh is not mesh:
            raise ValueError("a mesh with a model axis needs the model built for it: whisper_from_jax(..., mesh=mesh)")
        self.engine = engine
        self.vad_model = vad
        self._vad_params = vad_params
        self.options = options
        self.tokenizer = tokenizer
        self.preset_language = language
        self.suppress_numerals = suppress_numerals
        # "model" keeps decode KV in the compute dtype; "int8" quantizes the
        # cache (load_model pairs it with int8 weights).
        self.kv_cache_dtype = kv_cache_dtype
        self.model = engine.model
        self.mesh = mesh
        self.telemetry = PipelineTelemetry()

    @property
    def device(self) -> torch.device:
        return self.engine.device

    def _data_granule(self) -> int:
        return axis_size(self.mesh, "data") if self.mesh is not None else 1

    def _generator(self, seed: int) -> torch.Generator:
        """A generator on the model's device for one sampled decode, seeded
        with the integer the JAX package gives ``jax.random.PRNGKey``. Under
        a mesh whose data axis has 2 or more ranks, the rank's data
        coordinate is folded in (``hash((seed, coordinate))``): each data
        rank draws its own rows, as the JAX package's one key over the
        global batch does, while the ranks of one model group, which share
        the coordinate, draw the same tokens. Without such a mesh the seed
        is used as it is."""
        if self._data_granule() > 1:
            seed = hash((seed, axis_index(self.mesh, "data"))) & 0x7FFFFFFF
        return torch.Generator(device=self.device).manual_seed(seed)

    def _gathered(self, result):
        """A batch's result with every data rank's rows (``DecodeResult.
        gathered``); the result itself without a mesh."""
        return result if self.mesh is None else result.gathered(self.mesh)

    # -- helpers -------------------------------------------------------------

    def _make_tokenizer(self, language: str, task: str) -> WhisperTokenizer:
        base = self.engine.tokenizer  # carries the text backend
        return WhisperTokenizer(
            base.backend,
            base.layout.n_vocab,
            base.layout.num_languages,
            language=language,
            task=task,
        )

    def _search_options(self, tokenizer: WhisperTokenizer) -> tuple[SearchOptions, WhisperEngine]:
        opts = self.options
        # A knob that quietly does nothing is worse than one that raises.
        # These two are accepted-but-unused by the reference's batched path
        # too (whisperx/asr.py:53-62 never passes them to CT2.generate).
        if opts.repetition_penalty != 1.0:
            raise NotImplementedError(
                "repetition_penalty is not implemented in the batched decode "
                "path (the reference's batched path ignores it too); leave it "
                "at 1.0"
            )
        if opts.no_repeat_ngram_size:
            raise NotImplementedError(
                "no_repeat_ngram_size is not implemented in the batched decode "
                "path (the reference's batched path ignores it too); leave it "
                "at 0"
            )
        suppress = list(opts.suppress_tokens)
        if self.suppress_numerals:
            print("Suppressing numeral and symbol tokens")
            suppress = sorted(set(list(suppress) + list(numeral_symbol_tokens(tokenizer))))
        engine = WhisperEngine(self.engine.model, tokenizer)
        return engine.build_options(
            beam_size=opts.beam_size,
            patience=opts.patience,
            length_penalty=opts.length_penalty,
            temperature=float(opts.temperatures[0]) if opts.temperatures else 0.0,
            max_new_tokens=opts.max_new_tokens,
            suppress_tokens=suppress,
            suppress_blank=opts.suppress_blank,
            without_timestamps=opts.without_timestamps,
            kv_cache_dtype=self.kv_cache_dtype,
        ), engine

    def _mel(self, wavs: np.ndarray) -> torch.Tensor:
        """(B, N) host waveforms → (B, n_mels, 3000) features in the model's
        dtype, computed on the model's device: this rank's rows under a mesh.
        The upload goes through pinned memory without blocking the host;
        int16 PCM is divided by 32768 on the device."""
        if self.mesh is not None:
            t = shard_batch(self.mesh, wavs)
        else:
            t = torch.from_numpy(wavs)
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
        mel = log_mel_spectrogram(t, n_mels=self.engine.config.n_mels, device=self.device)
        return mel.to(self.model.dtype)

    @staticmethod
    def _wave_batches(audio: np.ndarray, chunks: List[dict], batch_size: int):
        """Yield (waveforms (batch_size, N_SAMPLES), n_valid) fixed-shape
        host batches of the chunks, zero-padded.

        ``audio`` may be float32 or int16 PCM (see ``_device_audio``): the
        waveform batch is uploaded in the audio's dtype.
        """
        for i in range(0, len(chunks), batch_size):
            batch = chunks[i : i + batch_size]
            wavs = np.zeros((batch_size, N_SAMPLES), audio.dtype)
            for row, seg in enumerate(batch):
                f1 = int(seg["start"] * SAMPLE_RATE)
                f2 = int(seg["end"] * SAMPLE_RATE)
                clip = audio[f1:f2][:N_SAMPLES]
                wavs[row, : len(clip)] = clip
            yield wavs, len(batch)

    def _feature_batches(self, audio: np.ndarray, chunks: List[dict], batch_size: int):
        """Yield (mel_batch (B, n_mels, 3000), n_valid) fixed-shape batches
        (this rank's B / n_data rows under a mesh) of :meth:`_wave_batches`."""
        for wavs, n_valid in self._wave_batches(audio, chunks, batch_size):
            yield self._mel(wavs), n_valid

    # -- public API ------------------------------------------------------------

    def transcribe(
        self,
        audio: Union[str, np.ndarray],
        batch_size: Optional[int] = None,
        num_workers: int = 0,
        language: Optional[str] = None,
        task: Optional[str] = None,
        chunk_size: int = 30,
        print_progress: bool = False,
        combined_progress: bool = False,
        verbose: bool = False,
    ) -> TranscriptionResult:
        """The request's root telemetry span is ``transcribe`` (count
        ``audio_s``): under it the stages ``vad`` (holding ``vad.band``, the
        device span of the scorer's band-pass, where that runs on the card)
        and ``asr_decode``, and in ``asr_decode`` one ``asr.batch`` per
        decode batch (counts ``rows``, ``rows_valid``) holding
        ``asr.prepare`` (device: upload, log-mel,
        encoder, cross K/V and prompt, up to the loop's launch; counts
        ``flash_launches``, the encoder's flash kernel launches),
        ``decode.loop``, ``asr.fetch`` (the host's wait for the batch's
        result) and ``asr.detokenize``."""
        with telemetry.span("transcribe", root=True) as root:
            return self._transcribe(audio, batch_size, language, task, chunk_size, print_progress,
                                    combined_progress, verbose, root)

    def _transcribe(self, audio, batch_size, language, task, chunk_size, print_progress, combined_progress, verbose,
                    root) -> TranscriptionResult:
        if isinstance(audio, str):
            audio = load_audio(audio)
        audio = np.asarray(audio, dtype=np.float32).reshape(-1)
        batch_size = batch_size or 8
        # Batch rows must tile the mesh's data axis exactly (fixed shapes).
        granule = self._data_granule()
        batch_size = -(-batch_size // granule) * granule
        total_audio = len(audio) / SAMPLE_RATE
        root.counts["audio_s"] = total_audio

        with self.telemetry.stage("vad", audio_seconds=total_audio):
            vad_segments = self.vad_model(audio, chunk_size=chunk_size)

        # Device uploads in int16 PCM (half the bytes; exact for
        # s16le-decoded audio). WHISPERX_WAV_INT16=0 keeps float32 uploads.
        audio_dev = _device_audio(audio)

        # Lazy tokenizer (re)build — reference semantics (asr.py:193-205).
        if self.tokenizer is None:
            language = language or self.detect_language(audio)
            task = task or "transcribe"
            self.tokenizer = self._make_tokenizer(language, task)
        else:
            language = language or self.tokenizer.language
            task = task or self.tokenizer.task
            if task != self.tokenizer.task or language != self.tokenizer.language:
                self.tokenizer = self._make_tokenizer(language, task)

        search_opts, engine = self._search_options(self.tokenizer)

        total = len(vad_segments)
        texts: List[str] = [""] * total
        avg_lps = np.zeros(total)
        no_speech = np.zeros(total)
        done = 0

        def consume(result, n_valid, at, batch):
            with telemetry.within(batch):
                with telemetry.span("asr.fetch"):
                    result.fetch()  # the first host read of the device tensors waits here
                with telemetry.span("asr.detokenize"):
                    batch_texts = engine.decode_text(result)[:n_valid]
                    avg = np.asarray(result.avg_logprobs)
                    nsp = result.no_speech_probs
                    for j, text in enumerate(batch_texts):
                        texts[at + j] = text
                        avg_lps[at + j] = avg[j]
                        if nsp is not None:
                            no_speech[at + j] = float(nsp[j])
            telemetry.end(batch)
            if print_progress:
                pct = ((at + n_valid) / total) * 100
                print(f"Progress: {(pct / 2 if combined_progress else pct):.2f}%...")

        # One batch kept in flight: batch i+1 (upload, mel front end, decode)
        # is launched before batch i's tokens are read back, so host-side
        # detokenization and chunk prep overlap device work — the replacement
        # for the reference's DataLoader worker overlap (whisperx/asr.py:158-171).
        # Under a mesh each batch's rows are gathered from the data axis as
        # soon as it is launched, in the same order on every rank.
        total_audio_s = sum(s["end"] - s["start"] for s in vad_segments)
        with self.telemetry.stage("asr_decode", audio_seconds=total_audio_s):
            in_flight = None
            for wavs, n_valid in self._wave_batches(audio_dev, vad_segments, batch_size):
                batch = telemetry.begin("asr.batch", rows=batch_size, rows_valid=n_valid)
                with telemetry.within(batch):
                    flash0 = flash_attn.launches
                    prepare = telemetry.begin("asr.prepare", device=self.device)
                    # A sampled first pass draws as the JAX package's PRNGKey(0) does
                    # (whisperx_tpu/decode/search.py:greedy_decode): the same seed
                    # for every batch and every call.
                    result = self._gathered(engine.generate(
                        self._mel(wavs), options=search_opts,
                        initial_prompt=self.options.initial_prompt,
                        prefix=self.options.prefix,
                        generator=self._generator(0) if search_opts.temperature > 0 else None,
                        sync=False,
                    ))
                    telemetry.end(prepare, at=result.loop_span)  # where the loop begins
                    prepare.counts["flash_launches"] = flash_attn.launches - flash0
                if in_flight is not None:
                    consume(*in_flight)
                    done += in_flight[1]
                in_flight = (result, n_valid, done, batch)
            if in_flight is not None:
                consume(*in_flight)
                done += in_flight[1]

        if self.options.enable_fallback:
            texts = self._temperature_fallback(
                engine, search_opts, audio_dev, vad_segments, texts, avg_lps, no_speech, batch_size
            )

        segments: List[SingleSegment] = []
        for idx, seg in enumerate(vad_segments):
            if verbose:
                print(
                    f"Transcript: [{seg['start']:.3f} --> {seg['end']:.3f}] {texts[idx].strip()}"
                )
            segments.append(
                {
                    "text": texts[idx],
                    "start": round(seg["start"], 3),
                    "end": round(seg["end"], 3),
                }
            )

        # Multilingual mode: drop the tokenizer so the next file re-detects.
        if self.preset_language is None:
            self.tokenizer = None

        return {"segments": segments, "language": language}

    def _temperature_fallback(
        self, engine, search_opts, audio, vad_segments, texts, avg_lps, no_speech, batch_size
    ):
        """Whisper-style quality gate over the batched results.

        Chunks failing the compression-ratio or avg-logprob thresholds are
        re-decoded at the next temperature with ``best_of`` independent
        sampled candidates per chunk — drawn as ONE widened batch, not a loop
        — keeping the candidate with the highest avg logprob. Chunks flagged
        silent (<|nospeech|> prob above threshold AND low logprob) end up
        with empty text. Each retry batch samples from a ``torch.Generator``
        on the model's device, seeded with the integer the JAX package gives
        ``jax.random.PRNGKey`` (:meth:`_generator`: under a mesh the data
        coordinate is folded in, so that copies of a chunk on different data
        ranks stay independent samples); the samples themselves differ from
        JAX's.
        """
        from ..utils import compression_ratio

        opts = self.options
        cr_thr = opts.compression_ratio_threshold
        lp_thr = opts.log_prob_threshold
        ns_thr = opts.no_speech_threshold
        n_cand = max(1, int(opts.best_of or 1))

        def failed(idx: int) -> bool:
            if cr_thr is not None and texts[idx].strip() and compression_ratio(texts[idx]) > cr_thr:
                return True
            if lp_thr is not None and avg_lps[idx] < lp_thr:
                return True
            return False

        pending = [i for i in range(len(texts)) if failed(i)]
        temperatures = [t for t in opts.temperatures if t > 0]
        for t_i, temp in enumerate(temperatures):
            if not pending:
                break
            fb_opts = dataclasses.replace(search_opts, beam_size=1, temperature=float(temp))
            # Each failed chunk appears best_of times in the retry batch;
            # rows sample independently, so the replicated rows are distinct
            # samples of the same chunk.
            retry_segments = [vad_segments[i] for i in pending for _ in range(n_cand)]
            new_texts: List[str] = []
            new_lps: List[float] = []
            done = 0
            for mel, n_valid in self._feature_batches(audio, retry_segments, batch_size):
                result = self._gathered(engine.generate(
                    mel, options=fb_opts,
                    initial_prompt=opts.initial_prompt,
                    prefix=opts.prefix,
                    generator=self._generator(hash((t_i, done)) & 0x7FFFFFFF),
                    sync=False,
                ))
                new_texts.extend(engine.decode_text(result)[:n_valid])
                new_lps.extend(result.avg_logprobs[:n_valid].tolist())
                done += n_valid
            for row, idx in enumerate(pending):
                lo = row * n_cand
                best = lo + int(np.argmax(new_lps[lo : lo + n_cand]))
                texts[idx] = new_texts[best]
                avg_lps[idx] = new_lps[best]
            pending = [i for i in pending if failed(i)]

        # Silence gate: no-speech prob high AND decode confidence low → empty.
        if ns_thr is not None and lp_thr is not None:
            for i in range(len(texts)):
                if no_speech[i] > ns_thr and avg_lps[i] < lp_thr:
                    texts[i] = ""
        return texts

    def detect_language(self, audio: np.ndarray) -> str:
        if audio.shape[0] < N_SAMPLES:
            print("Warning: audio is shorter than 30s, language detection may be inaccurate.")
        clip = pad_or_trim(_device_audio(np.asarray(audio, np.float32))[:N_SAMPLES])
        # Tile the single clip over the mesh's data axis: every rank detects
        # on the same clip.
        mel = self._mel(np.ascontiguousarray(np.tile(clip[None], (self._data_granule(), 1))))
        (language, prob) = self.engine.detect_language(mel)[0]
        print(f"Detected language: {language} ({prob:.2f}) in first 30s of audio...")
        return language


def _device_audio(audio: np.ndarray) -> np.ndarray:
    """Waveform as uploaded to the device: int16 PCM by default.

    Halves the host→device bytes of every chunk batch; bit-exact for
    s16le-decoded audio (the reference's own decode contract,
    whisperx/audio.py:44-61). WHISPERX_WAV_INT16=0 restores float32 uploads.
    """
    if os.environ.get("WHISPERX_WAV_INT16", "1") == "1":
        return pcm16(audio)
    return audio


def numeral_symbol_tokens(tokenizer: WhisperTokenizer) -> list[int]:
    """Token ids containing digits or currency symbols (asr.py:16-23 parity)."""
    out = []
    for i in range(tokenizer.eot):
        piece = tokenizer.backend.id_to_piece(i)
        if piece and any(c in "0123456789%$£" for c in piece):
            out.append(i)
    return out


_COMPUTE_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.bfloat16,  # fp16 requests map to bf16, as in the JAX package
    "int8": torch.bfloat16,
    "int4": torch.bfloat16,
    "float32": torch.float32,
    "default": torch.bfloat16,
}


def load_model(
    whisper_arch: str,
    device: DeviceLike = None,
    device_index: int = 0,
    compute_type: str = "bfloat16",
    asr_options: Optional[dict] = None,
    language: Optional[str] = None,
    vad_model: Optional[VadPipeline] = None,
    vad_options: Optional[dict] = None,
    model: Optional[Any] = None,
    task: str = "transcribe",
    download_root: Optional[str] = None,
    threads: int = 0,
    checkpoint: Optional[str] = None,
    vad_checkpoint: Optional[str] = None,
    mesh: Any = "auto",
    kv_cache_dtype: str = "auto",
) -> WhisperPipeline:
    """Build the transcription pipeline (reference load_model API, asr.py:259).

    ``whisper_arch`` may be a size name ("large-v2") resolved against the
    local HF cache / ``download_root``, or ``checkpoint`` may point directly
    at a local HF checkpoint directory. ``compute_type`` maps to the compute
    dtype (bf16 by default, "float16" maps to bf16, "float32" is fp32);
    "int8" quantizes every projection weight-only (per output channel) on
    top of bf16, and "int4" does so at 4 bits (kernels packed two to a
    byte; the token embedding stays int8). ``kv_cache_dtype``: "auto" (int8
    for int8 and int4 weights, the model's dtype otherwise), "model",
    "int8" or "int4". ``device=None`` means the card (``cuda:<device_index>``);
    pass ``device="cpu"`` for the plain PyTorch versions. ``mesh``: a
    ``parallel.make_mesh`` mesh to run data/tensor-parallel over (on its
    rank's device; every rank calls ``load_model``), or "auto", which means
    None here (module docstring). ``model`` and
    ``threads`` are accepted for reference API parity and unused, as in the
    JAX package.
    """
    from ..models.convert import read_whisper, resolve_checkpoint_dir, whisper_from_jax
    from ..models.whisper import fuse_qkv_params, quantize_params

    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f"mesh={mesh!r}: expected a mesh, None or 'auto'")
        mesh = None
    if mesh is not None:
        dev = mesh_device(mesh)
    else:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", device_index)

    if whisper_arch.endswith(".en"):
        language = "en"
    dtype = _COMPUTE_DTYPES.get(compute_type, torch.bfloat16)

    path = checkpoint
    if path is None:
        for candidate in (
            whisper_arch,
            f"openai/whisper-{whisper_arch}",
            f"distil-whisper/{whisper_arch}",
        ):
            try:
                path = resolve_checkpoint_dir(candidate, download_root)
                break
            except FileNotFoundError:
                continue
    if path is None:
        raise FileNotFoundError(
            f"No local checkpoint for {whisper_arch!r}. Place an HF whisper "
            "checkpoint dir on disk and pass checkpoint=<dir> (offline loader)."
        )

    params, config = read_whisper(path, dtype=dtype)
    bits = 4 if compute_type == "int4" else 8
    if compute_type in ("int8", "int4"):
        # Weight-only int8/int4 (per-output-channel scales): the analogue of
        # the reference's CT2 compute_type="int8" (whisperx/asr.py:262,288).
        params = quantize_params(params, bits=bits)
    # Fuse q/k/v into one projection for the per-token decode path (the JAX
    # package's on-chip A/B winner); opt out with WHISPERX_FUSED_QKV=0.
    # Skipped under a model axis (the partition rules target the unfused
    # layout).
    tp_size = axis_size(mesh, "model") if mesh is not None else 1
    if os.environ.get("WHISPERX_FUSED_QKV", "1") != "0" and tp_size == 1:
        params = fuse_qkv_params(params)
    whisper_model = whisper_from_jax(params, config, dtype=dtype, quant_bits=bits, device=dev, mesh=mesh)
    del params
    tokenizer_backend = WhisperTokenizer.from_pretrained(path, language=language, task=task)
    engine = WhisperEngine(whisper_model, tokenizer_backend)

    tokenizer = None
    if language is not None:
        tokenizer = WhisperTokenizer(
            tokenizer_backend.backend,
            config.n_vocab,
            config.num_languages,
            language=language,
            task=task,
        )

    default_asr = TranscriptionOptions()
    suppress_numerals = False
    if asr_options:
        asr_options = dict(asr_options)
        suppress_numerals = asr_options.pop("suppress_numerals", False)
        default_asr = replace(default_asr, **asr_options)

    default_vad_options = {"vad_onset": 0.500, "vad_offset": 0.363}
    if vad_options:
        default_vad_options.update(vad_options)
    if vad_model is None:
        vad_model = load_vad_model(dev, checkpoint=vad_checkpoint, **default_vad_options)

    if kv_cache_dtype == "auto":
        # Quantized weights pair with the int8 KV cache (the JAX package's
        # flagship default); full-precision weights keep the model-dtype cache.
        kv_cache_dtype = "int8" if compute_type in ("int8", "int4") else "model"
    return WhisperPipeline(
        engine=engine,
        vad=vad_model,
        vad_params=default_vad_options,
        options=default_asr,
        tokenizer=tokenizer,
        language=language,
        suppress_numerals=suppress_numerals,
        mesh=mesh,
        kv_cache_dtype=kv_cache_dtype,
    )


def load_test_pipeline(
    *,
    language: Optional[str] = "en",
    seed: int = 0,
    beam_size: int = 1,
    config=None,
    device: DeviceLike = None,
    mesh: Any = None,
) -> WhisperPipeline:
    """Random-weight pipeline on the miniature config (tests/benchmarks).

    The weights equal the JAX package's ``load_test_pipeline(seed=seed)``
    (``models/whisper.py:random_params``); fp32; ``device=None`` means the
    card (the rank's device under a ``mesh``)."""
    from ..models.configs import TEST_CONFIG
    from ..models.convert import whisper_from_jax
    from ..models.whisper import random_params

    cfg = config or TEST_CONFIG
    model = whisper_from_jax(random_params(cfg, seed=seed), cfg, device=device, mesh=mesh)
    backend_tok = WhisperTokenizer.dummy(cfg.n_vocab, language=language or "en")
    engine = WhisperEngine(model, backend_tok)
    tokenizer = WhisperTokenizer.dummy(cfg.n_vocab, language=language) if language else None
    return WhisperPipeline(
        engine=engine,
        vad=VadPipeline(EnergyVAD()),
        vad_params={"vad_onset": 0.5, "vad_offset": 0.363},
        options=TranscriptionOptions(beam_size=beam_size, max_new_tokens=8),
        tokenizer=tokenizer,
        language=language,
        mesh=mesh,
    )
