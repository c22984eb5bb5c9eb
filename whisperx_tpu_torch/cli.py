"""Command-line entry point.

Port of ``whisperx_tpu/cli.py``: ``python -m whisperx_tpu_torch <audio> ...``
(or the ``whisperx-tpu-torch`` console script) runs on the card unless
``--device cpu`` is given. The argparse flag table is a compatibility
contract with the reference CLI (whisperx/transcribe.py:19-79): same flag
names, defaults and help text, so ``--help`` and existing invocations
behave identically. The orchestration below it is the JAX package's: flags
resolve into one typed ``CliConfig``, and four small stage functions
(transcribe / align / diarize / write) fold over a list of ``FileJob``
records. Behavioral quirks of the reference that downstream output depends
on are kept and marked inline.

Under ``torchrun --nproc-per-node N python -m whisperx_tpu_torch ...`` (or
the JAX package's ``COORDINATOR_ADDRESS``/``NUM_PROCESSES``/``PROCESS_ID``)
each rank takes its round-robin share of the files
(``parallel/distributed.py:shard_files``) and runs them on its own card
(``cuda:<LOCAL_RANK>``, whatever ``--device_index`` says) with no mesh, as
the JAX CLI shards its files over processes.
"""

from __future__ import annotations

import argparse
import gc
import os
import warnings
from dataclasses import dataclass, field, replace
from typing import List, Optional

import numpy as np
import torch.distributed as dist

from .align.alignment import align_begin, load_align_model
from .audio.io import AudioPrefetcher
from .diarize.assign import assign_word_speakers
from .diarize.pipeline import DiarizationPipeline
from .io.languages import LANGUAGES, TO_LANGUAGE_CODE
from .io.writers import get_writer
from .parallel.distributed import initialize, local_device, shard_files, world_size
from .pipeline.asr import load_model
from .utils import optional_float, optional_int, str2bool


def build_parser() -> argparse.ArgumentParser:
    # fmt: off
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("audio", nargs="+", type=str, help="audio file(s) to transcribe")
    parser.add_argument("--model", default="small", help="name of the Whisper model to use")
    parser.add_argument("--model_dir", type=str, default=None, help="the path to look up model checkpoints (local HF cache layout)")
    parser.add_argument("--checkpoint", type=str, default=None, help="path to a local HF whisper checkpoint directory (offline)")
    parser.add_argument("--device", default="cuda", help="device to use for inference (cuda/cpu)")
    parser.add_argument("--device_index", default=0, type=int, help="device index to use for inference")
    parser.add_argument("--batch_size", default=8, type=int, help="the preferred batch size for inference")
    parser.add_argument("--compute_type", default="bfloat16", type=str, choices=["float16", "bfloat16", "float32", "int8"], help="compute type (float16 maps to bfloat16; int8 is int8 weights on bfloat16)")

    parser.add_argument("--output_dir", "-o", type=str, default=".", help="directory to save the outputs")
    parser.add_argument("--output_format", "-f", type=str, default="all", choices=["all", "srt", "vtt", "txt", "tsv", "json", "aud"], help="format of the output file; if not specified, all available formats will be produced")
    parser.add_argument("--verbose", type=str2bool, default=True, help="whether to print out the progress and debug messages")

    parser.add_argument("--task", type=str, default="transcribe", choices=["transcribe", "translate"], help="whether to perform X->X speech recognition ('transcribe') or X->English translation ('translate')")
    parser.add_argument("--language", type=str, default=None, choices=sorted(LANGUAGES.keys()) + sorted([k.title() for k in TO_LANGUAGE_CODE.keys()]), help="language spoken in the audio, specify None to perform language detection")

    # alignment params
    parser.add_argument("--align_model", default=None, help="Name of phoneme-level ASR model to do alignment")
    parser.add_argument("--interpolate_method", default="nearest", choices=["nearest", "linear", "ignore"], help="For word .srt, method to assign timestamps to non-aligned words, or merge them into neighbouring.")
    parser.add_argument("--no_align", action="store_true", help="Do not perform phoneme alignment")
    parser.add_argument("--return_char_alignments", action="store_true", help="Return character-level alignments in the output json file")

    # vad params
    parser.add_argument("--vad_onset", type=float, default=0.500, help="Onset threshold for VAD, reduce this if speech is not being detected")
    parser.add_argument("--vad_offset", type=float, default=0.363, help="Offset threshold for VAD, reduce this if speech is not being detected.")
    parser.add_argument("--vad_checkpoint", type=str, default=None, help="path to the pinned pyannote segmentation checkpoint for neural VAD (energy VAD is used if absent)")
    parser.add_argument("--chunk_size", type=int, default=30, help="Chunk size for merging VAD segments. Default is 30, reduce this if the chunk is too long.")

    # diarization params
    parser.add_argument("--diarize", action="store_true", help="Apply diarization to assign speaker labels to each segment/word")
    parser.add_argument("--min_speakers", default=None, type=int, help="Minimum number of speakers to in audio file")
    parser.add_argument("--max_speakers", default=None, type=int, help="Maximum number of speakers to in audio file")
    parser.add_argument("--diarize_checkpoint", type=str, default=None, help="path to a local WeSpeaker ResNet34 speaker-embedding checkpoint for neural diarization")
    parser.add_argument("--segmentation_checkpoint", type=str, default=None, help="path to the pinned pyannote segmentation checkpoint; enables overlap-aware diarization (local speaker activities, simultaneous speakers). Defaults to --vad_checkpoint when that is set.")
    parser.add_argument("--diarize_clustering_threshold", type=float, default=0.7, help="agglomerative cosine-distance threshold for speaker clustering when the speaker count is unknown")

    parser.add_argument("--temperature", type=float, default=0, help="temperature to use for sampling")
    parser.add_argument("--best_of", type=optional_int, default=5, help="number of candidates when sampling with non-zero temperature")
    parser.add_argument("--beam_size", type=optional_int, default=5, help="number of beams in beam search, only applicable when temperature is zero")
    parser.add_argument("--patience", type=float, default=1.0, help="optional patience value to use in beam decoding, as in https://arxiv.org/abs/2204.05424, the default (1.0) is equivalent to conventional beam search")
    parser.add_argument("--length_penalty", type=float, default=1.0, help="optional token length penalty coefficient (alpha) as in https://arxiv.org/abs/1609.08144, uses simple length normalization by default")

    parser.add_argument("--suppress_tokens", type=str, default="-1", help="comma-separated list of token ids to suppress during sampling; '-1' will suppress most special characters except common punctuations")
    parser.add_argument("--suppress_numerals", action="store_true", help="whether to suppress numeric symbols and currency symbols during sampling, since wav2vec2 cannot align them correctly")

    parser.add_argument("--initial_prompt", type=str, default=None, help="optional text to provide as a prompt for the first window.")
    parser.add_argument("--condition_on_previous_text", type=str2bool, default=False, help="if True, provide the previous output of the model as a prompt for the next window")
    parser.add_argument("--fp16", type=str2bool, default=True, help="accepted for compatibility; --compute_type sets the precision")

    parser.add_argument("--temperature_increment_on_fallback", type=optional_float, default=0.2, help="temperature to increase when falling back when the decoding fails to meet either of the thresholds below")
    parser.add_argument("--compression_ratio_threshold", type=optional_float, default=2.4, help="if the gzip compression ratio is higher than this value, treat the decoding as failed")
    parser.add_argument("--logprob_threshold", type=optional_float, default=-1.0, help="if the average log probability is lower than this value, treat the decoding as failed")
    parser.add_argument("--no_speech_threshold", type=optional_float, default=0.6, help="if the probability of the <|nospeech|> token is higher than this value AND the decoding has failed due to `logprob_threshold`, consider the segment as silence")

    parser.add_argument("--max_line_width", type=optional_int, default=None, help="(not possible with --no_align) the maximum number of characters in a line before breaking the line")
    parser.add_argument("--max_line_count", type=optional_int, default=None, help="(not possible with --no_align) the maximum number of lines in a segment")
    parser.add_argument("--highlight_words", type=str2bool, default=False, help="(not possible with --no_align) underline each word as it is spoken in srt and vtt")
    parser.add_argument("--segment_resolution", type=str, default="sentence", choices=["sentence", "chunk"], help="(not possible with --no_align) the maximum number of characters in a line before breaking the line")

    parser.add_argument("--threads", type=optional_int, default=0, help="number of host threads for CPU inference")

    parser.add_argument("--hf_token", type=str, default=None, help="Hugging Face Access Token (compat; loading is offline/cache-based)")

    parser.add_argument("--print_progress", type=str2bool, default=False, help="if True, progress will be printed in transcribe() and align() methods.")
    # fmt: on
    return parser


# ---------------------------------------------------------------------------
# config resolution
# ---------------------------------------------------------------------------


@dataclass
class CliConfig:
    """Everything the stage functions need, resolved and typed once."""

    files: List[str]
    model_name: str
    checkpoint: Optional[str]
    model_dir: Optional[str]
    device: str
    device_index: int
    compute_type: str
    batch_size: int
    task: str
    language: Optional[str]  # validated code or None (detect per file)
    align_language: str  # language the align model is loaded for
    verbose: bool
    print_progress: bool
    threads: int
    chunk_size: int
    asr_options: dict = field(default_factory=dict)
    vad_options: dict = field(default_factory=dict)
    vad_checkpoint: Optional[str] = None
    # alignment
    do_align: bool = True
    align_model_name: Optional[str] = None
    interpolate_method: str = "nearest"
    return_char_alignments: bool = False
    # diarization
    do_diarize: bool = False
    min_speakers: Optional[int] = None
    max_speakers: Optional[int] = None
    diarize_checkpoint: Optional[str] = None
    segmentation_checkpoint: Optional[str] = None
    diarize_clustering_threshold: float = 0.7
    hf_token: Optional[str] = None
    # output
    output_dir: str = "."
    output_format: str = "all"
    writer_options: dict = field(default_factory=dict)


def _validated_language(raw: Optional[str]) -> Optional[str]:
    if raw is None:
        return None
    code = raw.lower()
    if code in LANGUAGES:
        return code
    if code in TO_LANGUAGE_CODE:
        return TO_LANGUAGE_CODE[code]
    raise ValueError(f"Unsupported language: {raw}")


def _temperature_schedule(base: float, increment: Optional[float]):
    """Fallback ladder base, base+inc, ... 1.0 (reference transcribe.py:156)."""
    if increment is None:
        return [base]
    return tuple(np.arange(base, 1.0 + 1e-6, increment))


def resolve_config(ns: argparse.Namespace, parser: argparse.ArgumentParser) -> CliConfig:
    language = _validated_language(ns.language)

    if ns.model.endswith(".en") and language != "en":
        if language is not None:
            warnings.warn(
                f"{ns.model} is an English-only model but received "
                f"'{language}'; using English instead."
            )
        language = "en"

    do_align = not ns.no_align
    if ns.task == "translate":
        do_align = False  # translated text cannot be phoneme-aligned to source audio

    # Word-level writer options require alignment.
    word_options = {
        "highlight_words": ns.highlight_words,
        "max_line_count": ns.max_line_count,
        "max_line_width": ns.max_line_width,
    }
    if not do_align:
        for name, value in word_options.items():
            if value:
                parser.error(f"--{name} not possible with --no_align")
    if ns.max_line_count and not ns.max_line_width:
        warnings.warn("--max_line_count has no effect without --max_line_width")

    asr_options = {
        "beam_size": ns.beam_size,
        "best_of": ns.best_of,
        "patience": ns.patience,
        "length_penalty": ns.length_penalty,
        "temperatures": _temperature_schedule(
            ns.temperature, ns.temperature_increment_on_fallback
        ),
        "compression_ratio_threshold": ns.compression_ratio_threshold,
        "log_prob_threshold": ns.logprob_threshold,
        "no_speech_threshold": ns.no_speech_threshold,
        "condition_on_previous_text": False,
        "initial_prompt": ns.initial_prompt,
        "suppress_tokens": [int(x) for x in ns.suppress_tokens.split(",")],
        "suppress_numerals": ns.suppress_numerals,
    }

    return CliConfig(
        files=list(ns.audio),
        model_name=ns.model,
        checkpoint=ns.checkpoint,
        model_dir=ns.model_dir,
        device=ns.device,
        device_index=ns.device_index,
        compute_type=ns.compute_type,
        batch_size=ns.batch_size,
        task=ns.task,
        language=language,
        # Reference-parity quirk: the align model (and the language written
        # into every result) defaults to English when detection is on
        # (whisperx/transcribe.py:226) — it affects ja/zh spacing in writers.
        align_language=language or "en",
        verbose=ns.verbose,
        print_progress=ns.print_progress,
        threads=ns.threads or 0,
        chunk_size=ns.chunk_size,
        asr_options=asr_options,
        vad_options={"vad_onset": ns.vad_onset, "vad_offset": ns.vad_offset},
        vad_checkpoint=ns.vad_checkpoint,
        do_align=do_align,
        align_model_name=ns.align_model,
        interpolate_method=ns.interpolate_method,
        return_char_alignments=ns.return_char_alignments,
        do_diarize=ns.diarize,
        min_speakers=ns.min_speakers,
        max_speakers=ns.max_speakers,
        diarize_checkpoint=ns.diarize_checkpoint,
        # The pyannote segmentation checkpoint serves both neural VAD and the
        # overlap-aware diarization stage; --vad_checkpoint flows through.
        segmentation_checkpoint=ns.segmentation_checkpoint or ns.vad_checkpoint,
        diarize_clustering_threshold=ns.diarize_clustering_threshold,
        hf_token=ns.hf_token,
        output_dir=ns.output_dir,
        output_format=ns.output_format,
        writer_options=word_options,
    )


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------


@dataclass
class FileJob:
    """One audio file's state as it moves through the stages."""

    path: str
    result: Optional[dict] = None
    audio: Optional[np.ndarray] = None  # cached waveform (single-file runs)


def _transcribe_stage(cfg: CliConfig, jobs: List[FileJob]) -> None:
    """Stage 1: load Whisper once, transcribe every file, then free it."""
    model = load_model(
        cfg.model_name,
        device=cfg.device,
        device_index=cfg.device_index,
        download_root=cfg.model_dir,
        compute_type=cfg.compute_type,
        language=cfg.language,
        asr_options=cfg.asr_options,
        vad_options=cfg.vad_options,
        task=cfg.task,
        threads=cfg.threads,
        checkpoint=cfg.checkpoint,
        vad_checkpoint=cfg.vad_checkpoint,
    )
    keep_audio = len(jobs) == 1  # reuse the waveform downstream instead of re-decoding
    # Background ingest: the native pool decodes/resamples file i+1 while
    # the accelerator transcribes file i (audio/io.py:AudioPrefetcher).
    prefetch = AudioPrefetcher([job.path for job in jobs])
    for job, (_, audio) in zip(jobs, prefetch):
        if cfg.verbose or cfg.print_progress:
            print(f"[whisperx-tpu-torch] transcribe: {job.path}")
        job.result = model.transcribe(
            audio,
            batch_size=cfg.batch_size,
            chunk_size=cfg.chunk_size,
            print_progress=cfg.print_progress,
            verbose=cfg.verbose,
        )
        if keep_audio:
            job.audio = audio
    # The model's tensors drop here, freeing the card for the next stage's model.
    del model
    gc.collect()


def _align_stage(cfg: CliConfig, jobs: List[FileJob]) -> None:
    """Stage 2: word-level timestamps via wav2vec2 forced alignment."""
    model, metadata = load_align_model(
        cfg.align_language, cfg.device, model_name=cfg.align_model_name
    )
    # Stream waveforms with background ingest (skipped when the single-file
    # run already cached its audio in stage 1). Waveforms are NOT retained:
    # only the single-file cache persists across stages (memory-bounded).
    need = [job for job in jobs if job.audio is None]
    prefetch = iter(AudioPrefetcher([job.path for job in need]))
    # One file's align kept in flight: file f's host post-processing
    # (AlignJob.finish) runs while file f+1's align batches execute on the
    # accelerator. The reference aligns each file fully serially
    # (whisperx/transcribe.py:218-227).
    in_flight = None
    for job in jobs:
        audio = job.audio
        if audio is None:
            _, audio = next(prefetch)
        if model is None or not job.result["segments"]:
            continue
        detected = job.result.get("language", "en")
        if detected != metadata["language"]:
            # Hot-swap to the detected language's default align model. Finish
            # the previous file's in-flight job FIRST: it was built on the old
            # model, so draining it (a) avoids transiently holding two align
            # models' params in HBM and (b) keeps its warnings/prints ordered
            # before the next file's header. Overlap is lost only on the rare
            # language-switch boundary.
            if in_flight is not None:
                prev_job, prev_handle = in_flight
                prev_job.result = prev_handle.finish()
                in_flight = None
            print(
                f"[whisperx-tpu-torch] align model is {metadata['language']}, file is "
                f"{detected}: loading {detected} align model"
            )
            model, metadata = load_align_model(detected, cfg.device)
        if cfg.verbose or cfg.print_progress:
            print(f"[whisperx-tpu-torch] align: {job.path}")
        handle = align_begin(
            job.result["segments"],
            model,
            metadata,
            audio,
            cfg.device,
            interpolate_method=cfg.interpolate_method,
            return_char_alignments=cfg.return_char_alignments,
            print_progress=cfg.print_progress,
        )
        if in_flight is not None:
            prev_job, prev_handle = in_flight
            prev_job.result = prev_handle.finish()
        in_flight = (job, handle)
    if in_flight is not None:
        prev_job, prev_handle = in_flight
        prev_job.result = prev_handle.finish()
    del model
    gc.collect()


def _diarize_stage(cfg: CliConfig, jobs: List[FileJob]) -> None:
    """Stage 3: speaker turns + word-speaker assignment."""
    pipeline = DiarizationPipeline(
        use_auth_token=cfg.hf_token,
        device=cfg.device,
        checkpoint=cfg.diarize_checkpoint,
        vad_checkpoint=cfg.vad_checkpoint,
        segmentation_checkpoint=cfg.segmentation_checkpoint,
        clustering_threshold=cfg.diarize_clustering_threshold,
    )
    need = [job for job in jobs if job.audio is None]
    prefetch = iter(AudioPrefetcher([job.path for job in need]))
    for job in jobs:
        audio = job.audio
        if audio is None:
            _, audio = next(prefetch)
        if cfg.verbose or cfg.print_progress:
            print(f"[whisperx-tpu-torch] diarize: {job.path}")
        turns = pipeline(
            audio,
            min_speakers=cfg.min_speakers,
            max_speakers=cfg.max_speakers,
        )
        job.result = assign_word_speakers(turns, job.result)


def _write_stage(cfg: CliConfig, jobs: List[FileJob]) -> None:
    writer = get_writer(cfg.output_format, cfg.output_dir)
    for job in jobs:
        # Reference-parity quirk: the detected language is overwritten with the
        # align language before writing (whisperx/transcribe.py:226); writers
        # key ja/zh spacing off it.
        job.result["language"] = cfg.align_language
        writer(job.result, job.path, cfg.writer_options)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def cli(argv=None):
    parser = build_parser()
    cfg = resolve_config(parser.parse_args(argv), parser)
    os.makedirs(cfg.output_dir, exist_ok=True)
    if cfg.threads:
        import torch

        torch.set_num_threads(cfg.threads)

    # Fleets: each rank owns a round-robin share of the file list (coarse data
    # parallelism; see parallel/distributed.shard_files), on its own card.
    joined = not dist.is_initialized()
    initialize()
    files = cfg.files
    if world_size() > 1:
        files = shard_files(files)
        if cfg.device == "cuda":
            cfg = replace(cfg, device_index=local_device().index)
    jobs = [FileJob(path) for path in files]
    if jobs:  # a rank may have none: more ranks than files
        _transcribe_stage(cfg, jobs)
        if cfg.do_align:
            _align_stage(cfg, jobs)
        if cfg.do_diarize:
            _diarize_stage(cfg, jobs)
        _write_stage(cfg, jobs)
    if joined and dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    cli()
