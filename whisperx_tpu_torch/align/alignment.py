"""Forced alignment: transcript + audio → char/word/sentence timestamps.

Port of ``whisperx_tpu/align/alignment.py`` (reference aligner:
whisperx/alignment.py:100-354): the same char cleaning (lowercase,
space→``|``, charwise ja/zh), Punkt-rule sentence spans, trellis/backtrack
semantics, word/sentence aggregation, NaN interpolation, same-timestamp
sentence merging and degraded-output fallbacks.

Alignable segments are sorted by length and packed into padded batches
(length buckets of :data:`BUCKET_S` seconds, tail batches on the halving
ladder); for each batch one device function runs int16 → float
audio, wav2vec2 emissions, the CTC trellis and the backtrack, and returns a
small (3, B, T'+1) pack that is fetched to the host once. ``align_begin``
launches every batch without waiting (PyTorch's launches are asynchronous;
uploads go through pinned memory) and keeps at most :data:`MAX_INFLIGHT`
packs pending; ``AlignJob.finish()`` fetches them and aggregates on the host.

``load_align_model`` reads a local HF wav2vec2-CTC checkpoint
(``models/convert.py:load_wav2vec2``); ``compute_type="int8"`` quantizes it
weight-only (``models/wav2vec2.py:quantize_wav2vec2``).
``shard_align_model`` puts the model on a ``parallel.make_mesh`` mesh: each
batch's rows split over the "data" axis (a multiple of it, on the ladder),
the transformer over "model", and every rank gathers the packs back in rank
order before the host aggregation.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from dataclasses import dataclass
from typing import Any, Iterable, List, Optional, Union

import numpy as np
import torch

from ..audio.constants import SAMPLE_RATE
from ..audio.io import load_audio, pcm16
from ..device import DeviceLike, resolve_device
from ..io.languages import LANGUAGES_WITHOUT_SPACES
from ..io.types import AlignedTranscriptionResult, SingleAlignedSegment, SingleSegment
from ..models.configs import WAV2VEC2_TEST
from ..models.wav2vec2 import Wav2Vec2ForCTC
from ..ops import flash_attn
from ..ops.ctc import PathPoint, ctc_align_batch_device, merge_repeats
from ..parallel.mesh import axis_size, gather_rows, mesh_device, shard_batch
from ..utils import interpolate_nans, telemetry
from .registry import TORCH_BUNDLE_TO_HF, default_align_model
from .sentences import PUNKT_ABBREVIATIONS, sentence_spans

# Align batches pad their audio to a multiple of BUCKET_S seconds, and
# align_begin keeps at most MAX_INFLIGHT launched batches unfetched.
BUCKET_S = 1
MAX_INFLIGHT = 8


@dataclass
class AlignModel:
    """The port's wav2vec2 (weights inside the module) and its char vocabulary."""

    model: Wav2Vec2ForCTC
    dictionary: dict  # lowercase char -> token id
    language: str
    blank_id: int = 0
    max_batch: int = 8
    # Optional parallel.make_mesh mesh (shard_align_model): align batches run
    # data-parallel over its "data" axis, the model split over "model".
    mesh: Any = None

    @property
    def device(self) -> torch.device:
        return self.model.device


def shard_align_model(align_model: AlignModel, mesh) -> AlignModel:
    """Return a copy of the align model placed on a (data, model) mesh.

    The model becomes this rank's slice under the wav2vec2 tensor-parallel
    rules (whole wherever a dim does not divide the "model" axis), on the
    rank's device; align() then splits each batch's rows over "data" and
    gathers the results, so the word timestamps are the single-device
    ones. ``max_batch`` rounds up to a multiple of the data axis. Every rank
    calls this.
    """
    from ..models.convert import wav2vec2_from_jax, whisper_to_jax

    if align_model.mesh is not None:
        raise ValueError("shard_align_model: the align model is already on a mesh")
    m = align_model.model
    model = wav2vec2_from_jax(whisper_to_jax(m), m.config, dtype=m.dtype, device=mesh_device(mesh), mesh=mesh)
    # Round the batch up to a data-axis multiple so rows tile the mesh.
    n_data = axis_size(mesh, "data")
    max_batch = -(-align_model.max_batch // n_data) * n_data
    return dataclasses.replace(align_model, model=model, mesh=mesh, max_batch=max_batch)


def _find_blank_id(dictionary: dict) -> int:
    for char, code in dictionary.items():
        if char in ("[pad]", "<pad>"):
            return code
    return 0


def load_align_model(
    language_code: str,
    device: DeviceLike = None,
    model_name: Optional[str] = None,
    model_dir: Optional[str] = None,
    compute_type: Optional[str] = None,
):
    """Build the alignment model + metadata (reference alignment.py:64-97 API).

    ``model_name`` may be a local HF checkpoint directory (offline), an HF hub
    id (resolved through the local cache), or a torchaudio bundle name
    (mapped to its HF twin). The compute dtype is bf16 on the card and fp32
    on the CPU; ``compute_type="int8"`` weight-only quantizes the wav2vec2
    transformer (the emissions head stays fp, see ``quantize_wav2vec2``).
    ``device=None`` means the card. Returns (AlignModel, {"language",
    "dictionary", "type"}).
    """
    from ..models.convert import load_wav2vec2
    from ..models.wav2vec2 import quantize_wav2vec2

    if model_name is None:
        model_name = default_align_model(language_code)
    model_name = TORCH_BUNDLE_TO_HF.get(model_name, model_name)
    model, dictionary = load_wav2vec2(model_name, cache_dir=model_dir, device=resolve_device(device))
    if compute_type == "int8":
        model = quantize_wav2vec2(model)
    align_model = AlignModel(
        model=model,
        dictionary={c.lower(): i for c, i in dictionary.items()},
        language=language_code,
        blank_id=_find_blank_id(dictionary),
    )
    metadata = {"language": language_code, "dictionary": align_model.dictionary, "type": "torch"}
    return align_model, metadata


def test_align_model(
    language: str = "en",
    seed: int = 0,
    config=None,
    dtype: torch.dtype = None,
    *,
    device: DeviceLike = None,
) -> AlignModel:
    """Random-weight align model with an a-z dictionary (tests/benchmarks).

    ``config`` defaults to the miniature test architecture; pass
    WAV2VEC2_BASE for realistic cost. ``dtype`` sets the compute dtype (fp32
    by default). Weights come from ``models/wav2vec2.py:random_params``
    (numpy, ``seed``); ``device=None`` means the card."""
    from ..models.convert import wav2vec2_from_jax
    from ..models.wav2vec2 import random_params

    cfg = config or WAV2VEC2_TEST
    model = wav2vec2_from_jax(random_params(cfg, seed), cfg, dtype=dtype or torch.float32, device=device)
    chars = ["[pad]", "|", "'"] + [chr(c) for c in range(ord("a"), ord("z") + 1)]
    dictionary = {c: i for i, c in enumerate(chars)}
    return AlignModel(model, dictionary, language, blank_id=0)


# Not a pytest test — keep pytest from collecting this factory when imported
# into test modules.
test_align_model.__test__ = False


def _sentence_spans(text: str):
    return sentence_spans(text, PUNKT_ABBREVIATIONS)


def _preprocess_segment(text: str, dictionary: dict, charwise: bool):
    """Clean chars to the model vocabulary, tracking original indices."""
    num_leading = len(text) - len(text.lstrip())
    num_trailing = len(text) - len(text.rstrip())

    clean_char, clean_cdx = [], []
    for cdx, char in enumerate(text):
        c = char.lower()
        if not charwise:
            c = c.replace(" ", "|")
        if cdx < num_leading or cdx > len(text) - num_trailing - 1:
            continue
        if c in dictionary:
            clean_char.append(c)
            clean_cdx.append(cdx)

    per_word = text if charwise else text.split(" ")
    clean_wdx = [
        wdx for wdx, wrd in enumerate(per_word) if any(c.lower() in dictionary for c in wrd)
    ]
    return clean_char, clean_cdx, clean_wdx


def _wav_f32(wavs: torch.Tensor) -> torch.Tensor:
    """int16 uploads → float32 / 32768 on the device; float passes through."""
    return wavs if wavs.dtype.is_floating_point else wavs.float() / 32768.0


def _upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array → device tensor without blocking the host: through pinned
    memory on CUDA, so a launch queue behind earlier batches does not stall
    the caller."""
    t = torch.from_numpy(x)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _emissions(model: Wav2Vec2ForCTC, wavs: torch.Tensor, sample_lens: torch.Tensor):
    """(B, T) audio on the device → (log-softmax emissions (B, T', V),
    valid frame counts (B,))."""
    logits = model(_wav_f32(wavs), sample_lengths=sample_lens)
    return torch.log_softmax(logits, dim=-1), model.feature_lengths(sample_lens)


@torch.inference_mode()
def _fused_align_fwd(model: Wav2Vec2ForCTC, wavs: torch.Tensor, tok_pack: torch.Tensor, blank: int, rows_valid: int):
    """Waveforms → wav2vec2 emissions → CTC trellis → device backtrack, all
    on the device, into ONE (3, B, T'+1) float32 pack: plane 0 the token path
    index, plane 1 the probs, plane 2 the active mask, and a trailing column
    [success, t_len, 0]. ``tok_pack`` (B, N+2) = [tokens | sample_len |
    n_len]. Nothing is read back here. Two device spans time it,
    ``align.emissions`` and ``align.ctc`` (counts ``rows`` and
    ``rows_valid``, the rows that hold a segment; ``align.emissions`` also
    ``flash_launches``, the encoder's flash kernel launches)."""
    tokens = tok_pack[:, :-2]
    sample_lens = tok_pack[:, -2]
    n_len = tok_pack[:, -1]
    counts = {"rows": wavs.shape[0], "rows_valid": rows_valid}
    flash0 = flash_attn.launches
    emissions = telemetry.begin("align.emissions", device=wavs.device, **counts)
    logp, t_len = _emissions(model, wavs, sample_lens)
    emissions.counts["flash_launches"] = flash_attn.launches - flash0
    ctc = telemetry.begin("align.ctc", device=wavs.device, **counts)
    telemetry.end(emissions, at=ctc)
    tok_idx, probs, active, success, _ = ctc_align_batch_device(logp, tokens, t_len, n_len, blank=blank)
    pack = torch.stack([tok_idx.float(), probs, active.float()])  # (3, B, T')
    tail = torch.stack([success.float(), t_len.float(), torch.zeros_like(probs[:, 0])])  # (3, B)
    out = torch.cat([pack, tail[:, :, None]], dim=2)
    telemetry.end(ctc)
    return out


def _ladder_rows(n: int, max_batch: int, mesh=None) -> int:
    """Round a tail batch up on the halving ladder {B, B/2, B/4}: at most
    three row counts per length bucket, and a half-full tail pays about half
    the wav2vec2 work. Under a mesh, rows stay a multiple of the data axis
    so batches tile it."""
    floor = axis_size(mesh, "data") if mesh is not None else 1
    for rows in (max_batch // 4, max_batch // 2, max_batch):
        if rows >= max(n, floor, 1) and rows % floor == 0:
            return rows
    return max_batch


def _run_rows(align_model: AlignModel, fn, *host_arrays, dim: int = 0) -> torch.Tensor:
    """``fn`` on the device copies of ``host_arrays`` (row-aligned): all
    rows on the model's device, or under a mesh this rank's rows, with the
    result's rows (along ``dim``) gathered from every rank."""
    if align_model.mesh is None:
        return fn(*(_upload(a, align_model.device) for a in host_arrays))
    out = fn(*(shard_batch(align_model.mesh, a) for a in host_arrays))
    return gather_rows(align_model.mesh, out, dim=dim)


def _bucket_len(n: int) -> int:
    """Pad to the next multiple of :data:`BUCKET_S` seconds."""
    b = BUCKET_S * SAMPLE_RATE
    return max(b, -(-n // b) * b)


class AlignJob:
    """Deferred alignment handle (no reference counterpart).

    ``align_begin`` launches the device work of every batch without waiting
    for results; ``finish()`` fetches them and runs the host aggregation, so
    host post-processing overlaps device work the caller launches in between.
    """

    def __init__(self, finish_fn):
        self._finish_fn = finish_fn
        self._result = None

    def finish(self) -> AlignedTranscriptionResult:
        if self._finish_fn is not None:
            self._result = self._finish_fn()
            self._finish_fn = None
        return self._result


def align(
    transcript: Iterable[SingleSegment],
    model: AlignModel,
    align_model_metadata: dict,
    audio: Union[str, np.ndarray],
    device: DeviceLike = None,
    interpolate_method: str = "nearest",
    return_char_alignments: bool = False,
    print_progress: bool = False,
    combined_progress: bool = False,
) -> AlignedTranscriptionResult:
    """Align transcription segments to the audio (reference align() API)."""
    return align_begin(
        transcript,
        model,
        align_model_metadata,
        audio,
        device,
        interpolate_method=interpolate_method,
        return_char_alignments=return_char_alignments,
        print_progress=print_progress,
        combined_progress=combined_progress,
    ).finish()


def align_begin(
    transcript: Iterable[SingleSegment],
    model: AlignModel,
    align_model_metadata: dict,
    audio: Union[str, np.ndarray],
    device: DeviceLike = None,
    interpolate_method: str = "nearest",
    return_char_alignments: bool = False,
    print_progress: bool = False,
    combined_progress: bool = False,
) -> AlignJob:
    """Launch alignment device work; see AlignJob for the overlap contract.

    ``device`` (``None`` means the card) must be where ``model`` lives.
    The request's root telemetry span is ``align`` (count ``audio_s``, the
    audio's length), open until ``finish()`` ends: under it each batch's
    ``align.emissions`` and ``align.ctc`` (device), each ``align.fetch``
    (the host's wait for a batch's pack) and the ``align.aggregate`` spans
    (host: the packs into paths, then the words and sentences).
    """
    t0 = time.perf_counter()
    root = telemetry.begin("align", root=True)
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"align: the align model lives on {model.device}, but {dev} was asked for")
    if isinstance(audio, str):
        audio = load_audio(audio)
    audio = np.asarray(audio, dtype=np.float32).reshape(-1)
    max_duration = len(audio) / SAMPLE_RATE
    root.counts["audio_s"] = max_duration

    # Device uploads in int16 PCM: half the bytes per align batch (bit-exact
    # for s16le-decoded audio; WHISPERX_WAV_INT16=0 opts out).
    audio_up = pcm16(audio) if os.environ.get("WHISPERX_WAV_INT16", "1") == "1" else audio

    dictionary = align_model_metadata["dictionary"]
    lang = align_model_metadata["language"]
    charwise = lang in LANGUAGES_WITHOUT_SPACES

    transcript = list(transcript)
    total = len(transcript)

    # ---- pass 1: clean text + sentence spans -------------------------------
    for sdx, segment in enumerate(transcript):
        if print_progress:
            base = ((sdx + 1) / total) * 100
            pct = (50 + base / 2) if combined_progress else base
            print(f"Progress: {pct:.2f}%...")
        clean_char, clean_cdx, clean_wdx = _preprocess_segment(segment["text"], dictionary, charwise)
        segment["clean_char"] = clean_char
        segment["clean_cdx"] = clean_cdx
        segment["clean_wdx"] = clean_wdx
        segment["sentence_spans"] = _sentence_spans(segment["text"])

    # ---- pass 2: batched emissions + trellis for alignable segments -------
    alignable: List[int] = []
    slices: List[np.ndarray] = []
    token_lists: List[List[int]] = []
    for sdx, segment in enumerate(transcript):
        if len(segment["clean_char"]) == 0 or segment["start"] >= max_duration:
            continue
        f1 = int(segment["start"] * SAMPLE_RATE)
        f2 = int(segment["end"] * SAMPLE_RATE)
        wav = audio_up[f1:f2]
        if len(wav) < 400:  # wav2vec2 minimum receptive field
            wav = np.pad(wav, (0, 400 - len(wav)))
        alignable.append(sdx)
        slices.append(wav)
        token_lists.append([dictionary[c] for c in segment["clean_char"]])

    paths_by_sdx = {}
    frames_by_sdx = {}
    pendings: List[tuple] = []
    if alignable:
        B = model.max_batch
        order = sorted(range(len(alignable)), key=lambda k: len(slices[k]))

        def consume(pending):
            idx, out = pending
            with telemetry.span("align.fetch"):
                pack = out.cpu().numpy()  # (3, B, T'+1): ONE device→host fetch
            telemetry.resolve()  # the batch has ended: read its events
            with telemetry.span("align.aggregate"):
                _paths(idx, pack)

        def _paths(idx, pack):
            tok_idx = pack[0, :, :-1].astype(np.int32)
            probs = pack[1, :, :-1]
            active = pack[2, :, :-1] != 0.0
            success = pack[0, :, -1] != 0.0
            t_len = pack[1, :, -1].astype(np.int32)
            T = tok_idx.shape[1]
            times = T - 1 - np.arange(T)
            for row, k in enumerate(idx):
                sdx = alignable[k]
                frames_by_sdx[sdx] = int(t_len[row])
                if not success[row]:
                    paths_by_sdx[sdx] = None
                    continue
                ks = np.nonzero(active[row])[0]
                paths_by_sdx[sdx] = [
                    PathPoint(int(tok_idx[row, x]), int(times[x]), float(probs[row, x])) for x in ks
                ][::-1]

        for i in range(0, len(order), B):
            idx = order[i : i + B]
            max_len = _bucket_len(max(len(slices[k]) for k in idx))
            N_true = max(len(token_lists[k]) for k in idx)
            N = max(64, -(-N_true // 64) * 64)
            rows = _ladder_rows(len(idx), B, model.mesh)
            wavs = np.zeros((rows, max_len), audio_up.dtype)
            # tok_pack = [tokens | sample_len | n_len]: one small upload.
            tok_pack = np.zeros((rows, N + 2), np.int64)
            tok_pack[:, 0] = model.blank_id or 1
            tok_pack[:, N + 1] = 1  # padding rows: 1 dummy token
            for row, k in enumerate(idx):
                wavs[row, : len(slices[k])] = slices[k]
                tok_pack[row, : len(token_lists[k])] = token_lists[k]
                tok_pack[row, N] = len(slices[k])
                tok_pack[row, N + 1] = len(token_lists[k])
            tok_pack[:, N] = np.maximum(tok_pack[:, N], 400)  # avoid zero-length conv edge on pad rows
            fwd = functools.partial(_fused_align_fwd, model.model, blank=model.blank_id, rows_valid=len(idx))
            with telemetry.within(root):
                out = _run_rows(model, fwd, wavs, tok_pack, dim=1)
                pendings.append((idx, out))
                # Bound the launch window: each pending batch keeps its upload
                # alive on the device. Consuming the oldest blocks on a batch
                # launched MAX_INFLIGHT batches ago.
                while len(pendings) > MAX_INFLIGHT:
                    consume(pendings.pop(0))

    # Telemetry counts only time inside align's own phases: the begin span
    # plus the finish span, not the caller's work in between.
    begin_s = time.perf_counter() - t0

    def _finish() -> AlignedTranscriptionResult:
        tf = time.perf_counter()
        with telemetry.within(root):
            for pending in pendings:
                consume(pending)
            with telemetry.span("align.aggregate"):
                result = _aggregate_result(
                    transcript, paths_by_sdx, frames_by_sdx, max_duration, charwise, interpolate_method,
                    return_char_alignments,
                )
        telemetry.GLOBAL.record(
            "align",
            seconds=begin_s + (time.perf_counter() - tf),
            audio_seconds=sum(max(0.0, float(s["end"]) - float(s["start"])) for s in transcript),
            span=root,
        )
        return result

    return AlignJob(_finish)


def _aggregate_result(
    transcript,
    paths_by_sdx,
    frames_by_sdx,
    max_duration,
    charwise,
    interpolate_method,
    return_char_alignments,
) -> AlignedTranscriptionResult:
    """Pass 3: char → word → sentence aggregation (host-only, numpy)."""
    aligned_segments: List[SingleAlignedSegment] = []
    for sdx, segment in enumerate(transcript):
        t1, t2, text = segment["start"], segment["end"], segment["text"]
        fallback: SingleAlignedSegment = {"start": t1, "end": t2, "text": text, "words": []}
        if return_char_alignments:
            fallback["chars"] = []

        if len(segment["clean_char"]) == 0:
            print(
                f'Failed to align segment ("{text}"): no characters in this '
                "segment found in model dictionary, resorting to original..."
            )
            aligned_segments.append(fallback)
            continue
        if t1 >= max_duration:
            print(
                f'Failed to align segment ("{text}"): original start time '
                "longer than audio duration, skipping..."
            )
            aligned_segments.append(fallback)
            continue

        path = paths_by_sdx.get(sdx)
        if path is None:
            print(f'Failed to align segment ("{text}"): backtrack failed, resorting to original...')
            aligned_segments.append(fallback)
            continue

        text_clean = "".join(segment["clean_char"])
        char_spans = merge_repeats(path, text_clean)
        duration = t2 - t1
        ratio = duration / frames_by_sdx[sdx]

        # Per-char timestamp arrays over the ORIGINAL text (NaN = unaligned),
        # plus the word index of every character (the reference's pandas
        # aggregation, whisperx/alignment.py:284-347, on numpy).
        n_chars = len(text)
        starts = np.full(n_chars, np.nan)
        ends = np.full(n_chars, np.nan)
        scores = np.full(n_chars, np.nan)
        word_of_char = np.zeros(n_chars, np.int64)
        word_idx = 0
        for cdx, char in enumerate(text):
            word_of_char[cdx] = word_idx
            if charwise:
                word_idx += 1
            elif cdx == n_chars - 1 or text[cdx + 1] == " ":
                word_idx += 1
        for k, cdx in enumerate(segment["clean_cdx"]):
            span = char_spans[k]
            starts[cdx] = round(span.start * ratio + t1, 3)
            ends[cdx] = round(span.end * ratio + t1, 3)
            scores[cdx] = round(span.score, 3)

        def _nanreduce(fn, a):
            a = a[~np.isnan(a)]
            return fn(a) if a.size else np.nan

        subsegments = []
        for sstart, send in segment["sentence_spans"]:
            # Reference quirk: the sentence selection is index <= send —
            # inclusive of the char AT the span end (usually the following
            # space) — so keep it.
            sel = slice(sstart, min(send, n_chars - 1) + 1)
            sel_chars = text[sel]
            non_space = np.array([c != " " for c in sel_chars], bool)
            sentence_start = _nanreduce(np.min, starts[sel])
            sentence_end = _nanreduce(np.max, ends[sel][non_space])

            sentence_words = []
            for w_idx in np.unique(word_of_char[sel]):  # ascending == appearance order
                in_word = word_of_char[sel] == w_idx
                word_text = "".join(c for c, m in zip(sel_chars, in_word) if m).strip()
                if not word_text:
                    continue
                keep = in_word & non_space
                word_start = _nanreduce(np.min, starts[sel][keep])
                word_end = _nanreduce(np.max, ends[sel][keep])
                word_score = round(_nanreduce(np.mean, scores[sel][keep]), 3)

                word_seg = {"word": word_text}
                if not np.isnan(word_start):
                    word_seg["start"] = word_start
                if not np.isnan(word_end):
                    word_seg["end"] = word_end
                if not np.isnan(word_score):
                    word_seg["score"] = word_score
                sentence_words.append(word_seg)

            sub = {
                "text": text[sstart:send],
                "start": sentence_start,
                "end": sentence_end,
                "words": sentence_words,
            }
            if return_char_alignments:
                sub["chars"] = [
                    {
                        k: v
                        for k, v in (
                            ("char", c),
                            ("start", starts[cdx]),
                            ("end", ends[cdx]),
                            ("score", scores[cdx]),
                        )
                        if not (isinstance(v, float) and np.isnan(v))
                    }
                    for cdx, c in zip(range(sstart, min(send, n_chars - 1) + 1), sel_chars)
                ]
            subsegments.append(sub)

        # Heal missing sentence times, then merge sentences that landed on
        # identical (start, end) — value-grouped and key-sorted, and NaN-keyed
        # rows dropped, exactly like the reference's pandas groupby
        # (whisperx/alignment.py:336-347).
        sub_starts = interpolate_nans([s["start"] for s in subsegments], method=interpolate_method)
        sub_ends = interpolate_nans([s["end"] for s in subsegments], method=interpolate_method)
        joiner = "" if charwise else " "
        groups: dict = {}
        for sub, g_start, g_end in zip(subsegments, sub_starts, sub_ends):
            if np.isnan(g_start) or np.isnan(g_end):
                continue
            key = (float(g_start), float(g_end))
            grp = groups.get(key)
            if grp is None:
                grp = groups[key] = {"start": key[0], "end": key[1], "text": [], "words": []}
                if return_char_alignments:
                    grp["chars"] = []
            grp["text"].append(sub["text"])
            grp["words"].extend(sub["words"])
            if return_char_alignments:
                grp["chars"].extend(sub["chars"])
        for key in sorted(groups):
            grp = groups[key]
            grp["text"] = joiner.join(grp["text"])
            aligned_segments.append(grp)

    word_segments = []
    for segment in aligned_segments:
        word_segments += segment["words"]
    return {"segments": aligned_segments, "word_segments": word_segments}
