"""VAD pipelines: weight-free host scorers, binarize, cut & merge.

Port of ``whisperx_tpu/vad/model.py``. The scorers (``EnergyVAD``,
``SpeechBandVAD``) are numpy on the host, as in the JAX package, so their
scores are bit-equal to it; ``VadPipeline`` turns scores into the ≤chunk_size
windows the batched decode takes (``binarize.py`` is a verbatim copy).

Not ported: ``NeuralVAD``, the sliding-window PyanNet scorer. It needs
``models/vad_net.py``, which comes with the diarization slice (ROADMAP.md
queue 1, item 8); ``load_vad_model(checkpoint=...)`` raises until then.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..audio.constants import SAMPLE_RATE
from .binarize import SpeechTurn, binarize, merge_chunks

# PyanNet frame grid (see whisperx_tpu/models/vad_net.py conv arithmetic).
FRAME_STEP = 270
FRAME_SIZE = 991

_NEURAL_VAD_MISSING = (
    "the neural (PyanNet) VAD is not ported yet: it comes with the diarization "
    "slice (ROADMAP.md queue 1, item 8). Leave checkpoint unset for the "
    "weight-free SpeechBandVAD"
)


@dataclass
class VadScores:
    """Frame-level speech scores on a uniform time grid."""

    scores: np.ndarray  # (num_frames,)
    timestamps: np.ndarray  # (num_frames,) frame-center seconds


class NeuralVAD:
    """Placeholder for the PyanNet scorer: raises (see the module docstring)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_NEURAL_VAD_MISSING)


class EnergyVAD:
    """Band-limited RMS-energy scores on the PyanNet frame grid (fallback).

    Score-scale note: percentile normalization maps the 10th..95th
    log-RMS percentile into [0, 1] *per file* — these scores are NOT on the
    pyannote posterior scale, so the reference's tuned onset=0.5/offset=0.363
    (whisperx/vad.py:52-55) are merely reasonable mid-range cuts here, not
    calibrated values. The adaptive normalization is what makes them
    workable: 0.5 always sits between the file's noise floor and speech
    ceiling. For threshold-faithful behavior use the neural scorer with the
    pinned converted checkpoint.
    """

    def __init__(self, *, smooth_frames: int = 9):
        self.smooth_frames = smooth_frames

    def __call__(self, audio: np.ndarray) -> VadScores:
        n = len(audio)
        if n < FRAME_SIZE:
            audio = np.pad(audio, (0, FRAME_SIZE - n))
            n = len(audio)
        total_frames = (n - FRAME_SIZE) // FRAME_STEP + 1
        starts = np.arange(total_frames) * FRAME_STEP
        energy = _frame_sq_sums(audio, starts, FRAME_SIZE) / FRAME_SIZE
        rms = np.sqrt(energy)

        if self.smooth_frames > 1:
            k = self.smooth_frames
            kernel = np.ones(k) / k
            rms = _convolve_same(rms, kernel)

        # Normalize adaptively: noise floor at the 10th percentile, speech
        # ceiling at the 95th; map log-RMS between them into [0, 1].
        log_rms = np.log10(np.maximum(rms, 1e-10))
        lo = np.percentile(log_rms, 10)
        hi = np.percentile(log_rms, 95)
        scores = np.clip((log_rms - lo) / max(hi - lo, 1e-6), 0.0, 1.0)
        times = (starts + FRAME_SIZE / 2) / SAMPLE_RATE
        return VadScores(scores.astype(np.float32), times.astype(np.float32))


def _convolve_same(x: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``np.convolve(x, kernel, mode="same")``, kept at ``len(x)`` when the
    kernel is longer than ``x`` (numpy then returns ``len(kernel)`` values).

    The JAX package calls ``np.convolve`` directly, so on audio of fewer
    frames than a smoothing kernel (under ~0.5 s for SpeechBandVAD) its
    scores and timestamps differ in length and binarize raises; everywhere
    else the two give the same bits.
    """
    out = np.convolve(x, kernel, mode="same")
    if len(out) != len(x):
        start = (len(kernel) - 1) // 2
        out = np.convolve(x, kernel, mode="full")[start : start + len(x)]
    return out


def _rolling_mean(x: np.ndarray, w: int) -> np.ndarray:
    pad = np.pad(x, (w // 2, w - w // 2 - 1), mode="edge")
    c = np.concatenate([[0.0], np.cumsum(pad)])
    return (c[w:] - c[:-w]) / w


def _frame_sq_sums(x: np.ndarray, starts: np.ndarray, win: int) -> np.ndarray:
    """Windowed sums of x**2 without a per-sample float64 cumsum.

    The VAD host tax at scale (benchmarks/vad_host_tax.py) was dominated by
    ``np.cumsum(x.astype(np.float64) ** 2)`` — ~2.4 s per half hour of audio.
    Here squares stay float32 (one vectorized pass), ``np.add.reduceat``
    folds them into the ≤FRAME_STEP-sample segments between consecutive
    window boundaries, and only the ~2-segments-per-frame cumulative sum
    runs in float64: same frame-level accuracy (float32 segment sums of
    ≤270 samples, float64 accumulation across frames), ~10x less work.
    """
    n = len(x)
    sq = np.asarray(x, np.float32) ** 2
    bounds = np.unique(np.concatenate([starts, starts + win]))
    inner = bounds[bounds < n]
    seg = np.add.reduceat(sq, inner)
    # cum[i] = sum(sq[: inner[i]]); cum[len(inner)] = total. Every window
    # boundary (including an end equal to n) resolves via searchsorted.
    cum = np.concatenate([[0.0], np.cumsum(seg, dtype=np.float64)])
    lo = cum[np.searchsorted(inner, starts)]
    hi = cum[np.searchsorted(inner, starts + win)]
    return hi - lo


class SpeechBandVAD:
    """Speech-band energy x syllabic-modulation scores (weight-free default).

    Two cheap host-side cues fix EnergyVAD's classic failure modes, measured
    on adversarial synthetic audio (music, noise beds, clicks) by
    benchmarks/vad_eval.py — frame F1 0.92-0.95 vs EnergyVAD's 0.56-0.85,
    boundary F1 up to 0.78 vs 0.32 across seeds:

    - **band energy**: one full-signal rFFT band-pass (default 300-3500 Hz)
      removes rumble, hiss and out-of-band music energy; AM valleys are
      filled with a short sliding-window max so syllable gaps don't split
      turns;
    - **syllabic modulation**: speech's 2-8 Hz envelope modulation. The band
      RMS envelope is high-passed by subtracting its ~0.25 s rolling mean
      (so one-shot energy *steps* at segment transitions don't count as
      modulation), and the ratio of residual modulation power to envelope
      mean gates the score. Sustained music/tones/noise beds have near-flat
      envelopes and gate toward zero — the reference gets this robustness
      from pyannote's trained scorer (whisperx/vad.py:51,238); this is the
      calibration-free approximation for checkpoint-less runs.

    Scores keep EnergyVAD's per-file percentile normalization, so the
    reference's onset=0.5/offset=0.363 remain reasonable mid-range cuts.
    ``min_duration_on=0.5`` is the scorer's recommended binarize floor
    (VadPipeline reads it): residual false turns are sub-0.6 s transition
    blips, while real speech turns are longer.
    """

    min_duration_on = 0.5  # recommended binarize floor (see class docstring)

    def __init__(
        self,
        *,
        band: tuple = (300.0, 3500.0),
        env_smooth: int = 5,
        env_fill: int = 11,
        mod_hp_s: float = 0.25,
        mod_window_s: float = 0.8,
        mod_knee: float = 0.3,
        gate_smooth: int = 29,
        close_s: float = 0.22,
    ):
        self.band = band
        self.env_smooth = env_smooth
        self.env_fill = env_fill
        self.mod_hp_s = mod_hp_s
        self.mod_window_s = mod_window_s
        self.mod_knee = mod_knee
        self.gate_smooth = gate_smooth
        self.close_s = close_s

    def __call__(self, audio: np.ndarray) -> VadScores:
        n = len(audio)
        if n < FRAME_SIZE:
            audio = np.pad(audio, (0, FRAME_SIZE - n))
            n = len(audio)
        # Band-pass via one rFFT over the file (O(n log n), float32).
        spec = np.fft.rfft(audio.astype(np.float32))
        freqs = np.fft.rfftfreq(n, 1.0 / SAMPLE_RATE)
        spec[(freqs < self.band[0]) | (freqs > self.band[1])] = 0.0
        banded = np.fft.irfft(spec, n).astype(np.float32)

        total_frames = (n - FRAME_SIZE) // FRAME_STEP + 1
        starts = np.arange(total_frames) * FRAME_STEP
        rms = np.sqrt(_frame_sq_sums(banded, starts, FRAME_SIZE) / FRAME_SIZE)
        frame_rate = SAMPLE_RATE / FRAME_STEP  # ~59 Hz
        if self.env_smooth > 1:
            rms = _convolve_same(rms, np.ones(self.env_smooth) / self.env_smooth)

        # Syllabic-modulation gate on the 2-8 Hz envelope band: the
        # env_smooth above is the ~12 Hz low-pass; subtracting the rolling
        # mean is the ~(1/mod_hp_s) Hz high-pass.
        hp = rms - _rolling_mean(rms, max(3, int(self.mod_hp_s * frame_rate)))
        w = max(3, int(self.mod_window_s * frame_rate))
        mod_power = np.sqrt(np.maximum(_rolling_mean(hp**2, w), 0.0))
        cv = mod_power / np.maximum(_rolling_mean(rms, w), 1e-8)
        gate = np.clip(cv / self.mod_knee, 0.0, 1.0)
        if self.gate_smooth > 1:
            gate = _convolve_same(gate, np.ones(self.gate_smooth) / self.gate_smooth)

        # Energy term: sliding-window max fills syllabic AM valleys so one
        # speech turn stays one turn.
        env = rms
        if self.env_fill > 1:
            sw = np.lib.stride_tricks.sliding_window_view(
                np.pad(env, (self.env_fill // 2, self.env_fill - self.env_fill // 2 - 1),
                       mode="edge"),
                self.env_fill,
            )
            env = sw.max(axis=1)
        log_rms = np.log10(np.maximum(env, 1e-10))
        lo = np.percentile(log_rms, 10)
        hi = np.percentile(log_rms, 95)
        energy = np.clip((log_rms - lo) / max(hi - lo, 1e-6), 0.0, 1.0)

        scores = energy * gate

        # Morphological closing (sliding max, then sliding min): fills score
        # dips narrower than close_s *exactly* to the surrounding level, so
        # deep intra-speech envelope valleys (e.g. strong syllabic AM over a
        # silent floor, where per-file normalization amplifies the ripple to
        # a full 0→1 swing) cannot flap the binarize hysteresis. This is the
        # max_duration-compatible replacement for the reference's
        # min_duration_off gap-fill (whisperx/vad.py:185-187 raises when the
        # two combine, so its chunking path has no gap-fill at all).
        cw = max(3, int(self.close_s * frame_rate))
        if cw % 2 == 0:
            cw += 1

        def _slide(arr, op):
            sw = np.lib.stride_tricks.sliding_window_view(
                np.pad(arr, (cw // 2, cw // 2), mode="edge"), cw
            )
            return op(sw, axis=1)

        scores = _slide(_slide(scores, np.max), np.min)
        times = (starts + FRAME_SIZE / 2) / SAMPLE_RATE
        return VadScores(scores.astype(np.float32), times.astype(np.float32))


class VadPipeline:
    """Scores + binarize + merge: audio → ≤chunk_size batching windows."""

    def __init__(
        self,
        scorer,
        *,
        onset: float = 0.500,
        offset: float = 0.363,
        min_duration_on: Optional[float] = None,
        min_duration_off: float = 0.0,
    ):
        self.scorer = scorer
        self.onset = onset
        self.offset = offset
        # Scorers may recommend a binarize floor (SpeechBandVAD sets 0.5 to
        # drop sub-turn transition blips); explicit argument wins.
        if min_duration_on is None:
            min_duration_on = float(getattr(scorer, "min_duration_on", 0.0))
        self.min_duration_on = min_duration_on
        # Gap-fill below binarize (reference Binarize raises when combined
        # with max_duration — whisperx/vad.py:185-187 — so its merge_chunks
        # path never uses it either; keep 0.0 with chunked binarize and use
        # scorer-level closing instead, see SpeechBandVAD).
        self.min_duration_off = min_duration_off

    def __call__(self, audio: np.ndarray, chunk_size: float = 30.0) -> List[dict]:
        vs = self.scorer(audio)
        turns = binarize(
            vs.scores,
            vs.timestamps,
            onset=self.onset,
            offset=self.offset,
            min_duration_on=self.min_duration_on,
            min_duration_off=self.min_duration_off,
            max_duration=chunk_size,
        )
        if not turns:
            return []
        return merge_chunks(turns, chunk_size)

    def speech_turns(self, audio: np.ndarray, max_duration: float = float("inf")):
        vs = self.scorer(audio)
        return binarize(
            vs.scores, vs.timestamps, onset=self.onset, offset=self.offset,
            min_duration_on=self.min_duration_on,
            min_duration_off=self.min_duration_off,
            max_duration=max_duration,
        )


# SHA256 of the pinned pyannote segmentation checkpoint the reference
# downloads and verifies (whisperx/vad.py:18,46-49 — the hash is the URL's
# path component). Canonical registry: models/pinned.py.
from ..models.pinned import PINNED as _PINNED

VAD_SEGMENTATION_SHA256 = _PINNED["pyannote-segmentation"]


def verify_checkpoint_sha256(path: str, expected: Optional[str]) -> str:
    """SHA256-check a checkpoint file (reference vad.py:46-49 contract).

    With ``expected`` set, a mismatch raises; otherwise the digest is
    compared against the pinned reference checkpoint and a warning is issued
    when it differs (custom checkpoints are allowed, but the user should know
    they are off the pinned weights). Returns the hex digest.
    """
    import hashlib
    import warnings

    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if expected is not None:
        if digest != expected:
            raise RuntimeError(
                f"VAD checkpoint SHA256 mismatch for {path}: got {digest}, "
                f"expected {expected}. Re-fetch the checkpoint."
            )
    elif digest != VAD_SEGMENTATION_SHA256:
        warnings.warn(
            f"VAD checkpoint {path} does not match the pinned reference "
            f"segmentation weights (sha256 {digest[:12]}…); proceeding with "
            "custom weights."
        )
    return digest


def load_vad_model(
    device=None,
    vad_onset: float = 0.500,
    vad_offset: float = 0.363,
    *,
    checkpoint: Optional[str] = None,
    use_auth_token=None,
    model_fp: Optional[str] = None,
    expected_sha256: Optional[str] = None,
) -> VadPipeline:
    """Build the VAD pipeline (reference load_vad_model contract, vad.py:20-59).

    The weight-free ``SpeechBandVAD`` scorer, as the JAX package uses without
    a checkpoint. A ``checkpoint`` (or ``model_fp``) asks for the neural
    scorer, which is not ported: that raises NotImplementedError rather than
    quietly scoring with SpeechBandVAD. ``device`` is accepted for API
    parity; the scorers run on the host.
    """
    if checkpoint or model_fp:
        raise NotImplementedError(_NEURAL_VAD_MISSING)
    # Weight-free default for real runs: SpeechBandVAD beat EnergyVAD
    # decisively on the JAX package's adversarial eval (benchmarks/vad_eval.py
    # — frame F1 0.92-0.95 vs 0.56-0.85 across seeds). EnergyVAD remains for
    # tests whose synthetic tones sit below the speech band.
    return VadPipeline(SpeechBandVAD(), onset=vad_onset, offset=vad_offset)
