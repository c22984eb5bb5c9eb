"""Overlap-aware speaker segmentation (the pyannote-3.1 'segmentation' stage).

Port of ``whisperx_tpu/diarize/segmentation.py``: ``NeuralSegmentation``
runs the PyanNet on the device; ``OverlapDiarizer`` is the JAX package's
host numpy over an injected scorer, unchanged.

The reference's diarizer runs pyannote ``speaker-diarization-3.1``
(whisperx/diarize.py:19,28): a local *segmentation* model producing
per-speaker frame activities inside sliding windows — including overlapping
speech — then one embedding per (window, local speaker), then global
clustering.

The segmentation network IS the PyanNet already used for VAD
(models/vad_net.py): its classifier head emits (T', C) per-class sigmoid
activities that ``vad/model.py`` max-reduces to mono VAD. Here the
multi-class output is kept:

1. sliding windows (5 s / 2.5 s) → ONE batched PyanNet forward → local
   activities (W, T', C);
2. per (window, class) with enough active speech: mask the window waveform
   by the class's frame activity and embed — all masked windows in ONE
   batched embedder call;
3. agglomerative cosine clustering of the embeddings → global speaker per
   (window, class), honoring num/min/max_speakers;
4. Hamming-weighted overlap-average of each global speaker's activities
   onto the global PyanNet frame grid (same aggregation as the VAD scorer);
5. per-speaker hysteresis binarization → speaker turns that MAY overlap.

The PyanNet forward and the embeddings run on the device; host code does
the windowing, clustering (tiny N) and binarization.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from ..audio.constants import SAMPLE_RATE
from ..device import map_rows
from ..vad.binarize import binarize
from ..vad.model import FRAME_SIZE, FRAME_STEP
from .cluster import cluster_speakers


class NeuralSegmentation:
    """Batched sliding-window PyanNet inference keeping the per-class output.

    Same batching as ``vad.model.NeuralVAD`` (``device.map_rows``) but
    returns the full (W, T', C) local speaker activities instead of the
    max-reduced mono VAD score.
    """

    def __init__(self, model, mesh=None):
        self.model = model.eval()
        self.mesh = mesh  # data-parallel window batches when set

    def __call__(self, windows: np.ndarray) -> np.ndarray:  # (W, T) -> (W, T', C)
        return map_rows(self.model, windows, self.model.device, self.mesh)


class OverlapDiarizer:
    """Local segmentation → masked embeddings → clustering → overlapping turns.

    ``scorer`` maps a (W, T) window batch to (W, T', C) activities in [0, 1]
    (NeuralSegmentation with converted pyannote weights, or any callable with
    that contract — tests inject a band-energy oracle). ``embedder`` maps
    (B, T) waveforms to L2-normalized (B, D) embeddings (the same backends
    DiarizationPipeline uses).
    """

    def __init__(
        self,
        scorer: Callable[[np.ndarray], np.ndarray],
        embedder,
        *,
        window: float = 5.0,
        step: float = 2.5,
        onset: float = 0.5,
        offset: float = 0.363,
        min_duration_on: float = 0.1,
        min_duration_off: float = 0.1,
        min_activity: float = 0.3,
        clustering_threshold: float = 0.7,
    ):
        self.scorer = scorer
        self.embedder = embedder
        self.window = window
        self.step = step
        self.onset = onset
        self.offset = offset
        self.min_duration_on = min_duration_on
        self.min_duration_off = min_duration_off
        self.min_activity = min_activity
        self.clustering_threshold = clustering_threshold

    # -- helpers --------------------------------------------------------------

    def _window_starts(self, n: int, win: int, hop: int) -> List[int]:
        starts = list(range(0, max(n - win, 0) + 1, hop))
        if starts[-1] + win < n:
            starts.append(n - win)
        return starts

    def __call__(
        self,
        audio: np.ndarray,
        num_speakers: Optional[int] = None,
        min_speakers: Optional[int] = None,
        max_speakers: Optional[int] = None,
    ) -> List[Tuple[float, float, int]]:
        """audio (T,) float32 → [(start_s, end_s, speaker_int), ...] (may overlap)."""
        audio = np.asarray(audio, dtype=np.float32).reshape(-1)
        win = int(self.window * SAMPLE_RATE)
        hop = int(self.step * SAMPLE_RATE)
        n = len(audio)
        if n < win:
            audio = np.pad(audio, (0, win - n))
            n = win
        starts = self._window_starts(n, win, hop)
        windows = np.stack([audio[s : s + win] for s in starts])  # (W, win)

        acts = np.asarray(self.scorer(windows), np.float32)  # (W, T', C)
        W, Tp, C = acts.shape

        # -- local speakers worth embedding: activity mask per (window, class).
        # The class's active samples are compacted and repeat-padded to the
        # fixed window length (NOT zero-masked in place: silence would
        # dominate the embedder's temporal statistics pooling; repeat-padding
        # short utterances is the standard speaker-verification treatment and
        # keeps one compile signature for the batched embedder call).
        frames_per_sec = SAMPLE_RATE / FRAME_STEP
        min_frames = max(1, int(self.min_activity * frames_per_sec))
        samples_per_frame = -(-win // Tp)  # frame mask → sample mask upsample
        pairs: List[Tuple[int, int]] = []
        masked: List[np.ndarray] = []
        for w in range(W):
            for c in range(C):
                active = acts[w, :, c] > self.onset
                if int(active.sum()) < min_frames:
                    continue
                mask = np.repeat(active, samples_per_frame)[:win]
                if len(mask) < win:
                    mask = np.pad(mask, (0, win - len(mask)))
                compact = windows[w][mask]
                reps = -(-win // len(compact))
                pairs.append((w, c))
                masked.append(np.tile(compact, reps)[:win])
        if not pairs:
            return []

        embeddings = self.embedder(np.stack(masked))  # (M, D), one batched call
        labels = cluster_speakers(
            embeddings,
            num_speakers=num_speakers,
            min_speakers=min_speakers,
            max_speakers=max_speakers,
            threshold=self.clustering_threshold,
        )
        n_spk = int(labels.max()) + 1

        # -- aggregate each global speaker's activity onto the global grid ----
        # Hamming-weighted overlap average, the same scheme the VAD scorer
        # uses; the denominator counts every window covering a frame so a
        # speaker silent in most windows is not inflated.
        total_frames = (n - FRAME_SIZE) // FRAME_STEP + 1
        acc = np.zeros((n_spk, total_frames))
        wsum = np.zeros(total_frames)
        hamming = np.hamming(Tp)
        for w, s in enumerate(starts):
            f0 = s // FRAME_STEP
            count = min(Tp, total_frames - f0)
            if count <= 0:
                continue
            wsum[f0 : f0 + count] += hamming[:count]
        for (w, c), g in zip(pairs, labels):
            s = starts[w]
            f0 = s // FRAME_STEP
            count = min(Tp, total_frames - f0)
            if count <= 0:
                continue
            acc[g, f0 : f0 + count] += acts[w, :count, c] * hamming[:count]
        scores = acc / np.maximum(wsum, 1e-12)[None, :]
        times = ((np.arange(total_frames) * FRAME_STEP) + FRAME_SIZE / 2) / SAMPLE_RATE

        # -- per-speaker hysteresis binarization → (possibly overlapping) turns
        rows: List[Tuple[float, float, int]] = []
        for g in range(n_spk):
            for turn in binarize(
                scores[g],
                times,
                onset=self.onset,
                offset=self.offset,
                min_duration_on=self.min_duration_on,
                min_duration_off=self.min_duration_off,
            ):
                rows.append((float(turn.start), float(turn.end), g))
        rows.sort(key=lambda r: (r[0], r[2]))
        # Relabel in order of first appearance → stable SPEAKER_00, 01, ...
        remap: dict = {}
        out = []
        for s, e, g in rows:
            if g not in remap:
                remap[g] = len(remap)
            out.append((s, e, remap[g]))
        return out
