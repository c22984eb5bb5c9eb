"""Speaker diarization pipeline.

Port of ``whisperx_tpu/diarize/pipeline.py``. API parity with the reference
wrapper (whisperx/diarize.py:10-32): callable on audio (path or waveform),
honors num/min/max_speakers, and returns a pandas DataFrame with
``segment``/``label``/``speaker``/``start``/``end`` columns — drop-in for
``assign_word_speakers``.

Two modes:

- **Overlap-aware** (the reference's pyannote-3.1 architecture,
  whisperx/diarize.py:19,28): with a segmentation model — either
  ``segmentation_checkpoint`` (converted pyannote PyanNet weights) or an
  injected ``segmentation`` scorer — local per-speaker activities are
  computed in sliding windows, masked embeddings are clustered globally, and
  per-speaker binarization emits turns that MAY overlap (two simultaneous
  speakers both appear). See ``diarize/segmentation.py``.
- **VAD-window fallback** (no segmentation model): speech turns from the VAD
  scorer are cut into 1.5 s / 0.75 s windows, embedded in one batch, and
  clustered; adjacent same-speaker windows merge into turns. Cannot emit
  overlapping speakers.

The networks run on ``device`` (``None`` means the card; pass ``"cpu"`` for
the CPU), or on the rank's device of ``mesh``, whose "data" axis the window
batches split over. A checkpoint that does not load raises: it never falls back to the
weight-free scorers. The agglomerative cosine-distance threshold used when
the speaker count is unknown is ``clustering_threshold`` (default 0.7).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from ..audio.constants import SAMPLE_RATE
from ..audio.io import load_audio
from ..device import DeviceLike, resolve_device
from ..parallel.mesh import mesh_device
from ..vad.model import EnergyVAD, VadPipeline, load_vad_model
from .assign import Segment
from .cluster import cluster_speakers
from .embed import MelStatsEmbedding


def _turns_dataframe(rows):
    """[(start, end, int label)] → the reference's diarization DataFrame."""
    import pandas as pd

    return pd.DataFrame(
        {
            "segment": [Segment(s, e) for s, e, _ in rows],
            "label": [f"SPEAKER_{l:02d}" for _, _, l in rows],
            "speaker": [f"SPEAKER_{l:02d}" for _, _, l in rows],
            "start": [s for s, _, _ in rows],
            "end": [e for _, e, _ in rows],
        }
    )


class DiarizationPipeline:
    def __init__(
        self,
        model_name: str = "resnet34",
        use_auth_token=None,
        device: DeviceLike = None,
        *,
        embedder=None,
        vad: Optional[VadPipeline] = None,
        vad_checkpoint: Optional[str] = None,
        window: float = 1.5,
        step: float = 0.75,
        checkpoint: Optional[str] = None,
        segmentation=None,
        segmentation_checkpoint: Optional[str] = None,
        clustering_threshold: float = 0.7,
        mesh=None,
    ):
        self.device = mesh_device(mesh) if mesh is not None else resolve_device(device)
        if embedder is None:
            if checkpoint:
                # WeSpeaker ResNet34 (the embedding model inside the
                # reference's pyannote/speaker-diarization-3.1,
                # whisperx/diarize.py:19).
                import os

                from ..models.convert import load_wespeaker_resnet34
                from ..models.pinned import verify_pinned
                from .embed import NeuralSpeakerEmbedding

                if os.path.isfile(checkpoint):
                    verify_pinned(
                        "wespeaker-voxceleb-resnet34-LM", checkpoint, strict=False
                    )
                embedder = NeuralSpeakerEmbedding(load_wespeaker_resnet34(checkpoint, device=self.device))
            else:
                embedder = MelStatsEmbedding(self.device)
        self.embedder = embedder
        if vad is None:
            if vad_checkpoint:
                vad = load_vad_model(self.device, checkpoint=vad_checkpoint)
            else:
                vad = VadPipeline(EnergyVAD())
        self.vad = vad
        self.window = window
        self.step = step
        self.clustering_threshold = clustering_threshold

        # Overlap-aware segmentation stage (pyannote-3.1 architecture).
        if segmentation is None and segmentation_checkpoint:
            import os

            from ..models.convert import load_pyannet_vad
            from ..vad.model import verify_checkpoint_sha256
            from .segmentation import NeuralSegmentation

            if os.path.isfile(segmentation_checkpoint):
                verify_checkpoint_sha256(segmentation_checkpoint, None)
            segmentation = NeuralSegmentation(load_pyannet_vad(segmentation_checkpoint, device=self.device))
        self.segmentation = segmentation
        # Data-parallel mesh (parallel.make_mesh): window batches of the
        # embedder and the segmentation scorer split over the "data" axis
        # and are gathered back (the reference's pyannote pipeline is
        # strictly single-device, whisperx/diarize.py:19).
        self.mesh = mesh
        if mesh is not None:
            for stage in (self.embedder, self.segmentation):
                if stage is not None and hasattr(stage, "mesh"):
                    stage.mesh = mesh
        self._overlap = None
        if segmentation is not None:
            from .segmentation import OverlapDiarizer

            self._overlap = OverlapDiarizer(
                segmentation,
                self.embedder,
                onset=self.vad.onset,
                offset=self.vad.offset,
                clustering_threshold=clustering_threshold,
            )

    def _windows(self, audio: np.ndarray):
        win = int(self.window * SAMPLE_RATE)
        hop = int(self.step * SAMPLE_RATE)
        spans = []
        for turn in self.vad.speech_turns(audio):
            s = max(0, int(turn.start * SAMPLE_RATE))
            e = min(len(audio), int(turn.end * SAMPLE_RATE))
            if e - s < win // 3:  # skip sub-0.5s slivers
                continue
            pos = s
            while pos < e:
                spans.append((pos, min(pos + win, e)))
                if pos + win >= e:
                    break
                pos += hop
        return spans, win

    def __call__(
        self,
        audio: Union[str, np.ndarray],
        num_speakers: Optional[int] = None,
        min_speakers: Optional[int] = None,
        max_speakers: Optional[int] = None,
    ):
        import time as _time

        import pandas as pd

        from ..utils import telemetry

        _t0 = _time.perf_counter()
        if isinstance(audio, str):
            audio = load_audio(audio)
        audio = np.asarray(audio, dtype=np.float32).reshape(-1)

        if self._overlap is not None:
            rows = self._overlap(
                audio,
                num_speakers=num_speakers,
                min_speakers=min_speakers,
                max_speakers=max_speakers,
            )
            df = _turns_dataframe(rows)
            telemetry.GLOBAL.record(
                "diarize",
                seconds=_time.perf_counter() - _t0,
                audio_seconds=len(audio) / SAMPLE_RATE,
            )
            return df

        spans, win = self._windows(audio)
        if not spans:
            telemetry.GLOBAL.record(
                "diarize",
                seconds=_time.perf_counter() - _t0,
                audio_seconds=len(audio) / SAMPLE_RATE,
            )
            return pd.DataFrame(columns=["segment", "label", "speaker", "start", "end"])

        wavs = np.zeros((len(spans), win), np.float32)
        for i, (s, e) in enumerate(spans):
            wavs[i, : e - s] = audio[s:e]
        embeddings = self.embedder(wavs)
        labels = cluster_speakers(
            embeddings,
            num_speakers=num_speakers,
            min_speakers=min_speakers,
            max_speakers=max_speakers,
            threshold=self.clustering_threshold,
        )

        # Merge adjacent same-speaker windows into speaker turns.
        rows = []
        cur_label, cur_start, cur_end = None, None, None
        for (s, e), lab in zip(spans, labels):
            t0, t1 = s / SAMPLE_RATE, e / SAMPLE_RATE
            if lab == cur_label and t0 <= cur_end + self.step:
                cur_end = max(cur_end, t1)
            else:
                if cur_label is not None:
                    rows.append((cur_start, cur_end, int(cur_label)))
                cur_label, cur_start, cur_end = lab, t0, t1
        if cur_label is not None:
            rows.append((cur_start, cur_end, int(cur_label)))

        df = _turns_dataframe(rows)
        telemetry.GLOBAL.record(
            "diarize",
            seconds=_time.perf_counter() - _t0,
            audio_seconds=len(audio) / SAMPLE_RATE,
        )
        return df
