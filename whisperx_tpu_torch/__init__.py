"""PyTorch/CUDA port of ``whisperx_tpu`` for NVIDIA Hopper (H100).

The public API is the JAX package's (reference: whisperx/__init__.py):

    import whisperx_tpu_torch as whisperx
    model = whisperx.load_model("large-v2", compute_type="int8")
    audio = whisperx.load_audio("audio.wav")
    result = model.transcribe(audio, batch_size=8)
    align_model, metadata = whisperx.load_align_model(result["language"])
    result = whisperx.align(result["segments"], align_model, metadata, audio)
    diarize = whisperx.DiarizationPipeline()
    result = whisperx.assign_word_speakers(diarize(audio), result)

The command line is ``python -m whisperx_tpu_torch <audio> ...`` (``cli.py``).
The package mirrors the JAX package's layout (``audio/``, ``io/``,
``models/``, ``decode/``, ``align/``, ``vad/``, ``diarize/``, ``pipeline/``,
``native/``, ``ops/``, ``utils/``) so each module's counterpart is easy to
find. It imports ``torch`` and never ``jax``, ``flax`` or ``whisperx_tpu``;
framework-free modules are carried as copies.

Every Pallas kernel of the JAX package is a hand-written CUDA C++ kernel
under ``csrc/``, built with ``nvcc`` for ``sm_90a`` on first use
(``ops/_build.py``). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU each kernel wrapper runs its plain PyTorch
version.
"""

from .align.alignment import AlignJob, align, align_begin, load_align_model
from .audio.io import load_audio
from .device import resolve_device
from .diarize.assign import assign_word_speakers
from .diarize.pipeline import DiarizationPipeline
from .pipeline.asr import load_model

__all__ = [
    "AlignJob",
    "DiarizationPipeline",
    "align",
    "align_begin",
    "assign_word_speakers",
    "load_align_model",
    "load_audio",
    "load_model",
    "resolve_device",
]
