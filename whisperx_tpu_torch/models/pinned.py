"""Pinned external-checkpoint digests and provenance checks.

The reference SHA256-pins exactly one artifact — its VAD segmentation
checkpoint, whose digest is the URL path component
(whisperx/vad.py:18,46-49). This registry extends that contract to every
external checkpoint the converters accept, so the day a real file lands,
``pytest tests/test_real_checkpoints.py`` (env-gated) validates digest →
conversion → torch-forward parity in one command.
"""

from __future__ import annotations

import hashlib
import warnings
from typing import Optional

PINNED: dict[str, Optional[str]] = {
    # pyannote segmentation — serves neural VAD (vad/model.py) and the
    # overlap-aware diarization segmentation stage (diarize/segmentation.py).
    # The digest IS the reference's pinned URL path component
    # (whisperx/vad.py:18,46-49).
    "pyannote-segmentation": (
        "0b5b3216d60a2d32fc086b47ea8c67589aaeb26b7e07fcbe620d6d0b83e209ea"
    ),
    # wespeaker-voxceleb-resnet34-LM — the embedding model inside
    # pyannote/speaker-diarization-3.1 (whisperx/diarize.py:19). The
    # reference never pins this hash (it resolves through the HF hub at
    # runtime) and this offline build cannot compute one; None means
    # trust-on-first-validation: verify_pinned warns with the observed
    # digest, which should then be recorded here.
    "wespeaker-voxceleb-resnet34-LM": None,
    # Whisper HF checkpoints (converter input: models/convert.load_whisper;
    # reference loads the CT2 variants at whisperx/asr.py:288). HF weight
    # files have no vendor-published digest reachable from this offline
    # build, so these start as trust-on-first-validation: the loader (with
    # WHISPERX_VERIFY_CKPT=1) and tests/test_real_checkpoints.py warn with
    # the observed sha256 of the primary weights file — record it here.
    "whisper-tiny": None,
    "whisper-tiny.en": None,
    "whisper-base": None,
    "whisper-base.en": None,
    "whisper-small": None,
    "whisper-small.en": None,
    "whisper-medium": None,
    "whisper-medium.en": None,
    "whisper-large-v2": None,
    "whisper-large-v3": None,
    # wav2vec2 CTC checkpoints (converter input: load_wav2vec2; the
    # reference's default English aligner, whisperx/alignment.py:26).
    "wav2vec2-base-960h": None,
    "wav2vec2-large-960h-lv60-self": None,
}


def pinned_key_for(name_or_path: str) -> Optional[str]:
    """Map a checkpoint name/hub-id/local dir to its registry key.

    "openai/whisper-large-v2", "/ckpts/whisper-large-v2", "large-v2" →
    "whisper-large-v2"; "facebook/wav2vec2-base-960h" → "wav2vec2-base-960h".
    Returns None when the basename matches no known family (custom/finetuned
    checkpoints are intentionally unregistered).
    """
    import os
    import re

    base = os.path.basename(os.path.normpath(name_or_path)).lower()
    if base in PINNED:
        return base
    m = re.fullmatch(r"(?:whisper-)?((?:tiny|base|small|medium)(?:\.en)?|large-v\d)", base)
    if m and f"whisper-{m.group(1)}" in PINNED:
        return f"whisper-{m.group(1)}"
    return None


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def verify_pinned(name: str, path: str, *, strict: bool = True) -> str:
    """Check ``path`` against the registry entry ``name``; return the digest.

    - pinned digest present + mismatch → raise (strict) or warn;
    - no pinned digest yet → warn with the observed digest so it can be
      recorded in ``PINNED``.
    """
    expected = PINNED.get(name)
    digest = file_sha256(path)
    if expected is None:
        warnings.warn(
            f"checkpoint {name!r} has no pinned digest yet; observed sha256 "
            f"{digest} for {path} — record it in models/pinned.py."
        )
    elif digest != expected:
        msg = (
            f"checkpoint {name!r} SHA256 mismatch for {path}: got {digest}, "
            f"expected {expected}."
        )
        if strict:
            raise RuntimeError(msg)
        warnings.warn(msg + " Proceeding with custom weights.")
    return digest
