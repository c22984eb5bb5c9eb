"""Audio host helpers (only what the ported path uses so far)."""

from __future__ import annotations

import numpy as np


def pcm16(audio: np.ndarray) -> np.ndarray:
    """float32 [-1, 1] → int16 PCM for half-size device uploads.

    Port of ``whisperx_tpu/audio/io.py:pcm16``. Audio decoded through the
    s16le contract lies exactly on the int16 grid, so this round-trips
    bit-exactly; ``log_mel_spectrogram`` divides integer input by 32768 on
    the device.
    """
    return np.clip(np.round(audio * 32768.0), -32768, 32767).astype(np.int16)
