from .constants import (
    CHUNK_LENGTH,
    FRAMES_PER_SECOND,
    HOP_LENGTH,
    N_FFT,
    N_FRAMES,
    N_FREQS,
    N_SAMPLES,
    N_SAMPLES_PER_TOKEN,
    SAMPLE_RATE,
    TOKENS_PER_SECOND,
)
from .io import pcm16
from .mel import log_mel_spectrogram, mel_filters

__all__ = [
    "CHUNK_LENGTH",
    "FRAMES_PER_SECOND",
    "HOP_LENGTH",
    "N_FFT",
    "N_FRAMES",
    "N_FREQS",
    "N_SAMPLES",
    "N_SAMPLES_PER_TOKEN",
    "SAMPLE_RATE",
    "TOKENS_PER_SECOND",
    "pcm16",
    "log_mel_spectrogram",
    "mel_filters",
]
