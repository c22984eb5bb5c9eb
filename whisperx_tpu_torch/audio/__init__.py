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
from .io import load_audio, pad_or_trim, pcm16, resample, write_wav
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
    "load_audio",
    "pad_or_trim",
    "pcm16",
    "resample",
    "write_wav",
    "log_mel_spectrogram",
    "mel_filters",
]
