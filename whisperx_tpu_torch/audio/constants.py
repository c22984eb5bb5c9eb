"""Audio hyperparameters for the Whisper front-end.

Same public contract as the reference front-end (reference:
whisperx/audio.py:13-22): 16 kHz mono audio, 25 ms Hann STFT with 10 ms hop,
30 s chunks of exactly 3000 mel frames. These are properties of the Whisper
model family, not implementation choices, so they are fixed here once and
imported everywhere. A copy of ``whisperx_tpu/audio/constants.py``: the port
keeps its own so it never imports the JAX package (tests hold the two equal).
"""

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30  # seconds per encoder window

N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480_000 samples / 30 s chunk
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000 mel frames / chunk

N_SAMPLES_PER_TOKEN = HOP_LENGTH * 2  # encoder convs downsample time by 2
FRAMES_PER_SECOND = SAMPLE_RATE // HOP_LENGTH  # 100 frames/s (10 ms)
TOKENS_PER_SECOND = SAMPLE_RATE // N_SAMPLES_PER_TOKEN  # 50 tokens/s (20 ms)

# Number of FFT bins kept by a one-sided real FFT of N_FFT points.
N_FREQS = N_FFT // 2 + 1  # 201
