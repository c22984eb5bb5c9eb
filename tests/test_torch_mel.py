"""whisperx_tpu_torch log-mel front-end against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperx_tpu.audio.mel import _dft_basis as j_basis
from whisperx_tpu.audio.mel import log_mel_spectrogram as j_log_mel
from whisperx_tpu.audio.mel import mel_filters as j_filters
from whisperx_tpu_torch.audio import log_mel_spectrogram, mel_filters, pcm16
from whisperx_tpu_torch.audio.mel import _dft_basis

torch.set_num_threads(2)


def _audio(batch, seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    tone = 0.3 * np.sin(2 * np.pi * 440.0 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t))
    return (tone[None, :] + 0.05 * rng.standard_normal((batch, t.size))).astype(np.float32)


def test_tables_equal():
    for n_mels in (80, 128):
        np.testing.assert_array_equal(mel_filters(n_mels), j_filters(n_mels))
    np.testing.assert_array_equal(_dft_basis(), j_basis())


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("int16", [False, True])
def test_log_mel_matches_jax(n_mels, int16):
    audio = _audio(2, 4.0)
    if int16:
        audio = pcm16(audio)
    want = np.asarray(j_log_mel(jnp.asarray(audio), n_mels=n_mels))
    got = log_mel_spectrogram(audio, n_mels=n_mels, device="cpu").numpy()
    assert got.shape == want.shape == (2, n_mels, 400)
    # fp32 sums in another order; the log10 output is O(1).
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_log_mel_unbatched_and_padding():
    audio = _audio(1, 1.0, seed=3)[0]
    want = np.asarray(j_log_mel(jnp.asarray(audio), n_mels=80, padding=480))
    got = log_mel_spectrogram(torch.from_numpy(audio), n_mels=80, padding=480, device="cpu").numpy()
    assert got.shape == want.shape == (80, 103)
    np.testing.assert_allclose(got, want, atol=1e-4)
