"""whisperx_tpu_torch ``log_mel_kernel`` (its CPU route, the plain version)
against the JAX package's ``log_mel_pallas`` in interpret mode, at the
tolerance of ``tests/test_pallas_mel.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperx_tpu.audio import N_SAMPLES
from whisperx_tpu.ops.pallas_mel import log_mel_pallas
from whisperx_tpu_torch.audio import log_mel_spectrogram, pcm16
from whisperx_tpu_torch.ops import mel

torch.set_num_threads(2)


@pytest.fixture
def audio():
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((2, N_SAMPLES)) * 0.2).astype(np.float32)
    a[0] += 0.4 * np.sin(2 * np.pi * 330 * np.arange(N_SAMPLES) / 16000).astype(np.float32)
    return a


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_kernel_route_matches_pallas(audio, n_mels):
    want = np.asarray(log_mel_pallas(jnp.asarray(audio), n_mels=n_mels, interpret=True))
    before = mel.launches
    got = mel.log_mel_kernel(audio, n_mels, device="cpu")
    assert mel.launches == before  # CPU: the plain version, no launch
    assert got.shape == want.shape == (2, n_mels, 3000) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=1e-4)


def test_int16_is_divided_like_the_decode_front_end(audio):
    """int16 PCM is divided by 32768 (as audio/mel.py does); log_mel_pallas
    casts int16 without dividing, so it is fed the divided float audio."""
    pcm = pcm16(audio)
    got = mel.log_mel_kernel(pcm, 80, device="cpu")
    torch.testing.assert_close(got, log_mel_spectrogram(pcm, 80, device="cpu"), atol=0, rtol=0)
    want = np.asarray(log_mel_pallas(jnp.asarray(pcm.astype(np.float32) / 32768.0), n_mels=80, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=1e-4)


def test_single_row_and_short_clip(audio):
    row = mel.log_mel_kernel(audio[1], 80, device="cpu")
    assert row.shape == (80, 3000)
    torch.testing.assert_close(row, mel.log_mel_kernel(audio, 80, device="cpu")[1], atol=1e-5, rtol=0)
    short = audio[:, :16000]  # 1 s: 100 frames, not a multiple of the Pallas kernel's 120-frame tile
    got = mel.log_mel_kernel(short, 128, device="cpu")
    assert got.shape == (2, 128, 100)
    torch.testing.assert_close(got, log_mel_spectrogram(short, 128, device="cpu"), atol=0, rtol=0)


def test_contract(monkeypatch):
    with pytest.raises(ValueError, match="n % 160"):
        mel.log_mel_kernel(np.zeros((2, 1000), np.float32), device="cpu")
    with pytest.raises(ValueError, match="n > 200"):
        mel.log_mel_kernel(np.zeros((2, 160), np.float32), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mel.log_mel_kernel(np.zeros(1600, np.float32))
