"""whisperx_tpu_torch ``log_mel_kernel`` (its CPU route, the plain version)
against the JAX package's ``log_mel_pallas`` in interpret mode, at the
tolerance of ``tests/test_pallas_mel.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from whisperx_tpu.audio import N_SAMPLES
from whisperx_tpu.ops.pallas_mel import log_mel_pallas
from whisperx_tpu_torch.audio import log_mel_spectrogram, mel_filters, pcm16
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


@pytest.mark.parametrize("n_mels", [80, 128])
def test_kernel_band_table_rebuilds_the_filterbank(n_mels):
    """The (start, length, taps) table the kernel reads gives back
    mel_filters(n_mels) exactly."""
    band, taps = mel.mel_bands(n_mels)
    filt = mel_filters(n_mels)
    rebuilt = np.zeros_like(filt)
    for m, (start, length) in enumerate(band.T):
        assert 1 <= length <= mel.MAX_TAPS and not taps[m, length:].any()
        rebuilt[m, start : start + length] = taps[m, :length]
    np.testing.assert_array_equal(rebuilt, filt)


def _fft_log_mel(audio, n_mels):
    """The kernel's algorithm in torch, fed the wrapper's own tables: the
    windowed frames through a 20 x 20 Cooley-Tukey real DFT (real DFT-20s over
    n1, the twiddles, complex DFT-20s over n2), power, the banded filterbank,
    log10 and the per-row clip."""
    dft20, tables = (torch.from_numpy(t) for t in mel.fft_tables())
    band, taps = (torch.from_numpy(t) for t in mel.mel_bands(n_mels))
    r = mel.FFT_RADIX
    x = torch.as_tensor(audio).float()
    B, n = x.shape
    n_frames = n // 160
    frames = F.pad(x[:, None], (200, 200), mode="reflect")[:, 0].unfold(-1, 400, 160)[:, :n_frames]
    hann, twr, twi = tables[:400], tables[400:800].reshape(r, r).T, tables[800:].reshape(r, r).T  # [n2][k1]
    xs = (frames * hann).reshape(B, n_frames, r, r)  # [n1][n2]: t = 20 n1 + n2
    idx = torch.outer(torch.arange(r), torch.arange(r // 2 + 1)) % r  # (n1 or n2, k1 or k2)
    cos, sin = dft20[0][idx], dft20[1][idx]
    yr = torch.einsum("btin,ik->btnk", xs, cos)  # (B, T, n2, k1 = 0..10)
    yi = -torch.einsum("btin,ik->btnk", xs, sin)
    ar = torch.cat([yr, yr[..., 1 : r // 2].flip(-1)], dim=-1)  # k1 = 11..19 by conjugate symmetry
    ai = torch.cat([yi, -yi[..., 1 : r // 2].flip(-1)], dim=-1)
    zr, zi = ar * twr - ai * twi, ar * twi + ai * twr
    xr = torch.einsum("btnk,nq->btkq", zr, cos) + torch.einsum("btnk,nq->btkq", zi, sin)  # (B, T, k1, k2)
    xi = torch.einsum("btnk,nq->btkq", zi, cos) - torch.einsum("btnk,nq->btkq", zr, sin)
    power = (xr**2 + xi**2).transpose(2, 3).reshape(B, n_frames, -1)[..., :201]  # bin k1 + 20 k2
    cols = (band[0][:, None] + torch.arange(mel.MAX_TAPS)).clamp(max=200)
    mels = (power[..., cols] * taps).sum(-1).transpose(1, 2)  # (B, n_mels, T)
    lg = torch.log10(torch.clamp(mels, min=1e-10))
    lg = torch.maximum(lg, lg.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (lg + 4.0) / 4.0


@pytest.mark.parametrize("n_mels", [80, 128])
def test_kernel_fft_factorization_matches_plain_and_pallas(audio, n_mels):
    got = _fft_log_mel(audio, n_mels)
    torch.testing.assert_close(got, log_mel_spectrogram(audio, n_mels, device="cpu"), atol=1e-4, rtol=0)
    want = np.asarray(log_mel_pallas(jnp.asarray(audio), n_mels=n_mels, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=1e-4)


def test_kernel_fft_tables():
    """The DFT-20 coefficients and twiddles are the float32 roundings of
    their float64 values, with exact zeros where the value is zero."""
    dft20, tables = mel.fft_tables()
    assert dft20.dtype == tables.dtype == np.float32 and tables.shape == (1200,)
    assert dft20[1, 0] == dft20[1, 10] == dft20[0, 5] == dft20[0, 15] == 0.0
    k1, n2 = np.meshgrid(np.arange(20), np.arange(20), indexing="ij")
    tw = tables[400:800] + 1j * tables[800:]
    np.testing.assert_allclose(tw, np.exp(-2j * np.pi * (n2 * k1).ravel() / 400), atol=6e-8, rtol=0)
