"""whisperx_tpu_torch encoder self-attention against the JAX package's:
``_naive`` against JAX ``_naive``, and the flash kernel's plain version (what
the wrapper runs on CPU tensors) against JAX ``_naive`` and the stock Pallas
flash kernel in interpret mode, at the tolerance of ``tests/test_attention.py``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperx_tpu.ops import attention as ja
from whisperx_tpu_torch.models import whisper as tw
from whisperx_tpu_torch.models.configs import TEST_CONFIG
from whisperx_tpu_torch.models.convert import whisper_from_jax
from whisperx_tpu_torch.ops import attention as ta
from whisperx_tpu_torch.ops import flash_attn

torch.set_num_threads(2)


def _qkv(B, T, H, Dh, seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, T, H, Dh)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((B, T, H, Dh)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((B, T, H, Dh)) * 0.5).astype(np.float32)
    return q, k, v


def _mask(B, T, lengths):
    return (np.arange(T)[None, :] < np.asarray(lengths)[:, None])


@pytest.mark.parametrize("T", [512, 200])
@pytest.mark.parametrize("masked", [False, True])
def test_naive_matches_jax_naive(T, masked):
    q, k, v = _qkv(2, T, 2, 64, seed=T)
    mask = _mask(2, T, [T, T // 3]) if masked else None
    want = np.asarray(ja._naive(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None if mask is None else jnp.asarray(mask), -1e9))
    got = ta._naive(*map(torch.from_numpy, (q, k, v)), None if mask is None else torch.from_numpy(mask), -1e9)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("T", [512, 200])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_plain_matches_jax_naive_and_pallas_flash(T, masked):
    """bf16 inputs (the kernel's type) on both sides; the port's flash route
    on CPU tensors is the kernel's plain version."""
    q, k, v = _qkv(2, T, 2, 64, seed=T + 1)
    mask = _mask(2, T, [T, 77]) if masked else None
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    jmask = None if mask is None else jnp.asarray(mask)
    naive = np.asarray(ja._naive(jq.astype(jnp.float32), jk.astype(jnp.float32), jv.astype(jnp.float32), jmask, -1e9))
    pallas = np.asarray(ja.fused_self_attention(jq, jk, jv, jmask, impl="flash", interpret=True).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    before = flash_attn.launches
    got = ta.fused_self_attention(tq, tk, tv, None if mask is None else torch.from_numpy(mask), impl="flash")
    assert got.dtype == torch.bfloat16 and flash_attn.launches == before  # CPU: no launch
    got = got.float().numpy()
    np.testing.assert_allclose(got, naive, atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(got, pallas, atol=2e-3, rtol=2e-3)


def test_resolve_attn_impl_matches_jax(monkeypatch):
    monkeypatch.delenv("WHISPERX_ATTN", raising=False)
    for impl in ("auto", "xla", "flash"):
        assert ta.resolve_attn_impl(impl) == ja.resolve_attn_impl(impl)
    assert ta.resolve_attn_impl() == "xla"
    with pytest.raises(ValueError, match="unknown attention impl"):
        ta.resolve_attn_impl("pallas")
    for env in ("flash", "xla"):
        monkeypatch.setenv("WHISPERX_ATTN", env)
        for impl in ("auto", "xla", "flash"):
            assert ta.resolve_attn_impl(impl) == ja.resolve_attn_impl(impl) == env


def test_flash_contract():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 2, 64, seed=0))
    with pytest.raises(TypeError, match="bf16"):
        flash_attn.flash_attention(q, k, v)
    q32, k32, v32 = (torch.from_numpy(x).bfloat16() for x in _qkv(1, 8, 2, 32, seed=0))
    with pytest.raises(ValueError, match="head dim 32"):
        flash_attn.flash_attention(q32, k32, v32)
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    with pytest.raises(ValueError, match="pad_mask"):
        flash_attn.flash_attention(qb, kb, vb, torch.ones(1, 7, dtype=torch.bool))
    # A row whose keys are all excluded gets zeros (the kernel's contract).
    out = flash_attn.flash_attention(qb, kb, vb, torch.zeros(1, 8, dtype=torch.bool))
    assert torch.equal(out, torch.zeros_like(out))


def test_set_attn_impl_and_whisper_encoder_flash():
    """The Whisper encoder at bf16 through the flash route stays within bf16
    noise of its "xla" route (same weights, same mel)."""
    cfg = dataclasses.replace(TEST_CONFIG, n_text_state=128, n_audio_state=128, n_text_head=2, n_audio_head=2)
    params = tw.random_params(cfg, seed=0, scale=0.05)
    model = whisper_from_jax(params, cfg, dtype=torch.bfloat16, attn_impl="flash", device="cpu")
    assert model.encoder.layers[0].attn.attn_impl == "flash"
    mel = torch.from_numpy((np.random.default_rng(0).standard_normal((2, cfg.n_mels, 3000)) * 0.5).astype(np.float32))
    with torch.no_grad():
        flash = model.encode(mel).float()
        ta.set_attn_impl(model, "xla")
        assert all(m.attn_impl == "xla" for m in model.modules() if hasattr(m, "attn_impl"))
        xla = model.encode(mel).float()
    assert torch.isfinite(flash).all()
    # Two bf16 layers apart in where the weights are rounded: a few bf16 ulps.
    torch.testing.assert_close(flash, xla, atol=0.1, rtol=0.05)
    assert (flash - xla).abs().mean() < 0.01
    with pytest.raises(ValueError):
        ta.set_attn_impl(model, "pallas")
