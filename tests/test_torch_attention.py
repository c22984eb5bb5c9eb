"""whisperx_tpu_torch encoder self-attention against the JAX package's:
``_naive`` against JAX ``_naive``, and the flash kernel's plain version (what
the wrapper runs on CPU tensors) against JAX ``_naive`` and the stock Pallas
flash kernel in interpret mode, at the tolerance of ``tests/test_attention.py``."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_routes import force_routes
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
def test_flash_plain_matches_jax_naive_and_pallas_flash(monkeypatch, T, masked):
    """bf16 inputs (the kernel's type) on both sides; the port's flash route
    on CPU tensors is the kernel's plain version."""
    force_routes(monkeypatch, attn="flash")
    q, k, v = _qkv(2, T, 2, 64, seed=T + 1)
    mask = _mask(2, T, [T, 77]) if masked else None
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    jmask = None if mask is None else jnp.asarray(mask)
    naive = np.asarray(ja._naive(jq.astype(jnp.float32), jk.astype(jnp.float32), jv.astype(jnp.float32), jmask, -1e9))
    pallas = np.asarray(ja.fused_self_attention(jq, jk, jv, jmask, impl="flash", interpret=True).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    before = flash_attn.launches
    got = ta.fused_self_attention(tq, tk, tv, None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16 and flash_attn.launches == before  # CPU: no launch
    got = got.float().numpy()
    np.testing.assert_allclose(got, naive, atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(got, pallas, atol=2e-3, rtol=2e-3)


def test_resolve_attn_impl_matches_jax(monkeypatch):
    """On CPU tensors the port's rule gives the JAX package's default route,
    "xla". ``WHISPERX_ATTN`` moves the JAX package's route and not the
    port's, which reads no variable."""
    monkeypatch.delenv("WHISPERX_ATTN", raising=False)
    for facts in ((torch.device("cpu"), torch.bfloat16, 64), (torch.device("cpu"), torch.float32, 64)):
        assert ta.resolve_attn_impl(*facts) == ja.resolve_attn_impl("auto") == "xla"
    for env in ("flash", "xla"):
        monkeypatch.setenv("WHISPERX_ATTN", env)
        assert ja.resolve_attn_impl("auto") == env
        assert ta.resolve_attn_impl(torch.device("cpu"), torch.bfloat16, 64) == "xla"


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


def test_set_attn_impl_and_whisper_encoder_flash(monkeypatch):
    """The Whisper encoder at bf16 through the flash route stays within bf16
    noise of its "xla" route (same weights, same mel), each forced through
    the tests' seam; no model option picks the route."""
    cfg = dataclasses.replace(TEST_CONFIG, n_text_state=128, n_audio_state=128, n_text_head=2, n_audio_head=2)
    params = tw.random_params(cfg, seed=0, scale=0.05)
    model = whisper_from_jax(params, cfg, dtype=torch.bfloat16, device="cpu")
    mel = torch.from_numpy((np.random.default_rng(0).standard_normal((2, cfg.n_mels, 3000)) * 0.5).astype(np.float32))
    with torch.no_grad():
        force_routes(monkeypatch, attn="flash")
        flash = model.encode(mel).float()
        force_routes(monkeypatch, attn="xla")
        xla = model.encode(mel).float()
    assert torch.isfinite(flash).all()
    # Two bf16 layers apart in where the weights are rounded: a few bf16 ulps.
    torch.testing.assert_close(flash, xla, atol=0.1, rtol=0.05)
    assert (flash - xla).abs().mean() < 0.01
    with pytest.raises(ValueError, match="attn_impl"):
        tw.Whisper(cfg, dtype=torch.bfloat16, attn_impl="flash", device="cpu")


# ---- gradients (training): the stock kernel's custom_vjp against the port's ----

# T 100 and 300 (not multiples of the stock kernel's 128-row blocks), with
# and without a pad mask; the last case holds a batch row with no valid key.
GRAD_CASES = [(100, None), (100, (100, 37)), (300, None), (300, (300, 211)), (100, (100, 0))]


def _grad_inputs(T, lengths, seed):
    q, k, v = _qkv(2, T, 2, 64, seed=seed)
    dout = np.random.default_rng(seed + 1).standard_normal((2, T, 2, 64)).astype(np.float32)
    mask = None if lengths is None else _mask(2, T, lengths)
    return q, k, v, dout, mask


def _port_grads(q, k, v, dout, mask):
    tq, tk, tv = (torch.from_numpy(x).bfloat16().requires_grad_() for x in (q, k, v))
    out = ta.fused_self_attention(tq, tk, tv, None if mask is None else torch.from_numpy(mask))
    out.backward(torch.from_numpy(dout).bfloat16())
    return out, tuple(t.grad for t in (tq, tk, tv))


@pytest.mark.parametrize("T,lengths", GRAD_CASES)
def test_flash_grads_match_jax_stock_kernels(monkeypatch, T, lengths):
    """bf16 ``jax.grad`` through the stock flash kernel (its forward with
    residuals and both backward kernels, interpreted) against the port's
    autograd through ``FlashAttention`` (the plain versions on the CPU).

    Tolerance: one bf16 ulp of the largest gradient, 2**-7 relative — both
    sides sum in fp32 and round bf16(P) and bf16(dS) alike, so they differ by
    a rounding of the outputs (measured: at most one ulp). A batch row with no
    valid key is the known difference of ``ROADMAP.md`` §3: the stock kernel
    spreads its weight evenly over every key, the port's kernels give zeros,
    so that row is held to zero instead."""
    from jax.experimental.pallas import tpu as pltpu

    q, k, v, dout, mask = _grad_inputs(T, lengths, seed=T + (lengths is not None))
    jmask = None if mask is None else jnp.asarray(mask)
    jdout = jnp.asarray(dout, jnp.bfloat16).astype(jnp.float32)

    def loss(q, k, v):
        out = ja.fused_self_attention(q, k, v, jmask, impl="flash", interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jdout)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    before = (flash_attn.launches, flash_attn.launches_bwd_dq, flash_attn.launches_bwd_dkv)
    force_routes(monkeypatch, attn="flash")
    _, got = _port_grads(q, k, v, dout, mask)
    assert (flash_attn.launches, flash_attn.launches_bwd_dq, flash_attn.launches_bwd_dkv) == before  # CPU: no launch
    rows = [b for b in range(2) if mask is None or mask[b].any()]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g[rows], w[rows], atol=2**-8 * np.abs(w).max(), rtol=2**-7, err_msg=name)
        assert not np.any(np.delete(g, rows, axis=0)), f"{name}: a row with no valid key must get zero gradients"


@pytest.mark.parametrize("T,lengths", [(100, None), (300, (300, 211))])
def test_flash_backward_plain_matches_fp32_naive_autograd(T, lengths):
    """The plain backward against float64 autograd of ``_naive`` on the same
    bf16 values: the bf16 rounding of P, dS and the outputs is all that
    parts them (a few bf16 ulps of the largest gradient)."""
    q, k, v, dout, mask = _grad_inputs(T, lengths, seed=7 * T)
    qb, kb, vb, db = (torch.from_numpy(x).bfloat16() for x in (q, k, v, dout))
    tmask = None if mask is None else torch.from_numpy(mask)
    out, lse = flash_attn.flash_attention_fwd_plain(qb, kb, vb, tmask)
    got = flash_attn.flash_attention_backward_plain(qb, kb, vb, out, lse, db, tmask)
    ref_in = [t.double().requires_grad_() for t in (qb, kb, vb)]
    ta._naive(*ref_in, tmask, -1e9).backward(db.double())
    for name, g, r in zip(("dq", "dk", "dv"), got, ref_in):
        want = r.grad.float()
        torch.testing.assert_close(g.float(), want, atol=2**-6 * want.abs().max().item(), rtol=2**-6, msg=name)


@pytest.mark.parametrize("lengths", [None, (300, 211), (300, 0)])
def test_flash_lse_matches_float64_logsumexp(lengths):
    """lse = m + ln(l) of the plain forward against a float64 logsumexp over
    the valid keys (fp32 sums: within 1e-5); -inf for a row without one."""
    q, k, v, _, mask = _grad_inputs(300, lengths, seed=5)
    qb, kb, vb = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    _, lse = flash_attn.flash_attention_fwd_plain(qb, kb, vb, tmask)
    s = torch.einsum("bthd,bshd->bhts", qb.double(), kb.double())
    if tmask is not None:
        s = s.masked_fill(~tmask[:, None, None, :], float("-inf"))
    want = torch.logsumexp(s, dim=-1)
    assert lse.shape == (2, 2, 300) and lse.dtype == torch.float32
    finite = torch.isfinite(want)
    torch.testing.assert_close(lse.double()[finite], want[finite], atol=1e-5, rtol=1e-6)
    assert torch.equal(torch.isinf(lse), ~finite)


def test_flash_takes_lse_only_under_grad():
    """Without grad the wrapper returns the forward alone (no autograd
    node); with an input that requires grad it goes through FlashAttention,
    whose output equals the plain forward's."""
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(1, 70, 2, 64, seed=3))
    plain = flash_attn.flash_attention(q, k, v)
    assert plain.grad_fn is None
    with torch.no_grad():
        assert flash_attn.flash_attention(q, k, v.requires_grad_()).grad_fn is None
    out = flash_attn.flash_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert torch.equal(out.detach(), plain)


def test_matmul_f32_gradient_is_fp32_product():
    """``matmul_f32``'s gradient (the CPU route's autograd; the CUDA route's
    ``_BmmF32`` computes the same products): the fp32 gradient times the
    other operand in fp32, rounded to each operand's bf16."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((3, 5, 64)).astype(np.float32)).bfloat16().requires_grad_()
    b = torch.from_numpy(rng.standard_normal((3, 64, 7)).astype(np.float32)).bfloat16().requires_grad_()
    g = torch.from_numpy(rng.standard_normal((3, 5, 7)).astype(np.float32))
    out = ta.matmul_f32(a, b)
    assert out.dtype == torch.float32
    out.backward(g)
    assert torch.equal(a.grad, torch.bmm(g, b.detach().float().transpose(1, 2)).bfloat16())
    assert torch.equal(b.grad, torch.bmm(a.detach().float().transpose(1, 2), g).bfloat16())
    # The CUDA route's Function on CPU tensors (its backward has no
    # device-specific op): the same gradients.
    ctx = types.SimpleNamespace(saved_tensors=(a.detach(), b.detach()), needs_input_grad=(True, True))
    da, db = ta._BmmF32.backward(ctx, g)
    assert torch.equal(da, a.grad) and torch.equal(db, b.grad)


def test_flash_backward_kernel_wrappers_never_fall_back():
    """The dQ and dK/dV wrappers launch their kernels or raise: CPU tensors
    (and operands outside the contract) are refused, never computed another
    way. ``flash_attention_backward`` takes the plain version on the CPU."""
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(1, 70, 2, 64, seed=4))
    out, lse = flash_attn.flash_attention_fwd_plain(q, k, v)
    with pytest.raises(ValueError, match="contract"):
        flash_attn.flash_attention_bwd_dq(q, k, v, out, out, lse)
    with pytest.raises(ValueError, match="contract"):
        flash_attn.flash_attention_bwd_dkv(q, k, v, out, lse, lse)
    with pytest.raises(TypeError, match="bf16"):
        flash_attn.flash_attention_bwd_dq(q.float(), k, v, out, out, lse)
    got = flash_attn.flash_attention_backward(q, k, v, out, lse, out)
    want = flash_attn.flash_attention_backward_plain(q, k, v, out, lse, out)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
