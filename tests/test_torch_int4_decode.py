"""int4 weights and the int4 KV cache through the port's decode engine,
against the JAX package's ``WhisperEngine`` on one weight tree: mel features
→ encoder → cross K/V → prompt → greedy and beam search, fp32 on the CPU, on
a 128-wide 2-layer model, under both decode cross-attention paths. Tokens
must be identical.

The JAX side runs with WHISPERX_INT8_MM=pallas (its int8 kernel in interpret
mode), as the port always sends its ≤ 256-row int8 projections through
``int8_matmul``; int4 projections take neither kernel on either side."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_routes import force_routes
from whisperx_tpu.decode.engine import WhisperEngine as JEngine
from whisperx_tpu.decode.tokenizer import WhisperTokenizer as JTokenizer
from whisperx_tpu.models import whisper as jw
from whisperx_tpu.models.configs import TEST_CONFIG
from whisperx_tpu_torch.decode.engine import WhisperEngine
from whisperx_tpu_torch.decode.search import reorder_cache_
from whisperx_tpu_torch.decode.tokenizer import WhisperTokenizer
from whisperx_tpu_torch.models import whisper as tw
from whisperx_tpu_torch.models.convert import whisper_from_jax
from whisperx_tpu_torch.ops import int8_mm
from whisperx_tpu_torch.ops.quant import PACKED_INT4, pack_int4, unpack_int4

torch.set_num_threads(2)

SMALL = dataclasses.replace(TEST_CONFIG, n_text_state=128, n_audio_state=128, n_text_head=2, n_audio_head=2)


def snap_to_int4_grid(params: dict) -> dict:
    """Every rank-2 kernel moved onto its own int4 grid (scale = amax / 7),
    as ``tests/test_quantize.py``'s int4 test does: int4 quantization of the
    result is lossless."""
    out = {}
    for name, child in params.items():
        if isinstance(child, dict):
            out[name] = snap_to_int4_grid(child)
        elif name == "kernel" and child.ndim == 2:
            scale = np.maximum(np.max(np.abs(child), axis=0) / 7.0, 1e-12)
            out[name] = (np.round(child / scale) * scale).astype(np.float32)
        else:
            out[name] = child
    return out


def _pair(params: dict, quant_bits):
    """(JAX engine, its params, port engine) on one tree; ``quant_bits`` None
    keeps fp32 weights."""
    tree = params
    if quant_bits:
        tree = tw.fuse_qkv_params(tw.quantize_params(params, bits=quant_bits))
    jmodel = jw.Whisper(SMALL, dtype=jnp.float32, quantized=bool(quant_bits), quant_bits=quant_bits or 8, fused_qkv=bool(quant_bits))
    if quant_bits == 4:
        jparams = jw.fuse_qkv_params(jw.quantize_params(jax.tree_util.tree_map(jnp.asarray, params), bits=4))
    else:
        jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jengine = JEngine(jmodel, JTokenizer.dummy(SMALL.n_vocab, language="en"))
    model = whisper_from_jax(tree, SMALL, quant_bits=quant_bits, device="cpu")
    return jengine, jparams, WhisperEngine(model, WhisperTokenizer.dummy(SMALL.n_vocab))


@pytest.fixture(scope="module")
def mel():
    return (3 * np.random.default_rng(2).standard_normal((2, SMALL.n_mels, 3000))).astype(np.float32)


@pytest.fixture(scope="module")
def pairs():
    # Weight scale 0.2 (not init's 0.02) and mel values of std 3: peaked
    # enough for beam search to pick other tokens than greedy, and for the
    # tokens to vary.
    fp = tw.random_params(SMALL, seed=0, scale=0.2)
    return {
        "int4 weights": _pair(snap_to_int4_grid(fp), 4),
        "int4 kv": _pair(fp, None),
        "int4 weights + kv": _pair(fp, 4),
    }


def _assert_same(pair, mel, monkeypatch, **kw):
    jengine, jparams, tengine = pair
    monkeypatch.setenv("WHISPERX_INT8_MM", "pallas")
    monkeypatch.delenv("WHISPERX_CROSS_ATTN", raising=False)
    cross = kw.pop("cross")
    force_routes(monkeypatch, cross=cross)
    jopts = dataclasses.replace(jengine.build_options(max_new_tokens=6, **kw), cross_attn=cross)
    topts = tengine.build_options(max_new_tokens=6, **kw)
    want = jengine.generate(jparams, jnp.asarray(mel), options=jopts)
    got = tengine.generate(torch.from_numpy(mel), options=topts)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_allclose(got.sum_logprobs, want.sum_logprobs, atol=2e-2)
    np.testing.assert_allclose(got.no_speech_probs, want.no_speech_probs, rtol=1e-3, atol=1e-6)
    return got


@pytest.mark.parametrize("beam", [1, 3])
def test_int4_weight_tokens_match_jax(pairs, mel, monkeypatch, beam):
    """Snapped-grid model, int4 weights, the int8 KV cache that "auto" pairs them with."""
    _assert_same(pairs["int4 weights"], mel, monkeypatch, beam_size=beam, kv_cache_dtype="int8", cross="xla")


@pytest.mark.parametrize("cross", ["xla", "pallas"])
@pytest.mark.parametrize("beam", [1, 3])
def test_int4_kv_tokens_match_jax(pairs, mel, monkeypatch, beam, cross):
    _assert_same(pairs["int4 kv"], mel, monkeypatch, beam_size=beam, kv_cache_dtype="int4", cross=cross)


@pytest.mark.parametrize("cross", ["xla", "pallas"])
@pytest.mark.parametrize("beam", [1, 3])
def test_int4_weights_and_kv_tokens_match_jax(pairs, mel, monkeypatch, beam, cross):
    _assert_same(pairs["int4 weights + kv"], mel, monkeypatch, beam_size=beam, kv_cache_dtype="int4", cross=cross)


@pytest.mark.parametrize("which,kv", [("int4 weights", "int8"), ("int4 kv", "int4"), ("int4 weights + kv", "int4")])
def test_beam_differs_from_greedy_on_these_models(pairs, mel, which, kv):
    """Guards the tests above: on each model beam search reorders the
    (packed) cache, and the tokens vary."""
    _, _, tengine = pairs[which]
    opts = dict(max_new_tokens=6, kv_cache_dtype=kv)
    greedy = tengine.generate(mel, options=tengine.build_options(beam_size=1, **opts))
    beam = tengine.generate(mel, options=tengine.build_options(beam_size=3, **opts))
    assert not np.array_equal(greedy.tokens, beam.tokens)
    assert (beam.sum_logprobs >= greedy.sum_logprobs - 1e-4).all()
    assert len(np.unique(beam.tokens)) > 2  # the tokens vary


@pytest.mark.parametrize("cross", ["xla", "pallas"])
def test_int4_cache_layout(pairs, mel, cross):
    """An int4 request keeps a packed int4 self cache; its cross K/V are
    packed int4 on the "xla" path and int8 FlatCrossKV (the kernel's) on the
    "pallas" path, as the JAX package builds them."""
    _, _, tengine = pairs["int4 weights + kv"]
    with torch.inference_mode():
        states = tengine._encode(torch.from_numpy(mel))
        prompt = tengine.build_prompt(2)
        _, cache, _ = tengine._prompt_cache(states, prompt, 64, kv_bits=4, cross_impl=cross)
    H, Dh = SMALL.n_text_head, SMALL.n_text_state // SMALL.n_text_head
    layer = cache["self"][0]
    assert layer["k"].dtype == layer["v"].dtype == PACKED_INT4
    assert layer["k"].shape == (2, 64, H, Dh // 2) and layer["k_scale"].shape == (2, 64, H, 1)
    cross_kv = cache["cross"][0]
    if cross == "pallas":
        assert isinstance(cross_kv, tw.FlatCrossKV) and cross_kv.k.dtype == torch.int8
        assert cross_kv.k.shape == (2, 1500, H * Dh)
    else:
        k, ks, v, vs = cross_kv
        assert k.dtype == v.dtype == PACKED_INT4 and k.shape == (2, 1500, H, Dh // 2)
        assert ks.shape == (2, 1500, H, 1)


def test_beam_reorder_on_packed_buffers():
    """search.py's axis-0 index_select moves packed rows whole: the packed
    cache reordered in place unpacks to the reordered int8 values."""
    rng = np.random.default_rng(5)
    vals = torch.from_numpy(rng.integers(-7, 8, (6, 16, 2, 64)).astype(np.int8))
    scales = torch.from_numpy(rng.random((6, 16, 2, 1)).astype(np.float32))
    cache = [{"k": pack_int4(vals), "v": pack_int4(-vals), "k_scale": scales.clone(), "v_scale": 2 * scales}]
    idx = torch.tensor([2, 2, 0, 5, 1, 1])
    buffers = dict(cache[0])
    reorder_cache_(cache, idx, {(tuple(b.shape), b.dtype): torch.empty_like(b) for b in buffers.values()})
    out = cache[0]
    assert all(out[n] is b for n, b in buffers.items())  # the same buffers, reordered in place
    assert out["k"].dtype == PACKED_INT4 and out["k"].shape == (6, 16, 2, 32)
    assert torch.equal(unpack_int4(out["k"]), vals[idx])
    assert torch.equal(unpack_int4(out["v"]), -vals[idx])
    assert torch.equal(out["v_scale"], 2 * scales[idx])


def test_int4_projections_never_take_the_int8_kernel(pairs, mel, monkeypatch):
    """int4 projections are an XLA dot in the JAX package: the port's int4
    model never calls int8_matmul, even at ≤ 256 rows and 128-multiple widths."""
    _, _, tengine = pairs["int4 weights + kv"]
    from whisperx_tpu_torch.models import whisper as whisper_mod

    def refuse(*a, **kw):
        raise AssertionError("int8_matmul called by an int4 model")

    monkeypatch.setattr(whisper_mod, "int8_matmul", refuse)
    before = int8_mm.launches
    res = tengine.generate(mel, options=tengine.build_options(beam_size=2, max_new_tokens=2, kv_cache_dtype="int4"))
    assert res.tokens.shape == (2, 2) and np.isfinite(res.sum_logprobs).all()
    assert int8_mm.launches == before
