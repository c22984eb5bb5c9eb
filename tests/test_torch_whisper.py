"""whisperx_tpu_torch Whisper modules against the JAX package's, after
``whisper_from_jax``, on a 128-wide 2-layer model (the smallest that meets
both kernels' shape rules)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperx_tpu.models.configs import TEST_CONFIG
from whisperx_tpu.models.whisper import Whisper as JWhisper
from whisperx_tpu.models.whisper import fuse_qkv_params as j_fuse
from whisperx_tpu.models.whisper import quantize_params as j_quantize
from whisperx_tpu_torch.models import whisper as tw
from whisperx_tpu_torch.models.convert import torch_name, whisper_from_jax
from whisperx_tpu_torch.ops.quant import PACKED_INT4

torch.set_num_threads(2)

SMALL = dataclasses.replace(TEST_CONFIG, n_text_state=128, n_audio_state=128, n_text_head=2, n_audio_head=2)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    params = tw.random_params(SMALL, seed=0, scale=0.05)
    mel = (rng.standard_normal((2, SMALL.n_mels, 3000)) * 0.5).astype(np.float32)
    tokens = rng.integers(0, 1000, (2, 6)).astype(np.int32)
    return params, mel, tokens


def _jax_logits(params, mel, tokens, quantized, fused):
    model = JWhisper(SMALL, dtype=jnp.float32, quantized=quantized, fused_qkv=fused)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    return np.asarray(model.apply({"params": jparams}, jnp.asarray(mel), jnp.asarray(tokens)))


def test_fp32_logits_match_jax(inputs):
    params, mel, tokens = inputs
    want = _jax_logits(params, mel, tokens, quantized=False, fused=False)
    model = whisper_from_jax(params, SMALL, device="cpu")
    got = model(torch.from_numpy(mel), torch.from_numpy(tokens).long()).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fused", [False, True])
def test_int8_logits_match_jax(inputs, monkeypatch, fused):
    """int8 weights: both sides send the ≤256-row projections through the
    int8 kernel's function (JAX: WHISPERX_INT8_MM=pallas), which rounds x to
    bf16. Rounding boundaries fall apart where fp32 sums differ in the last
    bit, so single bf16 ulps (2**-8 relative) of x can differ."""
    params, mel, tokens = inputs
    qparams = tw.quantize_params(params)
    if fused:
        qparams = tw.fuse_qkv_params(qparams)
    monkeypatch.setenv("WHISPERX_INT8_MM", "pallas")
    want = _jax_logits(qparams, mel, tokens, quantized=True, fused=fused)
    model = whisper_from_jax(qparams, SMALL, device="cpu")
    assert model.quantized is True and model.fused_qkv is fused
    got = model(torch.from_numpy(mel), torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_decoder_only_quantization_is_read_off_the_tree(inputs):
    params, mel, tokens = inputs
    qparams = tw.quantize_params(params, scope="decoder")
    model = whisper_from_jax(qparams, SMALL, device="cpu")
    assert model.quantized == "decoder"
    assert model.encoder.layers[0].mlp.fc1.kernel.dtype == torch.float32
    assert model.decoder.layers[0].mlp.fc1.kernel.dtype == torch.int8


def test_encoder_states_match_jax(inputs):
    params, mel, _ = inputs
    model = JWhisper(SMALL, dtype=jnp.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    want = np.asarray(model.apply({"params": jparams}, jnp.asarray(mel), method=JWhisper.encode))
    got = whisper_from_jax(params, SMALL, device="cpu").encode(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_converter_rejects_incomplete_trees(inputs):
    params = dict(inputs[0])
    params["decoder"] = {k: v for k, v in params["decoder"].items() if k != "ln"}
    with pytest.raises(KeyError):
        whisper_from_jax(params, SMALL, device="cpu")
    assert torch_name(("decoder", "layers_12", "attn", "qkv", "kernel")) == "decoder.layers.12.attn.qkv.kernel"


def test_empty_cache_layout():
    model = tw.Whisper(SMALL, device="cpu")
    cache = model.empty_cache(3, cache_dtype=torch.int8, cache_len=128)
    assert len(cache["self"]) == SMALL.n_text_layer and cache["cross"] == [None, None]
    layer = cache["self"][0]
    assert layer["k"].shape == (3, 128, 2, 64) and layer["k"].dtype == torch.int8
    assert layer["k_scale"].shape == (3, 128, 2, 1) and layer["k_scale"].dtype == torch.float32
    assert set(model.empty_cache(1)["self"][0]) == {"k", "v"}


@pytest.mark.parametrize("kv", ["fp32", "int8", "int4"])
def test_device_position_is_bit_equal_to_the_int(inputs, kv):
    """The decode loop's position as a 0-d int64 tensor (nothing read back
    to the host) gives the logits and the cache writes of the Python int,
    bit for bit: the prompt, then two steps, with the model's cache, the
    int8 one and the packed int4 one (values and scale planes)."""
    params, mel, tokens = inputs
    model = whisper_from_jax(params, SMALL, device="cpu")
    cache_dtype = {"fp32": None, "int8": torch.int8, "int4": PACKED_INT4}[kv]
    runs = []
    with torch.inference_mode():
        states = model.encode(torch.from_numpy(mel))
        for wrap in (int, torch.tensor):
            cache = model.empty_cache(2, cache_dtype=cache_dtype, cache_len=64)
            cache["cross"] = model.compute_cross_kv(states)
            logits, cache = model.decode_step(torch.from_numpy(tokens).long(), cache, wrap(0))
            out = [logits]
            for i in range(2):
                step_tokens = out[-1][:, -1].argmax(-1, keepdim=True)
                logits, cache = model.decode_step(step_tokens, cache, wrap(tokens.shape[1] + i))
                out.append(logits)
            runs.append((out, cache["self"]))
    (int_logits, int_cache), (dev_logits, dev_cache) = runs
    assert all(torch.equal(a, b) for a, b in zip(int_logits, dev_logits))
    for a, b in zip(int_cache, dev_cache):
        assert a.keys() == b.keys() and all(torch.equal(a[n], b[n]) for n in a)
    assert int_cache[0]["k"][:, tokens.shape[1] + 1].abs().sum() > 0  # the last step wrote its slot
