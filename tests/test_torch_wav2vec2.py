"""whisperx_tpu_torch wav2vec2 against the JAX package's ``Wav2Vec2ForCTC``,
after ``wav2vec2_from_jax`` on the Flax-initialized weights, for the
group-norm (base) and layer-norm (large) architectures at test size."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_routes import force_routes
from whisperx_tpu.models.configs import WAV2VEC2_LARGE, WAV2VEC2_TEST
from whisperx_tpu.models.wav2vec2 import Wav2Vec2ForCTC as JW2V
from whisperx_tpu.models.wav2vec2 import init_wav2vec2_params
from whisperx_tpu_torch.models import wav2vec2 as tw2
from whisperx_tpu_torch.models.configs import Wav2Vec2Config
from whisperx_tpu_torch.models.convert import wav2vec2_from_jax

torch.set_num_threads(2)

GROUP = WAV2VEC2_TEST
LAYER = dataclasses.replace(
    WAV2VEC2_LARGE, name="large-test", hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128,
    conv_layers=((32, 10, 5), (32, 3, 2), (32, 2, 2)), num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
)
CONFIGS = {"group": GROUP, "layer": LAYER}


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 8000)) * 0.1).astype(np.float32)
    return x, np.array([8000, 5000, 400], np.int32)


@pytest.fixture(scope="module")
def flax_params():
    """Flax-initialized weights per architecture, drawn once."""
    return {norm: init_wav2vec2_params(cfg, seed=0)[1] for norm, cfg in CONFIGS.items()}


def _jax(cfg, params, x, lens, dtype):
    return np.asarray(JW2V(cfg, dtype=dtype).apply({"params": params}, jnp.asarray(x), sample_lengths=jnp.asarray(lens)))


@pytest.mark.parametrize("norm", ["group", "layer"])
def test_fp32_logits_match_jax(audio, flax_params, norm):
    cfg, params = CONFIGS[norm], flax_params[norm]
    x, lens = audio
    want = _jax(cfg, params, x, lens, jnp.float32)
    model = wav2vec2_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(lens)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("norm", ["group", "layer"])
def test_bf16_logits_match_jax(audio, flax_params, norm):
    """bf16 on both sides rounds at other places (GELU, the conv sums): the
    two bf16 results stay within a few bf16 ulps of logits of magnitude ~4,
    and each as far from the fp32 result as the other."""
    cfg, params = CONFIGS[norm], flax_params[norm]
    x, lens = audio
    want = _jax(cfg, params, x, lens, jnp.bfloat16)
    ref = _jax(cfg, params, x, lens, jnp.float32)
    model = wav2vec2_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, dtype=torch.bfloat16, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(lens)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=0.15, rtol=0.05)
    assert np.abs(got - ref).max() <= 2 * np.abs(want - ref).max() + 0.02


def test_feature_lengths_match_jax():
    lens = np.array([400, 401, 719, 720, 16000, 473600, 480000], np.int64)
    for cfg in CONFIGS.values():
        model = tw2.Wav2Vec2ForCTC(cfg, device="cpu")
        want = np.asarray(JW2V(cfg).feature_lengths(jnp.asarray(lens)))
        np.testing.assert_array_equal(model.feature_lengths(torch.from_numpy(lens)).numpy(), want)
        np.testing.assert_array_equal(model.feature_lengths(lens), want)


@pytest.mark.parametrize("norm", ["group", "layer"])
def test_random_params_tree_matches_flax_init(flax_params, norm):
    cfg, params = CONFIGS[norm], flax_params[norm]
    want = {jax.tree_util.keystr(p): np.shape(x) for p, x in jax.tree_util.tree_flatten_with_path(params)[0]}
    ours = tw2.random_params(cfg, seed=0)
    got = {jax.tree_util.keystr(p): np.shape(x) for p, x in jax.tree_util.tree_flatten_with_path(ours)[0]}
    assert got == want
    assert tw2.param_shapes(cfg)["feature_extractor"]["conv_0"]["kernel"] == (10, 1, cfg.conv_layers[0][0])
    model = wav2vec2_from_jax(ours, cfg, device="cpu")  # loads every leaf, or raises
    assert model.layers[0].attention.q_proj.kernel.shape == (cfg.hidden_size, cfg.hidden_size)


def test_flash_route_matches_xla_at_bf16(monkeypatch):
    """wav2vec2 with a 64-wide head (the flash kernel's) and padded rows:
    the flash route (its plain version on CPU) against the "xla" route, each
    forced through the tests' seam."""
    cfg = Wav2Vec2Config(name="test-128", vocab_size=32, hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256)
    model = wav2vec2_from_jax(tw2.random_params(cfg, seed=1), cfg, dtype=torch.bfloat16, device="cpu")
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal((2, 16000)) * 0.1).astype(np.float32))
    lens = torch.tensor([16000, 6000])
    with torch.no_grad():
        force_routes(monkeypatch, attn="flash")
        flash = model(x, lens)
        force_routes(monkeypatch, attn="xla")
        xla = model(x, lens)
    valid = torch.arange(flash.shape[1])[None, :] < model.feature_lengths(lens)[:, None]
    assert torch.isfinite(flash).all()
    torch.testing.assert_close(flash[valid], xla[valid], atol=0.15, rtol=0.05)


def test_converter_rejects_int8_and_incomplete_trees():
    cfg = GROUP
    params = tw2.random_params(cfg, seed=0)
    broken = {k: v for k, v in params.items() if k != "lm_head"}
    with pytest.raises(KeyError):
        wav2vec2_from_jax(broken, cfg, device="cpu")
    # A kernel_scale makes the int8 model, whose lm_head stays fp: a scale
    # on it, or fp kernels beside the scales, do not fit.
    quant = dict(params, lm_head=dict(params["lm_head"], kernel_scale=np.ones(cfg.vocab_size, np.float32)))
    with pytest.raises(ValueError, match="feat_projection"):
        wav2vec2_from_jax(quant, cfg, device="cpu")
    int8 = tw2.quantize_wav2vec2_params(params)
    with pytest.raises(KeyError, match="lm_head"):
        wav2vec2_from_jax(dict(int8, lm_head=quant["lm_head"]), cfg, device="cpu")
    fp_kernels = dict(int8, feat_projection=dict(int8["feat_projection"], kernel=params["feat_projection"]["kernel"]))
    with pytest.raises(ValueError, match="feat_projection"):
        wav2vec2_from_jax(fp_kernels, cfg, device="cpu")
    assert wav2vec2_from_jax(int8, cfg, device="cpu").quantized
