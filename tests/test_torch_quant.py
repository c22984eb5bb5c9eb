"""The port's int4 weights and KV values and its int8 wav2vec2 against the
JAX package's, on seeded numpy inputs: the packing of int4 values two to a
byte, ``quantize_params(bits=4)``, ``quantize_kv(bits=4)``, the int4
``Dense`` forward, trees in and out of ``whisper_from_jax`` /
``wav2vec2_from_jax``, ``quantize_wav2vec2``'s tree, the int8 wav2vec2's
emissions and ``align()`` on it. fp32 on the CPU.

The JAX side runs with WHISPERX_INT8_MM=pallas (its int8 kernel in interpret
mode) where int8 projections of ≤ 256 rows occur, as the port always sends
them through ``int8_matmul`` (its plain version here), which rounds x to
bf16."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperx_tpu.align import alignment as ja
from whisperx_tpu.models import wav2vec2 as jw2
from whisperx_tpu.models import whisper as jw
from whisperx_tpu.models.configs import TEST_CONFIG, WAV2VEC2_TEST
from whisperx_tpu_torch.align import alignment as ta
from whisperx_tpu_torch.models import wav2vec2 as tw2
from whisperx_tpu_torch.models import whisper as tw
from whisperx_tpu_torch.models.convert import load_jax_params, wav2vec2_from_jax, whisper_from_jax, whisper_to_jax
from whisperx_tpu_torch.ops.quant import PACKED_INT4, pack_int4, quantize_kv, store_kv, unpack_int4

torch.set_num_threads(2)

SR = 16000
SMALL = dataclasses.replace(TEST_CONFIG, n_text_state=128, n_audio_state=128, n_text_head=2, n_audio_head=2)
# wav2vec2 with every projection width a multiple of 128 (feat_projection
# 512 → 128, attention 128 → 128, feed-forward 128 → 256 → 128): short
# batches take the int8 kernel's route on both sides.
W2V_128 = dataclasses.replace(WAV2VEC2_TEST, hidden_size=128, intermediate_size=256)


def _nibble(b: int) -> int:
    return b - 16 if b >= 8 else b


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            w = np.asarray(want[k])
            w = w.astype(np.int8) if w.dtype.name == "int4" else w
            assert np.asarray(got[k]).dtype == w.dtype, f"{path}/{k}"
            np.testing.assert_array_equal(got[k], w, err_msg=f"{path}/{k}")


# ---- packing ----------------------------------------------------------------


def test_unpack_all_256_bytes():
    """Both nibbles of every byte value sign-extend as two's complement int4."""
    p = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    got = unpack_int4(p)
    want = [v for b in range(256) for v in (_nibble(b & 0xF), _nibble(b >> 4))]
    assert got.dtype == torch.int8
    assert got.tolist() == want
    assert torch.equal(pack_int4(got), p)  # and back, byte for byte


@pytest.mark.parametrize("dim", [0, 1, -1])
def test_pack_round_trip_along_any_dim(dim):
    vals = torch.from_numpy(np.random.default_rng(1).integers(-8, 8, (4, 6, 8)).astype(np.int8))
    packed = pack_int4(vals, dim=dim)
    shape = list(vals.shape)
    shape[dim] //= 2
    assert packed.dtype == PACKED_INT4 and list(packed.shape) == shape
    assert torch.equal(unpack_int4(packed, dim=dim), vals)
    # Element 2i in the low nibble, 2i + 1 in the high one.
    first = vals.movedim(dim, -1)[..., 0]
    second = vals.movedim(dim, -1)[..., 1]
    lead = packed.movedim(dim, -1)[..., 0].view(torch.int8)
    assert torch.equal((lead << 4) >> 4, first) and torch.equal(lead >> 4, second)


# ---- quantization -----------------------------------------------------------


@pytest.mark.parametrize("scope", ["all", "decoder"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_equals_jax(bits, scope):
    """Kernel values (int4 as int8 arrays of the same values) and scales bit
    for bit; the token embedding per-row int8 at both widths; convs fp."""
    params = tw.random_params(SMALL, seed=3)
    got = tw.quantize_params(params, bits=bits, scope=scope)
    want = jw.quantize_params(jax.tree_util.tree_map(jnp.asarray, params), bits=bits, scope=scope)
    _assert_trees_equal(got, _np_tree(want))
    q = got["decoder"]["layers_0"]["mlp"]["fc1"]["kernel"]
    assert q.dtype == np.int8 and np.abs(q).max() == (7 if bits == 4 else 127)
    assert got["decoder"]["token_embedding"].dtype == np.int8
    assert np.abs(got["decoder"]["token_embedding"]).max() == 127
    assert got["encoder"]["conv1"]["kernel"].dtype == np.float32


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_kv_equals_jax(bits):
    x = (np.random.default_rng(4).standard_normal((2, 7, 3, 64)) * 2).astype(np.float32)
    x[0, 1, 2] = 0.0  # an all-zero head: the 1e-8 floor under the divide
    qj, sj = jw.quantize_kv(jnp.asarray(x), bits=bits)
    qt, st = quantize_kv(torch.from_numpy(x), bits=bits)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj).astype(np.int8))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    qmax = 7 if bits == 4 else 127
    assert qt.dtype == torch.int8 and int(qt.abs().max()) == qmax
    # Round trip within half a step.
    err = (qt.float() * st - torch.from_numpy(x)).abs()
    assert bool((err <= st / 2 + 1e-6).all())
    stored, st2 = store_kv(torch.from_numpy(x), bits)
    assert torch.equal(st2, st)
    if bits == 4:
        assert stored.dtype == PACKED_INT4 and stored.shape == (2, 7, 3, 32)
        assert torch.equal(unpack_int4(stored), qt)
    else:
        assert torch.equal(stored, qt)


# ---- the int4 Dense ---------------------------------------------------------


@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("rows", [3, 300])
def test_int4_dense_matches_jax(rows, use_bias):
    """fp32, JAX order: x @ W(int4 → fp32), × scale, + bias."""
    rng = np.random.default_rng(5)
    K, N = 256, 384
    fp = {"kernel": (rng.standard_normal((K, N)) * 0.05).astype(np.float32)}
    if use_bias:
        fp["bias"] = (rng.standard_normal(N) * 0.1).astype(np.float32)
    tree = tw.quantize_params(fp, bits=4)
    x = rng.standard_normal((rows, K)).astype(np.float32)
    jdense = jw.Dense(N, use_bias=use_bias, dtype=jnp.float32, quantized=True, quant_bits=4)
    want = np.asarray(jdense.apply({"params": jw.quantize_params(jax.tree_util.tree_map(jnp.asarray, fp), bits=4)}, jnp.asarray(x)))
    dense = tw.Dense(K, N, use_bias=use_bias, quantized=True, quant_bits=4, device="cpu")
    load_jax_params(dense, tree)
    assert dense.kernel.dtype == PACKED_INT4 and dense.kernel.shape == (K // 2, N)
    assert dense.kernel.numel() * dense.kernel.element_size() == K * N // 2
    with torch.inference_mode():
        got = dense(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_load_rejects_int8_values_as_int4():
    rng = np.random.default_rng(6)
    tree = tw.quantize_params({"kernel": rng.standard_normal((128, 128)).astype(np.float32)}, bits=8)
    dense = tw.Dense(128, 128, use_bias=False, quantized=True, quant_bits=4, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        load_jax_params(dense, tree)


# ---- Whisper trees in and out -----------------------------------------------


@pytest.mark.parametrize("fused", [False, True])
def test_whisper_from_jax_reads_int4_trees(fused):
    """A JAX int4 tree straight from ``tree_map(np.asarray, ...)`` (ml_dtypes
    int4 leaves) gives the model that the port's own int8-valued tree gives
    with quant_bits=4; ``whisper_to_jax`` gives the values back."""
    fp = tw.random_params(SMALL, seed=7)
    jtree = jw.quantize_params(jax.tree_util.tree_map(jnp.asarray, fp), bits=4)
    ttree = tw.quantize_params(fp, bits=4)
    if fused:
        jtree, ttree = jw.fuse_qkv_params(jtree), tw.fuse_qkv_params(ttree)
    jtree = _np_tree(jtree)
    assert jtree["decoder"]["layers_0"]["mlp"]["fc1"]["kernel"].dtype.name == "int4"
    from_jax = whisper_from_jax(jtree, SMALL, device="cpu")
    from_port = whisper_from_jax(ttree, SMALL, quant_bits=4, device="cpu")
    assert from_jax.quant_bits == from_port.quant_bits == 4 and from_jax.fused_qkv == fused
    a, b = dict(from_jax.named_parameters()), dict(from_port.named_parameters())
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].dtype == b[name].dtype and torch.equal(a[name], b[name]), name
    dense = from_jax.decoder.layers[0].mlp.fc1
    assert dense.kernel.dtype == PACKED_INT4 and dense.kernel.shape == (SMALL.n_text_state // 2, 4 * SMALL.n_text_state)
    assert from_jax.decoder.token_embedding.dtype == torch.int8
    _assert_trees_equal(whisper_to_jax(from_jax), ttree)
    # Without quant_bits an int8-valued tree reads as int8.
    assert whisper_from_jax(ttree, SMALL, device="cpu").decoder.layers[0].mlp.fc1.kernel.dtype == torch.int8


def test_int4_logits_match_jax():
    fp = tw.random_params(SMALL, seed=8, scale=0.05)
    tree = tw.fuse_qkv_params(tw.quantize_params(fp, bits=4))
    jparams = jw.fuse_qkv_params(jw.quantize_params(jax.tree_util.tree_map(jnp.asarray, fp), bits=4))
    rng = np.random.default_rng(9)
    mel = (rng.standard_normal((2, SMALL.n_mels, 3000)) * 0.5).astype(np.float32)
    tokens = rng.integers(0, 1000, (2, 6)).astype(np.int32)
    jmodel = jw.Whisper(SMALL, dtype=jnp.float32, quantized=True, quant_bits=4, fused_qkv=True)
    want = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(mel), jnp.asarray(tokens)))
    model = whisper_from_jax(tree, SMALL, quant_bits=4, device="cpu")
    with torch.inference_mode():
        got = model(torch.from_numpy(mel), torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# ---- the int8 wav2vec2 ------------------------------------------------------


@pytest.fixture(scope="module")
def w2v():
    """The JAX package's int8 align model on Flax-initialized 128-wide
    weights, and the port's from its tree (max_batch 2: a 1 s batch has 98
    rows, a 3 s one 298)."""
    jm = ja.test_align_model("en", seed=0, config=W2V_128)
    jm.max_batch = 2
    fp_tree = _np_tree(jm.params)
    jm.model, jm.params = jw2.quantize_wav2vec2(jm.model, jm.params)
    model = wav2vec2_from_jax(_np_tree(jm.params), W2V_128, device="cpu")
    tm = ta.AlignModel(model, jm.dictionary, "en", blank_id=jm.blank_id, max_batch=2)
    return jm, tm, fp_tree


def test_quantize_wav2vec2_tree_equals_jax(w2v):
    jm, tm, fp_tree = w2v
    got = tw2.quantize_wav2vec2_params(fp_tree)
    _assert_trees_equal(got, _np_tree(jm.params))
    assert got["lm_head"]["kernel"].dtype == np.float32 and "kernel_scale" not in got["lm_head"]
    assert got["feature_extractor"]["conv_0"]["kernel"].dtype == np.float32
    assert got["pos_conv_embed"]["conv"]["kernel"].dtype == np.float32
    assert got["feat_projection"]["kernel"].dtype == np.int8
    assert got["layers_1"]["feed_forward"]["output"]["kernel"].dtype == np.int8
    # The model-level transform gives the same module.
    quant = tw2.quantize_wav2vec2(wav2vec2_from_jax(fp_tree, W2V_128, device="cpu"))
    assert quant.quantized and not quant.lm_head.quantized
    a, b = dict(quant.named_parameters()), dict(tm.model.named_parameters())
    assert a.keys() == b.keys() and all(torch.equal(a[n], b[n]) for n in a)


def _emissions(w2v, seconds):
    jm, tm, _ = w2v
    rng = np.random.default_rng(10)
    x = (rng.standard_normal((2, seconds * SR)) * 0.1).astype(np.float32)
    lens = np.array([seconds * SR, seconds * SR - 5000], np.int32)
    want = np.asarray(jm.model.apply({"params": jm.params}, jnp.asarray(x), sample_lengths=jnp.asarray(lens)))
    with torch.inference_mode():
        got = tm.model(torch.from_numpy(x), torch.from_numpy(lens).long()).numpy()
    return got, want


def test_int8_wav2vec2_emissions_match_jax(w2v, monkeypatch):
    """3 s rows (2 x 149 frames): every projection dequantizes and multiplies
    in fp32 on both sides."""
    monkeypatch.setenv("WHISPERX_INT8_MM", "pallas")
    got, want = _emissions(w2v, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rounding", [False, True])
def test_int8_wav2vec2_kernel_route_emissions_match_jax(w2v, monkeypatch, rounding):
    """1 s rows (2 x 49 frames) take the int8 kernel's route on both sides.
    Without the bf16 rounding of x (the JAX package's XLA route, and the
    port's int8_matmul replaced by the same product unrounded) the
    emissions agree within 1e-4. With it, x values whose fp32 sums differ
    in the last bit round to neighbouring bf16 values (2**-8 apart), and
    two layers carry that to ~1e-2 of the emissions."""
    from whisperx_tpu_torch.models import whisper as whisper_mod

    if rounding:
        monkeypatch.setenv("WHISPERX_INT8_MM", "pallas")
        tol = 2e-2
    else:
        monkeypatch.setenv("WHISPERX_INT8_MM", "xla")

        def unrounded(x, w, scale, bias=None, *, out_dtype):
            y = torch.matmul(x.float(), w.float()) * scale.float()
            return (y if bias is None else y + bias.float()).to(out_dtype)

        monkeypatch.setattr(whisper_mod, "int8_matmul", unrounded)
        tol = 1e-4
    got, want = _emissions(w2v, 1)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_int8_align_equals_jax(w2v, monkeypatch):
    """Words, chars and timestamps of align() identical: a 1 s batch (the
    kernel's route) and a 3 s batch."""
    jm, tm, _ = w2v
    monkeypatch.setenv("WHISPERX_INT8_MM", "pallas")
    audio = (np.random.default_rng(11).standard_normal(9 * SR) * 0.1).astype(np.float32)
    transcript = [
        {"start": 0.1, "end": 0.9, "text": " hi there"},
        {"start": 1.2, "end": 2.0, "text": " good day"},
        {"start": 3.0, "end": 5.9, "text": " hello there. general kenobi"},
        {"start": 6.0, "end": 8.9, "text": " you are bold"},
    ]
    meta = {"language": "en", "dictionary": jm.dictionary, "type": "jax"}
    want = ja.align([dict(s) for s in transcript], jm, meta, audio, return_char_alignments=True)
    got = ta.align([dict(s) for s in transcript], tm, meta, audio, "cpu", return_char_alignments=True)
    assert got == want
    assert all(seg["words"] for seg in got["segments"])
