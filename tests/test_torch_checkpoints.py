"""whisperx_tpu_torch's HF checkpoint loaders against the JAX package's, on
tiny random Whisper and wav2vec2 checkpoints written with ``transformers``
(as ``.safetensors`` and as ``pytorch_model.bin``): the state dicts, the
converted trees, Whisper logits, wav2vec2 emissions, ``load_model`` /
``load_align_model`` (fp, int8 and int4) and the options that raise."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperx_tpu.align import alignment as ja
from whisperx_tpu.models import convert as jc
from whisperx_tpu.pipeline import asr as jasr
from whisperx_tpu_torch.align import alignment as ta
from whisperx_tpu_torch.models import convert as tc
from whisperx_tpu_torch.pipeline import asr as tasr

torch.set_num_threads(2)

SR = 16000


def _whisper_dir(path, safe):
    from tokenizers import pre_tokenizers
    from transformers import WhisperConfig, WhisperForConditionalGeneration

    cfg = WhisperConfig(
        vocab_size=51865, num_mel_bins=80, d_model=64, encoder_layers=2, encoder_attention_heads=2,
        decoder_layers=2, decoder_attention_heads=2, decoder_ffn_dim=256, encoder_ffn_dim=256,
        max_source_positions=1500, max_target_positions=64, pad_token_id=50257, bos_token_id=50257,
        eos_token_id=50257, decoder_start_token_id=50258,
    )
    torch.manual_seed(0)
    WhisperForConditionalGeneration(cfg).eval().save_pretrained(str(path), safe_serialization=safe)
    # Minimal byte-level BPE files (no merges) for the tokenizer's offline path.
    alphabet = sorted(pre_tokenizers.ByteLevel.alphabet())
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump({c: i for i, c in enumerate(alphabet)}, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    return str(path)


def _wav2vec2_dir(path, safe):
    from transformers import Wav2Vec2Config, Wav2Vec2ForCTC

    cfg = Wav2Vec2Config(
        vocab_size=32, hidden_size=64, num_hidden_layers=2, num_attention_heads=2, intermediate_size=128,
        conv_dim=[32, 32, 32], conv_kernel=[10, 3, 3], conv_stride=[5, 2, 2], num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4, do_stable_layer_norm=False, feat_extract_norm="group",
    )
    torch.manual_seed(1)
    Wav2Vec2ForCTC(cfg).eval().save_pretrained(str(path), safe_serialization=safe)
    chars = ["<pad>", "|", "'"] + [chr(c) for c in range(ord("a"), ord("z") + 1)]
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump({c: i for i, c in enumerate(chars)}, f)
    return str(path)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpts")
    return {
        (kind, fmt): make(root / f"{kind}-{fmt}", fmt == "safetensors")
        for kind, make in (("whisper", _whisper_dir), ("wav2vec2", _wav2vec2_dir))
        for fmt in ("safetensors", "bin")
    }


def _int4_as_int8(x):
    """A JAX int4 leaf as the int8 array of its values (ml_dtypes by name)."""
    x = np.asarray(x)
    return x.astype(np.int8) if x.dtype.name == "int4" else x


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"{path}/{k}")


@pytest.mark.parametrize("kind", ["whisper", "wav2vec2"])
@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_state_dict_equal(ckpts, kind, fmt):
    path = ckpts[kind, fmt]
    got = tc.load_state_dict(path)
    want = jc.load_state_dict(path)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tc.primary_weights_file(path) == jc.primary_weights_file(path)


def test_safetensors_reader_equals_the_library(tmp_path):
    from safetensors.numpy import load_file
    from safetensors.torch import save_file

    tensors = {
        "f32": torch.randn(3, 5), "f16": torch.randn(4).half(), "bf16": torch.randn(2, 3, 4).bfloat16(),
        "i64": torch.arange(7), "i32": torch.arange(6, dtype=torch.int32).reshape(2, 3),
        "i8": torch.arange(-4, 4, dtype=torch.int8), "u8": torch.arange(9, dtype=torch.uint8),
        "bool": torch.tensor([True, False, True]), "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 3),
    }
    save_file(tensors, str(tmp_path / "t.safetensors"), metadata={"format": "pt"})
    got = tc.read_safetensors(str(tmp_path / "t.safetensors"))
    want = load_file(str(tmp_path / "t.safetensors"))  # bfloat16 through ml_dtypes (imported by jax)
    assert set(got) == set(want) == set(tensors)
    for k, w in want.items():
        exp = w.astype(np.float32) if k == "bf16" else w
        assert got[k].dtype == exp.dtype and got[k].shape == exp.shape, k
        np.testing.assert_array_equal(got[k], exp, err_msg=k)
    np.testing.assert_array_equal(got["bf16"], tensors["bf16"].float().numpy())


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_converted_trees_equal(ckpts, fmt):
    for kind, t_conv, j_conv, t_cfg, j_cfg in (
        ("whisper", tc.convert_whisper, jc.convert_whisper, tc.whisper_config_from_hf, jc.whisper_config_from_hf),
        ("wav2vec2", tc.convert_wav2vec2, jc.convert_wav2vec2, tc.wav2vec2_config_from_hf, jc.wav2vec2_config_from_hf),
    ):
        path = ckpts[kind, fmt]
        with open(os.path.join(path, "config.json")) as f:
            hf = json.load(f)
        assert vars(t_cfg(hf)) == vars(j_cfg(hf))
        sd = jc.load_state_dict(path)
        _assert_trees_equal(t_conv(sd, t_cfg(hf)), j_conv(sd, j_cfg(hf)))


def test_whisper_logits_equal(ckpts):
    model, config = tc.load_whisper(ckpts["whisper", "safetensors"], device="cpu")
    jmodel, jparams, jconfig = jc.load_whisper(ckpts["whisper", "safetensors"])
    assert vars(config) == vars(jconfig)
    mel = np.random.default_rng(0).standard_normal((2, 80, 3000)).astype(np.float32)
    tokens = np.array([[50258, 50259, 50359, 50363, 220, 300]] * 2)
    want = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(mel), jnp.asarray(tokens)))
    with torch.inference_mode():
        got = model(torch.from_numpy(mel), torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # bf16: the tree carries the values the JAX loader casts its leaves to.
    tree, _ = tc.read_whisper(ckpts["whisper", "safetensors"], dtype=torch.bfloat16)
    jtree = jax.tree_util.tree_map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32), jparams)
    _assert_trees_equal(tree, jtree)


def test_load_model_int8_routes_and_raises(ckpts, monkeypatch):
    path = ckpts["whisper", "safetensors"]
    p = tasr.load_model("tiny", checkpoint=path, compute_type="int8", device="cpu", language="en")
    assert p.kv_cache_dtype == "int8"
    assert p.model.fused_qkv and p.model.quantized is True and p.model.dtype == torch.bfloat16
    assert p.model.decoder.layers[0].attn.qkv.kernel.dtype == torch.int8
    opts, _ = p._search_options(p.tokenizer)
    assert opts.kv_cache_dtype == "int8"
    # int4: the JAX package's load_model on the same directory holds the
    # same weights (its int4 leaves as values), and both pair them with the
    # int8 KV cache; the port's kernels are packed two to a byte.
    p4 = tasr.load_model("tiny", checkpoint=path, compute_type="int4", device="cpu", language="en")
    j4 = jasr.load_model("tiny", checkpoint=path, compute_type="int4", language="en")
    assert p4.kv_cache_dtype == j4.kv_cache_dtype == "int8"
    assert p4.model.quant_bits == j4.model.quant_bits == 4 and p4.model.fused_qkv and p4.model.dtype == torch.bfloat16
    qkv = p4.model.decoder.layers[0].attn.qkv.kernel
    assert qkv.dtype == torch.uint8 and qkv.shape == (32, 192)
    _assert_trees_equal(tc.whisper_to_jax(p4.model), jax.tree_util.tree_map(_int4_as_int8, j4.params))
    monkeypatch.setenv("WHISPERX_FUSED_QKV", "0")
    p = tasr.load_model("tiny", checkpoint=path, compute_type="float32", device="cpu")
    assert not p.model.fused_qkv and p.kv_cache_dtype == "model" and p.model.dtype == torch.float32
    p = tasr.load_model("tiny", checkpoint=path, compute_type="int4", device="cpu", language="en", kv_cache_dtype="int4")
    assert p.kv_cache_dtype == "int4" and not p.model.fused_qkv
    opts, _ = p._search_options(p.tokenizer)
    assert opts.kv_cache_dtype == "int4"
    with pytest.raises(FileNotFoundError):
        tasr.load_model("no-such-model", download_root=str(path), device="cpu")


def _bursts(seconds, seed=0):
    rng = np.random.default_rng(seed)
    audio = np.zeros(seconds * SR, np.float32)
    t = np.arange(3 * SR) / SR
    for s in range(1, seconds - 3, 5):
        audio[s * SR : (s + 3) * SR] = 0.3 * np.sin(2 * np.pi * 600 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    return audio + 0.003 * rng.standard_normal(len(audio)).astype(np.float32)


def test_load_model_transcribe_equal(ckpts):
    """fp32 from one HF directory, the BPE tokenizer and SpeechBandVAD: the
    same segments and text as the JAX package's load_model."""
    path = ckpts["whisper", "bin"]
    opts = {"beam_size": 2, "max_new_tokens": 4}
    got_p = tasr.load_model("tiny", checkpoint=path, compute_type="float32", device="cpu", language="en", asr_options=opts)
    want_p = jasr.load_model("tiny", checkpoint=path, compute_type="float32", language="en", asr_options=opts)
    audio = _bursts(16)
    got = got_p.transcribe(audio, batch_size=2, chunk_size=5)
    want = want_p.transcribe(audio, batch_size=2, chunk_size=5)
    assert got == want
    assert len(got["segments"]) >= 3


def test_load_align_model_equal(ckpts):
    path = ckpts["wav2vec2", "safetensors"]
    tm, tmeta = ta.load_align_model("en", device="cpu", model_name=path)
    jm, jmeta = ja.load_align_model("en", model_name=path)
    assert tmeta == {**jmeta, "type": "torch"}
    assert tm.dictionary == jm.dictionary and tm.blank_id == jm.blank_id == 0
    assert tm.model.dtype == torch.float32
    audio = (np.random.default_rng(3).standard_normal((2, 2 * SR)) * 0.1).astype(np.float32)
    want = np.asarray(jm.model.apply({"params": jm.params}, jnp.asarray(audio)))
    with torch.inference_mode():
        got = tm.model(torch.from_numpy(audio)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    transcript = [{"start": 0.1, "end": 1.9, "text": " hello there"}, {"start": 2.0, "end": 3.8, "text": " good day"}]
    flat = audio.reshape(-1)
    assert ta.align([dict(s) for s in transcript], tm, tmeta, flat, "cpu") == ja.align(
        [dict(s) for s in transcript], jm, jmeta, flat
    )
    # int8: the same emissions and alignment as the JAX package's int8 model.
    tq, _ = ta.load_align_model("en", device="cpu", model_name=path, compute_type="int8")
    jq, _ = ja.load_align_model("en", model_name=path, compute_type="int8")
    assert tq.model.quantized and tq.model.layers[0].attention.q_proj.kernel.dtype == torch.int8
    assert tq.model.lm_head.kernel.dtype == torch.float32
    want = np.asarray(jq.model.apply({"params": jq.params}, jnp.asarray(audio)))
    with torch.inference_mode():
        got = tq.model(torch.from_numpy(audio)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert ta.align([dict(s) for s in transcript], tq, tmeta, flat, "cpu") == ja.align(
        [dict(s) for s in transcript], jq, jmeta, flat
    )
    assert ta._find_blank_id({"a": 3, "[pad]": 7}) == 7 and ta._find_blank_id({"a": 3}) == 0
