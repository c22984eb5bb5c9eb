"""The ported slice end to end against the JAX package: mel features →
encoder → int8 cross K/V → prompt → greedy and beam search, on a 128-wide
2-layer model with int8 weights, fused QKV and an int8 KV cache, under both
decode cross-attention paths. Tokens must be identical.

The JAX side runs with WHISPERX_INT8_MM=pallas (its int8 kernel in interpret
mode), so both sides round the projection inputs to bf16 the same way."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperx_tpu.decode.engine import WhisperEngine as JEngine
from whisperx_tpu.decode.tokenizer import WhisperTokenizer as JTokenizer
from whisperx_tpu.models.configs import TEST_CONFIG
from whisperx_tpu.models.whisper import Whisper as JWhisper
from whisperx_tpu_torch.decode.engine import WhisperEngine
from whisperx_tpu_torch.decode.tokenizer import WhisperTokenizer
from whisperx_tpu_torch.models import whisper as tw
from whisperx_tpu_torch.models.convert import whisper_from_jax
from whisperx_tpu_torch.ops import cross_attn, int8_mm

torch.set_num_threads(2)

SMALL = dataclasses.replace(TEST_CONFIG, n_text_state=128, n_audio_state=128, n_text_head=2, n_audio_head=2)


@pytest.fixture(scope="module")
def engines():
    # Weight scale 0.1 (not init's 0.02) so the random model's distributions
    # are peaked enough for beam search to pick other tokens than greedy.
    params = tw.fuse_qkv_params(tw.quantize_params(tw.random_params(SMALL, seed=0, scale=0.1)))
    jmodel = JWhisper(SMALL, dtype=jnp.float32, quantized=True, fused_qkv=True)
    jengine = JEngine(jmodel, JTokenizer.dummy(SMALL.n_vocab, language="en"))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tengine = WhisperEngine(whisper_from_jax(params, SMALL, device="cpu"), WhisperTokenizer.dummy(SMALL.n_vocab))
    mel = (np.random.default_rng(2).standard_normal((2, SMALL.n_mels, 3000))).astype(np.float32)
    return jengine, jparams, tengine, mel


@pytest.mark.parametrize("cross", ["xla", "pallas"])
@pytest.mark.parametrize("beam", [1, 2])
def test_slice_tokens_match_jax(engines, monkeypatch, beam, cross):
    jengine, jparams, tengine, mel = engines
    monkeypatch.setenv("WHISPERX_INT8_MM", "pallas")
    monkeypatch.delenv("WHISPERX_CROSS_ATTN", raising=False)
    kw = dict(beam_size=beam, max_new_tokens=6, kv_cache_dtype="int8")
    jopts = dataclasses.replace(jengine.build_options(**kw), cross_attn=cross)
    topts = dataclasses.replace(tengine.build_options(**kw), cross_attn=cross)
    want = jengine.generate(jparams, jnp.asarray(mel), options=jopts)
    got = tengine.generate(torch.from_numpy(mel), options=topts)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_allclose(got.sum_logprobs, want.sum_logprobs, atol=2e-2)
    np.testing.assert_allclose(got.no_speech_probs, want.no_speech_probs, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(got.avg_logprobs, want.avg_logprobs, atol=2e-2)
    assert tengine.decode_text(got) == jengine.decode_text(want)


def test_beam_differs_from_greedy_on_this_model(engines):
    """Guards the slice test above: the model must make beam search reorder."""
    _, _, tengine, mel = engines
    greedy = tengine.generate(mel, options=tengine.build_options(beam_size=1, max_new_tokens=6, kv_cache_dtype="int8"))
    beam = tengine.generate(mel, options=tengine.build_options(beam_size=2, max_new_tokens=6, kv_cache_dtype="int8"))
    assert not np.array_equal(greedy.tokens, beam.tokens)
    assert (beam.sum_logprobs >= greedy.sum_logprobs - 1e-4).all()


def test_cpu_slice_launches_no_kernel(engines):
    _, _, tengine, mel = engines
    before = (int8_mm.launches, cross_attn.launches)
    opts = dataclasses.replace(
        tengine.build_options(beam_size=2, max_new_tokens=2, kv_cache_dtype="int8"), cross_attn="pallas"
    )
    res = tengine.generate(mel, options=opts)
    assert res.tokens.shape == (2, 2) and np.isfinite(res.sum_logprobs).all()
    assert (int8_mm.launches, cross_attn.launches) == before


def test_language_detection_matches_jax(engines, monkeypatch):
    jengine, jparams, tengine, mel = engines
    monkeypatch.setenv("WHISPERX_INT8_MM", "pallas")
    want = jengine.detect_language(jparams, jnp.asarray(mel))
    got = tengine.detect_language(torch.from_numpy(mel))
    assert [c for c, _ in got] == [c for c, _ in want]
    np.testing.assert_allclose([p for _, p in got], [p for _, p in want], rtol=1e-3)
