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

from torch_routes import force_routes
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
    force_routes(monkeypatch, cross=cross)
    kw = dict(beam_size=beam, max_new_tokens=6, kv_cache_dtype="int8")
    jopts = dataclasses.replace(jengine.build_options(**kw), cross_attn=cross)
    topts = tengine.build_options(**kw)
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


def test_cpu_slice_launches_no_kernel(engines, monkeypatch):
    _, _, tengine, mel = engines
    before = (int8_mm.launches, cross_attn.launches)
    force_routes(monkeypatch, cross="pallas")
    res = tengine.generate(mel, options=tengine.build_options(beam_size=2, max_new_tokens=2, kv_cache_dtype="int8"))
    assert res.tokens.shape == (2, 2) and np.isfinite(res.sum_logprobs).all()
    assert (int8_mm.launches, cross_attn.launches) == before


def test_language_detection_matches_jax(engines, monkeypatch):
    jengine, jparams, tengine, mel = engines
    monkeypatch.setenv("WHISPERX_INT8_MM", "pallas")
    want = jengine.detect_language(jparams, jnp.asarray(mel))
    got = tengine.detect_language(torch.from_numpy(mel))
    assert [c for c, _ in got] == [c for c, _ in want]
    np.testing.assert_allclose([p for _, p in got], [p for _, p in want], rtol=1e-3)


def test_the_cpu_runs_the_host_loop(engines):
    """The rule of ``WhisperEngine.uses_device_loop``: the device loop needs a
    card; on the CPU every decode runs the host loop and makes no loop graph.
    The no-speech probability read at the SOT position stays on the device
    (an index_select) and equals softmax of the logits there."""
    from whisperx_tpu_torch.ops import graph_loop

    _, _, tengine, mel = engines
    greedy = tengine.build_options(beam_size=1, max_new_tokens=2, kv_cache_dtype="int8")
    for opts in (greedy, dataclasses.replace(greedy, beam_size=2), dataclasses.replace(greedy, temperature=0.5)):
        assert not tengine.uses_device_loop(opts)
    before = graph_loop.launches
    res = tengine.generate(mel, options=greedy, generator=torch.Generator().manual_seed(0))
    assert graph_loop.launches == before and not tengine.model.decode_loops
    with torch.inference_mode():
        states = tengine._encode(torch.from_numpy(mel))
        prompt = tengine.build_prompt(2)
        logits, cache, no_speech = tengine._prompt_cache(states, prompt, 64, kv_bits=8)
        layout = tengine.tokenizer.layout
        full, _ = tengine.model.decode_step(prompt, tengine.model.empty_cache(2, torch.int8, 64) | {"cross": cache["cross"]}, 0)
        sot = prompt[0].tolist().index(layout.sot)
        want = torch.softmax(full[:, sot], dim=-1)[:, layout.no_speech]
    assert torch.equal(no_speech, want)
    np.testing.assert_array_equal(res.no_speech_probs, no_speech.numpy())


@pytest.mark.parametrize("kv_bits,cross_impl", [(0, "xla"), (8, "xla"), (4, "xla"), (8, "pallas"), (0, "pallas")])
def test_prompt_cache_writes_cross_kv_into_given_buffers(engines, kv_bits, cross_impl):
    """``_prompt_cache(cross=...)`` (a device loop's static cross K/V) writes
    each layer's cross K/V into the given buffers and returns those very
    buffers, equal to the ones it makes without them, with the same logits,
    self cache and no-speech probability; the layer-by-layer computation
    equals the model's ``compute_cross_kv`` of all layers at once."""
    _, _, tengine, mel = engines
    with torch.inference_mode():
        states = tengine._encode(torch.from_numpy(mel))
        prompt = tengine.build_prompt(2)
        fresh = tengine._prompt_cache(states, prompt, 64, kv_bits=kv_bits, cross_impl=cross_impl)
        filled = [[torch.full_like(t, 3) for t in kv] for kv in fresh[1]["cross"]]
        bufs = [tw.FlatCrossKV(*f) if isinstance(kv, tw.FlatCrossKV) else tuple(f) for f, kv in zip(filled, fresh[1]["cross"])]
        got = tengine._prompt_cache(states, prompt, 64, kv_bits=kv_bits, cross_impl=cross_impl, cross=bufs)
        whole = tengine.model.compute_cross_kv(states)
    assert got[1]["cross"] is bufs
    for mine, theirs in zip(bufs, fresh[1]["cross"]):
        assert all(torch.equal(a, b) for a, b in zip(mine, theirs))
    if kv_bits == 0 and cross_impl == "xla":
        assert all(torch.equal(a, b) for kv, ref in zip(fresh[1]["cross"], whole) for a, b in zip(kv, ref))
    assert torch.equal(got[0], fresh[0]) and torch.equal(got[2], fresh[2])
    for layer, ref in zip(got[1]["self"], fresh[1]["self"]):
        assert all(torch.equal(layer[n], ref[n]) for n in layer)
