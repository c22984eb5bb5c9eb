"""whisperx_tpu_torch's production pipeline against the JAX package's:
``transcribe`` (VAD cut & merge → fixed batches → int16 upload → log-mel →
decode → text) with the same weights on the same seeded audio gives the same
``{"segments", "language"}``, in fp32 on the CPU; then transcribe → align
word timestamps.

Both pipelines' text backends render every token id (``<id>``), so equal
text means equal tokens. The weights are drawn at scale 0.3 (not init's
0.02) so that the random decoder's tokens depend on the audio."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from whisperx_tpu.align import alignment as ja
from whisperx_tpu.decode.engine import WhisperEngine as JEngine
from whisperx_tpu.decode.tokenizer import ByteBackend as JByteBackend
from whisperx_tpu.models.configs import TEST_CONFIG
from whisperx_tpu.models.whisper import Whisper as JWhisper
from whisperx_tpu.pipeline import asr as jasr
from whisperx_tpu_torch.align import alignment as ta
from whisperx_tpu_torch.audio.io import write_wav
from whisperx_tpu_torch.decode import engine as tengine
from whisperx_tpu_torch.decode.tokenizer import ByteBackend as TByteBackend
from whisperx_tpu_torch.models import whisper as tw
from whisperx_tpu_torch.models.convert import wav2vec2_from_jax, whisper_from_jax
from whisperx_tpu_torch.pipeline import asr as tasr

torch.set_num_threads(2)

SR = 16000
SMALL = dataclasses.replace(TEST_CONFIG, n_text_state=128, n_audio_state=128, n_text_head=2, n_audio_head=2)


class JIds(JByteBackend):
    def decode(self, ids):
        return "".join(f"<{i}>" for i in ids)


class TIds(TByteBackend):
    def decode(self, ids):
        return "".join(f"<{i}>" for i in ids)


def _speechy(seconds, seed=0, freq=210.0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = 0.3 * np.sin(2 * np.pi * freq * t) * (1 + 0.5 * np.sin(2 * np.pi * 3.1 * t)) + 0.05 * rng.standard_normal(len(t))
    pad = np.zeros(SR // 2, np.float32)
    return np.concatenate([pad, x.astype(np.float32), pad])


def _islands(n, gap_s=3.0):
    """n separate speech islands: n VAD chunks at chunk_size=5."""
    gap = np.zeros(int(gap_s * SR), np.float32)
    parts = []
    for i in range(n):
        parts += [_speechy(1.5 + 0.3 * i, seed=i, freq=180.0 + 40 * i), gap]
    return np.concatenate(parts)


def _pair(*, cfg=TEST_CONFIG, language="en", beam_size=1, quantized=False, kv="model", max_new=8):
    """(JAX pipeline, port pipeline) on one seeded weight tree."""
    params = tw.random_params(cfg, seed=0, scale=0.3)
    if quantized:
        params = tw.fuse_qkv_params(tw.quantize_params(params))
    jp = jasr.load_test_pipeline(language=language, beam_size=beam_size, config=cfg)
    jmodel = JWhisper(cfg, quantized=quantized, fused_qkv=quantized)
    jp.engine = JEngine(jmodel, jp.engine.tokenizer)
    jp.model, jp.params = jmodel, jax.tree_util.tree_map(np.asarray, params)
    tp = tasr.load_test_pipeline(language=language, beam_size=beam_size, config=cfg, device="cpu")
    tp.engine = tengine.WhisperEngine(whisper_from_jax(params, cfg, device="cpu"), tp.engine.tokenizer)
    tp.model = tp.engine.model
    for p, backend in ((jp, JIds), (tp, TIds)):
        p.engine.tokenizer.backend = backend(cfg.n_vocab)
        if p.tokenizer is not None:
            p.tokenizer.backend = p.engine.tokenizer.backend
        p.kv_cache_dtype = kv
        p.options = dataclasses.replace(p.options, max_new_tokens=max_new)
    return jp, tp


@pytest.fixture(scope="module")
def fp32_pair():
    return _pair()


def _both(pair, audio, **kw):
    jp, tp = pair
    return tp.transcribe(audio, **kw), jp.transcribe(audio, **kw)


def _distinct_texts(result):
    return len({s["text"] for s in result["segments"]})


@pytest.mark.parametrize("beam", [1, 2])
def test_multibatch_padded_last_batch_equal(fp32_pair, beam):
    """5 chunks at batch 2: three batches, the last one padded."""
    for p in fp32_pair:
        p.options = dataclasses.replace(p.options, beam_size=beam)
    got, want = _both(fp32_pair, _islands(5), batch_size=2, chunk_size=5)
    assert got == want
    assert len(got["segments"]) == 5 and got["language"] == "en"
    assert _distinct_texts(got) >= 2  # the tokens depend on the audio
    # The padding rows change nothing: batch 4 gives the same segments.
    assert fp32_pair[1].transcribe(_islands(5), batch_size=4, chunk_size=5) == got


def test_int8_weights_and_kv_equal(monkeypatch):
    """int8 weights + fused QKV + int8 KV cache on a 128-wide model: the
    port's int8 projections (their plain versions here) and the JAX package's
    int8 kernel (interpret mode) round the inputs to bf16 alike."""
    monkeypatch.setenv("WHISPERX_INT8_MM", "pallas")
    pair = _pair(cfg=SMALL, beam_size=2, quantized=True, kv="int8", max_new=4)
    got, want = _both(pair, _islands(3), batch_size=2, chunk_size=5)
    assert got == want and len(got["segments"]) == 3


def test_empty_audio(fp32_pair):
    got, want = _both(fp32_pair, np.zeros(SR, np.float32), batch_size=2)
    assert got == want == {"segments": [], "language": "en"}


@pytest.mark.parametrize("field", ["initial_prompt", "prefix"])
def test_initial_prompt_and_prefix_equal(fp32_pair, field):
    for p in fp32_pair:
        p.options = dataclasses.replace(p.options, beam_size=1, **{field: "the quick brown fox"})
    try:
        got, want = _both(fp32_pair, _islands(2), batch_size=2, chunk_size=5)
    finally:
        for p in fp32_pair:
            p.options = dataclasses.replace(p.options, **{field: None})
    assert got == want
    plain = fp32_pair[1].transcribe(_islands(2), batch_size=2, chunk_size=5)
    assert got != plain  # the option reached the decoder


def test_suppress_numerals_equal(fp32_pair):
    jp, tp = fp32_pair
    tok_t, tok_j = tp._make_tokenizer("en", "transcribe"), jp._make_tokenizer("en", "transcribe")
    assert tasr.numeral_symbol_tokens(tok_t) == jasr.numeral_symbol_tokens(tok_j) != []
    for p in fp32_pair:
        p.suppress_numerals = True
    try:
        (t_opts, _), (j_opts, _) = tp._search_options(tok_t), jp._search_options(tok_j)
        assert dataclasses.asdict(t_opts) == dataclasses.asdict(j_opts)
        got, want = _both(fp32_pair, _islands(2), batch_size=2, chunk_size=5)
    finally:
        for p in fp32_pair:
            p.suppress_numerals = False
    assert got == want


def test_multilingual_detection_and_reset():
    jp, tp = _pair(language=None)
    audio = _speechy(2.0)
    assert tp.detect_language(audio) == jp.detect_language(audio)
    got, want = _both((jp, tp), audio, batch_size=2)
    assert got == want
    assert tp.tokenizer is None and jp.tokenizer is None
    got, want = _both((jp, tp), audio, batch_size=2, language="fr", task="transcribe")
    assert got == want and got["language"] == "fr"
    assert tp.tokenizer is None


def test_raising_knobs(fp32_pair):
    audio = np.zeros(SR, np.float32)
    for knob, value in (("repetition_penalty", 1.2), ("no_repeat_ngram_size", 3)):
        for p in fp32_pair:
            old = p.options
            p.options = dataclasses.replace(old, **{knob: value})
            try:
                with pytest.raises(NotImplementedError, match=knob):
                    p.transcribe(audio, batch_size=2)
            finally:
                p.options = old


def test_sync_false_result_equals_sync(fp32_pair):
    _, tp = fp32_pair
    mel = tp._mel(np.zeros((2, 480_000), np.int16) + tasr.pcm16(_speechy(29.0)[:480_000]))
    opts = tp.engine.build_options(beam_size=2, max_new_tokens=4)
    lazy = tp.engine.generate(mel, options=opts, sync=False)
    assert isinstance(lazy._tokens, torch.Tensor) and isinstance(lazy._stats, torch.Tensor)
    eager = tp.engine.generate(mel, options=opts)
    assert isinstance(eager._tokens, np.ndarray)
    np.testing.assert_array_equal(lazy.tokens, eager.tokens)
    np.testing.assert_array_equal(lazy.avg_logprobs, eager.avg_logprobs)
    np.testing.assert_array_equal(lazy.no_speech_probs, eager.no_speech_probs)


# ---- the temperature fallback, with stubbed sampled candidates -------------


class _Stub:
    """Stands in for the engine in the retry passes: call n's rows get the
    avg logprobs of ``LPS[n]`` and "c<n>r<row>" as text; records each call's
    rows, temperature, beam size and seed."""

    LPS = [[-0.5, -0.2, -3.0, -3.0], [-0.6, -3.0, -2.0, -1.5], [-1.8, -9.0, -9.0, -9.0], [-4.0, -1.2, -2.5, -9.0]]

    def __init__(self):
        self.calls = []

    def _result(self, mel, options, seed):
        B = mel.shape[0]
        n = len(self.calls)
        self.calls.append((B, options.temperature, options.beam_size, seed))
        return type("R", (), {"avg_logprobs": np.asarray(self.LPS[n], np.float32), "texts": [f"c{n}r{r}" for r in range(B)]})()

    def decode_text(self, result):
        return result.texts


class _JStub(_Stub):
    def generate(self, params, mel, options=None, initial_prompt=None, prefix=None, rng=None, sync=True):
        return self._result(mel, options, int(np.asarray(jax.random.key_data(rng))[-1]))


class _TStub(_Stub):
    def generate(self, mel, options=None, initial_prompt=None, prefix=None, generator=None, sync=True):
        return self._result(mel, options, generator.initial_seed())


def test_fallback_retries_and_gates_the_same_chunks(fp32_pair, monkeypatch):
    jp, tp = fp32_pair
    segs = [{"start": 2.0 * i + 0.1, "end": 2.0 * i + 1.9} for i in range(6)]
    audio = _islands(6)
    texts = ["fine", "abab" * 40, "fine too", "", "low", "silent"]  # chunk 1 compresses too well
    avg = np.array([-0.3, -0.2, -0.4, -0.1, -4.0, -2.0])
    no_speech = np.array([0.1, 0.1, 0.1, 0.1, 0.1, 0.9])
    retried = {}
    out = {}
    for name, p, stub in (("jax", jp, _JStub()), ("torch", tp, _TStub())):
        p.options = dataclasses.replace(
            p.options, enable_fallback=True, best_of=3, temperatures=(0.0, 0.4, 0.8), log_prob_threshold=-1.0,
            compression_ratio_threshold=2.4, no_speech_threshold=0.6,
        )
        seen = retried[name] = []
        orig = type(p)._feature_batches

        def spy(self, a, chunks, batch_size, orig=orig, seen=seen):
            seen.append([c["start"] for c in chunks])
            return orig(self, a, chunks, batch_size)

        monkeypatch.setattr(type(p), "_feature_batches", spy)
        a = avg.copy()
        try:
            res = p._temperature_fallback(
                stub, p.engine.build_options(beam_size=1, max_new_tokens=4), tasr.pcm16(audio), segs, list(texts),
                a, no_speech, 4,
            )
        finally:
            p.options = dataclasses.replace(p.options, enable_fallback=False)
        out[name] = (res, a.tolist(), stub.calls)
    assert out["torch"] == out["jax"]
    assert retried["torch"] == retried["jax"]
    res, lps, calls = out["torch"]
    # Chunks 1, 4 and 5 fail (compression, logprob x2) and are retried, three
    # candidates each; chunk 5 stays low and is gated silent at the end.
    assert retried["torch"][0] == [segs[i]["start"] for i in (1, 4, 5) for _ in range(3)]
    assert [c[:3] for c in calls] == [(4, 0.4, 1)] * 3 + [(4, 0.8, 1)]
    # Temperature 0.4: three candidates each, best avg logprob wins; chunk 5
    # (-1.5) still fails and alone goes to 0.8, where its best (-1.2) fails
    # again, so the silence gate (no-speech 0.9) empties it.
    assert retried["torch"][1] == [segs[5]["start"]] * 3
    assert res == ["fine", "c0r1", "fine too", "", "c1r0", ""]
    np.testing.assert_allclose(lps, [-0.3, -0.2, -0.4, -0.1, -0.6, -1.2])


def test_fallback_samples_on_the_port(fp32_pair):
    """The real sampling path: every chunk fails once and is redrawn."""
    _, tp = fp32_pair
    tp.options = dataclasses.replace(
        tp.options, enable_fallback=True, best_of=2, temperatures=(0.0, 0.8), log_prob_threshold=0.0,
        compression_ratio_threshold=None, no_speech_threshold=None,
    )
    try:
        res = tp.transcribe(_islands(2), batch_size=2, chunk_size=5)
    finally:
        tp.options = dataclasses.replace(tp.options, enable_fallback=False)
    assert len(res["segments"]) == 2 and all(s["text"] for s in res["segments"])


# ---- transcribe → align ----------------------------------------------------


def test_transcribe_then_align_word_timestamps_identical(fp32_pair, tmp_path):
    """The file path through load_audio, transcribe's VAD chunks carrying a
    fixed transcript, then align on both packages (wav2vec2 weights converted
    from the JAX package's test model)."""
    jp, tp = fp32_pair
    path = str(tmp_path / "speech.wav")
    write_wav(path, _islands(4))
    got, want = tp.transcribe(path, batch_size=2, chunk_size=5), jp.transcribe(path, batch_size=2, chunk_size=5)
    assert got == want
    jm = ja.test_align_model("en", seed=0)
    tm = ta.AlignModel(wav2vec2_from_jax(jax.tree_util.tree_map(np.asarray, jm.params), jm.model.config, device="cpu"),
                       jm.dictionary, "en", blank_id=jm.blank_id)
    meta = {"language": "en", "dictionary": jm.dictionary, "type": "jax"}
    words = " hello there general kenobi"
    t_al = ta.align_begin([dict(s, text=words) for s in got["segments"]], tm, meta, path, "cpu").finish()
    j_al = ja.align([dict(s, text=words) for s in want["segments"]], jm, meta, path)
    assert t_al == j_al
    assert len(t_al["word_segments"]) == 4 * len(got["segments"])
    assert all("start" in w and "end" in w for w in t_al["word_segments"])
