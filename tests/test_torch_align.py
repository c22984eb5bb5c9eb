"""whisperx_tpu_torch ``align()`` against the JAX package's on the same random
``test_align_model`` weights (converted with ``wav2vec2_from_jax``), in fp32
on the CPU: segments, words, chars and timestamps must be identical."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from whisperx_tpu.align import alignment as ja
from whisperx_tpu.models.configs import WAV2VEC2_LARGE, WAV2VEC2_TEST
from whisperx_tpu.models.wav2vec2 import init_wav2vec2_params
from whisperx_tpu_torch.align import alignment as ta
from whisperx_tpu_torch.models.convert import wav2vec2_from_jax
from whisperx_tpu_torch.utils import telemetry

torch.set_num_threads(2)

SR = 16000
WORDS = ["hello there", "general kenobi", "you are bold", "as expected", "the archives are complete"]


def _port(jmodel, cfg=WAV2VEC2_TEST):
    model = wav2vec2_from_jax(jax.tree_util.tree_map(np.asarray, jmodel.params), cfg, device="cpu")
    return ta.AlignModel(model, jmodel.dictionary, jmodel.language, blank_id=jmodel.blank_id, max_batch=jmodel.max_batch)


@pytest.fixture(scope="module")
def models():
    jm = ja.test_align_model("en", seed=0)
    return jm, _port(jm)


def _meta(model, lang="en"):
    return {"language": lang, "dictionary": model.dictionary, "type": "jax"}


def _both(models, transcript, audio, lang="en", **kw):
    jm, tm = models
    want = ja.align([dict(s) for s in transcript], jm, _meta(jm, lang), audio, **kw)
    got = ta.align([dict(s) for s in transcript], tm, _meta(tm, lang), audio, "cpu", **kw)
    return got, want


def _audio(seed, seconds):
    return (np.random.default_rng(seed).standard_normal(seconds * SR) * 0.1).astype(np.float32)


def test_sentences_and_char_alignments_identical(models):
    """Several sentences per segment (Punkt rules, the sentence merge of
    equal timestamps) and per-char output."""
    transcript = [
        {"start": 0.1, "end": 1.9, "text": " Good day. Nice cat! Dr. Who?"},
        {"start": 2.0, "end": 3.9, "text": " hello there. general kenobi"},
        {"start": 4.1, "end": 4.6, "text": " a. b. c."},
    ]
    got, want = _both(models, transcript, _audio(0, 5), return_char_alignments=True)
    assert got == want
    assert len(got["segments"]) > len(transcript)
    assert any("start" in c for seg in got["segments"] for c in seg["chars"])


def test_charwise_language_identical(models):
    got, want = _both(models, [{"start": 0.0, "end": 1.5, "text": "hello"}], _audio(1, 2), lang="ja")
    assert got == want
    assert [w["word"] for w in got["word_segments"]] == list("hello")


def test_fallbacks_identical(models, capsys):
    transcript = [
        {"start": 0.0, "end": 0.9, "text": "123456"},  # no dictionary characters
        {"start": 5.0, "end": 6.0, "text": " hello"},  # starts beyond the audio
        {"start": 0.2, "end": 0.9, "text": " fine"},
    ]
    got, want = _both(models, transcript, _audio(2, 1))
    assert got == want
    assert got["segments"][0] == {"start": 0.0, "end": 0.9, "text": "123456", "words": []}
    assert got["segments"][1]["words"] == []
    assert "resorting to original" in capsys.readouterr().out


def test_multibatch_ladder_identical(models):
    """Five segments at max_batch 2: three launches, the last on the halving
    ladder, in length order."""
    jm, tm = models
    jm2, tm2 = dataclasses.replace(jm, max_batch=2), dataclasses.replace(tm, max_batch=2)
    transcript = [{"start": 2.0 * i + 0.1, "end": 2.0 * i + 1.9 - 0.2 * i, "text": " " + w} for i, w in enumerate(WORDS)]
    got, want = _both((jm2, tm2), transcript, _audio(3, 10))
    assert got == want
    assert ta._ladder_rows(1, 8) == 2 and ta._ladder_rows(3, 8) == 4 and ta._ladder_rows(5, 8) == 8


def test_deferred_and_windowed_equal_sync(models, monkeypatch):
    _, tm = models
    tm2 = dataclasses.replace(tm, max_batch=2)
    transcript = [{"start": 2.0 * i + 0.1, "end": 2.0 * i + 1.9, "text": " " + w} for i, w in enumerate(WORDS)]
    audio = _audio(4, 10)
    sync = ta.align([dict(s) for s in transcript], tm2, _meta(tm2), audio, "cpu")
    job = ta.align_begin([dict(s) for s in transcript], tm2, _meta(tm2), audio, "cpu")
    _ = torch.ones(64, 64) @ torch.ones(64, 64)  # unrelated work between begin and finish
    deferred = job.finish()
    assert deferred == sync and job.finish() is deferred
    monkeypatch.setattr(ta, "MAX_INFLIGHT", 1)
    assert ta.align_begin([dict(s) for s in transcript], tm2, _meta(tm2), audio, "cpu").finish() == sync
    assert telemetry.GLOBAL.stages["align"].calls >= 3


def test_host_backtrack_identical_to_device_and_jax(models, monkeypatch):
    """The port's one walk (the device route) against both of the JAX
    package's: its device walk and, under its ``WHISPERX_CTC_BACKTRACK=host``,
    its numpy walk."""
    transcript = [{"start": 0.1, "end": 1.4, "text": " hello there"}, {"start": 1.5, "end": 2.8, "text": " general kenobi"}]
    audio = _audio(5, 3)
    monkeypatch.delenv("WHISPERX_CTC_BACKTRACK", raising=False)
    device, jdevice = _both(models, transcript, audio)
    monkeypatch.setenv("WHISPERX_CTC_BACKTRACK", "host")
    again, jhost = _both(models, transcript, audio)
    assert device == again == jdevice == jhost


def test_align_takes_the_device_walk_whatever_the_jax_variable_says(models, monkeypatch):
    """``WHISPERX_CTC_BACKTRACK=host`` is the JAX package's: the port's
    ``align_begin`` still runs one ``ctc_align_batch_device`` a batch."""
    _, tm = models
    calls = []
    walk = ta.ctc_align_batch_device

    def counted(*args, **kw):
        calls.append(args[0].shape[0])
        return walk(*args, **kw)

    monkeypatch.setattr(ta, "ctc_align_batch_device", counted)
    monkeypatch.setenv("WHISPERX_CTC_BACKTRACK", "host")
    tm2 = dataclasses.replace(tm, max_batch=2)
    transcript = [{"start": 2.0 * i + 0.1, "end": 2.0 * i + 1.9, "text": " " + w} for i, w in enumerate(WORDS)]
    out = ta.align(transcript, tm2, _meta(tm2), _audio(6, 10), "cpu")
    assert calls == [2, 2, ta._ladder_rows(1, 2)]  # five segments: two full batches and one on the ladder
    assert all(seg["words"] for seg in out["segments"])


@pytest.mark.parametrize("seconds,padded", [(0.3, 1), (1.0, 1), (1.2, 2)])
def test_bucket_len_pads_to_whole_seconds(seconds, padded):
    assert ta._bucket_len(int(seconds * SR)) == padded * SR


def test_int16_uploads_equal_float(monkeypatch):
    """A large-style model (conv bias: not scale-invariant) on int16-grid
    audio: int16 uploads divided on the device give the float result, and
    equal the JAX package's with its device walk and with its host walk."""
    cfg = dataclasses.replace(
        WAV2VEC2_LARGE, name="test-tiny", vocab_size=29, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64,
        conv_layers=((16, 10, 5), (16, 3, 2), (16, 2, 2)), num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
    )
    jmodel, params = init_wav2vec2_params(cfg, seed=0)
    chars = ["[pad]", "|", "'"] + [chr(c) for c in range(ord("a"), ord("z") + 1)]
    jm = ja.AlignModel(jmodel, params, {c: i for i, c in enumerate(chars)}, "en", blank_id=0, max_batch=4)
    tm = _port(jm, cfg)
    audio = np.random.default_rng(7).integers(-32768, 32768, 2 * SR).astype(np.float32) / 32768.0
    transcript = [{"start": 0.0, "end": 2.0, "text": " hello world"}]

    def run(int16, backtrack):
        monkeypatch.setenv("WHISPERX_WAV_INT16", "1" if int16 else "0")
        monkeypatch.setenv("WHISPERX_CTC_BACKTRACK", backtrack)  # the JAX package's walk
        return _both((jm, tm), transcript, audio)

    got16, want16 = run(True, "device")
    got32, _ = run(False, "device")
    _, jhost16 = run(True, "host")
    assert got16 == got32 == want16 == jhost16
    assert got16["word_segments"] and "start" in got16["word_segments"][0]


def test_entry_points_need_the_card_unless_cpu_is_asked(models, monkeypatch, tmp_path):
    _, tm = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ta.test_align_model()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ta.align([{"start": 0.0, "end": 1.0, "text": " a"}], tm, _meta(tm), _audio(0, 1))
    # A file path goes through load_audio: the same result as its waveform.
    from whisperx_tpu_torch.audio.io import load_audio, write_wav

    write_wav(str(tmp_path / "speech.wav"), _audio(0, 1))
    transcript = [{"start": 0.1, "end": 0.9, "text": " hello"}]
    assert ta.align([dict(s) for s in transcript], tm, _meta(tm), str(tmp_path / "speech.wav"), "cpu") == ta.align(
        [dict(s) for s in transcript], tm, _meta(tm), load_audio(str(tmp_path / "speech.wav")), "cpu"
    )
    assert ta.test_align_model(device="cpu", seed=3).model.device.type == "cpu"
