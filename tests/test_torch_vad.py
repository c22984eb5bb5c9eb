"""whisperx_tpu_torch's VAD against the JAX package's: the host scorers'
frame scores and timestamps bit for bit, and VadPipeline's cut & merge
segments, on the same seeded numpy audio."""

import numpy as np
import pytest

from whisperx_tpu.vad import model as jv
from whisperx_tpu_torch.vad import model as tv

SR = 16000


def _bursts(seconds, *, on=15, period=25, seed=0, start=0):
    """bench.py's pipeline audio: 220 Hz bursts with 3 Hz AM in silence."""
    rng = np.random.default_rng(seed)
    audio = np.zeros(int(seconds * SR), np.float32)
    tb = np.arange(on * SR) / SR
    burst = (0.3 * np.sin(2 * np.pi * 220 * tb) * (0.75 + 0.25 * np.sin(2 * np.pi * 3 * tb))
             + 0.01 * rng.standard_normal(on * SR)).astype(np.float32)
    for s in range(start, int(seconds) - on + 1, period):
        audio[s * SR : (s + on) * SR] = burst
    return audio


def _speech_band(seconds, seed=1):
    """Noise bed with syllabic bursts of in-band tones (SpeechBandVAD's cues)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    env = (np.sin(2 * np.pi * 4 * t) > 0.2) * (np.sin(2 * np.pi * 0.1 * t) > -0.3)
    x = 0.2 * env * (np.sin(2 * np.pi * 700 * t) + 0.5 * np.sin(2 * np.pi * 1500 * t))
    return (x + 0.005 * rng.standard_normal(len(t))).astype(np.float32)


AUDIO = {
    "tone bursts 75 s": lambda: _bursts(75),
    "silence 3 s": lambda: np.zeros(3 * SR, np.float32),
    "shorter than one frame": lambda: (np.random.default_rng(2).standard_normal(500) * 0.1).astype(np.float32),
    "speech longer than 30 s": lambda: _bursts(70, on=65, period=70),
    "speech band 40 s": lambda: _speech_band(40),
}


# Fewer frames than a smoothing kernel: the JAX scorers' np.convolve(mode=
# "same") returns the kernel's length and binarize raises; the port keeps the
# frame count (vad/model.py:_convolve_same).
JAX_RAISES = {("shorter than one frame", "EnergyVAD"), ("shorter than one frame", "SpeechBandVAD")}


def _jax(scorer, what, fn):
    """``fn()`` on the JAX side, or None after checking that it raises."""
    if (what, scorer) in JAX_RAISES:
        with pytest.raises((ValueError, AssertionError)):
            fn()
        return None
    return fn()


def _turns(turns):
    return [(t.start, t.end) for t in turns]


@pytest.mark.parametrize("scorer", ["EnergyVAD", "SpeechBandVAD"])
@pytest.mark.parametrize("what", list(AUDIO))
def test_scores_bit_equal(scorer, what):
    audio = AUDIO[what]()
    got = getattr(tv, scorer)()(audio)
    assert got.scores.shape == got.timestamps.shape
    if (what, scorer) in JAX_RAISES:
        assert len(got.scores) == 1
        return
    want = getattr(jv, scorer)()(audio)
    assert got.scores.dtype == want.scores.dtype == np.float32
    np.testing.assert_array_equal(got.scores, want.scores)
    np.testing.assert_array_equal(got.timestamps, want.timestamps)


@pytest.mark.parametrize("scorer", ["EnergyVAD", "SpeechBandVAD"])
@pytest.mark.parametrize("what", list(AUDIO))
def test_pipeline_segments_equal(scorer, what):
    audio = AUDIO[what]()
    t_pipe = tv.VadPipeline(getattr(tv, scorer)(), onset=0.5, offset=0.363)
    j_pipe = jv.VadPipeline(getattr(jv, scorer)(), onset=0.5, offset=0.363)
    assert t_pipe.min_duration_on == j_pipe.min_duration_on
    for chunk in (30.0, 5.0):
        got = t_pipe(audio, chunk_size=chunk)
        want = _jax(scorer, what, lambda: j_pipe(audio, chunk_size=chunk))
        assert got == (want if want is not None else [])
        assert all(s["end"] - s["start"] <= chunk + 1e-6 for s in got)
    got = _turns(t_pipe.speech_turns(audio))
    want = _jax(scorer, what, lambda: _turns(j_pipe.speech_turns(audio)))
    assert got == (want if want is not None else [])
    if (what, scorer) == ("speech longer than 30 s", "EnergyVAD"):
        assert len(t_pipe(audio)) >= 2  # the min-cut splits the long turn
    if what == "silence 3 s":
        assert t_pipe(audio) == []


def test_load_vad_model_and_neural_vad_raise():
    pipe = tv.load_vad_model(vad_onset=0.4, vad_offset=0.3)
    assert isinstance(pipe.scorer, tv.SpeechBandVAD)
    assert (pipe.onset, pipe.offset, pipe.min_duration_on) == (0.4, 0.3, 0.5)
    jpipe = jv.load_vad_model(vad_onset=0.4, vad_offset=0.3)
    audio = _bursts(60)
    assert pipe(audio) == jpipe(audio)
    for kw in (dict(checkpoint="segmentation.bin"), dict(model_fp="segmentation.bin")):
        with pytest.raises(NotImplementedError, match="item 8"):
            tv.load_vad_model(**kw)
    with pytest.raises(NotImplementedError, match="item 8"):
        tv.NeuralVAD(None, None)


def test_checkpoint_digest_check_equal(tmp_path):
    f = tmp_path / "ckpt.bin"
    f.write_bytes(b"not the pinned weights")
    assert tv.VAD_SEGMENTATION_SHA256 == jv.VAD_SEGMENTATION_SHA256
    with pytest.warns(UserWarning, match="pinned reference"):
        digest = tv.verify_checkpoint_sha256(str(f), None)
    with pytest.warns(UserWarning):
        assert digest == jv.verify_checkpoint_sha256(str(f), None)
    assert tv.verify_checkpoint_sha256(str(f), digest) == digest
    with pytest.raises(RuntimeError, match="mismatch"):
        tv.verify_checkpoint_sha256(str(f), "0" * 64)


def test_frame_helpers_equal():
    rng = np.random.default_rng(5)
    x = rng.standard_normal(50_000).astype(np.float32)
    starts = np.arange(180) * tv.FRAME_STEP
    np.testing.assert_array_equal(tv._frame_sq_sums(x, starts, tv.FRAME_SIZE), jv._frame_sq_sums(x, starts, jv.FRAME_SIZE))
    for w in (3, 14, 47):
        np.testing.assert_array_equal(tv._rolling_mean(x[:1000], w), jv._rolling_mean(x[:1000], w))
