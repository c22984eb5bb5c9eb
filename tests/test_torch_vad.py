"""whisperx_tpu_torch's VAD against the JAX package's: the host scorers'
frame scores and timestamps bit for bit, and VadPipeline's cut & merge
segments, on the same seeded numpy audio."""

import numpy as np
import pytest
import torch

from torch_routes import force_routes
from traffic_files import traffic_audio
from whisperx_tpu.vad import model as jv
from whisperx_tpu_torch.utils import telemetry
from whisperx_tpu_torch.vad import model as tv

torch.set_num_threads(2)

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


def test_load_vad_model_and_neural_vad_raise(tmp_path):
    """The weight-free default, then a PyanNet ``.bin`` that loads into
    NeuralVAD and scores as the JAX package's (within 1e-4, the same cut &
    merge segments); a checkpoint that does not load raises."""
    import torch

    from tests.test_real_checkpoints import write_synthetic_pyannet_ckpt

    pipe = tv.load_vad_model(vad_onset=0.4, vad_offset=0.3)
    assert isinstance(pipe.scorer, tv.SpeechBandVAD)
    assert (pipe.onset, pipe.offset, pipe.min_duration_on) == (0.4, 0.3, 0.5)
    jpipe = jv.load_vad_model(vad_onset=0.4, vad_offset=0.3)
    audio = _bursts(60)
    assert pipe(audio) == jpipe(audio)

    ckpt = str(write_synthetic_pyannet_ckpt(tmp_path / "segmentation.bin"))
    audio = _speech_band(20)
    for kw in (dict(checkpoint=ckpt), dict(model_fp=ckpt)):
        with pytest.warns(UserWarning, match="pinned reference"):
            pipe = tv.load_vad_model("cpu", vad_onset=0.5, vad_offset=0.363, **kw)
        with pytest.warns(UserWarning, match="pinned reference"):
            jpipe = jv.load_vad_model(None, vad_onset=0.5, vad_offset=0.363, **kw)
        assert isinstance(pipe.scorer, tv.NeuralVAD) and pipe.scorer.model.device.type == "cpu"
        got, want = pipe.scorer(audio), jpipe.scorer(audio)
        np.testing.assert_array_equal(got.timestamps, want.timestamps)
        np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=1e-4)
        assert pipe(audio, chunk_size=5.0) == jpipe(audio, chunk_size=5.0)
    with pytest.raises(RuntimeError, match="mismatch"):
        tv.load_vad_model("cpu", checkpoint=ckpt, expected_sha256="0" * 64)
    bad = tmp_path / "bad.bin"
    torch.save({"state_dict": {"classifier.weight": torch.zeros(3, 128)}}, bad)
    with pytest.warns(UserWarning), pytest.raises((KeyError, ValueError)):
        tv.load_vad_model("cpu", checkpoint=str(bad))
    with pytest.raises(FileNotFoundError):
        tv.load_vad_model("cpu", checkpoint=str(tmp_path / "missing"))


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


def test_band_route_is_the_device():
    """A CUDA device takes the torch band-pass; the CPU and a scorer built
    without a device keep numpy, which records no ``vad.band`` span and
    stays bit-equal to the JAX package."""
    assert tv.band_route(torch.device("cuda")) == tv.band_route(torch.device("cuda:1")) == "torch"
    assert tv.band_route(torch.device("cpu")) == tv.band_route(None) == "numpy"
    assert tv.load_vad_model("cuda").scorer.device == torch.device("cuda")
    assert tv.load_vad_model("cpu").scorer.device == torch.device("cpu")
    assert tv.load_vad_model().scorer.device is None and tv.SpeechBandVAD().device is None
    audio = _speech_band(40)
    start = max((s.span_id for s in telemetry.spans()), default=0)
    for scorer in (tv.SpeechBandVAD(), tv.load_vad_model("cpu").scorer):
        got, want = scorer(audio), jv.SpeechBandVAD()(audio)
        np.testing.assert_array_equal(got.scores, want.scores)
        np.testing.assert_array_equal(got.timestamps, want.timestamps)
    assert not [s for s in telemetry.spans() if s.span_id > start and s.name == "vad.band"]


@pytest.mark.parametrize("n", [991, 1000, 1001, 16000, 16001, 48000, 1_200_007, 14_400_011, 17_280_000])
def test_band_bins_are_the_numpy_mask(n):
    freqs = np.fft.rfftfreq(n, 1.0 / SR)
    kept = np.flatnonzero((freqs >= 300.0) & (freqs <= 3500.0))
    assert tv.band_bins(n, (300.0, 3500.0)) == (kept[0], kept[-1] + 1)


def _rounded(chunks):
    return [(round(c["start"], 3), round(c["end"], 3)) for c in chunks]


@pytest.mark.parametrize("n", [991, 1000, 16001, 100_003, 1_000_000])
@pytest.mark.parametrize("band", [(300.0, 3500.0), (0.0, 8000.0), (0.0, 1000.0), (4000.0, 8000.0), (3500.0, 300.0)])
def test_band_kernel_is_the_mask_response(n, band):
    """The kernel in closed form against the float64 inverse rFFT of the
    kept bins, laid out for a circular convolution at ``conv_length``; the
    0 Hz and n / 2 bins included where a band holds them, none where it
    holds no bin."""
    lo, hi = tv.band_bins(n, band)
    mask = np.zeros(n // 2 + 1)
    mask[lo:hi] = 1.0
    want = np.fft.irfft(mask, n)
    m = tv.conv_length(n)
    g = tv.band_kernel(n, lo, hi, m, torch.device("cpu")).numpy()
    assert g.dtype == np.float32 and g.shape == (m,)
    np.testing.assert_allclose(g[:n], want.astype(np.float32), rtol=0, atol=1e-7 * np.abs(want).max())
    np.testing.assert_array_equal(g[m - n + 1 :], g[1:n][::-1])
    assert not g[n : m - n + 1].any()


@pytest.mark.parametrize("n", [991, 1000, 1001, 6_719_989, 14_400_000, 14_400_011, 17_280_000])
def test_conv_length_holds_a_linear_convolution(n):
    m = tv.conv_length(n)
    k = m.bit_length() - 1
    assert m >= 2 * n - 1 and m in (1 << k, 3 << (k - 1))
    assert not [c for c in (1 << (k - 1), 3 << (k - 2), 1 << k, 3 << (k - 1)) if 2 * n - 1 <= c < m]


# The benchmark's burst shapes (perfbench/traffic/): dense speech, and turns
# between minutes of noise floor; one cut to a prime length, as a recording
# of any length may be.
TRAFFIC = {"dense 3 min": ("longform-dense", 3.0), "dense 7 min": ("longform-dense", 7.0),
           "sparse 10 min": ("sparse-speech", 10.0), "sparse 4 min": ("sparse-speech", 4.0)}
BAND_AUDIO = {**AUDIO, **{k: (lambda t=t: traffic_audio(*t)) for k, t in TRAFFIC.items()},
              "dense 3 min cut to a prime length": lambda: traffic_audio("longform-dense", 3.0)[:2_879_999]}


@pytest.mark.parametrize("what", list(BAND_AUDIO))
def test_torch_band_path_matches_numpy(monkeypatch, what):
    """The card's band-pass, run by torch on the CPU through the seam: the
    same chunks and speech turns as the numpy route to the millisecond, one
    ``vad.band`` span a call. Frame energies: both routes are float32 FFTs,
    whose rounding is a noise near eps32 * log2(n) of the file's amplitude
    spread over every sample, so a frame far below the file's loudest
    carries a larger relative error (up to 1.6e-4 measured, at frames 1e-6
    of the loudest in "tone bursts 75 s") and a frame of pure rounding
    differs wholly; hence 1e-3 relative with a floor of 1e-8 of the
    loudest frame's energy (measured at most 4.7e-10)."""
    audio = BAND_AUDIO[what]()
    n = max(len(audio), tv.FRAME_SIZE)
    padded = np.pad(audio, (0, n - len(audio)))
    starts = np.arange((n - tv.FRAME_SIZE) // tv.FRAME_STEP + 1) * tv.FRAME_STEP
    want = tv.band_energies_numpy(padded, (300.0, 3500.0), starts)
    start = max((s.span_id for s in telemetry.spans()), default=0)
    got = tv.band_energies_torch(padded, (300.0, 3500.0), torch.device("cpu"))
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-8 * want.max())

    pipe = tv.VadPipeline(tv.SpeechBandVAD(device="cpu"))

    def cuts():
        return ([_rounded(pipe(audio, chunk_size=c)) for c in (30.0, 5.0)],
                [(round(t.start, 3), round(t.end, 3)) for t in pipe.speech_turns(audio)])

    numpy_cuts = cuts()
    force_routes(monkeypatch, vad="torch")
    assert cuts() == numpy_cuts
    bands = [s for s in telemetry.spans() if s.span_id > start and s.name == "vad.band"]
    assert len(bands) == 1 + 3  # band_energies_torch, then two chunk sizes and speech_turns
    assert all(s.counts == {"samples": n, "on_card": 0} and s.device == "cpu" for s in bands)
    if what not in AUDIO:
        assert numpy_cuts[0][0]  # every burst file holds speech
