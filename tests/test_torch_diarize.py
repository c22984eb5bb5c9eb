"""whisperx_tpu_torch's diarization against the JAX package's, on the same
numpy inputs and the same weights: kaldi fbank, the two embedders, the
PyanNet, the pyannote and WeSpeaker converters (from ``.bin`` files),
NeuralVAD, NeuralSegmentation, the overlap diarizer and DiarizationPipeline
in both modes. Turns, labels, cluster assignments and assign_word_speakers
output are identical; embeddings and activities agree within 1e-4."""

import jax
import numpy as np
import pytest
import torch

from tests.test_diarize import (
    _band_energy_scorer,
    _kaldi_fbank_oracle,
    _three_speaker_session,
    _torch_wespeaker,
    _two_simultaneous_speakers,
    _two_speaker_audio,
)
from tests.test_real_checkpoints import _torch_pyannet_from_sd, write_synthetic_pyannet_ckpt
from whisperx_tpu.audio import fbank as jf
from whisperx_tpu.diarize import embed as je
from whisperx_tpu.diarize import pipeline as jp
from whisperx_tpu.diarize import segmentation as js
from whisperx_tpu.models import convert as jc
from whisperx_tpu.models import vad_net as jvn
from whisperx_tpu.vad import model as jvad
from whisperx_tpu_torch.audio import fbank as tf
from whisperx_tpu_torch.diarize import embed as te
from whisperx_tpu_torch.diarize import pipeline as tp
from whisperx_tpu_torch.diarize import segmentation as ts
from whisperx_tpu_torch.models import convert as tc
from whisperx_tpu_torch.models import vad_net as tvn
from whisperx_tpu_torch.vad import model as tvad

torch.set_num_threads(2)

SR = 16000
TOL = 1e-4  # L2-normalised embeddings, sigmoid activities, VAD scores


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            assert np.shape(got[k]) == np.shape(want[k]), f"{path}/{k}"
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"{path}/{k}")


def _with_floor(audio, seed=0):
    """``audio`` over a -50 dB white-noise floor. Pure tones leave most sinc
    bands at rounding level, where InstanceNorm turns float noise into
    features; real recordings never do."""
    return audio + (0.003 * np.random.default_rng(seed).standard_normal(len(audio))).astype(np.float32)


def _turns(df):
    return [(float(r.start), float(r.end), r.speaker, r.label) for r in df.itertuples()]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """A pyannote-layout PyanNet ``.bin`` (2-layer LSTM) and a WeSpeaker
    ``.bin`` in the pyannote wrapper layout (base 4, one block a stage, 16
    fbank bins), both from seeds."""
    root = tmp_path_factory.mktemp("diarize_ckpts")
    seg = write_synthetic_pyannet_ckpt(root / "segmentation.bin")
    net = _torch_wespeaker()
    emb = root / "embedding.bin"
    torch.save({"state_dict": {f"resnet.{k}": v for k, v in net.state_dict().items()}}, emb)
    return {"segmentation": str(seg), "embedding": str(emb), "wespeaker": net}


# ---- front end and embedders -----------------------------------------------


@pytest.mark.parametrize("n_mels", [24, 80])
def test_kaldi_fbank_matches_jax_and_oracle(n_mels):
    rng = np.random.default_rng(3)
    wav = (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    got = tf.kaldi_fbank(wav, num_mel_bins=n_mels, device="cpu").numpy()
    want = np.asarray(jf.kaldi_fbank(wav, num_mel_bins=n_mels))
    assert got.shape == want.shape == (2, 98, n_mels) and got.dtype == np.float32
    # Log energies of narrow banks: the tolerance of the JAX package's own
    # oracle test (tests/test_diarize.py::test_kaldi_fbank_matches_oracle).
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[0], _kaldi_fbank_oracle(wav[0], n_mels=n_mels), rtol=1e-4, atol=1e-4)
    # A 1-D waveform is one row; a tensor stays on its device.
    np.testing.assert_array_equal(tf.kaldi_fbank(wav[1], num_mel_bins=n_mels, device="cpu").numpy()[0], got[1])
    assert tf.kaldi_fbank(torch.from_numpy(wav), num_mel_bins=n_mels).device.type == "cpu"
    assert tf.kaldi_mel_banks(n_mels) is not None
    np.testing.assert_array_equal(tf.kaldi_mel_banks(n_mels), jf.kaldi_mel_banks(n_mels))
    np.testing.assert_array_equal(tf._dft_basis("hamming"), jf._dft_basis("hamming"))


@pytest.mark.parametrize("seconds", [1.5, 5.0])
def test_melstats_embedding_equal(seconds):
    rng = np.random.default_rng(4)
    windows = (rng.standard_normal((5, int(seconds * SR))) * 0.1).astype(np.float32)
    got = te.MelStatsEmbedding("cpu")(windows)
    want = je.MelStatsEmbedding()(windows)
    assert got.shape == want.shape == (5, 240) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("kw", [{}, dict(embed_dim=16, stage_blocks=(1, 1, 1, 1))], ids=["resnet34", "one block a stage"])
def test_init_resnet34_params_equal_jax(kw):
    _, want = je.init_resnet34_params(seed=1, **kw)
    _assert_trees_equal(te.init_resnet34_params(seed=1, **kw), _np_tree(want))


def test_resnet34_from_jax_equal():
    model, variables = je.init_resnet34_params(seed=2, embed_dim=16, stage_blocks=(1, 1, 1, 1))
    net = tc.resnet34_from_jax(_np_tree(variables), device="cpu")
    assert net.n_mels == 80 and not net.training
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((2, 120, 80)).astype(np.float32)
    want = np.asarray(model.apply(variables, feats))
    with torch.inference_mode():
        got = net(torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    windows = (rng.standard_normal((3, 32000)) * 0.1).astype(np.float32)
    got = te.NeuralSpeakerEmbedding(net)(windows)
    want = je.NeuralSpeakerEmbedding(model, variables)(windows)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


# ---- PyanNet ---------------------------------------------------------------


def test_pyannet_from_jax_scores():
    model, params = jvn.init_vad_params(seed=0)
    apply = jax.jit(model.apply)
    net = tc.pyannet_from_jax(_np_tree(params), device="cpu")
    wav = (np.random.default_rng(6).standard_normal((2, 16000)) * 0.1).astype(np.float32)
    want = np.asarray(apply({"params": params}, wav))
    with torch.inference_mode():
        got = net(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (2, tvn.num_frames(16000), 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_array_equal(tvn.frame_centers(16000), jvn.frame_centers(16000))
    # The port's seeded tree has the JAX tree's layout, and both nets read it alike.
    tree = tvn.init_vad_params(seed=1)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert sorted(jax.tree_util.keystr(p) for p, _ in flat) == sorted(
        jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]
    )
    want = np.asarray(apply({"params": tree}, wav))
    with torch.inference_mode():
        got = tc.pyannet_from_jax(tree, device="cpu")(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_pyannet_converter_from_bin(ckpts, tmp_path):
    path = ckpts["segmentation"]
    got, n_classes = tc.convert_pyannet(tc.load_state_dict(path))
    want, j_classes = jc.convert_pyannet(jc.load_state_dict(path))
    assert n_classes == j_classes == 3
    _assert_trees_equal(got, want)
    net = tc.load_pyannet_vad(path, device="cpu")
    assert net.lstm.num_layers == 2
    jmodel, jparams = jc.load_pyannet_vad(path)
    wav = (np.random.default_rng(7).standard_normal((2, 16000)) * 0.1).astype(np.float32)
    with torch.inference_mode():
        out = net(torch.from_numpy(wav)).numpy()
    sd = {k[len("model."):]: v for k, v in tc.load_state_dict(path).items()}
    with torch.no_grad():
        want = _torch_pyannet_from_sd(sd)(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(out, want, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(out, np.asarray(jmodel.apply({"params": jparams}, wav)), rtol=0, atol=TOL)
    # The port module's own state dict is the pyannote layout: it round-trips.
    torch.save(net.state_dict(), tmp_path / "again.bin")
    with torch.inference_mode():
        again = tc.load_pyannet_vad(str(tmp_path / "again.bin"), device="cpu")(torch.from_numpy(wav)).numpy()
    np.testing.assert_array_equal(again, out)


def test_wespeaker_converter_from_bin(ckpts):
    path, oracle = ckpts["embedding"], ckpts["wespeaker"]
    got, kwargs = tc.convert_wespeaker_resnet34(tc.load_state_dict(path))
    want, jkwargs = jc.convert_wespeaker_resnet34(jc.load_state_dict(path))
    assert kwargs == jkwargs == {"embed_dim": 8, "base_channels": 4, "stage_blocks": (1, 1, 1, 1), "two_emb_layer": False}
    _assert_trees_equal(got, want)
    net = tc.load_wespeaker_resnet34(path, device="cpu")
    jmodel, jvariables, j_mels = jc.load_wespeaker_resnet34(path)
    assert net.n_mels == j_mels == 16
    feats = np.random.default_rng(2).standard_normal((2, 27, 16)).astype(np.float32)
    with torch.no_grad():
        want = oracle(torch.from_numpy(feats)).numpy()
        out = net(torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(out, want, rtol=2e-4, atol=2e-5)
    windows = (np.random.default_rng(8).standard_normal((4, 24000)) * 0.1).astype(np.float32)
    np.testing.assert_allclose(
        te.NeuralSpeakerEmbedding(net)(windows), je.NeuralSpeakerEmbedding(jmodel, jvariables, n_mels=j_mels)(windows),
        rtol=0, atol=TOL,
    )


# ---- NeuralVAD and NeuralSegmentation --------------------------------------


@pytest.mark.parametrize("seconds", [3.0, 12.5])
def test_neural_vad_scores_equal(ckpts, seconds):
    audio = _with_floor(np.tile(_two_speaker_audio(), 2)[: int(seconds * SR)])
    with pytest.warns(UserWarning, match="pinned"):
        got_pipe = tvad.load_vad_model("cpu", vad_onset=0.5, vad_offset=0.363, checkpoint=ckpts["segmentation"])
    with pytest.warns(UserWarning, match="pinned"):
        want_pipe = jvad.load_vad_model(None, vad_onset=0.5, vad_offset=0.363, checkpoint=ckpts["segmentation"])
    assert isinstance(got_pipe.scorer, tvad.NeuralVAD)
    got, want = got_pipe.scorer(audio), want_pipe.scorer(audio)
    assert got.scores.dtype == want.scores.dtype == np.float32
    np.testing.assert_array_equal(got.timestamps, want.timestamps)
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=TOL)
    assert got_pipe(audio, chunk_size=5.0) == want_pipe(audio, chunk_size=5.0)


def test_neural_segmentation_activities_equal(ckpts):
    windows = np.stack([_with_floor(_two_speaker_audio()[:80000]), _with_floor(_two_simultaneous_speakers()[0][:80000], 1)])
    got = ts.NeuralSegmentation(tc.load_pyannet_vad(ckpts["segmentation"], device="cpu"))(windows)
    want = js.NeuralSegmentation(*jc.load_pyannet_vad(ckpts["segmentation"]))(windows)
    assert got.shape == want.shape == (2, tvn.num_frames(80000), 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


# ---- DiarizationPipeline ---------------------------------------------------


BAND_SCORER = [(150, 300), (1800, 2200)]


@pytest.mark.parametrize(
    "kw,call",
    [
        ({}, dict(num_speakers=2)),
        ({}, dict(max_speakers=2)),
        ({}, dict(num_speakers=1)),
        (dict(clustering_threshold=1.99), {}),
    ],
    ids=["num_speakers=2", "max_speakers=2", "num_speakers=1", "threshold 1.99"],
)
def test_overlap_diarizer_equal(kw, call):
    """The overlap-aware path with the band-energy oracle scorer
    (tests/test_diarize.py::_band_energy_scorer) and the weight-free embedder."""
    audio, _ = _two_simultaneous_speakers()
    scorer = _band_energy_scorer(BAND_SCORER)
    got = tp.DiarizationPipeline(segmentation=scorer, device="cpu", **kw)(audio, **call)
    want = jp.DiarizationPipeline(segmentation=scorer, **kw)(audio, **call)
    assert _turns(got) == _turns(want) and len(got) > 0
    if call == dict(num_speakers=2):
        at5 = {r.speaker for r in got.itertuples() if r.start <= 5.0 <= r.end}
        assert len(at5) == 2  # both speakers at once inside the overlap


@pytest.mark.parametrize(
    "what",
    ["two speakers", "three speakers", "threshold 1.99", "empty audio"],
)
def test_vad_window_pipeline_equal(what):
    """The VAD-window mode (EnergyVAD windows + MelStatsEmbedding)."""
    kw, call = {}, {}
    if what == "two speakers":
        audio, call = _two_speaker_audio(), dict(num_speakers=2)
    elif what == "three speakers":
        audio, call = _three_speaker_session()[0], dict(num_speakers=3)
    elif what == "threshold 1.99":
        audio, kw = _two_simultaneous_speakers()[0], dict(clustering_threshold=1.99)
    else:
        audio = np.zeros(SR, np.float32)
    got = tp.DiarizationPipeline(device="cpu", **kw)(audio, **call)
    want = jp.DiarizationPipeline(**kw)(audio, **call)
    assert list(got.columns) == list(want.columns)
    assert _turns(got) == _turns(want)
    n = {"two speakers": 2, "three speakers": 3, "threshold 1.99": 1, "empty audio": 0}[what]
    assert got["speaker"].nunique() == n


@pytest.mark.parametrize("mode", ["overlap", "vad-window"])
def test_neural_pipeline_equal(ckpts, mode):
    """Both checkpoints, loaded from ``.bin`` files: the segmentation PyanNet
    (overlap mode) or the neural VAD (VAD-window mode), with the WeSpeaker
    embedder; then assign_word_speakers on a transcript."""
    kw = dict(checkpoint=ckpts["embedding"])
    kw["segmentation_checkpoint" if mode == "overlap" else "vad_checkpoint"] = ckpts["segmentation"]
    audio = np.concatenate([_two_speaker_audio(), _two_simultaneous_speakers()[0]])
    with pytest.warns(UserWarning):
        got_pipe = tp.DiarizationPipeline(device="cpu", **kw)
    with pytest.warns(UserWarning):
        want_pipe = jp.DiarizationPipeline(**kw)
    assert (got_pipe._overlap is not None) == (mode == "overlap")
    assert isinstance(got_pipe.embedder, te.NeuralSpeakerEmbedding)
    got, want = got_pipe(audio, max_speakers=2), want_pipe(audio, max_speakers=2)
    assert _turns(got) == _turns(want)
    from whisperx_tpu.diarize import assign_word_speakers as j_assign
    from whisperx_tpu_torch import assign_word_speakers as t_assign

    words = [{"word": f"w{i}", "start": 0.5 * i, "end": 0.5 * i + 0.4, "score": 0.9} for i in range(40)]
    result = {"segments": [{"start": 0.0, "end": 10.0, "text": "a", "words": words[:20]},
                           {"start": 10.0, "end": 20.0, "text": "b", "words": words[20:]}]}
    import copy

    assert t_assign(got, copy.deepcopy(result)) == j_assign(want, copy.deepcopy(result))


def test_pipeline_reads_a_path_and_raises_on_a_bad_checkpoint(tmp_path):
    from whisperx_tpu_torch.audio.io import write_wav

    audio = _two_speaker_audio()
    write_wav(str(tmp_path / "two.wav"), audio)
    pipe = tp.DiarizationPipeline(device="cpu")
    got = pipe(str(tmp_path / "two.wav"), num_speakers=2)
    want = jp.DiarizationPipeline()(str(tmp_path / "two.wav"), num_speakers=2)
    assert _turns(got) == _turns(want)
    bad = tmp_path / "bad.bin"
    torch.save({"state_dict": {"unrelated.weight": torch.zeros(2)}}, bad)
    for kw in (dict(checkpoint=str(bad)), dict(segmentation_checkpoint=str(bad)), dict(vad_checkpoint=str(bad))):
        with pytest.warns(UserWarning), pytest.raises(KeyError):
            tp.DiarizationPipeline(device="cpu", **kw)


# ---- host code: clustering and assignment ----------------------------------


@pytest.mark.parametrize(
    "kw", [dict(num_speakers=2), dict(max_speakers=3, threshold=0.01), dict(min_speakers=4), dict(threshold=0.7)]
)
def test_cluster_speakers_equal(kw):
    from whisperx_tpu.diarize import cluster_speakers as j_cluster
    from whisperx_tpu_torch.diarize import cluster_speakers as t_cluster

    rng = np.random.default_rng(1)
    emb = rng.standard_normal((16, 6))
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    np.testing.assert_array_equal(t_cluster(emb, **kw), j_cluster(emb, **kw))


def test_assign_word_speakers_equal():
    import copy

    import pandas as pd

    from whisperx_tpu.diarize import assign_word_speakers as j_assign
    from whisperx_tpu_torch.diarize import assign_word_speakers as t_assign

    df = pd.DataFrame({"start": [0.0, 2.0, 5.0], "end": [2.0, 5.0, 10.0], "speaker": ["SPEAKER_00", "SPEAKER_01", "SPEAKER_00"]})
    result = {"segments": [
        {"start": 1.0, "end": 4.0, "text": "w", "words": [{"word": "w", "start": 1.5, "end": 4.0, "score": 1.0},
                                                           {"word": "x"}]},
        {"start": 11.0, "end": 12.0, "text": "y", "words": []},
    ]}
    for fill in (False, True):
        assert t_assign(df, copy.deepcopy(result), fill_nearest=fill) == j_assign(df, copy.deepcopy(result), fill_nearest=fill)
