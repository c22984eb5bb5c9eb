"""whisperx_tpu_torch's parallel/ against the JAX package's, on the CPU.

The port runs one process per rank under ``torch.distributed`` (gloo here).
A module fixture starts this file's own ``__main__`` worker as four ranks of
one world; each rank builds the meshes, runs every scenario and prints its
results as JSON. The JAX side runs in the pytest process on the conftest's
eight virtual devices, on the same numpy weights and inputs: tensor-parallel
greedy and beam decode (tokens equal, log-probs within 1e-3), int8 weights
with the int8 KV cache, ``transcribe`` under (4, 1) and (2, 2) meshes,
``shard_align_model`` alignment, diarization, and the helpers' row counts.
A second fixture runs the command line as two ranks (torchrun's variables)
and once as one process: each rank writes only its share of the files, and
the files are byte-equal.

Run the workers alone: ``python tests/test_torch_parallel.py <dir>`` with
COORDINATOR_ADDRESS, NUM_PROCESSES and PROCESS_ID set (the fixture writes
``<dir>/align.npz`` and ``<dir>/align.json`` first). A third fixture runs
``python tests/test_torch_parallel.py <dir> fallback`` as two ranks of a
(2, 1) mesh: the sampled decodes (the fallback's ``best_of`` candidates
across data ranks, and a sampled first pass called twice).
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RANKS = 4
SR = 16000
MAX_NEW = 6
MEL_ROWS = 4
INT8_MEL_SEED = 9  # tests/test_parallel.py's int8-KV mesh case
FALLBACK_BEST_OF = 4  # candidates a chunk: two rows on each of two data ranks


# ---- inputs shared by both sides (numpy only) --------------------------------


def _mel(seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((MEL_ROWS, 80, 3000)) * 0.5).astype(np.float32)


def _configs():
    from whisperx_tpu_torch.models.configs import TEST_CONFIG

    return {
        "test": TEST_CONFIG,
        # n_vocab even: the token embedding splits over the model axis.
        "vocab51866": dataclasses.replace(TEST_CONFIG, n_vocab=51866),
        # 256 wide, 4 heads: every decoder projection's shard is a multiple of
        # 128, so the int8 ones take int8_matmul at the split shapes.
        "wide": dataclasses.replace(
            TEST_CONFIG, n_audio_state=256, n_text_state=256, n_audio_head=4, n_text_head=4
        ),
    }


def _weights(cfg) -> dict:
    """fp32 weights at scale 0.3 (not init's 0.02), so that the random
    decoder's tokens depend on the audio."""
    from whisperx_tpu_torch.models import whisper as tw

    return tw.random_params(cfg, seed=0, scale=0.3)


def _int8_weights(cfg) -> dict:
    """int8 weights from the JAX package's init (scale 0.02), as its own
    int8-KV mesh test (tests/test_parallel.py) draws them. At scale 0.3 the
    int8 KV grid turns the fp32 difference of the split sums (encoder states
    5e-6 apart) into first-step logits 1.3% apart, and one of four rows
    takes another beam from its third token: int8 under a split is not
    bit-exact, fp32 is."""
    from whisperx_tpu_torch.models import whisper as tw

    return tw.quantize_params(tw.random_params(cfg, seed=0))


def _speechy(seconds, seed=0, freq=210.0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = 0.3 * np.sin(2 * np.pi * freq * t) * (1 + 0.5 * np.sin(2 * np.pi * 3.1 * t))
    x = x + 0.05 * rng.standard_normal(len(t))
    pad = np.zeros(SR // 2, np.float32)
    return np.concatenate([pad, x.astype(np.float32), pad])


def _islands(n, gap_s=3.0):
    """n separate speech islands: n VAD chunks at chunk_size=5."""
    gap = np.zeros(int(gap_s * SR), np.float32)
    parts = []
    for i in range(n):
        parts += [_speechy(1.5 + 0.3 * i, seed=i, freq=180.0 + 40 * i), gap]
    return np.concatenate(parts)


ALIGN_WORDS = ["hello there", "general kenobi", "you are bold", "as expected", "the archives are complete"]


def _align_inputs():
    audio = (np.random.default_rng(5).standard_normal(30 * SR) * 0.1).astype(np.float32)
    five = [{"start": 0.3 + 6.0 * i, "end": 5.5 + 6.0 * i, "text": w} for i, w in enumerate(ALIGN_WORDS)]
    return audio, [five, five[:3]]


def _diarize_audio():
    t = np.arange(40 * SR) / SR
    return np.where(
        (t // 5).astype(np.int64) % 2 == 0, 0.3 * np.sin(2 * np.pi * 180 * t), 0.3 * np.sin(2 * np.pi * 1400 * t)
    ).astype(np.float32)


def _turns(df) -> list:
    return [[float(s), float(e), str(k)] for s, e, k in zip(df["start"], df["end"], df["speaker"])]


def _canon(result) -> str:
    """A result dict as canonical JSON (NaN included), numpy scalars as
    Python ones."""

    def default(o):
        if isinstance(o, np.generic):
            return o.item()
        raise TypeError(type(o))

    return json.dumps(result, sort_keys=True, default=default)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, v


def _nest(flat) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parts, last = path.split("/")
        for p in parts:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


# ---- the rank worker (port only: no JAX in this process) --------------------


def _worker(data_dir: str) -> dict:
    import torch

    torch.set_num_threads(1)
    from whisperx_tpu_torch.align import alignment as ta
    from whisperx_tpu_torch.decode.engine import WhisperEngine
    from whisperx_tpu_torch.decode.tokenizer import ByteBackend, WhisperTokenizer
    from whisperx_tpu_torch.diarize import pipeline as tdp
    from whisperx_tpu_torch.diarize.embed import NeuralSpeakerEmbedding, init_resnet34_params
    from whisperx_tpu_torch.diarize.segmentation import NeuralSegmentation
    from whisperx_tpu_torch.models import whisper as tw
    from whisperx_tpu_torch.models.configs import WAV2VEC2_TEST
    from whisperx_tpu_torch.models.convert import resnet34_from_jax, wav2vec2_from_jax, whisper_from_jax
    from whisperx_tpu_torch.models.vad_net import PyanNetVAD
    from whisperx_tpu_torch.parallel import distributed as pd
    from whisperx_tpu_torch.parallel import make_mesh, pad_rows_to_mesh, shard_batch
    from whisperx_tpu_torch.parallel.mesh import gather_rows
    from whisperx_tpu_torch.pipeline import asr as tasr
    from whisperx_tpu_torch.vad.model import EnergyVAD, VadPipeline

    pd.initialize(backend="gloo")  # COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID
    rank = pd.rank()
    meshes = {
        4: make_mesh(device="cpu"),  # (4, 1)
        2: make_mesh(n_model=2, device="cpu"),  # (2, 2)
        1: make_mesh(n_data=1, n_model=4, device="cpu"),  # (1, 4)
    }
    m41, m22 = meshes[4], meshes[2]
    out = {
        "info": pd.process_info(),
        "slice": [pd.local_batch_slice(8).start, pd.local_batch_slice(8).stop],
        "files": pd.shard_files([f"f{i}.wav" for i in range(7)]),
        "shapes": {str(n): list(m.shape) for n, m in meshes.items()},
        "gather": gather_rows(m41, torch.tensor([[rank, 10 + rank]])).tolist(),
    }
    out["pad_rows"] = {
        str(n): [pad_rows_to_mesh(m, np.zeros((b, 3), np.float32)).shape[0] * n for b in range(1, 10)]
        for n, m in meshes.items()
    }
    out["ladder"] = {
        str(n): {str(mb): [ta._ladder_rows(b, mb, m) for b in range(1, 10)] for mb in (8, 12)}
        for n, m in meshes.items()
    }

    # Row-parallel int8 projections: record every int8_matmul call's shape.
    calls = []
    kernel = tw.int8_matmul

    def recording(x, w, scale, bias=None, *, out_dtype=torch.bfloat16):
        calls.append((int(w.shape[0]), int(w.shape[1]), bias is None, str(out_dtype)))
        return kernel(x, w, scale, bias, out_dtype=out_dtype)

    tw.int8_matmul = recording

    cfgs = _configs()

    def decode(cfg, params, beam, kv="model", mel_seed=3):
        model = whisper_from_jax(params, cfg, device="cpu", mesh=m22)
        engine = WhisperEngine(model, WhisperTokenizer.dummy(cfg.n_vocab, language="en"))
        opts = engine.build_options(beam_size=beam, max_new_tokens=MAX_NEW, kv_cache_dtype=kv)
        r = engine.generate(shard_batch(m22, _mel(mel_seed)), options=opts, sync=False).gathered(m22)
        local = model.decoder.layers[0].attn
        return {
            "tokens": r.tokens.tolist(),
            "sum_logprobs": r.sum_logprobs.tolist(),
            "heads": local.n_head,
            "vocab_rows": int(model.decoder.token_embedding.shape[0]),
        }

    for name in ("test", "vocab51866"):
        for beam in (1, 2):
            out[f"decode/{name}/{beam}"] = decode(cfgs[name], _weights(cfgs[name]), beam)
    calls.clear()
    out["decode/int8/3"] = decode(cfgs["wide"], _int8_weights(cfgs["wide"]), 3, kv="int8", mel_seed=INT8_MEL_SEED)
    out["int8_calls"] = sorted(set(calls))

    class Ids(ByteBackend):
        def decode(self, ids):
            return "".join(f"<{i}>" for i in ids)

    def transcribe(mesh):
        cfg = cfgs["test"]
        model = whisper_from_jax(_weights(cfg), cfg, device="cpu", mesh=mesh)
        base, tok = (WhisperTokenizer.dummy(cfg.n_vocab, language="en") for _ in range(2))
        base.backend = tok.backend = Ids(cfg.n_vocab)
        pipe = tasr.WhisperPipeline(
            WhisperEngine(model, base), VadPipeline(EnergyVAD()), {"vad_onset": 0.5, "vad_offset": 0.363},
            tasr.TranscriptionOptions(beam_size=2, max_new_tokens=8), tokenizer=tok, language="en", mesh=mesh,
        )
        return pipe.transcribe(_islands(5), batch_size=2, chunk_size=5)

    out["transcribe/4x1"] = transcribe(m41)
    out["transcribe/2x2"] = transcribe(m22)

    with np.load(os.path.join(data_dir, "align.npz")) as f:
        tree = _nest(dict(f))
    with open(os.path.join(data_dir, "align.json")) as f:
        meta = json.load(f)
    am = ta.AlignModel(
        wav2vec2_from_jax(tree, WAV2VEC2_TEST, device="cpu"), meta["dictionary"], "en",
        blank_id=meta["blank_id"], max_batch=meta["max_batch"],
    )
    sharded = ta.shard_align_model(am, m22)
    audio, transcripts = _align_inputs()
    align_meta = {"language": "en", "dictionary": am.dictionary, "type": "torch"}
    out["align"] = [_canon(ta.align([dict(s) for s in t], sharded, align_meta, audio, "cpu")) for t in transcripts]
    out["align_max_batch"] = sharded.max_batch
    out["align_heads"] = sharded.model.layers[0].attention.num_heads

    diar_audio = _diarize_audio()
    out["diarize"] = _turns(tdp.DiarizationPipeline(device="cpu", mesh=m41)(diar_audio, min_speakers=2, max_speakers=2))

    def neural(mesh):
        torch.manual_seed(0)
        seg = PyanNetVAD()
        with torch.no_grad():
            seg.classifier.bias += 3.0  # every class active
        net = resnet34_from_jax(init_resnet34_params(seed=0, stage_blocks=(1, 1, 1, 1)), device="cpu")
        pipe = tdp.DiarizationPipeline(
            device="cpu", embedder=NeuralSpeakerEmbedding(net), segmentation=NeuralSegmentation(seg), mesh=mesh
        )
        return _turns(pipe(diar_audio[: 20 * SR], min_speakers=2, max_speakers=2))

    out["neural_diarize"] = {"mesh": neural(m41), "single": neural(None)}
    return out


def _fallback_worker() -> dict:
    """Two data ranks, mesh (2, 1), each with the whole model: the sampled
    decodes of ``transcribe`` (fault 3.1 of the port's ROADMAP)."""
    import torch

    torch.set_num_threads(1)
    from whisperx_tpu_torch.decode.engine import WhisperEngine
    from whisperx_tpu_torch.decode.tokenizer import ByteBackend, WhisperTokenizer
    from whisperx_tpu_torch.models.convert import whisper_from_jax
    from whisperx_tpu_torch.parallel import distributed as pd
    from whisperx_tpu_torch.parallel import make_mesh
    from whisperx_tpu_torch.pipeline import asr as tasr
    from whisperx_tpu_torch.vad.model import EnergyVAD, VadPipeline

    pd.initialize(backend="gloo")
    mesh = make_mesh(device="cpu")  # (2, 1)
    cfg = _configs()["test"]
    model = whisper_from_jax(_weights(cfg), cfg, device="cpu")

    class Ids(ByteBackend):
        def decode(self, ids):
            return "".join(f"<{i}>" for i in ids)

    decoded = []  # the token rows of every gathered batch, in order
    decode_text = WhisperEngine.decode_text

    def recording(self, result):
        decoded.append(np.asarray(result.tokens).tolist())
        return decode_text(self, result)

    WhisperEngine.decode_text = recording

    def pipeline(mesh, temperatures, fallback):
        base, tok = (WhisperTokenizer.dummy(cfg.n_vocab, language="en") for _ in range(2))
        base.backend = tok.backend = Ids(cfg.n_vocab)
        opts = tasr.TranscriptionOptions(
            beam_size=2, best_of=FALLBACK_BEST_OF, max_new_tokens=8, temperatures=temperatures,
            log_prob_threshold=1.0,  # above any average log-prob: every chunk is retried
            compression_ratio_threshold=None, no_speech_threshold=None, enable_fallback=fallback,
        )
        return tasr.WhisperPipeline(
            WhisperEngine(model, base), VadPipeline(EnergyVAD()), {"vad_onset": 0.5, "vad_offset": 0.363}, opts,
            tokenizer=tok, language="en", mesh=mesh,
        )

    audio = _islands(1)  # one chunk: its best_of copies fill one retry batch
    out = {}
    for name, m in (("mesh", mesh), ("single", None)):
        decoded.clear()
        pipeline(m, (0.0, 1.0), True).transcribe(audio, batch_size=FALLBACK_BEST_OF, chunk_size=5)
        out[f"fallback/{name}"] = decoded[-1]  # the retry batch at temperature 1.0
    sampled = pipeline(mesh, (1.0,), False)
    out["sampled"] = [sampled.transcribe(audio, batch_size=FALLBACK_BEST_OF, chunk_size=5) for _ in range(2)]
    # Leave together: a rank that exits while the other still talks to the
    # store it hosts can abort the other.
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return out


# ---- the fixtures -----------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "1"}
    env.update({k: str(v) for k, v in extra.items()})
    return env


class _Ranks:
    """The rank processes (``n`` of them, running ``worker``); ``results()``
    waits for them once."""

    def __init__(self, data_dir, n=N_RANKS, worker="all"):
        port = _free_port()
        self.procs = [
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(data_dir), worker],
                env=_env(COORDINATOR_ADDRESS=f"127.0.0.1:{port}", NUM_PROCESSES=n, PROCESS_ID=r),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
            )
            for r in range(n)
        ]
        self._results = None

    def results(self) -> list:
        if self._results is None:
            outs = []
            for p in self.procs:
                out, err = p.communicate(timeout=900)
                assert p.returncode == 0, f"rank failed:\n{err[-4000:]}"
                outs.append(json.loads([l for l in out.splitlines() if l.startswith("RESULT ")][-1][7:]))
            self._results = outs
        return self._results

    def rank0(self) -> dict:
        return self.results()[0]


@pytest.fixture(scope="module")
def jax_align():
    from whisperx_tpu.align import alignment as ja

    return ja.test_align_model("en", seed=0)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_align):
    import jax

    d = tmp_path_factory.mktemp("ranks")
    np.savez(d / "align.npz", **dict(_flat(jax.tree_util.tree_map(np.asarray, jax_align.params))))
    (d / "align.json").write_text(
        json.dumps({"dictionary": jax_align.dictionary, "blank_id": jax_align.blank_id, "max_batch": jax_align.max_batch})
    )
    r = _Ranks(d)
    yield r
    for p in r.procs:
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="module")
def fallback_ranks(tmp_path_factory):
    r = _Ranks(tmp_path_factory.mktemp("fallback"), n=2, worker="fallback")
    yield r
    for p in r.procs:
        if p.poll() is None:
            p.kill()


# ---- JAX references ----------------------------------------------------------


def _jax_decode(cfg, params, beam, *, kv="model", quantized=False, mesh=True, mel_seed=3):
    import jax

    from whisperx_tpu.decode.engine import WhisperEngine as JEngine
    from whisperx_tpu.decode.tokenizer import WhisperTokenizer as JTok
    from whisperx_tpu.models.whisper import Whisper as JWhisper
    from whisperx_tpu.parallel import make_mesh, shard_batch, shard_params

    engine = JEngine(JWhisper(cfg, quantized=quantized), JTok.dummy(cfg.n_vocab, language="en"))
    opts = engine.build_options(beam_size=beam, max_new_tokens=MAX_NEW, kv_cache_dtype=kv)
    if not mesh:
        return engine.generate(params, _mel(mel_seed), options=opts)
    jm = make_mesh(n_model=2)  # (4, 2)
    with jax.set_mesh(jm):
        return engine.generate(shard_params(params, jm), shard_batch(jm, _mel(mel_seed)), options=opts)


def _assert_decode_equal(got, want, *, atol=1e-3, rtol=0.0):
    np.testing.assert_array_equal(np.asarray(got["tokens"]), np.asarray(want.tokens))
    np.testing.assert_allclose(got["sum_logprobs"], np.asarray(want.sum_logprobs), atol=atol, rtol=rtol)
    assert len({tuple(row) for row in got["tokens"]}) >= 2  # the tokens depend on the input


def _assert_ranks_agree(ranks, key):
    res = ranks.results()
    assert all(r[key] == res[0][key] for r in res), f"{key}: the ranks differ"


@pytest.mark.parametrize("beam", [1, 2])
def test_tp_decode_matches_jax(ranks, beam):
    """(2, 2): heads and MLP split over two ranks, rows over two; greedy and
    beam 2 in fp32 against the JAX package's (4, 2) mesh."""
    cfg = _configs()["test"]
    want = _jax_decode(cfg, _weights(cfg), beam)
    got = ranks.rank0()[f"decode/test/{beam}"]
    _assert_decode_equal(got, want)
    assert got["heads"] == cfg.n_text_head // 2
    assert got["vocab_rows"] == cfg.n_vocab  # 51865 is odd: the embedding stays whole
    _assert_ranks_agree(ranks, f"decode/test/{beam}")


@pytest.mark.parametrize("beam", [1, 2])
def test_tp_decode_split_vocab_matches_jax(ranks, beam):
    """n_vocab 51866 (large-v3's): the token embedding splits over the model
    axis, so the lookup all-reduces and the logits are gathered."""
    cfg = _configs()["vocab51866"]
    want = _jax_decode(cfg, _weights(cfg), beam)
    got = ranks.rank0()[f"decode/vocab51866/{beam}"]
    _assert_decode_equal(got, want)
    assert got["vocab_rows"] == cfg.n_vocab // 2
    _assert_ranks_agree(ranks, f"decode/vocab51866/{beam}")


def test_tp_int8_decode_matches_jax(ranks, monkeypatch):
    """int8 weights + int8 KV cache, beam 3, under (2, 2) against the JAX
    package on one device with its int8 kernel (both round x to bf16; JAX's
    XLA route under a mesh does not). Tokens equal; the summed log-probs
    (~-55) within a relative 1e-4, since the bf16 rounding of x and the int8
    KV grid amplify the fp32 order of the split sums (``_int8_weights``)."""
    monkeypatch.setenv("WHISPERX_INT8_MM", "pallas")
    cfg = _configs()["wide"]
    want = _jax_decode(cfg, _int8_weights(cfg), 3, kv="int8", quantized=True, mesh=False, mel_seed=INT8_MEL_SEED)
    got = ranks.rank0()["decode/int8/3"]
    _assert_decode_equal(got, want, atol=0.0, rtol=1e-4)
    _assert_ranks_agree(ranks, "decode/int8/3")


def test_row_parallel_int8_matmul_takes_no_bias(ranks):
    """Under (2, 2) at 256 wide every decoder projection's shard goes through
    int8_matmul: column splits (K 256 → N 128, fc1 256 → 512) with their
    bias; row splits (out K 128 → N 256, fc2 512 → 256) without it, in fp32,
    the bias added once after the all-reduce."""
    calls = {tuple(c) for c in ranks.rank0()["int8_calls"]}
    row = {c for c in calls if c[0] in (128, 512)}
    assert row == {(128, 256, True, "torch.float32"), (512, 256, True, "torch.float32")}
    assert (256, 128, False, "torch.float32") in calls  # query, value (bias)
    assert (256, 128, True, "torch.float32") in calls  # key (no bias in the model)
    assert (256, 512, False, "torch.float32") in calls  # fc1


@pytest.fixture(scope="module")
def jax_transcribe():
    """The JAX package's mesh pipeline on the same weights, tokens rendered as ids."""
    from whisperx_tpu.decode.engine import WhisperEngine as JEngine
    from whisperx_tpu.decode.tokenizer import ByteBackend as JByteBackend
    from whisperx_tpu.decode.tokenizer import WhisperTokenizer as JTok
    from whisperx_tpu.models.whisper import Whisper as JWhisper
    from whisperx_tpu.parallel import make_mesh
    from whisperx_tpu.pipeline import asr as jasr
    from whisperx_tpu.vad.model import EnergyVAD as JEnergyVAD
    from whisperx_tpu.vad.model import VadPipeline as JVad

    class Ids(JByteBackend):
        def decode(self, ids):
            return "".join(f"<{i}>" for i in ids)

    cfg = _configs()["test"]

    def run(mesh):
        base, tok = (JTok.dummy(cfg.n_vocab, language="en") for _ in range(2))
        base.backend = tok.backend = Ids(cfg.n_vocab)
        pipe = jasr.WhisperPipeline(
            engine=JEngine(JWhisper(cfg), base), params=_weights(cfg), vad=JVad(JEnergyVAD()),
            vad_params={"vad_onset": 0.5, "vad_offset": 0.363},
            options=jasr.TranscriptionOptions(beam_size=2, max_new_tokens=8), tokenizer=tok, language="en", mesh=mesh,
        )
        return pipe.transcribe(_islands(5), batch_size=2, chunk_size=5)

    return {"4x1": run(make_mesh()), "2x2": run(make_mesh(n_model=2))}


@pytest.mark.parametrize("shape", ["4x1", "2x2"])
def test_transcribe_matches_jax_mesh(ranks, jax_transcribe, shape):
    """``WhisperPipeline(mesh=)``: batches pad to the data granule, each rank
    decodes its rows, every rank returns the whole transcript; segments,
    texts (token ids) and times equal the JAX mesh pipeline's ((8, 1) and
    (4, 2))."""
    want = jax_transcribe[shape]
    got = ranks.rank0()[f"transcribe/{shape}"]
    assert got == json.loads(json.dumps(want))
    assert len(got["segments"]) == 5 and len({s["text"] for s in got["segments"]}) >= 2
    _assert_ranks_agree(ranks, f"transcribe/{shape}")


def test_shard_align_model_matches_jax(ranks, jax_align):
    """``shard_align_model`` under (2, 2): rows over two ranks (5 segments on
    the 8-row ladder, then 3 on its 4-row step), one head a rank; words,
    chars, starts, ends and scores equal the JAX package's ``align``."""
    from whisperx_tpu.align import alignment as ja

    audio, transcripts = _align_inputs()
    meta = {"language": "en", "dictionary": jax_align.dictionary, "type": "jax"}
    want = [_canon(ja.align([dict(s) for s in t], jax_align, meta, audio)) for t in transcripts]
    got = ranks.rank0()
    assert got["align"] == want
    assert json.loads(want[0])["word_segments"]
    assert got["align_max_batch"] == 8 and got["align_heads"] == 1
    _assert_ranks_agree(ranks, "align")


def test_diarize_mesh_matches_jax(ranks):
    """``DiarizationPipeline(mesh=)`` under (4, 1): the window batches split
    over four ranks and are gathered back; the turns equal the JAX
    package's."""
    from whisperx_tpu.diarize import DiarizationPipeline as JDiarization

    want = _turns(JDiarization()(_diarize_audio(), min_speakers=2, max_speakers=2))
    got = ranks.rank0()["diarize"]
    assert got == want and {t[2] for t in got} == {"SPEAKER_00", "SPEAKER_01"}
    _assert_ranks_agree(ranks, "diarize")


def test_neural_diarize_mesh_equals_one_rank(ranks):
    """The overlap-aware path (PyanNet segmentation, ResNet34 embeddings)
    under (4, 1) gives the turns of the same pipeline without a mesh."""
    got = ranks.rank0()["neural_diarize"]
    assert got["mesh"] == got["single"] and got["mesh"]
    _assert_ranks_agree(ranks, "neural_diarize")


# ---- sampling under a data axis -------------------------------------------------


def test_fallback_candidates_stay_distinct_under_a_data_axis(fallback_ranks):
    """The temperature fallback under a (2, 1) mesh: one chunk's best_of
    copies fill a retry batch whose rows span both data ranks. Each rank
    folds its data coordinate into its generator's seed, so the mesh run
    gives as many distinct candidates as the single-process run (without
    the fold, rows at the same local index on the two ranks drew the same
    uniforms and decoded the same tokens)."""
    res = fallback_ranks.results()
    single = res[0]["fallback/single"]
    assert len(single) == FALLBACK_BEST_OF and len({tuple(r) for r in single}) == FALLBACK_BEST_OF
    mesh = res[0]["fallback/mesh"]
    assert len(mesh) == FALLBACK_BEST_OF and len({tuple(r) for r in mesh}) == FALLBACK_BEST_OF
    assert all(r["fallback/mesh"] == mesh for r in res)  # every rank gathers the same rows


def test_sampled_decode_is_reproducible_from_call_to_call(fallback_ranks):
    """temperatures[0] > 0: the main decode samples from a generator seeded
    as the JAX package's PRNGKey(0), with the data coordinate folded in, so
    two calls give the same transcript, on every rank."""
    res = fallback_ranks.results()
    first, second = res[0]["sampled"]
    assert first == second and first["segments"]
    assert all(r["sampled"] == res[0]["sampled"] for r in res)


# ---- helpers: row counts, shards, the world -----------------------------------


@pytest.mark.parametrize("n_data", [1, 2, 4])
def test_pad_rows_to_mesh_matches_jax(ranks, n_data):
    from whisperx_tpu.parallel import make_mesh, pad_rows_to_mesh

    jm = make_mesh(n_data=n_data, n_model=8 // n_data)
    want = [int(pad_rows_to_mesh(jm, np.zeros((b, 3), np.float32)).shape[0]) for b in range(1, 10)]
    assert ranks.rank0()["pad_rows"][str(n_data)] == want


@pytest.mark.parametrize("n_data", [1, 2, 4])
def test_ladder_rows_match_jax(ranks, n_data):
    from whisperx_tpu.align.alignment import _ladder_rows
    from whisperx_tpu.parallel import make_mesh

    jm = make_mesh(n_data=n_data, n_model=8 // n_data)
    want = {str(mb): [_ladder_rows(b, mb, jm) for b in range(1, 10)] for mb in (8, 12)}
    assert ranks.rank0()["ladder"][str(n_data)] == want


def test_world_meshes_and_gathers(ranks):
    """Four ranks, one world: process_info, local_batch_slice, round-robin
    files, the three mesh shapes, and a gather in rank order."""
    res = ranks.results()
    assert [r["info"] for r in res] == [
        {"process_index": i, "process_count": 4, "local_devices": 1, "global_devices": 4} for i in range(4)
    ]
    assert [r["slice"] for r in res] == [[0, 2], [2, 4], [4, 6], [6, 8]]
    assert [r["files"] for r in res] == [["f0.wav", "f4.wav"], ["f1.wav", "f5.wav"], ["f2.wav", "f6.wav"], ["f3.wav"]]
    assert res[0]["shapes"] == {"4": [4, 1], "2": [2, 2], "1": [1, 4]}
    assert all(r["gather"] == [[0, 10], [1, 11], [2, 12], [3, 13]] for r in res)


def test_shard_files_match_jax():
    from whisperx_tpu.parallel.distributed import shard_files as jshard
    from whisperx_tpu_torch.parallel.distributed import shard_files

    files = [f"f{i}.wav" for i in range(7)]
    for pc in (1, 2, 3, 4):
        for pi in range(pc):
            assert shard_files(files, process_index=pi, process_count=pc) == jshard(files, pi, pc)
    assert shard_files(files) == files  # one process owns everything


def _trees():
    import jax

    from whisperx_tpu.models.configs import WAV2VEC2_TEST as JW2V_TEST
    from whisperx_tpu.models.wav2vec2 import init_wav2vec2_params
    from whisperx_tpu.models.whisper import init_whisper_params, quantize_params
    from whisperx_tpu.parallel import partition as jpart
    from whisperx_tpu.parallel import partition_specs as jspecs
    from whisperx_tpu_torch.models.configs import TEST_CONFIG

    _, wp = init_whisper_params(TEST_CONFIG, seed=0)
    _, w2v = init_wav2vec2_params(JW2V_TEST, seed=0)
    return {
        "whisper": (wp, jpart.WHISPER_RULES),
        "whisper_int8": (quantize_params(wp), jpart.WHISPER_RULES),
        "wav2vec2": (w2v, jpart.W2V2_RULES),
    }, jspecs, jax


@pytest.mark.parametrize("tree", ["whisper", "whisper_int8", "wav2vec2"])
def test_partition_specs_match_jax(tree):
    from whisperx_tpu_torch.parallel import W2V2_RULES, WHISPER_RULES, partition_specs

    trees, jspecs, jax = _trees()
    params, jrules = trees[tree]
    rules = W2V2_RULES if tree == "wav2vec2" else WHISPER_RULES
    assert [p for p, _ in rules] == [p for p, _ in jrules]
    got = dict(_flat(partition_specs(jax.tree_util.tree_map(np.asarray, params), rules)))
    want = {
        "/".join(str(k.key) for k in path): tuple(spec)
        for path, spec in jax.tree_util.tree_flatten_with_path(jspecs(params, jrules))[0]
    }
    assert got == want
    assert any(v != () for v in want.values())


# ---- the command line over two ranks ---------------------------------------


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """``python -m whisperx_tpu_torch`` as two ranks (torchrun's variables),
    each with its own output directory; under ``torchrun --standalone
    --nproc-per-node 2`` into one directory; and once in this process, on
    three WAV files and tiny HF directories, fp32 on the CPU."""
    import whisperx_tpu_torch.cli as t_cli
    from tests.test_torch_checkpoints import _wav2vec2_dir, _whisper_dir
    from tests.test_torch_cli import _worded_vocab
    from whisperx_tpu_torch.audio.io import write_wav

    root = tmp_path_factory.mktemp("cli_ranks")
    whisper = _worded_vocab(_whisper_dir(root / "whisper", True))
    w2v = _wav2vec2_dir(root / "wav2vec2", True)
    wavs = []
    for i, name in enumerate(("a", "b", "c")):
        path = str(root / f"{name}.wav")
        write_wav(path, np.concatenate([_speechy(2.0 + i, seed=i, freq=200.0 + 90 * i), np.zeros(SR, np.float32)]))
        wavs.append(path)
    argv = wavs + ["--checkpoint", whisper, "--align_model", w2v, "--compute_type", "float32", "--language", "en",
                   "--beam_size", "2", "--batch_size", "2", "--chunk_size", "5", "--device", "cpu", "--verbose", "False"]
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "whisperx_tpu_torch", *argv, "--threads", "1", "--output_dir", str(root / f"rank{r}")],
            env=_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, WORLD_SIZE=2, RANK=r, LOCAL_RANK=r),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        )
        for r in range(2)
    ]
    procs.append(
        subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
             "-m", "whisperx_tpu_torch", *argv, "--threads", "1", "--output_dir", str(root / "torchrun")],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        )
    )
    t_cli.cli(argv + ["--output_dir", str(root / "single")])
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"CLI rank failed:\n{err[-4000:]}"
    return root


def test_cli_under_torchrun_writes_the_single_process_bytes(cli_runs):
    single = sorted(os.listdir(cli_runs / "single"))
    assert sorted(os.listdir(cli_runs / "torchrun")) == single
    for name in single:
        assert (cli_runs / "torchrun" / name).read_bytes() == (cli_runs / "single" / name).read_bytes(), name


def test_cli_two_ranks_write_their_shards_byte_equal(cli_runs):
    single = sorted(os.listdir(cli_runs / "single"))
    assert len(single) == 15  # five formats of "all" for three files
    shards = {r: sorted(os.listdir(cli_runs / f"rank{r}")) for r in (0, 1)}
    assert {f.split(".")[0] for f in shards[0]} == {"a", "c"}
    assert {f.split(".")[0] for f in shards[1]} == {"b"}
    assert sorted(shards[0] + shards[1]) == single
    for r, names in shards.items():
        for name in names:
            assert (cli_runs / f"rank{r}" / name).read_bytes() == (cli_runs / "single" / name).read_bytes(), name


if __name__ == "__main__":
    result = _fallback_worker() if sys.argv[2:] == ["fallback"] else _worker(sys.argv[1])
    print("RESULT " + json.dumps(result), flush=True)
