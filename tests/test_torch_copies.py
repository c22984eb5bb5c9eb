"""whisperx_tpu_torch: the copied framework-free modules, the host-side
parameter transforms and the package's import and device rules, held against
the JAX package."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from whisperx_tpu.audio import constants as j_constants
from whisperx_tpu.decode.engine import WhisperEngine as JEngine
from whisperx_tpu.decode.search import _first_step_mask as j_first_mask
from whisperx_tpu.decode.search import _static_suppress_mask as j_suppress_mask
from whisperx_tpu.decode.tokenizer import WhisperTokenizer as JTokenizer
from whisperx_tpu.io import languages as j_languages
from whisperx_tpu.models import configs as j_configs
from whisperx_tpu.models.whisper import fuse_qkv_params as j_fuse
from whisperx_tpu.models.whisper import init_whisper_params
from whisperx_tpu.models.whisper import quantize_params as j_quantize
from whisperx_tpu_torch.audio import constants as t_constants
from whisperx_tpu_torch.decode.search import _first_step_mask as t_first_mask
from whisperx_tpu_torch.decode.search import _static_suppress_mask as t_suppress_mask
from whisperx_tpu_torch.decode.tokenizer import WhisperTokenizer as TTokenizer
from whisperx_tpu_torch.io import languages as t_languages
from whisperx_tpu_torch.models import configs as t_configs
from whisperx_tpu_torch.models import whisper as tw

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SMALL = dataclasses.replace(
    t_configs.TEST_CONFIG, n_text_state=128, n_audio_state=128, n_text_head=2, n_audio_head=2
)


def _public(mod):
    return {k: v for k, v in vars(mod).items() if k.isupper()}


def test_constants_and_languages_equal():
    assert _public(t_constants) == _public(j_constants)
    assert t_languages.LANGUAGES == j_languages.LANGUAGES
    assert t_languages.LANGUAGE_CODES == j_languages.LANGUAGE_CODES
    assert t_languages.TO_LANGUAGE_CODE == j_languages.TO_LANGUAGE_CODE
    assert t_languages.LANGUAGES_WITHOUT_SPACES == j_languages.LANGUAGES_WITHOUT_SPACES


def test_configs_equal():
    assert set(t_configs.WHISPER_CONFIGS) == set(j_configs.WHISPER_CONFIGS)
    for name, cfg in t_configs.WHISPER_CONFIGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(j_configs.WHISPER_CONFIGS[name]), name
    assert dataclasses.asdict(t_configs.TEST_CONFIG) == dataclasses.asdict(j_configs.TEST_CONFIG)
    for name in ("WAV2VEC2_BASE", "WAV2VEC2_LARGE", "WAV2VEC2_TEST"):
        assert dataclasses.asdict(getattr(t_configs, name)) == dataclasses.asdict(getattr(j_configs, name))


@pytest.mark.parametrize("n_vocab", [51864, 51865, 51866])
@pytest.mark.parametrize("language,task", [("en", "transcribe"), ("fr", "translate")])
def test_tokenizer_layout_and_masks_equal(n_vocab, language, task):
    jt = JTokenizer.dummy(n_vocab, language=language, task=task)
    tt = TTokenizer.dummy(n_vocab, language=language, task=task)
    assert dataclasses.asdict(tt.layout) == dataclasses.asdict(jt.layout)
    assert tt.sot_sequence() == jt.sot_sequence()
    assert tt.sot_sequence(without_timestamps=False) == jt.sot_sequence(without_timestamps=False)
    assert tt.non_speech_tokens == jt.non_speech_tokens
    assert tt.encode(" hello") == jt.encode(" hello")
    assert tt.decode([104, 105, jt.eot]) == jt.decode([104, 105, jt.eot])


def _engines(cfg):
    from whisperx_tpu_torch.decode.engine import WhisperEngine as TEngine

    from whisperx_tpu.models.whisper import Whisper as JWhisper

    return (
        JEngine(JWhisper(cfg), JTokenizer.dummy(cfg.n_vocab, language="en")),
        TEngine(tw.Whisper(cfg, device="cpu"), TTokenizer.dummy(cfg.n_vocab, language="en")),
    )


def test_engine_options_prompts_and_masks_equal():
    je, te = _engines(t_configs.TEST_CONFIG)
    for kw in (
        {},
        dict(beam_size=5, max_new_tokens=112, kv_cache_dtype="int8"),
        dict(beam_size=1, suppress_tokens=(-1, 7, 300), without_timestamps=False, suppress_blank=False),
    ):
        jo, to = je.build_options(**kw), te.build_options(**kw)
        assert dataclasses.asdict(to) == dataclasses.asdict(jo)
        V = t_configs.TEST_CONFIG.n_vocab
        np.testing.assert_array_equal(t_suppress_mask(V, to), j_suppress_mask(V, jo))
        np.testing.assert_array_equal(t_first_mask(V, to), j_first_mask(V, jo))
    long_text = "words " * 400
    for kw in ({}, dict(initial_prompt=long_text), dict(prefix_tokens=te.prefix_tokens(long_text))):
        np.testing.assert_array_equal(te.build_prompt(3, **kw).numpy(), np.asarray(je.build_prompt(3, **kw)))
    assert te.prefix_tokens(long_text) == je.prefix_tokens(long_text)
    opts = te.build_options(max_new_tokens=112)
    for P in (1, 4, 16, 300):
        assert te._cache_len(P, opts) == je._cache_len(P, opts)


def test_random_params_equal_jax_init():
    _, jparams = init_whisper_params(SMALL, seed=3)
    tparams = tw.random_params(SMALL, seed=3)
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == sum(1 for _ in _leaves(tparams))
    for path, leaf in flat:
        node = tparams
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, np.asarray(leaf), err_msg=jax.tree_util.keystr(path))


def _leaves(tree):
    for child in tree.values():
        if isinstance(child, dict):
            yield from _leaves(child)
        else:
            yield child


@pytest.mark.parametrize("scope", ["all", "decoder"])
def test_quantize_and_fuse_params_equal(scope):
    tparams = tw.random_params(SMALL, seed=1)
    want = j_fuse(j_quantize(jax.tree_util.tree_map(np.asarray, tparams), scope=scope))
    got = tw.fuse_qkv_params(tw.quantize_params(tparams, scope=scope))
    wflat = jax.tree_util.tree_flatten_with_path(want)[0]
    gflat = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in wflat] == [p for p, _ in gflat]
    for (path, w), (_, g) in zip(wflat, gflat):
        assert np.asarray(g).dtype == np.asarray(w).dtype, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=jax.tree_util.keystr(path))


def test_port_imports_without_jax_or_the_jax_package():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'whisperx_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import whisperx_tpu_torch\n"
        "import whisperx_tpu_torch.audio, whisperx_tpu_torch.models.convert\n"
        "import whisperx_tpu_torch.decode.engine, whisperx_tpu_torch.ops._build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'whisperx_tpu')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_points_need_the_card_unless_cpu_is_asked(monkeypatch):
    from whisperx_tpu_torch import resolve_device
    from whisperx_tpu_torch.audio import log_mel_spectrogram

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tw.Whisper(t_configs.TEST_CONFIG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        log_mel_spectrogram(np.zeros(1600, np.float32))
    assert resolve_device("cpu").type == "cpu"
    assert log_mel_spectrogram(np.zeros(1600, np.float32), device="cpu").shape == (80, 10)


def test_io_types_equal():
    from whisperx_tpu.io import types as j_types
    from whisperx_tpu_torch.io import types as t_types

    for name in ("SingleWordSegment", "SingleCharSegment", "SingleSegment", "SingleAlignedSegment",
                 "TranscriptionResult", "AlignedTranscriptionResult"):
        tcls, jcls = getattr(t_types, name), getattr(j_types, name)
        assert set(tcls.__annotations__) == set(jcls.__annotations__), name
        def text(ann):  # the annotation as written (forward references carry their module)
            return {k: getattr(v, "__forward_arg__", str(v)) for k, v in ann.items()}

        assert text(tcls.__annotations__) == text(jcls.__annotations__), name


def test_sentences_and_registry_equal():
    from whisperx_tpu.align import registry as j_registry
    from whisperx_tpu.align import sentences as j_sentences
    from whisperx_tpu_torch.align import registry as t_registry
    from whisperx_tpu_torch.align import sentences as t_sentences

    assert t_sentences.PUNKT_ABBREVIATIONS == j_sentences.PUNKT_ABBREVIATIONS
    texts = [
        "Hello world. How are you?", " Mr. Smith went to Washington. He was late.", "Wait... what happened next",
        "The value is 4.5 and rising. Done.", 'He said "Stop." Then he left.', "J. Smith arrived. Prof. X too.",
        "", "  leading spaces. And more.  ", "Number 5. follows.", "U.S. troops moved. Then stopped.",
        "What?! Seriously?? yes.", "he said 'done.' then left.",
    ]
    for text in texts:
        assert t_sentences.sentence_spans(text) == j_sentences.sentence_spans(text), text
    for name in ("DEFAULT_ALIGN_MODELS_TORCH", "DEFAULT_ALIGN_MODELS_HF", "TORCH_BUNDLE_TO_HF"):
        assert getattr(t_registry, name) == getattr(j_registry, name)
    for lang in ("en", "fr", "ja", "hr"):
        assert t_registry.default_align_model(lang) == j_registry.default_align_model(lang)
    with pytest.raises(ValueError):
        t_registry.default_align_model("xx")


def test_utils_equal():
    from whisperx_tpu import utils as j_utils
    from whisperx_tpu_torch import utils as t_utils

    for vals in ([np.nan, 1.0, np.nan, np.nan, 4.0, np.nan], [np.nan, 2.0, np.nan], [np.nan, np.nan], [1.0, 2.0]):
        for method in ("nearest", "linear"):
            np.testing.assert_array_equal(t_utils.interpolate_nans(vals, method), j_utils.interpolate_nans(vals, method))
    for s in (0.0, 3.4567, 3725.5, 86399.999):
        for hours in (False, True):
            assert t_utils.format_timestamp(s, hours, ",") == j_utils.format_timestamp(s, hours, ",")
    text = "the same words again " * 20
    assert t_utils.compression_ratio(text) == j_utils.compression_ratio(text)
    assert t_utils.make_safe("héllo") == j_utils.make_safe("héllo")
    assert [t_utils.bucket_rows(n) for n in (1, 8, 9, 30)] == [j_utils.bucket_rows(n) for n in (1, 8, 9, 30)]
    assert t_utils.str2bool("True") is j_utils.str2bool("True") is True
    assert t_utils.optional_int("None") is None and t_utils.optional_float("2.5") == j_utils.optional_float("2.5")
    assert t_utils.exact_div(12, 4) == j_utils.exact_div(12, 4)


def test_telemetry_counters_equal():
    from whisperx_tpu.utils import telemetry as j_tel
    from whisperx_tpu_torch.utils import telemetry as t_tel

    tp, jp = t_tel.PipelineTelemetry(), j_tel.PipelineTelemetry()
    for p in (tp, jp):
        p.record("align", seconds=2.0, audio_seconds=60.0)
        p.record("align", seconds=1.0, audio_seconds=30.0)
        p.record("decode", seconds=0.0)
    assert tp.report() == jp.report()
    assert tp.stages["align"].realtime_factor == jp.stages["align"].realtime_factor == 30.0
    with tp.stage("vad", audio_seconds=5.0) as stats:
        pass
    assert stats.calls == 1 and stats.audio_seconds == 5.0


def test_new_modules_import_without_jax_or_the_jax_package():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'whisperx_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import whisperx_tpu_torch.align.alignment, whisperx_tpu_torch.models.wav2vec2\n"
        "import whisperx_tpu_torch.ops.ctc, whisperx_tpu_torch.ops.mel, whisperx_tpu_torch.ops.flash_attn\n"
        "import whisperx_tpu_torch.utils.telemetry, whisperx_tpu_torch.io.types\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'whisperx_tpu')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_new_entry_points_need_the_card_unless_cpu_is_asked(monkeypatch):
    from whisperx_tpu_torch.models import wav2vec2 as tw2
    from whisperx_tpu_torch.models.convert import wav2vec2_from_jax

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = tw2.random_params(t_configs.WAV2VEC2_TEST, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        wav2vec2_from_jax(params, t_configs.WAV2VEC2_TEST)
    assert wav2vec2_from_jax(params, t_configs.WAV2VEC2_TEST, device="cpu").device.type == "cpu"


# Files the port carries byte for byte.
VERBATIM = {
    "whisperx_tpu_torch/vad/binarize.py": "whisperx_tpu/vad/binarize.py",
    "whisperx_tpu_torch/vad/__init__.py": "whisperx_tpu/vad/__init__.py",
    "whisperx_tpu_torch/models/pinned.py": "whisperx_tpu/models/pinned.py",
    "whisperx_tpu_torch/native/audio_native.cpp": "whisperx_tpu/native/audio_native.cpp",
}


@pytest.mark.parametrize("port", list(VERBATIM))
def test_verbatim_copies(port):
    assert (REPO / port).read_bytes() == (REPO / VERBATIM[port]).read_bytes()


def test_pinned_registry_and_binarize_equal():
    import importlib

    from whisperx_tpu.models import pinned as j_pinned
    from whisperx_tpu_torch.models import pinned as t_pinned

    # The packages' vad/__init__.py export a function named binarize.
    j_bin = importlib.import_module("whisperx_tpu.vad.binarize")
    t_bin = importlib.import_module("whisperx_tpu_torch.vad.binarize")

    assert t_pinned.PINNED == j_pinned.PINNED
    for name in ("openai/whisper-large-v2", "/ckpts/whisper-tiny.en", "large-v3", "facebook/wav2vec2-base-960h", "custom"):
        assert t_pinned.pinned_key_for(name) == j_pinned.pinned_key_for(name)
    rng = np.random.default_rng(0)
    scores = np.clip(np.cumsum(rng.standard_normal(3000)) / 30 + 0.5, 0, 1).astype(np.float32)
    times = (np.arange(3000) * 270 + 495.5) / 16000
    for kw in (dict(max_duration=30.0), dict(max_duration=5.0, min_duration_on=0.5)):
        got, want = t_bin.binarize(scores, times, **kw), j_bin.binarize(scores, times, **kw)
        assert [(t.start, t.end) for t in got] == [(t.start, t.end) for t in want]
        assert t_bin.merge_chunks(got, 30.0) == j_bin.merge_chunks(want, 30.0)


PIPELINE_MODULES = (
    "whisperx_tpu_torch.vad", "whisperx_tpu_torch.vad.model", "whisperx_tpu_torch.vad.binarize",
    "whisperx_tpu_torch.models.pinned", "whisperx_tpu_torch.native", "whisperx_tpu_torch.audio.io",
    "whisperx_tpu_torch.models.convert", "whisperx_tpu_torch.pipeline", "whisperx_tpu_torch.pipeline.asr",
)


def test_pipeline_modules_import_without_jax_or_the_jax_package():
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'whisperx_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import whisperx_tpu_torch as w\n"
        f"for m in {PIPELINE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "for name in ('load_model', 'load_audio', 'align', 'align_begin', 'AlignJob', 'load_align_model'):\n"
        "    assert hasattr(w, name), name\n"
        "assert w.native.available()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'whisperx_tpu')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_pipeline_entry_points_need_the_card_unless_cpu_is_asked(monkeypatch, tmp_path):
    from whisperx_tpu_torch import load_align_model, load_model
    from whisperx_tpu_torch.pipeline.asr import load_test_pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: load_test_pipeline(),
        lambda: load_model("tiny", checkpoint=str(tmp_path)),
        lambda: load_align_model("en", model_name=str(tmp_path)),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    p = load_test_pipeline(device="cpu")
    assert p.device.type == "cpu" and p.model.device.type == "cpu"
