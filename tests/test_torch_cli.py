"""whisperx_tpu_torch's command line, writers and subtitle processor: the
cases of tests/test_cli_and_subtitles.py, tests/test_cli_config.py and
tests/test_utils_writers.py run against the port (the writers' files also
byte-equal to the JAX package's), the flag table held name for name against
the JAX CLI's, and one run of both CLIs on the same tiny HF checkpoint
directories and WAV file with --diarize that writes byte-equal files in all
six formats."""

import json
import os

import numpy as np
import pytest
import torch

from whisperx_tpu_torch.cli import build_parser, resolve_config
from whisperx_tpu_torch.io import get_writer
from whisperx_tpu_torch.utils import compression_ratio, exact_div, format_timestamp, interpolate_nans

torch.set_num_threads(2)

SR = 16000
FORMATS = ("txt", "vtt", "srt", "tsv", "json", "aud")


def _resolve(argv):
    parser = build_parser()
    return resolve_config(parser.parse_args(argv), parser)


def _stub_models(monkeypatch, cli_mod, pipeline=None):
    """The random-weight pipeline and align model on the CPU in place of the
    checkpoint loaders."""
    from whisperx_tpu_torch.align.alignment import test_align_model
    from whisperx_tpu_torch.pipeline.asr import load_test_pipeline

    monkeypatch.setattr(cli_mod, "load_model", lambda *a, **k: pipeline or load_test_pipeline(language="en", device="cpu"))

    def fake_load_align_model(language, device, model_name=None, **kw):
        m = test_align_model(language or "en", device="cpu")
        return m, {"language": language or "en", "dictionary": m.dictionary, "type": "torch"}

    monkeypatch.setattr(cli_mod, "load_align_model", fake_load_align_model)


def _tone(freq, seconds=2.0):
    t = np.arange(int(seconds * SR)) / SR
    return (0.4 * np.sin(2 * np.pi * freq * t) * (1 + 0.4 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)


# ---- tests/test_cli_and_subtitles.py ---------------------------------------


def test_cli_parser_flags():
    parser = build_parser()
    args = parser.parse_args(
        ["a.wav", "--model", "tiny", "--batch_size", "4", "--diarize",
         "--vad_onset", "0.4", "--suppress_tokens=-1,5", "--language", "fr",
         "--max_line_width", "40", "--highlight_words", "True"]
    )
    assert args.audio == ["a.wav"]
    assert args.model == "tiny"
    assert args.batch_size == 4
    assert args.diarize is True
    assert args.vad_onset == 0.4
    assert args.language == "fr"
    assert args.max_line_width == 40
    assert args.highlight_words is True
    assert args.device == "cuda"


def test_cli_end_to_end_with_stub_model(tmp_path, monkeypatch):
    """Full CLI flow (transcribe→align→write) on the random-weight pipeline."""
    import whisperx_tpu_torch.cli as cli_mod
    from whisperx_tpu_torch.audio.io import write_wav

    wav_path = str(tmp_path / "speech.wav")
    write_wav(wav_path, _tone(210))
    _stub_models(monkeypatch, cli_mod)
    cli_mod.cli([wav_path, "--model", "tiny", "--output_dir", str(tmp_path), "--device", "cpu",
                 "--output_format", "srt", "--language", "en", "--batch_size", "2",
                 "--verbose", "False"])
    assert (tmp_path / "speech.srt").exists()


def test_cli_multifile_align_overlap(tmp_path, monkeypatch):
    """Multi-file CLI run: the align stage keeps one file's AlignJob in
    flight (cli._align_stage), so file f's result must not leak into file
    f+1's — every output file gets its own aligned transcript."""
    import whisperx_tpu_torch.cli as cli_mod
    from whisperx_tpu_torch.audio.io import write_wav
    from whisperx_tpu_torch.pipeline.asr import load_test_pipeline

    paths = []
    for i, freq in enumerate((210, 330)):
        p = str(tmp_path / f"clip{i}.wav")
        write_wav(p, _tone(freq))
        paths.append(p)
    _stub_models(monkeypatch, cli_mod, load_test_pipeline(language="en", device="cpu"))
    cli_mod.cli(paths + ["--model", "tiny", "--output_dir", str(tmp_path), "--device", "cpu",
                         "--output_format", "json", "--language", "en",
                         "--batch_size", "2", "--verbose", "False"])
    for i in range(2):
        data = json.loads((tmp_path / f"clip{i}.json").read_text())
        assert "segments" in data and "word_segments" in data


def _long_words():
    words, t = [], 0.0
    text_words = ("the quick brown fox jumps over the lazy dog and runs far away "
                  "because it saw a hunter near the old barn").split()
    for w in text_words:
        words.append({"word": w, "start": round(t, 2), "end": round(t + 0.3, 2)})
        t += 0.35
    return [{"start": 0.0, "end": t, "text": " ".join(text_words), "words": words}]


def test_subtitles_processor_splits_long_segment(tmp_path):
    from whisperx_tpu.io.subtitles import SubtitlesProcessor as JProcessor
    from whisperx_tpu_torch.io.subtitles import SubtitlesProcessor

    proc = SubtitlesProcessor(_long_words(), "en", max_line_length=30)
    subs = proc.process_segments(advanced_splitting=True)
    assert len(subs) >= 2
    for sub in subs:
        assert sub["start"] <= sub["end"]
    assert subs == JProcessor(_long_words(), "en", max_line_length=30).process_segments(advanced_splitting=True)

    out = tmp_path / "out.srt"
    n = proc.save(str(out))
    assert out.read_text().count("-->") == n


def test_subtitles_estimates_missing_times():
    from whisperx_tpu_torch.io.subtitles import SubtitlesProcessor

    words = [
        {"word": "hello", "start": 0.0, "end": 0.4},
        {"word": "123"},  # unaligned (numeral)
        {"word": "world", "start": 1.0, "end": 1.4},
    ]
    segments = [{"start": 0.0, "end": 1.4, "text": "hello 123 world", "words": words}]
    proc = SubtitlesProcessor(segments, "en")
    proc.process_segments(advanced_splitting=True)
    assert words[1]["start"] == 0.4
    assert words[1]["end"] == 1.0


def test_subtitles_vtt_header(tmp_path):
    from whisperx_tpu_torch.io.subtitles import SubtitlesProcessor

    segments = [{"start": 0.0, "end": 1.0, "text": "hi", "words": [
        {"word": "hi", "start": 0.0, "end": 1.0}]}]
    proc = SubtitlesProcessor(segments, "en", is_vtt=True)
    out = tmp_path / "o.vtt"
    proc.save(str(out))
    assert out.read_text().startswith("WEBVTT")


def test_cli_align_hot_swap_finishes_in_flight_first(monkeypatch):
    """On a detected-language switch, _align_stage must drain the previous
    file's in-flight AlignJob (built on the old model) BEFORE loading the
    replacement align model."""
    import whisperx_tpu_torch.cli as cli_mod
    from whisperx_tpu_torch.cli import CliConfig, FileJob

    events = []

    def fake_load_align_model(language, device, model_name=None, **kw):
        events.append(("load", language))
        return object(), {"language": language, "dictionary": {"a": 1}, "type": "torch"}

    class FakeJob:
        def __init__(self, path):
            self.path = path

        def finish(self):
            events.append(("finish", self.path))
            return {"segments": [], "word_segments": []}

    def fake_align_begin(segments, model, meta, audio, device, **kw):
        events.append(("begin", meta["language"]))
        return FakeJob(meta["language"])

    monkeypatch.setattr(cli_mod, "load_align_model", fake_load_align_model)
    monkeypatch.setattr(cli_mod, "align_begin", fake_align_begin)

    cfg = CliConfig(
        files=["a.wav", "b.wav"], model_name="tiny", checkpoint=None,
        model_dir=None, device="cpu", device_index=0, compute_type="int8",
        batch_size=2, task="transcribe", language=None, align_language="en",
        verbose=False, print_progress=False, threads=0, chunk_size=30,
    )
    jobs = [
        FileJob("a.wav", result={"segments": [{"start": 0, "end": 1, "text": "x"}],
                                 "language": "en"}, audio=np.zeros(16000, np.float32)),
        FileJob("b.wav", result={"segments": [{"start": 0, "end": 1, "text": "x"}],
                                 "language": "fr"}, audio=np.zeros(16000, np.float32)),
    ]
    cli_mod._align_stage(cfg, jobs)
    assert events == [("load", "en"), ("begin", "en"), ("finish", "en"), ("load", "fr"), ("begin", "fr"), ("finish", "fr")]


def test_cli_diarize_end_to_end(tmp_path, monkeypatch):
    """--diarize through the real stage functions (weight-free diarizer on
    the CPU): the output JSON carries speaker labels on segments."""
    import whisperx_tpu_torch.cli as cli_mod
    from whisperx_tpu_torch.audio.io import write_wav

    audio = np.zeros(8 * SR, np.float32)
    audio[SR : 4 * SR] = _tone(210, 3.0)
    audio[5 * SR : 8 * SR] = _tone(1200, 3.0)
    wav_path = str(tmp_path / "meet.wav")
    write_wav(wav_path, audio)
    _stub_models(monkeypatch, cli_mod)
    cli_mod.cli([wav_path, "--model", "tiny", "--output_dir", str(tmp_path), "--device", "cpu",
                 "--output_format", "json", "--language", "en", "--batch_size", "2",
                 "--diarize", "--min_speakers", "1", "--max_speakers", "2",
                 "--verbose", "False"])
    data = json.loads((tmp_path / "meet.json").read_text())
    assert [s for s in data["segments"] if "speaker" in s], "no segment carried a speaker label"


# ---- tests/test_cli_config.py ----------------------------------------------


def test_language_alias_and_validation():
    cfg = _resolve(["a.wav", "--language", "French"])
    assert cfg.language == "fr"
    assert cfg.align_language == "fr"
    # Detection mode: align model defaults to English (reference
    # transcribe.py:226 quirk).
    cfg = _resolve(["a.wav"])
    assert cfg.language is None
    assert cfg.align_language == "en"


def test_english_only_model_forces_english():
    with pytest.warns(UserWarning, match="English-only"):
        cfg = _resolve(["a.wav", "--model", "small.en", "--language", "fr"])
    assert cfg.language == "en"


def test_temperature_fallback_schedule():
    cfg = _resolve(["a.wav", "--temperature", "0.2"])
    np.testing.assert_allclose(cfg.asr_options["temperatures"], [0.2, 0.4, 0.6, 0.8, 1.0], atol=1e-9)
    cfg = _resolve(["a.wav", "--temperature_increment_on_fallback", "None"])
    assert list(cfg.asr_options["temperatures"]) == [0.0]


def test_translate_disables_alignment():
    assert _resolve(["a.wav", "--task", "translate"]).do_align is False


def test_word_options_require_alignment():
    with pytest.raises(SystemExit):
        _resolve(["a.wav", "--no_align", "--highlight_words", "True"])


def test_suppress_tokens_parsing():
    assert _resolve(["a.wav", "--suppress_tokens=-1,5,9"]).asr_options["suppress_tokens"] == [-1, 5, 9]


def test_diarize_checkpoint_and_threshold_plumbing():
    """--vad_checkpoint feeds the diarize stage's segmentation model unless
    --segmentation_checkpoint overrides; the clustering threshold flows."""
    cfg = _resolve(["a.wav", "--diarize", "--vad_checkpoint", "/ckpt/seg.bin"])
    assert cfg.segmentation_checkpoint == "/ckpt/seg.bin"
    assert cfg.diarize_clustering_threshold == 0.7
    cfg = _resolve(["a.wav", "--diarize", "--vad_checkpoint", "/ckpt/seg.bin",
                    "--segmentation_checkpoint", "/ckpt/other.bin", "--diarize_clustering_threshold", "0.55"])
    assert cfg.segmentation_checkpoint == "/ckpt/other.bin"
    assert cfg.diarize_clustering_threshold == 0.55
    assert _resolve(["a.wav", "--diarize"]).segmentation_checkpoint is None


# ---- tests/test_utils_writers.py -------------------------------------------

RESULT = {
    "language": "en",
    "segments": [
        {
            "start": 0.5,
            "end": 2.0,
            "text": " hello world",
            "words": [
                {"word": "hello", "start": 0.5, "end": 1.0, "score": 0.9},
                {"word": "world", "start": 1.2, "end": 2.0, "score": 0.8},
            ],
        },
        {
            "start": 3.0,
            "end": 4.0,
            "text": " again",
            "words": [{"word": "again", "start": 3.0, "end": 4.0, "score": 0.7}],
        },
    ],
}

OPTIONS = {"max_line_width": None, "max_line_count": None, "highlight_words": False}


def _write_both(tmp_path, fmt, result, name, options=OPTIONS):
    """Write with the port's and the JAX package's writer; the port's text,
    after checking that the two files are byte-equal."""
    from whisperx_tpu.io import get_writer as j_get_writer

    (tmp_path / "port").mkdir(exist_ok=True)
    (tmp_path / "jax").mkdir(exist_ok=True)
    get_writer(fmt, str(tmp_path / "port"))(result, name, options)
    j_get_writer(fmt, str(tmp_path / "jax"))(result, name, options)
    stem = os.path.splitext(name)[0]
    for ext in FORMATS if fmt == "all" else (fmt,):
        port, jax = tmp_path / "port" / f"{stem}.{ext}", tmp_path / "jax" / f"{stem}.{ext}"
        assert port.exists() == jax.exists(), ext
        if port.exists():
            assert port.read_bytes() == jax.read_bytes(), ext
    return tmp_path / "port"


def test_format_timestamp():
    assert format_timestamp(0.0) == "00:00.000"
    assert format_timestamp(3661.5, always_include_hours=True) == "01:01:01.500"
    assert format_timestamp(1.5, decimal_marker=",") == "00:01,500"


def test_srt_output(tmp_path):
    text = (_write_both(tmp_path, "srt", RESULT, "audio.wav") / "audio.srt").read_text()
    assert "1\n00:00:00,500 --> 00:00:02,000\nhello world\n" in text
    assert "2\n00:00:03,000 --> 00:00:04,000\nagain\n" in text


def test_vtt_output(tmp_path):
    text = (_write_both(tmp_path, "vtt", RESULT, "audio.wav") / "audio.vtt").read_text()
    assert text.startswith("WEBVTT\n")
    assert "00:00.500 --> 00:02.000\nhello world\n" in text


def test_txt_tsv_json_aud(tmp_path):
    for fmt in ["txt", "tsv", "json", "aud"]:
        out = _write_both(tmp_path, fmt, RESULT, "a.wav")
    assert (out / "a.txt").read_text() == "hello world\nagain\n"
    tsv = (out / "a.tsv").read_text().splitlines()
    assert tsv[0] == "start\tend\ttext"
    assert tsv[1] == "500\t2000\thello world"
    assert "hello world" in (out / "a.json").read_text()
    assert (out / "a.aud").read_text().splitlines()[0] == "0.5\t2.0\thello world"


def test_writer_all(tmp_path):
    out = _write_both(tmp_path, "all", RESULT, "b.wav")
    for ext in ["txt", "vtt", "srt", "tsv", "json"]:
        assert (out / f"b.{ext}").exists()


def test_speaker_prefix(tmp_path):
    result = {"language": "en", "segments": [{**RESULT["segments"][0], "speaker": "SPEAKER_00"}]}
    assert "[SPEAKER_00]: hello world" in (_write_both(tmp_path, "srt", result, "c.wav") / "c.srt").read_text()


def test_highlight_words(tmp_path):
    options = {"max_line_width": None, "max_line_count": None, "highlight_words": True}
    text = (_write_both(tmp_path, "srt", RESULT, "d.wav", options) / "d.srt").read_text()
    assert "<u>hello</u>" in text and "<u>world</u>" in text


def test_line_wrapping(tmp_path):
    options = {"max_line_width": 8, "max_line_count": 1, "highlight_words": False}
    text = (_write_both(tmp_path, "srt", RESULT, "e.wav", options) / "e.srt").read_text()
    # width 8 forces "hello" and "world" into separate blocks (1 line max)
    assert len([b for b in text.split("\n\n") if b.strip()]) == 3


def test_segment_level_cues_without_words(tmp_path):
    result = {"language": "en", "segments": [{"start": 0.0, "end": 1.0, "text": " plain"}]}
    assert "plain" in (_write_both(tmp_path, "srt", result, "f.wav") / "f.srt").read_text()


def test_misc_utils():
    assert exact_div(480000, 160) == 3000
    assert compression_ratio("aaaaaaaaaaaaaaaa") > 1.0


def test_interpolate_nans():
    x = np.array([np.nan, 1.0, np.nan, 3.0, np.nan])
    out = interpolate_nans(x)
    assert not np.isnan(out).any()
    assert out[0] == 1.0 and out[4] == 3.0
    assert out[2] in (1.0, 3.0)
    assert np.isnan(interpolate_nans(np.array([np.nan, np.nan]))).all()
    np.testing.assert_array_equal(interpolate_nans(np.array([np.nan, 2.0, np.nan])), [2.0, 2.0, 2.0])


# ---- the port's CLI against the JAX package's ------------------------------


def test_flag_table_matches_jax():
    """Name for name and default for default, save --device (cuda, not tpu)."""
    from whisperx_tpu.cli import build_parser as j_build_parser

    def table(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs, a.type) for a in parser._actions}

    got, want = table(build_parser()), table(j_build_parser())
    assert list(got) == list(want)
    for k in want:
        if k == "device":
            assert got[k][1] == "cuda" and want[k][1] == "tpu"
            continue
        assert got[k][:4] == want[k][:4], k
        assert getattr(got[k][4], "__name__", got[k][4]) == getattr(want[k][4], "__name__", want[k][4]), k


def _two_speaker_wav(path):
    """Two in-band tone 'speakers' taking turns, with pauses and a noise floor."""
    from whisperx_tpu_torch.audio.io import write_wav

    rng = np.random.default_rng(0)
    t = np.arange(3 * SR) / SR
    a = 0.4 * np.sin(2 * np.pi * 500 * t) * (1 + 0.5 * np.sin(2 * np.pi * 4 * t))
    b = 0.4 * np.sin(2 * np.pi * 2000 * t) * (1 + 0.5 * np.sin(2 * np.pi * 5 * t))
    gap = np.zeros(SR // 2)
    audio = np.concatenate([gap, a, gap, b, gap, a, gap])
    write_wav(path, (audio + 0.003 * rng.standard_normal(len(audio))).astype(np.float32))
    return path


def _worded_vocab(path):
    """Replace the directory's 256-entry byte vocabulary by 50,257 entries
    (the bytes, then letter strings with and without a leading space), so
    that every text id a random model emits decodes to letters the aligner
    can place."""
    import itertools

    from tokenizers import pre_tokenizers

    vocab = sorted(pre_tokenizers.ByteLevel.alphabet())
    seen = set(vocab)
    letters = "abcdefghijklmnopqrstuvwxyz"
    for n in itertools.count(1):
        for combo in itertools.product(letters, repeat=n):
            for word in ("\u0120" + "".join(combo), "".join(combo)):
                if word not in seen and len(vocab) < 50257:
                    seen.add(word)
                    vocab.append(word)
        if len(vocab) == 50257:
            break
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump({c: i for i, c in enumerate(vocab)}, f)
    return path


@pytest.fixture(scope="module")
def both_cli_outputs(tmp_path_factory):
    """whisperx_tpu.cli.cli and whisperx_tpu_torch.cli.cli --device cpu on
    the same tiny HF Whisper and wav2vec2 directories, the same WAV file,
    float32 and --diarize; each writes all six formats (two runs: "all",
    then "aud")."""
    import whisperx_tpu.cli as j_cli
    import whisperx_tpu_torch.cli as t_cli
    from tests.test_torch_checkpoints import _wav2vec2_dir, _whisper_dir

    root = tmp_path_factory.mktemp("cli")
    whisper = _worded_vocab(_whisper_dir(root / "whisper", True))
    w2v = _wav2vec2_dir(root / "wav2vec2", True)
    wav = _two_speaker_wav(str(root / "meeting.wav"))
    argv = [wav, "--checkpoint", whisper, "--align_model", w2v, "--compute_type", "float32",
            "--language", "en", "--beam_size", "2", "--batch_size", "2", "--chunk_size", "5",
            "--diarize", "--min_speakers", "1", "--max_speakers", "2", "--suppress_tokens=-1,50257", "--verbose", "False"]
    # "all" writes five formats, as in the JAX CLI; "aud" is written on request.
    for fmt in ("all", "aud"):
        t_cli.cli(argv + ["--output_format", fmt, "--output_dir", str(root / "port"), "--device", "cpu"])
        j_cli.cli(argv + ["--output_format", fmt, "--output_dir", str(root / "jax")])
    return root


@pytest.mark.parametrize("ext", FORMATS)
def test_cli_writes_the_jax_cli_bytes(both_cli_outputs, ext):
    port = (both_cli_outputs / "port" / f"meeting.{ext}").read_bytes()
    assert port == (both_cli_outputs / "jax" / f"meeting.{ext}").read_bytes()
    if ext == "json":
        data = json.loads(port)
        assert data["segments"] and all("speaker" in s for s in data["segments"])
        assert data["word_segments"] and all(s["text"] for s in data["segments"])
        assert {s["speaker"] for s in data["segments"]} <= {"SPEAKER_00", "SPEAKER_01"}
