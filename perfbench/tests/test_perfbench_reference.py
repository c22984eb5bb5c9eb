"""The plain reference agrees with itself and with plain arithmetic, at tiny
widths on the CPU."""

import numpy as np
import pytest
import torch

import tiny
from benchlib import system
from reference import ctc, quant, wav2vec2, whisper


def test_log_mel_matches_numpy_stft():
    rng = np.random.default_rng(0)
    audio = (0.1 * rng.standard_normal(16000 * 30)).astype(np.float32)
    got = whisper.log_mel(torch.from_numpy(audio)[None], 80)[0].numpy()
    x = np.pad(audio.astype(np.float64), 200, mode="reflect")
    win = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(400) / 400)
    frames = np.stack([x[i * 160 : i * 160 + 400] * win for i in range(3000)])
    power = np.abs(np.fft.rfft(frames, axis=1)) ** 2
    log = np.log10(np.maximum(whisper.mel_filters(80).astype(np.float64) @ power.T, 1e-10))
    want = (np.maximum(log, log.max() - 8.0) + 4.0) / 4.0
    assert np.abs(got - want).max() < 1e-4


@pytest.fixture(scope="module")
def tiny_whisper():
    cfg = tiny.cell().config
    tree = system.whisper_tree(cfg, 7, "cpu")
    return whisper.Whisper(tree, cfg["whisper"]), cfg


def test_teacher_forcing_is_causal(tiny_whisper):
    model, cfg = tiny_whisper
    mel = torch.randn(2, 80, 3000) * 0.5
    cross = model.cross_kv(model.encode(mel))
    tokens = torch.randint(0, 50000, (2, 12))
    full = model.logits(cross, tokens, 12)
    for n in (1, 5, 12):
        assert torch.allclose(model.logits(cross, tokens[:, :n], 1)[:, 0], full[:, n - 1], atol=1e-4)


def test_cached_decode_matches_teacher_forcing(tiny_whisper):
    model, _ = tiny_whisper
    cross = model.cross_kv(model.encode(torch.randn(2, 80, 3000) * 0.5))
    tokens = torch.randint(0, 50000, (2, 9))
    full, _ = model.decode(cross, tokens)
    x, cache = model.decode(cross, tokens[:, :4])
    for t in range(4, 9):
        x, cache = model.decode(cross, tokens[:, t : t + 1], cache)
        assert torch.allclose(x[:, 0], full[:, t], atol=1e-4)


def test_beam_search_scores_its_own_tokens(tiny_whisper):
    from reference import tokens as rt

    model, cfg = tiny_whisper
    V = cfg["whisper"]["vocab_size"]
    cross = model.cross_kv(model.encode(torch.randn(2, 80, 3000) * 0.5))
    prompt = rt.prompt(V)
    lp = lambda logits, first: rt.masked_log_probs(logits, V, first)  # noqa: E731
    for beam in (1, 3):
        toks, score = model.beam_search(cross, prompt, beam, 5, lp)
        logits = model.logits(cross, torch.cat([torch.tensor(prompt).expand(2, -1), toks[:, :-1]], 1), 5)
        lps = torch.stack([lp(logits[:, s], s == 0) for s in range(5)], 1)
        assert torch.allclose(torch.gather(lps, -1, toks[..., None]).sum((1, 2)), score, atol=1e-3)
        if beam == 1:  # greedy: each token is its position's best
            assert torch.equal(lps.argmax(-1), toks)


def test_rows_do_not_mix(tiny_whisper):
    model, _ = tiny_whisper
    mel = torch.randn(3, 80, 3000) * 0.5
    both = model.encode(mel)
    assert torch.allclose(model.encode(mel[1:2])[0], both[1], atol=1e-5)


def test_exact_precision_is_the_weights_and_lower_ones_are_not():
    w = torch.randn(64, 32)
    assert quant.lower(w, "exact", 0) is w
    q = quant.lower(w, "int4", 0)
    assert all(len(torch.unique(q[:, j])) <= 15 for j in range(32))
    assert 0 < (quant.lower(w, "fp8", 0) - w).abs().max() < 0.1 * w.abs().max()


def test_ctc_walk_finds_planted_tokens():
    # Tokens all but impossible outside their blocks: the walk must put each
    # token's first frame at its block (it ends after the last token).
    T, V = 60, 5
    lp = np.full((T, V), np.log(1e-9))
    lp[:, 0] = np.log(0.96)
    tokens = [1, 2, 3]
    for k, (a, b) in enumerate([(10, 14), (30, 33), (45, 50)]):
        lp[a:b, 0] = np.log(0.1)
        lp[a:b, tokens[k]] = np.log(0.9)
    steps = ctc.path(lp, tokens)
    assert max(t for _, t, _ in steps) == 45
    firsts = {k: min(t for j, t, _ in steps if j == k) for k in range(3)}
    assert firsts == {0: 10, 1: 30, 2: 45}
    words = ctc.words(" ab c", {"a": 1, "b": 2, "c": 3, "|": 4}, lp, 0.0, 6.0)
    assert [w[0] for w in words] == ["ab", "c"]
    assert words[0][1] == pytest.approx(1.0) and words[1][1] == pytest.approx(4.5) and words[1][2] == pytest.approx(4.6)


def test_wav2vec2_rows_are_independent_at_one_padded_length():
    cfg = tiny.cell().config
    model = wav2vec2.Wav2Vec2(system.wav2vec2_tree(cfg, 3, "cpu"), cfg["wav2vec2"])
    audio = torch.randn(2, 32000) * 0.1
    audio[1, 20000:] = 0
    both = model.log_probs(audio, [32000, 20000])
    one = model.log_probs(audio[1:], [20000])
    n = wav2vec2.frames(20000, cfg["wav2vec2"])
    assert torch.allclose(both[1, :n], one[0, :n], atol=1e-4)
    assert torch.allclose(both.exp().sum(-1), torch.ones(both.shape[:2]), atol=1e-4)
