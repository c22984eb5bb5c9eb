"""whisperx_tpu_torch CTC trellis and backtracks against the JAX package's
``ops/ctc.py`` on the same emissions, and against a brute-force DP oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperx_tpu.ops import ctc as jc
from whisperx_tpu_torch.ops import ctc as tc

torch.set_num_threads(2)


def brute_force_trellis(emission, tokens, blank=0):
    """Direct per-cell implementation of the published recurrence (the
    oracle of tests/test_ctc.py)."""
    T, V = emission.shape
    N = len(tokens)
    trellis = np.zeros((T + 1, N + 1), np.float32)
    trellis[1:, 0] = np.cumsum(emission[:, blank])
    trellis[0, 1:] = -np.inf
    trellis[T - N + 1 :, 0] = np.inf
    for t in range(T):
        for j in range(1, N + 1):
            trellis[t + 1, j] = max(
                trellis[t, j] + emission[t, blank],
                trellis[t, j - 1] + emission[t, tokens[j - 1]],
            )
    return trellis


def _logp(rng, shape):
    logits = rng.standard_normal(shape).astype(np.float32)
    return logits - np.log(np.exp(logits).sum(-1, keepdims=True))


@pytest.fixture
def batch():
    """Rows that align easily, rows with nearly as many tokens as frames, a
    row that cannot align (more tokens than frames), and padded lengths."""
    rng = np.random.default_rng(5)
    B, T, V = 5, 120, 12
    logp = _logp(rng, (B, T, V))
    token_lists = [[3, 4, 5], [1, 2, 3, 4, 5, 6, 7, 8], list(rng.integers(1, V, 110)), [9], list(rng.integers(1, V, 30))]
    t_lens = [120, 80, 115, 25, 20]
    return logp, token_lists, t_lens


def _padded(token_lists, N):
    tok = np.zeros((len(token_lists), N), np.int32)
    n_len = np.zeros(len(token_lists), np.int32)
    for i, tl in enumerate(token_lists):
        tok[i, : len(tl)] = tl
        n_len[i] = len(tl)
    return tok, n_len


def test_trellis_matches_jax(batch):
    """Same recurrence, same +inf/-inf pattern. Column 0 is a cumsum, which
    XLA sums in another association than torch.cumsum, so finite cells agree
    to fp32 rounding rather than bit for bit (the paths below are equal)."""
    logp, token_lists, t_lens = batch
    tok, n_len = _padded(token_lists, 128)
    want = np.asarray(jc.ctc_trellis_batch(jnp.asarray(logp), jnp.asarray(tok), jnp.asarray(t_lens, jnp.int32), jnp.asarray(n_len)))
    got = tc.ctc_trellis_batch(torch.from_numpy(logp), torch.from_numpy(tok), torch.tensor(t_lens), torch.from_numpy(n_len)).numpy()
    assert got.shape == want.shape == (5, 121, 129)
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("T,N", [(20, 5), (18, 4), (10, 2), (6, 6)])
def test_trellis_matches_bruteforce(T, N):
    rng = np.random.default_rng(T * 10 + N)
    em = _logp(rng, (T, 8))
    tokens = rng.integers(1, 8, N).tolist()
    got = tc.ctc_trellis_batch(torch.from_numpy(em[None]), torch.tensor([tokens]), torch.tensor([T]), torch.tensor([N])).numpy()[0]
    ref = brute_force_trellis(em, tokens)
    finite = np.isfinite(ref)
    np.testing.assert_allclose(got[finite], ref[finite], atol=1e-4)
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(ref))


def test_device_backtrack_matches_jax(batch):
    """Every output of the fused device walk equals ctc_align_batch_device's:
    token indices, active steps, success and start rows exactly, probs to
    fp32 rounding of exp."""
    logp, token_lists, t_lens = batch
    tok, n_len = _padded(token_lists, 128)
    want = jc.ctc_align_batch_device(jnp.asarray(logp), jnp.asarray(tok), jnp.asarray(t_lens, jnp.int32), jnp.asarray(n_len))
    got = tc.ctc_align_batch_device(torch.from_numpy(logp), torch.from_numpy(tok), torch.tensor(t_lens), torch.from_numpy(n_len))
    names = ("token_idx", "probs", "active", "success", "t_start")
    for name, w, g in zip(names, want, got):
        w, g = np.asarray(w), g.numpy()
        assert g.shape == w.shape, name
        if name == "probs":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert not got[3].numpy().all()  # one row cannot align


@pytest.mark.parametrize("impl", ["device", "host"])
def test_paths_match_jax(batch, impl):
    logp, token_lists, t_lens = batch
    want = jc.align_tokens_batch(logp, token_lists, t_lens, blank=0, backtrack_impl=impl)
    got = tc.align_tokens_batch(logp, token_lists, t_lens, blank=0, backtrack_impl=impl)
    assert [p is None for p in got] == [p is None for p in want] == [False, False, False, False, True]
    for g, w in zip(got, want):
        if w is None:
            continue
        assert [(p.token_index, p.time_index) for p in g] == [(p.token_index, p.time_index) for p in w]
        np.testing.assert_allclose([p.score for p in g], [p.score for p in w], rtol=1e-6)


def test_device_walk_matches_host_walk(batch):
    logp, token_lists, t_lens = batch
    host = tc.align_tokens_batch(logp, token_lists, t_lens, backtrack_impl="host")
    dev = tc.align_tokens_batch(logp, token_lists, t_lens, backtrack_impl="device")
    for h, d in zip(host, dev):
        assert (h is None) == (d is None)
        if h is not None:
            assert [(p.token_index, p.time_index) for p in h] == [(p.token_index, p.time_index) for p in d]
            np.testing.assert_allclose([p.score for p in h], [p.score for p in d], rtol=1e-5, atol=1e-6)


def test_host_backtrack_matches_jax_on_bruteforce_trellis():
    rng = np.random.default_rng(1)
    em = _logp(rng, (40, 7))
    tokens = [1, 2, 3, 4, 5, 6, 2]
    tr = brute_force_trellis(em, tokens)
    got = tc.backtrack(tr, em[:, 0], em[:, tokens])
    want = jc.backtrack(tr, em[:, 0], em[:, tokens])
    assert [(p.token_index, p.time_index, p.score) for p in got] == [(p.token_index, p.time_index, p.score) for p in want]
    # More tokens than frames: the walk cannot consume them all.
    em2 = np.log(np.full((2, 4), 0.25, np.float32))
    tr2 = brute_force_trellis(em2, [1, 2, 3])
    assert tc.backtrack(tr2, em2[:, 0], em2[:, [1, 2, 3]]) == jc.backtrack(tr2, em2[:, 0], em2[:, [1, 2, 3]])


def test_merge_repeats_and_words_match_jax(batch):
    logp, token_lists, t_lens = batch
    text = "ab|cd|efgh"
    path = tc.align_tokens_batch(logp[:1], [[1 + (ord(c) % 10) for c in text]], [120])[0]
    jpath = [jc.PathPoint(p.token_index, p.time_index, p.score) for p in path]
    spans, jspans = tc.merge_repeats(path, text), jc.merge_repeats(jpath, text)
    assert [(s.label, s.start, s.end, s.score) for s in spans] == [(s.label, s.start, s.end, s.score) for s in jspans]
    words = tc.merge_words(spans)
    jwords = jc.merge_words(jspans)
    assert [(w.label, w.start, w.end, w.score) for w in words] == [(w.label, w.start, w.end, w.score) for w in jwords]
    assert [w.label for w in words] == ["ab", "cd", "efgh"]


def test_planted_alignment_is_recovered():
    """Emissions peaked on a known path recover it (tests/test_ctc.py's plan):
    advance 'a', blank, advance 'b', blank, advance 'c'."""
    V = 6
    frame_labels = [2, 0, 3, 0, 1]
    em = np.full((len(frame_labels), V), -10.0, np.float32)
    for t, lab in enumerate(frame_labels):
        em[t, lab] = -0.01
    for impl in ("device", "host"):
        path = tc.align_tokens_batch(em[None], [[2, 3, 1]], [5], blank=0, backtrack_impl=impl)[0]
        spans = tc.merge_repeats(path, "abc")
        assert [(s.label, s.start, s.end) for s in spans] == [("a", 0, 2), ("b", 2, 4), ("c", 4, 5)]


def test_unknown_backend_raises():
    logp = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 10, 5)).astype(np.float32))
    tokens, t_len, n_len = torch.tensor([[1, 2]]), torch.tensor([10]), torch.tensor([2])
    with pytest.raises(ValueError, match="unknown CTC trellis backend"):
        tc.ctc_align_batch_device(logp, tokens, t_len, n_len, blank=0, backend="pallas")
