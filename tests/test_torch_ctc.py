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


@pytest.mark.parametrize("N", [40, 70])
def test_unalignable_row_and_ragged_columns_match_jax(N):
    """A row with fewer frames than tokens (it cannot align) beside rows that
    can, at an N + 1 that is not a multiple of 32 (the kernel's ballot words
    end inside a warp): every output of the fused walk equals the JAX
    package's, and the paths too."""
    rng = np.random.default_rng(N)
    B, T, V = 4, 96, 32
    logp = _logp(rng, (B, T, V))
    token_lists = [list(rng.integers(1, V, N)), list(rng.integers(1, V, N // 2)), list(rng.integers(1, V, 7)), [3]]
    t_lens = [N - 5, 96, 60, 1]  # row 0: t_len < n_len
    tok, n_len = _padded(token_lists, N)
    want = jc.ctc_align_batch_device(jnp.asarray(logp), jnp.asarray(tok), jnp.asarray(t_lens, jnp.int32), jnp.asarray(n_len))
    got = tc.ctc_align_batch_device(torch.from_numpy(logp), torch.from_numpy(tok), torch.tensor(t_lens), torch.from_numpy(n_len))
    for name, w, g in zip(("token_idx", "probs", "active", "success", "t_start"), want, got):
        if name == "probs":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[3].tolist() == [False, True, True, True]
    paths = tc.align_tokens_batch(logp, token_lists, t_lens)
    jpaths = jc.align_tokens_batch(logp, token_lists, t_lens)
    assert [p is None for p in paths] == [p is None for p in jpaths] == [True, False, False, False]
    for g, w in zip(paths[1:], jpaths[1:]):
        assert [(p.token_index, p.time_index) for p in g] == [(p.token_index, p.time_index) for p in w]


def kernel_algorithm(logp, tok, t_len, n_len, blank=0):
    """``csrc/ctc_align.cu``'s algorithm in numpy fp32, step for step: the
    trellis rows with the decision bits ``advance > stay`` (ties keep stay),
    column n_len's running argmax over rows <= t_len, the walk over the
    bits writing the pointer before each step, then the epilogue (at j = 0
    its own decision on column 0). Returns the kernel's five outputs."""
    B, T, V = logp.shape
    N = tok.shape[1]
    col0 = np.zeros((B, T + 1), np.float32)
    col0[:, 1:] = tc._first_column(torch.from_numpy(logp), torch.from_numpy(t_len), torch.from_numpy(n_len), blank).numpy()
    tok_idx = np.zeros((B, T), np.int64)
    probs = np.zeros((B, T), np.float32)
    active = np.zeros((B, T), bool)
    success = np.zeros(B, bool)
    t_start = np.zeros(B, np.int64)
    for b in range(B):
        nl, tl = int(n_len[b]), int(t_len[b])
        prev = np.full(N + 1, -np.inf, np.float32)
        prev[0] = col0[b, 0]
        bits = np.zeros((T, N + 1), bool)
        best, best_r = (col0[b, 0] if nl == 0 else np.float32(-np.inf)), 0
        for t in range(T):
            e = logp[b, t]
            stay = prev[1:] + e[blank]
            advance = prev[:-1] + e[tok[b]]
            bits[t, 1:] = advance > stay
            nxt = np.empty_like(prev)
            nxt[0] = col0[b, t + 1]
            nxt[1:] = np.where(bits[t, 1:], advance, stay)
            if t + 1 <= tl and nxt[nl] > best:
                best, best_r = nxt[nl], t + 1
            prev = nxt
        j = nl
        for k in range(T):
            t = T - k
            tok_idx[b, k] = j
            if t <= best_r and j > 0 and bits[t - 1, j]:
                j -= 1
        success[b], t_start[b] = j == 0, best_r
        for k in range(T):
            r, j = T - 1 - k, int(tok_idx[b, k])
            jm1 = max(j - 1, 0)
            e = logp[b, r]
            take = col0[b, r] + e[tok[b, 0]] > col0[b, r] + e[blank] if j == 0 else bits[r, j]
            tok_idx[b, k] = jm1
            probs[b, k] = np.exp(e[tok[b, jm1]] if take else e[blank])
            active[b, k] = r + 1 <= best_r and j > 0
    return tok_idx, probs, active, success, t_start


@pytest.mark.parametrize("n_zero", [False, True])
def test_kernel_algorithm_equals_the_plain_version(batch, n_zero):
    """The kernel's algorithm gives the plain version's outputs at every
    position, inactive ones included (t > t_start, the pointer at 0), which
    ``align/alignment.py:_fused_align_fwd`` packs whole; with n_zero a row
    has no token, so the walk stays at column 0 from its first step."""
    logp, token_lists, t_lens = batch
    if n_zero:
        token_lists = [[]] + token_lists[1:]
    tok, n_len = _padded(token_lists, 128)
    tok, n_len, t_len = tok.astype(np.int64), n_len.astype(np.int64), np.asarray(t_lens, np.int64)
    got = kernel_algorithm(logp, tok, t_len, n_len)
    want = tc.ctc_align_batch_device_plain(torch.from_numpy(logp), torch.from_numpy(tok), torch.from_numpy(t_len), torch.from_numpy(n_len))
    for name, g, w in zip(("token_idx", "probs", "active", "success", "t_start"), got, want):
        if name == "probs":
            np.testing.assert_allclose(g, w.numpy(), rtol=1e-6)
        else:
            np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    if n_zero:  # without tokens the row aligns trivially, with no active step
        assert got[3][0] and not got[2][0].any() and (got[0][0] == 0).all()


@pytest.mark.parametrize(
    "T,N,V,in_smem",
    [(1499, 448, 32, True), (1499, 64, 32, True), (1499, 1024, 32, True), (1499, 1280, 32, False), (120, 128, 12, True)],
)
def test_launch_plan(T, N, V, in_smem):
    """The kernel's plan: threads cover the N + 1 columns in warps (at most
    1024), the emission chunk stays within 32 KB, and the decision bits,
    T x ceil((N + 1) / 32) words, sit in shared memory exactly when the whole
    layout fits in the 227 KB a CTA can use (else a scratch buffer)."""
    plan = tc.launch_plan(T, N, V)
    words = -(-(N + 1) // 32)
    assert plan.words == words and plan.bits_in_smem == in_smem
    assert plan.threads % 32 == 0 and plan.threads <= 1024 and (plan.threads >= N + 1 or plan.threads == 1024)
    assert plan.chunk * V * 4 <= 32768
    base = 4 * (2 * (N + 1) + plan.chunk * (V + 1) + N + 4)
    assert plan.smem_bytes == base + (4 * T * words if in_smem else 0) <= tc.SMEM_LIMIT
    assert not tc.launch_plan(T, N, V, align=False).bits_in_smem
    if N == 448:
        assert 4 * T * words == 89_940  # the ~90 KB of decision bits at the alignment path's shapes


def test_cpu_tensors_take_the_plain_version(batch):
    """On a CPU tensor the wrappers run the plain versions and launch no
    kernel."""
    logp, token_lists, t_lens = batch
    tok, n_len = _padded(token_lists, 128)
    args = (torch.from_numpy(logp), torch.from_numpy(tok), torch.tensor(t_lens), torch.from_numpy(n_len))
    before = tc.launches
    assert torch.equal(tc.ctc_trellis_batch(*args), tc.ctc_trellis_batch_plain(*args))
    for g, w in zip(tc.ctc_align_batch_device(*args), tc.ctc_align_batch_device_plain(*args)):
        assert torch.equal(g, w)
    assert tc.launches == before
