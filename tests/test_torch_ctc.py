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


def kernel_algorithm(logp, tok, t_len, n_len, blank=0, trellis_mode=False):
    """``csrc/ctc_align.cu``'s algorithm in numpy fp32, step for step, at the
    plan ``launch_plan`` gives: W warps of 32 lanes, lane l of warp w holding
    virtual columns v = (32 w + l) K + k in its K slots; emission rows in ring
    chunks of ``rows`` rows of V + 3 columns, -0.0 read as +0.0 (column V
    holds -0.0, column V + 1 column 1's advance X_t = col0[t] + lp[t][tok[0]],
    column V + 2 col0), the
    last chunk run on to a whole 4-row load (below 64 slots) on whatever the
    ring holds, with nothing stored; each step one shuffle
    of slot K - 1 up a lane (warp w - 1's lane 31 for lane 0, the injected
    value for warp 0's lane 0), the K columns from the previous row's
    registers (the max of stay and advance; the decision bit the sign of
    stay - advance), and in align mode each lane's K decision bits packed
    into one K-bit word, lane after lane. Align mode shifts the columns right so that
    column n_len is slot K - 1 of the last lane (its running argmax), with
    signed zeros left of column 1; then the walk, 32 steps a block on masks
    of the bits, and the epilogue (at j = 0 its own decision on column 0).
    Returns the trellis (trellis mode) or the kernel's five outputs."""
    B, T, V = logp.shape
    N = tok.shape[1]
    plan = tc.launch_plan(T, N, V, align=not trellis_mode)
    K, W, R = plan.slots, plan.warps, plan.rows
    VW = 4 if K < 64 else 1  # rows a ring load covers
    rng = np.random.default_rng(0)
    VC = 32 * K * W
    col0 = np.zeros((B, T + 1), np.float32)
    col0[:, 1:] = tc._first_column(torch.from_numpy(logp), torch.from_numpy(t_len), torch.from_numpy(n_len), blank).numpy()
    trellis = np.zeros((B, T + 1, N + 1), np.float32)
    tok_idx = np.zeros((B, T), np.int64)
    probs = np.zeros((B, T), np.float32)
    active = np.zeros((B, T), bool)
    success = np.zeros(B, bool)
    t_start = np.zeros(B, np.int64)
    for b in range(B):
        if ((tok[b] < 0) | (tok[b] >= V)).any() or not 0 <= n_len[b] <= N:
            raise IndexError("the kernel traps")
        nl = N if trellis_mode else int(n_len[b])
        tl = min(max(int(t_len[b]), -1), T)
        s = 0 if trellis_mode else VC - nl
        j = np.arange(VC).reshape(W, 32, K) - s + 1  # each slot's trellis column
        tok_b = tok[b][np.clip(j - 1, 0, N - 1)] if N else np.zeros_like(j)
        if trellis_mode:
            p = np.full((W, 32, K), -np.inf, np.float32)
            off = np.where(j <= N, tok_b, 0)
            trellis[b, 0] = -np.inf
            trellis[b, 0, 0] = col0[b, 0]
            trellis[b, 1:, 0] = col0[b, 1:]
        else:
            p = np.where(j < 1, np.float32(-0.0), np.float32(-np.inf)).astype(np.float32)
            off = np.where(j < 1, V, np.where(j == 1, V + 1, tok_b))
        bits = np.zeros((T, plan.words), np.uint32)
        best, best_r = np.float32(-np.inf), 0
        for t0 in range(0, T if trellis_mode or nl > 0 else 0, R):
            n = min(R, T - t0)
            nv = -(-n // VW) * VW
            ring = rng.standard_normal((nv, V + 3)).astype(np.float32) * 1e3  # rows past T: anything
            ring[:n, :V] = logp[b, t0 : t0 + n] + np.float32(0.0)  # -0.0 as +0.0
            ring[:n, V + 2] = col0[b, t0 : t0 + n] + np.float32(0.0)
            ring[:, V] = -0.0
            if not trellis_mode:
                if (ring[:n, blank] > 0).any():
                    raise ValueError("the kernel traps: a blank log-prob above 0")
                ring[:n, V + 1] = ring[:n, V + 2] + ring[:n, int(tok[b, 0])]
            for i in range(nv):
                t, row = t0 + i, ring[i]
                last = p[:, :, K - 1]
                left0 = np.empty((W, 32), np.float32)
                left0[:, 1:] = last[:, :-1]  # __shfl_up_sync
                left0[1:, 0] = last[:-1, 31]  # the warps' exchange
                left0[0, 0] = row[V + 2] if trellis_mode else np.float32(-0.0)
                left = np.concatenate([left0[:, :, None], p[:, :, :-1]], axis=2)
                stay = p + row[blank]
                with np.errstate(invalid="ignore", over="ignore"):  # rows past T
                    advance = left + row[off]
                    d = stay - advance  # inf - inf: the GPU's canonical NaN, sign clear
                take = (d < 0) | ((d == 0) & np.signbit(d))  # the sign bit of stay - advance
                p = np.fmax(stay, advance)
                if t >= T:
                    continue
                if trellis_mode:
                    trellis[b, t + 1, 1:] = p.reshape(-1)[:N]
                    continue
                # Each lane's K bits, lane after lane: the row's bits in column order.
                bits[t] = np.packbits(take.reshape(-1), bitorder="little").view(np.uint32)
                if t < tl and p[W - 1, 31, K - 1] > best:
                    best, best_r = p[W - 1, 31, K - 1], t + 1
        if trellis_mode:
            continue
        if nl == 0:  # the first argmax of column 0 over rows <= t_len: lanes, then a shuffle tree
            bv, br = [np.float32(-np.inf)] * 32, [0] * 32
            for r in range(tl + 1):
                if col0[b, r] > bv[r % 32]:
                    bv[r % 32], br[r % 32] = col0[b, r], r
            for o in (16, 8, 4, 2, 1):
                for ln in range(32 - o):
                    ov, orow = bv[ln + o], br[ln + o]
                    if ov > bv[ln] or (ov == bv[ln] and orow < br[ln]):
                        bv[ln], br[ln] = ov, orow
            best_r = br[0]
        ts = best_r
        jp = nl
        for k0 in range(0, T, 32):  # the walk
            vb = jp - 1 + s - 31
            masks = []
            for i in range(32):
                k, t = k0 + i, T - k0 - i
                m = 0
                if jp > 0 and k < T and t <= ts:
                    w0 = vb >> 5
                    lo = int(bits[t - 1, w0]) if w0 >= 0 else 0
                    hi = int(bits[t - 1, w0 + 1]) if vb & 31 else 0
                    m = (((hi << 32) | lo) >> (vb & 31)) & 0xFFFFFFFF
                    below = s - vb
                    if below > 0:
                        m &= 0 if below >= 32 else (0xFFFFFFFF << below) & 0xFFFFFFFF
                masks.append(m)
            e, moves = 31, 0
            for i in range(32):
                bit = (masks[i] >> e) & 1
                moves |= bit << i
                e -= bit
            for i in range(min(32, T - k0)):
                tok_idx[b, k0 + i] = jp - bin(moves & ((1 << i) - 1)).count("1")
            jp -= bin(moves).count("1")
        success[b], t_start[b] = jp == 0, ts
        for k in range(T):  # the epilogue
            r, jk = T - 1 - k, int(tok_idx[b, k])
            jm1 = max(jk - 1, 0)
            e = logp[b, r]
            if jk == 0:
                take = col0[b, r] + e[tok[b, 0]] > col0[b, r] + e[blank]
            else:
                v = jk - 1 + s
                take = (int(bits[r, v >> 5]) >> (v & 31)) & 1
            tok_idx[b, k] = jm1
            probs[b, k] = np.exp(e[tok[b, jm1]] if take else e[blank])
            active[b, k] = r + 1 <= ts and jk > 0
    if trellis_mode:
        return trellis
    return tok_idx, probs, active, success, t_start


def _assert_like_plain(got, logp, tok, t_len, n_len):
    args = (torch.from_numpy(logp), torch.from_numpy(tok), torch.from_numpy(t_len), torch.from_numpy(n_len))
    want = tc.ctc_align_batch_device_plain(*args)
    for name, g, w in zip(("token_idx", "probs", "active", "success", "t_start"), got, want):
        if name == "probs":
            np.testing.assert_allclose(g, w.numpy(), rtol=1e-6)
        else:
            np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    np.testing.assert_array_equal(kernel_algorithm(logp, tok, t_len, n_len, trellis_mode=True), tc.ctc_trellis_batch_plain(*args).numpy())


@pytest.mark.parametrize("n_zero", [False, True])
def test_kernel_algorithm_equals_the_plain_version(batch, n_zero):
    """The kernel's algorithm gives the plain version's outputs at every
    position, inactive ones included (t > t_start, the pointer at 0), which
    ``align/alignment.py:_fused_align_fwd`` packs whole, and its trellis
    mode the plain trellis bit for bit; with n_zero a row has no token, so
    the walk stays at column 0 from its first step."""
    logp, token_lists, t_lens = batch
    if n_zero:
        token_lists = [[]] + token_lists[1:]
    tok, n_len = _padded(token_lists, 128)
    tok, n_len, t_len = tok.astype(np.int64), n_len.astype(np.int64), np.asarray(t_lens, np.int64)
    got = kernel_algorithm(logp, tok, t_len, n_len)
    _assert_like_plain(got, logp, tok, t_len, n_len)
    if n_zero:  # without tokens the row aligns trivially, with no active step
        assert got[3][0] and not got[2][0].any() and (got[0][0] == 0).all()


@pytest.mark.parametrize(
    "T,V,N,t_lens,n_lens",
    [
        # N + 1 not a multiple of 32; an unalignable row (t_len < n_len); one token; none.
        (96, 32, 70, [96, 60, 40, 96, 50], [70, 33, 55, 1, 0]),
        (40, 12, 1, [40, 3], [1, 1]),  # N 1: 255 columns of signed zeros left of column 1
        (20, 12, 40, [20, 20, 17], [12, 40, 5]),  # T shorter than one ring chunk (32 rows)
        (150, 64, 100, [150, 149, 120], [100, 64, 31]),  # V 64, rows across five ring chunks
        (40, 32, 2100, [40, 40], [30, 2100]),  # N above 2,048: two warps of 64 slots, a mailbox between them
        (30, 32, 9000, [30], [8999]),  # five warps of 64 slots
        (100, 3500, 128, [100, 90], [60, 128]),  # a vocabulary of 3,500 ids: a one-stage ring of 8-row chunks
    ],
)
def test_kernel_algorithm_edge_shapes(T, V, N, t_lens, n_lens):
    """The same at the plan's edges: ragged column counts, K 8 with most
    columns virtual, a single ring chunk, a wide vocabulary, several warps,
    and a last chunk padded to whole loads (T not a multiple of 4)."""
    rng = np.random.default_rng(T + N + V)
    logp = _logp(rng, (len(t_lens), T, V)) * np.float32(3)
    logp -= np.log(np.exp(logp).sum(-1, keepdims=True))
    tok = rng.integers(1, V, (len(t_lens), N)).astype(np.int64)
    t_len, n_len = np.asarray(t_lens, np.int64), np.asarray(n_lens, np.int64)
    got = kernel_algorithm(logp, tok, t_len, n_len)
    _assert_like_plain(got, logp, tok, t_len, n_len)
    assert got[3][np.argmin(t_len - n_len)] == (min(t_len - n_len) >= 0)


def test_kernel_algorithm_signed_zeros():
    """Blank log-probs of exactly 0 (+0.0 and -0.0) and tokens whose log-prob
    is 0: the signed zeros left of column 1 turn +0 but column 1's advance
    keeps its value; a blank above 0 is not a log-probability, and the kernel
    traps."""
    T, V = 64, 8
    logp = np.full((2, T, V), -30.0, np.float32)
    logp[:, ::3, 0] = 0.0  # blank certain on every third frame
    logp[:, 1::3, 2] = 0.0
    logp[:, 2::3, 3] = 0.0
    logp[:, 1::6, 0] = -0.0  # and -0.0 (the kernel reads it as +0.0: equal values, zero signs aside)
    logp[:, ::4, 5] = -0.0
    tok = np.tile(np.array([2, 3, 2, 3, 5], np.int64), (2, 1))
    t_len, n_len = np.array([64, 50], np.int64), np.array([5, 4], np.int64)
    got = kernel_algorithm(logp, tok, t_len, n_len)
    _assert_like_plain(got, logp, tok, t_len, n_len)
    logp[1, 7, 0] = 0.5
    with pytest.raises(ValueError, match="traps"):
        kernel_algorithm(logp, tok, t_len, n_len)


def _barriered_plan_fits(T, N, V):
    """The barriered design's plan (one CTA a segment, one barrier a step)
    accepted a shape when two trellis rows, an emission chunk and the token
    ids fit in a CTA's shared memory."""
    chunk = max(1, min(64, 8192 // V))
    return 4 * (2 * (N + 1) + chunk * (V + 1) + N + 4) <= tc.SMEM_LIMIT


@pytest.mark.parametrize(
    "T,N,V,slots,in_smem",
    [(1499, 448, 32, 16, True), (1499, 64, 32, 8, True), (1499, 1024, 32, 32, True), (1499, 1280, 32, 64, False),
     (120, 128, 12, 8, True)],
)
def test_launch_plan(T, N, V, slots, in_smem):
    """The kernel's plan: one warp with K slots a lane covers the N columns up
    to 2,048 (K 8, 16, 32 or 64), several warps of 64 beyond; eight warps a
    CTA for the epilogue; a ring stage of 32 rows of the V + 3 columns within
    32 KB; the decision bits, T x 32 K W bits, sit in shared memory exactly
    when the whole layout fits in the 227 KB a CTA can use (else a scratch
    buffer)."""
    plan = tc.launch_plan(T, N, V)
    assert (plan.slots, plan.warps, plan.threads, plan.rows, plan.stages) == (slots, 1, 256, 32, 2)
    assert 32 * plan.slots >= N and plan.words == plan.slots
    assert plan.bits_in_smem == in_smem
    ring = 2 * (V + 3) * tc.row_pitch(32, slots)
    assert 4 * ring / 2 <= tc.STAGE_BYTES
    base = ring + ring % 2 + 1
    assert plan.smem_bytes == 4 * ((-(-base // 4) * 4 + tc.bit_rows(T) * plan.words) if in_smem else base) <= tc.SMEM_LIMIT
    assert not tc.launch_plan(T, N, V, align=False).bits_in_smem
    if N == 448:
        assert 4 * tc.bit_rows(T) * plan.words == 96_000  # the ~96 KB of decision bits at the alignment path's shapes


@pytest.mark.parametrize(
    "T,N,V,plan",
    [(1499, 128, 3500, (8, 1, 256, 8, 1, True)), (1499, 2100, 32, (64, 2, 256, 32, 2, False)),
     (1499, 9000, 32, (64, 5, 256, 32, 2, False))],
)
def test_launch_plan_one_stage_and_several_warps(T, N, V, plan):
    """A vocabulary of thousands of ids leaves room for one ring stage of
    8 rows (each chunk then waits for its stage to be read); above 2,048
    columns the plan takes several warps of 64 slots a lane."""
    got = tc.launch_plan(T, N, V)
    assert (got.slots, got.warps, got.threads, got.rows, got.stages, got.bits_in_smem) == plan
    assert got.smem_bytes <= tc.SMEM_LIMIT and 32 * got.slots * got.warps >= N


@pytest.mark.parametrize("slots,warps", [(8, 2), (16, 2), (32, 4), (12, 1), (64, 0), (64, tc.MAX_WARPS + 1)])
def test_plan_for_refuses_what_the_kernel_refuses(slots, warps):
    """plan_for hands out no plan the kernel would refuse: several warps
    only at 64 slots a lane, slots on the ladder, at most MAX_WARPS warps."""
    with pytest.raises(ValueError):
        tc.plan_for(1499, 64, 32, True, slots, warps)


def test_row_pitch_spreads_the_banks():
    """A ring column's pitch: below 64 slots a multiple of 4 floats whose
    quarter is odd (a 4-row load is 16 aligned bytes, and columns apart by
    one pitch fall in different 16-byte bank groups); at 64 slots an odd
    number of floats (rows read one at a time)."""
    for rows in range(4, 33, 4):
        rp = tc.row_pitch(rows, 16)
        assert rp >= rows and rp % 4 == 0 and (rp // 4) % 2 == 1
        assert len({(col * rp // 4) % 8 for col in range(8)}) == 8
    for rows in range(1, 33):
        assert tc.row_pitch(rows, 64) % 2 == 1 and rows <= tc.row_pitch(rows, 64) <= rows + 1


@pytest.mark.parametrize("V", [12, 32, 64, 8192, 29_000, 58_102])
def test_launch_plan_takes_every_shape_the_barriered_plan_took(V):
    """No shape the barriered design's plan accepted is refused: at each vocabulary size,
    the largest N it took (and N 1, and N 0 in trellis mode) still plans,
    several warps only at 64 slots a lane."""
    n_max = max(n for n in (0, 1, *range(2, 20_000, 7)) if _barriered_plan_fits(1499, n, V)) if _barriered_plan_fits(1499, 0, V) else -1
    for N in {n for n in (0, 1, 448, 2048, 2049, n_max) if 0 <= n <= n_max}:
        for align in (True, False) if N else (False,):
            plan = tc.launch_plan(1499, N, V, align)
            assert 32 * plan.slots * plan.warps >= N and plan.warps <= tc.MAX_WARPS
            assert plan.threads == 32 * max(plan.warps + 1, 8) and plan.smem_bytes <= tc.SMEM_LIMIT
            assert plan.warps == 1 or plan.slots == 64


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
