"""whisperx_tpu_torch greedy and beam search against the JAX package's, on a
synthetic step function with a small vocabulary: hypotheses finish at
different lengths, two tokens always tie exactly (tie order decides which
candidates are kept), patience and length penalty are away from 1."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperx_tpu.decode import search as jsearch
from whisperx_tpu_torch.decode import search as tsearch

torch.set_num_threads(2)

V, DH, EOT, B = 64, 16, 3, 3


def _tables(seed, eot_bias=1.5):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((V, DH)).astype(np.float32)
    proj = (rng.standard_normal((DH, V)) * 0.8).astype(np.float32)
    proj[:, 10] += 1.0  # make token 10 likely...
    emb[11], proj[:, 11] = emb[10], proj[:, 10]  # ...and token 11 its exact tie
    proj[:, EOT] += eot_bias  # make hypotheses finish early, at various steps
    init = (rng.standard_normal((B, V)) * 2).astype(np.float32)
    return emb, proj, init


def _step_fns(seed, eot_bias=1.5):
    emb, proj, _ = _tables(seed, eot_bias)

    def jstep(tokens, cache, pos):
        h = 0.5 * cache[0]["h"] + jnp.asarray(emb)[tokens[:, 0]]
        return (h @ jnp.asarray(proj))[:, None, :], [{"h": h}]

    def tstep(tokens, cache, pos):
        h = 0.5 * cache[0]["h"] + torch.from_numpy(emb)[tokens[:, 0]]
        return (h @ torch.from_numpy(proj))[:, None, :], [{"h": h}]

    return jstep, tstep


def _opts(mod, **kw):
    return mod.SearchOptions(
        eot=EOT, suppress_tokens=(5,), blank_tokens=(7,), banned_tokens=(9,), max_new_tokens=10, **kw
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("beam,patience,alpha", [(3, 1.0, 1.0), (4, 1.5, 0.8)])
def test_beam_search_matches_jax(seed, beam, patience, alpha):
    jstep, tstep = _step_fns(seed)
    init = _tables(seed)[2]
    kw = dict(beam_size=beam, patience=patience, length_penalty=alpha)
    jcache = [{"h": jnp.zeros((B * beam, DH), jnp.float32)}]
    tcache = [{"h": torch.zeros((B * beam, DH))}]
    want = jsearch.beam_decode(jstep, jnp.asarray(init), jcache, 4, _opts(jsearch, **kw))
    got = tsearch.beam_decode(tstep, torch.from_numpy(init), tcache, 4, _opts(tsearch, **kw))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_matches_jax(seed):
    jstep, tstep = _step_fns(seed)
    init = _tables(seed)[2]
    want = jsearch.greedy_decode(jstep, jnp.asarray(init), [{"h": jnp.zeros((B, DH))}], 4, _opts(jsearch, beam_size=1))
    got = tsearch.greedy_decode(tstep, torch.from_numpy(init), [{"h": torch.zeros((B, DH))}], 4, _opts(tsearch, beam_size=1))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-5)


def test_sampling_follows_its_generator_and_the_masks():
    """temperature > 0 draws from the caller's torch.Generator: the same seed
    gives the same tokens, and no draw is a suppressed or banned token."""
    _, tstep = _step_fns(0)
    init = torch.from_numpy(_tables(0)[2])
    opts = _opts(tsearch, beam_size=1, temperature=1.5)

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return tsearch.greedy_decode(tstep, init, [{"h": torch.zeros((B, DH))}], 4, opts, gen)[0]

    first = run(0)
    assert torch.equal(first, run(0))
    assert not torch.isin(first, torch.tensor([5, 9])).any()
    assert not (first[:, 0] == 7).any()  # the blank token is masked at step 0
    assert any(not torch.equal(first, run(seed)) for seed in (1, 2, 3))


def _draw_inputs(seed=11, step=3, B=4, V=16):
    return (torch.tensor(seed), torch.tensor(step), torch.arange(B), torch.arange(V))


def test_draw_is_a_pure_function_of_seed_step_row_and_vocab():
    """The sampled draw's lanes depend on (seed, step, row, vocabulary index)
    and on nothing else: the same inputs give the same bits, and a change
    to any one of the four changes them. Lanes are 32-bit values held in
    int64, and the noise's uniforms never reach 0 or 1."""
    seed, step, rows, vocab = _draw_inputs()
    bits = tsearch.draw_bits(seed, step, rows, vocab)
    assert bits.dtype == torch.int64 and bits.shape == (4, 16)
    assert int(bits.min()) >= 0 and int(bits.max()) < 2**32
    assert torch.equal(bits, tsearch.draw_bits(*_draw_inputs()))
    assert not torch.equal(bits, tsearch.draw_bits(torch.tensor(12), step, rows, vocab))
    assert not torch.equal(bits, tsearch.draw_bits(seed, torch.tensor(4), rows, vocab))
    assert (bits[1:] != bits[:-1]).all()  # row r against row r + 1, at every vocabulary index
    assert (bits[:, 1:] != bits[:, :-1]).all()  # index v against v + 1, on every row
    shifted = tsearch.draw_bits(seed, step, rows + 1, vocab)
    assert torch.equal(shifted[:-1], bits[1:]) and not torch.equal(shifted, bits)
    # The generator's seed, folded to 32 bits; 0 without one (PRNGKey(0)).
    assert tsearch.seed_key(torch.Generator().manual_seed(5)) == 5 and tsearch.seed_key(None) == 0
    assert tsearch.seed_key(torch.Generator().manual_seed(2**40 + 3)) == (2**8) ^ 3
    g = tsearch.gumbel_noise(seed, step, torch.arange(64), torch.arange(4096))
    assert torch.isfinite(g).all() and g.dtype == torch.float32


def test_draw_follows_softmax_of_logits_over_temperature():
    """20,000 draws on an 8-token vocabulary (2,500 steps x 8 rows, one
    seed): the frequencies of argmax(logits / T + g) match softmax(logits /
    T) by a chi-square test (7 degrees of freedom, p = 0.001: 24.32), as
    the JAX package's jax.random.categorical, the same method, does."""
    import jax

    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 1.5, 0.25])
    temperature = 0.7
    p = torch.softmax(logits / temperature, dim=-1).double().numpy()
    rows, vocab, seed = torch.arange(8), torch.arange(8), torch.tensor(tsearch.seed_key(torch.Generator().manual_seed(3)))
    toks = torch.cat([
        torch.argmax(logits / temperature + tsearch.gumbel_noise(seed, torch.tensor(s), rows, vocab), dim=-1)
        for s in range(2500)
    ])
    jtoks = np.asarray(jax.random.categorical(jax.random.PRNGKey(3), jnp.asarray(logits.numpy()) / temperature, shape=(20000,)))
    for drawn in (toks.numpy(), jtoks):
        counts = np.bincount(drawn, minlength=8)
        chi2 = float((((counts - 20000 * p) ** 2) / (20000 * p)).sum())
        assert chi2 < 24.32, (counts, 20000 * p)


def test_no_suppressed_or_banned_token_is_drawn():
    """At a high temperature, over many rows and steps, the draw never
    picks a suppressed (NEG_INF) or banned token, nor the blank or EOT at
    the first step."""
    _, tstep = _step_fns(1, eot_bias=-3.0)
    rng = np.random.default_rng(0)
    init = torch.from_numpy((rng.standard_normal((64, V)) * 0.01).astype(np.float32))
    opts = dataclasses.replace(_opts(tsearch, beam_size=1, temperature=5.0), max_new_tokens=40)
    for seed in range(3):
        tokens, _, _ = tsearch.greedy_decode(
            tstep, init, [{"h": torch.zeros((64, DH))}], 4, opts, torch.Generator().manual_seed(seed)
        )
        assert not torch.isin(tokens, torch.tensor([5, 9])).any()
        assert not torch.isin(tokens[:, 0], torch.tensor([7, EOT])).any()
        assert len(torch.unique(tokens)) > 40  # the draw does reach most of the vocabulary


def test_greedy_loop_step_by_step_equals_greedy_decode():
    """A sampling GreedyLoop driven one body() at a time, its temperature
    and seed written by start(), gives greedy_decode's tokens and
    statistics from the same seed; another seed or temperature on the same
    loop gives other tokens."""
    _, tstep = _step_fns(2)
    init = torch.from_numpy(_tables(2)[2])
    opts = _opts(tsearch, beam_size=1, temperature=1.0)
    want = tsearch.greedy_decode(tstep, init, [{"h": torch.zeros((B, DH))}], 4, dataclasses.replace(opts, temperature=0.8),
                                 torch.Generator().manual_seed(9))
    loop = tsearch.GreedyLoop(tstep, [{"h": torch.zeros((B, DH))}], B, V, 4, opts)

    def run(temperature, seed):
        loop.cache[0]["h"].zero_()
        loop.start(init, temperature=temperature, generator=torch.Generator().manual_seed(seed))
        while bool(loop.cont):
            loop.body()
        return loop.result()

    got = run(0.8, 9)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not torch.equal(run(0.8, 10)[0], got[0]) and not torch.equal(run(1.6, 9)[0], got[0])


def test_synthetic_search_finishes_early_and_ties():
    """Guards the tests above: some hypotheses end before max_new, and the
    tied tokens are reachable."""
    _, tstep = _step_fns(0)
    init = _tables(0)[2]
    tokens, _, lengths = tsearch.beam_decode(
        tstep, torch.from_numpy(init), [{"h": torch.zeros((B * 3, DH))}], 4, _opts(tsearch, beam_size=3)
    )
    assert (lengths <= 10).any()
    logits, _ = tstep(torch.tensor([[10], [11]]), [{"h": torch.zeros((2, DH))}], 0)
    assert torch.equal(logits[0], logits[1])
    # Every tie between 10 and 11 went to the lower index, as lax.top_k does.
    assert (tokens == 10).any() and not (tokens == 11).any()


def test_length_penalized_matches_jax():
    s = np.array([-3.5, -10.25, tsearch.NEG_INF], np.float32)
    for length, alpha in ((1, 1.0), (7, 0.6), (112, 1.3)):
        want = np.asarray(jsearch.length_penalized(jnp.asarray(s), jnp.int32(length), alpha))
        got = tsearch.length_penalized(torch.from_numpy(s), length, alpha).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)


LONG = 30  # steps enough for every row to finish: the loops exit early


def _counting(jstep):
    """``jstep`` with a host callback a step: the list gets the position of
    every step that JAX's while_loop runs."""
    import jax

    seen = []

    def step(tokens, cache, pos):
        jax.debug.callback(lambda p: seen.append(int(p)), pos)
        return jstep(tokens, cache, pos)

    return step, seen


# (kind, seed, EOT bias, length penalty, exits before the horizon on the first batch)
STATIC_CASES = [
    *[(kind, seed, 1.5, 1.0, False) for kind in ("beam", "greedy") for seed in (0, 1, 2)],
    ("beam", 3, 3.0, 0.0, True),  # saturated: K finished, no alive beam can beat them
    ("greedy", 4, 4.0, 1.0, True),  # every row finished
]


@pytest.mark.parametrize("kind,seed,eot_bias,alpha,early", STATIC_CASES)
def test_static_loop_matches_jax_and_stops_at_its_step(kind, seed, eot_bias, alpha, early):
    """The loop as the device loop drives it: state allocated once, the
    prompt cache copied in by ``start`` (to each of the K beams), the
    in-place body repeated by ``run_host_loop``, then the same loop started
    again on a second batch. Tokens and log-probs equal JAX's, and the step
    counter stops where JAX's ``cond`` ended its while_loop (before the
    horizon in the early cases)."""
    jstep, tstep = _step_fns(seed, eot_bias)
    K = 3 if kind == "beam" else 1
    kw = dict(
        eot=EOT, suppress_tokens=(5,), blank_tokens=(7,), banned_tokens=(9,), max_new_tokens=LONG,
        beam_size=K, length_penalty=alpha,
    )
    jopts, topts = jsearch.SearchOptions(**kw), tsearch.SearchOptions(**kw)
    Loop = tsearch.BeamLoop if kind == "beam" else tsearch.GreedyLoop
    loop = Loop(tstep, [{"h": torch.full((B * K, DH), 7.0)}], B, V, 4, topts)
    prompt_cache = [{"h": torch.zeros((B, DH))}]
    for i, init in enumerate((_tables(seed, eot_bias)[2], _tables(seed + 10, eot_bias)[2])):
        counted, seen = _counting(jstep)
        jcache = [{"h": jnp.zeros((B * K, DH), jnp.float32)}]
        run = jsearch.beam_decode if kind == "beam" else jsearch.greedy_decode
        want = run(counted, jnp.asarray(init), jcache, 4, jopts)
        tsearch.run_host_loop(loop.start(torch.from_numpy(init), prompt_cache))
        got = loop.result()
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        assert int(loop.step) == len(seen) and seen == [4 + j for j in range(len(seen))]
        assert not bool(loop.cont)
        if early and i == 0:
            assert int(loop.step) < LONG


def test_continue_flag_is_the_cond_before_the_first_step():
    """As lax.while_loop tests cond before its first body: a horizon of zero
    steps runs none, and ``start`` leaves ``cont`` true otherwise."""
    _, tstep = _step_fns(0)
    init = torch.from_numpy(_tables(0)[2])
    for n, want in ((0, False), (1, True)):
        opts = tsearch.SearchOptions(eot=EOT, beam_size=2, max_new_tokens=n)
        loop = tsearch.BeamLoop(tstep, [{"h": torch.zeros((B * 2, DH))}], B, V, 4, opts).start(init)
        assert bool(loop.cont) is want
        tsearch.run_host_loop(loop)
        assert int(loop.step) == n
