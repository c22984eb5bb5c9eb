"""whisperx_tpu_torch greedy and beam search against the JAX package's, on a
synthetic step function with a small vocabulary: hypotheses finish at
different lengths, two tokens always tie exactly (tie order decides which
candidates are kept), patience and length penalty are away from 1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperx_tpu.decode import search as jsearch
from whisperx_tpu_torch.decode import search as tsearch

torch.set_num_threads(2)

V, DH, EOT, B = 64, 16, 3, 3


def _tables(seed):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((V, DH)).astype(np.float32)
    proj = (rng.standard_normal((DH, V)) * 0.8).astype(np.float32)
    proj[:, 10] += 1.0  # make token 10 likely...
    emb[11], proj[:, 11] = emb[10], proj[:, 10]  # ...and token 11 its exact tie
    proj[:, EOT] += 1.5  # make hypotheses finish early, at various steps
    init = (rng.standard_normal((B, V)) * 2).astype(np.float32)
    return emb, proj, init


def _step_fns(seed):
    emb, proj, _ = _tables(seed)

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
