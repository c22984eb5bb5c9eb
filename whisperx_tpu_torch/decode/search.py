"""Batched greedy and beam-search decoding.

Port of ``whisperx_tpu/decode/search.py`` on its default arms: the token
history is carried as (B, K, max_new) buffers reordered by gathers, and the
self cache is reordered with one ``index_select`` per layer buffer every step
(``_gather_cache`` "take", unconditional). The TPU A/B knobs
(``WHISPERX_REORDER``, ``WHISPERX_BEAM_HISTORY``, ``WHISPERX_REORDER_PREFIX``,
``WHISPERX_REORDER_COND``, ``WHISPERX_TOPK=approx``) are not ported.

The JAX loops are ``lax.while_loop``s whose condition is evaluated on the
device. Here each loop is a :class:`GreedyLoop` or :class:`BeamLoop`: its
state lives in tensors allocated once, and :meth:`body` runs one step in
place (``copy_``, ``index_copy_``, ``scatter_``; the position and the step
counter are 0-d device tensors), ending with the JAX ``cond`` written as
tensor code into the 0-d bool ``cont``. Two loops repeat that body:

- :func:`run_host_loop` reads ``cont`` on the host before each step (the
  CPU, and a model split over a tensor-parallel group);
- ``ops/graph_loop.py`` captures the body once into a CUDA graph and runs it
  as the body of a conditional WHILE node, which tests ``cont`` on the card
  (``decode/engine.py`` says which one runs).

Under tensor parallelism every rank of the model group runs the loop, and
each step's collectives wait for all of them, so the ranks must leave it at
the same step: :func:`run_host_loop` takes that decision for the whole group.

Sampling (temperature > 0) is a Gumbel-max draw, the method of the JAX
package's ``jax.random.categorical`` (not its bits): ``argmax(logits / T +
g)``, ``g = -log(-log(u))``, where ``u`` is a pure function of (seed, step,
row, vocabulary index) computed by tensor code (:func:`draw_bits`). The
step is the loop's 0-d device counter and the seed and temperature are 0-d
tensors of the loop's state, so a replayed graph draws new numbers every
iteration with no input from the host, and the host loop draws the same.

Tie order: ``lax.top_k`` puts the lower index first among equal values and
``torch.topk`` promises no order, so every selection whose kept set or order
can depend on ties (the finished-buffer merge ranks many ``NEG_INF`` slots)
goes through a stable descending sort.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils import telemetry

NEG_INF = float(np.finfo(np.float32).min)


@dataclass(frozen=True)
class SearchOptions:
    """Decode configuration: the JAX package's fields without its route
    knobs (``cross_attn``, ``topk``); the routes here follow from the model
    and these options."""

    beam_size: int = 5
    patience: float = 1.0
    length_penalty: float = 1.0
    max_new_tokens: int = 224
    temperature: float = 0.0
    suppress_tokens: tuple[int, ...] = ()
    suppress_blank: bool = True
    blank_tokens: tuple[int, ...] = ()  # token ids of " " (suppressed at step 0)
    eot: int = 50257
    # Tokens that may never be produced (timestamps in no-timestamp mode etc.)
    banned_tokens: tuple[int, ...] = ()
    # "model" keeps KV in the model compute dtype; "int8" and "int4" quantize
    # the self cache and cross K/V per (token, head) (int4 packed along Dh).
    kv_cache_dtype: str = "model"


# The draw's 32-bit lanes are held in int64: every multiplier is below 2**31
# and each product is masked back to 32 bits, so no intermediate overflows
# and the CPU and the card compute the same bits.
_LANE = 0xFFFFFFFF
_MIX = 0x45D9F3B  # odd: multiplying by it is a bijection of the lane


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijection of 32-bit lanes: two rounds of xor-shift and multiply."""
    x = ((x ^ (x >> 16)) * _MIX) & _LANE
    x = ((x ^ (x >> 16)) * _MIX) & _LANE
    return x ^ (x >> 16)


def draw_bits(seed: torch.Tensor, step: torch.Tensor, rows: torch.Tensor, vocab: torch.Tensor) -> torch.Tensor:
    """(B, V) 32-bit lanes (int64), a pure function of the 0-d ``seed`` (a
    32-bit key, :func:`seed_key`) and ``step``, the (B,) row indices and the
    (V,) vocabulary indices. Each stage mixes one more input into the
    lane, so for fixed others a change of any one input changes the lane."""
    h = _mix32(_mix32(seed & _LANE) ^ (step & _LANE))
    h = _mix32(h ^ rows)
    return _mix32(h[:, None] ^ _mix32(vocab))


def gumbel_noise(seed: torch.Tensor, step: torch.Tensor, rows: torch.Tensor, vocab: torch.Tensor) -> torch.Tensor:
    """(B, V) float32 Gumbel noise ``-log(-log(u))``, ``u = (k + 0.5) /
    2**24`` from the top 24 bits k of :func:`draw_bits` (never 0 or 1; in
    float64, where k + 0.5 is exact)."""
    u = ((draw_bits(seed, step, rows, vocab) >> 8).double() + 0.5) * 2.0**-24
    return (-torch.log(-torch.log(u))).float()


def seed_key(generator: Optional[torch.Generator]) -> int:
    """A sampled loop's seed: the generator's initial seed folded to 32 bits,
    read on the host before the loop starts; 0 without a generator (the JAX
    package's ``PRNGKey(0)``). The draw does not advance the generator: the
    same seed gives the same tokens."""
    seed = generator.initial_seed() if generator is not None else 0
    return (seed ^ (seed >> 32)) & _LANE


def _static_suppress_mask(n_vocab: int, opts: SearchOptions) -> np.ndarray:
    mask = np.zeros((n_vocab,), np.float32)
    for t in opts.suppress_tokens:
        if 0 <= t < n_vocab:
            mask[t] = NEG_INF
    for t in opts.banned_tokens:
        if 0 <= t < n_vocab:
            mask[t] = NEG_INF
    return mask


def _first_step_mask(n_vocab: int, opts: SearchOptions) -> np.ndarray:
    mask = np.zeros((n_vocab,), np.float32)
    if opts.suppress_blank:
        for t in (*opts.blank_tokens, opts.eot):
            if 0 <= t < n_vocab:
                mask[t] = NEG_INF
    return mask


def length_penalized(score: torch.Tensor, length, alpha: float) -> torch.Tensor:
    """GNMT length normalization: score / ((5+L)/6)^alpha (CT2 convention),
    with the factor computed in fp32 as the JAX code does."""
    length = torch.as_tensor(length, dtype=torch.float32, device=score.device)
    return score / (((5.0 + length) / 6.0) ** alpha)


def _sorted_top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: descending, lower index first among
    equal values (stable sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _candidate_top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over a wide last axis: ``torch.topk`` picks the set, then
    a stable sort on (value desc, index asc) fixes the order among ties."""
    _, idx = torch.topk(x, k, dim=-1)
    idx, _ = torch.sort(idx, dim=-1)
    vals, order = torch.sort(torch.gather(x, -1, idx), dim=-1, descending=True, stable=True)
    return vals, torch.gather(idx, -1, order)


class LoopResult(tuple):
    """A loop's (tokens (B, max_new), sum_logprobs (B,), lengths (B,)), with
    ``steps``, the steps it ran (a 0-d float32 tensor on the loop's device,
    read back with the rest), and ``span``, the ``decode.loop`` telemetry
    span that timed it (None where none did)."""

    def __new__(cls, tokens, sum_lp, lengths, steps, span=None):
        out = super().__new__(cls, (tokens, sum_lp, lengths))
        out.steps, out.span = steps, span
        return out


def run_host_loop(loop, group=None) -> telemetry.Span:
    """Drive ``loop`` (a :class:`GreedyLoop` or :class:`BeamLoop` after
    ``start``) on the host: read its ``cont`` flag, run a step, until the
    flag is false. Under a tensor-parallel ``group`` the flag is all-reduced
    (MAX), so that every rank runs a step while any rank would: the ranks
    hold the same logits (each is the same fp32 sum after the all-reduces
    and gathers), but the exit does not rest on bit equality, and no rank
    leaves the loop while another starts a step whose collectives would
    wait for it forever. Returns the ``decode.loop`` span that timed it,
    counting the ``steps`` run."""
    with telemetry.span("decode.loop", device=loop.device) as span:
        steps = 0
        while True:
            flag = loop.cont
            if group is not None:
                flag = flag.to(torch.int32)
                dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
            if not bool(flag):
                break
            loop.body()
            steps += 1
        span.counts["steps"] = steps
    return span


def _land(cache: list, new: list) -> None:
    """Make ``new`` (a step function's returned self cache) the contents of
    ``cache``: the model's step writes in place and returns the same
    buffers; a step that returns new ones has them copied back, so that the
    loop's buffers keep their addresses."""
    for layer, new_layer in zip(cache, new):
        for name, buf in layer.items():
            if new_layer[name] is not buf:
                buf.copy_(new_layer[name])


def _broadcast_rows(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy (B, ...) rows into (B*K, ...) ``dst``, each row K times in a row
    (``repeat_interleave(K, dim=0)`` without the intermediate)."""
    B = src.shape[0]
    dst.view(B, dst.shape[0] // B, *dst.shape[1:]).copy_(src[:, None])


class _Loop:
    """What both loops share: the step function, the self cache (per-layer
    dicts of (B*K, ...) buffers, updated in place), the masks, the step
    counter and the continue flag."""

    def __init__(self, step_fn: Callable, cache: list, vocab: int, prompt_len: int, opts: SearchOptions):
        self.step_fn = step_fn
        self.cache = cache
        self.opts = opts
        self.prompt_len = prompt_len
        self.max_new = opts.max_new_tokens
        dev = self.device = next(iter(cache[0].values())).device
        self.suppress = torch.as_tensor(_static_suppress_mask(vocab, opts), device=dev)
        self.first_mask = torch.as_tensor(_first_step_mask(vocab, opts), device=dev)
        self.step = torch.zeros((), dtype=torch.long, device=dev)
        self.cont = torch.zeros((), dtype=torch.bool, device=dev)

    def _load_cache(self, prompt_cache: Optional[list]) -> None:
        if prompt_cache is not None:
            for layer, src in zip(self.cache, prompt_cache):
                for name, buf in layer.items():
                    _broadcast_rows(buf, src[name])

    def _advance(self, tokens: torch.Tensor) -> torch.Tensor:
        """One decoder step on ``tokens`` (rows, 1) at the device position,
        its cache landed in the loop's buffers; returns (rows, V) logits."""
        logits, cache = self.step_fn(tokens, self.cache, self.prompt_len + self.step)
        _land(self.cache, cache)
        return logits[:, -1]


class GreedyLoop(_Loop):
    """The greedy/sampling decode as static state and an in-place body.

    ``step_fn(tokens (B, 1), self_cache, pos) -> (logits (B, 1, V),
    self_cache)``, ``pos`` a 0-d int64 tensor; the cross K/V are closed over
    by ``step_fn``. ``cache``: the (B, ...) self-cache buffers the loop
    owns. The loop samples when ``opts.temperature > 0``: its temperature
    and seed (``seed_key(generator)``) are 0-d tensors that :meth:`start`
    writes, so one loop serves every temperature and seed.
    """

    def __init__(self, step_fn, cache, batch: int, vocab: int, prompt_len: int, opts: SearchOptions, generator=None):
        super().__init__(step_fn, cache, vocab, prompt_len, opts)
        dev, B = self.device, batch
        self.generator = generator
        self.sample = opts.temperature > 0
        self.temperature = torch.ones((), dtype=torch.float32, device=dev)
        self.seed = torch.zeros((), dtype=torch.long, device=dev)
        self.rows = torch.arange(B, device=dev)
        self.vocab = torch.arange(vocab, device=dev)
        self.logits = torch.zeros((B, vocab), dtype=torch.float32, device=dev)
        self.finished = torch.zeros((B,), dtype=torch.bool, device=dev)
        self.tokens = torch.zeros((B, self.max_new), dtype=torch.long, device=dev)
        self.sum_lp = torch.zeros((B,), dtype=torch.float32, device=dev)

    def start(
        self, init_logits: torch.Tensor, prompt_cache: Optional[list] = None, *, temperature=None, generator=None
    ) -> "GreedyLoop":
        """The initial state: ``init_logits`` (B, V) after the prompt and,
        where given, the prompt-filled (B, ...) cache copied in; a sampling
        loop's temperature (``opts.temperature`` by default) and seed (from
        ``generator``, else the loop's own)."""
        self._load_cache(prompt_cache)
        if self.sample:
            self.temperature.fill_(self.opts.temperature if temperature is None else temperature)
            self.seed.fill_(seed_key(generator if generator is not None else self.generator))
        self.logits.copy_(init_logits)
        self.finished.fill_(False)
        self.tokens.fill_(self.opts.eot)
        self.sum_lp.zero_()
        self.step.zero_()
        self.cont.copy_(self.cond())
        return self

    def cond(self) -> torch.Tensor:
        """The JAX ``cond``: ``step < max_new`` and some row unfinished."""
        return (self.step < self.max_new) & ~self.finished.all()

    def body(self) -> None:
        o = self.opts
        logits = self.logits + self.suppress
        logits = torch.where(self.step == 0, logits + self.first_mask, logits)
        logprobs = torch.log_softmax(logits, dim=-1)
        if self.sample:
            noise = gumbel_noise(self.seed, self.step, self.rows, self.vocab)
            tok = torch.argmax(logits / self.temperature + noise, dim=-1)
        else:
            tok = torch.argmax(logits, dim=-1)
        lp = torch.gather(logprobs, 1, tok[:, None])[:, 0]
        tok = torch.where(self.finished, o.eot, tok)
        self.sum_lp.add_(torch.where(self.finished, 0.0, lp))
        self.tokens.scatter_(1, self.step.expand(tok.shape[0], 1), tok[:, None])
        self.finished.logical_or_(tok == o.eot)
        self.logits.copy_(self._advance(tok[:, None]))
        self.step.add_(1)
        self.cont.copy_(self.cond())

    def result(self, span=None) -> LoopResult:
        """(tokens (B, max_new), sum_logprobs (B,), lengths (B,)) in new
        tensors; token rows are padded with EOT after finish. ``span``: the
        span that timed the loop."""
        tokens = self.tokens.clone()
        lengths = (tokens != self.opts.eot).sum(dim=1) + 1  # +1 for the EOT itself
        return LoopResult(tokens, self.sum_lp.clone(), lengths, self.step.float(), span)


def greedy_decode(
    step_fn: Callable,
    init_logits: torch.Tensor,  # (B, V) logits after the prompt
    init_cache,
    prompt_len: int,
    opts: SearchOptions,
    generator: Optional[torch.Generator] = None,
    group=None,
):
    """Batched greedy/sampling decode on the host loop.

    step_fn(tokens (B, 1), self_cache, pos) -> (logits (B, 1, V), self_cache);
    the cross K/V are closed over by ``step_fn``; ``init_cache`` is updated
    in place. Returns (tokens (B, max_new), sum_logprobs (B,), lengths (B,));
    token buffers are padded with EOT after finish. Sampling (temperature >
    0) draws from ``generator``'s seed (:func:`seed_key`). ``group``: the
    tensor-parallel group whose ranks run this loop together
    (:func:`run_host_loop`).
    """
    B, V = init_logits.shape
    loop = GreedyLoop(step_fn, init_cache, B, V, prompt_len, opts, generator).start(init_logits)
    return loop.result(run_host_loop(loop, group))


def reorder_cache_(self_cache: list, flat_idx: torch.Tensor, scratch: dict) -> None:
    """Reorder the per-layer (B*K, T, H, ·) self cache by beam indices, in
    place: one axis-0 ``index_select`` per buffer into the scratch buffer of
    its shape and type (``scratch``, keyed by both), then a copy back, so
    that the buffers keep their addresses and the next step's in-place cache
    writes never touch a row two beams share."""
    for layer in self_cache:
        for buf in layer.values():
            tmp = scratch[(tuple(buf.shape), buf.dtype)]
            torch.index_select(buf, 0, flat_idx, out=tmp)
            buf.copy_(tmp)


class BeamLoop(_Loop):
    """Fixed-shape batched beam search as static state and an in-place body.

    ``cache``: the (B*K, ...) self-cache buffers the loop owns; ``step_fn``
    as for :class:`GreedyLoop`, on B*K rows.
    """

    def __init__(self, step_fn, cache, batch: int, vocab: int, prompt_len: int, opts: SearchOptions):
        super().__init__(step_fn, cache, vocab, prompt_len, opts)
        dev, B, K, L = self.device, batch, opts.beam_size, self.max_new
        self.shape = (B, K, vocab)
        self.target_finished = max(K, int(round(K * opts.patience)))
        self.batch_base = torch.arange(B, device=dev)[:, None] * K
        self.logprobs = torch.zeros((B, K, vocab), dtype=torch.float32, device=dev)
        self.alive_scores = torch.zeros((B, K), dtype=torch.float32, device=dev)
        self.alive_toks = torch.zeros((B, K, L), dtype=torch.long, device=dev)
        self.fin_toks = torch.zeros((B, K, L), dtype=torch.long, device=dev)
        self.fin_scores = torch.zeros((B, K), dtype=torch.float32, device=dev)
        self.fin_count = torch.zeros((B,), dtype=torch.long, device=dev)
        self.scratch = {
            (tuple(b.shape), b.dtype): torch.empty_like(b) for layer in cache for b in layer.values()
        }

    def start(self, init_logits: torch.Tensor, prompt_cache: Optional[list] = None) -> "BeamLoop":
        """The initial state: ``init_logits`` (B, V) after the prompt and,
        where given, the prompt-filled (B, ...) cache, each row copied to
        its K beams. Beam 0 starts live, the others at NEG_INF, so the first
        expansion draws K distinct tokens from the single prompt
        distribution."""
        B, K, V = self.shape
        self._load_cache(prompt_cache)
        logprobs = torch.log_softmax(init_logits + self.suppress + self.first_mask, dim=-1)
        self.logprobs.copy_(logprobs[:, None, :].expand(B, K, V))
        self.alive_scores.fill_(NEG_INF)
        self.alive_scores[:, 0].fill_(0.0)
        self.alive_toks.fill_(self.opts.eot)
        self.fin_toks.fill_(self.opts.eot)
        self.fin_scores.fill_(NEG_INF)
        self.fin_count.zero_()
        self.step.zero_()
        self.cont.copy_(self.cond())
        return self

    def cond(self) -> torch.Tensor:
        """The JAX ``cond``: ``step < max_new`` and not every row saturated,
        where saturated means enough finished and no alive beam can beat the
        worst kept finished hypothesis even with a perfect (0 logprob)
        future."""
        alpha = self.opts.length_penalty
        best_alive = length_penalized(self.alive_scores.amax(dim=1), self.step + self.max_new, alpha)
        worst_fin = self.fin_scores.amin(dim=1)
        saturated = (self.fin_count >= self.target_finished) & (best_alive <= worst_fin)
        return (self.step < self.max_new) & ~saturated.all()

    def body(self) -> None:
        B, K, V = self.shape
        L, eot, alpha = self.max_new, self.opts.eot, self.opts.length_penalty
        cand = self.alive_scores[:, :, None] + self.logprobs  # (B, K, V)
        top_scores, top_idx = _candidate_top_k(cand.reshape(B, K * V), 2 * K)
        beam_idx = top_idx // V
        tok_idx = top_idx % V
        is_eot = tok_idx == eot

        # Finished merge: candidates ending in EOT → top-K finished buffer.
        eot_pen = torch.where(is_eot, length_penalized(top_scores, self.step + 1, alpha), NEG_INF)
        self.fin_count.add_(is_eot.sum(dim=1))

        # Alive selection: best K non-EOT of the 2K candidates.
        new_scores, pick = _sorted_top_k(torch.where(is_eot, NEG_INF, top_scores), K)
        new_beam = torch.gather(beam_idx, 1, pick)
        new_tok = torch.gather(tok_idx, 1, pick)

        # Token history of each EOT candidate = alive_toks[beam] + EOT pad.
        cand_toks = torch.gather(self.alive_toks, 1, beam_idx[:, :, None].expand(B, 2 * K, L))
        cand_toks.scatter_(2, self.step.expand(B, 2 * K, 1), eot)
        keep_scores, keep_idx = _sorted_top_k(torch.cat([self.fin_scores, eot_pen], dim=1), K)
        all_fin_toks = torch.cat([self.fin_toks, cand_toks], dim=1)
        self.fin_toks.copy_(torch.gather(all_fin_toks, 1, keep_idx[:, :, None].expand(B, K, L)))
        self.fin_scores.copy_(keep_scores)

        alive_toks = torch.gather(self.alive_toks, 1, new_beam[:, :, None].expand(B, K, L))
        alive_toks.scatter_(2, self.step.expand(B, K, 1), new_tok[:, :, None])
        self.alive_toks.copy_(alive_toks)

        reorder_cache_(self.cache, (self.batch_base + new_beam).reshape(-1), self.scratch)
        logits = self._advance(new_tok.reshape(B * K, 1))
        self.logprobs.copy_(torch.log_softmax(logits + self.suppress, dim=-1).reshape(B, K, V))
        self.alive_scores.copy_(new_scores)
        self.step.add_(1)
        self.cont.copy_(self.cond())

    def result(self, span=None) -> LoopResult:
        """(tokens (B, max_new), sum_logprobs (B,), lengths (B,)) of the best
        hypothesis per row, in new tensors: the best finished one (ranked by
        the GNMT length-penalized cumulative logprob), else the best alive
        one (ran out of steps without EOT). ``span``: the span that timed
        the loop."""
        B, K, V = self.shape
        eot, alpha = self.opts.eot, self.opts.length_penalty
        have_finished = self.fin_count > 0
        best_alive_idx = torch.argmax(length_penalized(self.alive_scores, self.step, alpha), dim=1)
        best_alive_score = torch.gather(self.alive_scores, 1, best_alive_idx[:, None])[:, 0]
        best_alive_toks = torch.gather(self.alive_toks, 1, best_alive_idx[:, None, None].expand(B, 1, self.max_new))[:, 0]
        tokens = torch.where(have_finished[:, None], self.fin_toks[:, 0], best_alive_toks)
        # Recover the raw (unpenalized) cumulative logprob for finished rows.
        lengths = (tokens != eot).sum(dim=1) + 1
        raw_fin = self.fin_scores[:, 0] * (((5.0 + lengths.float()) / 6.0) ** alpha)
        sum_lp = torch.where(have_finished, raw_fin, best_alive_score)
        return LoopResult(tokens, sum_lp, lengths, self.step.float(), span)


def beam_decode(
    step_fn: Callable,
    init_logits: torch.Tensor,  # (B, V) logits after the prompt (pre-expansion)
    expanded_cache,  # SELF cache with leading dim B*K (prompt replicated per beam)
    prompt_len: int,
    opts: SearchOptions,
    group=None,
):
    """Fixed-shape batched beam search on the host loop.

    Returns (tokens (B, max_new), sum_logprobs (B,), lengths (B,)) for the
    best hypothesis per batch element (:meth:`BeamLoop.result`);
    ``expanded_cache`` is updated in place. ``group``: as for
    :func:`greedy_decode`.
    """
    B, V = init_logits.shape
    loop = BeamLoop(step_fn, expanded_cache, B, V, prompt_len, opts).start(init_logits)
    return loop.result(run_host_loop(loop, group))
