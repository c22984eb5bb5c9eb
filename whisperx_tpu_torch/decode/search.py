"""Batched greedy and beam-search decoding.

Port of ``whisperx_tpu/decode/search.py`` on its default arms: the token
history is carried as (B, K, max_new) buffers reordered by gathers, and the
self cache is reordered with one ``index_select`` per layer buffer every step
(``_gather_cache`` "take", unconditional). The TPU A/B knobs
(``WHISPERX_REORDER``, ``WHISPERX_BEAM_HISTORY``, ``WHISPERX_REORDER_PREFIX``,
``WHISPERX_REORDER_COND``, ``WHISPERX_TOPK=approx``) are not ported.

The JAX loops are ``lax.while_loop``s whose condition exits early. Here the
loop runs on the host and reads that condition back once a step. Under
tensor parallelism every rank of the model group runs the loop, and each
step's collectives wait for all of them, so the ranks must leave it at the
same step: :func:`_all_done` takes that decision for the whole group.

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

NEG_INF = float(np.finfo(np.float32).min)


@dataclass(frozen=True)
class SearchOptions:
    """Decode configuration; the same fields as the JAX package's."""

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
    # Decode cross attention: "auto"/"xla" → the einsum path; "pallas" → the
    # fused kernel (ops/cross_attn.py). WHISPERX_CROSS_ATTN overrides.
    cross_attn: str = "auto"
    # Candidate top-k: "auto" and "exact" are the exact top-k ("approx" is a
    # TPU-only knob and is not ported).
    topk: str = "auto"


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


def _all_done(done: torch.Tensor, group) -> bool:
    """``bool(done.all())``, one decision for every rank of the
    tensor-parallel ``group``. The ranks hold the same logits (each is the
    same fp32 sum after the all-reduces and gathers), but the exit does not
    rest on bit equality: the flag is all-reduced (MIN) over the group, so
    no rank leaves the loop while another starts a step whose collectives
    would wait for it forever."""
    flag = done.all()
    if group is not None:
        flag = flag.to(torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
    return bool(flag)


def _check_topk(opts: SearchOptions) -> None:
    if opts.topk not in ("auto", "exact"):
        raise ValueError(f"unknown top-k impl {opts.topk!r}: the port has auto|exact")


def greedy_decode(
    step_fn: Callable,
    init_logits: torch.Tensor,  # (B, V) logits after the prompt
    init_cache,
    prompt_len: int,
    opts: SearchOptions,
    generator: Optional[torch.Generator] = None,
    group=None,
):
    """Batched greedy/sampling decode.

    step_fn(tokens (B, 1), self_cache, pos) -> (logits (B, 1, V), self_cache);
    the cross K/V are closed over by ``step_fn``. Returns (tokens
    (B, max_new), sum_logprobs (B,), lengths (B,)); token buffers are padded
    with EOT after finish. Sampling (temperature > 0) draws from
    ``generator``. ``group``: the tensor-parallel group whose ranks run
    this loop together (:func:`_all_done`).
    """
    B, V = init_logits.shape
    dev = init_logits.device
    max_new = opts.max_new_tokens
    suppress = torch.as_tensor(_static_suppress_mask(V, opts), device=dev)
    first_mask = torch.as_tensor(_first_step_mask(V, opts), device=dev)
    sample = opts.temperature > 0

    logits, cache = init_logits, init_cache
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    tokens = torch.full((B, max_new), opts.eot, dtype=torch.long, device=dev)
    sum_lp = torch.zeros((B,), dtype=torch.float32, device=dev)
    for step in range(max_new):
        if _all_done(finished, group):
            break
        logits = logits + suppress
        if step == 0:
            logits = logits + first_mask
        logprobs = torch.log_softmax(logits, dim=-1)
        if sample:
            probs = torch.softmax(logits / opts.temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            tok = torch.argmax(logits, dim=-1)
        lp = torch.gather(logprobs, 1, tok[:, None])[:, 0]
        tok = torch.where(finished, opts.eot, tok)
        sum_lp = sum_lp + torch.where(finished, 0.0, lp)
        tokens[:, step] = tok
        finished = finished | (tok == opts.eot)
        new_logits, cache = step_fn(tok[:, None], cache, prompt_len + step)
        logits = new_logits[:, -1]
    lengths = (tokens != opts.eot).sum(dim=1) + 1  # +1 for the EOT itself
    return tokens, sum_lp, lengths


def _gather_cache(self_cache: list, flat_idx: torch.Tensor) -> list:
    """Reorder the per-layer (B*K, T, H, ·) self cache by beam indices: one
    axis-0 ``index_select`` per buffer (new buffers, so the in-place cache
    writes of the next step never touch a buffer two beams share)."""
    return [{name: buf.index_select(0, flat_idx) for name, buf in layer.items()} for layer in self_cache]


def beam_decode(
    step_fn: Callable,
    init_logits: torch.Tensor,  # (B, V) logits after the prompt (pre-expansion)
    expanded_cache,  # SELF cache with leading dim B*K (prompt replicated per beam)
    prompt_len: int,
    opts: SearchOptions,
    group=None,
):
    """Fixed-shape batched beam search.

    Returns (tokens (B, max_new), sum_logprobs (B,), lengths (B,)) for the
    best hypothesis per batch element (finished preferred, ranked by the GNMT
    length-penalized cumulative logprob). ``group``: as for
    :func:`greedy_decode`.
    """
    _check_topk(opts)
    B, V = init_logits.shape
    dev = init_logits.device
    K = opts.beam_size
    max_new = opts.max_new_tokens
    eot = opts.eot
    alpha = opts.length_penalty
    target_finished = max(K, int(round(K * opts.patience)))
    suppress = torch.as_tensor(_static_suppress_mask(V, opts), device=dev)
    first_mask = torch.as_tensor(_first_step_mask(V, opts), device=dev)

    # Beam 0 starts live, the others at NEG_INF, so the first expansion draws
    # K distinct tokens from the single prompt distribution.
    alive_scores = torch.tensor([0.0] + [NEG_INF] * (K - 1), device=dev).repeat(B, 1)
    logprobs = torch.log_softmax(init_logits + suppress + first_mask, dim=-1)
    logprobs = logprobs[:, None, :].expand(B, K, V)
    cache = expanded_cache
    alive_toks = torch.full((B, K, max_new), eot, dtype=torch.long, device=dev)
    fin_toks = torch.full((B, K, max_new), eot, dtype=torch.long, device=dev)
    fin_scores = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
    fin_count = torch.zeros((B,), dtype=torch.long, device=dev)
    batch_base = torch.arange(B, device=dev)[:, None] * K

    step = 0
    while step < max_new:
        # Early exit: enough finished and no alive beam can beat the worst
        # kept finished hypothesis even with a perfect (0 logprob) future.
        best_alive = length_penalized(alive_scores.amax(dim=1), step + max_new, alpha)
        worst_fin = fin_scores.amin(dim=1)
        saturated = (fin_count >= target_finished) & (best_alive <= worst_fin)
        if _all_done(saturated, group):
            break

        cand = alive_scores[:, :, None] + logprobs  # (B, K, V)
        top_scores, top_idx = _candidate_top_k(cand.reshape(B, K * V), 2 * K)
        beam_idx = top_idx // V
        tok_idx = top_idx % V
        is_eot = tok_idx == eot

        # Finished merge: candidates ending in EOT → top-K finished buffer.
        eot_pen = torch.where(is_eot, length_penalized(top_scores, step + 1, alpha), NEG_INF)
        fin_count = fin_count + is_eot.sum(dim=1)

        # Alive selection: best K non-EOT of the 2K candidates.
        new_scores, pick = _sorted_top_k(torch.where(is_eot, NEG_INF, top_scores), K)
        new_beam = torch.gather(beam_idx, 1, pick)
        new_tok = torch.gather(tok_idx, 1, pick)

        # Token history of each EOT candidate = alive_toks[beam] + EOT pad.
        cand_toks = torch.gather(alive_toks, 1, beam_idx[:, :, None].expand(B, 2 * K, max_new))
        cand_toks[:, :, step] = eot
        keep_scores, keep_idx = _sorted_top_k(torch.cat([fin_scores, eot_pen], dim=1), K)
        all_fin_toks = torch.cat([fin_toks, cand_toks], dim=1)
        fin_toks = torch.gather(all_fin_toks, 1, keep_idx[:, :, None].expand(B, K, max_new))
        fin_scores = keep_scores

        alive_toks = torch.gather(alive_toks, 1, new_beam[:, :, None].expand(B, K, max_new))
        alive_toks[:, :, step] = new_tok

        cache = _gather_cache(cache, (batch_base + new_beam).reshape(-1))
        logits, cache = step_fn(new_tok.reshape(B * K, 1), cache, prompt_len + step)
        logprobs = torch.log_softmax(logits[:, -1] + suppress, dim=-1).reshape(B, K, V)
        alive_scores = new_scores
        step += 1

    # Prefer the best finished hypothesis; fall back to the best alive one
    # (ran out of steps without EOT).
    have_finished = fin_count > 0
    best_alive_idx = torch.argmax(length_penalized(alive_scores, step, alpha), dim=1)
    best_alive_score = torch.gather(alive_scores, 1, best_alive_idx[:, None])[:, 0]
    best_alive_toks = torch.gather(
        alive_toks, 1, best_alive_idx[:, None, None].expand(B, 1, max_new)
    )[:, 0]
    tokens = torch.where(have_finished[:, None], fin_toks[:, 0], best_alive_toks)
    # Recover the raw (unpenalized) cumulative logprob for finished rows.
    lengths = (tokens != eot).sum(dim=1) + 1
    raw_fin = fin_scores[:, 0] * (((5.0 + lengths.float()) / 6.0) ** alpha)
    sum_lp = torch.where(have_finished, raw_fin, best_alive_score)
    return tokens, sum_lp, lengths
