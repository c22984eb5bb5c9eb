"""CTC forced alignment: batched max-plus trellis and backtrack on the device.

Port of ``whisperx_tpu/ops/ctc.py`` (reference recurrence:
whisperx/alignment.py:359-421): trellis (T+1, N+1) with
``new[j] = max(prev[j] + blank_t, prev[j-1] + token_t[j])``, a cumsum-of-blank
first column whose last N rows are +inf (forcing full token consumption), and
a greedy stay/change backtrack from the argmax of the final column.

The JAX package runs the time recurrence and the walk as one compiled
program (a ``lax.scan`` trellis and a vmapped ``lax.scan`` walk). On a CUDA
tensor :func:`ctc_align_batch_device` and :func:`ctc_trellis_batch` launch
the hand-written Hopper kernel ``csrc/ctc_align.cu`` once a call (or
raise): one warp a segment holding the trellis row in registers, the
CTA's other warps filling a shared-memory ring of emission rows a chunk
ahead, the walk's decisions as packed bits. On a CPU tensor they run the
plain versions, :func:`ctc_trellis_batch_plain` (a Python loop over T of
three in-place tensor ops on a preallocated (B, T+1, N+1) buffer,
vectorised over the batch) and :func:`ctc_align_batch_device_plain` (that
trellis, then :func:`ctc_backtrack_device`, which precomputes every
stay/change decision and walks T small steps with no host sync). Column 0
of the trellis is the same torch code on both routes (:func:`_first_column`),
so the kernel's trellis equals the plain version's bit for bit on one
device (as numbers where the inputs hold -0.0, which the kernel reads as
+0.0). The JAX
package has no Pallas trellis (``ctc.py:203-209``).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from . import _build

INF = float("inf")


# Kernel launches since the last reset (chip_smoke.py zeroes and reads it):
# one a call of ctc_align_batch_device or ctc_trellis_batch on a CUDA tensor.
launches = 0

SMEM_LIMIT = 232_448  # shared memory one CTA can use on Hopper (227 KB)
MAX_CHUNK_ROWS = 32  # emission rows a stage of the kernel's ring holds at most
STAGE_BYTES = 32_768  # ... and the bytes a stage takes where the vocabulary lets it
SLOT_LADDER = (8, 16, 32, 64)  # trellis columns a lane holds in registers (the kernel's K)
EPILOGUE_WARPS = 8  # warps a CTA has at least (they fill the emission ring, then all write the outputs)
MAX_WARPS = 11  # computing warps at 64 slots a lane (the registers of 384 threads, one warp to fill the ring)
MAILBOX = 64  # rows a warp's mailbox holds (64-slot plans with several warps)


@dataclass(frozen=True)
class LaunchPlan:
    """How ``csrc/ctc_align.cu`` runs one call: one CTA a segment of
    ``threads`` threads, of which ``warps`` warps hold the trellis row in
    registers, ``slots`` columns a lane (32 x slots x warps >= N; several
    warps only at 64 slots), while the others fill a ring of ``stages``
    stages of ``rows`` emission rows; ``smem_bytes`` of dynamic shared
    memory, and whether the decision bits fit there (``bits_in_smem``; else
    a (B, bit_rows(T), words) scratch buffer holds them)."""

    slots: int
    warps: int
    threads: int
    rows: int
    stages: int
    smem_bytes: int
    bits_in_smem: bool
    words: int  # 32-bit words of decision bits a trellis row: slots x warps


def row_pitch(rows: int, slots: int) -> int:
    """A ring column's pitch in floats (``csrc/ctc_align.cu:row_pitch``)."""
    if slots == SLOT_LADDER[-1]:
        return rows | 1
    return rows + 4 + (4 if (rows // 4) % 2 else 0)


def bit_rows(T: int) -> int:
    """Rows of decision bits the kernel writes: T, to a whole 4-row load."""
    return -(-T // 4) * 4


def _ring_rows(V: int, slots: int):
    """Rows a ring stage holds: the most (up to 32, a multiple of the 4 rows a
    load reads below 64 slots) whose stage fits in 32 KB, else in half of a
    CTA's shared memory, else in all of it; None when not even one load's
    rows fit."""
    step = 4 if slots < SLOT_LADDER[-1] else 1
    for budget in (STAGE_BYTES, SMEM_LIMIT // 2, SMEM_LIMIT):
        for rows in range(MAX_CHUNK_ROWS, step - 1, -step):
            if 4 * (V + 3) * row_pitch(rows, slots) <= budget:
                return rows
    return None


def launch_plan(T: int, N: int, V: int, align: bool = True) -> LaunchPlan:
    """The kernel's launch plan for (B, T, V) emissions and N token columns:
    the fewest slots a lane with which one warp covers the N columns (64
    slots and several warps beyond 2,048, or when a vocabulary is too wide
    for a ring of 4-row loads); the layout is the one
    ``csrc/ctc_align.cu:layout`` counts."""
    slots = next((k for k in SLOT_LADDER if 32 * k >= N), SLOT_LADDER[-1])
    if _ring_rows(V, slots) is None:
        slots = SLOT_LADDER[-1]
    return plan_for(T, N, V, align, slots, max(1, -(-N // (32 * slots))))


def plan_for(T: int, N: int, V: int, align: bool, slots: int, warps: int) -> LaunchPlan:
    """The launch plan at a given number of slots a lane and computing warps
    (several warps only at 64 slots, as the kernel takes them)."""
    if slots not in SLOT_LADDER or warps < 1 or (warps > 1 and slots != SLOT_LADDER[-1]):
        raise ValueError(f"ctc_align: no kernel runs {warps} warps of {slots} columns a lane")
    if warps > MAX_WARPS or 32 * slots * warps < N:
        raise ValueError(
            f"ctc_align: {N} token columns need {warps} warps of {slots} columns a lane, over the {MAX_WARPS} "
            "whose registers a CTA can hold"
        )
    rows = _ring_rows(V, slots)
    if rows is None:
        raise ValueError(f"ctc_align: a ring of {V}-float emission rows does not fit in a CTA's shared memory")
    threads = 32 * max(warps + 1, EPILOGUE_WARPS)
    words = slots * warps

    def base(stages: int) -> int:  # words up to and with t_start
        ring = stages * (V + 3) * row_pitch(rows, slots)
        return ring + ring % 2 + (2 * warps * MAILBOX if warps > 1 else 0) + 1

    stages = 2 if 4 * base(2) <= SMEM_LIMIT else 1
    if 4 * base(stages) > SMEM_LIMIT:
        raise ValueError(
            f"ctc_align: an emission row of {V} floats needs {4 * base(stages)} bytes of shared memory, over the "
            f"{SMEM_LIMIT} a CTA can use"
        )
    bits_at = -(-base(stages) // 4) * 4
    bits = bit_rows(T) * words
    bits_in_smem = align and 4 * (bits_at + bits) <= SMEM_LIMIT
    smem_bytes = 4 * (bits_at + bits) if bits_in_smem else 4 * base(stages)
    return LaunchPlan(slots, warps, threads, rows, stages, smem_bytes, bits_in_smem, words)


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entry points' argument types on a built ``csrc/ctc_align.cu``."""
    lib.ctc_align.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 10 + [ctypes.c_longlong, ctypes.c_void_p]
    lib.ctc_align.restype = ctypes.c_int
    lib.ctc_barrier_steps.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    lib.ctc_barrier_steps.restype = ctypes.c_int
    lib.ctc_shuffle_steps.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    lib.ctc_shuffle_steps.restype = ctypes.c_int
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return declare(_build.load("ctc_align"))


def _first_column(lp: torch.Tensor, t_len: torch.Tensor, n_len: torch.Tensor, blank: int) -> torch.Tensor:
    """Rows 1..T of the trellis's column 0, (B, T): the cumsum of blank, with
    the last n_len rows set to +inf (the full-consumption forcing trick)."""
    T = lp.shape[1]
    dev = lp.device
    csum = torch.cumsum(lp[:, :, blank], dim=1)
    rows = torch.arange(1, T + 1, device=dev)[None, :]
    return torch.where(rows > (t_len - n_len)[:, None].to(dev), INF, csum)


def _check(log_probs: torch.Tensor, tokens: torch.Tensor, t_len: torch.Tensor, n_len: torch.Tensor, blank: int) -> None:
    if log_probs.ndim != 3 or tokens.ndim != 2 or tokens.shape[0] != log_probs.shape[0]:
        raise ValueError(f"ctc: log_probs {tuple(log_probs.shape)} must be (B, T, V), tokens {tuple(tokens.shape)} (B, N)")
    if t_len.shape != (log_probs.shape[0],) or n_len.shape != (log_probs.shape[0],):
        raise ValueError(f"ctc: t_len {tuple(t_len.shape)} and n_len {tuple(n_len.shape)} must be (B,)")
    if not 0 <= blank < log_probs.shape[2]:
        raise ValueError(f"ctc: blank {blank} outside the vocabulary of {log_probs.shape[2]}")


def _launch(log_probs, tokens, t_len, n_len, blank: int, align: bool):
    """One launch of ``csrc/ctc_align.cu`` on CUDA tensors: the trellis
    (trellis mode) or (token_idx, probs, active, success, t_start)."""
    global launches
    _check(log_probs, tokens, t_len, n_len, blank)
    dev = log_probs.device
    lp = log_probs.float().contiguous()
    B, T, V = lp.shape
    N = tokens.shape[1]
    if align and N < 1:
        raise ValueError("ctc_align_batch_device: tokens must have at least one column")
    tokens = tokens.to(dev, torch.long).contiguous()
    t_len = t_len.to(dev, torch.long).contiguous()
    n_len = n_len.to(dev, torch.long).contiguous()
    col0 = torch.zeros((B, T + 1), dtype=torch.float32, device=dev)
    col0[:, 1:] = _first_column(lp, t_len, n_len, blank)
    plan = launch_plan(T, N, V, align)
    trellis = outs = scratch = None
    if align:
        outs = (
            torch.empty((B, T), dtype=torch.long, device=dev),
            torch.empty((B, T), dtype=torch.float32, device=dev),
            torch.empty((B, T), dtype=torch.bool, device=dev),
            torch.empty((B,), dtype=torch.bool, device=dev),
            torch.empty((B,), dtype=torch.long, device=dev),
        )
        if not plan.bits_in_smem:
            scratch = torch.empty((B, bit_rows(T), plan.words), dtype=torch.int32, device=dev)
    else:
        trellis = torch.empty((B, T + 1, N + 1), dtype=torch.float32, device=dev)
    ptrs = [None if x is None else x.data_ptr() for x in (trellis, *(outs or (None,) * 5), scratch)]
    lib = _lib()
    with torch.cuda.device(dev):
        code = lib.ctc_align(
            lp.data_ptr(), tokens.data_ptr(), t_len.data_ptr(), n_len.data_ptr(), col0.data_ptr(), *ptrs,
            B, T, N, V, blank, plan.slots, plan.warps, plan.threads, plan.rows, plan.stages, plan.smem_bytes,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, code, "ctc_align")
    launches += 1
    return outs if align else trellis


def _probe_ms(run, iters: int, dev) -> float:
    with torch.cuda.device(dev):
        run()
        stream = torch.cuda.current_stream(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        for _ in range(iters):
            run()
        end.record(stream)
        end.synchronize()
    return start.elapsed_time(end) / iters


def barrier_steps_ms(B: int, T: int, threads: int, iters: int = 20, device="cuda") -> float:
    """Device ms of ``B`` CTAs of ``threads`` threads each running T
    barriered steps of an empty loop body (one shared-memory round trip a
    step): the floor of the kernel's barriered design before its redesign,
    one barrier of a CTA a step (chip_smoke.py)."""
    lib = _lib()
    dev = torch.device(device)
    out = torch.empty((B, threads), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    return _probe_ms(
        lambda: _build.check(lib, lib.ctc_barrier_steps(B, T, threads, out.data_ptr(), stream), "ctc_barrier_steps"),
        iters, dev,
    )


def shuffle_steps_ms(B: int, T: int, iters: int = 20, device="cuda") -> float:
    """Device ms of ``B`` warps each running T dependent steps of one
    ``__shfl_up_sync``, one fp32 add and one compare-select: the trellis
    recurrence's dependency bound at T rows (chip_smoke.py)."""
    lib = _lib()
    dev = torch.device(device)
    out = torch.empty((B, 32), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    return _probe_ms(
        lambda: _build.check(lib, lib.ctc_shuffle_steps(B, T, out.data_ptr(), stream), "ctc_shuffle_steps"),
        iters, dev,
    )


def ctc_trellis_batch(
    log_probs: torch.Tensor,  # (B, T, V) log-softmax emissions
    tokens: torch.Tensor,  # (B, N) int, padded with any valid id
    t_len: torch.Tensor,  # (B,) true frame counts
    n_len: torch.Tensor,  # (B,) true token counts
    blank: int = 0,
) -> torch.Tensor:
    """Compute (B, T+1, N+1) alignment trellises for a padded segment batch:
    one kernel launch on a CUDA tensor, :func:`ctc_trellis_batch_plain`
    elsewhere."""
    if log_probs.is_cuda:
        return _launch(log_probs, tokens, t_len, n_len, blank, align=False)
    return ctc_trellis_batch_plain(log_probs, tokens, t_len, n_len, blank)


def ctc_trellis_batch_plain(
    log_probs: torch.Tensor,  # (B, T, V) log-softmax emissions
    tokens: torch.Tensor,  # (B, N) int, padded with any valid id
    t_len: torch.Tensor,  # (B,) true frame counts
    n_len: torch.Tensor,  # (B,) true token counts
    blank: int = 0,
) -> torch.Tensor:
    """The plain version of :func:`ctc_trellis_batch` (any device)."""
    B, T, _ = log_probs.shape
    N = tokens.shape[1]
    dev = log_probs.device
    lp = log_probs.float()
    blank_em = lp[:, :, blank]  # (B, T)
    tok_em = torch.gather(lp, 2, tokens.long()[:, None, :].expand(B, T, N))  # (B, T, N)

    trellis = torch.empty((B, T + 1, N + 1), dtype=torch.float32, device=dev)
    trellis[:, 1:, 0] = _first_column(lp, t_len, n_len, blank)
    trellis[:, 0, 0] = 0.0
    trellis[:, 0, 1:] = -INF
    for t in range(T):
        prev = trellis[:, t]
        stay = prev[:, 1:] + blank_em[:, t, None]
        advance = prev[:, :-1] + tok_em[:, t]
        torch.maximum(stay, advance, out=trellis[:, t + 1, 1:])
    return trellis


@dataclass
class PathPoint:
    token_index: int
    time_index: int
    score: float  # frame-wise probability


@dataclass
class CharSpan:
    label: str
    start: int  # frame index (inclusive)
    end: int  # frame index (exclusive)
    score: float


def backtrack(
    trellis: np.ndarray,  # (T+1, N+1), true sizes (unpadded view)
    blank_em: np.ndarray,  # (T,) blank log-probs
    tok_em: np.ndarray,  # (T, N) per-token log-probs
) -> Optional[List[PathPoint]]:
    """Greedy stay/change walk from argmax of the last column.

    Returns None when the walk exhausts time before consuming all tokens —
    callers fall back to segment-level timestamps, the same degraded-output
    contract as the reference (whisperx/alignment.py:245-248).
    """
    T = trellis.shape[0] - 1
    N = trellis.shape[1] - 1
    j = N
    t_start = int(np.argmax(trellis[:, j]))

    path: List[PathPoint] = []
    for t in range(t_start, 0, -1):
        stayed = trellis[t - 1, j] + blank_em[t - 1]
        changed = trellis[t - 1, j - 1] + tok_em[t - 1, j - 1]
        prob = float(np.exp(tok_em[t - 1, j - 1] if changed > stayed else blank_em[t - 1]))
        path.append(PathPoint(j - 1, t - 1, prob))
        if changed > stayed:
            j -= 1
            if j == 0:
                break
    else:
        return None
    return path[::-1]


def merge_repeats(path: List[PathPoint], transcript: str) -> List[CharSpan]:
    """Collapse consecutive path points of the same token into char spans."""
    spans: List[CharSpan] = []
    i1 = 0
    while i1 < len(path):
        i2 = i1
        while i2 < len(path) and path[i1].token_index == path[i2].token_index:
            i2 += 1
        score = sum(p.score for p in path[i1:i2]) / (i2 - i1)
        spans.append(
            CharSpan(
                transcript[path[i1].token_index],
                path[i1].time_index,
                path[i2 - 1].time_index + 1,
                score,
            )
        )
        i1 = i2
    return spans


def merge_words(spans: List[CharSpan], separator: str = "|") -> List[CharSpan]:
    """Group char spans into word spans at separator chars (length-weighted score)."""
    words: List[CharSpan] = []
    i1, i2 = 0, 0
    while i1 < len(spans):
        if i2 >= len(spans) or spans[i2].label == separator:
            if i1 != i2:
                segs = spans[i1:i2]
                word = "".join(s.label for s in segs)
                total = sum(s.end - s.start for s in segs)
                score = sum(s.score * (s.end - s.start) for s in segs) / total
                words.append(CharSpan(word, segs[0].start, segs[-1].end, score))
            i1 = i2 + 1
            i2 = i1
        else:
            i2 += 1
    return words


def ctc_backtrack_device(
    trellis: torch.Tensor,  # (B, T+1, N+1)
    log_probs: torch.Tensor,  # (B, T, V)
    tokens: torch.Tensor,  # (B, N)
    t_len: torch.Tensor,  # (B,)
    n_len: torch.Tensor,  # (B,)
    blank: int = 0,
):
    """The greedy stay/change walk of :func:`backtrack` for every row at
    once, on the trellis's device (``whisperx_tpu/ops/ctc.py:157-231``).

    Step k walks t = T - k: with the token pointer j, ``stayed =
    trellis[t-1, j] + blank[t-1]``, ``changed = trellis[t-1, j-1] +
    tok[t-1, j-1]``, and j moves down when the step is active (t <= t_start,
    j > 0) and ``changed > stayed``. All decisions are computed up front, so
    the loop only gathers one of them per row and step.

    Returns (token_idx, probs, active, success, t_start): (B, T) arrays in
    descending-t order (position k holds time index T - 1 - k), then (B,).
    """
    B, T1, N1 = trellis.shape
    T = T1 - 1
    dev = trellis.device
    lp = log_probs.float()
    blank_em = lp[:, :, blank]  # (B, T)
    tok_em = torch.gather(lp, 2, tokens.long()[:, None, :].expand(B, T, N1 - 1))  # (B, T, N)
    t_len = t_len.to(dev).long()
    n_len = n_len.to(dev).long()

    # Start row: argmax over valid rows (t <= t_len) of the true final column
    # (the first maximum, as jnp.argmax takes it).
    col = torch.gather(trellis, 2, n_len[:, None, None].expand(B, T1, 1))[..., 0]  # (B, T+1)
    rows = torch.arange(T1, device=dev)[None, :]
    col = torch.where(rows <= t_len[:, None], col, -INF)
    t_start = torch.argmax(col, dim=1)

    # Every decision of the walk: for time t-1 (row r = t-1) and pointer j,
    # jm1 = max(j-1, 0); take = changed > stayed; the step is active when
    # t <= t_start and j > 0.
    prev = trellis[:, :T]  # rows t-1 for t = 1..T, (B, T, N+1)
    jm1 = torch.clamp(torch.arange(N1, device=dev) - 1, min=0)  # (N+1,)
    stayed = prev + blank_em[:, :, None]
    changed = prev[:, :, jm1] + tok_em[:, :, jm1]
    take_all = changed > stayed
    live = (torch.arange(1, T + 1, device=dev)[None, :] <= t_start[:, None])[:, :, None]  # t <= t_start
    move = (take_all & live & (torch.arange(N1, device=dev) > 0)).long().reshape(B, T * N1)

    j = n_len
    js = []  # pointer before each step, descending t
    for t in range(T, 0, -1):
        js.append(j)
        j = j - torch.gather(move, 1, (j + (t - 1) * N1)[:, None])[:, 0]
    j_before = torch.stack(js, dim=1)  # (B, T)

    # The step outputs, vectorised over the walk: row t-1 = T-1-k at position k.
    r = torch.arange(T - 1, -1, -1, device=dev)[None, :].expand(B, T)
    rows_b = torch.arange(B, device=dev)[:, None]
    jm1_k = torch.clamp(j_before - 1, min=0)
    take = take_all[rows_b, r, j_before]
    tok_k = tok_em[rows_b, r, jm1_k]
    blank_k = blank_em.flip(1)
    probs = torch.exp(torch.where(take, tok_k, blank_k))
    active = ((r + 1) <= t_start[:, None]) & (j_before > 0)
    success = j == 0
    return jm1_k, probs, active, success, t_start


def ctc_align_batch_device(
    log_probs: torch.Tensor,  # (B, T, V)
    tokens: torch.Tensor,  # (B, N)
    t_len: torch.Tensor,  # (B,)
    n_len: torch.Tensor,  # (B,)
    blank: int = 0,
    backend: str = "scan",
):
    """Fused trellis + backtrack, entirely on the device (no host sync): one
    launch of ``csrc/ctc_align.cu`` on a CUDA tensor,
    :func:`ctc_align_batch_device_plain` elsewhere.

    Returns (token_idx, probs, active, success, t_start) as
    :func:`ctc_backtrack_device` does. ``backend`` "scan" is the only
    trellis implementation; anything else raises, as in the JAX package.

    On a CUDA tensor the emissions must be log-probabilities in their blank
    column (at most 0, as log-softmax gives): a blank log-prob above 0, like
    a token id outside the vocabulary, fails the launch (the kernel traps,
    and the process's CUDA context is lost). The plain version takes any
    finite values.
    """
    if backend != "scan":
        raise ValueError(
            f"unknown CTC trellis backend {backend!r}: 'scan' is the only "
            "implementation (the r2 Pallas trellis was deleted)"
        )
    if log_probs.is_cuda:
        return _launch(log_probs, tokens, t_len, n_len, blank, align=True)
    return ctc_align_batch_device_plain(log_probs, tokens, t_len, n_len, blank)


def ctc_align_batch_device_plain(log_probs, tokens, t_len, n_len, blank: int = 0):
    """The plain version of :func:`ctc_align_batch_device` (any device): the
    plain trellis, then the vectorised walk."""
    trellis = ctc_trellis_batch_plain(log_probs, tokens, t_len, n_len, blank=blank)
    return ctc_backtrack_device(trellis, log_probs, tokens, t_len, n_len, blank=blank)


def align_tokens_batch(
    log_probs,  # (B, T, V) log-probs, numpy or tensor
    token_lists: List[List[int]],
    t_lens: List[int],
    blank: int = 0,
    backtrack_impl: str = "device",
    *,
    device=None,
):
    """Batched trellis + backtrack for a padded batch of segments.

    ``backtrack_impl`` is "device" (the vectorised walk) or "host" (the
    numpy reference walk), as in the JAX package's signature.
    ``device`` is where the trellis runs: a tensor's own device by default,
    the CPU for numpy input. Returns a list (one per segment) of path lists
    (or None on failure). On the card the "device" walk needs blank
    log-probs of at most 0 (:func:`ctc_align_batch_device`).
    """
    lp = torch.as_tensor(log_probs)
    dev = torch.device(device) if device is not None else lp.device
    lp = lp.to(dev)
    B, T, V = lp.shape
    # Bucket the token-count dim as the JAX package does (its compile
    # signatures); the walk's results do not depend on it.
    N_true = max((len(t) for t in token_lists), default=1)
    N = max(64, -(-N_true // 64) * 64) if backtrack_impl == "device" else N_true
    tokens = np.zeros((B, N), np.int64)
    n_len = np.zeros((B,), np.int64)
    for i, tl in enumerate(token_lists):
        tokens[i, : len(tl)] = tl
        n_len[i] = len(tl)
    tokens_t = torch.from_numpy(tokens).to(dev)
    t_len_t = torch.as_tensor(np.asarray(t_lens, np.int64)).to(dev)
    n_len_t = torch.from_numpy(n_len).to(dev)

    if backtrack_impl == "device":
        tok_idx, probs, active, success, _ = ctc_align_batch_device(lp, tokens_t, t_len_t, n_len_t, blank=blank)
        tok_idx, probs = tok_idx.cpu().numpy(), probs.cpu().numpy()
        active, success = active.cpu().numpy(), success.cpu().numpy()
        times = T - 1 - np.arange(T)  # time_index at each walk position
        out = []
        for i in range(len(token_lists)):
            if not success[i]:
                out.append(None)
                continue
            ks = np.nonzero(active[i])[0]
            out.append([PathPoint(int(tok_idx[i, k]), int(times[k]), float(probs[i, k])) for k in ks][::-1])
        return out

    trellis = ctc_trellis_batch(lp, tokens_t, t_len_t, n_len_t, blank=blank).cpu().numpy()
    lp_host = lp.float().cpu().numpy()
    out = []
    for i, tl in enumerate(token_lists):
        Ti, Ni = int(t_lens[i]), len(tl)
        em_i = lp_host[i, :Ti]
        out.append(backtrack(trellis[i, : Ti + 1, : Ni + 1], em_i[:, blank], em_i[:, tl]))
    return out
