"""Plain reference of the VAD cut & merge: speech-band scores, hysteresis
binarize with the min-cut, greedy merge into chunks of at most 30 s.

A frozen copy of the semantics of the port's weight-free default
(``SpeechBandVAD`` at onset 0.5 / offset 0.363, ``min_duration_on`` 0.5)
and of whisperX's ``Binarize`` + ``merge_chunks``, in numpy. It imports
nothing of the program. Exact comparisons hold: same operations on the same
samples give the same bits.
"""

from __future__ import annotations

import numpy as np

SR = 16_000
FRAME_STEP = 270
FRAME_SIZE = 991


def _frame_sq_sums(x: np.ndarray, starts: np.ndarray, win: int) -> np.ndarray:
    n = len(x)
    sq = np.asarray(x, np.float32) ** 2
    bounds = np.unique(np.concatenate([starts, starts + win]))
    inner = bounds[bounds < n]
    seg = np.add.reduceat(sq, inner)
    cum = np.concatenate([[0.0], np.cumsum(seg, dtype=np.float64)])
    return cum[np.searchsorted(inner, starts + win)] - cum[np.searchsorted(inner, starts)]


def _convolve_same(x: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    out = np.convolve(x, kernel, mode="same")
    if len(out) != len(x):
        start = (len(kernel) - 1) // 2
        out = np.convolve(x, kernel, mode="full")[start : start + len(x)]
    return out


def _rolling_mean(x: np.ndarray, w: int) -> np.ndarray:
    pad = np.pad(x, (w // 2, w - w // 2 - 1), mode="edge")
    c = np.concatenate([[0.0], np.cumsum(pad)])
    return (c[w:] - c[:-w]) / w


def _sliding(arr: np.ndarray, w: int, op, left: int, right: int) -> np.ndarray:
    view = np.lib.stride_tricks.sliding_window_view(np.pad(arr, (left, right), mode="edge"), w)
    return op(view, axis=1)


def speech_scores(audio: np.ndarray):
    """Frame scores and frame-centre times of the speech-band scorer
    (band 300-3500 Hz, syllabic-modulation gate, closing of 0.22 s)."""
    n = len(audio)
    if n < FRAME_SIZE:
        audio = np.pad(audio, (0, FRAME_SIZE - n))
        n = len(audio)
    spec = np.fft.rfft(audio.astype(np.float32))
    freqs = np.fft.rfftfreq(n, 1.0 / SR)
    spec[(freqs < 300.0) | (freqs > 3500.0)] = 0.0
    banded = np.fft.irfft(spec, n).astype(np.float32)
    total = (n - FRAME_SIZE) // FRAME_STEP + 1
    starts = np.arange(total) * FRAME_STEP
    rms = np.sqrt(_frame_sq_sums(banded, starts, FRAME_SIZE) / FRAME_SIZE)
    rate = SR / FRAME_STEP
    rms = _convolve_same(rms, np.ones(5) / 5)
    hp = rms - _rolling_mean(rms, max(3, int(0.25 * rate)))
    w = max(3, int(0.8 * rate))
    mod = np.sqrt(np.maximum(_rolling_mean(hp**2, w), 0.0))
    gate = np.clip(mod / np.maximum(_rolling_mean(rms, w), 1e-8) / 0.3, 0.0, 1.0)
    gate = _convolve_same(gate, np.ones(29) / 29)
    env = _sliding(rms, 11, np.max, 5, 5)
    log_rms = np.log10(np.maximum(env, 1e-10))
    lo, hi = np.percentile(log_rms, 10), np.percentile(log_rms, 95)
    scores = np.clip((log_rms - lo) / max(hi - lo, 1e-6), 0.0, 1.0) * gate
    cw = max(3, int(0.22 * rate))
    cw += cw % 2 == 0
    scores = _sliding(_sliding(scores, cw, np.max, cw // 2, cw // 2), cw, np.min, cw // 2, cw // 2)
    return scores.astype(np.float32), ((starts + FRAME_SIZE / 2) / SR).astype(np.float32)


def binarize(scores, times, onset=0.5, offset=0.363, min_on=0.5, max_duration=30.0) -> list:
    """Hysteresis turns; an active run longer than ``max_duration`` is cut at
    its lowest score in the second half of the run."""
    scores = np.asarray(scores, np.float64)
    times = np.asarray(times, np.float64)
    turns = []
    start = times[0]
    active = scores[0] > onset
    run_s, run_t = [scores[0]], [start]
    t = start
    for t, y in zip(times[1:], scores[1:]):
        if active:
            if t - start > max_duration:
                half = len(run_s) // 2
                cut = half + int(np.argmin(run_s[half:]))
                turns.append((start, run_t[cut]))
                start = run_t[cut]
                run_s, run_t = run_s[cut + 1 :], run_t[cut + 1 :]
            elif y < offset:
                turns.append((start, t))
                start, active, run_s, run_t = t, False, [], []
            run_s.append(y)
            run_t.append(t)
        elif y > onset:
            start, active = t, True
    if active:
        turns.append((start, t))
    return [(a, b) for a, b in turns if b - a >= min_on]


def merge(turns: list, chunk: float = 30.0) -> list:
    """Greedy packing of consecutive turns into chunks of at most ``chunk`` s."""
    if not turns:
        return []
    out, start, end = [], turns[0][0], turns[0][0]
    for a, b in turns:
        if b - start > chunk and end - start > 0:
            out.append((start, end))
            start = a
        end = b
    out.append((start, end))
    return out


def chunks(audio: np.ndarray, chunk: float = 30.0) -> list:
    """The (start, end) seconds of the chunks the pipeline decodes."""
    scores, times = speech_scores(audio)
    return merge(binarize(scores, times, max_duration=chunk), chunk)
