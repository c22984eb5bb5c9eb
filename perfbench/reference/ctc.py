"""Plain reference of CTC forced alignment and the word timestamps it gives.

whisperX's trellis and backtrack (``whisperx/alignment.py``, after the
torchaudio tutorial) in float64 numpy on one segment at a time: the trellis
starts with the cumulative blank in its first column and forces the last
``n`` frames to consume every token; the walk starts at the best frame of
the last column and steps back, staying on blank or advancing a token.
Then chars merge into spans and spans into words: a word's start is its
first char's first frame, its end its last char's last frame + 1, each
times the segment's seconds per frame, and its score the mean of its chars'
mean frame probabilities (rounded to 3 digits, as whisperX rounds).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def path(log_probs: np.ndarray, tokens: list, blank: int = 0) -> Optional[list]:
    """(token index, frame, prob) of each frame the walk visits, in time
    order, for (T, V) log-probs and the token ids; None when the walk runs
    out of frames before it consumes every token."""
    lp = np.asarray(log_probs, np.float64)
    T, N = lp.shape[0], len(tokens)
    blank_em = lp[:, blank]
    tok_em = lp[:, tokens]
    trellis = np.empty((T + 1, N + 1))
    trellis[0, 0] = 0.0
    trellis[0, 1:] = -np.inf
    trellis[1:, 0] = np.cumsum(blank_em)
    trellis[T - N + 1 :, 0] = np.inf
    for t in range(T):
        trellis[t + 1, 1:] = np.maximum(trellis[t, 1:] + blank_em[t], trellis[t, :-1] + tok_em[t])
    j = N
    t_start = int(np.argmax(trellis[:, j]))
    out = []
    for t in range(t_start, 0, -1):
        stay = trellis[t - 1, j] + blank_em[t - 1]
        move = trellis[t - 1, j - 1] + tok_em[t - 1, j - 1]
        out.append((j - 1, t - 1, float(np.exp(tok_em[t - 1, j - 1] if move > stay else blank_em[t - 1]))))
        if move > stay:
            j -= 1
            if j == 0:
                return out[::-1]
    return None


def words(text: str, dictionary: dict, log_probs: np.ndarray, start: float, end: float, blank: int = 0) -> Optional[list]:
    """(word, start s, end s, score) of each word of ``text`` aligned over the
    segment [start, end] whose (T, V) emissions are ``log_probs``. The text
    is one sentence of lowercase words separated by single spaces."""
    body = text.strip()
    chars = [("|" if c == " " else c) for c in body]
    keep = [i for i, c in enumerate(chars) if c in dictionary]
    steps = path(log_probs, [dictionary[chars[i]] for i in keep], blank)
    if steps is None:
        return None
    spans = {}
    for k, t, p in steps:
        a, b, ps = spans.get(k, (t, t, []))
        spans[k] = (min(a, t), max(b, t), ps + [p])
    ratio = (end - start) / log_probs.shape[0]
    char_at = {keep[k]: (round(a * ratio + start, 3), round((b + 1) * ratio + start, 3), round(sum(ps) / len(ps), 3))
               for k, (a, b, ps) in spans.items()}
    out, pos = [], 0
    for w in body.split(" "):
        times = [char_at[i] for i in range(pos, pos + len(w)) if i in char_at]
        pos += len(w) + 1
        if times:
            out.append((w, min(x[0] for x in times), max(x[1] for x in times), round(float(np.mean([x[2] for x in times])), 3)))
    return out
