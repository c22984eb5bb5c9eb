"""Speaker clustering: agglomerative (cosine, average linkage) over embeddings.

On-device embeddings land here for the host-side clustering step (tiny N —
hundreds of windows per hour of audio). Honors the reference's
num/min/max_speakers controls (whisperx/diarize.py:21): a fixed ``num``
overrides the distance threshold; min/max clamp the threshold-derived count.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def cluster_speakers(
    embeddings: np.ndarray,  # (N, D), L2-normalized
    *,
    num_speakers: Optional[int] = None,
    min_speakers: Optional[int] = None,
    max_speakers: Optional[int] = None,
    threshold: float = 0.7,  # cosine-distance cut for unknown speaker count
) -> np.ndarray:
    """Return integer labels (N,) in order of first appearance."""
    n = len(embeddings)
    if n == 0:
        return np.zeros((0,), np.int32)
    if n == 1 or num_speakers == 1:
        return np.zeros((n,), np.int32)

    from scipy.cluster.hierarchy import fcluster, linkage

    z = linkage(embeddings, method="average", metric="cosine")

    if num_speakers is not None:
        labels = fcluster(z, t=num_speakers, criterion="maxclust")
    else:
        labels = fcluster(z, t=threshold, criterion="distance")
        k = labels.max()
        lo = min_speakers or 1
        hi = max_speakers or n
        if k < lo:
            labels = fcluster(z, t=min(lo, n), criterion="maxclust")
        elif k > hi:
            labels = fcluster(z, t=hi, criterion="maxclust")

    # Relabel in order of first appearance → stable SPEAKER_00, 01, ...
    remap: dict[int, int] = {}
    out = np.empty(n, np.int32)
    for i, lab in enumerate(labels):
        if lab not in remap:
            remap[lab] = len(remap)
        out[i] = remap[lab]
    return out
