"""Parameter partition rules: path pattern → partition spec.

Port of ``whisperx_tpu/parallel/partition.py`` with the same rule tables,
the same patterns in the same order (first match wins). A spec is a tuple
with one entry per array dimension: ``"model"`` where that dimension splits
over the mesh's "model" axis, ``None`` where it does not; ``()`` is
replicated. The tables describe the Megatron layout:

- attention q/k/v kernels split their *head* (output) dim; the
  out-projection splits its input dim, so the block needs one all-reduce
  at the residual add;
- MLP fc1 splits the hidden (4d) output dim, fc2 the matching input dim;
- embeddings split the vocab dim (the logits are gathered before the
  search);
- LayerNorms, convs, and biases of row-split matmuls stay whole.

Rules match the "a/b/c" path of a leaf in the JAX-named numpy tree (the one
``models/convert.py:whisper_from_jax`` and ``wav2vec2_from_jax`` take) with
fnmatch wildcards.
"""

from __future__ import annotations

import fnmatch
from typing import Any

import numpy as np

from .mesh import axis_index, axis_size

Spec = tuple

# (pattern, spec) — first match wins. Patterns cover both encoder and decoder
# stacks of the Whisper tree and the wav2vec2 encoder tree.
WHISPER_RULES: tuple[tuple[str, Spec], ...] = (
    # Attention projections: column-parallel qkv, row-parallel out.
    ("*/attn/query/kernel", (None, "model")),
    ("*/attn/key/kernel", (None, "model")),
    ("*/attn/value/kernel", (None, "model")),
    ("*/attn/out/kernel", ("model", None)),
    ("*/cross_attn/query/kernel", (None, "model")),
    ("*/cross_attn/key/kernel", (None, "model")),
    ("*/cross_attn/value/kernel", (None, "model")),
    ("*/cross_attn/out/kernel", ("model", None)),
    ("*/attn/query/bias", ("model",)),
    ("*/attn/value/bias", ("model",)),
    ("*/cross_attn/query/bias", ("model",)),
    ("*/cross_attn/value/bias", ("model",)),
    # MLP: column-parallel fc1, row-parallel fc2.
    ("*/mlp/fc1/kernel", (None, "model")),
    ("*/mlp/fc1/bias", ("model",)),
    ("*/mlp/fc2/kernel", ("model", None)),
    # int8 weight-only scales follow their kernel's output-dim split:
    # column-parallel kernels split the (out,) scale, row-parallel keep it whole.
    ("*/attn/query/kernel_scale", ("model",)),
    ("*/attn/key/kernel_scale", ("model",)),
    ("*/attn/value/kernel_scale", ("model",)),
    ("*/cross_attn/query/kernel_scale", ("model",)),
    ("*/cross_attn/key/kernel_scale", ("model",)),
    ("*/cross_attn/value/kernel_scale", ("model",)),
    ("*/mlp/fc1/kernel_scale", ("model",)),
    # Embeddings: split the vocab/feature table rows (and per-row scales).
    ("*token_embedding", ("model", None)),
    ("*token_embedding_scale", ("model",)),
    # Everything else (LayerNorm scales, conv kernels, out/fc2 biases,
    # positional embeddings) is replicated.
)

W2V2_RULES: tuple[tuple[str, Spec], ...] = (
    # out_proj first: the generic *_proj pattern below would otherwise match
    # it (first rule wins) and give the row-parallel matmul a column spec.
    ("*/attention/out_proj/kernel", ("model", None)),
    ("*/attention/*_proj/kernel", (None, "model")),
    ("*/feed_forward/intermediate/kernel", (None, "model")),
    ("*/feed_forward/intermediate/bias", ("model",)),
    ("*/feed_forward/output/kernel", ("model", None)),
    ("*lm_head/kernel", (None, None)),
)


def _spec_for(path: str, rules) -> Spec:
    for pattern, spec in rules:
        if fnmatch.fnmatch(path, pattern):
            return spec
    return ()


def _map_with_path(fn, tree: Any, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k)) for k, v in tree.items()}
    return fn(prefix, tree)


def partition_specs(params: Any, rules=WHISPER_RULES):
    """Spec tree matching ``params`` (nested dicts of arrays), derived from
    path rules."""
    return _map_with_path(lambda path, _: _spec_for(path, rules), params)


def shard_leaf(x, spec: Spec, n: int, i: int):
    """Slice ``i`` of ``n`` of ``x`` along the dims ``spec`` marks "model",
    or ``x`` whole where such a dim does not divide ``n`` (or ``x`` lacks
    it), as the JAX package falls back to replication."""
    x = np.asarray(x)
    dims = [d for d, axis in enumerate(spec) if axis == "model"]
    if n == 1 or not dims or any(d >= x.ndim or x.shape[d] % n for d in dims):
        return x
    for d in dims:
        size = x.shape[d] // n
        x = x[(slice(None),) * d + (slice(i * size, (i + 1) * size),)]
    return np.ascontiguousarray(x)


def shard_params(params, mesh, rules=WHISPER_RULES):
    """This rank's slices of a parameter tree, according to the rules: a
    dim marked "model" keeps the slice at this rank's "model" coordinate.

    Dims that do not divide the mesh axis fall back to replication for that
    param (keeps tiny test models and odd vocabularies working on any
    mesh)."""
    n, i = axis_size(mesh, "model"), axis_index(mesh, "model")
    return _map_with_path(lambda path, x: shard_leaf(x, _spec_for(path, rules), n, i), params)
