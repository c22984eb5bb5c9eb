"""Parameter checkpoint save/load: one ``.safetensors`` file per tree.

Port of ``whisperx_tpu/utils/checkpoint.py``. A parameter tree (nested dicts
of arrays in the JAX package's layout, as ``models/convert.py:
whisper_to_jax`` gives it) is flattened with "/"-joined paths, bf16 leaves
widened to fp32, and written as one ``.safetensors`` file; loading rebuilds
the nesting. The file is written and read by hand
(``models/convert.py:write_safetensors`` / ``read_safetensors``), without
the ``safetensors`` package, and a file saved by either package loads in
the other with equal leaves.

Both functions work on host numpy trees and touch no device:
``whisper_from_jax(load_params(path), config)`` puts the weights on the card
(or on the CPU with ``device="cpu"``).
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from ..models.convert import read_safetensors, write_safetensors


def flatten_params(tree: Any, prefix: str = ""):
    """(path, leaf) for every leaf of a nested dict tree, paths joined with
    "/" as the file names them."""
    for name, child in tree.items():
        path = f"{prefix}/{name}" if prefix else str(name)
        if isinstance(child, dict):
            yield from flatten_params(child, path)
        else:
            yield path, child


def _as_numpy(leaf) -> np.ndarray:
    """A leaf as numpy; bf16 (a torch tensor, or an ``ml_dtypes`` array)
    widened to fp32, exactly."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        leaf = leaf.float() if leaf.dtype == torch.bfloat16 else leaf
        return leaf.numpy()
    arr = np.asarray(leaf)
    return arr.astype(np.float32) if arr.dtype.name == "bfloat16" else arr


def save_params(params: Any, path: str) -> None:
    """Write a parameter tree to one ``.safetensors`` file."""
    leaves = [(key, _as_numpy(leaf)) for key, leaf in flatten_params(params)]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_safetensors(path, [(key, arr.shape, arr.dtype, lambda arr=arr: arr) for key, arr in leaves])


def load_params(path: str, dtype=None) -> dict:
    """Read a ``.safetensors`` parameter file back into a nested dict of
    numpy arrays; ``dtype`` (a numpy type), when given, casts every leaf."""
    tree: dict = {}
    for key, arr in read_safetensors(path).items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr.astype(dtype) if dtype is not None else arr
    return tree
