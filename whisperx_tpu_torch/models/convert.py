"""Build the port's modules from a parameter tree in the JAX package's layout.

The tree is the nested dict ``whisperx_tpu`` keeps (``{"encoder": {...},
"decoder": {...}}`` with ``layers_<i>`` subtrees), given as numpy arrays: fp,
int8-quantized (:func:`..models.whisper.quantize_params`) and/or fused-QKV
(:func:`..models.whisper.fuse_qkv_params`). The port's modules then compute
the same function as the JAX ``Whisper`` with those parameters.

Layout changes, leaf by leaf:
- Conv kernels: Flax stores (W, I, O); the port stores torch's (O, I, W).
- Dense kernels keep (K, N) = (in, out): the layout the int8 kernel reads.
- Everything else (embeddings, scales, biases, LayerNorms) is copied as is.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from ..device import DeviceLike
from .configs import WhisperConfig
from .whisper import Whisper


def _flatten(tree: dict, prefix: tuple = ()):
    for name, child in tree.items():
        if isinstance(child, dict):
            yield from _flatten(child, prefix + (name,))
        else:
            yield prefix + (name,), child


def _has_key(tree, key: str) -> bool:
    return isinstance(tree, dict) and any(k == key or _has_key(c, key) for k, c in tree.items())


def torch_name(path: tuple) -> str:
    """JAX tree path → the port's parameter name (``layers_3`` → ``layers.3``)."""
    return re.sub(r"\blayers_(\d+)\b", r"layers.\1", ".".join(path))


@torch.no_grad()
def load_jax_params(model: Whisper, params: dict) -> Whisper:
    """Copy every leaf of ``params`` into ``model``; raises on a missing,
    extra or mis-shaped leaf."""
    named = dict(model.named_parameters())
    seen = set()
    for path, leaf in _flatten(params):
        name = torch_name(path)
        if name not in named:
            raise KeyError(f"parameter {'/'.join(path)} has no counterpart {name!r} in the port")
        arr = np.asarray(leaf)
        if path[-1] == "kernel" and arr.ndim == 3:
            arr = arr.transpose(2, 1, 0)  # Flax conv (W, I, O) → torch (O, I, W)
        dst = named[name]
        src = torch.from_numpy(np.array(arr))  # a writable contiguous copy
        if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
            raise ValueError(
                f"{name}: tree leaf {tuple(src.shape)} {src.dtype} does not fit "
                f"{tuple(dst.shape)} {dst.dtype}"
            )
        dst.copy_(src)
        seen.add(name)
    missing = sorted(set(named) - seen)
    if missing:
        raise KeyError(f"parameters missing from the tree: {missing[:5]} ({len(missing)} in all)")
    return model


def whisper_from_jax(
    params: dict,
    config: WhisperConfig,
    *,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> Whisper:
    """A port ``Whisper`` holding ``params`` (numpy tree, JAX layout).

    Quantization (per stack) and QKV fusion are read off the tree.
    ``device=None`` means the card.
    """
    q_enc = _has_key(params["encoder"], "kernel_scale")
    q_dec = _has_key(params["decoder"], "kernel_scale")
    quantized = (q_enc and q_dec) or ("encoder" if q_enc else "decoder" if q_dec else False)
    fused = _has_key(params, "qkv")
    model = Whisper(config, dtype=dtype, quantized=quantized, fused_qkv=fused, device=device)
    return load_jax_params(model, params)
