"""Build the port's modules from a parameter tree in the JAX package's layout.

The tree is the nested dict ``whisperx_tpu`` keeps, given as numpy arrays.
For Whisper (``{"encoder": {...}, "decoder": {...}}`` with ``layers_<i>``
subtrees) it may be fp, int8-quantized
(:func:`..models.whisper.quantize_params`) and/or fused-QKV
(:func:`..models.whisper.fuse_qkv_params`); for wav2vec2 it is the Flax
``Wav2Vec2ForCTC`` tree. The port's modules then compute the same function
as the JAX modules with those parameters.

Layout changes, leaf by leaf:
- Conv kernels: Flax stores (W, I, O); the port stores torch's (O, I, W).
- Dense kernels keep (K, N) = (in, out): the layout the int8 kernel reads.
- Everything else (embeddings, scales, biases, LayerNorms) is copied as is.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike
from .configs import Wav2Vec2Config, WhisperConfig
from .wav2vec2 import Wav2Vec2ForCTC
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
def load_jax_params(model: nn.Module, params: dict) -> nn.Module:
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
    attn_impl: str = "auto",
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
    model = Whisper(config, dtype=dtype, quantized=quantized, fused_qkv=fused, attn_impl=attn_impl, device=device)
    return load_jax_params(model, params)


def wav2vec2_from_jax(
    params: dict,
    config: Wav2Vec2Config,
    *,
    dtype: torch.dtype = torch.float32,
    attn_impl: str = "auto",
    device: DeviceLike = None,
) -> Wav2Vec2ForCTC:
    """A port ``Wav2Vec2ForCTC`` holding ``params`` (numpy tree, the Flax
    layout of ``whisperx_tpu/models/wav2vec2.py``; fp only: the int8
    variant is not ported). ``device=None`` means the card."""
    if _has_key(params, "kernel_scale"):
        raise NotImplementedError("int8 wav2vec2 trees (quantize_wav2vec2) are not ported")
    model = Wav2Vec2ForCTC(config, dtype=dtype, attn_impl=attn_impl, device=device)
    return load_jax_params(model, params)
