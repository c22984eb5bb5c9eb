"""Checkpoint loading: HF files → the JAX package's parameter tree → the
port's modules.

Two halves. The HF half ports ``whisperx_tpu/models/convert.py:36-346``:
local checkpoint directories (safetensors or torch pickles; no network) are
read into state dicts and transposed into the numpy tree the JAX converter
gives (torch ``nn.Linear.weight`` (out, in) → Dense kernel (in, out); conv1d
(out, in, k) → (k, in, out); LayerNorm weight/bias → scale/bias).
Safetensors files are parsed here (an 8-byte little-endian header length, a
JSON header, raw little-endian buffers), so loading needs no ``safetensors``
package. The pyannote and WeSpeaker converters come with the diarization
slice.

The second half builds the port's modules from such a tree.
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

import glob
import json
import os
import re
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from .configs import Wav2Vec2Config, WhisperConfig
from .wav2vec2 import Wav2Vec2ForCTC
from .whisper import Whisper

# ---------------------------------------------------------------------------
# checkpoint file plumbing
# ---------------------------------------------------------------------------


def resolve_checkpoint_dir(name_or_path: str, cache_dir: Optional[str] = None) -> str:
    """Resolve a local dir, or an HF hub id through the local HF cache."""
    if os.path.isdir(name_or_path):
        return name_or_path
    hub_root = cache_dir or os.path.join(
        os.environ.get("HF_HOME", os.path.expanduser("~/.cache/huggingface")), "hub"
    )
    cache_name = "models--" + name_or_path.replace("/", "--")
    snaps = sorted(glob.glob(os.path.join(hub_root, cache_name, "snapshots", "*")))
    if snaps:
        return snaps[-1]
    raise FileNotFoundError(
        f"Checkpoint {name_or_path!r} not found locally (searched {hub_root}). "
        "Weights load offline: pass a local directory or pre-populate the HF cache."
    )


def primary_weights_file(path: str) -> Optional[str]:
    """The weights file load_state_dict would read first (digest target)."""
    if not os.path.isdir(path):
        return path
    for pattern in ("*.safetensors", "pytorch_model*.bin", "*.ckpt", "*.bin"):
        files = [
            f
            for f in sorted(glob.glob(os.path.join(path, pattern)))
            if "index" not in os.path.basename(f)
        ]
        if files:
            return files[0]
    return None


def maybe_verify_checkpoint(resolved_dir: str, name_or_path: str) -> None:
    """Integrity-check the primary weights file against the pinned registry
    (models/pinned.py, a copy of the JAX package's).

    Runs whenever the checkpoint family has a pinned digest, or for
    unpinned families when WHISPERX_VERIFY_CKPT=1 (hashing multi-GB weights
    costs seconds, so trust-on-first-validation entries skip by default; a
    mismatch downgrades to a warning with WHISPERX_CKPT_ALLOW_UNPINNED=1).
    """
    from .pinned import PINNED, pinned_key_for, verify_pinned

    key = pinned_key_for(name_or_path) or pinned_key_for(resolved_dir)
    if key is None:
        return
    if PINNED.get(key) is None and os.environ.get("WHISPERX_VERIFY_CKPT") != "1":
        return
    weights = primary_weights_file(resolved_dir)
    if weights:
        verify_pinned(key, weights, strict=os.environ.get("WHISPERX_CKPT_ALLOW_UNPINNED") != "1")


_SAFETENSORS_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4",
    "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?",
}


def read_safetensors(path: str) -> dict[str, np.ndarray]:
    """Parse a ``.safetensors`` file into numpy arrays (BF16 widens exactly
    to float32, since numpy has no bfloat16)."""
    with open(path, "rb") as f:
        data = f.read()
    (n,) = np.frombuffer(data[:8], "<u8")
    header = json.loads(data[8 : 8 + int(n)])
    base = 8 + int(n)
    out: dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        buf = data[base + begin : base + end]
        shape = tuple(info["shape"])
        if info["dtype"] == "BF16":
            bits = np.frombuffer(buf, "<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        elif info["dtype"] in _SAFETENSORS_DTYPES:
            arr = np.frombuffer(buf, _SAFETENSORS_DTYPES[info["dtype"]]).copy()
        else:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        out[name] = arr.reshape(shape)
    return out


def load_state_dict(path: str) -> dict[str, np.ndarray]:
    """Read a state dict from a checkpoint dir or file (safetensors/torch)."""
    if os.path.isdir(path):
        st_files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
        if st_files:
            out: dict[str, np.ndarray] = {}
            for f in st_files:
                if "index" in os.path.basename(f):
                    continue
                out.update(read_safetensors(f))
            return out
        bins = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin"))) or sorted(
            glob.glob(os.path.join(path, "*.ckpt"))
        ) or sorted(glob.glob(os.path.join(path, "*.bin")))
        if not bins:
            raise FileNotFoundError(f"no weight files in {path}")
        path = bins[0]

    if path.endswith(".safetensors"):
        return read_safetensors(path)

    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {
        k: (v.float() if v.dtype == torch.bfloat16 else v).numpy() if torch.is_tensor(v) else np.asarray(v)
        for k, v in obj.items()
    }


def _linear(sd, prefix):
    p = {"kernel": sd[prefix + ".weight"].T.astype(np.float32)}
    if prefix + ".bias" in sd:
        p["bias"] = sd[prefix + ".bias"].astype(np.float32)
    return p


def _layernorm(sd, prefix):
    return {
        "scale": sd[prefix + ".weight"].astype(np.float32),
        "bias": sd[prefix + ".bias"].astype(np.float32),
    }


def _conv1d(sd, prefix, with_bias=True):
    p = {"kernel": sd[prefix + ".weight"].transpose(2, 1, 0).astype(np.float32)}
    if with_bias and prefix + ".bias" in sd:
        p["bias"] = sd[prefix + ".bias"].astype(np.float32)
    return p


# ---------------------------------------------------------------------------
# Whisper
# ---------------------------------------------------------------------------


def _whisper_attention(sd, prefix):
    return {
        "query": _linear(sd, prefix + ".q_proj"),
        "key": {"kernel": sd[prefix + ".k_proj.weight"].T.astype(np.float32)},
        "value": _linear(sd, prefix + ".v_proj"),
        "out": _linear(sd, prefix + ".out_proj"),
    }


def convert_whisper(sd: dict, config: WhisperConfig) -> dict:
    """HF WhisperForConditionalGeneration state dict → the JAX param tree."""
    # Strip optional prefixes ("model." for the composite HF model).
    sd = {(k[len("model."):] if k.startswith("model.") else k): v for k, v in sd.items()}

    enc: dict[str, Any] = {
        "conv1": _conv1d(sd, "encoder.conv1"),
        "conv2": _conv1d(sd, "encoder.conv2"),
        "positional_embedding": sd["encoder.embed_positions.weight"].astype(np.float32),
        "ln_post": _layernorm(sd, "encoder.layer_norm"),
    }
    for i in range(config.n_audio_layer):
        p = f"encoder.layers.{i}"
        enc[f"layers_{i}"] = {
            "attn": _whisper_attention(sd, p + ".self_attn"),
            "attn_ln": _layernorm(sd, p + ".self_attn_layer_norm"),
            "mlp": {"fc1": _linear(sd, p + ".fc1"), "fc2": _linear(sd, p + ".fc2")},
            "mlp_ln": _layernorm(sd, p + ".final_layer_norm"),
        }

    dec: dict[str, Any] = {
        "token_embedding": sd["decoder.embed_tokens.weight"].astype(np.float32),
        "positional_embedding": sd["decoder.embed_positions.weight"].astype(np.float32),
        "ln": _layernorm(sd, "decoder.layer_norm"),
    }
    for i in range(config.n_text_layer):
        p = f"decoder.layers.{i}"
        dec[f"layers_{i}"] = {
            "attn": _whisper_attention(sd, p + ".self_attn"),
            "attn_ln": _layernorm(sd, p + ".self_attn_layer_norm"),
            "cross_attn": _whisper_attention(sd, p + ".encoder_attn"),
            "cross_attn_ln": _layernorm(sd, p + ".encoder_attn_layer_norm"),
            "mlp": {"fc1": _linear(sd, p + ".fc1"), "fc2": _linear(sd, p + ".fc2")},
            "mlp_ln": _layernorm(sd, p + ".final_layer_norm"),
        }
    return {"encoder": enc, "decoder": dec}


def whisper_config_from_hf(cfg: dict) -> WhisperConfig:
    return WhisperConfig(
        name=cfg.get("_name_or_path", "custom"),
        n_mels=cfg["num_mel_bins"],
        n_vocab=cfg["vocab_size"],
        n_audio_ctx=cfg["max_source_positions"],
        n_audio_state=cfg["d_model"],
        n_audio_head=cfg["encoder_attention_heads"],
        n_audio_layer=cfg["encoder_layers"],
        n_text_ctx=cfg["max_target_positions"],
        n_text_state=cfg["d_model"],
        n_text_head=cfg["decoder_attention_heads"],
        n_text_layer=cfg["decoder_layers"],
        num_languages=100 if cfg["vocab_size"] == 51866 else 99,
    )


def _round_tree(tree: dict, dtype: torch.dtype) -> dict:
    """Every leaf rounded to ``dtype`` and kept as float32: the values the
    JAX loader's ``tree_map(jnp.asarray(x, dtype))`` holds, in the port's
    fp32 parameter storage."""
    if dtype == torch.float32:
        return tree
    return {
        k: _round_tree(v, dtype) if isinstance(v, dict) else torch.from_numpy(v).to(dtype).float().numpy()
        for k, v in tree.items()
    }


def read_whisper(name_or_path: str, dtype: torch.dtype = torch.float32, cache_dir: Optional[str] = None):
    """Local HF Whisper checkpoint → (numpy param tree in the JAX layout,
    config). With a ``dtype`` below fp32, the leaves carry the values the
    JAX loader casts them to (``load_whisper(..., dtype=bf16)``)."""
    path = resolve_checkpoint_dir(name_or_path, cache_dir)
    maybe_verify_checkpoint(path, name_or_path)
    with open(os.path.join(path, "config.json")) as f:
        config = whisper_config_from_hf(json.load(f))
    params = convert_whisper(load_state_dict(path), config)
    return _round_tree(params, dtype), config


def load_whisper(
    name_or_path: str,
    dtype: torch.dtype = torch.float32,
    cache_dir: Optional[str] = None,
    *,
    attn_impl: str = "auto",
    device: DeviceLike = None,
):
    """Local HF Whisper checkpoint → (port ``Whisper`` holding the weights,
    config). ``device=None`` means the card."""
    device = resolve_device(device)
    params, config = read_whisper(name_or_path, dtype, cache_dir)
    return whisper_from_jax(params, config, dtype=dtype, attn_impl=attn_impl, device=device), config


# ---------------------------------------------------------------------------
# wav2vec2
# ---------------------------------------------------------------------------


def _weight_norm_conv(sd: dict, prefix: str) -> np.ndarray:
    """Materialize a torch weight-normed conv1d weight (dim=2 convention)."""
    for g_name, v_name in (
        (prefix + ".weight_g", prefix + ".weight_v"),
        (prefix + ".parametrizations.weight.original0", prefix + ".parametrizations.weight.original1"),
    ):
        if g_name in sd:
            g, v = sd[g_name], sd[v_name]
            norm = np.sqrt((v**2).sum(axis=(0, 1), keepdims=True))
            return g * v / np.maximum(norm, 1e-12)
    return sd[prefix + ".weight"]


def convert_wav2vec2(sd: dict, config: Wav2Vec2Config) -> dict:
    """HF Wav2Vec2ForCTC state dict → the JAX param tree."""
    sd = {(k[len("wav2vec2."):] if k.startswith("wav2vec2.") else k): v for k, v in sd.items()}
    fe: dict[str, Any] = {}
    for i in range(len(config.conv_layers)):
        fe[f"conv_{i}"] = _conv1d(sd, f"feature_extractor.conv_layers.{i}.conv")
        ln_key = f"feature_extractor.conv_layers.{i}.layer_norm.weight"
        if ln_key in sd:
            fe[f"norm_{i}"] = _layernorm(sd, f"feature_extractor.conv_layers.{i}.layer_norm")

    params: dict[str, Any] = {
        "feature_extractor": fe,
        "feat_layer_norm": _layernorm(sd, "feature_projection.layer_norm"),
        "feat_projection": _linear(sd, "feature_projection.projection"),
        "pos_conv_embed": {
            "conv": {
                "kernel": _weight_norm_conv(sd, "encoder.pos_conv_embed.conv").transpose(2, 1, 0).astype(np.float32),
                "bias": sd["encoder.pos_conv_embed.conv.bias"].astype(np.float32),
            }
        },
        "encoder_layer_norm": _layernorm(sd, "encoder.layer_norm"),
        "lm_head": _linear(sd, "lm_head"),
    }
    for i in range(config.num_layers):
        p = f"encoder.layers.{i}"
        params[f"layers_{i}"] = {
            "attention": {
                "q_proj": _linear(sd, p + ".attention.q_proj"),
                "k_proj": _linear(sd, p + ".attention.k_proj"),
                "v_proj": _linear(sd, p + ".attention.v_proj"),
                "out_proj": _linear(sd, p + ".attention.out_proj"),
            },
            "layer_norm": _layernorm(sd, p + ".layer_norm"),
            "feed_forward": {
                "intermediate": _linear(sd, p + ".feed_forward.intermediate_dense"),
                "output": _linear(sd, p + ".feed_forward.output_dense"),
            },
            "final_layer_norm": _layernorm(sd, p + ".final_layer_norm"),
        }
    return params


def wav2vec2_config_from_hf(cfg: dict) -> Wav2Vec2Config:
    return Wav2Vec2Config(
        name=cfg.get("_name_or_path", "custom"),
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        conv_layers=tuple(zip(cfg["conv_dim"], cfg["conv_kernel"], cfg["conv_stride"])),
        conv_bias=cfg.get("conv_bias", False),
        do_stable_layer_norm=cfg.get("do_stable_layer_norm", False),
        feat_extract_norm=cfg.get("feat_extract_norm", "group"),
        num_conv_pos_embeddings=cfg.get("num_conv_pos_embeddings", 128),
        num_conv_pos_embedding_groups=cfg.get("num_conv_pos_embedding_groups", 16),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-5),
    )


def load_wav2vec2(
    name_or_path: str,
    cache_dir: Optional[str] = None,
    dtype: Optional[torch.dtype] = None,
    *,
    attn_impl: str = "auto",
    device: DeviceLike = None,
):
    """Local HF wav2vec2-CTC checkpoint → (port ``Wav2Vec2ForCTC`` holding
    the weights, char dictionary).

    ``dtype`` is the compute dtype: by default bf16 on the card (the JAX
    package's accelerator default; the emission head casts back to fp32
    before log-softmax), fp32 on the CPU. Parameters stay fp32.
    ``device=None`` means the card.
    """
    device = resolve_device(device)
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    path = resolve_checkpoint_dir(name_or_path, cache_dir)
    maybe_verify_checkpoint(path, name_or_path)
    with open(os.path.join(path, "config.json")) as f:
        config = wav2vec2_config_from_hf(json.load(f))
    params = convert_wav2vec2(load_state_dict(path), config)
    with open(os.path.join(path, "vocab.json")) as f:
        dictionary = json.load(f)
    return wav2vec2_from_jax(params, config, dtype=dtype, attn_impl=attn_impl, device=device), dictionary


# ---------------------------------------------------------------------------
# the port's modules from a JAX-layout tree
# ---------------------------------------------------------------------------


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
