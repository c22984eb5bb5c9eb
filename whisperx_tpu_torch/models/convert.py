"""Checkpoint loading: HF files → the JAX package's parameter tree → the
port's modules.

Two halves. The HF half ports ``whisperx_tpu/models/convert.py:36-346``:
local checkpoint directories (safetensors or torch pickles; no network) are
read into state dicts and transposed into the numpy tree the JAX converter
gives (torch ``nn.Linear.weight`` (out, in) → Dense kernel (in, out); conv1d
(out, in, k) → (k, in, out); LayerNorm weight/bias → scale/bias).
Safetensors files are parsed here (an 8-byte little-endian header length, a
JSON header, raw little-endian buffers), so loading needs no ``safetensors``
package. The pyannote PyanNet and WeSpeaker ResNet34 converters
(``whisperx_tpu/models/convert.py:349-501``) give the JAX package's trees
the same way.

The second half builds the port's modules from such a tree.
The tree is the nested dict ``whisperx_tpu`` keeps, given as numpy arrays.
PyanNet and ResNet34 trees map explicitly (:func:`pyannet_from_jax`,
:func:`resnet34_from_jax`); Whisper and wav2vec2 trees by name, below.
For Whisper (``{"encoder": {...}, "decoder": {...}}`` with ``layers_<i>``
subtrees) it may be fp, int8- or int4-quantized
(:func:`..models.whisper.quantize_params`) and/or fused-QKV
(:func:`..models.whisper.fuse_qkv_params`); for wav2vec2 it is the Flax
``Wav2Vec2ForCTC`` tree, fp or int8
(:func:`..models.wav2vec2.quantize_wav2vec2_params`). The port's modules then compute the same function
as the JAX modules with those parameters.

Layout changes, leaf by leaf:
- Conv kernels: Flax stores (W, I, O); the port stores torch's (O, I, W).
- Dense kernels keep (K, N) = (in, out): the layout the int8 kernel reads;
  int4 ones are packed two to a byte along K, (K / 2, N).
- Everything else (embeddings, scales, biases, LayerNorms) is copied as is.

With a ``mesh`` (``parallel.make_mesh``), :func:`whisper_from_jax` and
:func:`wav2vec2_from_jax` build this rank's tensor-parallel slice of the
model from :func:`local_params`.
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
from ..diarize.embed import ResNet34Embedding
from ..ops.quant import PACKED_INT4, pack_int4, unpack_int4
from ..parallel.mesh import axis_index, axis_size
from ..parallel.partition import W2V2_RULES, WHISPER_RULES, shard_leaf, shard_params
from .configs import Wav2Vec2Config, WhisperConfig
from .vad_net import PyanNetVAD
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


_SAFETENSORS_CODES = {np.dtype(v).str: k for k, v in _SAFETENSORS_DTYPES.items()}


def write_safetensors(path: str, tensors) -> None:
    """Write a ``.safetensors`` file by hand, one tensor at a time (no
    package needed): an 8-byte little-endian header length, the JSON header
    (padded with spaces to 8 bytes), then the raw little-endian buffers in
    order. ``tensors`` is a list of ``(name, shape, dtype, make)``: ``dtype``
    a numpy dtype of ``read_safetensors``' table, ``make()`` the array
    (called once, in the list's order, only while its bytes are written, so
    that a large file never sits in memory whole)."""
    header, offset = {}, 0
    for name, shape, dtype, _ in tensors:
        code = _SAFETENSORS_CODES.get(np.dtype(dtype).newbyteorder("<").str)
        if code is None:
            raise ValueError(f"{path}: tensor {name!r} has a type safetensors does not name: {np.dtype(dtype)}")
        n = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
        header[name] = {"dtype": code, "shape": [int(d) for d in shape], "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(np.uint64(len(blob)).astype("<u8").tobytes() + blob)
        for name, shape, dtype, make in tensors:
            arr = np.asarray(make(), np.dtype(dtype).newbyteorder("<"), order="C")  # keeps a 0-d shape
            if arr.shape != tuple(shape):
                raise ValueError(f"{path}: tensor {name!r} is {arr.shape}, its header says {tuple(shape)}")
            f.write(arr.tobytes())


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
    device: DeviceLike = None,
):
    """Local HF Whisper checkpoint → (port ``Whisper`` holding the weights,
    config). ``device=None`` means the card."""
    device = resolve_device(device)
    params, config = read_whisper(name_or_path, dtype, cache_dir)
    return whisper_from_jax(params, config, dtype=dtype, device=device), config


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
    return wav2vec2_from_jax(params, config, dtype=dtype, device=device), dictionary


# ---------------------------------------------------------------------------
# pyannote segmentation (VAD)
# ---------------------------------------------------------------------------


def _lstm_layer(sd, l: int, reverse: bool) -> dict:
    sfx = f"l{l}" + ("_reverse" if reverse else "")
    return {
        "w_ih": sd[f"lstm.weight_ih_{sfx}"].astype(np.float32),
        "w_hh": sd[f"lstm.weight_hh_{sfx}"].astype(np.float32),
        "b_ih": sd[f"lstm.bias_ih_{sfx}"].astype(np.float32),
        "b_hh": sd[f"lstm.bias_hh_{sfx}"].astype(np.float32),
    }


def convert_pyannet(sd: dict) -> tuple[dict, int]:
    """pyannote PyanNet checkpoint → (the JAX param tree, num_classes)."""
    sd = {(k[len("model."):] if k.startswith("model.") else k): v for k, v in sd.items()}

    def sinc_param(name):
        for key in (f"sincnet.conv1d.0.filterbank.{name}", f"sincnet.conv1d.0.{name}"):
            if key in sd:
                return sd[key].astype(np.float32)
        raise KeyError(name)

    num_classes = sd["classifier.weight"].shape[0]
    lstm_layers = max(int(k.split("_l")[-1].replace("_reverse", "")) for k in sd if k.startswith("lstm.weight_ih")) + 1

    params: dict[str, Any] = {
        "wav_norm": {
            "scale": sd["sincnet.wav_norm1d.weight"].reshape(-1).astype(np.float32),
            "bias": sd["sincnet.wav_norm1d.bias"].reshape(-1).astype(np.float32),
        },
        "sinc": {"low_hz": sinc_param("low_hz_"), "band_hz": sinc_param("band_hz_")},
        "conv_1": _conv1d(sd, "sincnet.conv1d.1"),
        "conv_2": _conv1d(sd, "sincnet.conv1d.2"),
        "classifier": _linear(sd, "classifier"),
        "lstm": {},
    }
    for i in range(3):
        params[f"norm_{i}"] = {
            "scale": sd[f"sincnet.norm1d.{i}.weight"].reshape(-1).astype(np.float32),
            "bias": sd[f"sincnet.norm1d.{i}.bias"].reshape(-1).astype(np.float32),
        }
    for l in range(lstm_layers):
        params["lstm"][f"fwd_{l}"] = _lstm_layer(sd, l, False)
        params["lstm"][f"bwd_{l}"] = _lstm_layer(sd, l, True)
    for i in range(2):
        params[f"linear_{i}"] = _linear(sd, f"linear.{i}")
    return params, num_classes


def load_pyannet_vad(path: str, *, device: DeviceLike = None) -> PyanNetVAD:
    """Pinned segmentation checkpoint (whisperx/vad.py:18) → the port's
    ``PyanNetVAD`` holding its weights. ``device=None`` means the card."""
    device = resolve_device(device)
    params, _ = convert_pyannet(load_state_dict(path))
    return pyannet_from_jax(params, device=device)


# ---------------------------------------------------------------------------
# WeSpeaker ResNet34 speaker embedding (diarization)
# ---------------------------------------------------------------------------


def _conv2d(sd, prefix):
    """torch conv2d weight (out, in, kh, kw) → Flax kernel (kh, kw, in, out)."""
    return {"kernel": sd[prefix + ".weight"].transpose(2, 3, 1, 0).astype(np.float32)}


def _batchnorm(sd, prefix):
    """torch BN → (params {scale,bias}, batch_stats {mean,var})."""
    return (
        {
            "scale": sd[prefix + ".weight"].astype(np.float32),
            "bias": sd[prefix + ".bias"].astype(np.float32),
        },
        {
            "mean": sd[prefix + ".running_mean"].astype(np.float32),
            "var": sd[prefix + ".running_var"].astype(np.float32),
        },
    )


def convert_wespeaker_resnet34(sd: dict) -> tuple[dict, dict]:
    """WeSpeaker ResNet34 state dict → (the JAX variables tree, model kwargs).

    Accepts the pyannote wrapper layout (``resnet.``-prefixed — the
    ``wespeaker-voxceleb-resnet34-LM`` checkpoint behind the reference's
    pyannote/speaker-diarization-3.1, whisperx/diarize.py:19) or a bare
    wespeaker export. The residual projection may be named ``shortcut`` or
    ``downsample``. Returns kwargs (embed_dim/base_channels/stage_blocks/
    two_emb_layer) inferred from the checkpoint.
    """
    for prefix in ("model.", "resnet.", "speaker_encoder."):
        if any(k.startswith(prefix) for k in sd):
            sd = {
                (k[len(prefix):] if k.startswith(prefix) else k): v for k, v in sd.items()
            }

    params: dict[str, Any] = {"conv1": _conv2d(sd, "conv1")}
    stats: dict[str, Any] = {}
    params["bn1"], stats["bn1"] = _batchnorm(sd, "bn1")

    stage_blocks = []
    for stage in range(1, 5):
        n_blocks = len(
            {k.split(".")[1] for k in sd if k.startswith(f"layer{stage}.")}
        )
        stage_blocks.append(n_blocks)
        for b in range(n_blocks):
            src = f"layer{stage}.{b}"
            dst = f"layer{stage}_{b}"
            block_p: dict[str, Any] = {"conv1": _conv2d(sd, src + ".conv1")}
            block_s: dict[str, Any] = {}
            block_p["bn1"], block_s["bn1"] = _batchnorm(sd, src + ".bn1")
            block_p["conv2"] = _conv2d(sd, src + ".conv2")
            block_p["bn2"], block_s["bn2"] = _batchnorm(sd, src + ".bn2")
            for proj in ("shortcut", "downsample"):
                if src + f".{proj}.0.weight" in sd:
                    block_p["shortcut_conv"] = _conv2d(sd, src + f".{proj}.0")
                    block_p["shortcut_bn"], block_s["shortcut_bn"] = _batchnorm(
                        sd, src + f".{proj}.1"
                    )
                    break
            params[dst] = block_p
            stats[dst] = block_s

    params["seg_1"] = _linear(sd, "seg_1")
    kwargs = {
        "embed_dim": int(sd["seg_1.weight"].shape[0]),
        "base_channels": int(sd["conv1.weight"].shape[0]),
        "stage_blocks": tuple(stage_blocks),
        "two_emb_layer": "seg_2.weight" in sd,
    }
    if kwargs["two_emb_layer"]:
        params["seg_bn_1"], stats["seg_bn_1"] = _batchnorm(sd, "seg_bn_1")
        params["seg_2"] = _linear(sd, "seg_2")
    return {"params": params, "batch_stats": stats}, kwargs


def load_wespeaker_resnet34(path: str, *, device: DeviceLike = None) -> ResNet34Embedding:
    """Speaker-embedding checkpoint → the port's ``ResNet34Embedding``
    holding its weights. Its ``n_mels`` (the fbank dim the net was trained
    on — 80 for the pyannote 3.1 checkpoint) is recovered from seg_1's input
    width, as the JAX loader does. ``device=None`` means the card."""
    device = resolve_device(device)
    variables, _ = convert_wespeaker_resnet34(load_state_dict(path))
    return resnet34_from_jax(variables, device=device)


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


def _is_int4(leaf) -> bool:
    """An int4 leaf of a JAX tree (``np.asarray`` of a ``jnp.int4`` array
    gives ml_dtypes' int4), read by its dtype's name."""
    return getattr(getattr(leaf, "dtype", None), "name", "") == "int4"


def torch_name(path: tuple) -> str:
    """JAX tree path → the port's parameter name (``layers_3`` → ``layers.3``)."""
    return re.sub(r"\blayers_(\d+)\b", r"layers.\1", ".".join(path))


@torch.no_grad()
def load_jax_params(model: nn.Module, params: dict) -> nn.Module:
    """Copy every leaf of ``params`` into ``model``; raises on a missing,
    extra or mis-shaped leaf. int4 kernels (int4 leaves, or int8 ones of
    values in [-8, 7]) are packed into the model's :data:`PACKED_INT4`
    kernels, on the model's device."""
    named = dict(model.named_parameters())
    seen = set()
    for path, leaf in _flatten(params):
        name = torch_name(path)
        if name not in named:
            raise KeyError(f"parameter {'/'.join(path)} has no counterpart {name!r} in the port")
        arr = np.asarray(leaf)
        if _is_int4(arr):
            arr = arr.astype(np.int8)
        if path[-1] == "kernel" and arr.ndim == 3:
            arr = arr.transpose(2, 1, 0)  # Flax conv (W, I, O) → torch (O, I, W)
        dst = named[name]
        src = torch.from_numpy(np.array(arr))  # a writable contiguous copy
        if dst.dtype == PACKED_INT4 and src.dtype == torch.int8 and src.ndim == 2 and src.shape[0] % 2 == 0:
            if arr.size and (arr.min() < -8 or arr.max() > 7):
                raise ValueError(f"{name}: int4 kernel values outside [-8, 7] (an int8 tree under quant_bits=4?)")
            src = pack_int4(src.to(dst.device), dim=0)
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


def jax_path(name: str) -> list[str]:
    """The port's parameter name → its JAX tree path (``layers.3`` →
    ``layers_3``): the inverse of :func:`torch_name`."""
    return re.sub(r"\blayers\.(\d+)\b", r"layers_\1", name).split(".")


def whisper_to_jax(model: nn.Module) -> dict:
    """The model's parameters as a numpy tree in the JAX package's layout:
    the inverse of :func:`load_jax_params` (conv kernels back to Flax's
    (W, I, O); packed int4 kernels unpacked to int8 arrays of their values,
    which ``whisper_from_jax(..., quant_bits=4)`` reads back), so that
    trained weights leave the port as the JAX package holds them
    (``utils/checkpoint.py:save_params`` writes such a tree)."""
    tree: dict = {}
    for name, p in model.named_parameters():
        p = p.detach()
        arr = (unpack_int4(p, dim=0) if p.dtype == PACKED_INT4 else p).cpu().numpy()
        path = jax_path(name)
        if path[-1] == "kernel" and arr.ndim == 3:
            arr = arr.transpose(2, 1, 0)  # torch conv (O, I, W) → Flax (W, I, O)
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return tree


def local_params(params: dict, mesh, rules) -> dict:
    """This rank's slices of ``params`` for the port's tensor-parallel
    modules: :func:`~..parallel.partition.shard_params`, then the ``bias``
    and ``kernel_scale`` of every kernel whose output dim was split are cut
    with it. (pjit adds a whole bias to split columns as it stands, so the
    wav2vec2 rules leave the q/k/v biases whole; a local module adds only
    its own columns'.)"""
    local = shard_params(params, mesh, rules)
    n, i = axis_size(mesh, "model"), axis_index(mesh, "model")

    def walk(full: dict, loc: dict) -> None:
        for name, child in loc.items():
            if isinstance(child, dict):
                walk(full[name], child)
        if "kernel" not in loc or np.ndim(loc["kernel"]) != 2:
            return
        cols = np.shape(full["kernel"])[1]
        if loc["kernel"].shape[1] != cols:
            for name in ("bias", "kernel_scale"):
                if name in loc and loc[name].shape == (cols,):
                    loc[name] = shard_leaf(loc[name], ("model",), n, i)

    walk(params, local)
    return local


def whisper_from_jax(
    params: dict,
    config: WhisperConfig,
    *,
    dtype: torch.dtype = torch.float32,
    quant_bits: Optional[int] = None,
    device: DeviceLike = None,
    mesh=None,
) -> Whisper:
    """A port ``Whisper`` holding ``params`` (numpy tree, JAX layout).

    Quantization (per stack) and QKV fusion are read off the tree, and so is
    the width with ``quant_bits=None``: 4 if a leaf is int4 (a JAX int4 tree
    through ``np.asarray``), else 8. ``quant_bits=4`` reads int8-valued int4
    kernels (``quantize_params(..., bits=4)``). ``device=None`` means the
    card. With ``mesh``, the model is this rank's slice under
    ``WHISPER_RULES`` (quantize first, then split: column splits take their
    slice of ``kernel_scale``, row splits keep it whole); a fused-QKV tree
    does not split, so fuse only without a "model" axis.
    """
    if mesh is not None:
        params = local_params(params, mesh, WHISPER_RULES)
    q_enc = _has_key(params["encoder"], "kernel_scale")
    q_dec = _has_key(params["decoder"], "kernel_scale")
    quantized = (q_enc and q_dec) or ("encoder" if q_enc else "decoder" if q_dec else False)
    fused = _has_key(params, "qkv")
    if quant_bits is None:
        quant_bits = 4 if any(_is_int4(leaf) for _, leaf in _flatten(params)) else 8
    model = Whisper(
        config, dtype=dtype, quantized=quantized, quant_bits=quant_bits, fused_qkv=fused, device=device, mesh=mesh
    )
    return load_jax_params(model, params)


def wav2vec2_from_jax(
    params: dict,
    config: Wav2Vec2Config,
    *,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
    mesh=None,
) -> Wav2Vec2ForCTC:
    """A port ``Wav2Vec2ForCTC`` holding ``params`` (numpy tree, the Flax
    layout of ``whisperx_tpu/models/wav2vec2.py``): the int8 model when the
    tree holds ``kernel_scale`` leaves (``quantize_wav2vec2``'s tree), the
    fp one otherwise. ``device=None`` means the card. With ``mesh``, the
    model is this rank's slice under ``W2V2_RULES``."""
    if mesh is not None:
        params = local_params(params, mesh, W2V2_RULES)
    quantized = _has_key(params, "kernel_scale")
    model = Wav2Vec2ForCTC(config, dtype=dtype, quantized=quantized, device=device, mesh=mesh)
    return load_jax_params(model, params)


def _module_from_state(model: nn.Module, sd: dict, device: torch.device) -> nn.Module:
    """``sd`` (numpy, the module's own names) loaded strictly: a missing,
    extra or mis-shaped entry raises."""
    keys = model.load_state_dict({k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}, strict=False)
    missing = [k for k in keys.missing_keys if not k.endswith("num_batches_tracked")]
    if missing or keys.unexpected_keys:
        raise KeyError(f"tree does not fit the module: missing {missing[:5]}, extra {keys.unexpected_keys[:5]}")
    return model.to(device).eval()


def pyannet_from_jax(params: dict, *, device: DeviceLike = None) -> PyanNetVAD:
    """A port ``PyanNetVAD`` holding ``params`` (numpy, the tree of
    ``whisperx_tpu/models/vad_net.py:PyanNetVAD``): Conv1d kernel
    (k, in, out) → weight (out, in, k), Dense kernel (in, out) → Linear
    weight (out, in); the LSTM's (w_ih, w_hh, b_ih, b_hh) per layer and
    direction are torch's own layout. ``device=None`` means the card."""
    dev = resolve_device(device)
    layers = len(params["lstm"]) // 2
    model = PyanNetVAD(num_classes=params["classifier"]["kernel"].shape[1], lstm_layers=layers)
    sd = {
        "sincnet.wav_norm1d.weight": params["wav_norm"]["scale"],
        "sincnet.wav_norm1d.bias": params["wav_norm"]["bias"],
        "sincnet.conv1d.0.low_hz_": params["sinc"]["low_hz"],
        "sincnet.conv1d.0.band_hz_": params["sinc"]["band_hz"],
        "classifier.weight": params["classifier"]["kernel"].T,
        "classifier.bias": params["classifier"]["bias"],
    }
    for i in range(3):
        sd[f"sincnet.norm1d.{i}.weight"] = params[f"norm_{i}"]["scale"]
        sd[f"sincnet.norm1d.{i}.bias"] = params[f"norm_{i}"]["bias"]
    for i in (1, 2):
        sd[f"sincnet.conv1d.{i}.weight"] = params[f"conv_{i}"]["kernel"].transpose(2, 1, 0)
        sd[f"sincnet.conv1d.{i}.bias"] = params[f"conv_{i}"]["bias"]
    for l in range(layers):
        for direction, sfx in (("fwd", ""), ("bwd", "_reverse")):
            p = params["lstm"][f"{direction}_{l}"]
            sd[f"lstm.weight_ih_l{l}{sfx}"], sd[f"lstm.weight_hh_l{l}{sfx}"] = p["w_ih"], p["w_hh"]
            sd[f"lstm.bias_ih_l{l}{sfx}"], sd[f"lstm.bias_hh_l{l}{sfx}"] = p["b_ih"], p["b_hh"]
    for i in range(len(model.linear)):
        sd[f"linear.{i}.weight"] = params[f"linear_{i}"]["kernel"].T
        sd[f"linear.{i}.bias"] = params[f"linear_{i}"]["bias"]
    return _module_from_state(model, sd, dev)


def resnet34_from_jax(variables: dict, *, device: DeviceLike = None) -> ResNet34Embedding:
    """A port ``ResNet34Embedding`` holding ``variables`` (numpy, the
    {"params", "batch_stats"} tree of
    ``whisperx_tpu/diarize/embed.py:ResNet34Embedding``): Conv2d kernel
    (kh, kw, in, out) → weight (out, in, kh, kw), Dense kernel (in, out) →
    Linear weight (out, in), BN scale/bias → weight/bias and batch_stats
    mean/var → running_mean/running_var. The widths, depths and fbank bins
    are read off the tree. ``device=None`` means the card."""
    dev = resolve_device(device)
    params, stats = variables["params"], variables["batch_stats"]
    stage_blocks = tuple(
        sum(1 for k in params if k.startswith(f"layer{s}_")) for s in range(1, 5) if f"layer{s}_0" in params
    )
    base = params["conv1"]["kernel"].shape[-1]
    c_final = base * 2 ** (len(stage_blocks) - 1)
    seg_in, embed_dim = params["seg_1"]["kernel"].shape
    n_mels = (seg_in // (2 * c_final)) * 2 ** (len(stage_blocks) - 1)
    model = ResNet34Embedding(
        embed_dim=embed_dim, base_channels=base, stage_blocks=stage_blocks,
        two_emb_layer="seg_2" in params, n_mels=n_mels,
    )
    sd: dict = {}

    def conv(dst, p):
        sd[dst + ".weight"] = p["kernel"].transpose(3, 2, 0, 1)

    def bn(dst, p, st):
        sd[dst + ".weight"], sd[dst + ".bias"] = p["scale"], p["bias"]
        sd[dst + ".running_mean"], sd[dst + ".running_var"] = st["mean"], st["var"]

    def dense(dst, p):
        sd[dst + ".weight"], sd[dst + ".bias"] = p["kernel"].T, p["bias"]

    conv("conv1", params["conv1"])
    bn("bn1", params["bn1"], stats["bn1"])
    for s, blocks in enumerate(stage_blocks, start=1):
        for b in range(blocks):
            src, dst = params[f"layer{s}_{b}"], f"layer{s}.{b}"
            st = stats[f"layer{s}_{b}"]
            conv(dst + ".conv1", src["conv1"])
            conv(dst + ".conv2", src["conv2"])
            bn(dst + ".bn1", src["bn1"], st["bn1"])
            bn(dst + ".bn2", src["bn2"], st["bn2"])
            if "shortcut_conv" in src:
                conv(dst + ".shortcut.0", src["shortcut_conv"])
                bn(dst + ".shortcut.1", src["shortcut_bn"], st["shortcut_bn"])
    dense("seg_1", params["seg_1"])
    if "seg_2" in params:
        bn("seg_bn_1", params["seg_bn_1"], stats["seg_bn_1"])
        dense("seg_2", params["seg_2"])
    return _module_from_state(model, sd, dev)
