"""Seeded random weights, made on the device in a few large draws.

The benchmark owns the weights: it lays them out by its own table of
shapes (the parameter names of the port's modules, so they load with a
strict ``load_state_dict``), draws them from ``--seed`` with a
``torch.Generator`` on the card, and hands the same tensors to the program
and, drawn again after the window, to the plain reference.

Values are in the type they are served in. int8 kernels are integers of
a normal law (sigma ``int8_sigma``) clipped to +-127 with per-output-column
fp32 scales (per-row for the token embedding); float leaves are normal,
rounded to bfloat16 where the model computes in bfloat16 (the program casts
fp32 parameters to its compute type), and kept as fp32 tensors.
"""

from __future__ import annotations

from typing import Iterator

import torch

BLOCK = 1 << 26  # elements a draw makes at once


def _stream(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + stream * 7_919) % (2**63))
    return g


def whisper_leaves(w: dict, quantized: bool, fused_qkv: bool) -> list:
    """(name, shape, kind, std) of every parameter of a Whisper, where kind is
    one of dense (a projection kernel), bias, zero, ln_scale, ln_bias, emb,
    pos, conv."""
    D, V = w["d_model"], w["vocab_size"]
    out = []

    def dense(prefix, i, o, bias=True):
        out.append((f"{prefix}.kernel", (i, o), "dense", 0.02))
        if quantized:
            out.append((f"{prefix}.kernel_scale", (o,), "col_scale", 0.02))
        if bias:
            out.append((f"{prefix}.bias", (o,), "bias", 0.02))

    def ln(prefix, d):
        out.append((f"{prefix}.scale", (d,), "ln_scale", 0.05))
        out.append((f"{prefix}.bias", (d,), "bias", 0.02))

    def attn(prefix, fused):
        if fused:
            dense(f"{prefix}.qkv", D, 3 * D)  # the key third of the bias is zeroed
        else:
            dense(f"{prefix}.query", D, D)
            dense(f"{prefix}.key", D, D, bias=False)
            dense(f"{prefix}.value", D, D)
        dense(f"{prefix}.out", D, D)

    def mlp(prefix, ffn):
        dense(f"{prefix}.fc1", D, ffn)
        dense(f"{prefix}.fc2", ffn, D)

    out.append(("encoder.conv1.kernel", (D, w["num_mel_bins"], 3), "conv", 0.02))
    out.append(("encoder.conv1.bias", (D,), "bias", 0.02))
    out.append(("encoder.conv2.kernel", (D, D, 3), "conv", 0.02))
    out.append(("encoder.conv2.bias", (D,), "bias", 0.02))
    out.append(("encoder.positional_embedding", (w["max_source_positions"], D), "pos", 0.02))
    for i in range(w["encoder_layers"]):
        p = f"encoder.layers.{i}"
        ln(f"{p}.attn_ln", D)
        attn(f"{p}.attn", fused_qkv)
        ln(f"{p}.mlp_ln", D)
        mlp(f"{p}.mlp", w["encoder_ffn_dim"])
    ln("encoder.ln_post", D)
    out.append(("decoder.token_embedding", (V, D), "emb", 0.02))
    if quantized:
        out.append(("decoder.token_embedding_scale", (V,), "row_scale", 0.02))
    out.append(("decoder.positional_embedding", (w["max_target_positions"], D), "pos", 0.02))
    for i in range(w["decoder_layers"]):
        p = f"decoder.layers.{i}"
        ln(f"{p}.attn_ln", D)
        attn(f"{p}.attn", fused_qkv)
        ln(f"{p}.cross_attn_ln", D)
        attn(f"{p}.cross_attn", False)
        ln(f"{p}.mlp_ln", D)
        mlp(f"{p}.mlp", w["decoder_ffn_dim"])
    ln("decoder.ln", D)
    return out


def wav2vec2_leaves(w: dict, emission_scale: float) -> list:
    """(name, shape, kind, std) of a wav2vec2-CTC's parameters: kernels
    normal with std 1/sqrt(fan in), the CTC head's times ``emission_scale``."""
    D, F = w["hidden_size"], w["intermediate_size"]
    out = []

    def dense(prefix, i, o, scale=1.0):
        out.append((f"{prefix}.kernel", (i, o), "dense", scale / i**0.5))
        out.append((f"{prefix}.bias", (o,), "bias", 0.02))

    def ln(prefix, d):
        out.append((f"{prefix}.scale", (d,), "ln_scale", 0.05))
        out.append((f"{prefix}.bias", (d,), "bias", 0.02))

    cin = 1
    for i, (dim, k) in enumerate(zip(w["conv_dim"], w["conv_kernel"])):
        out.append((f"feature_extractor.conv_{i}.kernel", (dim, cin, k), "conv", 1.0 / (cin * k) ** 0.5))
        if w["conv_bias"]:
            out.append((f"feature_extractor.conv_{i}.bias", (dim,), "bias", 0.02))
        if w["feat_extract_norm"] == "layer" or i == 0:
            ln(f"feature_extractor.norm_{i}", dim)
        cin = dim
    ln("feat_layer_norm", cin)
    dense("feat_projection", cin, D)
    k, g = w["num_conv_pos_embeddings"], w["num_conv_pos_embedding_groups"]
    out.append(("pos_conv_embed.conv.kernel", (D, D // g, k), "conv", 1.0 / (D // g * k) ** 0.5))
    out.append(("pos_conv_embed.conv.bias", (D,), "bias", 0.02))
    ln("encoder_layer_norm", D)
    for i in range(w["num_hidden_layers"]):
        p = f"layers.{i}"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense(f"{p}.attention.{n}", D, D)
        ln(f"{p}.layer_norm", D)
        dense(f"{p}.feed_forward.intermediate", D, F)
        dense(f"{p}.feed_forward.output", F, D)
        ln(f"{p}.final_layer_norm", D)
    dense("lm_head", D, w["vocab_size"], scale=emission_scale)
    return out


def _normals(gen: torch.Generator, sizes: list, device) -> Iterator[torch.Tensor]:
    """Consecutive slices of one stream of standard normals, one per size,
    drawn BLOCK elements at a time."""
    buf, pos = torch.empty(0, device=device), 0
    for n in sizes:
        parts, need = [], n
        while need:
            if pos == buf.numel():
                buf, pos = torch.randn(BLOCK, generator=gen, device=device), 0
            take = min(need, buf.numel() - pos)
            parts.append(buf[pos : pos + take])
            pos, need = pos + take, need - take
        yield parts[0] if len(parts) == 1 else torch.cat(parts)


def draw(leaves: list, seed: int, device, *, int8: bool, int8_sigma: float, bf16: bool, stream: int) -> dict:
    """The tensors of ``leaves`` drawn from ``seed`` on ``device``: int8
    dense kernels and the embedding when ``int8`` (with their scales),
    float leaves rounded to bf16 when ``bf16``."""
    gen = _stream(seed, stream, device)
    ugen = _stream(seed, stream + 1, device)
    tree = {}
    sizes = [int(torch.Size(shape).numel()) for _, shape, kind, _ in leaves if kind not in ("col_scale", "row_scale")]
    normals = _normals(gen, sizes, device)
    for name, shape, kind, std in leaves:
        if kind in ("col_scale", "row_scale"):
            u = torch.rand(shape, generator=ugen, device=device)
            tree[name] = (std / int8_sigma) * (0.8 + 0.4 * u)
            continue
        x = next(normals).reshape(shape)
        if int8 and kind in ("dense", "emb"):
            tree[name] = torch.round(x * int8_sigma).clamp_(-127, 127).to(torch.int8)
            continue
        x = x * std + (1.0 if kind == "ln_scale" else 0.0)
        if bf16:
            x = x.to(torch.bfloat16).float()
        tree[name] = x
    for name in tree:
        if name.endswith(".attn.qkv.bias"):
            D = tree[name].shape[0] // 3
            tree[name][D : 2 * D] = 0.0  # the key projection has no bias
    return tree
