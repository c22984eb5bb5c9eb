"""Plain reference of wav2vec2-CTC emissions (HF ``Wav2Vec2ForCTC``).

Plain PyTorch in float32, reading the benchmark's weights: the strided
convolution stack (GroupNorm after the first convolution in "group" models,
LayerNorm after each in "layer" models), the feature LayerNorm and
projection, the grouped convolutional positions, post-LN (base) or pre-LN
(stable) transformer layers whose attention ignores padded frames, and the
CTC head, then a log-softmax. The GroupNorm runs over every frame of the
padded row, as HF's does for these models: a chunk's emissions depend on
the length its batch pads to, which the caller gives.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import quant


def frames(n: int, cfg: dict) -> int:
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        n = (n - k) // s + 1
    return n


class Wav2Vec2:
    def __init__(self, tree: dict, cfg: dict, precision: str = "exact"):
        self.tree, self.cfg, self.precision = tree, cfg, precision

    def ln(self, x, prefix):
        return F.layer_norm(x, (x.shape[-1],), self.tree[f"{prefix}.scale"], self.tree[f"{prefix}.bias"], eps=self.cfg["layer_norm_eps"])

    def dense(self, x, prefix):
        w = quant.lower(self.tree[f"{prefix}.kernel"].float(), self.precision, axis=0)
        return quant.lower_input(x, self.precision) @ w + self.tree[f"{prefix}.bias"]

    def log_probs(self, audio: torch.Tensor, lengths: list) -> torch.Tensor:
        """(B, L) zero-padded float32 samples and each row's sample count →
        (B, T', V) log-softmax emissions."""
        c, t = self.cfg, self.tree
        B, L = audio.shape
        keep = torch.arange(L, device=audio.device)[None, :] < torch.tensor(lengths, device=audio.device)[:, None]
        x = torch.where(keep, audio, 0.0)[:, None, :]
        for i, s in enumerate(c["conv_stride"]):
            k = quant.lower(t[f"feature_extractor.conv_{i}.kernel"].float(), self.precision, axis=(1, 2))
            x = F.conv1d(x, k, t.get(f"feature_extractor.conv_{i}.bias"), stride=s)
            if c["feat_extract_norm"] == "group" and i == 0:
                x = F.group_norm(x, x.shape[1], t["feature_extractor.norm_0.scale"], t["feature_extractor.norm_0.bias"], eps=c["layer_norm_eps"])
            elif c["feat_extract_norm"] == "layer":
                x = self.ln(x.transpose(1, 2), f"feature_extractor.norm_{i}").transpose(1, 2)
            x = F.gelu(x)
        T = x.shape[2]
        valid = torch.arange(T, device=x.device)[None, :] < torch.tensor([frames(n, c) for n in lengths], device=x.device)[:, None]
        x = self.dense(self.ln(x.transpose(1, 2), "feat_layer_norm"), "feat_projection")
        kpos = quant.lower(t["pos_conv_embed.conv.kernel"].float(), self.precision, axis=(1, 2))
        pos = F.conv1d(x.transpose(1, 2), kpos, t["pos_conv_embed.conv.bias"], padding=c["num_conv_pos_embeddings"] // 2,
                       groups=c["num_conv_pos_embedding_groups"])
        if c["num_conv_pos_embeddings"] % 2 == 0:
            pos = pos[:, :, :-1]
        x = x + F.gelu(pos).transpose(1, 2)
        stable = c["do_stable_layer_norm"]
        if not stable:
            x = self.ln(x, "encoder_layer_norm")
        H = c["num_attention_heads"]
        for i in range(c["num_hidden_layers"]):
            p = f"layers.{i}"
            h = self.ln(x, f"{p}.layer_norm") if stable else x
            a = self.attention(h, f"{p}.attention", H, valid)
            x = x + a if stable else self.ln(x + a, f"{p}.layer_norm")
            h = self.ln(x, f"{p}.final_layer_norm") if stable else x
            f = self.dense(F.gelu(self.dense(h, f"{p}.feed_forward.intermediate")), f"{p}.feed_forward.output")
            x = x + f if stable else self.ln(x + f, f"{p}.final_layer_norm")
        if stable:
            x = self.ln(x, "encoder_layer_norm")
        return torch.log_softmax(self.dense(x, "lm_head"), dim=-1)

    def attention(self, x, prefix, heads, valid):
        B, T, D = x.shape
        dh = D // heads
        low = lambda x: quant.lower_input(x, self.precision)  # noqa: E731
        q, k, v = (self.dense(x, f"{prefix}.{n}_proj").reshape(B, T, heads, dh).transpose(1, 2) for n in ("q", "k", "v"))
        s = (low(q) @ low(k).transpose(-1, -2)) / dh**0.5
        s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
        out = (low(torch.softmax(s, dim=-1)) @ low(v.transpose(-1, -2)).transpose(-1, -2)).transpose(1, 2).reshape(B, T, D)
        return self.dense(out, f"{prefix}.out_proj")
