"""Plain reference of Whisper: log-mel front end, encoder, and the decoder
run teacher-forced over a prompt and a token sequence.

Plain PyTorch in float32 (TF32 off: ``reference.precision``), no cache, no
batching tricks, no kernels. It reads the weights the benchmark drew
(``benchlib/weights.py``'s names and layout) and dequantizes int8 leaves
itself; ``quant.lower`` gives the control's lower-precision weights. It
imports nothing of the program.

The architecture (openai/whisper, ``model.py``): two GELU convolutions
(the second of stride 2) and learned positions, pre-LN blocks of
self-attention and a 4x GELU MLP, a final LayerNorm; the decoder adds a
causal self-attention and a cross-attention to the encoder's states in each
block and ties its logits to the token embedding.

``beam_search`` is the reference's own beam search over the request's
allowed tokens: at each step the ``beam`` best continuations of all the
beams by their summed log-probs, as Whisper's beam search keeps them when
the end of text cannot be chosen.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import quant

SR = 16_000
N_FFT = 400
HOP = 160
N_SAMPLES = 30 * SR


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3)
    log = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), (200.0 / 3) * m)


def mel_filters(n_mels: int) -> np.ndarray:
    """librosa.filters.mel(sr=16000, n_fft=400, n_mels=n_mels): Slaney mel
    scale and normalization, (n_mels, 201)."""
    fft = np.linspace(0.0, SR / 2, N_FFT // 2 + 1)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SR / 2), n_mels + 2))
    diff = np.diff(pts)
    ramps = pts[:, None] - fft[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / diff[:-1, None], ramps[2:] / diff[1:, None]))
    return (w * (2.0 / (pts[2:] - pts[:-2]))[:, None]).astype(np.float32)


def log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """(B, 480000) float32 samples → (B, n_mels, 3000) Whisper log-mel."""
    window = torch.hann_window(N_FFT, periodic=True, device=audio.device)
    spec = torch.stft(audio, N_FFT, HOP, window=window, center=True, pad_mode="reflect", return_complex=True)
    power = spec[..., :-1].abs() ** 2
    mel = torch.from_numpy(mel_filters(n_mels)).to(audio.device) @ power
    log = torch.log10(torch.clamp(mel, min=1e-10))
    log = torch.maximum(log, log.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (log + 4.0) / 4.0


class Whisper:
    """``tree``: the benchmark's weights; ``cfg``: the configuration's HF-named
    sizes; ``precision``: "exact" (the weights as drawn, in fp32) or a
    ``quant.lower`` mode for the control."""

    def __init__(self, tree: dict, cfg: dict, precision: str = "exact"):
        self.tree, self.cfg, self.precision = tree, cfg, precision
        self.D = cfg["d_model"]
        self._w: dict = {}  # fp32 kernels, dequantized once

    def w(self, prefix: str) -> torch.Tensor:
        """The (in, out) fp32 kernel of projection ``prefix``."""
        if prefix not in self._w:
            k = self.tree[f"{prefix}.kernel"]
            w = k.float() * self.tree[f"{prefix}.kernel_scale"][None, :] if k.dtype == torch.int8 else k.float()
            self._w[prefix] = quant.lower(w, self.precision, axis=0)
        return self._w[prefix]

    def b(self, name: str):
        t = self.tree.get(name)
        return None if t is None else t.float()

    def dense(self, x, prefix, bias=True):
        y = quant.lower_input(x, self.precision) @ self.w(prefix)
        return y + self.b(f"{prefix}.bias") if bias else y

    def ln(self, x, prefix):
        return F.layer_norm(x, (x.shape[-1],), self.tree[f"{prefix}.scale"], self.tree[f"{prefix}.bias"], eps=1e-5)

    def qkv(self, x, prefix):
        if f"{prefix}.qkv.kernel" in self.tree:
            D = self.D
            y = self.dense(x, f"{prefix}.qkv")
            return y[..., :D], y[..., D : 2 * D], y[..., 2 * D :]
        return self.dense(x, f"{prefix}.query"), self.dense(x, f"{prefix}.key", bias=False), self.dense(x, f"{prefix}.value")

    def attend(self, q, k, v, heads, causal=False):
        B, Tq, D = q.shape
        Tk = k.shape[1]
        dh = D // heads
        low = lambda x: quant.lower_input(x, self.precision)  # noqa: E731
        q = low(q.reshape(B, Tq, heads, dh).transpose(1, 2))
        k = low(k.reshape(B, Tk, heads, dh).transpose(1, 2))
        v = v.reshape(B, Tk, heads, dh).transpose(1, 2)
        s = (q @ k.transpose(-1, -2)) / dh**0.5
        if causal:  # query j sits at position Tk - Tq + j
            s = s.masked_fill(torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).triu(Tk - Tq + 1), float("-inf"))
        return (low(torch.softmax(s, dim=-1)) @ low(v.transpose(-1, -2)).transpose(-1, -2)).transpose(1, 2).reshape(B, Tq, D)

    def conv(self, x, name, stride):
        k = quant.lower(self.tree[f"{name}.kernel"].float(), self.precision, axis=(1, 2))
        return F.gelu(F.conv1d(x, k, self.tree[f"{name}.bias"], stride=stride, padding=1))

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, n_mels, 3000) → (B, 1500, D) audio states."""
        c = self.cfg
        x = self.conv(mel, "encoder.conv1", 1)
        x = self.conv(x, "encoder.conv2", 2).transpose(1, 2)
        x = x + self.tree["encoder.positional_embedding"][: x.shape[1]]
        for i in range(c["encoder_layers"]):
            p = f"encoder.layers.{i}"
            q, k, v = self.qkv(self.ln(x, f"{p}.attn_ln"), f"{p}.attn")
            x = x + self.dense(self.attend(q, k, v, c["encoder_attention_heads"]), f"{p}.attn.out")
            x = x + self.dense(F.gelu(self.dense(self.ln(x, f"{p}.mlp_ln"), f"{p}.mlp.fc1")), f"{p}.mlp.fc2")
        return self.ln(x, "encoder.ln_post")

    def embedding(self) -> torch.Tensor:
        if "embedding" not in self._w:
            e = self.tree["decoder.token_embedding"]
            if e.dtype == torch.int8:
                e = e.float() * self.tree["decoder.token_embedding_scale"][:, None]
            self._w["embedding"] = quant.lower(e.float(), self.precision, axis=1)
        return self._w["embedding"]

    def cross_kv(self, states: torch.Tensor) -> list:
        """Each decoder layer's cross-attention keys and values of the audio
        states (B, 1500, D), computed once for all the positions."""
        return [(self.dense(states, f"decoder.layers.{i}.cross_attn.key", bias=False),
                 self.dense(states, f"decoder.layers.{i}.cross_attn.value"))
                for i in range(self.cfg["decoder_layers"])]

    def decode(self, cross: list, tokens: torch.Tensor, cache: list = None, beams: int = 1) -> tuple:
        """The decoder's final states (R, T, D) of ``tokens`` (R, T) at the
        positions after those ``cache`` holds, and the cache with them: each
        layer's self-attention keys and values (R, positions, D). Row r
        belongs to audio r // ``beams`` of ``cross`` (``cross_kv``; each
        (R / beams, 1500, D)): a row's queries attend to its audio's states."""
        c = self.cfg
        R, T = tokens.shape
        start = 0 if cache is None else cache[0][0].shape[1]
        x = self.embedding()[tokens] + self.tree["decoder.positional_embedding"][start : start + T]
        heads = c["decoder_attention_heads"]
        new = []
        for i in range(c["decoder_layers"]):
            p = f"decoder.layers.{i}"
            q, k, v = self.qkv(self.ln(x, f"{p}.attn_ln"), f"{p}.attn")
            if cache is not None:
                k, v = torch.cat([cache[i][0], k], 1), torch.cat([cache[i][1], v], 1)
            new.append((k, v))
            x = x + self.dense(self.attend(q, k, v, heads, causal=True), f"{p}.attn.out")
            q = self.dense(self.ln(x, f"{p}.cross_attn_ln"), f"{p}.cross_attn.query")
            ck, cv = cross[i]
            a = self.attend(q.reshape(R // beams, beams * T, self.D), ck, cv, heads)  # rows of one audio as queries
            x = x + self.dense(a.reshape(R, T, self.D), f"{p}.cross_attn.out")
            x = x + self.dense(F.gelu(self.dense(self.ln(x, f"{p}.mlp_ln"), f"{p}.mlp.fc1")), f"{p}.mlp.fc2")
        return self.ln(x, "decoder.ln"), new

    def logits(self, cross: list, tokens: torch.Tensor, last: int) -> torch.Tensor:
        """Teacher-forced logits (B, last, V) of the final ``last`` positions
        of ``tokens`` (B, T), given the rows' cross-attention keys and values
        (``cross_kv``; each (B, 1500, D))."""
        x, _ = self.decode(cross, tokens)
        return x[:, tokens.shape[1] - last :] @ self.embedding().t()

    def beam_search(self, cross: list, prompt: list, beam: int, steps: int, log_probs) -> tuple:
        """The ``beam`` best of the audios' (B) token sequences of ``steps``
        tokens after ``prompt``: at each step the ``beam`` best
        continuations over all beams of the summed log-probs that
        ``log_probs(logits (R, V), first)`` gives. Returns the best
        sequence of each audio (B, steps) and its summed log-prob (B,)."""
        B = cross[0][0].shape[0]
        tokens = torch.tensor(prompt, device=cross[0][0].device).expand(B, -1)
        x, cache = self.decode(cross, tokens)
        lp = log_probs(x[:, -1] @ self.embedding().t(), True)  # (B, V)
        V = lp.shape[-1]
        scores, tok = lp.topk(beam, dim=-1)  # distinct first tokens from the one prompt
        seqs = tok[:, :, None]
        cache = [(k.repeat_interleave(beam, 0), v.repeat_interleave(beam, 0)) for k, v in cache]
        for _ in range(steps - 1):
            x, cache = self.decode(cross, seqs[:, :, -1].reshape(B * beam, 1), cache, beam)
            lp = log_probs(x[:, -1] @ self.embedding().t(), False).reshape(B, beam, V)
            scores, flat = (scores[:, :, None] + lp).reshape(B, beam * V).topk(beam, dim=-1)
            src, tok = flat // V, flat % V
            seqs = torch.cat([torch.gather(seqs, 1, src[:, :, None].expand(-1, -1, seqs.shape[2])), tok[:, :, None]], 2)
            rows = (torch.arange(B, device=src.device)[:, None] * beam + src).reshape(-1)
            cache = [(k[rows], v[rows]) for k, v in cache]
        best = scores.argmax(dim=-1)
        return seqs[torch.arange(B), best], scores[torch.arange(B), best]
