"""Bytes a beam step of the decode loop must move, from shapes alone, and
the card's published memory bandwidth.

The count is of the step's work, not of any kernel's: each byte the step
must read once (the decoder's projection kernels and the token table, the
cross K/V of the batch's audio rows, the self cache's filled slots) and
the logits it writes. What the loop's kernels read again, or read of the
static cache beyond the filled slots, is not counted; nor are the
vectors (biases, LayerNorm parameters, the int8 kernels' and table's
scales), under 0.5% of the bytes. A later kernel is read against the same
work.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: 80 GB of HBM3 at 3.35 TB/s.
HBM_BYTES_PER_S = 3.35e12


def decoder_weights(w: dict) -> int:
    """Weights a step reads: each decoder layer's self-attention q, k, v and
    out, cross-attention query and out (its K/V projections ran once, with
    the encoder), fc1 and fc2, and the tied token table."""
    D, F, V = w["d_model"], w["decoder_ffn_dim"], w["vocab_size"]
    layer = 4 * D * D + 2 * D * D + 2 * D * F
    return w["decoder_layers"] * layer + V * D


def beam_step(w: dict, rows: int, audio_rows: int, position: int, weight_bytes: int, kv_bytes: int) -> int:
    """Bytes of one step of ``rows`` decoder rows (beams x audio rows) whose
    token goes to self-cache slot ``position``: the weights at
    ``weight_bytes`` a weight, the cross K/V of ``audio_rows`` (shared by
    their beams) and the self cache's ``position + 1`` filled slots at
    ``kv_bytes`` a value (an int8 cache adds an fp32 scale a token and
    head), and the fp32 logits written."""
    D, H, S, V, L = (w["d_model"], w["decoder_attention_heads"], w["max_source_positions"], w["vocab_size"],
                     w["decoder_layers"])
    token = D * kv_bytes + (4 * H if kv_bytes == 1 else 0)  # one position's K or V of one row
    cross = L * 2 * audio_rows * S * token
    cache = L * 2 * rows * (position + 1) * token
    return decoder_weights(w) * weight_bytes + cross + cache + 4 * rows * V


def beam_loop(w: dict, rows: int, audio_rows: int, start: int, steps: int, weight_bytes: int, kv_bytes: int) -> int:
    """Bytes of ``steps`` steps from slot ``start`` on (the prompt's length:
    the prompt pass filled the slots before it)."""
    return sum(beam_step(w, rows, audio_rows, start + s, weight_bytes, kv_bytes) for s in range(steps))
