"""Operations of the work a run asked for, from shapes alone, and the
card's published peak.

The counts are of the model's work, not of any kernel's: a chunk's encoder
pass and cross K/V, the prompt and ``beam`` rows of ``steps`` decoder
steps, wav2vec2 over each aligned chunk's own samples; padded batch rows
are left out. A later change that fuses or replaces a kernel is read
against the same work.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rate.
BF16_FLOPS = 989e12


def whisper_encoder(w: dict, frames: int = 3000) -> float:
    """FLOPs of one 30 s chunk through the encoder (convolutions, layers)."""
    D, F, M = w["d_model"], w["encoder_ffn_dim"], w["num_mel_bins"]
    T = frames // 2
    conv = 2 * 3 * M * D * frames + 2 * 3 * D * D * T
    layer = 2 * T * D * 3 * D + 2 * 2 * T * T * D + 2 * T * D * D + 2 * 2 * T * D * F
    return float(conv + w["encoder_layers"] * layer)


def whisper_cross_kv(w: dict, frames: int = 3000) -> float:
    D, T = w["d_model"], frames // 2
    return float(w["decoder_layers"] * 2 * 2 * T * D * D)


def whisper_decoder_row(w: dict, position: int, audio_ctx: int = 1500) -> float:
    """FLOPs of one decoder row at ``position`` (it attends to position + 1
    keys of its own and to the audio states), logits included."""
    D, F, V = w["d_model"], w["decoder_ffn_dim"], w["vocab_size"]
    layer = (2 * D * 3 * D + 2 * 2 * D * (position + 1) + 2 * D * D  # self-attention
             + 2 * D * D + 2 * 2 * D * audio_ctx + 2 * D * D  # cross-attention (query, scores and values, out)
             + 2 * 2 * D * F)
    return float(w["decoder_layers"] * layer + 2 * D * V)


def whisper_chunk(w: dict, prompt: int, beam: int, steps: int) -> float:
    """A chunk's decode: encoder, cross K/V, the prompt's rows, and ``beam``
    rows at each of ``steps`` positions after it."""
    total = whisper_encoder(w) + whisper_cross_kv(w)
    total += sum(whisper_decoder_row(w, p) for p in range(prompt))
    total += beam * sum(whisper_decoder_row(w, prompt + s) for s in range(steps))
    return total


def wav2vec2_frames(w: dict, samples: int) -> list:
    """Frame counts after each convolution."""
    out, n = [], samples
    for k, s in zip(w["conv_kernel"], w["conv_stride"]):
        n = (n - k) // s + 1
        out.append(n)
    return out


def wav2vec2_chunk(w: dict, samples: int) -> float:
    """FLOPs of wav2vec2 over one segment of ``samples`` samples."""
    D, F, V = w["hidden_size"], w["intermediate_size"], w["vocab_size"]
    lens = wav2vec2_frames(w, samples)
    cin, conv = 1, 0
    for dim, k, n in zip(w["conv_dim"], w["conv_kernel"], lens):
        conv += 2 * k * cin * dim * n
        cin = dim
    T = lens[-1]
    g, kp = w["num_conv_pos_embedding_groups"], w["num_conv_pos_embeddings"]
    head = 2 * T * cin * D + 2 * T * (D // g) * kp * D + 2 * T * D * V
    layer = 4 * 2 * T * D * D + 2 * 2 * T * T * D + 2 * 2 * T * D * F
    return float(conv + head + w["num_hidden_layers"] * layer)
