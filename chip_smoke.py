#!/usr/bin/env python3
"""Drive whisperx_tpu_torch's main path on one NVIDIA GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. Needs one CUDA
card and nvcc ($CUDA_HOME or /usr/local/cuda), no network. Exits non-zero,
without the final ``ok`` line, on any failure: no card, the package missing,
a kernel that does not build, launch or agree, a wrong result.

Phases:
  1. build every CUDA kernel of the paths and the device loop's
     csrc/graph_loop.cu (one nvcc per source, in parallel);
  2. hold each kernel against its plain PyTorch version at the main paths'
     shapes (plus edge shapes), and time the kernel, the plain version and
     one PyTorch library call (the yardstick) with cold caches; the flash
     forward's lse output and the two flash backward kernels at the
     training shape (large-v2 encoder, batch 2); the CTC alignment kernel
     (csrc/ctc_align.cu, trellis + walk) at the alignment path's shapes,
     at a ragged batch and with its decision bits in a scratch buffer,
     beside its dependency bound; the decoder's self-attention kernel
     (csrc/self_attn_decode.cu) at the beam step's shapes on int8 and bf16
     caches: stored values and scales equal to the plain version's, the
     output within a bf16 ulp, timed over 32 layers' caches beside its
     byte bound;
  3. on small models, check that the card gives the CPU's results: decode
     tokens (kernels against plain versions) and fp32 alignment segments,
     words and timestamps; then bf16 alignment emissions (the flash route)
     against the card's fp32 model's (the plain route); then the production
     pipeline (VAD → transcribe → align on a 128-wide Whisper and wav2vec2,
     fp32): identical segments,
     tokens, words and timestamps; then diarization at published widths on
     a few windows (seeded ResNet34 + PyanNet, overlap-aware, and the
     weight-free default): identical turns and labels; then ``cli.cli``
     with --diarize on 128-wide HF directories: the six output files of
     --device cuda byte-equal to those of --device cpu; then three fp32
     AdamW steps of a 128-wide Whisper on the card and on the CPU (equal
     losses and parameters) and a save_params/load_params round trip;
  4. drive the decode path: Whisper large-v2 with random weights from a seed,
     int8 weights, fused QKV, int8 KV cache; batch 8 of 30 s int16 audio →
     log-mel → beam-5 decode of 112 tokens with EOT banned (bench.py's
     flagship) on the log-mel kernel and the port's routes (flash encoder
     attention, cross-attention kernel). The loop runs on the card (one
     WHILE-graph launch a batch, ops/graph_loop.py); the host loop runs on
     the same inputs (tokens, sum log-probs and lengths equal), and
     generate(sync=False) returns before the loop ends, with no read of the
     card between the launch and the fetch; then a sampled arm on the same
     model (greedy, batch 8 x 1, 112 tokens, temperatures 0.2 and 1.0):
     one kept sampling loop on the card for both temperatures,
     the device loop equal to the host loop, distinct candidates for the
     copies of one chunk, generate(sync=False) returning at launch;
  5. drive the alignment path: wav2vec2 base (published widths, random
     weights from seed 0, bf16) aligning bench.py's fixed transcript to 8 x
     30 s of int16 audio through align_begin(...).finish() (flash encoder
     attention); one launch of the CTC kernel a batch;
  6. drive the production pipeline through the user entry points (bench.py's
     BENCH_PIPELINE configuration): a 6-minute WAV file of bench.py's tone
     bursts → load_audio → SpeechBandVAD cut & merge → phase 4's large-v2
     model, beam 5, 112 tokens (EOT suppressed), batch 8 → align_begin(...)
     .finish() with phase 5's wav2vec2 base and bench.py's transcript per
     chunk, on the port's routes (the cross-attention kernel and flash
     encoder attention); once with the default options and once with
     enable_fallback=True (sampled retry batches on the device loop);
  7. drive the command line as a user runs ``python -m whisperx_tpu_torch
     <wav> --diarize``: ``cli.cli`` in-process on checkpoints written from
     seeds in their published layouts (large-v2 HF directory with fp16
     safetensors, wav2vec2 base HF directory, WeSpeaker ResNet34 and
     pyannote PyanNet ``.bin`` files) and a 6-minute two-speaker WAV file:
     neural VAD, int8 beam-5 decode of 224 tokens (EOT banned) with the
     port's defaults (the cross-attention kernel, flash encoder attention
     in both encoders), alignment,
     overlap-aware diarization, six output files; then ``python -m
     whisperx_tpu_torch --help``;
  8. drive the training step: ``train.make_train_step`` on Whisper large-v2
     (published widths and depth, fp32 masters from seed 0, bf16 compute),
     five AdamW steps on 2 x 30 s of random mel and 129 random tokens, at
     bf16 compute (flash encoder attention: the forward with lse and both
     backward kernels, 32 launches of each a step) against fp32 compute
     (the plain "xla" attention);
  9. (run after phase 7, whose files it reads) drive the int4 path through
     the entry points: ``load_model(...,
     compute_type="int4")`` on phase 7's large-v2 directory (every Dense
     kernel packed two to a byte) and ``load_align_model(...,
     compute_type="int8")`` on its wav2vec2 base directory; 5 minutes of
     phase 6's tone bursts (8 chunks, one decode batch), beam 5, 112 tokens
     (EOT banned), then alignment of the chunks and of one 1 s batch (the
     int8 wav2vec2's projections through int8_matmul); arm (a) with the int8
     KV cache (the cross-attention kernel), arm (b) with the int4 KV cache
     (the einsum), both with flash attention;
 10. (run after phase 9, on phase 7's files) drive parallel/ on the one card:
     (a) a world of one over NCCL in this process: ``load_model(...,
     compute_type="int8", mesh=make_mesh())`` transcribes phase 6's WAV,
     ``shard_align_model`` aligns it and ``DiarizationPipeline(mesh=)``
     diarizes it, equal to the same calls without a mesh; (b) two ranks
     sharing the card over gloo, mesh (1, 2), each a process of this script
     (``--parallel-rank``): large-v2 int8 with 10 heads a rank and unfused
     QKV, the 8-chunk batch at beam 5 and 112 tokens (EOT banned) with every
     kernel, then ``shard_align_model`` alignment (6 heads a rank, flash
     attention); both ranks equal, the first step's log-probs near the whole
     model's on this card; (c) 128-wide fp32 Whisper and wav2vec2 under that
     mesh equal to the CPU's single process.
Phase 2 also holds int8_matmul at the int8 wav2vec2 base's shapes and at
large-v2's tensor-parallel shard shapes, and cross-attention and flash at a
rank's heads (10 and 6); phase 3 also checks int4-weight and int4-KV decode
tokens and the int8 wav2vec2's alignment, card against CPU.
Every kernel's launch count is zeroed just before each run of a path and
read just after: the wrapper's count plus, for each device-loop launch,
(launches in the captured step) x (steps the loop's device counter reports).
Phases 4, 6, 7 and 9 decode on the device loop, sampled decodes (phase 4's
sampled arm, phase 6's fallback) included; phases 4 and 9 also hold it
equal to the host loop on the same inputs; phase 10 (b) (a model split over gloo)
runs the host loop.

Prints the card's name and power limit, one line per check, a ``kernels``
JSON line and, last, ``{"ok": true, "device": {...}}``. Every time is taken
on this card in this run.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
FP32_FLOPS = 67e12  # H100 SXM fp32 peak outside the tensor cores (NVIDIA data sheet)
KERNEL_SOURCES = ("int8_mm", "cross_attn", "flash_attn", "flash_attn_bwd", "log_mel", "graph_loop", "ctc_align", "self_attn_decode")
# bench.py's alignment transcript (bench.py:277-285): ~70 words per 30 s chunk.
_WORDS = ("the quick brown fox jumps over the lazy dog and runs far away "
          "while seven silent watchers record every single word spoken here ").split()
ALIGN_TEXT = " " + " ".join(_WORDS * 4)[:400]
PIPELINE_MINUTES = 6.0  # 9 VAD chunks: two decode batches of 8, the last one padded
M_STEP = 40  # rows of a decode projection in the beam step: batch 8 x beam 5
# Large-v2's decoder projections split over a model axis of 2 (K, N, bias):
# q/k/v and cross-q, fc1 by columns; out, cross-out and fc2 by rows.
TP_SHARDS = ((1280, 640, True), (1280, 2560, True), (640, 1280, False), (2560, 1280, False))


def pipeline_audio(minutes: float, seed: int = 0) -> np.ndarray:
    """bench.py's _pipeline_audio (bench.py:86-102): 15 s tone bursts (220 Hz
    carrier, 3 Hz syllabic AM at shallow depth) every 25 s; SpeechBandVAD
    packs burst pairs into ~25.6 s chunks."""
    sr = 16000
    n = int(minutes * 60 * sr)
    rng = np.random.default_rng(seed)
    audio = np.zeros(n, np.float32)
    tb = np.arange(15 * sr) / sr
    burst = (
        0.3 * np.sin(2 * np.pi * 220 * tb) * (0.75 + 0.25 * np.sin(2 * np.pi * 3 * tb))
        + 0.01 * rng.standard_normal(15 * sr)
    ).astype(np.float32)
    for start_s in range(0, int(minutes * 60) - 15, 25):
        audio[start_s * sr : (start_s + 15) * sr] = burst
    return audio


def align_transcript(n: int) -> list:
    """bench.py's alignment transcript over n 30 s chunks: segment i spans
    i*30+0.2 .. (i+1)*30-0.2 s."""
    return [{"start": i * 30.0 + 0.2, "end": (i + 1) * 30.0 - 0.2, "text": ALIGN_TEXT} for i in range(n)]


def align_frames(conv_layers, transcript: list) -> tuple[list, int]:
    """wav2vec2 frame counts of the transcript's rows, and the padded width
    of their batch, as align_begin cuts (int(s * 16 kHz)) and pads (to the
    next whole second) the audio."""

    def frames(n):
        for _, kernel, stride in conv_layers:
            n = (n - kernel) // stride + 1
        return n

    lens = [int(s["end"] * 16_000) - int(s["start"] * 16_000) for s in transcript]
    return [frames(n) for n in lens], frames(-(-max(lens) // 16_000) * 16_000)


# ---- checkpoints and audio written from seeds -------------------------------
# The card has no network and no checkpoints: phases 3 and 7 write HF,
# pyannote and WeSpeaker files in their published layouts from seeds, and the
# port's loaders read them back.

# The JAX tree's names → HF Whisper module names (convert_whisper inverted).
_HF_WHISPER_NAMES = {
    "attn": "self_attn", "cross_attn": "encoder_attn", "attn_ln": "self_attn_layer_norm",
    "cross_attn_ln": "encoder_attn_layer_norm", "mlp_ln": "final_layer_norm", "ln_post": "layer_norm",
    "ln": "layer_norm", "query": "q_proj", "key": "k_proj", "value": "v_proj", "out": "out_proj",
    "positional_embedding": "embed_positions", "token_embedding": "embed_tokens", "scale": "weight",
    "kernel": "weight",
}
# The JAX tree's names → HF Wav2Vec2ForCTC module names (convert_wav2vec2 inverted).
_HF_W2V_NAMES = {
    "feat_layer_norm": "feature_projection.layer_norm", "feat_projection": "feature_projection.projection",
    "encoder_layer_norm": "encoder.layer_norm", "pos_conv_embed": "encoder.pos_conv_embed",
    "intermediate": "intermediate_dense", "output": "output_dense", "scale": "weight", "kernel": "weight",
}


def _sorted_leaves(shapes: dict, prefix: tuple = ()):
    """(path, shape) of a shape tree in JAX's flattening order (sorted keys)."""
    for name in sorted(shapes):
        child = shapes[name]
        if isinstance(child, dict):
            yield from _sorted_leaves(child, prefix + (name,))
        else:
            yield prefix + (name,), tuple(child)


def _hf_whisper_key(path: tuple) -> str:
    parts = []
    for p in path:
        if p.startswith("layers_"):
            parts += ["layers", p[len("layers_"):]]
        elif p != "mlp":
            parts.append(_HF_WHISPER_NAMES.get(p, p))
    if path[-1] in ("positional_embedding", "token_embedding"):
        parts.append("weight")
    return "model." + ".".join(parts)


def _hf_w2v_key(path: tuple) -> str:
    if path[0] == "lm_head":
        return "lm_head." + _HF_W2V_NAMES.get(path[1], path[1])
    if path[0] == "feature_extractor":
        i = path[1].split("_")[1]
        sub = "conv" if path[1].startswith("conv_") else "layer_norm"
        return f"wav2vec2.feature_extractor.conv_layers.{i}.{sub}.{_HF_W2V_NAMES.get(path[2], path[2])}"
    parts = []
    for p in path:
        if p.startswith("layers_"):
            parts += ["encoder.layers", p[len("layers_"):]]
        else:
            parts.append(_HF_W2V_NAMES.get(p, p))
    return "wav2vec2." + ".".join(parts)


def _to_hf(path: tuple, arr: np.ndarray) -> np.ndarray:
    """A JAX-layout leaf in torch's layout: Dense (in, out) → (out, in),
    conv (k, in, out) → (out, in, k)."""
    if path[-1] == "kernel" and arr.ndim == 2:
        return arr.T
    if path[-1] == "kernel" and arr.ndim == 3:
        return arr.transpose(2, 1, 0)
    return arr


def write_hf_safetensors(path: str, leaves, key, draw, dtype: str) -> None:
    """A ``.safetensors`` file in the HF layout through the package's own
    writer (``models/convert.py:write_safetensors``, one tensor at a time):
    ``leaves`` is a list of (path, shape); ``draw(path, shape)`` gives each
    leaf in the JAX layout, called in the list's order; ``key(path)`` names
    it; ``dtype`` is "F16" or "F32"."""
    from whisperx_tpu_torch.models.convert import write_safetensors

    np_dtype = {"F16": np.float16, "F32": np.float32}[dtype]
    write_safetensors(path, [
        (key(p), _to_hf(p, np.empty(shape, np.uint8)).shape, np_dtype, lambda p=p, shape=shape: _to_hf(p, draw(p, shape)))
        for p, shape in leaves
    ])


def worded_vocab() -> dict:
    """A 50,257-entry byte-level BPE vocabulary: the 256 byte symbols, then
    letter strings with and without a leading space, so that every text id a
    random Whisper emits decodes to letters the aligner can place."""
    import itertools

    byte_symbols = [chr(c) for c in range(ord("!"), ord("~") + 1)] + [chr(c) for c in range(ord("\u00a1"), ord("\u00ac") + 1)]
    byte_symbols += [chr(c) for c in range(ord("\u00ae"), ord("\u00ff") + 1)]
    byte_symbols += [chr(256 + i) for i in range(256 - len(byte_symbols))]  # GPT-2's remap of the rest
    vocab = sorted(byte_symbols)
    seen = set(vocab)
    for n in itertools.count(1):
        for combo in itertools.product("abcdefghijklmnopqrstuvwxyz", repeat=n):
            for word in ("\u0120" + "".join(combo), "".join(combo)):
                if word not in seen and len(vocab) < 50257:
                    seen.add(word)
                    vocab.append(word)
        if len(vocab) == 50257:
            return {c: i for i, c in enumerate(vocab)}


def write_hf_whisper(path: str, cfg, seed: int = 0, scale: float = 0.02, dtype: str = "F16") -> str:
    """An HF Whisper checkpoint directory: config.json, model.safetensors with
    the leaves of ``models/whisper.py:random_params(cfg, seed, scale)`` (the
    same draws, in the same order; rounded to ``dtype``) under the HF names,
    and byte-level BPE files (:func:`worded_vocab`, no merges)."""
    from whisperx_tpu_torch.models.whisper import param_shapes

    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)

    def draw(p, shape):
        if p[-1] == "scale":
            return np.ones(shape, np.float32)
        if p[-1] == "bias":
            return np.zeros(shape, np.float32)
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    leaves = list(_sorted_leaves(param_shapes(cfg)))
    write_hf_safetensors(os.path.join(path, "model.safetensors"), leaves, _hf_whisper_key, draw, dtype)
    config = {
        "model_type": "whisper", "_name_or_path": cfg.name, "vocab_size": cfg.n_vocab, "num_mel_bins": cfg.n_mels,
        "d_model": cfg.n_audio_state, "encoder_layers": cfg.n_audio_layer, "encoder_attention_heads": cfg.n_audio_head,
        "decoder_layers": cfg.n_text_layer, "decoder_attention_heads": cfg.n_text_head,
        "encoder_ffn_dim": 4 * cfg.n_audio_state, "decoder_ffn_dim": 4 * cfg.n_text_state,
        "max_source_positions": cfg.n_audio_ctx, "max_target_positions": cfg.n_text_ctx,
    }
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(worded_vocab(), f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    return path


ALIGN_CHARS = ["<pad>", "|", "'"] + [chr(c) for c in range(ord("a"), ord("z") + 1)]


def write_hf_wav2vec2(path: str, cfg, seed: int = 0) -> str:
    """An HF Wav2Vec2ForCTC directory: config.json, model.safetensors (fp32)
    with the leaves of ``models/wav2vec2.py:random_params(cfg, seed)`` under
    the HF names, and a character vocab.json."""
    from whisperx_tpu_torch.models.wav2vec2 import param_shapes

    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)

    def draw(p, shape):
        if p[-1] == "scale":
            return np.ones(shape, np.float32)
        if p[-1] == "bias":
            return np.zeros(shape, np.float32)
        return (rng.standard_normal(shape) / np.sqrt(int(np.prod(shape[:-1])))).astype(np.float32)

    leaves = list(_sorted_leaves(param_shapes(cfg)))
    write_hf_safetensors(os.path.join(path, "model.safetensors"), leaves, _hf_w2v_key, draw, "F32")
    config = {
        "model_type": "wav2vec2", "_name_or_path": cfg.name, "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size, "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads, "intermediate_size": cfg.intermediate_size,
        "conv_dim": [c[0] for c in cfg.conv_layers], "conv_kernel": [c[1] for c in cfg.conv_layers],
        "conv_stride": [c[2] for c in cfg.conv_layers], "conv_bias": cfg.conv_bias,
        "do_stable_layer_norm": cfg.do_stable_layer_norm, "feat_extract_norm": cfg.feat_extract_norm,
        "num_conv_pos_embeddings": cfg.num_conv_pos_embeddings,
        "num_conv_pos_embedding_groups": cfg.num_conv_pos_embedding_groups, "layer_norm_eps": cfg.layer_norm_eps,
    }
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump({c: i for i, c in enumerate(ALIGN_CHARS)}, f)
    return path


def write_pyannet_bin(path: str, seed: int = 0, classifier_bias: float = 0.0) -> str:
    """A pyannote segmentation checkpoint (Lightning ``state_dict``,
    ``model.`` prefix, the sinc parameters under ``filterbank``) holding the
    port's seeded 3-class PyanNet (``models/vad_net.py:init_vad_params``),
    its classifier bias set to ``classifier_bias``."""
    import torch

    from whisperx_tpu_torch.models.convert import pyannet_from_jax
    from whisperx_tpu_torch.models.vad_net import init_vad_params

    tree = init_vad_params(seed=seed)
    tree["classifier"]["bias"][:] = classifier_bias
    sd = pyannet_from_jax(tree, device="cpu").state_dict()
    sd = {k.replace("sincnet.conv1d.0.", "sincnet.conv1d.0.filterbank."): v for k, v in sd.items()}
    torch.save({"state_dict": {f"model.{k}": v for k, v in sd.items()}}, path)
    return path


def seeded_wespeaker(seed: int = 0):
    """The port's seeded ResNet34 on the CPU
    (``diarize/embed.py:init_resnet34_params``: 32 base channels, [3, 4, 6,
    3], 256-d, 80 fbank bins) with BN running statistics measured on 5 s of
    each of the two speakers, as training leaves them. With the init's unit
    statistics the activations grow by orders of magnitude over the stages
    and every embedding points the same way; measured ones keep each layer
    at unit scale, and the random net's embeddings differ by speaker."""
    import torch

    from whisperx_tpu_torch.audio.fbank import kaldi_fbank
    from whisperx_tpu_torch.diarize.embed import init_resnet34_params
    from whisperx_tpu_torch.models.convert import resnet34_from_jax

    net = resnet34_from_jax(init_resnet34_params(seed=seed), device="cpu")
    calib = np.stack([noise_floor(speaker_tones(5, k % 2, t0=k), seed=seed + k) for k in range(4)])
    for m in net.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.reset_running_stats()
            m.momentum = None  # a cumulative average: the batch's own statistics
    net.train()
    with torch.no_grad():
        net(kaldi_fbank(torch.from_numpy(calib)))
    return net.eval()


def write_wespeaker_bin(path: str, seed: int = 0) -> str:
    """A WeSpeaker ResNet34 checkpoint in the pyannote wrapper layout
    (``resnet.``-prefixed keys) holding :func:`seeded_wespeaker`."""
    import torch

    torch.save({"state_dict": {f"resnet.{k}": v for k, v in seeded_wespeaker(seed).state_dict().items()}}, path)
    return path


def speaker_tones(seconds: float, speaker: int, t0: float = 0.0) -> np.ndarray:
    """tests/test_diarize.py:98-107's two synthetic speakers: AM tones at
    160 + 320 Hz (4 Hz AM) and 1200 + 2400 Hz (5 Hz AM)."""
    t = t0 + np.arange(int(seconds * 16000)) / 16000
    f, am = ((160, 4), (1200, 5))[speaker]
    return 0.5 * np.sin(2 * np.pi * f * t) * (1 + 0.4 * np.sin(2 * np.pi * am * t)) + 0.2 * np.sin(2 * np.pi * 2 * f * t)


def noise_floor(audio: np.ndarray, seed: int) -> np.ndarray:
    """``audio`` over a -50 dB white-noise floor: pure tones leave most sinc
    bands at rounding level, where the PyanNet's InstanceNorm turns float
    noise into features and two devices' roundings into different turns."""
    return (audio + 0.003 * np.random.default_rng(seed).standard_normal(len(audio))).astype(np.float32)


def two_speaker_audio() -> np.ndarray:
    """tests/test_diarize.py:98-107: 3 s of each speaker around 1 s of
    silence, over the noise floor."""
    return noise_floor(np.concatenate([speaker_tones(3, 0), np.zeros(16000), speaker_tones(3, 1)]), seed=0)


def conversation_audio(minutes: float, seed: int = 0) -> np.ndarray:
    """The two speakers taking turns of 40-50 s with 0.5-1.5 s silences
    between them (lengths drawn from ``seed``), over the noise floor."""
    rng = np.random.default_rng(seed)
    n = int(minutes * 60 * 16000)
    parts, total, speaker = [], 0, 0
    while total < n:
        turn = speaker_tones(rng.uniform(40, 50), speaker, t0=total / 16000)
        gap = np.zeros(int(rng.uniform(0.5, 1.5) * 16000))
        parts += [turn, gap]
        total += len(turn) + len(gap)
        speaker = 1 - speaker
    return noise_floor(np.concatenate(parts)[:n], seed=seed)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, flops: float, peak_flops: float = BF16_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, iters: int) -> float:
    """Mean ms of ``fn`` on the card (CUDA events), after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int) -> float:
    """Device ms of one ``fn()``: captured once into a CUDA graph and replayed,
    so the Python cost of each call stays out of the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # lazy set-up (cuBLAS workspaces, library loads) before capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(torch, graph.replay, iters)


def profiled(torch, fn, iters: int = 1) -> dict:
    """``fn`` run ``iters`` times under torch.profiler: wall ms and device
    busy ms per run (the sum of the CUDA kernels' self time, gaps left out),
    and the kernels by device time. Empty if the profiler saw no device."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    # A record_function range (AdamW's "Optimizer.step#AdamW.step") also shows
    # as a device event spanning its kernels: leave it out, or it counts twice.
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not (getattr(e, "is_user_annotation", False) or e.key.startswith("Optimizer."))
    ]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / iters
    if busy_ms <= 0:
        return {}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)
    return {
        "wall_ms": wall_ms, "busy_ms": busy_ms,
        "kernels": [(e.key, e.self_device_time_total / 1e3 / iters, e.count // iters) for e in top],
    }


def zero_launches() -> None:
    """Zero every kernel's launch count: the wrappers' counters (the CTC
    kernel's too, which ``read_launches`` leaves out: the alignment's phases
    read ``ctc.launches`` themselves) and the launches inside device-loop
    graphs (``ops/graph_loop.py``)."""
    from whisperx_tpu_torch.ops import ctc, graph_loop

    for mod in graph_loop.COUNTERS.values():
        mod.launches = 0
    ctc.launches = 0
    graph_loop.reset_counts()


def read_launches() -> dict:
    """Each kernel's launches since ``zero_launches``: its wrapper's count
    (launches outside loop graphs) plus, for every device-loop launch,
    (launches in the captured step) x (steps the loop's device counter
    reports). Reads the card."""
    from whisperx_tpu_torch.ops import graph_loop

    in_loops = graph_loop.kernel_launches()
    return {name: mod.launches + in_loops.get(name, 0) for name, mod in graph_loop.COUNTERS.items()}


def max_err_within(torch, what: str, got, want, atol: float, rtol: float) -> float:
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} elements beyond atol={atol} rtol={rtol}, max err {err.max().item()}")
    return err.max().item()


# ---- phase 2: kernels against their plain versions -------------------------


def int8_mm_phase(torch, card: str) -> dict:
    from whisperx_tpu_torch.ops import int8_mm

    D = 1280  # large-v2 width
    # One decoder layer's projections in a beam step, in call order: self
    # qkv (fused), self out, cross query, cross out, fc1, fc2.
    layer = [(D, 3 * D), (D, D), (D, D), (D, D), (D, 4 * D), (4 * D, D)]
    gen = torch.Generator(device="cuda").manual_seed(0)

    def operands(M, K, N):
        x = torch.randn((M, K), device="cuda", generator=gen).bfloat16()
        w = torch.randint(-127, 128, (K, N), device="cuda", generator=gen, dtype=torch.int8)
        s = torch.rand((N,), device="cuda", generator=gen) * 0.01
        b = torch.randn((N,), device="cuda", generator=gen)
        return x, w, s, b

    # fp32 sums in another order; the bf16 output may round one ulp apart.
    atol, rtol = 1e-3, 2**-7
    path_err = 0.0
    # Decode, prompt, edges; then x rows around the n8 columns and the 64-row
    # block at the widest K (ten chunks a split), without a bias.
    cases = [(40, layer, True), (32, layer, True), (256, [(D, 4 * D)], True), (1, [(D, D)], True)]
    cases += [(M, [(4 * D, D)], False) for M in (8, 39, 41, 64, 65, 128, 255)]
    # The int8 wav2vec2 base's projections in phase 9's short alignment
    # batch (4 rows of 49 frames) and in a 2-row one: feat_projection,
    # attention, feed-forward in and out (48 chunks of K).
    w2v = [(512, 768), (768, 768), (768, 3072), (3072, 768)]
    cases += [(196, w2v, True), (98, w2v, True)]
    for M, shapes, with_bias in cases:
        for K, N in dict.fromkeys(shapes):
            x, w, s, b = operands(M, K, N)
            b = b if with_bias else None
            got = int8_mm.int8_matmul(x, w, s, b)
            torch.cuda.synchronize()
            err = max_err_within(torch, f"int8_mm M={M} K={K} N={N}", got, int8_mm.int8_matmul_plain(x, w, s, b), atol, rtol)
            if M in (40, 32):
                path_err = max(path_err, err)
            log(f"int8_mm M={M} K={K} N={N} bf16 out{'' if with_bias else ', no bias'}: max abs err {err:.3g} vs plain "
                f"(atol {atol}, rtol {rtol}): ok")

    # Large-v2's decoder projections at the tensor-parallel shard shapes of a
    # model axis of 2 (phase 10 (b)), M 40: the column splits with their bias
    # and bf16 out; the row splits' fp32 partial products without a bias.
    for K, N, with_bias in TP_SHARDS + tuple((K, N, False) for K, N, b in TP_SHARDS if b):
        out_dtype = torch.bfloat16 if with_bias else torch.float32
        x, w, s, b = operands(M_STEP, K, N)
        b = b if with_bias else None
        got = int8_mm.int8_matmul(x, w, s, b, out_dtype=out_dtype)
        torch.cuda.synchronize()
        shard_rtol = rtol if with_bias else 1e-5
        want = int8_mm.int8_matmul_plain(x, w, s, b, out_dtype=out_dtype)
        err = max_err_within(torch, f"int8_mm shard M={M_STEP} K={K} N={N}", got, want, atol, shard_rtol)
        log(f"int8_mm tensor-parallel shard M={M_STEP} K={K} N={N} {'bf16 out, bias' if with_bias else 'fp32 out, no bias'}: "
            f"max abs err {err:.3g} vs plain (atol {atol}, rtol {shard_rtol}): ok")

    # Timing unit: one decoder layer's six projections at M = 40 (batch 8 x
    # beam 5). Weights of 8 distinct layers (183 MB) rotate, so every call
    # finds its weight cold in HBM, as the decode step does.
    M, n_layers = 40, 8
    sets = [[operands(M, K, N) for K, N in layer] for _ in range(n_layers)]
    lib = [[(x, (w.float() * s).bfloat16(), b.bfloat16()) for x, w, s, b in ops] for ops in sets]

    def kernel():
        for ops in sets:
            for x, w, s, b in ops:
                int8_mm.int8_matmul(x, w, s, b)

    def plain():
        for ops in sets:
            for x, w, s, b in ops:
                int8_mm.int8_matmul_plain(x, w, s, b)

    def library():  # one cuBLAS call per projection on pre-dequantized bf16 weights
        for ops in lib:
            for x, wd, b in ops:
                torch.addmm(b, x, wd)

    ms = graph_ms(torch, kernel, 20) / n_layers
    plain_ms = graph_ms(torch, plain, 5) / n_layers
    library_ms = graph_ms(torch, library, 20) / n_layers
    eager_ms = time_ms(torch, kernel, 20) / n_layers
    nbytes = sum(K * N + M * K * 2 + 2 * N * 4 + M * N * 2 for K, N in layer)
    flops = sum(2 * M * K * N for K, N in layer)
    bms, by = bound_ms(nbytes, flops)
    log(
        f"int8_mm timing [{card}], one decoder layer's 6 projections at M=40, cold weights, device time "
        f"(CUDA graph replay): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library (addmm, bf16 weights) "
        f"{library_ms:.4f} ms, bound {bms:.4f} ms ({by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP); "
        f"eager calls from Python {eager_ms:.4f} ms"
    )
    return {
        "name": "int8_matmul",
        "route": "cuda",
        "design": "swap-AB mma.sync m16n8k16, W by TMA all at once (one round trip), int8->bf16 in registers, "
                  "split K summed through a cluster by st.async",
        "source": "whisperx_tpu_torch/csrc/int8_mm.cu",
        "replaces": "whisperx_tpu/ops/pallas_int8_mm.py:42",
        "launches": None,
        "max_abs_err": path_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bms,
        "bound_by": by,
        "library_ms": library_ms,
        "eager_ms": eager_ms,
        "unit": "one decoder layer's 6 projections, M=40, K,N in {1280,3840,5120}",
    }


def cross_attn_phase(torch, card: str) -> dict:
    from whisperx_tpu_torch.models.whisper import flat_cross_kv
    from whisperx_tpu_torch.ops import cross_attn

    B, G, S, H, Dh = 8, 5, 1500, 20, 64  # large-v2 beam step: batch 8, beam 5
    D = H * Dh
    gen = torch.Generator(device="cuda").manual_seed(1)

    def operands(G, kv_int8):
        q = (torch.randn((B, G, D), device="cuda", generator=gen) * 0.4 * Dh**-0.5).bfloat16()
        k = torch.randn((B, S, H, Dh), device="cuda", generator=gen) * 0.8
        v = torch.randn((B, S, H, Dh), device="cuda", generator=gen)
        return q, flat_cross_kv(k, v, kv_int8)

    # fp32 sums in another order; the weights' bf16 rounding may land one ulp apart.
    atol, rtol = 1e-4, 1e-3
    path_err = 0.0
    for g, kv_int8, what in ((G, True, "beam step"), (4, True, "prompt"), (G, False, "bf16 K/V")):
        q, f = operands(g, kv_int8)
        got = cross_attn.cross_attention_decode(q, *f)
        torch.cuda.synchronize()
        err = max_err_within(torch, f"cross_attn {what}", got, cross_attn.cross_attention_plain(q, *f), atol, rtol)
        if kv_int8:
            path_err = max(path_err, err)
        log(f"cross_attn {what} B={B} G={g} S={S} H={H}: max abs err {err:.3g} vs plain (atol {atol}, rtol {rtol}): ok")
    # Edges, bf16 K/V: S around the 64-position chunk and long, G from one row
    # to five blocks of 8. q and K on coarse grids (q in 1/64, K in 1/8
    # steps) make every logit exact in any order: with few positions a weight
    # is ~1/S, and one bf16 ulp of a weight rounding the other way would move
    # the output by ~1e-4 * |v|.
    for s_len in (1, 63, 64, 65, 3000):
        for g in (1, 16, 17, 40):
            q = (torch.randint(-4, 5, (2, g, 4 * Dh), device="cuda", generator=gen) / 64).bfloat16()
            k = torch.randint(-8, 9, (2, s_len, 4, Dh), device="cuda", generator=gen) / 8
            f = flat_cross_kv(k, torch.randn((2, s_len, 4, Dh), device="cuda", generator=gen), False)
            got = cross_attn.cross_attention_decode(q, *f)
            torch.cuda.synchronize()
            max_err_within(torch, f"cross_attn edge S={s_len} G={g}", got, cross_attn.cross_attention_plain(q, *f), atol, rtol)
    log(f"cross_attn edges (bf16 K/V, B=2 H=4, S in 1/63/64/65/3000 x G in 1/16/17/40): within atol {atol}, rtol {rtol}: ok")
    # The beam step at a rank's heads under a model axis of 2 (phase 10 (b): 10).
    for h in (10, 6):
        q = (torch.randn((B, G, h * Dh), device="cuda", generator=gen) * 0.4 * Dh**-0.5).bfloat16()
        f = flat_cross_kv(
            torch.randn((B, S, h, Dh), device="cuda", generator=gen) * 0.8,
            torch.randn((B, S, h, Dh), device="cuda", generator=gen), True,
        )
        got = cross_attn.cross_attention_decode(q, *f)
        torch.cuda.synchronize()
        err = max_err_within(torch, f"cross_attn {h} heads a rank", got, cross_attn.cross_attention_plain(q, *f), atol, rtol)
        log(f"cross_attn beam step, {h} heads a rank B={B} G={G} S={S} H={h}: max abs err {err:.3g} vs plain "
            f"(atol {atol}, rtol {rtol}): ok")

    # Three distinct layers' K/V (98 MB) rotate: cold in HBM, as in decode.
    sets = [operands(G, True) for _ in range(3)]

    def dequant(x, s):  # (B, S, D) int8, (B, H, S) → (B, H, S, Dh) bf16
        return (x.float().reshape(B, S, H, Dh) * s.transpose(1, 2)[..., None]).permute(0, 2, 1, 3).bfloat16().contiguous()

    lib = [(q.reshape(B, G, H, Dh).permute(0, 2, 1, 3).contiguous(), dequant(f.k, f.k_scale), dequant(f.v, f.v_scale)) for q, f in sets]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def kernel():
        for q, f in sets:
            cross_attn.cross_attention_decode(q, *f)

    def plain():
        for q, f in sets:
            cross_attn.cross_attention_plain(q, *f)

    def library():
        for q, k, v in lib:
            sdpa(q, k, v, scale=1.0)

    ms = graph_ms(torch, kernel, 50) / 3
    plain_ms = graph_ms(torch, plain, 10) / 3
    library_ms = graph_ms(torch, library, 50) / 3
    eager_ms = time_ms(torch, kernel, 50) / 3
    nbytes = B * G * D * 2 + 2 * B * S * D + 2 * B * H * S * 4 + B * G * D * 4
    flops = 2 * (2 * B * H * G * S * Dh)
    bms, by = bound_ms(nbytes, flops)
    log(
        f"cross_attn timing [{card}], B={B} G={G} S={S} H={H} int8 K/V, cold, device time (CUDA graph "
        f"replay): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library (SDPA, bf16 dequantized K/V) "
        f"{library_ms:.4f} ms, bound {bms:.4f} ms ({by}: {nbytes / 1e6:.2f} MB); eager calls from Python "
        f"{eager_ms:.4f} ms"
    )
    return {
        "name": "cross_attention_decode",
        "route": "cuda",
        "design": "one wave of clusters per (b, h), sized by the card's cluster count; K then V streamed by TMA "
                  "through a 4-slot ring; "
                  "both products on mma.sync (G on the n8 side); (max, sum) and outputs exchanged once each",
        "source": "whisperx_tpu_torch/csrc/cross_attn.cu",
        "replaces": "whisperx_tpu/ops/pallas_cross_attn.py:104",
        "launches": None,
        "max_abs_err": path_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bms,
        "bound_by": by,
        "library_ms": library_ms,
        "eager_ms": eager_ms,
        "unit": "one call, B=8 G=5 S=1500 H=20 int8 K/V",
    }


def self_attn_decode_phase(torch, card: str) -> dict:
    from whisperx_tpu_torch.ops import self_attn_decode as sad
    from whisperx_tpu_torch.ops.quant import store_kv

    rows, S, H, Dh = 40, 128, 20, 64  # large-v2 beam step (batch 8, beam 5) over the 112-token horizon's cache
    gen = torch.Generator(device="cuda").manual_seed(3)

    def operands(kv_int8, s_len, h):
        """A cache whose every slot holds an earlier token (int8 with its
        scales, or bf16), and q, k, v as views of one fused fp32 QKV output."""
        old_k = torch.randn((rows, s_len, h, Dh), device="cuda", generator=gen)
        old_v = torch.randn((rows, s_len, h, Dh), device="cuda", generator=gen)
        if kv_int8:
            (k, ks), (v, vs) = store_kv(old_k, 8), store_kv(old_v, 8)
            cache = {"k": k, "v": v, "k_scale": ks, "v_scale": vs}
        else:
            cache = {"k": old_k.bfloat16(), "v": old_v.bfloat16()}
        qkv = torch.randn((rows, 1, 3 * h * Dh), device="cuda", generator=gen) * 1.5
        return cache, qkv.split(h * Dh, dim=-1)

    def causal(pos, s_len):
        return torch.where(torch.arange(s_len, device="cuda")[None, :] <= pos[:, None], 0.0, -1e9)

    # fp32 sums in another order: a weight or an output may round one bf16 ulp apart.
    atol, rtol = 1e-3, 2**-7
    path_err = 0.0
    # The beam step at slots 0, the mean fill (59) and the last; turbo's
    # longest cache (n_text_ctx); a rank's heads under a model axis of 2.
    cases = [(S, H, p) for p in (0, 59, S - 1)] + [(448, H, 0), (448, H, 447), (S, 10, 59)]
    for kv_int8 in (True, False):
        for s_len, h, p in cases:
            cache, (q, k, v) = operands(kv_int8, s_len, h)
            plain_cache = {name: t.clone() for name, t in cache.items()}
            pos = torch.tensor([p], device="cuda")
            got = sad.self_attention_decode(q, k, v, cache, pos, causal(pos, s_len), torch.bfloat16)
            want = sad.self_attention_plain(q, k, v, plain_cache, pos, causal(pos, s_len), torch.bfloat16)
            torch.cuda.synchronize()
            what = f"self_attn_decode {'int8' if kv_int8 else 'bf16'} cache rows={rows} S={s_len} H={h} position {p}"
            differ = [name for name in cache if not torch.equal(cache[name], plain_cache[name])]
            if differ:
                raise AssertionError(f"{what}: the stored {differ} differ from store_kv + index_copy_")
            err = max_err_within(torch, what, got, want, atol, rtol)
            if kv_int8 and (s_len, h) == (S, H):
                path_err = max(path_err, err)
        log(f"self_attn_decode {'int8' if kv_int8 else 'bf16'} cache, rows={rows}: (S, H, position) in {cases}: stored "
            f"values{' and scales' if kv_int8 else ''} equal to the plain version's, output within atol {atol}, "
            f"rtol {rtol:.4g}: ok")

    # One int8 cache a decoder layer (32, 446 MB) in turn: out of L2, as in
    # the step. Timed at the mean fill over the horizon and full.
    layers = 32
    caches = [operands(True, S, H)[0] for _ in range(layers)]
    _, (q, k, v) = operands(True, S, H)
    timed = {}
    for p in (59, S - 1):
        pos = torch.tensor([p], device="cuda")
        mask = causal(pos, S)

        def kernel():
            for c in caches:
                sad.self_attention_decode(q, k, v, c, pos, mask, torch.bfloat16)

        def plain():
            for c in caches:
                sad.self_attention_plain(q, k, v, c, pos, mask, torch.bfloat16)

        # K, V and their scales of the filled slots; the fp32 q, k, v read; the bf16 output written.
        nbytes = rows * H * (p + 1) * (2 * Dh + 2 * 4) + rows * 3 * H * Dh * 4 + rows * H * Dh * 2
        flops = 2 * (2 * rows * H * (p + 1) * Dh)
        timed[p] = (graph_ms(torch, kernel, 50) / layers, graph_ms(torch, plain, 10) / layers, *bound_ms(nbytes, flops), nbytes)
    (ms, plain_ms, bms, by, nbytes), (ms_full, plain_full, bms_full, _, nbytes_full) = timed[59], timed[S - 1]
    log(
        f"self_attn_decode timing [{card}], rows={rows} H={H} S={S} int8 cache, {layers} caches in turn (cold), device "
        f"time (CUDA graph replay) a call: at the mean fill (position 59) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bms:.4f} ms ({by}: {nbytes / 1e6:.2f} MB); full (position {S - 1}) kernel {ms_full:.4f} ms, plain "
        f"{plain_full:.4f} ms, bound {bms_full:.4f} ms ({nbytes_full / 1e6:.2f} MB)"
    )
    return {
        "name": "self_attn_decode",
        "route": "cuda",
        "design": "one CTA of 128 threads a (row, head); the new k and v quantized as store_kv (or rounded to bf16) "
                  "and stored at the position read on the card; cp.async of the filled slots only, K then V; "
                  "two-pass fp32 softmax in shared memory",
        "source": "whisperx_tpu_torch/csrc/self_attn_decode.cu",
        "replaces": "none: the self cache's store and both einsums, whisperx_tpu/models/whisper.py:400-446, run in XLA",
        "launches": None,
        "max_abs_err": path_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bms,
        "bound_by": by,
        "library_ms": None,
        "ms_full": ms_full,
        "plain_ms_full": plain_full,
        "bound_ms_full": bms_full,
        "unit": f"one call, rows={rows} H={H} S={S} int8 cache at position 59 (the mean fill); *_full at {S - 1}",
    }

def flash_phase(torch, card: str) -> dict:
    from whisperx_tpu_torch.models.configs import WAV2VEC2_BASE
    from whisperx_tpu_torch.ops import flash_attn

    gen = torch.Generator(device="cuda").manual_seed(2)

    def operands(B, T, H, lengths=None):
        q, k = ((torch.randn((B, T, H, 64), device="cuda", generator=gen) * 0.35).bfloat16() for _ in range(2))
        v = torch.randn((B, T, H, 64), device="cuda", generator=gen).bfloat16()
        mask = None if lengths is None else torch.arange(T, device="cuda")[None, :] < torch.tensor(lengths, device="cuda")[:, None]
        return q, k, v, mask

    # Another summation order and another rescaling of exp(s - m) before its
    # bf16 rounding: the bf16 output may land one ulp apart.
    atol, rtol = 2e-3, 2**-7
    w2v_lengths = (1499, 1479, 1200, 700, 64, 65, 1, 1499)  # rows of different pad lengths
    # Phase 5's batch: 8 rows of 29.6 s, padded to 30 s.
    align_lengths, align_T = align_frames(WAV2VEC2_BASE.conv_layers, align_transcript(8))
    cases = [
        ("Whisper large-v2 encoder", (8, 1500, 20, None)),
        ("wav2vec2 base, padded rows", (8, 1499, 12, w2v_lengths)),
        ("wav2vec2 base, alignment path rows", (8, align_T, 12, align_lengths)),
        ("T=1", (1, 1, 2, None)),
        ("T=100 (not a tile multiple)", (2, 100, 2, None)),
        ("one valid key", (3, 130, 4, (1, 130, 67))),
        ("T=129 (one key past a tile)", (2, 129, 3, (129, 128))),
        ("180 work items on the persistent CTAs, masked rows", (3, 1500, 5, (1500, 1479, 1))),
        # A rank's heads under a model axis of 2 (phase 10 (b)).
        ("Whisper large-v2 encoder, 10 heads a rank", (8, 1500, 10, None)),
        ("Whisper encoder rows, 6 heads a rank", (8, 1500, 6, None)),
        ("wav2vec2 base alignment rows, 10 heads a rank", (8, align_T, 10, align_lengths)),
        ("wav2vec2 base alignment rows, 6 heads a rank", (8, align_T, 6, align_lengths)),
    ]
    path_err = 0.0
    for what, shape in cases:
        ops = operands(*shape)
        got = flash_attn.flash_attention(*ops)
        torch.cuda.synchronize()
        err = max_err_within(torch, f"flash {what}", got, flash_attn.flash_attention_plain(*ops), atol, rtol)
        if shape[0] == 8:  # the main paths' batches
            path_err = max(path_err, err)
        log(f"flash {what} {shape[:3]}: max abs err {err:.3g} vs plain (atol {atol}, rtol {rtol}): ok")

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for unit, (B, T, H, lengths) in (("whisper", (8, 1500, 20, None)), ("wav2vec2", (8, align_T, 12, align_lengths))):
        # Three distinct layers' operands rotate, as the encoder's layers do.
        sets = [operands(B, T, H, lengths) for _ in range(3)]
        lib = [
            (q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous(),
             None if m is None else m[:, None, None, :])
            for q, k, v, m in sets
        ]

        def kernel():
            for ops in sets:
                flash_attn.flash_attention(*ops)

        def plain():
            for ops in sets:
                flash_attn.flash_attention_plain(*ops)

        def library():
            for q, k, v, m in lib:
                sdpa(q, k, v, attn_mask=m, scale=1.0)

        ms = graph_ms(torch, kernel, 20) / 3
        plain_ms = graph_ms(torch, plain, 3) / 3
        library_ms = graph_ms(torch, library, 20) / 3
        eager_ms = time_ms(torch, kernel, 20) / 3
        nbytes = 4 * B * T * H * 64 * 2 + (0 if lengths is None else B * T)
        # Every query row, padded ones too, against the valid keys of its row.
        flops = 4 * H * 64 * T * (B * T if lengths is None else sum(lengths))
        bms, by = bound_ms(nbytes, flops)
        tflops = flops / ms / 1e9
        rows[unit] = (ms, plain_ms, library_ms, eager_ms, bms, by, tflops)
        log(
            f"flash timing [{card}], {unit} layer B={B} T={T} H={H}"
            f"{f' + pad mask (valid keys {min(lengths)}..{max(lengths)})' if lengths else ''}, device time "
            f"(CUDA graph replay): kernel {ms:.4f} ms ({tflops:.1f} TFLOP/s achieved on the valid keys), plain "
            f"{plain_ms:.4f} ms, library (SDPA) {library_ms:.4f} ms ({flops / library_ms / 1e9:.1f} TFLOP/s), "
            f"bound {bms:.4f} ms ({by}: {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB); eager calls from Python "
            f"{eager_ms:.4f} ms"
        )
    ms, plain_ms, library_ms, eager_ms, bms, by, tflops = rows["whisper"]
    return {
        "name": "flash_self_attention",
        "route": "cuda",
        "design": "wgmma+TMA, warp-specialized, persistent: 1 producer warp, 2 ping-pong consumer warpgroups",
        "source": "whisperx_tpu_torch/csrc/flash_attn.cu",
        "replaces": "whisperx_tpu/ops/attention.py:75",
        "launches": None,
        "max_abs_err": path_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bms,
        "bound_by": by,
        "library_ms": library_ms,
        "eager_ms": eager_ms,
        "tflops": tflops,
        "unit": "one call, Whisper large-v2 encoder layer B=8 T=1500 H=20 Dh=64",
        "wav2vec2_base_layer": dict(
            zip(("ms", "plain_ms", "library_ms", "eager_ms", "bound_ms", "bound_by", "tflops"), rows["wav2vec2"]),
            unit=f"one call, alignment path batch B=8 T={align_T} H=12 Dh=64, valid keys {align_lengths}",
        ),
    }


# Whisper large-v2's encoder under training (phase 8): batch 2 x 30 s, 20 heads of 64.
TRAIN_SHAPE = (2, 1500, 20)


def flash_bwd_phase(torch, card: str, flash: dict) -> list:
    """The training path's flash kernels: the forward kernel's lse output
    and the two backward kernels of ``csrc/flash_attn_bwd.cu``, each held
    against its plain version at the training shape and at edges (the
    backward kernels on the kernel forward's out and lse, so that the check
    isolates them; a second launch must give the same bits), then timed
    with cold caches. Adds the lse mode's numbers to ``flash`` and returns
    the two backward kernels' entries."""
    from whisperx_tpu_torch.ops import flash_attn

    gen = torch.Generator(device="cuda").manual_seed(4)

    def operands(B, T, H, lengths=None):
        q, k = ((torch.randn((B, T, H, 64), device="cuda", generator=gen) * 0.35).bfloat16() for _ in range(2))
        v, dout = (torch.randn((B, T, H, 64), device="cuda", generator=gen).bfloat16() for _ in range(2))
        mask = None if lengths is None else torch.arange(T, device="cuda")[None, :] < torch.tensor(lengths, device="cuda")[:, None]
        return q, k, v, dout, mask

    cases = [
        ("Whisper large-v2 encoder, training batch", (*TRAIN_SHAPE, None)),
        ("T=100 (not a tile multiple)", (2, 100, 2, None)),
        ("one valid key", (3, 130, 4, (1, 130, 67))),
        ("a row with no valid key", (2, 64, 2, (0, 64))),
        ("T=129 (one key past a tile)", (2, 129, 3, (129, 128))),
        ("T=1", (1, 1, 2, None)),
        ("masked rows, T=1500", (3, 1500, 5, (1500, 1479, 1))),
        ("T=192 (64-row tiles, not 128-row items), masked keys", (2, 192, 3, (192, 65))),
    ]
    errs = {"lse": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}
    for what, shape in cases:
        q, k, v, dout, mask = operands(*shape)
        out, lse = flash_attn._forward(q, k, v, mask, with_lse=True)
        dq, dk, dv = flash_attn.flash_attention_backward(q, k, v, out, lse, dout, mask)
        torch.cuda.synchronize()
        want_out, want_lse = flash_attn.flash_attention_fwd_plain(q, k, v, mask)
        if not torch.equal(torch.isinf(lse), torch.isinf(want_lse)):
            raise AssertionError(f"flash lse {what}: -inf rows differ from the plain version's")
        finite = torch.isfinite(want_lse)
        # fp32 m + ln(l) from sums in another order.
        e = {"lse": max_err_within(torch, f"flash lse {what}", lse[finite], want_lse[finite], 1e-5, 1e-5)}
        max_err_within(torch, f"flash out (with lse) {what}", out, want_out, 2e-3, 2**-7)
        want = flash_attn.flash_attention_backward_plain(q, k, v, out, lse, dout, mask)
        for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            # Both sum in fp32 and round bf16(P), bf16(dS) and the output at the
            # same points; another summation order (and exp2 for exp) may flip
            # a rounding: one bf16 ulp of the largest element, 2**-7 relative.
            atol = 2**-8 * w.float().abs().max().item() + 1e-6
            e[name] = max_err_within(torch, f"flash {name} {what}", got, w, atol, 2**-7)
        if shape[:3] == TRAIN_SHAPE:
            errs = e
        # No atomics and one summation order: a second launch gives the same bits.
        again = flash_attn.flash_attention_backward(q, k, v, out, lse, dout, mask)
        if not all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)):
            raise AssertionError(f"flash backward {what}: a second launch on the same operands gave other bits")
        log(
            f"flash backward {what} {shape[:3]}: max abs err lse {e['lse']:.3g}, dq {e['dq']:.3g}, dk {e['dk']:.3g}, "
            f"dv {e['dv']:.3g} vs plain, a second launch bit-equal: ok"
        )

    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, T, H = TRAIN_SHAPE
    sets = []
    for _ in range(3):  # three distinct layers' operands rotate, as the encoder's layers do
        q, k, v, dout, _ = operands(B, T, H)
        out, lse = flash_attn._forward(q, k, v, None, with_lse=True)
        _, delta = flash_attn.flash_attention_bwd_dq(q, k, v, out, dout, lse)
        sets.append((q, k, v, dout, out, lse, delta))
    lib = []
    for q, k, v, dout, *_ in sets:
        lq, lk, lv = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
        lib.append((lq, lk, lv, dout.transpose(1, 2).contiguous(), sdpa(lq, lk, lv, scale=1.0)))
    fns = {
        "dq": lambda: [flash_attn.flash_attention_bwd_dq(q, k, v, o, d, l) for q, k, v, d, o, l, _ in sets],
        "dkv": lambda: [flash_attn.flash_attention_bwd_dkv(q, k, v, d, l, dl) for q, k, v, d, _, l, dl in sets],
        "plain": lambda: [flash_attn.flash_attention_backward_plain(q, k, v, o, l, d) for q, k, v, d, o, l, _ in sets],
        "fwd_lse": lambda: [flash_attn._forward(q, k, v, None, with_lse=True) for q, k, v, *_ in sets],
        "fwd": lambda: [flash_attn._forward(q, k, v, None, with_lse=False) for q, k, v, *_ in sets],
        "fwd_plain": lambda: [flash_attn.flash_attention_fwd_plain(q, k, v) for q, k, v, *_ in sets],
        "sdpa_fwd": lambda: [sdpa(lq.detach(), lk.detach(), lv.detach(), scale=1.0) for lq, lk, lv, _, _ in lib],
    }
    ms = {name: graph_ms(torch, fn, 3 if "plain" in name else 20) / 3 for name, fn in fns.items()}
    eager = {name: time_ms(torch, fns[name], 20) / 3 for name in ("dq", "dkv")}
    # One PyTorch call for the whole backward (dq, dk, dv together) under
    # autograd (timed only: the port never calls it). Its device time is the
    # profiler's sum over its kernels: CUDA events around eager
    # autograd.grad calls also time the engine's host work between them.
    def library():
        for lq, lk, lv, d, o in lib:
            torch.autograd.grad(o, (lq, lk, lv), d, retain_graph=True)

    library_eager_ms = time_ms(torch, library, 20) / 3
    prof = profiled(torch, library, 10)
    if not prof:
        raise AssertionError("flash backward: the profiler recorded no device time for SDPA's backward")
    library_ms = prof["busy_ms"] / 3
    tensor = B * T * H * 64 * 2  # bytes of one (B, T, H, 64) bf16 tensor
    rows = B * H * T * 4  # bytes of one (B, H, T) fp32 row statistic
    prod = 2 * B * H * T * T * 64  # FLOP of one T x T x 64 product
    bounds = {
        "dq": bound_ms(5 * tensor + rows + tensor + rows, 3 * prod),  # q k v out dout lse -> dq D; S, dP, dQ
        "dkv": bound_ms(4 * tensor + 2 * rows + 2 * tensor, 4 * prod),  # q k v dout lse D -> dk dv; S, dP, dV, dK
        "backward": bound_ms(8 * tensor + rows, 5 * prod),  # the whole backward's five products
        "fwd_lse": bound_ms(4 * tensor + rows, 2 * prod),
    }
    res = flash_attn.bwd_resources()
    log(
        f"flash backward timing [{card}], Whisper large-v2 encoder layer under training B={B} T={T} H={H}, device time "
        f"(CUDA graph replay): dQ {ms['dq']:.4f} ms ({3 * prod / ms['dq'] / 1e9:.1f} TFLOP/s, bound {bounds['dq'][0]:.4f} "
        f"{bounds['dq'][1]}), dK/dV {ms['dkv']:.4f} ms ({4 * prod / ms['dkv'] / 1e9:.1f} TFLOP/s, bound "
        f"{bounds['dkv'][0]:.4f} {bounds['dkv'][1]}), together {ms['dq'] + ms['dkv']:.4f} ms against the five "
        f"products' bound {bounds['backward'][0]:.4f} ms; plain backward {ms['plain']:.4f} ms; library (SDPA backward "
        f"under autograd: device time by torch.profiler) {library_ms:.4f} ms ("
        + ", ".join(f"{k[:48]} {t / 3:.4f} ms" for k, t, _ in prof["kernels"][:4])
        + f"; CUDA events around eager calls {library_eager_ms:.4f} ms); eager dQ {eager['dq']:.4f}, dK/dV "
        f"{eager['dkv']:.4f} ms; resources (cudaFuncGetAttributes; registers as compiled, the consumers then take 232 "
        f"and the producer 40 by setmaxnreg): "
        + ", ".join(f"{n[20:]} {r['registers']} registers a thread, {r['spill_bytes']} spilled bytes, "
                    f"{r['smem_bytes']} B shared memory a CTA" for n, r in res.items())
    )
    log(
        f"flash forward with lse [{card}] at B={B} T={T} H={H}: {ms['fwd_lse']:.4f} ms against {ms['fwd']:.4f} ms "
        f"without (plain {ms['fwd_plain']:.4f}, SDPA forward {ms['sdpa_fwd']:.4f}, bound {bounds['fwd_lse'][0]:.4f} "
        f"{bounds['fwd_lse'][1]})"
    )
    flash["train_forward_lse"] = {
        "ms": ms["fwd_lse"], "no_lse_ms": ms["fwd"], "plain_ms": ms["fwd_plain"], "library_ms": ms["sdpa_fwd"],
        "bound_ms": bounds["fwd_lse"][0], "bound_by": bounds["fwd_lse"][1], "max_abs_err_lse": errs["lse"],
        "unit": f"one call with lse, Whisper large-v2 encoder layer under training B={B} T={T} H={H} Dh=64",
    }
    unit = f"one call, Whisper large-v2 encoder layer under training B={B} T={T} H={H} Dh=64"
    common = {
        "route": "cuda", "source": "whisperx_tpu_torch/csrc/flash_attn_bwd.cu", "launches": None,
        "plain_ms": ms["plain"], "library_ms": library_ms, "library_eager_ms": library_eager_ms, "unit": unit,
        "plain_and_library": "the whole backward (dq, dk, dv): the plain version, and SDPA's backward under autograd "
        "(library_ms: its kernels' device time by torch.profiler)",
    }
    return [
        dict(
            name="flash_attention_bwd_dq", **common,
            design="wgmma m64n64k16 (A from registers) + TMA ring, warp-specialized, persistent: 1 producer warp, 2 consumer "
            "warpgroups x 64 query rows, Q/dO resident as A fragments, K/V tiles of 64 (K read MN-major for dQ), D per item",
            **res["flash_attention_bwd_dq"],
            replaces="whisperx_tpu/ops/attention.py:75 (stock flash_attention.py:1287 _flash_attention_bwd_dq)",
            max_abs_err=errs["dq"], ms=ms["dq"], bound_ms=bounds["dq"][0], bound_by=bounds["dq"][1],
            eager_ms=eager["dq"], tflops=3 * prod / ms["dq"] / 1e9,
        ),
        dict(
            name="flash_attention_bwd_dkv", **common,
            design="wgmma m64n64k16 (A from registers) + TMA ring, warp-specialized, persistent: 1 producer warp, 2 consumer "
            "warpgroups x 64 keys, K/V resident as A fragments, S^T and dP^T so P^T and dS^T feed dV, dK; Q/dO read MN-major, no transposed copy",
            **res["flash_attention_bwd_dkv"],
            replaces="whisperx_tpu/ops/attention.py:75 (stock flash_attention.py:941 _flash_attention_bwd_dkv)",
            max_abs_err=max(errs["dk"], errs["dv"]), ms=ms["dkv"], bound_ms=bounds["dkv"][0], bound_by=bounds["dkv"][1],
            eager_ms=eager["dkv"], tflops=4 * prod / ms["dkv"] / 1e9,
        ),
    ]


def log_mel_phase(torch, card: str) -> dict:
    from whisperx_tpu_torch.audio import log_mel_spectrogram, mel_filters
    from whisperx_tpu_torch.ops import mel

    gen = torch.Generator(device="cuda").manual_seed(3)

    def audio(B, n, int16=False):
        a = torch.randn((B, n), device="cuda", generator=gen) * 0.1
        return (a * 32768).round().clamp(-32768, 32767).to(torch.int16) if int16 else a

    # fp32 products in another order than the plain version's cuBLAS GEMMs;
    # the card-vs-CPU tolerance of the plain log-mel (phase 3).
    atol = 1e-4
    path_err = 0.0
    for what, (B, n, n_mels, int16) in (
        ("8 x 30 s", (8, 480_000, 80, False)),
        ("8 x 30 s", (8, 480_000, 128, False)),
        ("8 x 30 s int16", (8, 480_000, 80, True)),
        ("short clip 1 s", (1, 16_000, 80, False)),
        ("short clip 0.1 s int16", (2, 1_600, 128, True)),
        ("101 frames int16", (3, 16_160, 128, True)),
    ):
        a = audio(B, n, int16)
        got = mel.log_mel_kernel(a, n_mels)
        torch.cuda.synchronize()
        err = max_err_within(torch, f"log_mel {what} n_mels={n_mels}", got, log_mel_spectrogram(a, n_mels), atol, 0.0)
        if n == 480_000:
            path_err = max(path_err, err)
        log(f"log_mel {what} n_mels={n_mels}: max abs err {err:.3g} vs plain (atol {atol}): ok")

    B, n, n_mels = 8, 480_000, 80
    frames = n // 160
    sets = [audio(B, n, int16=True) for _ in range(3)]  # the decode path uploads int16
    window = torch.hann_window(400, periodic=True, device="cuda")
    filt = torch.from_numpy(mel_filters(n_mels)).cuda()

    def kernel():
        for a in sets:
            mel.log_mel_kernel(a, n_mels)

    def plain():
        for a in sets:
            log_mel_spectrogram(a, n_mels)

    def library():  # cuFFT STFT + filterbank matmul + log10 and the clip
        for a in sets:
            spec = torch.stft(a.float() / 32768.0, 400, 160, window=window, center=True, pad_mode="reflect", return_complex=True)
            power = spec[..., :frames].abs() ** 2
            lg = torch.log10(torch.clamp(filt @ power, min=1e-10))
            lg = torch.maximum(lg, lg.amax(dim=(1, 2), keepdim=True) - 8.0)
            (lg + 4.0) / 4.0

    ms = graph_ms(torch, kernel, 20) / 3
    plain_ms = graph_ms(torch, plain, 20) / 3
    library_ms = graph_ms(torch, library, 20) / 3
    eager_ms = time_ms(torch, kernel, 20) / 3
    nbytes = B * n * 2 + B * n_mels * frames * 4
    # The function's least work a frame: window, a real FFT of 400 (the usual
    # 2.5 N log2 N), power, and the filterbank's nonzero taps.
    nnz = int((filt != 0).sum())
    flops = B * frames * (400 + 2.5 * 400 * np.log2(400) + 3 * 201 + 2 * nnz)
    bms, by = bound_ms(nbytes, flops, FP32_FLOPS)
    # The kernel's own algorithm (csrc/log_mel.cu), a frame: 20 real DFT-20s
    # (20 window products, 11 x 20 x 2 FMAs, 20 twiddle products of 6 FLOP
    # each), 20 complex DFT-20s (20 x 11 x 4 FMAs, 10 powers of 3 FLOP each),
    # the banded filterbank.
    algo_flops = B * frames * (20 * (20 + 2 * 440 + 6 * 20) + 20 * (2 * 880 + 3 * 10) + 2 * nnz)
    algo_bms, _ = bound_ms(nbytes, algo_flops, FP32_FLOPS)
    log(
        f"log_mel timing [{card}], 8 x 30 s int16 n_mels=80, device time (CUDA graph replay): kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library (stft + filterbank matmul + log10) {library_ms:.4f} ms, bound "
        f"{bms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP by FFT at the fp32 peak); "
        f"bound of the kernel's 20 x 20 FFT algorithm {algo_bms:.4f} ms ({algo_flops / 1e9:.3f} GFLOP at the fp32 "
        f"peak); eager calls from Python {eager_ms:.4f} ms"
    )
    return {
        "name": "log_mel",
        "route": "cuda",
        "design": "20 x 20 Cooley-Tukey real FFT in fp32 (direct DFT-20s) + banded mel, 16-frame tiles",
        "source": "whisperx_tpu_torch/csrc/log_mel.cu",
        "replaces": "whisperx_tpu/ops/pallas_mel.py:54",
        "launches": None,
        "max_abs_err": path_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bms,
        "bound_by": by,
        "library_ms": library_ms,
        "eager_ms": eager_ms,
        "bound_ms_kernel_algorithm": algo_bms,
        "unit": "one call, 8 x 480000 int16 samples, n_mels=80 (tile kernel + clip epilogue)",
    }


CTC_BARRIERED_MS = "0.6969"  # csrc/ctc_align.cu at the alignment path's shapes before its redesign (one barrier a step; final run)


def ctc_alignment_case():
    """Phase 5's CTC shapes: bench.py's transcript as wav2vec2 base's
    character ids, its frame count T for 8 x 30 s and the 8 rows' valid
    frames, and N (the ids bucketed by 64). Returns (ids, V, T, N, t_lens)."""
    from whisperx_tpu_torch.align.alignment import _preprocess_segment
    from whisperx_tpu_torch.models.configs import WAV2VEC2_BASE

    chars, _, _ = _preprocess_segment(ALIGN_TEXT, {c: i for i, c in enumerate(ALIGN_CHARS)}, False)
    ids = [ALIGN_CHARS.index(c) for c in chars]
    t_lens, T = align_frames(WAV2VEC2_BASE.conv_layers, align_transcript(8))
    return ids, WAV2VEC2_BASE.vocab_size, T, max(64, -(-len(ids) // 64) * 64), t_lens


def ctc_operands(torch, gen, ids, V, T, N, t_lens, n_lens):
    """Log-softmax emissions (B, T, V) on the card, token ids with the
    transcript's characters in each row's first n_len columns (random ids
    after them), and the lengths."""
    B = len(t_lens)
    lp = torch.log_softmax(torch.randn((B, T, V), device="cuda", generator=gen) * 3, dim=-1)
    tok = torch.randint(1, V, (B, N), device="cuda", generator=gen)
    for b, n in enumerate(n_lens):
        tok[b, :n] = torch.tensor((ids * (n // len(ids) + 1))[:n])
    return lp, tok, torch.tensor(t_lens, device="cuda"), torch.tensor(n_lens, device="cuda")


def ctc_trap(what: str) -> int:
    """A child process of ctc_phase (``python3 chip_smoke.py --ctc-trap
    token|blank``): one launch of csrc/ctc_align.cu with a token id outside
    the vocabulary, or a blank log-prob above 0, which must fail at the
    synchronization (the kernel's __trap). Exits 0 when it did."""
    import torch

    from whisperx_tpu_torch.ops import ctc

    ids, V, T, N, t_lens = ctc_alignment_case()
    gen = torch.Generator(device="cuda").manual_seed(4)
    lp, tok, t_len, n_len = ctc_operands(torch, gen, ids, V, T, N, t_lens[:2], [len(ids)] * 2)
    if what == "token":
        tok[1, 7] = V
    else:
        lp[1, 100, 0] = 0.5
    try:
        ctc.ctc_align_batch_device(lp, tok, t_len, n_len)
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 - the launch error of a trap, whatever torch names it
        print(f"ctc trap ({what}): the launch failed as it must: {type(e).__name__}: {str(e).splitlines()[0]}", flush=True)
        os._exit(0)  # the context is lost: no teardown through it
    print(f"ctc trap ({what}): the launch did not fail", flush=True)
    return 1


def ctc_phase(torch, card: str) -> dict:
    """csrc/ctc_align.cu against its plain version on the card: the trellis
    (ctc_trellis_batch) and the five outputs of the fused walk
    (ctc_align_batch_device) at the alignment path's shapes (phase 5's
    batch: 8 rows of bench.py's transcript, one token a character, N
    bucketed by 64; 1,499 frames, 1,479 valid; V 32), at a ragged batch and
    at a shape whose decision bits exceed shared memory (the scratch
    branch), at a vocabulary of 3,500 ids (a one-stage emission ring) and
    at N 2,100 (two computing warps and their mailbox). Bit for bit, probs to 1e-6 relative (expf against torch.exp).
    Two child processes launch it with a token id outside the vocabulary and
    with a blank log-prob above 0: both must see the launch fail (the
    kernel's trap), and this process's context must stay sound. Times the
    kernel, its trellis mode, the plain version (two Python loops over T),
    the bytes bound, the function's dependency bound (T dependent steps of
    one warp: a shuffle, an add, a compare-select) and the barriered design's
    floor (T barriered steps of a CTA); no PyTorch call computes forced
    alignment."""
    from whisperx_tpu_torch.ops import ctc

    gen = torch.Generator(device="cuda").manual_seed(4)
    ids, V, T, N, t_path = ctc_alignment_case()

    def check(what, args):
        T_, V_, N_ = *args[0].shape[1:], args[1].shape[1]
        plan = ctc.launch_plan(T_, N_, V_)
        trellis = ctc.ctc_trellis_batch(*args)
        got = ctc.ctc_align_batch_device(*args)
        torch.cuda.synchronize()
        if not torch.equal(trellis, ctc.ctc_trellis_batch_plain(*args)):
            raise AssertionError(f"ctc {what}: the kernel's trellis differs from the plain version's")
        want = ctc.ctc_align_batch_device_plain(*args)
        for name, g, w in zip(("token_idx", "probs", "active", "success", "t_start"), got, want):
            if g.dtype != w.dtype or g.shape != w.shape:
                raise AssertionError(f"ctc {what}: {name} {g.dtype} {tuple(g.shape)} != plain {w.dtype} {tuple(w.shape)}")
            if name != "probs" and not torch.equal(g, w):
                raise AssertionError(f"ctc {what}: {name} differs at {int((g != w).sum())} positions")
        err = max_err_within(torch, f"ctc {what} probs", got[1], want[1], 0.0, 1e-6)
        if plan.bits_in_smem != (N_ < 1024) or (V_ > 1000) != (plan.stages == 1) or (N_ > 2048) != (plan.warps > 1):
            raise AssertionError(f"ctc {what}: plan {plan}")
        log(
            f"ctc {what} B={args[0].shape[0]} T={T_} N={N_} V={V_}: trellis, token_idx, active, success "
            f"{got[3].tolist()}, t_start bit-equal to the plain version; probs max abs err {err:.3g} (rtol 1e-6); "
            f"{plan.warps} warp(s) of {plan.slots} columns a lane in a CTA of {plan.threads} threads, a ring of "
            f"{plan.stages} stage(s) of {plan.rows} rows, decision bits in "
            f"{'shared memory' if plan.bits_in_smem else 'a scratch buffer'}, {plan.smem_bytes} B of shared memory: ok"
        )
        return err

    cases = [
        ("alignment path", T, V, N, t_path, [len(ids)] * 8),
        ("ragged: full, short, unalignable (t_len < n_len), one token, none", T, V, N,
         [T, 1200, 300, t_path[0], 17], [len(ids), N, len(ids), 1, 0]),
        ("decision bits beyond shared memory (scratch)", T, V, 1280, [T, 1400], [1200, 1280]),
        ("a vocabulary of 3,500 ids (one ring stage)", T, 3500, 128, [T, 1200], [128, 90]),
        ("N above 2,048 (two warps, a mailbox)", T, V, 2100, [T, T, 1400], [2100, 1300, 700]),
    ]
    errs = [check(what, ctc_operands(torch, gen, ids, V_, T_, N_, t_lens, n_lens))
            for what, T_, V_, N_, t_lens, n_lens in cases]
    path_err = errs[0]

    for what in ("token", "blank"):  # the kernel's traps, each in a process of its own
        child = subprocess.run([sys.executable, os.path.abspath(__file__), "--ctc-trap", what], capture_output=True,
                               text=True, timeout=300)
        out = (child.stdout.strip().splitlines() or [""])[-1]
        if child.returncode != 0 or "failed as it must" not in out:
            raise AssertionError(f"ctc trap ({what}): exit {child.returncode}, {out!r}; stderr {child.stderr[-2000:]!r}")
        log(out)
    check("after the traps' child processes", ctc_operands(torch, gen, ids, V, T, N, t_path[:2], [len(ids)] * 2))

    B = len(t_path)
    sets = [ctc_operands(torch, gen, ids, V, T, N, t_path, [len(ids)] * B) for _ in range(3)]

    def kernel():
        for a in sets:
            ctc.ctc_align_batch_device(*a)

    def plain():
        for a in sets:
            ctc.ctc_align_batch_device_plain(*a)

    def trellis_only():  # the kernel's trellis mode: the recurrence without the bits and the walk
        for a in sets:
            ctc.ctc_trellis_batch(*a)

    ms = graph_ms(torch, kernel, 20) / 3
    trellis_ms = graph_ms(torch, trellis_only, 20) / 3
    eager_ms = time_ms(torch, kernel, 20) / 3
    plain_ms = graph_ms(torch, plain, 2) / 3
    plain_eager_ms = time_ms(torch, plain, 1) / 3
    shuffle_ms = ctc.shuffle_steps_ms(B, T)
    barrier_ms = ctc.barrier_steps_ms(B, T, 480)  # the barriered design's CTA at N 448
    # Each input read once, each output written once.
    nbytes = B * T * V * 4 + B * N * 8 + 2 * B * 8 + B * T * (8 + 4 + 1) + B * (1 + 8)
    flops = 3 * B * T * N  # two adds and a compare a cell
    bytes_ms, by = bound_ms(nbytes, flops, FP32_FLOPS)
    bms, by = (shuffle_ms, "operations") if shuffle_ms > bytes_ms else (bytes_ms, by)
    plan = ctc.launch_plan(T, N, V)
    log(
        f"ctc timing [{card}], alignment path B={B} T={T} N={N} V={V}, device time (CUDA graph replay): kernel "
        f"{ms:.4f} ms [barriered design, final run: {CTC_BARRIERED_MS}], trellis mode {trellis_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms "
        f"(eager from Python {plain_eager_ms:.1f} ms), library none; bytes bound {bytes_ms:.6f} ms "
        f"({nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP); dependency bound {shuffle_ms:.4f} ms ({T} dependent "
        f"steps of one warp: shuffle, add, compare-select; {B} warps), which governs; the barriered design's floor "
        f"{barrier_ms:.4f} ms ({T} barriered steps of 480 threads); kernel / dependency bound "
        f"{ms / shuffle_ms:.2f}; {plan.slots} columns a lane; eager calls from Python {eager_ms:.4f} ms"
    )
    return {
        "name": "ctc_align",
        "route": "cuda",
        "design": "one warp a segment: the trellis row in registers (16 contiguous columns a lane, one shuffle a "
                  "step, no barrier in a chunk), max and sign-bit decisions, emissions filled a chunk ahead by the "
                  "CTA's other warps into a column-major shared-memory ring (4-row loads), packed decision bits, a "
                  "32-step block walk on bit masks, the outputs written by the CTA",
        "source": "whisperx_tpu_torch/csrc/ctc_align.cu",
        "replaces": "whisperx_tpu/ops/ctc.py:188 (ctc_align_batch_device: lax.scan trellis :65, vmapped lax.scan walk "
                    ":183; not a Pallas kernel)",
        "launches": None,
        "max_abs_err": path_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bms,
        "bound_by": by,
        "library_ms": None,
        "eager_ms": eager_ms,
        "plain_eager_ms": plain_eager_ms,
        "bytes_bound_ms": bytes_ms,
        "shuffle_probe_ms": shuffle_ms,
        "barrier_probe_ms": barrier_ms,
        "trellis_mode_ms": trellis_ms,
        "unit": f"one call, alignment path batch B={B} T={T} N={N} V={V} (trellis + start row + walk); bound: T "
                "dependent shuffle steps (ctc_shuffle_steps)",
    }


# ---- phase 3: the card's decode against the CPU's on a small model ---------


def small_reference_phase(torch) -> None:
    from whisperx_tpu_torch.audio import log_mel_spectrogram, pcm16
    from whisperx_tpu_torch.decode.engine import WhisperEngine
    from whisperx_tpu_torch.decode.tokenizer import WhisperTokenizer
    from whisperx_tpu_torch.models import whisper as tw
    from whisperx_tpu_torch.models.configs import TEST_CONFIG
    from whisperx_tpu_torch.models.convert import whisper_from_jax

    rng = np.random.default_rng(3)
    audio = pcm16((rng.standard_normal((2, 480_000)) * 0.1).astype(np.float32))
    mel_gpu = log_mel_spectrogram(audio, device="cuda").cpu()
    mel_cpu = log_mel_spectrogram(audio, device="cpu")
    err = max_err_within(torch, "log_mel cuda vs cpu", mel_gpu, mel_cpu, 1e-4, 0.0)
    log(f"log_mel 2 x 30 s int16, cuda vs cpu: max abs err {err:.3g} (atol 1e-4): ok")

    cfg = dataclasses.replace(TEST_CONFIG, n_text_state=128, n_audio_state=128, n_text_head=2, n_audio_head=2)
    params = tw.fuse_qkv_params(tw.quantize_params(tw.random_params(cfg, seed=0, scale=0.1)))
    tok = WhisperTokenizer.dummy(cfg.n_vocab, language="en")
    engines = {dev: WhisperEngine(whisper_from_jax(params, cfg, device=dev), tok) for dev in ("cuda", "cpu")}
    mel = (rng.standard_normal((2, cfg.n_mels, 3000))).astype(np.float32)
    for beam in (1, 2):
        opts = engines["cpu"].build_options(beam_size=beam, max_new_tokens=6, kv_cache_dtype="int8")
        got = engines["cuda"].generate(mel, options=opts)
        want = engines["cpu"].generate(mel, options=opts)
        if not np.array_equal(got.tokens, want.tokens):
            raise AssertionError(f"small model beam={beam}: card tokens {got.tokens.tolist()} != cpu {want.tokens.tolist()}")
        lp_err = float(np.abs(got.sum_logprobs - want.sum_logprobs).max())
        if lp_err > 2e-2:
            raise AssertionError(f"small model beam={beam}: sum_logprobs differ by {lp_err}")
        log(f"small model (128 wide, int8, fp32 compute) beam={beam}: card tokens == cpu tokens, sum_logprobs within {lp_err:.2g}: ok")


def small_int4_phase(torch) -> None:
    """int4 weights and the int4 KV cache on a 128-wide fp32 Whisper: the
    card's decode tokens equal the CPU's, at beam 1 and 2 (fp32 compute
    keeps the einsum cross attention; int4 projections never take
    int8_matmul)."""
    from whisperx_tpu_torch.decode.engine import WhisperEngine
    from whisperx_tpu_torch.decode.tokenizer import WhisperTokenizer
    from whisperx_tpu_torch.models import whisper as tw
    from whisperx_tpu_torch.models.configs import TEST_CONFIG
    from whisperx_tpu_torch.models.convert import whisper_from_jax
    from whisperx_tpu_torch.ops.quant import unpack_int4

    p = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    if not torch.equal(unpack_int4(p.cuda()).cpu(), unpack_int4(p)):
        raise AssertionError("unpack_int4 of the 256 byte values: the card's nibbles differ from the CPU's")
    cfg = dataclasses.replace(TEST_CONFIG, n_text_state=128, n_audio_state=128, n_text_head=2, n_audio_head=2)
    fp = tw.random_params(cfg, seed=0, scale=0.2)
    q4 = tw.fuse_qkv_params(tw.quantize_params(fp, bits=4))
    mel = (3 * np.random.default_rng(5).standard_normal((2, cfg.n_mels, 3000))).astype(np.float32)
    tok = WhisperTokenizer.dummy(cfg.n_vocab, language="en")
    for what, tree, bits, kv in (("int4 weights", q4, 4, "int8"), ("int4 kv", fp, None, "int4"), ("int4 weights + kv", q4, 4, "int4")):
        engines = {dev: WhisperEngine(whisper_from_jax(tree, cfg, quant_bits=bits, device=dev), tok) for dev in ("cuda", "cpu")}
        for beam in (1, 2):
            opts = engines["cpu"].build_options(beam_size=beam, max_new_tokens=6, kv_cache_dtype=kv)
            zero_launches()
            got = engines["cuda"].generate(mel, options=opts)
            launched = tuple(read_launches()[k] for k in ("int8_matmul", "cross_attention_decode"))
            want = engines["cpu"].generate(mel, options=opts)
            if not np.array_equal(got.tokens, want.tokens):
                raise AssertionError(f"small {what} beam={beam}: card tokens {got.tokens.tolist()} != cpu {want.tokens.tolist()}")
            lp_err = float(np.abs(got.sum_logprobs - want.sum_logprobs).max())
            if lp_err > 2e-2:
                raise AssertionError(f"small {what} beam={beam}: sum_logprobs differ by {lp_err}")
            if launched != (0, 0):
                raise AssertionError(f"small {what} beam={beam}: int8_mm, cross_attn launches {launched}")
            log(f"small model (128 wide, {what}, kv {kv}) beam={beam}: card tokens == cpu tokens, "
                f"sum_logprobs within {lp_err:.2g}, launches int8_mm/cross_attn {launched}: ok")


def small_align_phase(torch, card: str) -> None:
    """Alignment on a 128-wide wav2vec2 (WAV2VEC2_TEST widened to the flash
    kernel's head dim 64): fp32 (the "xla" attention) on the card against
    the CPU, the same for its int8 model, then bf16 (the flash route)
    against the card's fp32 model, whose attention takes the plain route."""
    from whisperx_tpu_torch.align.alignment import AlignModel, _emissions, align
    from whisperx_tpu_torch.audio import N_SAMPLES
    from whisperx_tpu_torch.models import wav2vec2 as tw2
    from whisperx_tpu_torch.models.configs import WAV2VEC2_TEST
    from whisperx_tpu_torch.models.convert import wav2vec2_from_jax
    from whisperx_tpu_torch.ops import flash_attn, int8_mm

    cfg = dataclasses.replace(WAV2VEC2_TEST, hidden_size=128, intermediate_size=256)
    params = tw2.random_params(cfg, seed=0)
    dictionary = {c: i for i, c in enumerate(["[pad]", "|", "'"] + [chr(c) for c in range(ord("a"), ord("z") + 1)])}
    meta = {"language": "en", "dictionary": dictionary, "type": "torch"}
    n_seg = 3
    audio = (np.random.default_rng(4).standard_normal(n_seg * N_SAMPLES) * 0.1).astype(np.float32)
    transcript = align_transcript(n_seg)

    def model_on(dev, dtype):
        return AlignModel(wav2vec2_from_jax(params, cfg, dtype=dtype, device=dev), dictionary, "en")

    def timestamps(res):
        segs = [(s["text"], s["start"], s["end"]) for s in res["segments"]]
        return segs, [(w["word"], w.get("start"), w.get("end")) for w in res["word_segments"]]

    results = {}
    for dev in ("cuda", "cpu"):
        results[dev] = align([dict(s) for s in transcript], model_on(dev, torch.float32), meta, audio, dev)
    if timestamps(results["cuda"]) != timestamps(results["cpu"]):
        raise AssertionError("small align fp32: the card's segments, words or timestamps differ from the CPU's")
    # Scores are means of exp(log-probs) rounded to 3 decimals: fp32 sums in
    # another order may move one across a rounding boundary.
    score_err = max(
        (abs(a.get("score", 0.0) - b.get("score", 0.0)) for a, b in zip(results["cuda"]["word_segments"], results["cpu"]["word_segments"])),
        default=0.0,
    )
    if score_err > 2e-3:
        raise AssertionError(f"small align fp32: word scores differ by {score_err}")
    n_words = len(results["cpu"]["word_segments"])
    log(
        f"small align (128-wide wav2vec2, fp32, xla) {n_seg} x 30 s: card == cpu segments, {n_words} words and "
        f"timestamps identical, scores within {score_err:.3g} (atol 2e-3): ok"
    )

    # The int8 wav2vec2 (quantize_wav2vec2), fp32: the 3 x 30 s rows
    # dequantize and multiply; then 4 segments of 0.9 s (one batch of 4 x 49
    # frames) through int8_matmul on the card.
    short = [{"start": 30.0 * i + 2.0, "end": 30.0 * i + 2.9, "text": " the quick fox"} for i in range(3)]
    short.append({"start": 10.0, "end": 10.9, "text": " over the dog"})
    results = {}
    for dev in ("cuda", "cpu"):
        qm = AlignModel(tw2.quantize_wav2vec2(model_on(dev, torch.float32).model), dictionary, "en")
        int8_mm.launches = 0
        long_res = align([dict(s) for s in transcript], qm, meta, audio, dev)
        long_launched = int8_mm.launches
        results[dev] = (long_res, align([dict(s) for s in short], qm, meta, audio, dev), long_launched, int8_mm.launches - long_launched)
    want_launches = 1 + 6 * cfg.num_layers
    if results["cuda"][2:] != (0, want_launches) or results["cpu"][2:] != (0, 0):
        raise AssertionError(f"small align int8: int8_mm launches (30 s rows, 0.9 s rows): card {results['cuda'][2:]}, cpu {results['cpu'][2:]}")
    for i, what in ((0, "3 x 30 s"), (1, "4 x 0.9 s")):
        if timestamps(results["cuda"][i]) != timestamps(results["cpu"][i]):
            raise AssertionError(f"small align int8 fp32 {what}: the card's segments, words or timestamps differ from the CPU's")
    n_words = [len(results["cpu"][i]["word_segments"]) for i in (0, 1)]
    log(
        f"small align (128-wide int8 wav2vec2, fp32, xla): card == cpu segments, words and timestamps for "
        f"3 x 30 s ({n_words[0]} words) and 4 x 0.9 s ({n_words[1]} words, int8_matmul launched {want_launches} times): ok"
    )

    # bf16 (the flash route) against fp32 on the card (the plain route).
    models = {"flash": model_on("cuda", torch.bfloat16), "xla": model_on("cuda", torch.float32)}
    wavs = torch.from_numpy(audio.reshape(n_seg, N_SAMPLES)).cuda()
    lens = torch.full((n_seg,), N_SAMPLES, device="cuda")
    lens[1] = N_SAMPLES - 16_000 * 7  # one padded row
    with torch.inference_mode():
        flash_attn.launches = 0
        em_flash, t_len = _emissions(models["flash"].model, wavs, lens)
        launched = flash_attn.launches
        em_xla, _ = _emissions(models["xla"].model, wavs, lens)
        if flash_attn.launches != launched:
            raise AssertionError("small align fp32: the flash kernel launched for an fp32 model")
    valid = torch.arange(em_flash.shape[1], device="cuda")[None, :] < t_len[:, None]
    # bf16 activations rounded through two layers (0.058 at most on the CPU).
    err = max_err_within(torch, "small align bf16 flash vs fp32 xla emissions", em_flash[valid], em_xla[valid], 0.15, 0.05)
    if launched != cfg.num_layers:
        raise AssertionError(f"small align bf16: flash launched {launched} times, expected {cfg.num_layers}")
    words = {impl: align([dict(s) for s in transcript], am, meta, audio)["word_segments"] for impl, am in models.items()}
    same = float(np.mean([a == b for a, b in zip(words["xla"], words["flash"])])) if words["xla"] else 0.0
    log(
        f"small align bf16 [{card}]: emissions flash vs fp32 xla max abs err {err:.3g} (atol 0.15, rtol 0.05): ok; "
        f"word timestamps identical between bf16 flash and fp32 xla: {same:.3f} of {len(words['xla'])} words "
        f"(random weights)"
    )


def small_models():
    """Phase 3's small pipeline models: a 128-wide Whisper config (2 heads),
    a 128-wide wav2vec2 one, and the aligner's character dictionary."""
    from whisperx_tpu_torch.models.configs import TEST_CONFIG, WAV2VEC2_TEST

    cfg = dataclasses.replace(TEST_CONFIG, n_text_state=128, n_audio_state=128, n_text_head=2, n_audio_head=2)
    w2v_cfg = dataclasses.replace(WAV2VEC2_TEST, hidden_size=128, intermediate_size=256)
    dictionary = {c: i for i, c in enumerate(["[pad]", "|", "'"] + [chr(c) for c in range(ord("a"), ord("z") + 1)])}
    return cfg, w2v_cfg, dictionary


def small_audio() -> np.ndarray:
    """16 s with three tone bursts: three VAD chunks at chunk_size 5."""
    sr = 16000
    rng = np.random.default_rng(5)
    audio = np.zeros(16 * sr, np.float32)
    t = np.arange(2 * sr) / sr
    for i, start in enumerate((1, 6, 11)):
        audio[start * sr : (start + 2) * sr] = 0.3 * np.sin(2 * np.pi * (200 + 60 * i) * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
    return audio + (0.005 * rng.standard_normal(len(audio))).astype(np.float32)


def ids_tokenizer(n_vocab: int, language: str = "en"):
    """A tokenizer whose text renders every token id (``<id>``): equal text
    is equal tokens."""
    from whisperx_tpu_torch.decode.tokenizer import ByteBackend, WhisperTokenizer

    class Ids(ByteBackend):
        def decode(self, ids):
            return "".join(f"<{i}>" for i in ids)

    return WhisperTokenizer(Ids(n_vocab), n_vocab, language=language)


def small_pipeline_phase(torch) -> None:
    """The production pipeline on small models, card against CPU: a
    128-wide Whisper (int8 weights, fused QKV, int8 KV cache, fp32 compute;
    the int8 kernel on the card, its plain version on the CPU; fp32 keeps
    the einsum cross attention) transcribes three tone bursts, then a
    128-wide wav2vec2 (fp32, "xla") aligns bench.py's transcript in each VAD
    chunk. The text backend renders every token id, so equal text is equal
    tokens."""
    from whisperx_tpu_torch.align.alignment import AlignModel, align
    from whisperx_tpu_torch.decode.engine import WhisperEngine
    from whisperx_tpu_torch.models import wav2vec2 as tw2
    from whisperx_tpu_torch.models import whisper as tw
    from whisperx_tpu_torch.models.convert import wav2vec2_from_jax, whisper_from_jax
    from whisperx_tpu_torch.pipeline.asr import TranscriptionOptions, WhisperPipeline
    from whisperx_tpu_torch.vad.model import EnergyVAD, VadPipeline

    cfg, w2v_cfg, dictionary = small_models()
    params = tw.fuse_qkv_params(tw.quantize_params(tw.random_params(cfg, seed=0, scale=0.1)))
    w2v_params = tw2.random_params(w2v_cfg, seed=0)
    meta = {"language": "en", "dictionary": dictionary, "type": "torch"}
    audio = small_audio()

    def pipeline(dev, language="en"):
        tok = ids_tokenizer(cfg.n_vocab, language or "en")
        return WhisperPipeline(
            engine=WhisperEngine(whisper_from_jax(params, cfg, device=dev), tok),
            vad=VadPipeline(EnergyVAD()),
            vad_params={"vad_onset": 0.5, "vad_offset": 0.363},
            options=TranscriptionOptions(beam_size=2, max_new_tokens=6),
            tokenizer=tok if language else None,
            language=language,
            kv_cache_dtype="int8",
        )

    results, detected = {}, {}
    for dev in ("cuda", "cpu"):
        pipe = pipeline(dev)
        zero_launches()
        res = pipe.transcribe(audio, batch_size=2, chunk_size=5)
        launched = tuple(read_launches()[k] for k in ("int8_matmul", "cross_attention_decode"))
        am = AlignModel(wav2vec2_from_jax(w2v_params, w2v_cfg, device=dev), dictionary, "en")
        aligned = align([dict(s, text=" the quick brown fox jumps") for s in res["segments"]], am, meta, audio, dev)
        results[dev] = (res, aligned, launched)
        # Multilingual mode: language detection on the first 30 s, then
        # the tokenizer is dropped for the next file.
        multi = pipeline(dev, language=None)
        detected[dev] = (multi.transcribe(audio, batch_size=2, chunk_size=5), multi.tokenizer)
    # The temperature fallback's sampled retries, on the card only (the
    # samples are the card's own): every chunk fails the logprob gate once.
    pipe = pipeline("cuda")
    pipe.options = dataclasses.replace(
        pipe.options, enable_fallback=True, best_of=2, temperatures=(0.0, 0.5), log_prob_threshold=0.0,
        compression_ratio_threshold=None, no_speech_threshold=None,
    )
    fallback = pipe.transcribe(audio, batch_size=2, chunk_size=5)
    (got, got_al, launched), (want, want_al, cpu_launched) = results["cuda"], results["cpu"]
    if detected["cuda"] != detected["cpu"] or detected["cuda"][1] is not None:
        raise AssertionError(f"small pipeline, language detection: card {detected['cuda']} != cpu {detected['cpu']}")
    if [(s["start"], s["end"]) for s in fallback["segments"]] != [(s["start"], s["end"]) for s in got["segments"]]:
        raise AssertionError(f"small pipeline, temperature fallback on the card: {fallback}")
    if got != want:
        raise AssertionError(f"small pipeline: card segments {got} != cpu {want}")
    n = len(got["segments"])
    if n != 3 or not all(s["text"] for s in got["segments"]):
        raise AssertionError(f"small pipeline: expected 3 transcribed chunks, got {got['segments']}")
    # The beam loop may end early on EOT, so the card's int8_matmul count is
    # only known to be positive; fp32 compute launches no cross attention.
    if not (launched[0] > 0 and launched[1] == 0) or cpu_launched != (0, 0):
        raise AssertionError(f"small pipeline: launches card {launched}, cpu {cpu_launched}")

    def timestamps(res):
        return [(w["word"], w.get("start"), w.get("end")) for w in res["word_segments"]]

    if not all(s["words"] and all("start" in w for w in s["words"]) for s in got_al["segments"]):
        raise AssertionError(f"small pipeline: not every chunk aligned: {got_al['segments']}")

    if [(s["text"], s["start"], s["end"]) for s in got_al["segments"]] != [
        (s["text"], s["start"], s["end"]) for s in want_al["segments"]
    ] or timestamps(got_al) != timestamps(want_al):
        raise AssertionError("small pipeline: the card's aligned segments, words or timestamps differ from the CPU's")
    log(
        f"small pipeline (128-wide Whisper int8 + 128-wide wav2vec2, fp32): VAD -> transcribe -> align, card == cpu: "
        f"{n} chunks, tokens and VAD times identical, {len(timestamps(got_al))} words and timestamps identical, "
        f"detected language {detected['cuda'][0]['language']!r} on both; card launches int8_matmul {launched[0]}, "
        f"cross_attention_decode {launched[1]} (fp32: the einsum); the fallback's sampled retries ran on the card: ok"
    )


def small_diarize_phase(torch) -> None:
    """Diarization card against CPU at published widths on few windows
    (TF32 off, as set in main): the seeded WeSpeaker ResNet34 of
    :func:`seeded_wespeaker` and a seeded 3-class PyanNet (SincNet 80 x 251
    / 10, two 60-channel convs, 4-layer BiLSTM of 128, two 128-unit
    linears; classifier weights x 30 so that activities spread over [0, 1])
    in the overlap-aware mode; then the weight-free default (EnergyVAD
    windows + MelStatsEmbedding). Same turns and labels."""
    import copy

    from whisperx_tpu_torch.diarize.embed import NeuralSpeakerEmbedding
    from whisperx_tpu_torch.diarize.pipeline import DiarizationPipeline
    from whisperx_tpu_torch.diarize.segmentation import NeuralSegmentation
    from whisperx_tpu_torch.models.convert import pyannet_from_jax
    from whisperx_tpu_torch.models.vad_net import init_vad_params

    audio = two_speaker_audio()
    wespeaker = seeded_wespeaker(seed=0)
    seg_tree = init_vad_params(seed=0)
    seg_tree["classifier"]["kernel"] *= 30.0
    windows = np.stack([audio[s : s + 80_000] for s in (0, 16_000, len(audio) - 80_000)])  # 5 s windows, as the diarizer cuts
    res = {}
    for dev in ("cuda", "cpu"):
        embedder = NeuralSpeakerEmbedding(copy.deepcopy(wespeaker).to(dev))
        seg = NeuralSegmentation(pyannet_from_jax(seg_tree, device=dev))
        neural = DiarizationPipeline(device=dev, embedder=embedder, segmentation=seg)
        default = DiarizationPipeline(device=dev)
        res[dev] = {
            "neural": [tuple(r) for r in neural(audio, num_speakers=2)[["start", "end", "speaker"]].itertuples(index=False)],
            "default": [tuple(r) for r in default(audio, num_speakers=2)[["start", "end", "speaker"]].itertuples(index=False)],
            "acts": seg(windows),
            "emb": embedder(windows),
            "melstats": default.embedder(windows[:, :24_000]),
        }
    got, want = res["cuda"], res["cpu"]
    for mode in ("neural", "default"):
        if got[mode] != want[mode] or not want[mode]:
            raise AssertionError(f"small diarization {mode}: card turns {got[mode]} != cpu {want[mode]}")
    if len({t[2] for t in want["default"]}) != 2:
        raise AssertionError(f"small diarization default: expected two speakers, got {want['default']}")
    errs = {k: float(np.abs(got[k] - want[k]).max()) for k in ("acts", "emb", "melstats")}
    log(
        f"small diarization (ResNet34 + PyanNet at published widths, seeded; two-speaker audio): card == cpu "
        f"{len(got['neural'])} overlap-aware turns and labels ({len({t[2] for t in got['neural']})} speakers), "
        f"{len(got['default'])} weight-free turns (EnergyVAD + MelStats, 2 speakers); largest card-vs-cpu difference: "
        f"activities {errs['acts']:.3g}, L2-normalised ResNet34 embeddings {errs['emb']:.3g}, MelStats embeddings "
        f"{errs['melstats']:.3g}: ok"
    )


CLI_FORMATS = ("txt", "vtt", "srt", "tsv", "json", "aud")


def meeting_wav(path: str) -> str:
    """Two in-band tone speakers taking 3 s turns with 0.5 s pauses, over
    the noise floor (the CLI checks' WAV file)."""
    from whisperx_tpu_torch.audio.io import write_wav

    t = np.arange(3 * 16000) / 16000
    a = 0.4 * np.sin(2 * np.pi * 500 * t) * (1 + 0.5 * np.sin(2 * np.pi * 4 * t))
    b = 0.4 * np.sin(2 * np.pi * 2000 * t) * (1 + 0.5 * np.sin(2 * np.pi * 5 * t))
    gap = np.zeros(8000)
    write_wav(path, noise_floor(np.concatenate([gap, a, gap, b, gap, a, gap]), seed=0))
    return path


def small_cli_configs():
    """The CLI checks' models: Whisper 128 wide (2 + 2 layers, 2 heads, 64
    text positions) and wav2vec2 128 wide (three 32-channel convs, 2 layers)."""
    from whisperx_tpu_torch.models.configs import TEST_CONFIG, WAV2VEC2_TEST

    whisper = dataclasses.replace(TEST_CONFIG, name="cli-128", n_audio_state=128, n_text_state=128, n_text_ctx=64)
    w2v = dataclasses.replace(
        WAV2VEC2_TEST, name="cli-128", hidden_size=128, intermediate_size=256,
        conv_layers=((32, 10, 5), (32, 3, 2), (32, 3, 2)), num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
    )
    return whisper, w2v


def small_cli_phase(torch) -> None:
    """``cli.cli`` in-process on a 128-wide HF Whisper and wav2vec2 written by
    hand, float32, --diarize (weight-free diarizer), once with --device
    cuda and once with --device cpu; each run writes the five formats of
    "all" and then "aud". The six files must be byte-equal; the JSON may
    differ only in alignment scores, within 2e-3."""
    from whisperx_tpu_torch import cli

    whisper_cfg, w2v_cfg = small_cli_configs()
    with tempfile.TemporaryDirectory() as tmp:
        whisper = write_hf_whisper(os.path.join(tmp, "hf-whisper"), whisper_cfg, seed=0, dtype="F32")
        w2v = write_hf_wav2vec2(os.path.join(tmp, "hf-wav2vec2"), w2v_cfg, seed=0)
        wav = meeting_wav(os.path.join(tmp, "meeting.wav"))
        argv = [wav, "--checkpoint", whisper, "--align_model", w2v, "--compute_type", "float32", "--language", "en",
                "--beam_size", "2", "--batch_size", "2", "--chunk_size", "5", "--diarize", "--min_speakers", "1",
                "--max_speakers", "2", "--suppress_tokens=-1,50257", "--verbose", "False"]
        for dev in ("cuda", "cpu"):
            for fmt in ("all", "aud"):
                cli.cli(argv + ["--device", dev, "--output_format", fmt, "--output_dir", os.path.join(tmp, dev)])
        files = {
            dev: {ext: open(os.path.join(tmp, dev, f"meeting.{ext}"), "rb").read() for ext in CLI_FORMATS}
            for dev in ("cuda", "cpu")
        }
    same = [ext for ext in CLI_FORMATS if files["cuda"][ext] == files["cpu"][ext]]
    score_err = 0.0
    if "json" not in same:
        got, want = json.loads(files["cuda"]["json"]), json.loads(files["cpu"]["json"])
        pairs = [(a, b) for sa, sb in zip(got["segments"], want["segments"]) for a, b in zip(sa.get("words", []), sb.get("words", []))]
        score_err = max((abs(a.get("score", 0) - b.get("score", 0)) for a, b in pairs), default=0.0)
        for res in (got, want):
            for seg in res["segments"]:
                for w in seg.get("words", []):
                    w.pop("score", None)
            for w in res.get("word_segments", []):
                w.pop("score", None)
        if got != want or score_err > 2e-3:
            raise AssertionError(f"small CLI: the card's JSON differs from the CPU's beyond the scores (score err {score_err})")
    if [ext for ext in CLI_FORMATS if ext not in same and ext != "json"]:
        raise AssertionError(f"small CLI: card files differ from the cpu's: {sorted(set(CLI_FORMATS) - set(same))}")
    data = json.loads(files["cpu"]["json"])
    speakers = {seg.get("speaker") for seg in data["segments"]}
    if not data["segments"] or not data["word_segments"] or not speakers <= {"SPEAKER_00", "SPEAKER_01"}:
        raise AssertionError(f"small CLI: expected transcribed, aligned and diarized segments, got {data['segments']}")
    log(
        f"small CLI (cli.cli, 128-wide Whisper + wav2vec2 from hand-written HF directories, float32, --diarize): "
        f"--device cuda == --device cpu, byte-equal {', '.join(same)}"
        + ("" if "json" in same else f"; json equal but for alignment scores within {score_err:.3g} (atol 2e-3)")
        + f"; {len(data['segments'])} segments, {len(data['word_segments'])} words, speakers {sorted(speakers)}: ok"
    )


# ---- phase 4: the main path ------------------------------------------------


def large_v2(torch):
    """Whisper large-v2 at its published widths, random weights from seed 0,
    int8 weights + fused QKV, bf16 compute, on the card (phases 4 and 6)."""
    from whisperx_tpu_torch.models import whisper as tw
    from whisperx_tpu_torch.models.configs import get_whisper_config
    from whisperx_tpu_torch.models.convert import whisper_from_jax

    cfg = get_whisper_config("large-v2")
    t0 = time.perf_counter()
    params = tw.fuse_qkv_params(tw.quantize_params(tw.random_params(cfg, seed=0)))
    model = whisper_from_jax(params, cfg, dtype=torch.bfloat16, device="cuda")
    del params
    log(f"large-v2 random weights (seed 0), int8 + fused QKV, on the card in {time.perf_counter() - t0:.1f} s")
    return model


def main_path_phase(torch, card: str, model) -> dict:
    from whisperx_tpu_torch.audio import N_SAMPLES, pcm16
    from whisperx_tpu_torch.decode.engine import WhisperEngine
    from whisperx_tpu_torch.decode.search import beam_decode
    from whisperx_tpu_torch.decode.tokenizer import WhisperTokenizer
    from whisperx_tpu_torch.ops import graph_loop, mel

    cfg = model.config
    batch, beam, max_new = 8, 5, 112
    engine = WhisperEngine(model, WhisperTokenizer.dummy(cfg.n_vocab, language="en"))
    opts = engine.build_options(beam_size=beam, max_new_tokens=max_new, kv_cache_dtype="int8")
    # Ban EOT (bench.py:75-82): every segment pays the full 112-token horizon.
    opts = dataclasses.replace(opts, banned_tokens=opts.banned_tokens + (opts.eot,))
    cross = engine._cross_impl(opts)
    if cross != "pallas":
        raise AssertionError(f"main path: the cross-attention route is {cross!r}, not the kernel")
    rng = np.random.default_rng(0)
    audio = pcm16((rng.standard_normal((batch, N_SAMPLES)) * 0.1).astype(np.float32))

    # The log-mel kernel divides the int16 upload by 32768 on the card.
    def mel_of(x):
        return mel.log_mel_kernel(x, n_mels=cfg.n_mels).to(torch.bfloat16)

    # One-time CUDA and cuBLAS set-up, and the device loop captured, outside
    # the counted runs.
    engine.generate(mel_of(audio), options=opts)
    if not engine.uses_device_loop(opts):
        raise AssertionError(f"main path: the device loop is not chosen for {opts}")
    loop, _, graph = model.decode_loops[("beam", batch, len(engine.build_prompt(1)[0]), opts, cross)]
    log(
        f"device loop [{card}]: captured in {graph.capture_ms:.1f} ms (warm-up step + capture), WHILE "
        f"graph built and instantiated in {graph.instantiate_ms:.1f} ms; captured step's pool "
        f"{graph.pool_bytes / 2**20:.1f} MiB, static state {state_bytes(loop) / 2**20:.1f} MiB; launches in one "
        f"step {graph.body_launches}"
    )

    L = cfg.n_text_layer
    want = {
        "int8_matmul": 6 * L * (1 + max_new),  # 6 projections per layer, prompt + every step
        "cross_attention_decode": L * (1 + max_new),
        "flash_self_attention": cfg.n_audio_layer,  # one per encoder layer
        "log_mel": 1,  # one call for the batch
        "self_attn_decode": L * max_new,  # every step; the prompt pass keeps the plain route
    }
    for run in (1, 2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t0 = time.perf_counter()
        mel_b = mel_of(audio)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = engine.generate(mel_b, options=opts)  # returns host arrays: synchronized
        t2 = time.perf_counter()
        launches = read_launches()
        if res.tokens.shape != (batch, max_new) or not np.isfinite(res.sum_logprobs).all():
            raise AssertionError(f"main path: tokens {res.tokens.shape}, sum_logprobs {res.sum_logprobs}")
        if not (res.lengths == max_new + 1).all() or (res.tokens == opts.eot).any():
            raise AssertionError(f"main path: EOT is banned, yet lengths are {res.lengths}")
        if launches != want or graph_loop.launches != 1:
            raise AssertionError(f"main path: launches {launches}, {graph_loop.launches} loop graphs; expected {want}, 1")
        mel_ms, gen_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3
        rate = batch * 30.0 / (t2 - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(
            f"main path run {run} [{card}]: mel {mel_ms:.1f} ms, generate {gen_ms:.1f} ms (one WHILE-graph launch), "
            f"{rate:.2f} audio-s/s, peak {peak:.1f} GiB, launches {launches}: ok"
        )
    launches = {**launches, "decode_while_loop": graph_loop.launches}

    # generate(sync=False) returns once the loop is enqueued: its return time
    # next to the wait at the first read, and no read of the card in between.
    mel_b = mel_of(audio)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending = engine.generate(mel_b, options=opts, sync=False)
    t1 = time.perf_counter()
    done = torch.cuda.Event()
    done.record()
    busy_at_return = not done.query()
    pending.fetch()
    t2 = time.perf_counter()
    if not busy_at_return:
        raise AssertionError("generate(sync=False): the card had finished the loop when the call returned")
    reads = reads_between_launch_and_fetch(torch, engine, mel_b, opts)
    if reads["local_scalar_dense"] or reads["syncs"]:
        raise AssertionError(f"generate(sync=False): the host read the card between launch and fetch: {reads}")
    log(
        f"generate(sync=False) [{card}]: returned in {(t1 - t0) * 1e3:.2f} ms with the loop still running "
        f"on the card; the first read waited {(t2 - t1) * 1e3:.2f} ms; between the loop's launch and the fetch: "
        f"{reads['local_scalar_dense']} aten::_local_scalar_dense (profiler), {len(reads['syncs'])} synchronizing "
        f"calls (sync debug mode: device-to-host copies, item, synchronize); host reads before the launch: "
        f"{reads['before_launch'] or 'none'}: ok"
    )

    # Per-stage breakdown: the same stages generate() runs, each ended by a
    # sync; the loop twice on the same inputs, as one device-loop launch and
    # on the host loop (tokens and statistics equal); then a profiled window
    # of the host loop (the launch counts a step) and a profiled device loop
    # (its idle share).
    with torch.inference_mode():
        stamps = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        mel_b = mel_of(audio)
        mark()
        states = engine._encode(mel_b)
        mark()
        prompt = engine.build_prompt(batch)
        key = ("beam", batch, prompt.shape[1], opts, cross)
        logits, cache, _ = engine._prompt_cache(
            states, prompt, engine._cache_len(prompt.shape[1], opts), kv_bits=8, cross_impl=cross,
            cross=engine._loop_cross(key),
        )
        mark()
        device = engine._device_loop(key, logits, cache)
        mark()
        expanded = [{n: b.repeat_interleave(beam, dim=0) for n, b in layer.items()} for layer in cache["self"]]
        host = beam_decode(engine._step_fn(cache["cross"]), logits, expanded, prompt.shape[1], opts)
        mark()
        same_loops(torch, "main path", device, host)
        loop_err = float((device[1] - host[1]).abs().max())
        mel_ms, enc_ms, prompt_ms, dev_ms, host_ms = (1e3 * (b - a) for a, b in zip(stamps, stamps[1:]))
        log(
            f"stages (cross={cross}, encoder attention flash) [{card}]: "
            f"mel {mel_ms:.1f} ms, encoder {enc_ms:.1f} ms, prompt {prompt_ms:.1f} ms, device loop {dev_ms:.1f} ms "
            f"({dev_ms / max_new:.2f} ms/step), host loop {host_ms:.1f} ms ({host_ms / max_new:.2f} ms/step); "
            f"tokens, sum_logprobs and lengths equal between the two loops; "
            f"{batch * 30.0 / (stamps[4] - stamps[0]):.2f} audio-s/s with the device loop"
        )
        profile = profile_beam_loop(torch, engine, logits, cache, prompt.shape[1], opts, card)
        loop = profile_device_loop(torch, engine, logits, cache, key, card)
        loop.update(device_ms_per_step=dev_ms / max_new, host_ms_per_step=host_ms / max_new, max_abs_err=loop_err,
                    bound_ms=bound_ms(loop_step_bytes(engine, key, loop["steps"]), 0)[0])
    return launches, profile, loop


SAMPLED_TEMPERATURES = (0.2, 1.0)
BEST_OF = 5  # a retry batch's copies of one chunk (TranscriptionOptions.best_of)


def sampled_path_phase(torch, card: str, model) -> dict:
    """Phase 4's sampled arm, on phase 4's model (large-v2, int8 weights +
    fused QKV, int8 KV) with its default routes: greedy sampling at batch
    8 x 1, 112 tokens with EOT banned, at each of SAMPLED_TEMPERATURES, on a
    batch laid out as the fallback's retries are (the first chunk BEST_OF
    times, then three copies of another). Each temperature: one device-loop
    launch through generate (both temperatures share one kept loop), the
    BEST_OF copies decoded to distinct tokens, then the stages with the
    device loop and the host loop on the same inputs and seed (tokens, sum
    log-probs and lengths bit-equal), and generate(sync=False)'s return
    against the first read's wait with no read of the card between the
    launch and the fetch."""
    from whisperx_tpu_torch.audio import N_SAMPLES, pcm16
    from whisperx_tpu_torch.decode.engine import WhisperEngine
    from whisperx_tpu_torch.decode.search import greedy_decode
    from whisperx_tpu_torch.decode.tokenizer import WhisperTokenizer
    from whisperx_tpu_torch.ops import graph_loop, mel

    cfg = model.config
    batch, max_new, L = 8, 112, cfg.n_text_layer
    engine = WhisperEngine(model, WhisperTokenizer.dummy(cfg.n_vocab, language="en"))
    base = engine.build_options(beam_size=1, max_new_tokens=max_new, kv_cache_dtype="int8")
    base = dataclasses.replace(base, banned_tokens=base.banned_tokens + (base.eot,))
    cross = engine._cross_impl(base)
    rng = np.random.default_rng(1)
    chunks = pcm16((rng.standard_normal((2, N_SAMPLES)) * 0.1).astype(np.float32))
    audio = np.concatenate([np.repeat(chunks[:1], BEST_OF, axis=0), np.repeat(chunks[1:], batch - BEST_OF, axis=0)])
    mel_b = mel.log_mel_kernel(audio, n_mels=cfg.n_mels).to(torch.bfloat16)
    want = {"int8_matmul": 6 * L * (1 + max_new), "cross_attention_decode": L * (1 + max_new),
            "flash_self_attention": cfg.n_audio_layer, "log_mel": 0, "self_attn_decode": L * max_new}
    out = {}
    for t_i, temp in enumerate(SAMPLED_TEMPERATURES):
        o = dataclasses.replace(base, temperature=temp)
        if not engine.uses_device_loop(o):
            raise AssertionError(f"sampled arm T={temp}: the device loop is not chosen")
        seed = 1000 + t_i
        engine.generate(mel_b, options=o, generator=torch.Generator().manual_seed(seed))  # the capture (first temperature)
        torch.cuda.synchronize()
        zero_launches()
        res = engine.generate(mel_b, options=o, generator=torch.Generator().manual_seed(seed))
        launches, loop_graphs = read_launches(), graph_loop.launches
        if launches != want or loop_graphs != 1:
            raise AssertionError(f"sampled arm T={temp}: launches {launches}, {loop_graphs} loop graphs; expected {want}, 1")
        if not (res.lengths == max_new + 1).all() or not np.isfinite(res.sum_logprobs).all():
            raise AssertionError(f"sampled arm T={temp}: lengths {res.lengths}, sum_logprobs {res.sum_logprobs}")
        copies = {tuple(r) for r in res.tokens[:BEST_OF].tolist()}
        if len(copies) != BEST_OF:
            raise AssertionError(f"sampled arm T={temp}: {BEST_OF} copies of one chunk gave {len(copies)} distinct candidates")
        greedy_keys = [k for k in model.decode_loops if k[0] == "greedy"]
        if len(greedy_keys) != 1:
            raise AssertionError(f"sampled arm T={temp}: {len(greedy_keys)} sampling loops kept, expected one for every temperature")

        with torch.inference_mode():
            stamps = [time.perf_counter()]

            def mark():
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())

            states = engine._encode(mel_b)
            prompt = engine.build_prompt(batch)
            key = ("greedy", batch, prompt.shape[1], engine._loop_options(o), cross)
            logits, cache, _ = engine._prompt_cache(
                states, prompt, engine._cache_len(prompt.shape[1], o), kv_bits=8, cross_impl=cross,
                cross=engine._loop_cross(key),
            )
            mark()
            device = engine._device_loop(key, logits, cache, temp, torch.Generator().manual_seed(seed))
            mark()
            host = greedy_decode(engine._step_fn(cache["cross"]), logits, cache["self"], prompt.shape[1], o,
                                 torch.Generator().manual_seed(seed))
            mark()
        same_loops(torch, f"sampled arm T={temp}", device, host)
        if not np.array_equal(device[0].cpu().numpy(), res.tokens):
            raise AssertionError(f"sampled arm T={temp}: the staged device loop differs from generate's")
        dev_ms, host_ms = (1e3 * (b - a) for a, b in zip(stamps[1:], stamps[2:]))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = engine.generate(mel_b, options=o, generator=torch.Generator().manual_seed(seed), sync=False)
        t1 = time.perf_counter()
        done = torch.cuda.Event()
        done.record()
        busy_at_return = not done.query()
        pending.fetch()
        t2 = time.perf_counter()
        if not busy_at_return or not np.array_equal(pending.tokens, res.tokens):
            raise AssertionError(f"sampled arm T={temp}: generate(sync=False) returned after the loop, or other tokens")
        reads = reads_between_launch_and_fetch(torch, engine, mel_b, o, torch.Generator().manual_seed(seed))
        if reads["local_scalar_dense"] or reads["syncs"]:
            raise AssertionError(f"sampled arm T={temp}: the host read the card between launch and fetch: {reads}")
        out[temp] = {"device_ms_per_step": dev_ms / max_new, "host_ms_per_step": host_ms / max_new,
                     "return_ms": (t1 - t0) * 1e3, "wait_ms": (t2 - t1) * 1e3, "launches": loop_graphs}
        log(
            f"sampled arm T={temp} (greedy, batch {batch} x 1, {max_new} tokens, EOT banned, cross={cross}) [{card}]: "
            f"one WHILE-graph launch, launches {launches}; the {BEST_OF} copies of one chunk gave {len(copies)} distinct "
            f"candidates; device loop {dev_ms:.1f} ms ({dev_ms / max_new:.2f} ms/step), host loop {host_ms:.1f} ms "
            f"({host_ms / max_new:.2f} ms/step), tokens, sum_logprobs and lengths equal between the two loops; "
            f"generate(sync=False) returned in {(t1 - t0) * 1e3:.2f} ms with the loop still running, the first read "
            f"waited {(t2 - t1) * 1e3:.2f} ms; between the launch and the fetch {reads['local_scalar_dense']} "
            f"aten::_local_scalar_dense, {len(reads['syncs'])} synchronizing calls: ok"
        )
    return out


def state_bytes(loop) -> int:
    """Bytes of a search loop's static state: its tensors, the self cache
    and its reorder scratch (the cross K/V are held beside it in
    ``Whisper.decode_loops``)."""
    tensors = [v for v in vars(loop).values() if hasattr(v, "element_size") and hasattr(v, "numel")]
    tensors += [b for layer in loop.cache for b in layer.values()]
    tensors += list(getattr(loop, "scratch", {}).values())
    return sum(t.numel() * t.element_size() for t in tensors)


def loop_step_bytes(engine, key: tuple, steps: int) -> float:
    """Bytes a beam step of the device loop ``key`` must move at least, on
    average over a loop of ``steps`` steps: every decoder weight (Dense
    kernels, scales and biases, the token embedding of the tied logits and
    its row scales) and the cross K/V (values and scales) read once; of the
    self cache (values and scales) only the filled slots read once, the step
    at position P + s reading P + s + 1 of them, P + (steps + 1) / 2 on
    average; its new slot and the (B·K, V) fp32 logits written once. The
    bound of ``bound_ms`` in bytes; the step's operations are far below it."""
    model = engine.model
    loop, cross, _ = model.decode_loops[key]
    weights = sum(p.numel() * p.element_size() for p in model.decoder.parameters())
    cross_b = sum(t.numel() * t.element_size() for kv in cross for t in kv)
    cache_b = sum(b.numel() * b.element_size() for layer in loop.cache for b in layer.values())
    slot_b = cache_b / next(iter(loop.cache[0].values())).shape[1]
    read_b = slot_b * (loop.prompt_len + (steps + 1) / 2)
    logits_b = loop.logprobs.numel() * 4
    return weights + cross_b + read_b + slot_b + logits_b


def held_loops(model) -> str:
    """The device loops ``model`` keeps (``Whisper.decode_loops``) and the
    card memory they hold: static state, cross K/V and the captured step's
    pool."""
    total = 0
    for loop, cross, graph in model.decode_loops.values():
        total += state_bytes(loop) + sum(t.numel() * t.element_size() for kv in cross for t in kv) + graph.pool_bytes
    return f"{len(model.decode_loops)} device loops kept, holding {total / 2**30:.2f} GiB"


def same_loops(torch, what: str, device, host) -> None:
    """The device loop's (tokens, sum_logprobs, lengths) equal to the host
    loop's on the same inputs, bit for bit."""
    if not all(torch.equal(a, b) for a, b in zip(device, host)):
        diff = [int((a != b).sum()) for a, b in zip(device, host)]
        raise AssertionError(f"{what}: the device loop differs from the host loop (elements differing: {diff})")


def reads_between_launch_and_fetch(torch, engine, mel_b, opts, generator=None) -> dict:
    """``generate(mel_b, sync=False)`` (drawing from ``generator`` when
    sampling) and the fetch, with the host's reads of
    the card after the loop's WHILE-graph launch counted two ways: the
    ``aten::_local_scalar_dense`` calls between the launch and the fetch
    (torch.profiler's host events only: no CUPTI tracing over the graph, see
    ``profile_device_loop``), and every synchronizing call torch makes after
    the launch until ``generate`` returns (its CUDA sync debug mode:
    device-to-host copies, ``item``, stream and device synchronizations).
    Also the ``_local_scalar_dense`` calls before the launch, with the ops
    they came from."""
    import warnings

    from torch.profiler import ProfilerActivity, profile, record_function

    from whisperx_tpu_torch.ops import graph_loop

    launch = graph_loop.DeviceLoop.launch

    def marked(self):
        with record_function("graph_loop.launch"):
            span = launch(self)
        torch.cuda.set_sync_debug_mode("warn")
        return span

    graph_loop.DeviceLoop.launch = marked
    try:
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught, \
                profile(activities=[ProfilerActivity.CPU], with_stack=True) as prof:
            warnings.simplefilter("always")
            try:
                pending = engine.generate(mel_b, options=opts, generator=generator, sync=False)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            with record_function("fetch"):
                pending.fetch()
    finally:
        graph_loop.DeviceLoop.launch = launch
    events = prof.events()
    at = {e.name: e.time_range.start for e in events if e.name in ("graph_loop.launch", "fetch")}
    if len(at) != 2:
        raise AssertionError(f"reads between launch and fetch: the profiler lost the markers {sorted(at)}")
    scalar = [e for e in events if e.name == "aten::_local_scalar_dense"]

    def origin(e) -> str:
        chain, p = [], e.cpu_parent
        while p is not None and len(chain) < 6:
            chain.append(p.name)
            p = p.cpu_parent
        return " < ".join(chain) + (f" ({e.stack[0]})" if e.stack else "")

    return {
        "local_scalar_dense": sum(at["graph_loop.launch"] <= e.time_range.start < at["fetch"] for e in scalar),
        # torch's warning for each synchronizing call ("called a synchronizing
        # CUDA operation"), not its notice that the mode is a prototype.
        "syncs": [str(w.message)[:200] for w in caught
                  if "synchroniz" in str(w.message).lower() and "prototype" not in str(w.message)],
        "before_launch": [origin(e) for e in scalar if e.time_range.start < at["graph_loop.launch"]],
    }


def loop_entry(k: dict, sampled: dict, fallback: dict) -> dict:
    """The ``kernels`` line's entry of the device loop (``csrc/graph_loop.cu``):
    its ms a step against the host loop's (its plain version), in phase 4's
    beam decode; beside it the sampled arm's (phase 4) and the launches of
    phase 6's fallback arm."""
    return {
        "name": "decode_while_loop",
        "route": "cuda",
        "design": "the captured beam step as a child graph in the body of a conditional WHILE node; a one-thread "
                  "kernel sets the node's condition from the step's continue flag, before the first step and after each",
        "source": "whisperx_tpu_torch/csrc/graph_loop.cu",
        "replaces": "whisperx_tpu/decode/search.py:525 (lax.while_loop, cond at :404; not a Pallas kernel)",
        "launches": None,
        "max_abs_err": k["max_abs_err"],
        "ms": k["device_ms_per_step"],
        "plain_ms": k["host_ms_per_step"],
        "bound_ms": k["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "idle_share": k["idle_share"],
        "idle_share_of": "the captured step replayed alone under torch.profiler: 1 - device busy / the span from a "
                         "step's first kernel to its last",
        "busy_ms": k["busy_ms_per_step"],
        "span_ms": k["span_ms_per_step"],
        "unit": "one beam step of large-v2, batch 8 x beam 5, int8 weights and KV, default routes (host clock around the "
                "whole loop / steps); the plain version is the host loop on the same inputs",
        "launches_sampled": sum(v["launches"] for v in sampled.values()),
        "sampled": {str(t): v for t, v in sampled.items()},
        "sampled_unit": "one greedy sampling step of large-v2, batch 8 x 1, int8 weights and KV, default routes",
        "launches_fallback": fallback["launches"]["decode_while_loop"],
        "fallback_retry_batches": fallback["retry_batches"],
        "fallback_peak_gib": fallback["peak_gib"],
    }


# The CUDA kernels of the port by their device names, as the profiler lists them.
STEP_KERNELS = {"int8_matmul": "int8_mm_kernel", "cross_attention_decode": "cross_attn_kernel",
                "self_attn_decode": "self_attn_decode_kernel"}


def profile_beam_loop(torch, engine, logits, cache, prompt_len: int, opts, card: str, steps: int = 8) -> dict:
    """Device busy share and the costliest kernels over ``steps`` beam steps
    of the host loop (torch.profiler; its own overhead lengthens the host
    side). Returns the device busy ms per step and each port kernel's
    device ms per step. The kernel events a step are also the check of the
    device loop's launch counts: each must equal the launches that the
    captured step recorded."""
    from whisperx_tpu_torch.decode.search import beam_decode

    o = dataclasses.replace(opts, max_new_tokens=steps)
    K = o.beam_size
    expanded = [{n: b.repeat_interleave(K, dim=0) for n, b in layer.items()} for layer in cache["self"]]
    prof = profiled(torch, lambda: beam_decode(engine._step_fn(cache["cross"]), logits, expanded, prompt_len, o))
    cross = engine._cross_impl(opts)
    if not prof:
        log(f"profile cross={cross}: the profiler recorded no device time; busy share not measured")
        return {}
    kernels, busy_ms, wall_ms = prof["kernels"], prof["busy_ms"], prof["wall_ms"]
    step_ms = {name: sum(t for k, t, _ in kernels if key in k) / steps for name, key in STEP_KERNELS.items()}
    events = {name: sum(c for k, _, c in kernels if key in k) / steps for name, key in STEP_KERNELS.items()}
    key = ("beam", logits.shape[0], prompt_len, opts, cross)
    body = engine.model.decode_loops[key][2].body_launches
    if any(events[name] != body[name] for name in STEP_KERNELS):
        raise AssertionError(f"launches a step: the profiler's kernel events {events} != the captured step's {body}")
    log(
        f"profile host loop cross={cross} [{card}], {steps} beam steps under torch.profiler: wall "
        f"{wall_ms:.1f} ms, device busy {busy_ms:.2f} ms ({busy_ms / steps:.3f} ms/step), idle share "
        f"{1 - busy_ms / wall_ms:.3f}; kernel events a step {events} == the device loop's captured step: ok; top kernels: "
        + "; ".join(f"{k[:60]} {t / steps:.3f} ms/step x{c // steps}" for k, t, c in kernels[:6])
        + "; port kernels: " + ", ".join(f"{k} {v:.3f} ms/step" for k, v in step_ms.items())
    )
    return {"busy_ms_per_step": busy_ms / steps, **step_ms}


def profile_device_loop(torch, engine, logits, cache, key: tuple, card: str, replays: int = 8,
                        pause_s: float = 0.05, warm: int = 50) -> dict:
    """One launch of the device loop ``key`` timed by CUDA events, then its
    captured step traced: the step's CUDA graph (``DeviceLoop._graph``, the
    child of the WHILE body) replayed ``warm`` times untraced from the loop's
    start (the self cache fills to about its mean over the 112-step
    horizon), then alone ``replays`` times under torch.profiler, a
    synchronize and ``pause_s`` of sleep after
    each, after one more replay in the same trace that is left out (CUPTI
    dropped a few kernel events at the start of a trace: 188 of 192
    ``int8_mm`` events in the first replay of one run). The kernels split
    into the replays at the ``replays`` widest gaps between them: the pause
    leaves the card idle for far longer than
    any gap inside a step (traced steps hold gaps of a few ms, which a bare
    host round trip of tens of µs does not outlast), and each cut must be at
    least half the pause. Per step:
    the device busy ms (the union of its kernels' intervals), the span from
    its first kernel's start to its last kernel's end, and the idle share
    1 - busy / span. The WHILE launch itself runs without torch.profiler:
    CUPTI's kernel tracing inside a conditional body kept a varying share of
    the iterations (1 and 34.7 of 112) and once ended in an illegal memory
    access on this card. Each step's events of the port's kernels must equal
    the launches the capture recorded, which also checks the split. Each
    step's kernels are also grouped (:func:`step_groups`): device ms and
    launches a step of each group."""
    from torch.profiler import ProfilerActivity, profile

    loop, cross, graph = engine.model.decode_loops[key]
    route = key[4]
    if cache["cross"] is not cross:
        raise AssertionError("profile device loop: the cross K/V are not the loop's own")
    with torch.inference_mode():
        loop.start(logits, cache["self"])
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        graph.launch()
        end.record()
        torch.cuda.synchronize()
        wall_ms, steps = start.elapsed_time(end), int(loop.step)
        loop.start(logits, cache["self"])
        for _ in range(warm):  # the first instantiates the step graph: outside the trace
            graph._graph.replay()
        torch.cuda.synchronize()
        first = int(loop.step)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(replays + 1):  # the first: the trace's own start, left out
                graph._graph.replay()
                torch.cuda.synchronize()
                time.sleep(pause_s)
    kernels = sorted(
        (e.time_range.start, e.time_range.end, e.name) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
    )
    out = {"wall_ms_per_step": wall_ms / steps, "steps": steps}
    if len(kernels) < replays + 1:
        log(f"device loop cross={route} [{card}]: the profiler saw {len(kernels)} kernels in {replays + 1} step replays; "
            f"idle share not measured")
        return {**out, "idle_share": None, "busy_ms_per_step": None, "span_ms_per_step": None}
    gaps = sorted(range(1, len(kernels)), key=lambda i: kernels[i][0] - kernels[i - 1][1])[len(kernels) - 1 - replays:]
    cuts = [0, *sorted(gaps), len(kernels)]
    left_out, *per_step = [kernels[a:b] for a, b in zip(cuts, cuts[1:])]
    cut_us = min((kernels[i][0] - kernels[i - 1][1] for i in gaps), default=pause_s * 1e6)
    inner_us, at, before, after = max(
        ((ks[i][0] - ks[i - 1][1], i, ks[i - 1][2], ks[i][2]) for ks in per_step for i in range(1, len(ks))),
        default=(0.0, 0, "", ""),
    )
    widest = f"widest gap inside a step {inner_us:.1f} us, before its kernel {at} ({after[:40]}, after {before[:40]})"
    busy = span = 0.0
    for ks in per_step:
        span += max(k[1] for k in ks) - ks[0][0]
        reach = ks[0][0]
        for a, b, _ in ks:  # the union of the intervals
            busy += max(0.0, b - max(a, reach))
            reach = max(reach, b)
    busy_ms, span_ms = busy / 1e3 / replays, span / 1e3 / replays
    counts = [{name: sum(dev in k for _, _, k in ks) for name, dev in STEP_KERNELS.items()} for ks in per_step]
    if cut_us < pause_s * 1e6 / 2 or any(c[name] != graph.body_launches[name] for c in counts for name in STEP_KERNELS):
        raise AssertionError(
            f"device loop: kernel events of the step replays {counts} != the captured step's {graph.body_launches}, "
            f"or a cut between replays ({cut_us:.1f} us) shorter than half the {pause_s * 1e6:.0f} us pause "
            f"({widest})"
        )
    idle = 1 - busy_ms / span_ms
    groups = {}
    for ks in per_step:
        for name, members in step_groups(ks, engine.model.config.n_text_layer).items():
            ms, n = groups.get(name, (0.0, 0))
            groups[name] = (ms + sum(b - a for a, b, _ in members) / 1e3 / replays, n + len(members) / replays)
    groups = dict(sorted(groups.items(), key=lambda g: -g[1][0]))
    log(
        f"device loop cross={route} [{card}]: one WHILE-graph launch, {steps} steps in {wall_ms:.2f} ms "
        f"({wall_ms / steps:.3f} ms/step, CUDA events); its captured step replayed alone {replays} times (after one "
        f"left out) under "
        f"torch.profiler: device busy {busy_ms:.3f} ms a step over a span of {span_ms:.3f} ms from its first kernel "
        f"to its last ({sum(map(len, per_step)) / replays:.0f} kernels a step, {widest}, narrowest cut between replays "
        f"{cut_us:.1f} us), idle share {idle:.3f}; the port's kernel events "
        f"in every step {counts[0]} == the captured step's launches: ok; in the replay left out "
        f"{ {name: sum(dev in k for _, _, k in left_out) for name, dev in STEP_KERNELS.items()} }; steps {first + 1}-"
        f"{first + replays} of the loop, by group (device ms / launches a step): "
        + "; ".join(f"{name} {ms:.3f} / {n:g}" for name, (ms, n) in groups.items())
    )
    return {**out, "idle_share": idle, "busy_ms_per_step": busy_ms, "span_ms_per_step": span_ms,
            "groups": {name: {"ms": ms, "launches": n} for name, (ms, n) in groups.items()}}


def step_groups(step: list, n_layer: int) -> dict:
    """{group: kernels} of one traced beam step of an int8 model with fused
    QKV and the int8 self cache, (start, end, name) in order: by where each
    kernel sits between the six ``int8_mm_kernel`` launches of each decoder
    layer (q/k/v, out, cross query, cross out, fc1, fc2) and by name. The
    self-attention lies between q/k/v and out, the cross attention between
    the cross query and its out, GELU between fc1 and fc2, the LayerNorms,
    their casts and the residual adds elsewhere inside the layers.
    Before the first layer: the beam search's top-k, gathers and token
    histories, then ``reorder_cache_`` (an index_select and a copy back
    for each of a layer's four cache buffers, layer after layer: the run of
    8 L kernels whose names repeat every 8), then the embedding, positions,
    causal mask and first LayerNorm; after the last layer its LayerNorm,
    the logits, ``log_softmax`` and the loop's condition."""
    mm = [i for i, k in enumerate(step) if "int8_mm_kernel" in k[2]]
    if len(mm) != 6 * n_layer:
        raise AssertionError(f"step groups: {len(mm)} int8_mm kernels in a step, not {6 * n_layer}")
    out = {"int8_mm": [step[i] for i in mm]}

    def add(group, members):
        out.setdefault(group, []).extend(members)

    for layer in range(n_layer):
        qkv, o, cq, co, fc1, fc2 = mm[6 * layer : 6 * layer + 6]
        for k in step[qkv + 1 : o]:
            add("self_attn_decode" if "self_attn_decode_kernel" in k[2] else "self-attention, plain kernels", [k])
        for k in step[cq + 1 : co]:
            add("cross_attn" if "cross_attn_kernel" in k[2] else "cross-attention query scale and casts", [k])
        add("LayerNorms, casts, residual adds", step[o + 1 : cq] + step[co + 1 : fc1])
        add("GELU and its cast", step[fc1 + 1 : fc2])
        if layer + 1 < n_layer:
            add("LayerNorms, casts, residual adds", step[fc2 + 1 : mm[6 * layer + 6]])
        else:
            add("last LayerNorm, logits, log_softmax, cond", step[fc2 + 1 :])
    pre, run = step[: mm[0]], 8 * n_layer
    at = next((i for i in range(len(pre) - run + 1)
               if all(pre[i + j][2] == pre[i + j + 8][2] for j in range(run - 8))), None)
    if at is None:
        raise AssertionError(f"step groups: no run of {run} kernels repeating every 8 before the first layer")
    add("beam search: top-k, gathers, token histories", pre[:at])
    add("reorder_cache_ (index_select + copy)", pre[at : at + run])
    add("embedding, positions, causal mask, first LayerNorm", pre[at + run :])
    return out


# ---- phase 5: the alignment path -------------------------------------------


def align_path_phase(torch, card: str):
    """wav2vec2 base (published widths, depth not cut), random weights from
    seed 0, bf16, max_batch 8: bench.py's alignment of its fixed transcript
    to 8 x 30 s of int16 audio (bench.py:257-289), twice. Returns the flash
    and CTC kernel launches counted in the last run, and the align model."""
    from whisperx_tpu_torch.align import alignment
    from whisperx_tpu_torch.audio import N_SAMPLES
    from whisperx_tpu_torch.models.configs import WAV2VEC2_BASE
    from whisperx_tpu_torch.ops import ctc, flash_attn

    batch = 8
    t0 = time.perf_counter()
    am = alignment.test_align_model("en", seed=0, config=WAV2VEC2_BASE, dtype=torch.bfloat16, device="cuda")
    log(f"wav2vec2 base random weights (seed 0), bf16, on the card in {time.perf_counter() - t0:.1f} s")
    meta = {"language": "en", "dictionary": am.dictionary, "type": "torch"}
    audio = (np.random.default_rng(0).standard_normal((batch, N_SAMPLES)) * 0.1).astype(np.float32).reshape(-1)
    transcript = align_transcript(batch)
    audio_s = sum(s["end"] - s["start"] for s in transcript)

    def run():
        return alignment.align_begin([dict(s) for s in transcript], am, meta, audio).finish()

    run()  # one-time set-up (cuBLAS handles, pinned buffers), outside the counted runs
    want = am.model.config.num_layers  # one batch: one flash launch per encoder layer
    for i in (1, 2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_attn.launches = ctc.launches = 0
        t0 = time.perf_counter()
        res = run()
        wall = time.perf_counter() - t0
        flash_launches, ctc_launches = flash_attn.launches, ctc.launches
        segs = res["segments"]
        if len(segs) != batch or not all(s["words"] and all("start" in w and "end" in w for w in s["words"]) for s in segs):
            raise AssertionError(f"align path: not every segment aligned: {[len(s['words']) for s in segs]}")
        if flash_launches != want or ctc_launches != 1:
            raise AssertionError(f"align path: flash launched {flash_launches} times, expected {want}; "
                                 f"ctc_align {ctc_launches} times, expected 1 (one batch)")
        log(
            f"align path run {i} [{card}]: {wall * 1e3:.1f} ms for {audio_s:.1f} audio-s, "
            f"{audio_s / wall:.2f} audio-s/s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"{len(res['word_segments'])} words, flash launches {flash_launches}, ctc_align launches {ctc_launches}: ok"
        )
    log(same_alignment_as_plain(torch, "align path", run) + ": ok")

    # Stage split: the same run with a sync after each device stage.
    stages: dict = {}

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            stages[name] = stages.get(name, 0.0) + (time.perf_counter() - t) * 1e3
            return out

        return wrapper

    shapes = []

    def ctc_call(lp, tokens, *a, **kw):
        shapes.append((*lp.shape, tokens.shape[1]))
        return ctc.ctc_align_batch_device(lp, tokens, *a, **kw)

    originals = (alignment._emissions, alignment.ctc_align_batch_device)
    alignment._emissions = timed("emissions", originals[0])
    alignment.ctc_align_batch_device = timed("ctc", ctc_call)
    try:
        t0 = time.perf_counter()
        job = alignment.align_begin([dict(s) for s in transcript], am, meta, audio)
        t1 = time.perf_counter()
        job.finish()
        t2 = time.perf_counter()
        launch_ms = (t1 - t0) * 1e3 - sum(stages.values())
        log(
            f"align stages [{card}]: emissions (wav2vec2 + log-softmax) {stages['emissions']:.1f} ms, "
            f"trellis + backtrack (ctc_align kernel) {stages['ctc']:.2f} ms, host prep and launch "
            f"{launch_ms:.1f} ms, fetch + host aggregation {(t2 - t1) * 1e3:.1f} ms"
        )
    finally:
        alignment._emissions, alignment.ctc_align_batch_device = originals
    log(f"align path ctc_align shapes (B, T, V, N) {sorted(set(shapes))}")
    return flash_launches, ctc_launches, am


class CtcCalls:
    """Records each call of the alignment's CTC entry point
    (``align/alignment.py``'s ``ctc_align_batch_device``, the kernel on the
    card) while active: its inputs (the emissions among them) and its
    outputs, cloned. ``check`` then runs the plain version on the recorded
    inputs and holds the kernel's outputs to it: token indices, active
    steps, success and start rows bit for bit, probs to 1e-6 relative.
    Equal path arrays give equal word timestamps (the host aggregation reads
    no probs for them)."""

    def __init__(self, torch):
        from whisperx_tpu_torch.align import alignment

        self.torch, self.alignment, self.calls = torch, alignment, []
        self.kernel = alignment.ctc_align_batch_device

    def __enter__(self):
        def recorded(*a, **kw):
            out = self.kernel(*a, **kw)
            self.calls.append(([x.clone() for x in a], kw.get("blank", 0), [o.clone() for o in out]))
            return out

        self.alignment.ctc_align_batch_device = recorded
        return self

    def __exit__(self, *exc):
        self.alignment.ctc_align_batch_device = self.kernel

    def check(self, what: str) -> int:
        from whisperx_tpu_torch.ops import ctc

        for args, blank, got in self.calls:
            want = ctc.ctc_align_batch_device_plain(*args, blank=blank)
            for name, g, w in zip(("token_idx", "probs", "active", "success", "t_start"), got, want):
                if name == "probs":
                    max_err_within(self.torch, f"{what}: ctc probs", g, w, 0.0, 1e-6)
                elif not self.torch.equal(g, w):
                    raise AssertionError(f"{what}: the kernel's {name} differs from the plain version's on the same emissions")
        return len(self.calls)

    def plain_run(self, run):
        """``run()`` again with the plain version in place of the kernel, each
        call on the emissions recorded for it (the same order of batches)."""
        from whisperx_tpu_torch.ops import ctc

        recorded = iter(self.calls)

        def plain(lp, tokens, t_len, n_len, blank=0):
            args, _, _ = next(recorded)
            if any(tuple(a.shape) != tuple(b.shape) for a, b in zip(args, (lp, tokens, t_len, n_len))):
                raise AssertionError("plain alignment run: the batches differ from the recorded run's")
            return ctc.ctc_align_batch_device_plain(*args, blank=blank)

        self.alignment.ctc_align_batch_device = plain
        try:
            return run()
        finally:
            self.alignment.ctc_align_batch_device = self.kernel


def word_times(result) -> list:
    return [(w["word"], w.get("start"), w.get("end")) for w in result["word_segments"]]


def same_alignment_as_plain(torch, what: str, run) -> str:
    """``run()`` (an alignment through align_begin(...).finish()) with the
    CTC kernel, recording its calls, then with the plain version on the
    recorded emissions: the path arrays equal (``CtcCalls.check``) and the
    word timestamps equal."""
    with CtcCalls(torch) as calls:
        got = run()
    n = calls.check(what)
    ref = calls.plain_run(run)
    if word_times(got) != word_times(ref) or not got["word_segments"]:
        raise AssertionError(f"{what}: word timestamps differ between the CTC kernel and the plain version")
    return f"{what}: {n} ctc_align batches, paths and {len(got['word_segments'])} word timestamps equal to the plain version's on the same emissions"


# ---- phase 6: the production pipeline --------------------------------------


def pipeline_phase(torch, card: str, model, align_model) -> dict:
    """bench.py's BENCH_PIPELINE configuration (bench.py:105-231) through the
    port's entry points: a WAV file → transcribe (load_audio, SpeechBandVAD
    at onset 0.5 / offset 0.363, batches of 8, int16 uploads, beam 5, 112
    tokens with EOT suppressed, int8 KV cache) → align_begin(...).finish()
    with each chunk's text replaced by bench.py's transcript (bench.py:180).
    Two runs on the port's routes (on the card the cross-attention kernel,
    and the flash kernel in both encoders for bf16 heads of 64): the
    default options, then enable_fallback=True at temperatures (0.0,
    *SAMPLED_TEMPERATURES): on random weights every chunk fails the
    log-prob gate, so each temperature re-decodes BEST_OF sampled copies of
    each chunk in retry batches of 8, each one device-loop launch of one kept
    sampling loop. Returns the default run's launches and the fallback
    run's counts."""
    from whisperx_tpu_torch import native
    from whisperx_tpu_torch.align import alignment
    from whisperx_tpu_torch.audio import io as audio_io
    from whisperx_tpu_torch.decode.engine import WhisperEngine
    from whisperx_tpu_torch.decode.tokenizer import WhisperTokenizer
    from whisperx_tpu_torch.ops import ctc, graph_loop
    from whisperx_tpu_torch.pipeline.asr import TranscriptionOptions, WhisperPipeline
    from whisperx_tpu_torch.utils import telemetry
    from whisperx_tpu_torch.vad.model import SpeechBandVAD, VadPipeline

    cfg = model.config
    batch, beam, max_new = 8, 5, 112
    tok = WhisperTokenizer.dummy(cfg.n_vocab, language="en")
    pipe = WhisperPipeline(
        engine=WhisperEngine(model, tok),
        vad=VadPipeline(SpeechBandVAD(), onset=0.5, offset=0.363),
        vad_params={"vad_onset": 0.5, "vad_offset": 0.363},
        # Suppressing EOT forces the full decode horizon on random weights.
        options=TranscriptionOptions(beam_size=beam, max_new_tokens=max_new, suppress_tokens=(-1, tok.eot)),
        tokenizer=tok,
        language="en",
        kv_cache_dtype="int8",
    )
    fallback = WhisperPipeline(
        engine=pipe.engine, vad=pipe.vad_model, vad_params=pipe._vad_params,
        options=TranscriptionOptions(beam_size=beam, max_new_tokens=max_new, suppress_tokens=(-1, tok.eot),
                                     enable_fallback=True, temperatures=(0.0, *SAMPLED_TEMPERATURES), best_of=BEST_OF),
        tokenizer=tok, language="en", kv_cache_dtype="int8",
    )
    retries = []  # the temperature of each sampled decode batch
    generate = WhisperEngine.generate

    def counted_generate(self, mel, **kw):
        if kw["options"].temperature > 0:
            retries.append(kw["options"].temperature)
        return generate(self, mel, **kw)

    meta = {"language": "en", "dictionary": align_model.dictionary, "type": "torch"}
    audio = pipeline_audio(PIPELINE_MINUTES)
    audio_s = len(audio) / 16000
    # The native decoder is compiled by g++ on its first use: once per
    # checkout, outside the timed runs (as the kernels' nvcc build is).
    t0 = time.perf_counter()
    ready = native.available()
    log(f"native audio decoder {'built' if ready else 'unavailable (numpy fallback)'} in {time.perf_counter() - t0:.2f} s")
    arms = {"default": pipe, "fallback": fallback}
    L, runs = cfg.n_text_layer, {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pipeline.wav")
        audio_io.write_wav(path, audio)
        for arm, p in arms.items():
            WhisperEngine.generate = counted_generate
            retries.clear()
            try:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                p.telemetry.stages.clear()
                telemetry.GLOBAL.stages.clear()
                zero_launches()
                t0 = time.perf_counter()
                result = p.transcribe(path, batch_size=batch)
                decoder = audio_io.LAST_DECODER
                t1 = time.perf_counter()
                segs = [dict(s, text=ALIGN_TEXT) for s in result["segments"]]
                aligned = alignment.align_begin(segs, align_model, meta, path).finish()
                t2 = time.perf_counter()
                launches, loop_graphs, ctc_launches = read_launches(), graph_loop.launches, ctc.launches
            finally:
                WhisperEngine.generate = generate
            chunks = result["segments"]
            n_batches = -(-len(chunks) // batch)  # decode batches; align batches too (max batch 8)
            if n_batches < 2 or len(chunks) % batch == 0:
                raise AssertionError(f"pipeline {arm}: {len(chunks)} chunks, expected two or more batches, the last partial")
            if any(s["end"] - s["start"] > 30.0 for s in chunks):
                raise AssertionError(f"pipeline {arm}: a chunk longer than 30 s: {chunks}")
            if len(aligned["segments"]) != len(chunks) or not all(
                s["words"] and all("start" in w and "end" in w for w in s["words"]) for s in aligned["segments"]
            ):
                raise AssertionError(f"pipeline {arm}: not every chunk aligned: {[len(s['words']) for s in aligned['segments']]}")
            # Each retry batch holds BEST_OF copies of the failed chunks, padded to 8 rows.
            n_retry = len(SAMPLED_TEMPERATURES) * -(-len(chunks) * BEST_OF // batch) if arm == "fallback" else 0
            if len(retries) != n_retry:
                raise AssertionError(f"pipeline {arm}: {len(retries)} sampled decode batches {retries}, expected {n_retry}")
            want = {
                "int8_matmul": 6 * L * (1 + max_new) * (n_batches + n_retry),
                "cross_attention_decode": L * (1 + max_new) * (n_batches + n_retry),
                # Every encoder pass (a retry batch encodes its mel again) and
                # every align batch launches the flash kernel once a layer.
                "flash_self_attention": (cfg.n_audio_layer * (n_batches + n_retry)
                                         + align_model.model.config.num_layers * n_batches),
                "log_mel": 0,
                "self_attn_decode": L * max_new * (n_batches + n_retry),
            }
            if launches != want or loop_graphs != n_batches + n_retry or ctc_launches != n_batches:
                raise AssertionError(
                    f"pipeline {arm}: launches {launches}, {loop_graphs} loop graphs, {ctc_launches} ctc_align; expected "
                    f"{want}, {n_batches + n_retry}, {n_batches}"
                )
            stages = {**p.telemetry.report(), **telemetry.GLOBAL.report()}
            peak = torch.cuda.max_memory_allocated() / 2**30
            runs[arm] = {"vad": [(s["start"], s["end"]) for s in chunks], "segments": chunks, "retry_batches": n_retry, "peak_gib": peak,
                         "launches": {**launches, "decode_while_loop": loop_graphs, "ctc_align": ctc_launches}}
            log(
                f"pipeline {arm} arm [{card}]: {audio_s:.1f} s WAV (decoded by {decoder}) -> {len(chunks)} chunks, "
                f"{n_batches} decode batches of {batch} (last {len(chunks) - (n_batches - 1) * batch} rows), {n_batches} "
                f"align batches; transcribe {(t1 - t0) * 1e3:.1f} ms, align {(t2 - t1) * 1e3:.1f} ms, end to end "
                f"{audio_s / (t2 - t0):.2f} audio-s/s; stages "
                + ", ".join(f"{k} {stages[k]['seconds'] * 1e3:.1f} ms" for k in ("vad", "asr_decode", "align"))
                + f"; peak {peak:.2f} GiB; launches {launches}, {loop_graphs} WHILE-graph launches ({n_batches} beam "
                f"batches, {n_retry} sampled retry batches at temperatures {sorted(set(retries))}), ctc_align "
                f"{ctc_launches} (one an align batch); {held_loops(model)}: ok"
            )
    default_segs = [dict(s, text=ALIGN_TEXT) for s in runs["default"]["segments"]]
    log(same_alignment_as_plain(torch, "pipeline chunks", lambda: alignment.align_begin(
        [dict(s) for s in default_segs], align_model, meta, audio).finish()) + ": ok")
    if runs["default"]["vad"] != runs["fallback"]["vad"]:
        raise AssertionError("pipeline: the two runs' VAD segments differ")
    log(f"pipeline: both runs cut the same {len(runs['default']['vad'])} VAD segments: ok")
    fb = runs["fallback"]
    return runs["default"]["launches"], {k: fb[k] for k in ("retry_batches", "peak_gib", "launches")}


def small_train_phase(torch) -> None:
    """fp32 training of a 128-wide Whisper (heads of 64, "xla" attention,
    TF32 off) on the card and on the CPU: three AdamW steps (lr 1e-3) from
    the same tree on the same batch give the same losses (1e-5 relative)
    and the same parameters (1e-4 absolute: each step moves a weight by up
    to lr, the two devices sum in other orders, and Adam's m̂/√v̂ magnifies
    that where a gradient is near 0; the CPU tests hold the port to JAX at
    the same tolerance). Then a ``save_params``/``load_params`` round trip of
    the card's trained model gives the same forward, bit for bit. (The 6 GB
    full-width checkpoint of phase 8 is not written, to save the script's
    time.)"""
    from whisperx_tpu_torch import train
    from whisperx_tpu_torch.models import whisper as tw
    from whisperx_tpu_torch.models.configs import TEST_CONFIG
    from whisperx_tpu_torch.models.convert import whisper_from_jax, whisper_to_jax
    from whisperx_tpu_torch.utils.checkpoint import flatten_params, load_params, save_params

    cfg = dataclasses.replace(TEST_CONFIG, n_text_state=128, n_audio_state=128, n_text_head=2, n_audio_head=2)
    params = tw.random_params(cfg, seed=0, scale=0.05)
    rng = np.random.default_rng(5)
    mel = torch.from_numpy((rng.standard_normal((2, cfg.n_mels, 3000)) * 0.5).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, 1000, (2, 10)))
    mask = torch.ones((2, 10))
    mask[1, 7:] = 0.0
    losses, trees, models = {}, {}, {}
    for dev in ("cuda", "cpu"):
        models[dev] = whisper_from_jax(params, cfg, device=dev).trainable()
        step = train.make_train_step(models[dev], train.make_optimizer(models[dev].parameters(), lr=1e-3))
        losses[dev] = [float(step(mel, tokens, mask)) for _ in range(3)]
        trees[dev] = whisper_to_jax(models[dev])
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    if not (np.isfinite(losses["cuda"]).all() and loss_err <= 1e-5):
        raise AssertionError(f"small train: card losses {losses['cuda']} vs cpu {losses['cpu']}")
    flat = {dev: dict(flatten_params(t)) for dev, t in trees.items()}
    param_err = max(float(np.abs(flat["cuda"][k] - flat["cpu"][k]).max()) for k in flat["cpu"])
    moved = max(float(np.abs(flat["cpu"][k] - v).max()) for k, v in flatten_params(params))
    if param_err > 1e-4 or moved < 1e-3:
        raise AssertionError(f"small train: parameters differ by {param_err} (atol 1e-4) after moving {moved}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "small-trained.safetensors")
        save_params(trees["cuda"], path)
        again = whisper_from_jax(load_params(path), cfg, device="cuda")
    with torch.no_grad():
        want = models["cuda"](mel.cuda(), tokens[:, :-1].cuda())
        got = again(mel.cuda(), tokens[:, :-1].cuda())
    if not torch.equal(got, want):
        raise AssertionError(f"small train: forward after the checkpoint round trip differs by {(got - want).abs().max().item()}")
    log(
        f"small train (128 wide, fp32, xla, 3 AdamW steps): card losses {[round(x, 6) for x in losses['cuda']]} == cpu "
        f"within {loss_err:.2g} (rtol 1e-5), parameters within {param_err:.3g} (atol 1e-4, moved {moved:.3g}); "
        f"save_params/load_params round trip: forward bit-equal: ok"
    )


# ---- phase 7: the command line at full width --------------------------------

CLI_MINUTES = 6.0  # two speakers in ~45 s turns; the all-active VAD cuts 30 s chunks


def cli_phase(torch, card: str, tmp: str) -> dict:
    """``whisperx_tpu_torch.cli.cli`` in-process, as a user runs
    ``python -m whisperx_tpu_torch <wav> --diarize``, on checkpoints written
    here from seeds in their published layouts (nothing reused from phases
    4-6, so the loaders run on the card): large-v2 as an HF directory (fp16
    safetensors, BPE files), wav2vec2 base as an HF directory, a WeSpeaker
    ResNet34 ``.bin`` (pyannote wrapper layout) and a pyannote PyanNet
    ``.bin`` whose classifier bias is +3, so that every class is active and
    the path runs deterministically: neural VAD finds speech everywhere,
    30 s chunks, every (window, class) pair embedded and clustered. int8,
    batch 8, beam 5, EOT banned (the 224-token default horizon), the port's
    defaults otherwise (no kernel env knob: on the card the cross-attention
    kernel, and the flash kernel in both encoders, which "auto" takes for
    bf16 heads of 64). The files stay in
    ``tmp`` for phase 9. Returns the launches, the two HF directories, the
    int8 model's weight bytes and load_model's time."""
    from whisperx_tpu_torch import cli, native
    from whisperx_tpu_torch.align import alignment
    from whisperx_tpu_torch.audio import io as audio_io
    from whisperx_tpu_torch.decode.engine import WhisperEngine
    from whisperx_tpu_torch.diarize import embed, segmentation
    from whisperx_tpu_torch.io import get_writer
    from whisperx_tpu_torch.models.configs import WAV2VEC2_BASE, get_whisper_config
    from whisperx_tpu_torch.ops import ctc, graph_loop

    cfg = get_whisper_config("large-v2")
    steps, L, batch = cfg.n_text_ctx // 2, cfg.n_text_layer, 8  # decode/engine.py's default horizon
    times: dict = {}
    seen: dict = {"generate": 0, "pool_decodes": 0, "align_batches": 0}

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[name] = times.get(name, 0.0) + time.perf_counter() - t
            if name == "transcribe":
                seen["chunks"] = len(a[1][0].result["segments"])
                # Read what the pipeline holds, then drop this script's
                # reference: the CLI frees the model and its device loops
                # before alignment, as it does for a user.
                pipe = seen.pop("pipeline")
                seen.update(stages=pipe.telemetry.report(), weights=weight_bytes(pipe.model), held=held_loops(pipe.model),
                            transcribe_peak=torch.cuda.max_memory_allocated() / 2**30)
                del pipe
                gc.collect()
                seen["freed_to"] = torch.cuda.memory_allocated() / 2**30
            if name == "load_model":
                seen["pipeline"] = out
            return out

        return wrapper

    def counted(key, fn):
        def wrapper(*a, **kw):
            seen[key] += 1
            return fn(*a, **kw)

        return wrapper

    def assign(turns, result, *a, **kw):
        seen["turns"] = turns
        return cli_assign(turns, result, *a, **kw)

    t0 = time.perf_counter()
    whisper_dir = write_hf_whisper(os.path.join(tmp, "hf-whisper-large"), cfg, seed=0, dtype="F16")
    w2v_dir = write_hf_wav2vec2(os.path.join(tmp, "hf-wav2vec2-base"), WAV2VEC2_BASE, seed=0)
    wespeaker = write_wespeaker_bin(os.path.join(tmp, "wespeaker-resnet34.bin"), seed=0)
    pyannet = write_pyannet_bin(os.path.join(tmp, "segmentation.bin"), seed=0, classifier_bias=3.0)
    audio = conversation_audio(CLI_MINUTES)
    wav = os.path.join(tmp, "conversation.wav")
    audio_io.write_wav(wav, audio)
    audio_s = len(audio) / 16000
    sizes = {os.path.basename(p): os.path.getsize(os.path.join(p, "model.safetensors") if os.path.isdir(p) else p)
             for p in (whisper_dir, w2v_dir, wespeaker, pyannet)}
    log(f"cli inputs written from seeds in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {v / 2**20:.1f} MiB" for k, v in sizes.items()) + f"; {audio_s:.1f} s WAV")
    native.available()  # the g++ build, outside the timed run

    out = os.path.join(tmp, "out")
    argv = [wav, "--checkpoint", whisper_dir, "--compute_type", "int8", "--batch_size", str(batch),
            "--beam_size", "5", "--language", "en", "--align_model", w2v_dir, "--vad_checkpoint", pyannet,
            "--diarize", "--diarize_checkpoint", wespeaker, "--min_speakers", "2", "--max_speakers", "2",
            "--suppress_tokens=-1,50257", "--output_dir", out, "--output_format", "all", "--verbose", "False"]
    cli_assign = cli.assign_word_speakers
    patches = [
        (cli, "assign_word_speakers", assign),
        (cli, "load_model", timed("load_model", cli.load_model)),
        (cli, "load_align_model", timed("load_align_model", cli.load_align_model)),
        (cli, "DiarizationPipeline", timed("DiarizationPipeline", cli.DiarizationPipeline)),
        (cli, "_transcribe_stage", timed("transcribe", cli._transcribe_stage)),
        (cli, "_align_stage", timed("align", cli._align_stage)),
        (cli, "_diarize_stage", timed("diarize", cli._diarize_stage)),
        (cli, "_write_stage", timed("write", cli._write_stage)),
        (segmentation.NeuralSegmentation, "__call__", timed("segmentation forward", segmentation.NeuralSegmentation.__call__)),
        (embed.NeuralSpeakerEmbedding, "__call__", timed("fbank + ResNet34", embed.NeuralSpeakerEmbedding.__call__)),
        (segmentation, "cluster_speakers", timed("clustering", segmentation.cluster_speakers)),
        (segmentation, "binarize", timed("binarize", segmentation.binarize)),
        (WhisperEngine, "generate", counted("generate", WhisperEngine.generate)),
        (native.IngestPool, "get", counted("pool_decodes", native.IngestPool.get)),
        (alignment, "_fused_align_fwd", counted("align_batches", alignment._fused_align_fwd)),
    ]
    originals = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    audio_io.LAST_DECODER = None
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t0 = time.perf_counter()
        with CtcCalls(torch) as ctc_calls:
            cli.cli(argv)
        wall = time.perf_counter() - t0
        launches, loop_graphs, ctc_launches = read_launches(), graph_loop.launches, ctc.launches
    finally:
        for obj, name, fn in originals:
            setattr(obj, name, fn)
    peak = torch.cuda.max_memory_allocated() / 2**30
    written = sorted(os.listdir(out))
    with open(os.path.join(out, "conversation.json")) as f:
        result = json.load(f)
    # "all" writes five formats, as in the JAX CLI; the sixth, "aud", from the same result.
    get_writer("aud", out)(result, wav, {"max_line_width": None, "max_line_count": None, "highlight_words": False})
    written_all = sorted(os.listdir(out))
    stages = seen["stages"]

    n_batches = -(-seen["chunks"] // batch)
    # The default "auto" launches flash once an encoder layer: every decode batch and every align batch.
    want = {"int8_matmul": 6 * L * (1 + steps) * n_batches, "cross_attention_decode": L * (1 + steps) * n_batches,
            "flash_self_attention": cfg.n_audio_layer * n_batches + WAV2VEC2_BASE.num_layers * seen["align_batches"],
            "log_mel": 0, "self_attn_decode": L * steps * n_batches}
    if written != sorted(f"conversation.{e}" for e in ("txt", "vtt", "srt", "tsv", "json")) or len(written_all) != 6:
        raise AssertionError(f"cli: wrote {written}, then {written_all}")
    if seen["generate"] != n_batches or n_batches < 2:
        raise AssertionError(f"cli: {seen['chunks']} chunks, {seen['generate']} decode batches")
    # One file: AudioPrefetcher's native pool decodes it once, and the later
    # stages reuse the waveform; load_audio's own routes are never taken.
    if seen["pool_decodes"] != 1 or audio_io.LAST_DECODER is not None:
        raise AssertionError(f"cli: {seen['pool_decodes']} pool decodes, load_audio route {audio_io.LAST_DECODER}")
    if launches != want or loop_graphs != n_batches or ctc_launches != seen["align_batches"] or not ctc_launches:
        raise AssertionError(
            f"cli: launches {launches}, {loop_graphs} loop graphs, {ctc_launches} ctc_align; expected {want}, {n_batches} "
            f"({n_batches} decode batches of {steps} steps), {seen['align_batches']} (one an align batch)"
        )
    segs = result["segments"]
    if not segs or any(s["end"] - s["start"] > 30.0 for s in segs):
        raise AssertionError(f"cli: segments empty or longer than 30 s: {[(s['start'], s['end']) for s in segs]}")
    ctc_checked = ctc_calls.check("cli")
    speakers = [s.get("speaker") for s in segs]
    if not set(speakers) <= {"SPEAKER_00", "SPEAKER_01"} or None in speakers:
        raise AssertionError(f"cli: a segment without a speaker of the two: {sorted(set(map(str, speakers)))}")
    turn_speakers = sorted(set(seen["turns"]["speaker"]))
    if turn_speakers != ["SPEAKER_00", "SPEAKER_01"]:
        raise AssertionError(f"cli: --min_speakers 2 --max_speakers 2 gave turns of {turn_speakers}")
    helped = subprocess.run([sys.executable, "-m", "whisperx_tpu_torch", "--help"], capture_output=True, text=True, timeout=120)
    if helped.returncode != 0 or "--diarize_checkpoint" not in helped.stdout:
        raise AssertionError(f"python -m whisperx_tpu_torch --help: rc {helped.returncode}: {helped.stderr[-500:]}")

    ms = {k: v * 1e3 for k, v in times.items()}
    run_ms = sum(ms[k] for k in ("transcribe", "align", "diarize", "write"))
    loads = ms["load_model"] + ms["load_align_model"] + ms["DiarizationPipeline"]
    log(
        f"cli [{card}]: python -m whisperx_tpu_torch <{audio_s:.1f} s WAV> --compute_type int8 --batch_size 8 "
        f"--beam_size 5 --vad_checkpoint --diarize --diarize_checkpoint, large-v2 / wav2vec2 base / ResNet34 / "
        f"PyanNet: {seen['chunks']} chunks, {n_batches} decode batches of {steps} steps; loads: load_model "
        f"{ms['load_model']:.1f} ms, load_align_model {ms['load_align_model']:.1f} ms, DiarizationPipeline with the "
        f"converters {ms['DiarizationPipeline']:.1f} ms; stages: transcribe {ms['transcribe'] - ms['load_model']:.1f} ms "
        f"(vad {stages['vad']['seconds'] * 1e3:.1f}, asr_decode {stages['asr_decode']['seconds'] * 1e3:.1f}), align "
        f"{ms['align'] - ms['load_align_model']:.1f} ms, diarize {ms['diarize'] - ms['DiarizationPipeline']:.1f} ms "
        f"(segmentation forward {ms['segmentation forward']:.1f}, fbank + ResNet34 {ms['fbank + ResNet34']:.1f}, "
        f"clustering {ms['clustering']:.1f}, binarize {ms['binarize']:.1f}), write {ms['write']:.1f} ms; "
        f"file {audio_s / wall:.2f} audio-s/s end to end ({wall:.1f} s with the loads), "
        f"{audio_s / ((run_ms - loads) / 1e3):.2f} audio-s/s without them; peak {peak:.2f} GiB over the run, "
        f"{seen['transcribe_peak']:.2f} GiB by the end of the transcribe stage ({seen['held']} there), "
        f"{seen['freed_to']:.2f} GiB allocated once that stage dropped its model; the WAV decoded once "
        f"by AudioPrefetcher's native pool (load_audio's routes not taken: LAST_DECODER None); "
        f"{len(seen['turns'])} speaker turns of {turn_speakers}; {len(segs)} segments, speakers "
        f"{sorted(set(speakers))}, six files; launches {launches}, one WHILE-graph launch a decode batch, "
        f"ctc_align {ctc_launches} (one an align batch; the {ctc_checked} batches' paths equal to the plain "
        f"version's on the same emissions, so the word timestamps are); "
        f"python -m whisperx_tpu_torch --help rc 0: ok"
    )
    return {"launches": {**launches, "decode_while_loop": loop_graphs, "ctc_align": ctc_launches}, "whisper_dir": whisper_dir, "w2v_dir": w2v_dir,
            "wespeaker": wespeaker, "pyannet": pyannet,
            "weights": seen["weights"], "load_model_ms": ms["load_model"]}


# ---- phase 9: int4 weights and KV cache, the int8 wav2vec2 ----------------

INT4_MINUTES = 5.0  # 8 VAD chunks (SpeechBandVAD, chunk_size 30): one full decode batch of 8
INT4_CHUNKS = 8


def weight_bytes(model) -> dict:
    """Bytes of a model's Dense kernels, and of all its parameters."""
    from whisperx_tpu_torch.models.whisper import Dense

    dense = sum(m.kernel.numel() * m.kernel.element_size() for m in model.modules() if isinstance(m, Dense))
    return {"dense": dense, "all": sum(p.numel() * p.element_size() for p in model.parameters())}


def int4_phase(torch, card: str, whisper_dir: str, w2v_dir: str, int8: dict) -> dict:
    """The int4 path through the entry points a user calls, at full width:
    ``load_model(checkpoint=<phase 7's large-v2 HF directory>,
    compute_type="int4", language="en")`` (beam 5, 112 tokens, EOT banned:
    phases 4 and 6's configuration) and ``load_align_model(<phase 7's
    wav2vec2 base directory>, compute_type="int8")``; 5 minutes of phase
    6's tone bursts (8 VAD chunks: one full decode batch) → transcribe →
    align_begin(...).finish() on the chunks, then on 4 segments of 0.9 s
    (one 1 s alignment batch of 4 x 49 frames: every int8 projection of
    wav2vec2 base goes through int8_matmul). Two arms in turns, both on the
    port's routes (flash attention in both encoders): (a) int4 weights with
    the default KV ("auto" → int8), whose cross attention takes the kernel;
    (b) int4 weights and kv_cache_dtype="int4", which keeps the einsum.
    Then each arm's beam loop once more, stage by stage, on 8 x 30 s of
    noise. Returns arm (b)'s launches."""
    from whisperx_tpu_torch.align.alignment import align_begin, load_align_model
    from whisperx_tpu_torch.audio import N_SAMPLES, log_mel_spectrogram, pcm16
    from whisperx_tpu_torch.decode.engine import WhisperEngine
    from whisperx_tpu_torch.decode.search import beam_decode
    from whisperx_tpu_torch.models import convert
    from whisperx_tpu_torch.models import whisper as tw
    from whisperx_tpu_torch.ops import flash_attn, graph_loop
    from whisperx_tpu_torch.ops.quant import PACKED_INT4
    from whisperx_tpu_torch.pipeline.asr import load_model
    from whisperx_tpu_torch.utils import telemetry

    batch, beam, max_new, eot = 8, 5, 112, 50257
    loads: dict = {}

    def timed(name, fn):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            loads[name] = loads.get(name, 0.0) + (time.perf_counter() - t) * 1e3
            return out

        return wrapper

    patches = [(convert, "read_whisper"), (tw, "quantize_params"), (tw, "fuse_qkv_params"), (convert, "whisper_from_jax")]
    originals = [(obj, name, getattr(obj, name)) for obj, name in patches]
    for obj, name, fn in originals:
        setattr(obj, name, timed(name, fn))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pipe = load_model(
            "large-v2", checkpoint=whisper_dir, compute_type="int4", language="en",
            asr_options={"beam_size": beam, "max_new_tokens": max_new, "suppress_tokens": (-1, eot)},
        )
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for obj, name, fn in originals:
            setattr(obj, name, fn)
    load_peak = torch.cuda.max_memory_allocated() / 2**30
    model, cfg = pipe.model, pipe.model.config
    if pipe.tokenizer.eot != eot or pipe.kv_cache_dtype != "int8" or model.quant_bits != 4 or not model.fused_qkv:
        raise AssertionError(f"int4 load_model: eot {pipe.tokenizer.eot}, kv {pipe.kv_cache_dtype}, bits {model.quant_bits}")
    denses = [m for m in model.modules() if isinstance(m, tw.Dense)]
    for m in denses:
        stored = m.kernel.numel() * m.kernel.element_size()
        if m.kernel.dtype != PACKED_INT4 or stored * 2 != m.in_features * m.features:
            raise AssertionError(f"int4 Dense {m.in_features}x{m.features}: {stored} bytes of {m.kernel.dtype}")
    w4 = weight_bytes(model)
    log(
        f"int4 load_model [{card}]: {load_ms:.1f} ms (read_whisper {loads['read_whisper']:.1f}, quantize_params(bits=4) "
        f"{loads['quantize_params']:.1f}, fuse_qkv_params {loads['fuse_qkv_params']:.1f}, whisper_from_jax with the "
        f"packing {loads['whisper_from_jax']:.1f} ms); phase 7's int8 load_model {int8['load_model_ms']:.1f} ms; "
        f"{len(denses)} Dense kernels, each K*N/2 bytes: {w4['dense'] / 2**30:.3f} GiB (int8: {int8['weights']['dense'] / 2**30:.3f} GiB); "
        f"all weights {w4['all'] / 2**30:.3f} GiB (int8: {int8['weights']['all'] / 2**30:.3f} GiB); load peak {load_peak:.2f} GiB: ok"
    )
    t0 = time.perf_counter()
    am, meta = load_align_model("en", model_name=w2v_dir, compute_type="int8")
    torch.cuda.synchronize()
    align_load_ms = (time.perf_counter() - t0) * 1e3
    w2v = am.model
    if not (w2v.quantized and w2v.feat_projection.kernel.dtype == torch.int8 and w2v.lm_head.kernel.dtype == torch.float32):
        raise AssertionError("load_align_model(compute_type='int8'): not the int8 wav2vec2")
    log(f"int8 load_align_model [{card}]: {align_load_ms:.1f} ms, {weight_bytes(w2v)['dense'] / 2**20:.1f} MiB of Dense kernels: ok")

    audio = pipeline_audio(INT4_MINUTES)
    short = [{"start": 25.0 * i + 1.0, "end": 25.0 * i + 1.9, "text": " the quick brown fox"} for i in range(4)]
    n_w2v, L = w2v.config.num_layers, cfg.n_text_layer
    w2v_int8 = 1 + 6 * n_w2v  # feat_projection + 6 projections a layer, in the 1 s batch only
    arms = {"a": "int8", "b": "int4"}  # the KV cache
    flash = cfg.n_audio_layer + 2 * n_w2v  # the encoder and 2 alignment batches
    want = {
        "a": {"int8_matmul": w2v_int8, "cross_attention_decode": L * (1 + max_new), "flash_self_attention": flash, "log_mel": 0,
              "self_attn_decode": L * max_new},
        "b": {"int8_matmul": w2v_int8, "cross_attention_decode": 0, "flash_self_attention": flash, "log_mel": 0,
              "self_attn_decode": 0},
    }
    for w in want.values():
        w.update(flash_attention_bwd_dq=0, flash_attention_bwd_dkv=0)
    results: list = []
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    step_fn = model.decode_step

    def checked_step(tokens, cache, index):
        logits, cache = step_fn(tokens, cache, index)
        finite.logical_and_(torch.isfinite(logits).all())  # on the device: no sync
        return logits, cache

    def recorded(self, *a, **kw):
        out = generate(self, *a, **kw)
        results.append(out)
        return out

    generate = WhisperEngine.generate
    WhisperEngine.generate = recorded
    model.decode_step = checked_step
    runs: dict = {}
    try:
        for arm in ("a", "b", "b", "a"):  # in turns: two runs each
            kv = pipe.kv_cache_dtype = arms[arm]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            pipe.telemetry.stages.clear()
            telemetry.GLOBAL.stages.clear()
            zero_launches()
            flash_attn.launches_bwd_dq = flash_attn.launches_bwd_dkv = 0
            results.clear()
            finite.fill_(True)
            t0 = time.perf_counter()
            result = pipe.transcribe(audio, batch_size=batch)
            t1 = time.perf_counter()
            segs = [dict(s, text=ALIGN_TEXT) for s in result["segments"]]
            aligned = align_begin(segs, am, meta, audio).finish()
            chunk_int8 = read_launches()["int8_matmul"]
            t2 = time.perf_counter()
            aligned_short = align_begin([dict(s) for s in short], am, meta, audio).finish()
            t3 = time.perf_counter()
            launches = {**read_launches(), "flash_attention_bwd_dq": flash_attn.launches_bwd_dq,
                        "flash_attention_bwd_dkv": flash_attn.launches_bwd_dkv}
            loop_graphs = graph_loop.launches
            chunks = result["segments"]
            if len(chunks) != INT4_CHUNKS or len(results) != 1:
                raise AssertionError(f"int4 arm {arm}: {len(chunks)} segments, {len(results)} decode batches; expected {INT4_CHUNKS}, 1")
            res = results[0]
            if not bool(finite) or not all(np.isfinite(v).all() for v in (res.sum_logprobs, res.avg_logprobs, res.no_speech_probs)):
                raise AssertionError(f"int4 arm {arm}: non-finite logits or log-probs")
            if not (res.lengths == max_new + 1).all():
                raise AssertionError(f"int4 arm {arm}: EOT is banned, yet lengths are {res.lengths}")
            for what, out, n in (("chunks", aligned, INT4_CHUNKS), ("short", aligned_short, len(short))):
                if len(out["segments"]) != n or not all(
                    sg["words"] and all("start" in w and "end" in w for w in sg["words"]) for sg in out["segments"]
                ):
                    raise AssertionError(f"int4 arm {arm}: {what} not every segment aligned")
            if chunk_int8 != 0 or launches != want[arm] or loop_graphs != 1:
                raise AssertionError(
                    f"int4 arm {arm}: launches {launches} ({chunk_int8} in the chunks' batch), {loop_graphs} loop graphs; "
                    f"expected {want[arm]}, 1"
                )
            stages = {**pipe.telemetry.report(), **telemetry.GLOBAL.report()}
            dec_ms = stages["asr_decode"]["seconds"] * 1e3
            runs.setdefault(arm, []).append({"vad": [(c["start"], c["end"]) for c in chunks],
                                             "launches": {**launches, "decode_while_loop": loop_graphs},
                                             "decode_ms": dec_ms, "align_ms": (t3 - t1) * 1e3})
            log(
                f"int4 arm ({arm}) kv={kv} [{card}]: "
                f"{len(audio) / 16000:.1f} s -> {len(chunks)} chunks, one decode batch of {batch}; transcribe "
                f"{(t1 - t0) * 1e3:.1f} ms (vad {stages['vad']['seconds'] * 1e3:.1f}, asr_decode {dec_ms:.1f} ms = "
                f"{dec_ms / (1 + max_new):.2f} ms a step with the encoder and prompt); align {(t2 - t1) * 1e3:.1f} ms "
                f"(8 chunks) + {(t3 - t2) * 1e3:.1f} ms (4 x 0.9 s); peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                f"({held_loops(model)}); "
                f"logits finite; launches {launches}: ok"
            )
    finally:
        WhisperEngine.generate = generate
        del model.decode_step
    if runs["a"][0]["vad"] != runs["b"][0]["vad"]:
        raise AssertionError("int4: the two arms' VAD chunks differ")

    # Each arm's beam loop once more, stage by stage (phase 4's split, same
    # shapes), the loop as one device-loop launch and on the host loop.
    engine = WhisperEngine(model, pipe.tokenizer)
    raw = pcm16((np.random.default_rng(0).standard_normal((batch, N_SAMPLES)) * 0.1).astype(np.float32))
    split = {}
    for arm, kv in arms.items():
        opts = engine.build_options(beam_size=beam, max_new_tokens=max_new, kv_cache_dtype=kv)
        opts = dataclasses.replace(opts, banned_tokens=opts.banned_tokens + (eot,))
        cross = engine._cross_impl(opts)
        with torch.inference_mode():
            stamps = [time.perf_counter()]

            def mark():
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())

            mel_b = log_mel_spectrogram(raw, n_mels=cfg.n_mels).to(torch.bfloat16)
            mark()
            states = engine._encode(mel_b)
            mark()
            prompt = engine.build_prompt(batch)
            key = ("beam", batch, prompt.shape[1], opts, cross)
            logits, cache, _ = engine._prompt_cache(
                states, prompt, engine._cache_len(prompt.shape[1], opts), kv_bits=engine._kv_bits(opts), cross_impl=cross,
                cross=engine._loop_cross(key),
            )
            mark()
            engine._device_loop(key, logits, cache)  # the capture, outside the timing
            mark()
            device = engine._device_loop(key, logits, cache)
            mark()
            expanded = [{n: b.repeat_interleave(beam, dim=0) for n, b in layer.items()} for layer in cache["self"]]
            host = beam_decode(engine._step_fn(cache["cross"]), logits, expanded, prompt.shape[1], opts)
            mark()
            same_loops(torch, f"int4 arm ({arm})", device, host)
        mel_ms, enc_ms, prompt_ms, capture_ms, dev_ms, host_ms = (1e3 * (b - a) for a, b in zip(stamps, stamps[1:]))
        split[arm] = (dev_ms / max_new, host_ms / max_new)
        graph = model.decode_loops[("beam", batch, prompt.shape[1], opts, cross)][2]
        log(
            f"int4 stages arm ({arm}) kv={kv} cross={cross} [{card}]: mel {mel_ms:.1f} ms, "
            f"encoder {enc_ms:.1f} ms, prompt {prompt_ms:.1f} ms, device loop {dev_ms:.1f} ms ({split[arm][0]:.2f} "
            f"ms/step; its first launch with the capture {capture_ms:.1f} ms: capture {graph.capture_ms:.1f}, "
            f"instantiate {graph.instantiate_ms:.1f} ms, pool {graph.pool_bytes / 2**20:.1f} MiB), host loop "
            f"{host_ms:.1f} ms ({split[arm][1]:.2f} ms/step); tokens, sum_logprobs and lengths equal between the loops"
        )
    mean = {arm: {k: float(np.mean([r[k] for r in rs])) for k in ("decode_ms", "align_ms")} for arm, rs in runs.items()}
    log(
        f"int4 summary [{card}]: load_model {load_ms:.1f} ms, Dense weights {w4['dense'] / 2**30:.3f} GiB (int8 "
        f"{int8['weights']['dense'] / 2**30:.3f}); asr_decode a step (a) {mean['a']['decode_ms'] / (1 + max_new):.2f} ms, "
        f"(b) {mean['b']['decode_ms'] / (1 + max_new):.2f} ms; beam loop (a) {split['a'][0]:.2f} ms/step on the device "
        f"loop, {split['a'][1]:.2f} on the host loop, (b) {split['b'][0]:.2f} / {split['b'][1]:.2f} ms/step; align (a) "
        f"{mean['a']['align_ms']:.1f} ms, (b) {mean['b']['align_ms']:.1f} ms: ok"
    )
    return runs["b"][-1]["launches"]


# ---- phase 10: the parallel path -------------------------------------------
# One card: a world of one over NCCL in this process, then two ranks sharing
# the card over gloo (NCCL refuses two ranks on one device). Two ranks on one
# card say nothing of multi-card speed: every collective is staged through
# the host, and both ranks' kernels share one card.

# (b): the first step's log-probs of the split model against the whole one,
# both bf16 on this card. The row splits sum fp32 partial products in
# another order (and round to bf16 once, after the sum, where the whole
# model's dequantized encoder products round three times), so a few bf16
# ulps move over 32 encoder and 32 decoder layers.
TP_LOGPROB_ATOL = 0.25


def parallel_audio(torch):
    """(b)'s batch: 8 x 30 s of int16 noise from seed 0 (phase 4's)."""
    from whisperx_tpu_torch.audio import N_SAMPLES, pcm16

    return pcm16((np.random.default_rng(0).standard_normal((8, N_SAMPLES)) * 0.1).astype(np.float32))


def captured_decode(torch, pipe, wavs) -> dict:
    """One ``generate`` of the 8-chunk batch through ``pipe``'s engine and
    front end (beam 5, 112 tokens, EOT suppressed by the pipeline's options),
    on the port's routes (every kernel of the path); the beam loop (the host
    loop under a model split, else the device loop, whose first use is a
    capture outside the timed call) is wrapped to keep the first step's
    log-probs and time the loop. Returns tokens, log-probs, times, launches
    and which loop ran."""
    from whisperx_tpu_torch.decode import engine as engine_mod

    opts, engine = pipe._search_options(pipe.tokenizer)
    seen = {}
    host_loop, device_loop = engine_mod.beam_decode, engine_mod.WhisperEngine._device_loop

    def timed(fn, init_logits, *a, **kw):
        seen["logprobs"] = torch.log_softmax(init_logits.float(), dim=-1).cpu().numpy()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        seen["loop_ms"] = (time.perf_counter() - t) * 1e3
        return out

    def beam(step_fn, init_logits, cache, prompt_len, o, group=None):
        seen["loop"] = "host"
        return timed(host_loop, init_logits, step_fn, init_logits, cache, prompt_len, o, group=group)

    def device(self, key, init_logits, *a):
        seen["loop"] = "device"
        return timed(device_loop, init_logits, self, key, init_logits, *a)

    engine_mod.beam_decode, engine_mod.WhisperEngine._device_loop = beam, device
    try:
        mel_b = pipe._mel(wavs)
        if engine.uses_device_loop(opts):
            engine.generate(mel_b, options=opts)  # the capture
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.generate(mel_b, options=opts)
        ms = (time.perf_counter() - t0) * 1e3
        launches = read_launches()
    finally:
        engine_mod.beam_decode, engine_mod.WhisperEngine._device_loop = host_loop, device_loop
    if res.tokens.shape != (8, opts.max_new_tokens) or (res.tokens == opts.eot).any():
        raise AssertionError(f"parallel decode: tokens {res.tokens.shape}, EOT present: {(res.tokens == opts.eot).any()}")
    return {"tokens": res.tokens, "logprobs": seen["logprobs"], "generate_ms": ms, "loop_ms": seen["loop_ms"],
            "steps": opts.max_new_tokens, "launches": launches, "loop": seen["loop"]}


def small_fp32_run(torch, dev: str, mesh=None) -> dict:
    """Phase 3's small pipeline in fp32 without quantization: a 128-wide
    Whisper (2 heads) transcribes three tone bursts (beam 2) and a 128-wide
    wav2vec2 aligns a transcript in each chunk, on ``dev`` or on the rank's
    device of ``mesh`` (Whisper through ``whisper_from_jax(mesh=)``, the
    aligner through ``shard_align_model``). Token ids rendered as text."""
    from whisperx_tpu_torch.align.alignment import AlignModel, align, shard_align_model
    from whisperx_tpu_torch.decode.engine import WhisperEngine
    from whisperx_tpu_torch.models import wav2vec2 as tw2
    from whisperx_tpu_torch.models import whisper as tw
    from whisperx_tpu_torch.models.convert import wav2vec2_from_jax, whisper_from_jax
    from whisperx_tpu_torch.pipeline.asr import TranscriptionOptions, WhisperPipeline
    from whisperx_tpu_torch.vad.model import EnergyVAD, VadPipeline

    cfg, w2v_cfg, dictionary = small_models()
    audio = small_audio()
    tok = ids_tokenizer(cfg.n_vocab)
    model = whisper_from_jax(tw.random_params(cfg, seed=0, scale=0.1), cfg, device=None if mesh else dev, mesh=mesh)
    pipe = WhisperPipeline(
        engine=WhisperEngine(model, tok), vad=VadPipeline(EnergyVAD()), vad_params={"vad_onset": 0.5, "vad_offset": 0.363},
        options=TranscriptionOptions(beam_size=2, max_new_tokens=6), tokenizer=tok, language="en", mesh=mesh,
    )
    res = pipe.transcribe(audio, batch_size=2, chunk_size=5)
    am = AlignModel(wav2vec2_from_jax(tw2.random_params(w2v_cfg, seed=0), w2v_cfg, device=dev), dictionary, "en")
    if mesh is not None:
        am = shard_align_model(am, mesh)
    meta = {"language": "en", "dictionary": dictionary, "type": "torch"}
    aligned = align([dict(s, text=" the quick brown fox jumps") for s in res["segments"]], am, meta, audio, dev)
    words = [(w["word"], w.get("start"), w.get("end")) for w in aligned["word_segments"]]
    return {"segments": res["segments"], "words": words, "heads": model.decoder.layers[0].attn.n_head}


def gloo_cuda_collectives(torch, group) -> dict:
    """Which collectives gloo takes on CUDA tensors in this torch, each
    checked for its value: "ok" or the error. The port calls all_reduce
    (the row-parallel sums, the search's exit flag, a split vocabulary's
    lookup) and all_gather (rows over "data", a split vocabulary's logits)."""
    import torch.distributed as dist

    n, me = dist.get_world_size(group), dist.get_rank(group)
    checks = {
        "all_reduce": lambda: _reduced(dist, torch, group, me) == sum(range(1, n + 1)),
        "broadcast": lambda: _broadcast(dist, torch, group, me) == 7.0,
        "all_gather": lambda: _gathered(dist, torch, group, me, n) == list(range(n)),
    }
    out = {}
    for name, check in checks.items():
        try:
            out[name] = "ok" if check() else "wrong value"
        except RuntimeError as e:
            out[name] = f"refused: {str(e)[:120]}"
    return out


def _reduced(dist, torch, group, me):
    t = torch.full((4,), float(me + 1), device="cuda")
    dist.all_reduce(t, group=group)
    return t[0].item()


def _broadcast(dist, torch, group, me):
    t = torch.full((4,), 7.0 if me == 0 else 0.0, device="cuda")
    dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    return t[0].item()


def _gathered(dist, torch, group, me, n):
    parts = [torch.empty(1, device="cuda") for _ in range(n)]
    dist.all_gather(parts, torch.full((1,), float(me), device="cuda"), group=group)
    return [int(p.item()) for p in parts]


def parallel_rank(spec: dict) -> int:
    """One of phase 10's two ranks (``python3 chip_smoke.py --parallel-rank
    <json>``), both on cuda:0 over gloo, mesh (1, 2): (b) load_model(<phase
    7's large-v2 directory>, compute_type="int8", mesh=) → the 8-chunk decode
    with every kernel (``captured_decode``); shard_align_model(<phase 7's
    wav2vec2 base>) alignment of bench.py's transcript over the 8 chunks
    (flash attention); (c) ``small_fp32_run`` under the mesh.
    Prints one ``RANK_RESULT`` JSON line; the first step's log-probs go to
    ``<tmp>/rank<r>_logprobs.npy``."""
    import torch

    from whisperx_tpu_torch.align.alignment import align, load_align_model, shard_align_model
    from whisperx_tpu_torch.ops import flash_attn, int8_mm
    from whisperx_tpu_torch.parallel import make_mesh
    from whisperx_tpu_torch.parallel.distributed import initialize
    from whisperx_tpu_torch.pipeline.asr import load_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = spec["rank"]
    initialize(f"127.0.0.1:{spec['port']}", 2, rank, backend="gloo")
    mesh = make_mesh(1, 2)
    collectives = gloo_cuda_collectives(torch, mesh.get_group("model"))
    if collectives["all_reduce"] != "ok" or collectives["all_gather"] != "ok":
        raise AssertionError(f"rank {rank}: gloo refuses a collective the port calls on CUDA tensors: {collectives}")
    t0 = time.perf_counter()
    pipe = load_model(
        "large-v2", checkpoint=spec["whisper_dir"], compute_type="int8", language="en", mesh=mesh,
        asr_options={"beam_size": 5, "max_new_tokens": 112, "suppress_tokens": (-1, 50257)},
    )
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    model = pipe.model
    heads = [model.encoder.layers[0].attn.n_head, model.decoder.layers[0].attn.n_head, model.decoder.layers[0].cross_attn.n_head]
    if heads != [10, 10, 10] or model.fused_qkv or model.decoder.token_embedding.shape[0] != 51865:
        raise AssertionError(f"rank {rank}: heads {heads}, fused {model.fused_qkv}, vocab rows {model.decoder.token_embedding.shape}")
    wavs = parallel_audio(torch)
    dec = captured_decode(torch, pipe, wavs)
    np.save(os.path.join(spec["tmp"], f"rank{rank}_logprobs.npy"), dec["logprobs"])
    L, steps = model.config.n_text_layer, dec["steps"]
    # Unfused q/k/v: 8 projections a layer and step (prompt + every step).
    want = {"int8_matmul": 8 * L * (1 + steps), "cross_attention_decode": L * (1 + steps),
            "flash_self_attention": model.config.n_audio_layer, "log_mel": 0, "self_attn_decode": L * steps}
    if dec["launches"] != want or dec["loop"] != "host":
        raise AssertionError(f"rank {rank} decode: launches {dec['launches']} on the {dec['loop']} loop, expected {want} on the host loop")
    del pipe, model
    torch.cuda.empty_cache()

    am = shard_align_model(load_align_model("en", model_name=spec["w2v_dir"])[0], mesh)
    if am.model.layers[0].attention.num_heads != 6:
        raise AssertionError(f"rank {rank}: wav2vec2 heads {am.model.layers[0].attention.num_heads}")
    audio = wavs.reshape(-1).astype(np.float32) / 32768.0
    meta = {"language": "en", "dictionary": am.dictionary, "type": "torch"}
    flash_attn.launches = int8_mm.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = align(align_transcript(8), am, meta, audio)
    align_ms = (time.perf_counter() - t) * 1e3
    flash = flash_attn.launches
    aligned = [(w["word"], w.get("start"), w.get("end"), w.get("score")) for w in res["word_segments"]]
    if not aligned or any(w[1] is None for w in aligned):
        raise AssertionError(f"rank {rank} align: words without times")
    if flash != am.model.config.num_layers:
        raise AssertionError(f"rank {rank} align: flash launches {flash}")
    small = small_fp32_run(torch, "cuda", mesh)
    result = {
        "rank": rank, "load_ms": load_ms, "tokens": dec["tokens"].tolist(), "generate_ms": dec["generate_ms"],
        "loop_ms": dec["loop_ms"], "loop": dec["loop"], "steps": steps, "launches": dec["launches"], "aligned": aligned,
        "align_ms": align_ms, "align_flash": flash, "small": small, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "collectives": collectives,
    }
    print("RANK_RESULT " + json.dumps(result), flush=True)
    return 0


def world_of_one_phase(torch, card: str, cli: dict, tmp: str) -> dict:
    """(a) A world of one over NCCL, in this process: ``load_model(<phase
    7's large-v2 directory>, compute_type="int8", mesh=make_mesh())``
    transcribes phase 6's 6-minute WAV (beam 5, 112 tokens, EOT banned),
    ``shard_align_model`` of phase 7's wav2vec2 base aligns bench.py's
    transcript in every chunk, ``DiarizationPipeline(mesh=)`` with phase 7's
    WeSpeaker and PyanNet files diarizes it; then the same calls without a
    mesh on the same weights (a WhisperPipeline without a mesh over the
    loaded model, the unsplit align model, a DiarizationPipeline without a
    mesh). Segments, texts, words, timestamps, turns and int8_matmul's
    launches must be equal. Returns the pipeline without a mesh (phase 10
    (b)'s whole-model reference) and the launches."""
    import torch.distributed as dist

    from whisperx_tpu_torch.align.alignment import align, load_align_model, shard_align_model
    from whisperx_tpu_torch.audio import io as audio_io
    from whisperx_tpu_torch.decode.engine import WhisperEngine
    from whisperx_tpu_torch.diarize import DiarizationPipeline
    from whisperx_tpu_torch.parallel import make_mesh
    from whisperx_tpu_torch.pipeline.asr import WhisperPipeline, load_model

    mesh = make_mesh()
    if dist.get_backend() != "nccl" or tuple(mesh.shape) != (1, 1):
        raise AssertionError(f"world of one: backend {dist.get_backend()}, mesh {tuple(mesh.shape)}")
    path = os.path.join(tmp, "pipeline.wav")
    audio_io.write_wav(path, pipeline_audio(PIPELINE_MINUTES))
    t0 = time.perf_counter()
    pipe = load_model(
        "large-v2", checkpoint=cli["whisper_dir"], compute_type="int8", language="en", mesh=mesh,
        asr_options={"beam_size": 5, "max_new_tokens": 112, "suppress_tokens": (-1, 50257)},
    )
    load_ms = (time.perf_counter() - t0) * 1e3
    plain = WhisperPipeline(
        engine=WhisperEngine(pipe.model, pipe.engine.tokenizer), vad=pipe.vad_model, vad_params=pipe._vad_params,
        options=pipe.options, tokenizer=pipe.tokenizer, language="en", kv_cache_dtype=pipe.kv_cache_dtype,
    )
    am, _ = load_align_model("en", model_name=cli["w2v_dir"])
    diarize = {"wespeaker": cli["wespeaker"], "pyannet": cli["pyannet"]}
    arms = {
        "no mesh": (plain, am, DiarizationPipeline(checkpoint=diarize["wespeaker"], segmentation_checkpoint=diarize["pyannet"])),
        "mesh": (pipe, shard_align_model(am, mesh), DiarizationPipeline(
            checkpoint=diarize["wespeaker"], segmentation_checkpoint=diarize["pyannet"], mesh=mesh)),
    }
    meta = {"language": "en", "dictionary": am.dictionary, "type": "torch"}
    runs = {}
    for arm, (p, a, d) in arms.items():
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = p.transcribe(path, batch_size=8)
        t1 = time.perf_counter()
        aligned = align([dict(s, text=ALIGN_TEXT) for s in res["segments"]], a, meta, path)
        t2 = time.perf_counter()
        turns = d(path, min_speakers=2, max_speakers=2)
        t3 = time.perf_counter()
        runs[arm] = {
            "segments": res["segments"],
            "words": [(w["word"], w.get("start"), w.get("end"), w.get("score")) for w in aligned["word_segments"]],
            "turns": [(float(s), float(e), k) for s, e, k in zip(turns["start"], turns["end"], turns["speaker"])],
            "launches": read_launches(),
            "ms": [(t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3],
        }
    a, b = runs["no mesh"], runs["mesh"]
    n_batches = -(-len(b["segments"]) // 8)
    L = pipe.model.config.n_text_layer
    if a["launches"] != b["launches"] or b["launches"]["int8_matmul"] != 6 * L * 113 * n_batches:
        raise AssertionError(f"world of one: launches {b['launches']} with the mesh, {a['launches']} without")
    for key in ("segments", "words", "turns"):
        if a[key] != b[key]:
            raise AssertionError(f"world of one: {key} differ with the mesh")
    if not b["words"] or len({t[2] for t in b["turns"]}) != 2:
        raise AssertionError(f"world of one: {len(b['words'])} words, turns of {sorted({t[2] for t in b['turns']})}")
    dist.destroy_process_group()
    log(
        f"parallel (a) world of one over NCCL [{card}]: load_model(mesh=make_mesh()) {load_ms:.1f} ms; "
        f"{len(b['segments'])} chunks, {len(b['words'])} words, {len(b['turns'])} turns of 2 speakers, launches "
        f"{b['launches']}, all equal to the calls without a mesh; transcribe / align / diarize ms with the mesh "
        + " / ".join(f"{x:.1f}" for x in b["ms"]) + ", without " + " / ".join(f"{x:.1f}" for x in a["ms"]) + ": ok"
    )
    return {"pipe": plain, "launches": b["launches"]}


def parallel_phase(torch, card: str, cli: dict, tmp: str) -> dict:
    """Phase 10: (a) ``world_of_one_phase``; (b) two ranks sharing this card
    over gloo (``parallel_rank`` in two processes, mesh (1, 2)): equal
    results on both ranks, the first step's log-probs within
    ``TP_LOGPROB_ATOL`` of the whole model's on this card (from (a), same
    weights, same kernels) and the token agreement with it, ms a step and
    each kernel's launches a step; (c) the ranks' ``small_fp32_run`` under
    the mesh equal to this process's on the CPU. Returns rank 0's launches
    in (b) (its decode and its alignment)."""
    one = world_of_one_phase(torch, card, cli, tmp)
    ref = captured_decode(torch, one["pipe"], parallel_audio(torch))
    del one
    torch.cuda.empty_cache()

    spec = {"port": _free_port(), "tmp": tmp, "whisper_dir": cli["whisper_dir"], "w2v_dir": cli["w2v_dir"]}
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-rank", json.dumps({**spec, "rank": r})],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for r in range(2)
    ]
    small_cpu = small_fp32_run(torch, "cpu")
    results = []
    for r, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=600)
        finally:
            if p.poll() is None:
                p.kill()
        if p.returncode != 0:
            for q in procs:
                if q.poll() is None:
                    q.kill()
            raise AssertionError(f"parallel rank {r} failed (rc {p.returncode}):\n{err[-3000:]}")
        results.append(json.loads([ln for ln in out.splitlines() if ln.startswith("RANK_RESULT ")][-1][12:]))
    wall = time.perf_counter() - t0
    r0, r1 = results
    same = ("tokens", "aligned", "small", "launches", "align_flash")
    if any(r0[k] != r1[k] for k in same):
        raise AssertionError(f"parallel (b): the ranks differ in {[k for k in same if r0[k] != r1[k]]}")
    lp0, lp1 = (np.load(os.path.join(tmp, f"rank{r}_logprobs.npy")) for r in range(2))
    if not np.array_equal(lp0, lp1) or not np.isfinite(lp0).all():
        raise AssertionError("parallel (b): the ranks' first-step log-probs differ or are not finite")
    lp_err = float(np.abs(lp0 - ref["logprobs"]).max())
    if lp_err > TP_LOGPROB_ATOL:
        raise AssertionError(f"parallel (b): first-step log-probs {lp_err:.4g} from the whole model's (atol {TP_LOGPROB_ATOL})")
    agree = float((np.asarray(r0["tokens"]) == ref["tokens"]).mean())
    top1 = float((lp0.argmax(-1) == ref["logprobs"].argmax(-1)).mean())
    small_want = json.loads(json.dumps(small_cpu))
    if (r0["small"]["segments"], r0["small"]["words"]) != (small_want["segments"], small_want["words"]) or r0["small"]["heads"] != 1:
        raise AssertionError(f"parallel (c): the two-rank card mesh {r0['small']} != the CPU {small_want}")
    steps = r0["steps"]
    n = r0["launches"]
    log(
        f"parallel (b) two ranks sharing one card over gloo, mesh (1, 2) [{card}; NOT a multi-card number: every "
        f"all-reduce is staged through the host and both ranks share the card]: large-v2 int8, 10 heads a rank, "
        f"unfused QKV, batch 8, beam 5, {steps} tokens (EOT banned), cross-attention kernel + flash: load_model "
        f"{r0['load_ms']:.1f} / {r1['load_ms']:.1f} ms, generate {r0['generate_ms']:.1f} ms, beam loop "
        f"({r0['loop']} loop) {r0['loop_ms'] / steps:.2f} ms a step (whole model on this card alone, {ref['loop']} "
        f"loop: {ref['loop_ms'] / steps:.2f}); "
        f"launches a step (prompt + {steps} steps): int8_matmul {n['int8_matmul'] / (1 + steps):g}, "
        f"cross_attention_decode {n['cross_attention_decode'] / (1 + steps):g}; flash_self_attention "
        f"{n['flash_self_attention']} a batch (encoder), log_mel {n['log_mel']}; first-step log-probs max abs diff "
        f"{lp_err:.4g} from the whole model (atol {TP_LOGPROB_ATOL}), top-1 "
        f"agreement {top1:.3f}, token agreement {agree:.3f} of positions; both ranks equal (tokens, log-probs, words); "
        f"alignment of 8 x 30 s under shard_align_model (6 heads a rank): {len(r0['aligned'])} words, "
        f"{r0['align_ms']:.1f} ms ({r0['align_flash']} flash launches), peak {r0['peak_gib']:.2f} GiB a rank; gloo on CUDA tensors: {r0['collectives']}; "
        f"{wall:.1f} s for both ranks: ok"
    )
    log(
        f"parallel (c) 128-wide fp32 Whisper and wav2vec2 under the two-rank card mesh (1 head a rank) == the CPU "
        f"single process: {len(small_want['segments'])} chunks, {len(small_want['words'])} words and timestamps: ok"
    )
    launches = dict(r0["launches"])
    launches["flash_self_attention"] += r0["align_flash"]
    return launches


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---- phase 8: the training step at full width ------------------------------

TRAIN_STEPS = 5
TRAIN_LR = 1e-5  # optax.adamw's fine-tuning rate in the JAX package's make_optimizer
TRAIN_TOKENS = 129  # 128 teacher-forced positions


def seed_params_(torch, model, seed: int) -> None:
    """Fill every parameter in place from one seed on the card, by the rule
    of ``models/whisper.py:random_params``: LayerNorm scales ones, biases
    zeros, everything else normal x 0.02, in sorted name order."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, p in sorted(model.named_parameters()):
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale" or leaf.endswith("_scale"):
                p.fill_(1.0)
            elif leaf == "bias":
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=gen)


def train_phase(torch, card: str) -> dict:
    """``train.make_train_step`` on Whisper large-v2 at its published widths
    and depth (1280 wide, 20 heads of 64, 32 + 32 layers, vocab 51,865): fp32
    master parameters from seed 0, bf16 compute, AdamW (optax.adamw's
    defaults, lr 1e-5), five steps on one batch of 2 x 30 s random mel and 129
    random tokens (mask of ones). Two arms from the same seed, each its own
    model: bf16 compute, whose encoder attention takes "flash" (the forward
    kernel with lse and both backward kernels: exactly 32 launches of each a
    step), then fp32 compute, which takes the plain "xla" route (no launch).
    Both arms' losses finite and falling; the flash arm's first loss within
    1e-2 relative of the fp32 arm's, and its first gradients of one encoder
    layer's attention projections within 10% relative L2 (bf16 through 32
    layers). Returns each arm's numbers."""
    import gc

    from whisperx_tpu_torch import train
    from whisperx_tpu_torch.models.configs import get_whisper_config
    from whisperx_tpu_torch.models.whisper import Whisper
    from whisperx_tpu_torch.ops import cross_attn, flash_attn, int8_mm
    from whisperx_tpu_torch.ops import mel as mel_ops

    cfg = get_whisper_config("large-v2")
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch_max = TRAIN_SHAPE[0]
    mel = torch.randn((batch_max, cfg.n_mels, 3000), device="cuda", generator=gen)
    tokens = torch.randint(0, cfg.n_vocab, (batch_max, TRAIN_TOKENS), device="cuda", generator=gen)
    mask = torch.ones((batch_max, TRAIN_TOKENS), device="cuda")
    probe = cfg.n_audio_layer // 2  # the encoder layer whose attention gradients the arms compare

    def zero():
        flash_attn.launches = flash_attn.launches_lse = flash_attn.launches_bwd_dq = flash_attn.launches_bwd_dkv = 0
        int8_mm.launches = cross_attn.launches = mel_ops.launches = 0

    def counts():
        return {
            "flash_self_attention": flash_attn.launches, "flash_forward_lse": flash_attn.launches_lse,
            "flash_attention_bwd_dq": flash_attn.launches_bwd_dq, "flash_attention_bwd_dkv": flash_attn.launches_bwd_dkv,
            "int8_matmul": int8_mm.launches, "cross_attention_decode": cross_attn.launches, "log_mel": mel_ops.launches,
        }

    def run(impl: str, batch: int) -> dict:
        # The compute type picks the encoder attention's route: bf16 "flash", fp32 "xla".
        t0 = time.perf_counter()
        model = Whisper(cfg, dtype=torch.bfloat16 if impl == "flash" else torch.float32, device="cuda").trainable()
        seed_params_(torch, model, 0)
        build_s = time.perf_counter() - t0
        opt = train.make_optimizer(model.parameters(), lr=TRAIN_LR)
        timings: dict = {}
        step = train.make_train_step(model, opt, timings=timings)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero()
        losses, step_ms, grads = [], [], None
        for i in range(TRAIN_STEPS):
            t = time.perf_counter()
            losses.append(float(step(mel[:batch], tokens[:batch], mask[:batch])))
            step_ms.append((time.perf_counter() - t) * 1e3)
            if i == 0:
                attn = model.encoder.layers[probe].attn
                grads = {n: getattr(attn, n).kernel.grad.float().cpu() for n in ("query", "key", "value")}
        out = {
            "impl": impl, "batch": batch, "losses": losses, "grads": grads, "launches": counts(),
            "step_ms": float(np.median(step_ms)), "split_ms": {k: float(np.median(v)) for k, v in timings.items()},
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "build_s": build_s,
            "n_params": sum(p.numel() for p in model.parameters()),
        }
        # One more step under torch.profiler (outside the counted run): where its device time goes.
        out["profile"] = profiled(torch, lambda: step(mel[:batch], tokens[:batch], mask[:batch]))
        del opt, step, model
        cleanup()
        return out

    def cleanup():
        gc.collect()
        torch.cuda.empty_cache()

    flash = run("flash", batch_max)
    log(f"train: large-v2 ({flash['n_params'] / 1e9:.3f} B fp32 parameters) built and seeded on the card in "
        f"{flash['build_s']:.1f} s")
    try:
        xla = run("xla", batch_max)
    except torch.cuda.OutOfMemoryError:
        xla = None
    cmp_batch = batch_max
    if xla is None:
        cleanup()
        cmp_batch = 1
        log(f"train: the fp32 xla arm does not fit at batch {batch_max} (its (B, H, T, T) logits): it runs batch 1")
        xla = run("xla", 1)
    flash_cmp = flash if cmp_batch == batch_max else run("flash", cmp_batch)

    L, steps = cfg.n_audio_layer, TRAIN_STEPS
    want = {
        "xla": dict.fromkeys(counts(), 0),
        "flash": dict(
            dict.fromkeys(counts(), 0), flash_self_attention=L * steps, flash_forward_lse=L * steps,
            flash_attention_bwd_dq=L * steps, flash_attention_bwd_dkv=L * steps,
        ),
    }
    for arm in (xla, flash):
        losses = arm["losses"]
        if arm["launches"] != want[arm["impl"]]:
            raise AssertionError(f"train {arm['impl']}: launches {arm['launches']}, expected {want[arm['impl']]}")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"train {arm['impl']}: losses not finite and falling: {losses}")
        split = arm["split_ms"]
        log(
            f"train {arm['impl']} arm [{card}], large-v2, batch {arm['batch']} x 30 s, {TRAIN_TOKENS} tokens, "
            f"{'bf16' if arm['impl'] == 'flash' else 'fp32'} compute over fp32 masters, AdamW lr {TRAIN_LR}: {arm['step_ms']:.1f} ms a step (median of {steps}; forward "
            f"{split['forward']:.1f}, backward {split['backward']:.1f}, optimizer {split['optimizer']:.1f} ms), peak "
            f"{arm['peak_gib']:.2f} GiB, losses {[round(x, 5) for x in losses]}, launches {arm['launches']}: ok"
        )
        prof = arm["profile"]
        if prof:
            kernels = prof["kernels"]
            ours = {n: sum(t for k, t, _ in kernels if n in k) for n in ("flash_attn_kernel", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")}
            log(
                f"train {arm['impl']} arm, one step under torch.profiler (a sync after each part): wall "
                f"{prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} ms (idle share "
                f"{1 - prof['busy_ms'] / prof['wall_ms']:.3f}); top kernels: "
                + "; ".join(f"{k[:56]} {t:.2f} ms x{c}" for k, t, c in kernels[:8])
                + "; port kernels: " + ", ".join(f"{n} {t:.2f} ms" for n, t in ours.items())
            )
        else:
            log(f"train {arm['impl']} arm: the profiler recorded no device time; busy share not measured")
    loss_err = abs(flash_cmp["losses"][0] - xla["losses"][0]) / abs(xla["losses"][0])
    if loss_err > 1e-2:
        raise AssertionError(f"train: flash first loss {flash_cmp['losses'][0]} vs fp32 xla {xla['losses'][0]} (rtol 1e-2)")
    grad_err = {}
    for n, w in xla["grads"].items():
        g = flash_cmp["grads"][n]
        grad_err[n] = float((g - w).norm() / w.norm())
        if not (torch.isfinite(g).all() and grad_err[n] < 0.1):
            raise AssertionError(f"train: encoder layer {probe} attention {n} gradient, flash vs fp32 xla: relative L2 {grad_err[n]}")
    log(
        f"train bf16 flash vs fp32 xla at batch {cmp_batch}: first loss within {loss_err:.3g} (rtol 1e-2); encoder layer {probe} "
        f"attention gradients within relative L2 "
        + ", ".join(f"{n} {e:.3g}" for n, e in grad_err.items())
        + " (< 0.1): ok"
    )
    return {"xla": xla, "flash": flash, "cmp_batch": cmp_batch}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--parallel-rank"]:  # one of phase 10's two ranks
        return parallel_rank(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--ctc-trap"]:  # one of phase 2's trap children
        return ctc_trap(sys.argv[2])
    from whisperx_tpu_torch.ops import _build

    # Stated references: fp32 products in full fp32 (no TF32) on the card.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.pop("WHISPERX_WAV_INT16", None)  # int16 uploads, the default

    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    report = _build.build(KERNEL_SOURCES)
    log(f"built {sorted(report) or 'nothing (up to date)'} in {time.perf_counter() - t0:.1f} s (parallel nvcc, sm_90a)")
    for name, r in report.items():
        usage = [
            ln.split("ptxas info    : ")[-1]
            for ln in r["log"].splitlines()
            if "Used" in ln or "spill" in ln or "Performance Loss" in ln or "warning" in ln
        ]
        log(f"  {name}.cu {r['seconds']:.1f} s: " + "; ".join(usage))

    kernels = [int8_mm_phase(torch, card), cross_attn_phase(torch, card), flash_phase(torch, card), log_mel_phase(torch, card)]
    kernels += flash_bwd_phase(torch, card, kernels[2])
    kernels.append(self_attn_decode_phase(torch, card))
    ctc_entry = ctc_phase(torch, card)
    small_reference_phase(torch)
    small_int4_phase(torch)
    small_align_phase(torch, card)
    small_pipeline_phase(torch)
    small_diarize_phase(torch)
    small_cli_phase(torch)
    small_train_phase(torch)
    model = large_v2(torch)
    launches, profile, loop = main_path_phase(torch, card, model)  # the decode path
    sampled = sampled_path_phase(torch, card, model)
    flash_align, ctc_align, align_model = align_path_phase(torch, card)
    pipeline_launches, fallback = pipeline_phase(torch, card, model, align_model)  # its default run, its fallback run
    kernels.append(loop_entry(loop, sampled, fallback))
    del model, align_model
    with tempfile.TemporaryDirectory() as tmp:
        cli = cli_phase(torch, card, tmp)
        int4_launches = int4_phase(torch, card, cli["whisper_dir"], cli["w2v_dir"], cli)
        parallel_launches = parallel_phase(torch, card, cli, tmp)
    cli_launches = cli["launches"]
    trained = train_phase(torch, card)
    for k in kernels:
        k["launches"] = launches.get(k["name"], trained["flash"]["launches"].get(k["name"]))
        if k["name"] in STEP_KERNELS and k["name"] in profile:
            k["beam_step_device_ms"] = profile[k["name"]]  # per beam step, profiled host loop
    if profile:
        log(f"beam loop device busy {profile['busy_ms_per_step']:.3f} ms/step under torch.profiler")
    kernels[2]["launches_align"] = flash_align  # flash also serves the alignment path
    kernels[2]["launches_train"] = trained["flash"]["launches"]["flash_forward_lse"]  # with lse, phase 8's flash arm
    for k in kernels:
        if k["name"] in pipeline_launches:
            k["launches_pipeline"] = pipeline_launches[k["name"]]
            k["launches_cli"] = cli_launches[k["name"]]
        k["launches_int4"] = int4_launches[k["name"]]  # phase 9's arm (b)
        k["launches_parallel"] = parallel_launches.get(k["name"], 0)  # phase 10 (b), rank 0
    # The CTC kernel: phase 5's run (the alignment path), phase 6's default
    # and fallback runs, phase 7's CLI (one launch an align batch in each);
    # phases 9 and 10 align too, but their counts are not read.
    ctc_entry.update(launches=ctc_align, launches_pipeline=pipeline_launches["ctc_align"],
                     launches_fallback=fallback["launches"]["ctc_align"], launches_cli=cli_launches["ctc_align"],
                     launches_int4=None, launches_parallel=None)
    kernels.append(ctc_entry)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
