#!/usr/bin/env python3
"""Drive whisperx_tpu_torch's main path on one NVIDIA GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. Needs one CUDA
card and nvcc ($CUDA_HOME or /usr/local/cuda), no network. Exits non-zero,
without the final ``ok`` line, on any failure: no card, the package missing,
a kernel that does not build, launch or agree, a wrong result.

Phases:
  1. build every CUDA kernel of the paths (one nvcc per source, in parallel);
  2. hold each kernel against its plain PyTorch version at the main paths'
     shapes (plus edge shapes), and time the kernel, the plain version and
     one PyTorch library call (the yardstick) with cold caches;
  3. on small models, check that the card gives the CPU's results: decode
     tokens (kernels against plain versions) and fp32 alignment segments,
     words and timestamps; then the flash route's bf16 emissions against the
     card's plain route;
  4. drive the decode path: Whisper large-v2 with random weights from a seed,
     int8 weights, fused QKV, int8 KV cache; batch 8 of 30 s int16 audio →
     log-mel → beam-5 decode of 112 tokens with EOT banned (bench.py's
     flagship), in two arms: the JAX package's defaults (plain log-mel,
     "xla" encoder attention, einsum cross attention) and the kernel arm
     (log-mel kernel, flash encoder attention, cross-attention kernel);
  5. drive the alignment path: wav2vec2 base (published widths, random
     weights from seed 0, bf16) aligning bench.py's fixed transcript to 8 x
     30 s of int16 audio through align_begin(...).finish(), with the "xla"
     and the flash encoder attention.
Every kernel's launch count is zeroed just before each run of a path and
read just after.

Prints the card's name and power limit, one line per check, a ``kernels``
JSON line and, last, ``{"ok": true, "device": {...}}``. Every time is taken
on this card in this run.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
FP32_FLOPS = 67e12  # H100 SXM fp32 peak outside the tensor cores (NVIDIA data sheet)
KERNEL_SOURCES = ("int8_mm", "cross_attn", "flash_attn", "log_mel")
# bench.py's alignment transcript (bench.py:277-285): ~70 words per 30 s chunk.
_WORDS = ("the quick brown fox jumps over the lazy dog and runs far away "
          "while seven silent watchers record every single word spoken here ").split()
ALIGN_TEXT = " " + " ".join(_WORDS * 4)[:400]


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
        for cross in ("xla", "pallas"):
            opts = engines["cpu"].build_options(beam_size=beam, max_new_tokens=6, kv_cache_dtype="int8")
            opts = dataclasses.replace(opts, cross_attn=cross)
            got = engines["cuda"].generate(mel, options=opts)
            want = engines["cpu"].generate(mel, options=opts)
            if not np.array_equal(got.tokens, want.tokens):
                raise AssertionError(f"small model beam={beam} cross={cross}: card tokens {got.tokens.tolist()} != cpu {want.tokens.tolist()}")
            lp_err = float(np.abs(got.sum_logprobs - want.sum_logprobs).max())
            if lp_err > 2e-2:
                raise AssertionError(f"small model beam={beam} cross={cross}: sum_logprobs differ by {lp_err}")
            log(f"small model (128 wide, int8) beam={beam} cross={cross}: card tokens == cpu tokens, sum_logprobs within {lp_err:.2g}: ok")


def small_align_phase(torch, card: str) -> None:
    """Alignment on a 128-wide wav2vec2 (WAV2VEC2_TEST widened to the flash
    kernel's head dim 64): fp32 "xla" on the card against the CPU, then the
    flash route at bf16 against the card's plain route."""
    from whisperx_tpu_torch.align.alignment import AlignModel, _emissions, align
    from whisperx_tpu_torch.audio import N_SAMPLES
    from whisperx_tpu_torch.models import wav2vec2 as tw2
    from whisperx_tpu_torch.models.configs import WAV2VEC2_TEST
    from whisperx_tpu_torch.models.convert import wav2vec2_from_jax
    from whisperx_tpu_torch.ops import attention, flash_attn

    cfg = dataclasses.replace(WAV2VEC2_TEST, hidden_size=128, intermediate_size=256)
    params = tw2.random_params(cfg, seed=0)
    dictionary = {c: i for i, c in enumerate(["[pad]", "|", "'"] + [chr(c) for c in range(ord("a"), ord("z") + 1)])}
    meta = {"language": "en", "dictionary": dictionary, "type": "torch"}
    n_seg = 3
    audio = (np.random.default_rng(4).standard_normal(n_seg * N_SAMPLES) * 0.1).astype(np.float32)
    transcript = align_transcript(n_seg)

    def model_on(dev, dtype, impl):
        return AlignModel(wav2vec2_from_jax(params, cfg, dtype=dtype, attn_impl=impl, device=dev), dictionary, "en")

    def timestamps(res):
        segs = [(s["text"], s["start"], s["end"]) for s in res["segments"]]
        return segs, [(w["word"], w.get("start"), w.get("end")) for w in res["word_segments"]]

    results = {}
    for dev in ("cuda", "cpu"):
        results[dev] = align([dict(s) for s in transcript], model_on(dev, torch.float32, "xla"), meta, audio, dev)
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

    # bf16: the flash route's emissions against the card's plain ("xla") route.
    am = model_on("cuda", torch.bfloat16, "flash")
    wavs = torch.from_numpy(audio.reshape(n_seg, N_SAMPLES)).cuda()
    lens = torch.full((n_seg,), N_SAMPLES, device="cuda")
    lens[1] = N_SAMPLES - 16_000 * 7  # one padded row
    with torch.inference_mode():
        flash_attn.launches = 0
        em_flash, t_len = _emissions(am.model, wavs, lens)
        launched = flash_attn.launches
        attention.set_attn_impl(am.model, "xla")
        em_xla, _ = _emissions(am.model, wavs, lens)
    valid = torch.arange(em_flash.shape[1], device="cuda")[None, :] < t_len[:, None]
    # bf16 activations rounded at other places through two layers.
    err = max_err_within(torch, "small align bf16 emissions flash vs xla", em_flash[valid], em_xla[valid], 0.15, 0.05)
    if launched != cfg.num_layers:
        raise AssertionError(f"small align bf16: flash launched {launched} times, expected {cfg.num_layers}")
    words = {}
    for impl in ("xla", "flash"):
        attention.set_attn_impl(am.model, impl)
        words[impl] = align([dict(s) for s in transcript], am, meta, audio)["word_segments"]
    same = float(np.mean([a == b for a, b in zip(words["xla"], words["flash"])])) if words["xla"] else 0.0
    log(
        f"small align bf16 [{card}]: emissions flash vs xla max abs err {err:.3g} (atol 0.15, rtol 0.05): ok; "
        f"word timestamps identical between the routes: {same:.3f} of {len(words['xla'])} words (random weights)"
    )


# ---- phase 4: the main path ------------------------------------------------


def main_path_phase(torch, card: str) -> dict:
    from whisperx_tpu_torch.audio import N_SAMPLES, log_mel_spectrogram, pcm16
    from whisperx_tpu_torch.decode.engine import WhisperEngine
    from whisperx_tpu_torch.decode.search import beam_decode
    from whisperx_tpu_torch.decode.tokenizer import WhisperTokenizer
    from whisperx_tpu_torch.models import whisper as tw
    from whisperx_tpu_torch.models.configs import get_whisper_config
    from whisperx_tpu_torch.models.convert import whisper_from_jax
    from whisperx_tpu_torch.ops import attention, cross_attn, flash_attn, int8_mm, mel

    cfg = get_whisper_config("large-v2")
    batch, beam, max_new = 8, 5, 112
    t0 = time.perf_counter()
    params = tw.fuse_qkv_params(tw.quantize_params(tw.random_params(cfg, seed=0)))
    model = whisper_from_jax(params, cfg, dtype=torch.bfloat16, device="cuda")
    del params
    log(f"large-v2 random weights (seed 0), int8 + fused QKV, on the card in {time.perf_counter() - t0:.1f} s")
    engine = WhisperEngine(model, WhisperTokenizer.dummy(cfg.n_vocab, language="en"))
    opts = engine.build_options(beam_size=beam, max_new_tokens=max_new, kv_cache_dtype="int8")
    # Ban EOT (bench.py:75-82): every segment pays the full 112-token horizon.
    opts = dataclasses.replace(opts, banned_tokens=opts.banned_tokens + (opts.eot,))
    rng = np.random.default_rng(0)
    audio = pcm16((rng.standard_normal((batch, N_SAMPLES)) * 0.1).astype(np.float32))

    # The two arms: the JAX package's defaults, and every kernel of the path.
    # Both front ends divide the int16 upload by 32768 on the card.
    arms = {
        "reference": dict(cross="xla", attn="xla", mel=log_mel_spectrogram),
        "kernel": dict(cross="pallas", attn="flash", mel=mel.log_mel_kernel),
    }

    def use(arm):
        a = arms[arm]
        attention.set_attn_impl(model, a["attn"])
        return dataclasses.replace(opts, cross_attn=a["cross"]), lambda x: a["mel"](x, n_mels=cfg.n_mels).to(torch.bfloat16)

    # One-time CUDA and cuBLAS set-up, outside the counted runs.
    o, mel_of = use("kernel")
    engine.generate(mel_of(audio), options=dataclasses.replace(o, max_new_tokens=2))

    L = cfg.n_text_layer
    want = {
        "reference": {"int8_matmul": 6 * L * (1 + max_new), "cross_attention_decode": 0, "flash_self_attention": 0, "log_mel": 0},
        "kernel": {
            "int8_matmul": 6 * L * (1 + max_new),  # 6 projections per layer, prompt + every step
            "cross_attention_decode": L * (1 + max_new),
            "flash_self_attention": cfg.n_audio_layer,  # one per encoder layer
            "log_mel": 1,  # one call for the batch
        },
    }
    counters = {"int8_matmul": int8_mm, "cross_attention_decode": cross_attn, "flash_self_attention": flash_attn, "log_mel": mel}
    runs = {}
    for arm in ("reference", "kernel", "kernel", "reference"):  # in turns: two runs each
        o, mel_of = use(arm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        mel_b = mel_of(audio)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = engine.generate(mel_b, options=o)  # returns host arrays: synchronized
        t2 = time.perf_counter()
        launches = {name: c.launches for name, c in counters.items()}
        if res.tokens.shape != (batch, max_new) or not np.isfinite(res.sum_logprobs).all():
            raise AssertionError(f"main path {arm}: tokens {res.tokens.shape}, sum_logprobs {res.sum_logprobs}")
        if not (res.lengths == max_new + 1).all() or (res.tokens == opts.eot).any():
            raise AssertionError(f"main path {arm}: EOT is banned, yet lengths are {res.lengths}")
        if launches != want[arm]:
            raise AssertionError(f"main path {arm}: launches {launches}, expected {want[arm]}")
        mel_ms, gen_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3
        rate = batch * 30.0 / (t2 - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        runs[arm] = {"tokens": res.tokens, "launches": launches}
        log(
            f"main path {arm} arm [{card}]: mel {mel_ms:.1f} ms, generate {gen_ms:.1f} ms, "
            f"{rate:.2f} audio-s/s, peak {peak:.1f} GiB, launches {launches}: ok"
        )

    # Per-stage breakdown: the same stages generate() runs, each ended by a
    # sync; then a profiled window of the beam loop for the device busy share.
    profiles = {}
    with torch.inference_mode():
        for arm in ("reference", "kernel"):
            o, mel_of = use(arm)
            stamps = [time.perf_counter()]

            def mark():
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())

            mel_b = mel_of(audio)
            mark()
            states = engine._encode(mel_b)
            mark()
            prompt = engine.build_prompt(batch)
            logits, cache, _ = engine._prompt_cache(
                states, prompt, engine._cache_len(prompt.shape[1], o), kv_int8=True, cross_impl=o.cross_attn
            )
            mark()
            expanded = [{n: b.repeat_interleave(beam, dim=0) for n, b in layer.items()} for layer in cache["self"]]
            beam_decode(engine._step_fn(cache["cross"]), logits, expanded, prompt.shape[1], o)
            mark()
            mel_ms, enc_ms, prompt_ms, loop_ms = (1e3 * (b - a) for a, b in zip(stamps, stamps[1:]))
            log(
                f"stages {arm} arm (cross={o.cross_attn}, encoder attention={arms[arm]['attn']}) [{card}]: "
                f"mel {mel_ms:.1f} ms, encoder {enc_ms:.1f} ms, prompt {prompt_ms:.1f} ms, beam loop {loop_ms:.1f} ms "
                f"({loop_ms / max_new:.2f} ms/step), {batch * 30.0 / (stamps[-1] - stamps[0]):.2f} audio-s/s"
            )
            profiles[arm] = profile_beam_loop(torch, engine, logits, cache, prompt.shape[1], o, card)
    same = float((runs["reference"]["tokens"] == runs["kernel"]["tokens"]).mean())
    log(f"main path tokens equal between the two arms: {same:.3f} of positions (random weights)")
    return runs["kernel"]["launches"], profiles["kernel"]


# The CUDA kernels of the port by their device names, as the profiler lists them.
STEP_KERNELS = {"int8_matmul": "int8_mm_kernel", "cross_attention_decode": "cross_attn_kernel"}


def profile_beam_loop(torch, engine, logits, cache, prompt_len: int, opts, card: str, steps: int = 8) -> dict:
    """Device busy share and the costliest kernels over ``steps`` beam steps
    (torch.profiler; its own overhead lengthens the host side). Returns the
    device busy ms per step and each port kernel's device ms per step."""
    from torch.profiler import ProfilerActivity, profile

    from whisperx_tpu_torch.decode.search import beam_decode

    o = dataclasses.replace(opts, max_new_tokens=steps)
    K = o.beam_size
    expanded = [{n: b.repeat_interleave(K, dim=0) for n, b in layer.items()} for layer in cache["self"]]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        beam_decode(engine._step_fn(cache["cross"]), logits, expanded, prompt_len, o)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        log(f"profile cross={opts.cross_attn}: the profiler recorded no device time; busy share not measured")
        return {}
    step_ms = {
        name: sum(e.self_device_time_total for e in kernels if key in e.key) / 1e3 / steps
        for name, key in STEP_KERNELS.items()
    }
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(
        f"profile cross={opts.cross_attn} [{card}], {steps} beam steps under torch.profiler: wall {wall_ms:.1f} ms, "
        f"device busy {busy_ms:.2f} ms ({busy_ms / steps:.3f} ms/step), idle share {1 - busy_ms / wall_ms:.3f}; "
        "top kernels: "
        + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3 / steps:.3f} ms/step x{e.count // steps}" for e in top)
        + "; port kernels: " + ", ".join(f"{k} {v:.3f} ms/step" for k, v in step_ms.items())
    )
    return {"busy_ms_per_step": busy_ms / steps, **step_ms}


# ---- phase 5: the alignment path -------------------------------------------


def align_path_phase(torch, card: str) -> int:
    """wav2vec2 base (published widths, depth not cut), random weights from
    seed 0, bf16, max_batch 8: bench.py's alignment of its fixed transcript
    to 8 x 30 s of int16 audio (bench.py:257-289). Returns the flash
    launches counted in the last flash run."""
    from whisperx_tpu_torch.align import alignment
    from whisperx_tpu_torch.audio import N_SAMPLES
    from whisperx_tpu_torch.models.configs import WAV2VEC2_BASE
    from whisperx_tpu_torch.ops import attention, ctc, flash_attn

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

    attention.set_attn_impl(am.model, "flash")
    run()  # one-time set-up (cuBLAS handles, pinned buffers), outside the counted runs
    want = {"xla": 0, "flash": am.model.config.num_layers}  # one batch: one launch per encoder layer
    words, flash_launches = {}, None
    for impl in ("xla", "flash", "flash", "xla"):  # in turns: two runs each
        attention.set_attn_impl(am.model, impl)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_attn.launches = 0
        t0 = time.perf_counter()
        res = run()
        wall = time.perf_counter() - t0
        launched = flash_attn.launches
        segs = res["segments"]
        if len(segs) != batch or not all(s["words"] and all("start" in w and "end" in w for w in s["words"]) for s in segs):
            raise AssertionError(f"align path {impl}: not every segment aligned: {[len(s['words']) for s in segs]}")
        if launched != want[impl]:
            raise AssertionError(f"align path {impl}: flash launched {launched} times, expected {want[impl]}")
        words[impl] = res["word_segments"]
        if impl == "flash":
            flash_launches = launched
        log(
            f"align path attn={impl} [{card}]: {wall * 1e3:.1f} ms for {audio_s:.1f} audio-s, "
            f"{audio_s / wall:.2f} audio-s/s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"{len(res['word_segments'])} words, flash launches {launched}: ok"
        )
    same = float(np.mean([a == b for a, b in zip(words["xla"], words["flash"])]))
    log(f"align path word timestamps identical between xla and flash: {same:.3f} of {len(words['xla'])} words (random weights)")

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

    originals = (alignment._emissions, ctc.ctc_trellis_batch, ctc.ctc_backtrack_device)
    alignment._emissions = timed("emissions", originals[0])
    ctc.ctc_trellis_batch = timed("trellis", originals[1])
    ctc.ctc_backtrack_device = timed("backtrack", originals[2])
    try:
        for impl in ("xla", "flash"):
            attention.set_attn_impl(am.model, impl)
            stages.clear()
            t0 = time.perf_counter()
            job = alignment.align_begin([dict(s) for s in transcript], am, meta, audio)
            t1 = time.perf_counter()
            job.finish()
            t2 = time.perf_counter()
            launch_ms = (t1 - t0) * 1e3 - sum(stages.values())
            log(
                f"align stages attn={impl} [{card}]: emissions (wav2vec2 + log-softmax) {stages['emissions']:.1f} ms, "
                f"trellis {stages['trellis']:.1f} ms, backtrack {stages['backtrack']:.1f} ms, host prep and launch "
                f"{launch_ms:.1f} ms, fetch + host aggregation {(t2 - t1) * 1e3:.1f} ms"
            )
    finally:
        alignment._emissions, ctc.ctc_trellis_batch, ctc.ctc_backtrack_device = originals
    return flash_launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from whisperx_tpu_torch.ops import _build

    # Stated references: fp32 products in full fp32 (no TF32) on the card.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for knob in ("WHISPERX_CROSS_ATTN", "WHISPERX_ATTN", "WHISPERX_CTC_BACKTRACK", "WHISPERX_WAV_INT16"):
        os.environ.pop(knob, None)  # each run picks its path itself

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
    small_reference_phase(torch)
    small_align_phase(torch, card)
    launches, profile = main_path_phase(torch, card)  # the decode path's kernel arm
    flash_align = align_path_phase(torch, card)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["name"] in STEP_KERNELS and k["name"] in profile:
            k["beam_step_device_ms"] = profile[k["name"]]  # per beam step, profiled kernel arm
    if profile:
        log(f"beam loop (kernel arm) device busy {profile['busy_ms_per_step']:.3f} ms/step under torch.profiler")
    kernels[2]["launches_align"] = flash_align  # flash also serves the alignment path
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
