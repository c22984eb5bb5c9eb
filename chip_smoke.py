#!/usr/bin/env python3
"""Drive whisperx_tpu_torch's main path on one NVIDIA GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. Needs one CUDA
card and nvcc ($CUDA_HOME or /usr/local/cuda), no network. Exits non-zero,
without the final ``ok`` line, on any failure: no card, the package missing,
a kernel that does not build, launch or agree, a wrong result.

Phases:
  1. build every CUDA kernel of the path (one nvcc per source, in parallel);
  2. hold each kernel against its plain PyTorch version at the main path's
     shapes (plus edge shapes), and time the kernel, the plain version and
     one PyTorch library call (the yardstick) with cold caches;
  3. on a small model, check that the card's decode (kernels) gives the same
     tokens as the CPU's (plain versions);
  4. drive the main path: Whisper large-v2 with random weights from a seed,
     int8 weights, fused QKV, int8 KV cache; batch 8 of 30 s int16 audio →
     log-mel → beam-5 decode of 112 tokens with EOT banned (bench.py's
     flagship), once with the einsum cross attention and once with the
     cross-attention kernel. Both kernels' launch counts are zeroed just
     before each run and read just after.

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
KERNEL_SOURCES = ("int8_mm", "cross_attn")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
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
    cases = [(40, layer), (32, layer), (256, [(D, 4 * D)]), (1, [(D, D)])]  # decode, prompt, edges
    for M, shapes in cases:
        for K, N in dict.fromkeys(shapes):
            x, w, s, b = operands(M, K, N)
            got = int8_mm.int8_matmul(x, w, s, b)
            torch.cuda.synchronize()
            err = max_err_within(torch, f"int8_mm M={M} K={K} N={N}", got, int8_mm.int8_matmul_plain(x, w, s, b), atol, rtol)
            if M in (40, 32):
                path_err = max(path_err, err)
            log(f"int8_mm M={M} K={K} N={N} bf16 out: max abs err {err:.3g} vs plain (atol {atol}, rtol {rtol}): ok")

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
        "source": "whisperx_tpu_torch/csrc/int8_mm.cu",
        "replaces": "whisperx_tpu/ops/pallas_int8_mm.py:42",
        "launches": None,
        "max_abs_err": path_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bms,
        "bound_by": by,
        "library_ms": library_ms,
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
        "source": "whisperx_tpu_torch/csrc/cross_attn.cu",
        "replaces": "whisperx_tpu/ops/pallas_cross_attn.py:104",
        "launches": None,
        "max_abs_err": path_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bms,
        "bound_by": by,
        "library_ms": library_ms,
        "unit": "one call, B=8 G=5 S=1500 H=20 int8 K/V",
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


# ---- phase 4: the main path ------------------------------------------------


def main_path_phase(torch, card: str) -> dict:
    from whisperx_tpu_torch.audio import N_SAMPLES, log_mel_spectrogram, pcm16
    from whisperx_tpu_torch.decode.engine import WhisperEngine
    from whisperx_tpu_torch.decode.search import beam_decode
    from whisperx_tpu_torch.decode.tokenizer import WhisperTokenizer
    from whisperx_tpu_torch.models import whisper as tw
    from whisperx_tpu_torch.models.configs import get_whisper_config
    from whisperx_tpu_torch.models.convert import whisper_from_jax
    from whisperx_tpu_torch.ops import cross_attn, int8_mm

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

    def mel_of(a):
        return log_mel_spectrogram(a, n_mels=cfg.n_mels).to(torch.bfloat16)

    # One-time CUDA and cuBLAS set-up, outside the counted runs.
    engine.generate(mel_of(audio), options=dataclasses.replace(opts, max_new_tokens=2, cross_attn="pallas"))

    L = cfg.n_text_layer
    want_int8 = 6 * L * (1 + max_new)  # 6 projections per layer, prompt + every step
    want_cross = {"xla": 0, "pallas": L * (1 + max_new)}
    runs = {}
    for cross in ("xla", "pallas", "pallas", "xla"):  # in turns: two runs each
        o = dataclasses.replace(opts, cross_attn=cross)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        int8_mm.launches = 0
        cross_attn.launches = 0
        t0 = time.perf_counter()
        mel = mel_of(audio)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = engine.generate(mel, options=o)  # returns host arrays: synchronized
        t2 = time.perf_counter()
        launches = {"int8_matmul": int8_mm.launches, "cross_attention_decode": cross_attn.launches}
        if res.tokens.shape != (batch, max_new) or not np.isfinite(res.sum_logprobs).all():
            raise AssertionError(f"main path {cross}: tokens {res.tokens.shape}, sum_logprobs {res.sum_logprobs}")
        if not (res.lengths == max_new + 1).all() or (res.tokens == opts.eot).any():
            raise AssertionError(f"main path {cross}: EOT is banned, yet lengths are {res.lengths}")
        if launches != {"int8_matmul": want_int8, "cross_attention_decode": want_cross[cross]}:
            raise AssertionError(f"main path {cross}: launches {launches}, expected int8 {want_int8}, cross {want_cross[cross]}")
        mel_ms, gen_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3
        rate = batch * 30.0 / (t2 - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        runs[cross] = {"tokens": res.tokens, "launches": launches}
        log(
            f"main path cross={cross} [{card}]: mel {mel_ms:.1f} ms, generate {gen_ms:.1f} ms, "
            f"{rate:.2f} audio-s/s, peak {peak:.1f} GiB, launches {launches}: ok"
        )

    # Per-stage breakdown: the same stages generate() runs, each ended by a
    # sync; then a profiled window of the beam loop for the device busy share.
    with torch.inference_mode():
        for cross in ("xla", "pallas"):
            o = dataclasses.replace(opts, cross_attn=cross)
            stamps = [time.perf_counter()]

            def mark():
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())

            mel = mel_of(audio)
            mark()
            states = engine._encode(mel)
            mark()
            prompt = engine.build_prompt(batch)
            logits, cache, _ = engine._prompt_cache(
                states, prompt, engine._cache_len(prompt.shape[1], o), kv_int8=True, cross_impl=cross
            )
            mark()
            expanded = [{n: b.repeat_interleave(beam, dim=0) for n, b in layer.items()} for layer in cache["self"]]
            beam_decode(engine._step_fn(cache["cross"]), logits, expanded, prompt.shape[1], o)
            mark()
            mel_ms, enc_ms, prompt_ms, loop_ms = (1e3 * (b - a) for a, b in zip(stamps, stamps[1:]))
            log(
                f"stages cross={cross} [{card}]: mel {mel_ms:.1f} ms, encoder {enc_ms:.1f} ms, "
                f"prompt {prompt_ms:.1f} ms, beam loop {loop_ms:.1f} ms ({loop_ms / max_new:.2f} ms/step), "
                f"{batch * 30.0 / (stamps[-1] - stamps[0]):.2f} audio-s/s"
            )
            profile_beam_loop(torch, engine, logits, cache, prompt.shape[1], o, card)
    same = float((runs["xla"]["tokens"] == runs["pallas"]["tokens"]).mean())
    log(f"main path tokens equal between the two cross-attention paths: {same:.3f} of positions (random weights)")
    return runs["pallas"]["launches"]


def profile_beam_loop(torch, engine, logits, cache, prompt_len: int, opts, card: str, steps: int = 8) -> None:
    """Device busy share and the costliest kernels over ``steps`` beam steps
    (torch.profiler; its own overhead lengthens the host side)."""
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
        return
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(
        f"profile cross={opts.cross_attn} [{card}], {steps} beam steps under torch.profiler: wall {wall_ms:.1f} ms, "
        f"device busy {busy_ms:.2f} ms ({busy_ms / steps:.3f} ms/step), idle share {1 - busy_ms / wall_ms:.3f}; "
        "top kernels: "
        + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3 / steps:.3f} ms/step x{e.count // steps}" for e in top)
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from whisperx_tpu_torch.ops import _build

    # Stated references: fp32 products in full fp32 (no TF32) on the card.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.pop("WHISPERX_CROSS_ATTN", None)  # each run picks its path itself

    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    report = _build.build(KERNEL_SOURCES)
    log(f"built {sorted(report) or 'nothing (up to date)'} in {time.perf_counter() - t0:.1f} s (parallel nvcc, sm_90a)")
    for name, r in report.items():
        usage = [ln.split("ptxas info    : ")[-1] for ln in r["log"].splitlines() if "Used" in ln or "spill" in ln]
        log(f"  {name}.cu {r['seconds']:.1f} s: " + "; ".join(usage))

    kernels = [int8_mm_phase(torch, card), cross_attn_phase(torch, card)]
    small_reference_phase(torch)
    launches = main_path_phase(torch, card)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
