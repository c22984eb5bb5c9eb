"""whisperx_tpu_torch CUDA kernels against their plain versions, on the card.

Imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch: ``python -m pytest --noconftest tests/test_torch_kernels_cuda.py``.
Every test needs a CUDA device and skips without one.
"""

import pytest
import torch

from torch_routes import force_routes
from whisperx_tpu_torch.audio import log_mel_spectrogram
from whisperx_tpu_torch.models.whisper import flat_cross_kv
from whisperx_tpu_torch.ops import cross_attn, ctc, flash_attn, int8_mm, mel, self_attn_decode
from whisperx_tpu_torch.ops.quant import pack_int4, store_kv, unpack_int4

torch.set_num_threads(2)


def exact_logit_operands(gen, B, G, S, H):
    """q and K on coarse grids (q in 1/64 steps, K in 1/8 steps), so that
    every logit is exact in fp32 in any summation order. With few positions
    the weights are large (~1/S), and one bf16 ulp of a weight that rounds
    the other way moves the output by ~1e-4 * |v|: exact logits keep such
    flips out of a test of the kernel's tiling."""
    q = (torch.randint(-4, 5, (B, G, H * 64), device="cuda", generator=gen) / 64).bfloat16()
    k = torch.randint(-8, 9, (B, S, H, 64), device="cuda", generator=gen) / 8
    v = torch.randn((B, S, H, 64), device="cuda", generator=gen)
    return q, k, v


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "M,K,N", [(40, 1280, 3840), (40, 1280, 1280), (40, 1280, 5120), (40, 5120, 1280), (256, 1280, 5120), (1, 128, 128)]
)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_int8_mm_kernel_matches_plain(gen, M, K, N, out_dtype):
    x = torch.randn((M, K), device="cuda", generator=gen).bfloat16()
    w = torch.randint(-127, 128, (K, N), device="cuda", generator=gen, dtype=torch.int8)
    scale = torch.rand((N,), device="cuda", generator=gen) * 0.01
    bias = torch.randn((N,), device="cuda", generator=gen)
    before = int8_mm.launches
    got = int8_mm.int8_matmul(x, w, scale, bias, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert int8_mm.launches == before + 1
    want = int8_mm.int8_matmul_plain(x, w, scale, bias, out_dtype=out_dtype)
    # fp32 sums in another order; a bf16 output may round one ulp apart.
    rtol = 2 ** -7 if out_dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), atol=1e-3, rtol=rtol)


@pytest.mark.cuda
# x rows around the n8 columns and the 64-row block, at the widest K (ten
# chunks a split), without a bias.
@pytest.mark.parametrize("M", [8, 39, 41, 64, 65, 128, 255])
def test_int8_mm_kernel_matches_plain_without_bias(gen, M):
    K, N = 5120, 1280
    x = torch.randn((M, K), device="cuda", generator=gen).bfloat16()
    w = torch.randint(-127, 128, (K, N), device="cuda", generator=gen, dtype=torch.int8)
    scale = torch.rand((N,), device="cuda", generator=gen) * 0.01
    got = int8_mm.int8_matmul(x, w, scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), int8_mm.int8_matmul_plain(x, w, scale).float(), atol=1e-3, rtol=2**-7)


@pytest.mark.cuda
# The int8 wav2vec2 base's projections in a short alignment batch: 2 or 4
# rows of 49 frames (a 1 s bucket).
@pytest.mark.parametrize("M", [98, 196])
@pytest.mark.parametrize("K,N", [(512, 768), (768, 768), (768, 3072), (3072, 768)])
def test_int8_mm_kernel_matches_plain_at_wav2vec2_shapes(gen, M, K, N):
    x = torch.randn((M, K), device="cuda", generator=gen).bfloat16()
    w = torch.randint(-127, 128, (K, N), device="cuda", generator=gen, dtype=torch.int8)
    scale = torch.rand((N,), device="cuda", generator=gen) * 0.01
    bias = torch.randn((N,), device="cuda", generator=gen)
    before = int8_mm.launches
    got = int8_mm.int8_matmul(x, w, scale, bias, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert int8_mm.launches == before + 1
    want = int8_mm.int8_matmul_plain(x, w, scale, bias, out_dtype=torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-3, rtol=2**-7)


@pytest.mark.cuda
# Whisper large-v2's decoder projections at the tensor-parallel shard shapes
# of a (data, 2) mesh in the beam step (M 40): q/k/v and cross-q split their
# columns (K 1280 → N 640), fc1 (1280 → 2560); the row-parallel out/cross-out
# (K 640 → N 1280) and fc2 (2560 → 1280). Each without a bias in fp32 (the
# row-parallel partial products, models/whisper.py:Dense._row_parallel; the
# key projection has no bias either) and with one in bf16.
@pytest.mark.parametrize("K,N", [(1280, 640), (1280, 2560), (640, 1280), (2560, 1280)])
@pytest.mark.parametrize("with_bias,out_dtype", [(False, torch.float32), (True, torch.bfloat16)])
def test_int8_mm_kernel_matches_plain_at_tensor_parallel_shards(gen, K, N, with_bias, out_dtype):
    M = 40
    x = torch.randn((M, K), device="cuda", generator=gen).bfloat16()
    w = torch.randint(-127, 128, (K, N), device="cuda", generator=gen, dtype=torch.int8)
    scale = torch.rand((N,), device="cuda", generator=gen) * 0.01
    bias = torch.randn((N,), device="cuda", generator=gen) if with_bias else None
    before = int8_mm.launches
    got = int8_mm.int8_matmul(x, w, scale, bias, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert int8_mm.launches == before + 1
    want = int8_mm.int8_matmul_plain(x, w, scale, bias, out_dtype=out_dtype)
    rtol = 2 ** -7 if out_dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), atol=1e-3, rtol=rtol)


@pytest.mark.cuda
def test_int4_unpack_on_the_card_equals_the_cpu(gen):
    """The arithmetic shifts of int8 on CUDA sign-extend as on the CPU, for
    all 256 byte values."""
    p = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    got = unpack_int4(p.cuda()).cpu()
    assert torch.equal(got, unpack_int4(p)) and torch.equal(pack_int4(got.cuda()).cpu(), p)


@pytest.mark.cuda
def test_launch_plans_size_shared_memory_as_the_kernels_do(gen):
    lib = int8_mm._lib()
    for M, K, N in [(40, 1280, 3840), (40, 5120, 1280), (256, 1280, 5120), (1, 128, 128)]:
        p = int8_mm.launch_plan(M, K, N)
        assert lib.int8_mm_smem_bytes(p.bm, p.slots, p.splits) == p.smem_bytes
    lib = cross_attn._lib()
    for B, S, H, kv_int8 in [(8, 1500, 20, True), (8, 1500, 20, False), (1, 36000, 2, True)]:
        p = cross_attn.launch_plan(B, S, H, kv_int8)
        assert lib.cross_attn_smem_bytes(p.rows_pad, int(kv_int8)) == p.smem_bytes


@pytest.mark.cuda
@pytest.mark.parametrize("kv_int8", [True, False])
# The flagship beam step and prompt, a small S (one chunk per CTA), G > 8
# (several passes of 8 query rows), and S split over a cluster of 7.
# The beam step at a rank's heads under a model axis of 2: 10 (large-v2), 6.
@pytest.mark.parametrize(
    "B,G,S,H",
    [(8, 5, 1500, 20), (8, 4, 1500, 20), (2, 3, 96, 4), (2, 20, 300, 4), (1, 3, 2100, 2), (8, 5, 1500, 10), (8, 5, 1500, 6)],
)
def test_cross_attn_kernel_matches_plain(gen, kv_int8, B, G, S, H):
    q = (torch.randn((B, G, H * 64), device="cuda", generator=gen) * 0.05).bfloat16()
    k = torch.randn((B, S, H, 64), device="cuda", generator=gen) * 0.8
    v = torch.randn((B, S, H, 64), device="cuda", generator=gen)
    f = flat_cross_kv(k, v, kv_int8)
    before = cross_attn.launches
    got = cross_attn.cross_attention_decode(q, *f)
    torch.cuda.synchronize()
    assert cross_attn.launches == before + 1
    want = cross_attn.cross_attention_plain(q, *f)
    # fp32 sums in another order; the bf16 rounding of the weights can land
    # one ulp apart.
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3)


def self_cache_operands(gen, kv_int8, rows, S, H):
    """A self cache whose every slot holds an earlier token (int8 with its
    scales, or bf16) and one fused fp32 QKV projection output (rows, 1,
    3 W) for the new token."""
    old_k = torch.randn((rows, S, H, 64), device="cuda", generator=gen)
    old_v = torch.randn((rows, S, H, 64), device="cuda", generator=gen)
    if kv_int8:
        (k, ks), (v, vs) = store_kv(old_k, 8), store_kv(old_v, 8)
        cache = {"k": k, "v": v, "k_scale": ks, "v_scale": vs}
    else:
        cache = {"k": old_k.bfloat16(), "v": old_v.bfloat16()}
    qkv = torch.randn((rows, 1, 3 * H * 64), device="cuda", generator=gen) * 1.5
    return cache, qkv


@pytest.mark.cuda
@pytest.mark.parametrize("kv_int8", [True, False])
# large-v2's and turbo's beam step (40 rows, 20 heads) over the 128-slot
# cache of the benchmark's horizon and the 448 of n_text_ctx; a rank's 10
# heads under a model axis of 2.
@pytest.mark.parametrize("rows,S,H", [(40, 128, 20), (40, 448, 20), (40, 128, 10)])
@pytest.mark.parametrize("at", [0, 1, 63, 64, -1])
def test_self_attn_decode_kernel_matches_plain(gen, kv_int8, rows, S, H, at):
    """The kernel stores the new k and v bit for bit as store_kv and
    index_copy_ do on the card (int8 values and fp32 scales, or bf16), and
    its output is the plain version's within a bf16 ulp: only the order of
    the fp32 sums differs, and a weight or an output can round one bf16
    ulp apart."""
    position = at % S
    cache, qkv = self_cache_operands(gen, kv_int8, rows, S, H)
    plain_cache = {name: t.clone() for name, t in cache.items()}
    W = H * 64
    q, k, v = qkv[..., :W], qkv[..., W : 2 * W], qkv[..., 2 * W :]
    pos = torch.tensor([position], device="cuda")
    mask = torch.where(torch.arange(S, device="cuda")[None, :] <= pos[:, None], 0.0, -1e9)
    before = self_attn_decode.launches
    got = self_attn_decode.self_attention_decode(q, k, v, cache, pos, mask, torch.bfloat16)
    torch.cuda.synchronize()
    assert self_attn_decode.launches == before + 1
    want = self_attn_decode.self_attention_plain(q, k, v, plain_cache, pos, mask, torch.bfloat16)
    for name in cache:
        assert torch.equal(cache[name], plain_cache[name]), name
    assert got.shape == want.shape == (rows, 1, W) and got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=1e-3, rtol=2**-7)


@pytest.mark.cuda
def test_self_attn_decode_kernel_reads_unfused_projections(gen):
    """q, k and v from three projections (the tensor-parallel layout): the
    kernel takes each pointer with their common row stride."""
    cache, qkv = self_cache_operands(gen, True, 8, 128, 4)
    plain_cache = {name: t.clone() for name, t in cache.items()}
    q, k, v = (t.contiguous() for t in qkv.split(256, dim=-1))
    pos = torch.tensor([77], device="cuda")
    mask = torch.where(torch.arange(128, device="cuda")[None, :] <= pos[:, None], 0.0, -1e9)
    got = self_attn_decode.self_attention_decode(q, k, v, cache, pos, mask, torch.bfloat16)
    want = self_attn_decode.self_attention_plain(q, k, v, plain_cache, pos, mask, torch.bfloat16)
    assert all(torch.equal(cache[name], plain_cache[name]) for name in cache)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-3, rtol=2**-7)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["int8", "model"])
def test_beam_decode_on_the_self_attention_kernel_matches_the_plain_route(gen, monkeypatch, kv):
    """A bf16 Whisper's beam decode takes the self-attention kernel by
    default on the device loop (one launch a layer a step, none in the
    prompt pass) and gives the tokens of the plain route, forced through
    the tests' seam; the scores agree within the fp32 sums' order."""
    import dataclasses

    import numpy as np

    from whisperx_tpu_torch.decode.engine import WhisperEngine
    from whisperx_tpu_torch.decode.tokenizer import WhisperTokenizer
    from whisperx_tpu_torch.models import whisper as tw
    from whisperx_tpu_torch.models.configs import TEST_CONFIG
    from whisperx_tpu_torch.models.convert import whisper_from_jax

    cfg = dataclasses.replace(TEST_CONFIG, n_text_state=128, n_audio_state=128, n_text_head=2, n_audio_head=2)
    params = tw.fuse_qkv_params(tw.quantize_params(tw.random_params(cfg, seed=0, scale=0.1)))
    model = whisper_from_jax(params, cfg, dtype=torch.bfloat16, device="cuda")
    engine = WhisperEngine(model, WhisperTokenizer.dummy(cfg.n_vocab, language="en"))
    opts = engine.build_options(beam_size=5, max_new_tokens=24, kv_cache_dtype=kv)
    mel = torch.randn((2, cfg.n_mels, 3000), device="cuda", generator=gen)
    got = engine.generate(mel, options=opts)
    ((_, _, graph),) = model.decode_loops.values()
    assert graph.body_launches["self_attn_decode"] == cfg.n_text_layer
    assert got.loop_span.counts["self_attn_per_step"] == cfg.n_text_layer
    force_routes(monkeypatch, self_attn="plain")
    model.decode_loops.clear()
    want = engine.generate(mel, options=opts)
    assert want.loop_span.counts["self_attn_per_step"] == 0
    assert (got.tokens == want.tokens).all()
    np.testing.assert_allclose(got.sum_logprobs, want.sum_logprobs, atol=2e-2, rtol=0)


@pytest.mark.cuda
# S around the 64-position chunk and long, G from one row to five blocks of 8.
@pytest.mark.parametrize("S", [1, 63, 64, 65, 3000])
@pytest.mark.parametrize("G", [1, 16, 17, 40])
def test_cross_attn_kernel_matches_plain_bf16_edges(gen, S, G):
    B, H = 2, 4
    q, k, v = exact_logit_operands(gen, B, G, S, H)
    f = flat_cross_kv(k, v, False)
    got = cross_attn.cross_attention_decode(q, *f)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, cross_attn.cross_attention_plain(q, *f), atol=1e-4, rtol=1e-3)


@pytest.mark.cuda
# The Whisper large-v2 encoder, wav2vec2 base with rows of different pad
# lengths, and edges: T = 1, T not a multiple of the 64-row tile, one valid
# key, every key of a row excluded.
@pytest.mark.parametrize(
    "B,T,H,lengths",
    [(8, 1500, 20, None), (8, 1499, 12, (1499, 1479, 1200, 700, 64, 65, 1, 1499)), (1, 1, 2, None),
     (2, 100, 2, None), (3, 130, 4, (1, 130, 67)), (2, 64, 2, (0, 64)),
     # T around the 128-row tile and key tile; 180 work items (B x H x query
     # tiles), more than the persistent grid's one CTA per SM.
     (2, 127, 3, None), (2, 128, 3, (128, 5)), (2, 129, 3, (129, 128)), (2, 257, 3, (257, 129)),
     (3, 1500, 5, (1500, 1479, 1)), (1, 33, 1, None),
     # The rank's heads under a model axis of 2: large-v2 10, wav2vec2 base 6.
     (8, 1500, 10, None), (8, 1499, 6, (1499, 1479, 1200, 700, 64, 65, 1, 1499))],
)
def test_flash_attn_kernel_matches_plain(gen, B, T, H, lengths):
    q = (torch.randn((B, T, H, 64), device="cuda", generator=gen) * 0.35).bfloat16()
    k = (torch.randn((B, T, H, 64), device="cuda", generator=gen) * 0.35).bfloat16()
    v = torch.randn((B, T, H, 64), device="cuda", generator=gen).bfloat16()
    mask = None if lengths is None else torch.arange(T, device="cuda")[None, :] < torch.tensor(lengths, device="cuda")[:, None]
    before = flash_attn.launches
    got = flash_attn.flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert flash_attn.launches == before + 1
    want = flash_attn.flash_attention_plain(q, k, v, mask)
    # Another summation order and another rescaling of exp(s - m) before its
    # bf16 rounding: the bf16 output may land one ulp apart.
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3, rtol=2**-7)


@pytest.mark.cuda
def test_flash_attn_kernel_skips_a_key_tile_with_no_valid_key(gen):
    """Keys 128..255 (the middle 128-key tile) excluded in every row, plus a
    row whose only valid keys lie in the last tile."""
    B, T, H = 3, 384, 4
    q, k = ((torch.randn((B, T, H, 64), device="cuda", generator=gen) * 0.35).bfloat16() for _ in range(2))
    v = torch.randn((B, T, H, 64), device="cuda", generator=gen).bfloat16()
    mask = torch.ones((B, T), dtype=torch.bool, device="cuda")
    mask[:, 128:256] = False
    mask[2, :300] = False
    got = flash_attn.flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), flash_attn.flash_attention_plain(q, k, v, mask).float(), atol=2e-3, rtol=2**-7)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H", [(2, 300, 4), (2, 1500, 20)])
def test_flash_attn_kernel_takes_fused_qkv_slices(gen, B, T, H):
    D = H * 64
    qkv = (torch.randn((B, T, 3 * D), device="cuda", generator=gen) * 0.35).bfloat16()
    q, k, v = (qkv[..., i * D : (i + 1) * D].reshape(B, T, H, 64) for i in range(3))
    torch.testing.assert_close(
        flash_attn.flash_attention(q, k, v).float(), flash_attn.flash_attention_plain(q, k, v).float(), atol=2e-3, rtol=2**-7
    )
    with pytest.raises(TypeError):
        flash_attn.flash_attention(q.float(), k.float(), v.float())


# The training path's shape (large-v2 encoder, batch 2) and edges: T not a
# multiple of the 64-row streamed tiles or of the 128-row work items (192: a
# multiple of 64 but not of 128, with masked keys), a key one past a tile,
# one valid key, a batch row with no valid key, T = 1, a wav2vec2 base layer.
BWD_CASES = [(2, 1500, 20, None), (2, 100, 2, None), (3, 130, 4, (1, 130, 67)), (2, 64, 2, (0, 64)),
             (2, 129, 3, (129, 128)), (2, 257, 3, (257, 129)), (1, 1, 2, None), (3, 1500, 5, (1500, 1479, 1)),
             (2, 192, 3, (192, 65)), (1, 1499, 12, (1479,))]


def _bwd_operands(gen, B, T, H, lengths):
    q, k = ((torch.randn((B, T, H, 64), device="cuda", generator=gen) * 0.35).bfloat16() for _ in range(2))
    v, dout = (torch.randn((B, T, H, 64), device="cuda", generator=gen).bfloat16() for _ in range(2))
    mask = None if lengths is None else torch.arange(T, device="cuda")[None, :] < torch.tensor(lengths, device="cuda")[:, None]
    return q, k, v, dout, mask


def assert_grad_close(got, want, what):
    """A backward kernel's bf16 output against its plain version: both sum
    in fp32 and round bf16(P), bf16(dS) and the output at the same points;
    other summation orders (and exp2 against exp) may flip a rounding, so
    one bf16 ulp of the largest element, and 2**-7 relative."""
    want = want.float()
    torch.testing.assert_close(got.float(), want, atol=2**-8 * want.abs().max().item() + 1e-6, rtol=2**-7, msg=what)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,lengths", BWD_CASES)
def test_flash_attn_kernel_lse_matches_plain(gen, B, T, H, lengths):
    """The forward kernel's lse output (the training path) against the plain
    forward's: fp32 m + ln(l) from sums in another order (1e-5), -inf where a
    row has no valid key; its out equal to the launch without lse."""
    q, k, v, _, mask = _bwd_operands(gen, B, T, H, lengths)
    before = flash_attn.launches_lse
    out, lse = flash_attn._forward(q, k, v, mask, with_lse=True)
    torch.cuda.synchronize()
    assert flash_attn.launches_lse == before + 1
    want_out, want_lse = flash_attn.flash_attention_fwd_plain(q, k, v, mask)
    assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
    finite = torch.isfinite(want_lse)
    torch.testing.assert_close(lse[finite], want_lse[finite], atol=1e-5, rtol=1e-5)
    assert torch.equal(out, flash_attn.flash_attention(q, k, v, mask))
    torch.testing.assert_close(out.float(), want_out.float(), atol=2e-3, rtol=2**-7)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,lengths", BWD_CASES)
def test_flash_attn_bwd_kernels_match_plain(gen, B, T, H, lengths):
    q, k, v, dout, mask = _bwd_operands(gen, B, T, H, lengths)
    out, lse = flash_attn.flash_attention_fwd_plain(q, k, v, mask)
    before = (flash_attn.launches_bwd_dq, flash_attn.launches_bwd_dkv)
    got = flash_attn.flash_attention_backward(q, k, v, out, lse, dout, mask)
    torch.cuda.synchronize()
    assert (flash_attn.launches_bwd_dq, flash_attn.launches_bwd_dkv) == (before[0] + 1, before[1] + 1)
    want = flash_attn.flash_attention_backward_plain(q, k, v, out, lse, dout, mask)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == q.shape
        assert_grad_close(g, w, f"{name} {(B, T, H, lengths)}")


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,lengths", [(2, 1500, 20, None), (3, 1500, 5, (1500, 1479, 1))])
def test_flash_attn_bwd_kernels_are_deterministic(gen, B, T, H, lengths):
    """Two launches on the same operands give the same bits: every sum has
    one owner and one order (no atomics, no split reductions)."""
    q, k, v, dout, mask = _bwd_operands(gen, B, T, H, lengths)
    out, lse = flash_attn.flash_attention_fwd_plain(q, k, v, mask)
    first = flash_attn.flash_attention_backward(q, k, v, out, lse, dout, mask)
    second = flash_attn.flash_attention_backward(q, k, v, out, lse, dout, mask)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_flash_attn_autograd_launches_every_kernel(gen):
    """``flash_attention`` under autograd on the card: one forward launch
    with lse, one dQ and one dK/dV launch, and the plain gradients (fused
    QKV slices as q, k and v, a pad mask)."""
    B, T, H = 2, 300, 4
    D = H * 64
    qkv = (torch.randn((B, T, 3 * D), device="cuda", generator=gen) * 0.35).bfloat16().requires_grad_()
    mask = torch.arange(T, device="cuda")[None, :] < torch.tensor([300, 211], device="cuda")[:, None]
    dout = torch.randn((B, T, H, 64), device="cuda", generator=gen).bfloat16()
    counts = lambda: (flash_attn.launches, flash_attn.launches_lse, flash_attn.launches_bwd_dq, flash_attn.launches_bwd_dkv)
    before = counts()
    q, k, v = (qkv[..., i * D : (i + 1) * D].reshape(B, T, H, 64) for i in range(3))
    flash_attn.flash_attention(q, k, v, mask).backward(dout)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 1, 1, 1)
    qp, kp, vp = (t.detach() for t in (q, k, v))
    out, lse = flash_attn.flash_attention_fwd_plain(qp, kp, vp, mask)
    want = torch.cat([g.reshape(B, T, D) for g in flash_attn.flash_attention_backward_plain(qp, kp, vp, out, lse, dout, mask)], -1)
    assert_grad_close(qkv.grad, want, "fused qkv grads")


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,n_mels,int16", [(8, 480000, 80, False), (8, 480000, 128, False), (8, 480000, 80, True), (1, 16000, 80, False), (2, 1600, 128, True),
                                                 # 101 frames (not a multiple of the 16-frame tile); n_mels 128 from int16
                                                 (3, 16160, 80, False), (3, 16160, 128, True), (8, 480000, 128, True)])
def test_log_mel_kernel_matches_plain(gen, B, n, n_mels, int16):
    a = torch.randn((B, n), device="cuda", generator=gen) * 0.1
    if int16:
        a = (a * 32768).round().clamp(-32768, 32767).to(torch.int16)
    before = mel.launches
    got = mel.log_mel_kernel(a, n_mels)
    torch.cuda.synchronize()
    assert mel.launches == before + 1
    # fp32 products in another order (chip_smoke.py's card-vs-CPU tolerance).
    torch.testing.assert_close(got, log_mel_spectrogram(a, n_mels, device="cuda"), atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("cross", ["xla", "pallas"])
@pytest.mark.parametrize("beam", [1, 5])
def test_device_loop_equals_host_loop(gen, monkeypatch, beam, cross):
    """The decode loop as one WHILE-node graph launch (ops/graph_loop.py)
    gives the host loop's tokens and statistics, bit for bit, on a 128-wide
    int8 Whisper with the int8 KV cache; the exit is tested on the card, and
    the kernels' launches in the loop are those of the captured step times
    the steps the card counted."""
    import dataclasses

    from whisperx_tpu_torch.decode.engine import WhisperEngine
    from whisperx_tpu_torch.decode.tokenizer import WhisperTokenizer
    from whisperx_tpu_torch.models import whisper as tw
    from whisperx_tpu_torch.models.configs import TEST_CONFIG
    from whisperx_tpu_torch.models.convert import whisper_from_jax
    from whisperx_tpu_torch.ops import graph_loop

    cfg = dataclasses.replace(TEST_CONFIG, n_text_state=128, n_audio_state=128, n_text_head=2, n_audio_head=2)
    params = tw.fuse_qkv_params(tw.quantize_params(tw.random_params(cfg, seed=0, scale=0.1)))
    model = whisper_from_jax(params, cfg, device="cuda")
    tok = WhisperTokenizer.dummy(cfg.n_vocab, language="en")
    engine = WhisperEngine(model, tok)
    force_routes(monkeypatch, cross=cross)
    opts = engine.build_options(beam_size=beam, max_new_tokens=24, kv_cache_dtype="int8")
    mel = torch.randn((2, cfg.n_mels, 3000), device="cuda", generator=gen)
    assert engine.uses_device_loop(opts)
    graph_loop.reset_counts()
    got = engine.generate(mel, options=opts)
    assert graph_loop.launches == 1
    ((loop, _, graph),) = engine.model.decode_loops.values()
    assert graph_loop.kernel_launches() == {n: c * int(loop.step) for n, c in graph.body_launches.items()}
    monkeypatch.setattr(WhisperEngine, "uses_device_loop", lambda self, opts: False)  # the host loop on the card
    want = engine.generate(mel, options=opts)
    assert graph_loop.launches == 1
    assert (got.tokens == want.tokens).all() and (got._stats == want._stats).all()


@pytest.mark.cuda
def test_default_options_take_the_cross_attention_kernel_in_the_device_loop(gen, monkeypatch):
    """A bf16 int8 Whisper with the default options runs its beam loop's
    cross attention on the kernel: the captured step launches
    cross_attention_decode once a decoder layer and the ``decode.loop`` span
    counts as many. The einsum, forced through the tests' seam, is a loop
    of its own under its own key and launches none."""
    import dataclasses

    from whisperx_tpu_torch.decode.engine import WhisperEngine
    from whisperx_tpu_torch.decode.tokenizer import WhisperTokenizer
    from whisperx_tpu_torch.models import whisper as tw
    from whisperx_tpu_torch.models.configs import TEST_CONFIG
    from whisperx_tpu_torch.models.convert import whisper_from_jax

    cfg = dataclasses.replace(TEST_CONFIG, n_text_state=128, n_audio_state=128, n_text_head=2, n_audio_head=2)
    params = tw.fuse_qkv_params(tw.quantize_params(tw.random_params(cfg, seed=0, scale=0.1)))
    model = whisper_from_jax(params, cfg, dtype=torch.bfloat16, device="cuda")
    engine = WhisperEngine(model, WhisperTokenizer.dummy(cfg.n_vocab, language="en"))
    opts = engine.build_options(beam_size=5, max_new_tokens=24, kv_cache_dtype="int8")
    assert engine._cross_impl(opts) == "pallas"
    mel = torch.randn((2, cfg.n_mels, 3000), device="cuda", generator=gen)
    got = engine.generate(mel, options=opts)
    ((key, (_, cross, graph)),) = model.decode_loops.items()
    assert key[-1] == "pallas" and all(isinstance(kv, tw.FlatCrossKV) for kv in cross)
    assert graph.body_launches["cross_attention_decode"] == cfg.n_text_layer
    assert got.loop_span.counts["cross_attn_per_step"] == cfg.n_text_layer
    again = engine.generate(mel, options=opts)
    assert len(model.decode_loops) == 1 and again.loop_span.counts["cross_attn_per_step"] == cfg.n_text_layer
    assert (got.tokens == again.tokens).all() and (got._stats == again._stats).all()
    force_routes(monkeypatch, cross="xla")
    einsum = engine.generate(mel, options=opts)
    assert einsum.loop_span.counts["cross_attn_per_step"] == 0
    assert len(model.decode_loops) == 2 and list(model.decode_loops)[-1][-1] == "xla"


@pytest.mark.cuda
def test_default_options_take_the_flash_kernel_in_both_encoders(gen, monkeypatch):
    """A bf16 Whisper encoder and a bf16 wav2vec2 base (heads of 64) run
    their self-attention on the flash kernel: one launch a layer, an output
    bit-equal to "flash" forced through the tests' seam, none under a forced
    "xla". Through the pipeline, each ``asr.prepare`` span counts the
    Whisper encoder's launches and each ``align.emissions`` span wav2vec2
    base's 12."""
    import dataclasses

    import numpy as np

    from whisperx_tpu_torch.align import alignment
    from whisperx_tpu_torch.decode.engine import WhisperEngine
    from whisperx_tpu_torch.decode.tokenizer import WhisperTokenizer
    from whisperx_tpu_torch.models import whisper as tw
    from whisperx_tpu_torch.models.configs import TEST_CONFIG, WAV2VEC2_BASE
    from whisperx_tpu_torch.models.convert import whisper_from_jax
    from whisperx_tpu_torch.pipeline.asr import TranscriptionOptions, WhisperPipeline
    from whisperx_tpu_torch.utils import telemetry
    from whisperx_tpu_torch.vad.model import EnergyVAD, VadPipeline

    cfg = dataclasses.replace(TEST_CONFIG, n_text_state=128, n_audio_state=128, n_text_head=2, n_audio_head=2)
    params = tw.fuse_qkv_params(tw.quantize_params(tw.random_params(cfg, seed=0, scale=0.1)))
    model = whisper_from_jax(params, cfg, dtype=torch.bfloat16, device="cuda")
    am = alignment.test_align_model("en", seed=0, config=WAV2VEC2_BASE, dtype=torch.bfloat16, device="cuda")

    def launched(fn):
        before = flash_attn.launches
        out = fn()
        torch.cuda.synchronize()
        return out, flash_attn.launches - before

    mel = torch.randn((2, cfg.n_mels, 3000), device="cuda", generator=gen)
    with torch.inference_mode():
        got, n = launched(lambda: model.encode(mel))
        assert n == cfg.n_audio_layer
        force_routes(monkeypatch, attn="flash")
        assert torch.equal(got, model.encode(mel))
        force_routes(monkeypatch, attn="xla")
        assert launched(lambda: model.encode(mel))[1] == 0
    monkeypatch.undo()  # the rule again

    # Tone bursts 4 s apart: one VAD chunk each at chunk_size=5.
    rng, parts = np.random.default_rng(0), []
    for i in range(5):
        t = np.arange(int((1.5 + 0.3 * i) * 16_000)) / 16_000
        x = 0.3 * np.sin(2 * np.pi * (180.0 + 40 * i) * t) * (1 + 0.5 * np.sin(2 * np.pi * 3.1 * t))
        parts += [np.zeros(8_000), x + 0.05 * rng.standard_normal(len(t)), np.zeros(56_000)]
    audio = np.concatenate(parts).astype(np.float32)
    tok = WhisperTokenizer.dummy(cfg.n_vocab, language="en")
    pipe = WhisperPipeline(
        engine=WhisperEngine(model, tok), vad=VadPipeline(EnergyVAD()),
        vad_params={"vad_onset": 0.5, "vad_offset": 0.363}, options=TranscriptionOptions(beam_size=2, max_new_tokens=8),
        tokenizer=tok, language="en", kv_cache_dtype="int8",
    )
    meta = {"language": "en", "dictionary": am.dictionary}
    start = max((s.span_id for s in telemetry.spans()), default=0)
    result, n_asr = launched(lambda: pipe.transcribe(audio, batch_size=2, chunk_size=5))
    segs = [dict(s, text="the quick brown fox") for s in result["segments"]]
    aligned, n_align = launched(lambda: alignment.align([dict(s) for s in segs], am, meta, audio, "cuda"))
    spans = [s for s in telemetry.spans() if s.span_id > start]
    prepare = [s.counts["flash_launches"] for s in spans if s.name == "asr.prepare"]
    emissions = [s.counts["flash_launches"] for s in spans if s.name == "align.emissions"]
    assert len(segs) == 5 and len(prepare) == 3 and len(emissions) == 1
    assert prepare == [cfg.n_audio_layer] * 3 and sum(prepare) == n_asr
    assert emissions == [WAV2VEC2_BASE.num_layers] == [12] and n_align == 12
    force_routes(monkeypatch, attn="flash")
    assert alignment.align([dict(s) for s in segs], am, meta, audio, "cuda") == aligned
    force_routes(monkeypatch, attn="xla")
    assert launched(lambda: alignment.align([dict(s) for s in segs], am, meta, audio, "cuda"))[1] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.2, 1.0])
def test_sampled_device_loop_equals_host_loop(gen, monkeypatch, temperature):
    """A sampled decode (temperature > 0) runs on the device loop: its
    counter-based Gumbel-max draw gives the host loop's tokens and
    statistics bit for bit from the same seed; one kept loop serves every
    temperature (a static input, not part of the loop's key); rows draw
    their own numbers, so copies of one input decode to distinct tokens."""
    import dataclasses

    from whisperx_tpu_torch.decode.engine import WhisperEngine
    from whisperx_tpu_torch.decode.tokenizer import WhisperTokenizer
    from whisperx_tpu_torch.models import whisper as tw
    from whisperx_tpu_torch.models.configs import TEST_CONFIG
    from whisperx_tpu_torch.models.convert import whisper_from_jax
    from whisperx_tpu_torch.ops import graph_loop

    cfg = dataclasses.replace(TEST_CONFIG, n_text_state=128, n_audio_state=128, n_text_head=2, n_audio_head=2)
    params = tw.fuse_qkv_params(tw.quantize_params(tw.random_params(cfg, seed=0, scale=0.1)))
    model = whisper_from_jax(params, cfg, device="cuda")
    engine = WhisperEngine(model, WhisperTokenizer.dummy(cfg.n_vocab, language="en"))
    base = engine.build_options(beam_size=1, max_new_tokens=24, kv_cache_dtype="int8")
    mel = torch.randn((1, cfg.n_mels, 3000), device="cuda", generator=gen).expand(4, -1, -1).contiguous()
    graph_loop.reset_counts()
    got = {}
    for temp in (temperature, 0.5):
        opts = dataclasses.replace(base, temperature=temp)
        assert engine.uses_device_loop(opts)
        got[temp] = engine.generate(mel, options=opts, generator=torch.Generator().manual_seed(7))
    assert graph_loop.launches == 2 and len(engine.model.decode_loops) == 1
    assert len({tuple(r) for r in got[temperature].tokens.tolist()}) > 1  # copies of one input, distinct draws
    monkeypatch.setattr(WhisperEngine, "uses_device_loop", lambda self, opts: False)  # the host loop on the card
    opts = dataclasses.replace(base, temperature=temperature)
    want = engine.generate(mel, options=opts, generator=torch.Generator().manual_seed(7))
    assert graph_loop.launches == 2
    assert (got[temperature].tokens == want.tokens).all() and (got[temperature]._stats == want._stats).all()


@pytest.mark.cuda
def test_device_loop_span_counts_the_steps_and_the_trace_brackets_each_launch(gen):
    """Each launch's ``decode.loop`` span counts the steps the card ran (the
    steps arrive with the batch's result, no read of their own) and times
    the launch with device events; a profiler's trace of two launches holds
    the loop graph's outer kernels, ``loop_enter`` and ``loop_exit``, once a
    launch, on the device's clock around the WHILE body it cannot see."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from whisperx_tpu_torch.decode.engine import WhisperEngine
    from whisperx_tpu_torch.decode.tokenizer import WhisperTokenizer
    from whisperx_tpu_torch.models import whisper as tw
    from whisperx_tpu_torch.models.configs import TEST_CONFIG
    from whisperx_tpu_torch.models.convert import whisper_from_jax
    from whisperx_tpu_torch.utils import telemetry

    cfg = dataclasses.replace(TEST_CONFIG, n_text_state=128, n_audio_state=128, n_text_head=2, n_audio_head=2)
    params = tw.fuse_qkv_params(tw.quantize_params(tw.random_params(cfg, seed=0, scale=0.1)))
    engine = WhisperEngine(whisper_from_jax(params, cfg, device="cuda"), WhisperTokenizer.dummy(cfg.n_vocab, language="en"))
    opts = engine.build_options(beam_size=5, max_new_tokens=24, kv_cache_dtype="int8")
    mels = [torch.randn((2, cfg.n_mels, 3000), device="cuda", generator=gen) for _ in range(2)]
    engine.generate(mels[0], options=opts)  # the capture
    ((_, _, graph),) = engine.model.decode_loops.values()
    torch.cuda.synchronize()
    before = int(graph.steps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        results = [engine.generate(mel, options=opts, sync=False) for mel in mels]
        assert all("steps" not in r.loop_span.counts for r in results)  # nothing read back yet
        for r in results:
            r.fetch()
        torch.cuda.synchronize()
    steps = [r.loop_span.counts["steps"] for r in results]
    assert sum(steps) == int(graph.steps) - before and min(steps) >= 1
    assert steps == [int(r._stats[3, 0]) for r in results] and (results[0]._stats[3] == steps[0]).all()
    log = {s.span_id: s for s in telemetry.spans()}
    assert all(log[r.loop_span.span_id].device_ms > 0 for r in results)
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("loop_enter" in n for n in kernels) == 2 and sum("loop_exit" in n for n in kernels) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("name,kv,int8_per_step,cross_per_step", [("large-v2", "int8", 192, 32), ("large-v3-turbo", "model", 0, 4)])
def test_loop_span_counts_the_steps_projection_and_cross_kernels(gen, name, kv, int8_per_step, cross_per_step):
    """At the published decoder widths and depth (one encoder layer: the
    encoder launches nothing in the loop), the ``decode.loop`` span counts
    the captured step's ``int8_matmul`` launches (6 a layer of an int8
    model with fused QKV, none where the weights are bf16: cuBLAS), its
    ``cross_attention_decode`` launches (one a layer) and its
    ``self_attn_decode`` launches (one a layer, on the int8 and on the bf16
    self cache). Zero weights: only the launches are read."""
    import dataclasses

    from whisperx_tpu_torch.decode.engine import WhisperEngine
    from whisperx_tpu_torch.decode.tokenizer import WhisperTokenizer
    from whisperx_tpu_torch.models import whisper as tw
    from whisperx_tpu_torch.models.configs import WHISPER_CONFIGS

    cfg = dataclasses.replace(WHISPER_CONFIGS[name], n_audio_layer=1)
    model = tw.Whisper(cfg, dtype=torch.bfloat16, quantized=kv == "int8", fused_qkv=True, device="cuda")
    engine = WhisperEngine(model, WhisperTokenizer.dummy(cfg.n_vocab, language="en"))
    opts = engine.build_options(beam_size=5, max_new_tokens=8, kv_cache_dtype=kv)
    got = engine.generate(torch.randn((2, cfg.n_mels, 3000), device="cuda", generator=gen), options=opts)
    counts = got.loop_span.counts
    assert (counts["int8_mm_per_step"], counts["cross_attn_per_step"]) == (int8_per_step, cross_per_step)
    assert counts["self_attn_per_step"] == cfg.n_text_layer  # the self-attention kernel, one a layer
    assert counts["steps"] >= 1


def ctc_operands(gen, T, V, N, t_lens, n_lens):
    """Log-softmax emissions (B, T, V) peaked enough that paths move, token
    ids in [1, V), and the lengths, all on the card."""
    B = len(t_lens)
    logp = torch.log_softmax(torch.randn((B, T, V), device="cuda", generator=gen) * 3, dim=-1)
    tokens = torch.randint(1, V, (B, N), device="cuda", generator=gen)
    return logp, tokens, torch.tensor(t_lens, device="cuda"), torch.tensor(n_lens, device="cuda")


CTC_CASES = [
    # The alignment path's batch: 8 rows of 1,479 valid frames, bench.py's
    # ~400-character transcript, N bucketed to 448.
    (1499, 32, 448, [1479] * 8, [398] * 8),
    # Ragged: a full row, a short one, one that cannot align (t_len <
    # n_len), one token, no token; N + 1 not a multiple of 32.
    (1499, 32, 448, [1499, 1200, 300, 1479, 17], [400, 448, 400, 1, 0]),
    # Decision bits over the 227 KB of shared memory: the scratch branch.
    (1499, 32, 1280, [1499, 1400], [1200, 1280]),
    (40, 12, 1, [40, 3], [1, 1]),
    # A wider vocabulary (ring rows of 66 floats) and T shorter than one ring chunk.
    (1499, 64, 448, [1499, 1300, 900], [448, 300, 17]),
    (20, 32, 40, [20, 20, 9], [12, 40, 5]),
    # A vocabulary as wide as the CJK wav2vec2 models' (thousands of ids):
    # a ring of one stage of 8 rows, two CTA barriers a chunk.
    (1499, 3500, 128, [1499, 1200], [128, 90]),
    # N above 2,048: two warps of 64 slots, the boundary column through the mailbox.
    (1499, 32, 2100, [1499, 1499, 1400], [2100, 1300, 700]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("T,V,N,t_lens,n_lens", CTC_CASES)
def test_ctc_kernel_matches_plain(gen, T, V, N, t_lens, n_lens):
    """csrc/ctc_align.cu against its plain version on the same card: the
    trellis, token indices, active steps, success and start rows bit for
    bit, probs to 1e-6 relative (expf against torch.exp); one launch a call."""
    logp, tokens, t_len, n_len = ctc_operands(gen, T, V, N, t_lens, n_lens)
    before = ctc.launches
    trellis = ctc.ctc_trellis_batch(logp, tokens, t_len, n_len)
    got = ctc.ctc_align_batch_device(logp, tokens, t_len, n_len)
    torch.cuda.synchronize()
    assert ctc.launches == before + 2
    assert ctc.launch_plan(T, N, V).bits_in_smem == (N < 1024)
    assert torch.equal(trellis, ctc.ctc_trellis_batch_plain(logp, tokens, t_len, n_len))
    want = ctc.ctc_align_batch_device_plain(logp, tokens, t_len, n_len)
    for name, g, w in zip(("token_idx", "probs", "active", "success", "t_start"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name == "probs":
            torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
        else:
            assert torch.equal(g, w), name
    if len(t_lens) == 5:  # the row with fewer frames than tokens fails; the one without tokens succeeds
        assert not got[3][2] and got[3][4]


@pytest.mark.cuda
def test_ctc_shuffle_probe_runs(gen):
    """The dependency-bound probe of csrc/ctc_align.cu (T dependent steps of
    one warp: a shuffle, an add, a compare-select) runs and takes time."""
    ms = ctc.shuffle_steps_ms(8, 1499, iters=3)
    assert ms > 0


@pytest.mark.cuda
# 15-minute files, and one cut to the prime length below 15 minutes.
@pytest.mark.parametrize("traffic,samples", [("longform-dense", None), ("sparse-speech", None),
                                             ("sparse-speech", 14_399_999)])
def test_vad_band_on_the_card_cuts_as_numpy(gen, traffic, samples):
    """Files of the benchmark's burst shapes through the scorer
    ``load_vad_model`` builds for the card: the chunks of the numpy route to
    the millisecond, frame energies within the CPU test's tolerance
    (``test_torch_vad.py::test_torch_band_path_matches_numpy``), one
    ``vad.band`` span with ``on_card`` 1 a call, and every card tensor freed
    before the call returns."""
    import numpy as np
    from traffic_files import traffic_audio
    from whisperx_tpu_torch.utils import telemetry
    from whisperx_tpu_torch.vad import model as vad

    audio = traffic_audio(traffic, 15.0)[:samples]
    card = vad.load_vad_model("cuda")
    assert vad.band_route(card.scorer.device) == "torch"
    host = vad.VadPipeline(vad.SpeechBandVAD())

    def rounded(chunks):
        return [(round(c["start"], 3), round(c["end"], 3)) for c in chunks]

    start = max((s.span_id for s in telemetry.spans()), default=0)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    got = card(audio)
    assert torch.cuda.memory_allocated() == before
    want = host(audio)
    assert len(want) >= 3 and rounded(got) == rounded(want)
    bands = [s for s in telemetry.spans() if s.span_id > start and s.name == "vad.band"]
    assert len(bands) == 1 and bands[0].device.startswith("cuda") and bands[0].device_ms > 0
    assert dict(bands[0].counts) == {"samples": len(audio), "on_card": 1}

    starts = np.arange((len(audio) - vad.FRAME_SIZE) // vad.FRAME_STEP + 1) * vad.FRAME_STEP
    e_host = vad.band_energies_numpy(audio, vad.SpeechBandVAD().band, starts)
    e_card = vad.band_energies_torch(audio, vad.SpeechBandVAD().band, torch.device("cuda"))
    np.testing.assert_allclose(e_card, e_host, rtol=1e-3, atol=1e-8 * e_host.max())
