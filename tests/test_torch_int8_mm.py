"""whisperx_tpu_torch int8 matmul: the plain version against the JAX Pallas
kernel (interpret mode on the CPU), and the wrapper's contract. The CUDA
kernel itself is held against the plain version in
test_torch_kernels_cuda.py and by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperx_tpu.ops.pallas_int8_mm import int8_matmul as j_int8_matmul
from whisperx_tpu_torch.ops import int8_mm

torch.set_num_threads(2)


def _operands(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((M, K)) * 0.3).astype(np.float32)
    w = rng.integers(-127, 128, (K, N)).astype(np.int8)
    scale = rng.uniform(0.001, 0.02, (N,)).astype(np.float32)
    bias = (rng.standard_normal((N,)) * 0.1).astype(np.float32)
    return x, w, scale, bias


@pytest.mark.parametrize("M,K,N", [(40, 256, 640), (1, 128, 128), (256, 128, 384), (32, 384, 256)])
@pytest.mark.parametrize("out", ["bf16", "f32"])
def test_plain_matches_jax_kernel(M, K, N, out):
    x, w, scale, bias = _operands(M, K, N)
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}[out]
    want = j_int8_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jnp.asarray(bias), out_dtype=jdt, interpret=True
    )
    got = int8_mm.int8_matmul(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale), torch.from_numpy(bias), out_dtype=tdt
    )
    assert got.dtype == tdt and got.shape == (M, N)
    # tests/test_int8_mm.py tolerances (both sides round x to bf16 first).
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=0.5, rtol=0.02)


def test_plain_without_bias_matches_jax_kernel():
    x, w, scale, _ = _operands(8, 128, 256, seed=1)
    want = j_int8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), None, out_dtype=jnp.float32, interpret=True)
    got = int8_mm.int8_matmul(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale), out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0.5, rtol=0.02)


@pytest.mark.parametrize("M,K,N", [(257, 128, 128), (4, 128, 100), (4, 64, 128)])
def test_wrapper_rejects_shapes_outside_the_contract(M, K, N):
    x = torch.zeros((M, K))
    w = torch.zeros((K if K != 64 else 128, N), dtype=torch.int8)
    with pytest.raises(ValueError):
        int8_mm.int8_matmul(x, w, torch.ones(N))


def test_cpu_path_does_not_count_launches():
    before = int8_mm.launches
    x, w, scale, bias = _operands(4, 128, 128)
    int8_mm.int8_matmul(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale))
    assert int8_mm.launches == before


# The decode shapes (M = 40), the prompt (M = 32), and edges: one row, rows
# around a block of 64, the widest K at every M block, K past one pass; the
# int8 wav2vec2 base's short alignment batches (2 or 4 rows of 49 frames:
# feat_projection 512 → 768, attention 768 → 768, feed-forward 768 → 3072 →
# 768, the last with 48 chunks of K).
@pytest.mark.parametrize(
    "M,K,N",
    [(40, 1280, 1280), (40, 1280, 3840), (40, 1280, 5120), (40, 5120, 1280), (32, 1280, 5120), (256, 1280, 5120),
     (256, 5120, 1280), (1, 128, 128), (65, 5120, 1280), (8, 5120, 1280), (255, 64, 256), (256, 8192, 128),
     (98, 512, 768), (98, 768, 768), (98, 768, 3072), (98, 3072, 768), (196, 3072, 768), (196, 512, 768)],
)
def test_launch_plan_covers_the_output_and_k_once(M, K, N):
    p = int8_mm.launch_plan(M, K, N)
    k_chunks = K // 64
    assert p.bm % 8 == 0 and 8 <= p.bm <= 64 and 1 <= p.splits <= 8  # a cluster holds the splits of one slab
    assert p.smem_bytes == int8_mm.smem_bytes(p.bm, p.slots, p.splits) <= 232_448
    assert 1 <= p.slots <= p.chunks_per_split
    rows = np.zeros(M, int)
    for mb in range(p.m_blocks):
        m0 = mb * p.bm
        assert m0 < M  # no empty row block
        rows[m0 : m0 + p.bm] += 1
    chunks = np.zeros(k_chunks, int)
    for s in range(p.splits):
        mine = range(s * p.chunks_per_split, min(k_chunks, (s + 1) * p.chunks_per_split))
        assert len(mine) >= 1  # no empty split
        chunks[list(mine)] += 1
    assert (rows == 1).all() and (chunks == 1).all()
    assert N % 128 == 0  # N // 128 slabs of 128 channels cover the columns once


def test_launch_plan_fills_the_card_at_the_widest_decode_projection():
    p = int8_mm.launch_plan(40, 1280, 5120)
    assert 100 <= (5120 // 128) * p.splits <= 2 * 132 and p.slots == p.chunks_per_split  # one pass


def test_build_digest_covers_the_shared_headers(tmp_path, monkeypatch):
    from whisperx_tpu_torch.ops import _build

    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    before = _build._target("k")
    (tmp_path / "h.cuh").write_text("// v2\n")
    assert _build._target("k") != before


def test_launch_plan_cuts_the_split_until_every_cluster_is_resident():
    # 40 slabs of the widest decode projection: 3 splits fill the card, but
    # a card that holds only 38 clusters of 3 would run a second wave.
    held = {3: 38, 2: 60}
    p = int8_mm.launch_plan(40, 1280, 5120, max_clusters=lambda bm, slots, splits: held[splits])
    assert p.splits == 2 and p.chunks_per_split == 10
    assert int8_mm.launch_plan(40, 1280, 5120, max_clusters=lambda *a: 132).splits == 3
