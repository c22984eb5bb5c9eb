"""whisperx_tpu_torch decode cross attention: the plain version against the
JAX Pallas kernel (interpret mode on the CPU), and the K/V quantization and
flat layout against the JAX package's. The CUDA kernel itself is held
against the plain version in test_torch_kernels_cuda.py and by
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperx_tpu.models.whisper import flat_cross_kv as j_flat_cross_kv
from whisperx_tpu.models.whisper import quantize_kv as j_quantize_kv
from whisperx_tpu.ops.pallas_cross_attn import cross_attention_decode as j_cross
from whisperx_tpu_torch.models.whisper import flat_cross_kv
from whisperx_tpu_torch.ops import cross_attn
from whisperx_tpu_torch.ops.quant import quantize_kv

torch.set_num_threads(2)


def _qkv(B, S, H, G, seed=0):
    Dh = 64
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, G, H * Dh)) * 0.4 * Dh**-0.5).astype(np.float32)
    k = (rng.standard_normal((B, S, H, Dh)) * 0.8).astype(np.float32)
    v = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    return q, k, v


def test_quantize_kv_matches_jax():
    _, k, _ = _qkv(2, 40, 4, 1, seed=1)
    qj, sj = j_quantize_kv(jnp.asarray(k))
    qt, st = quantize_kv(torch.from_numpy(k))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("kv_int8", [True, False])
def test_flat_cross_kv_matches_jax(kv_int8):
    _, k, v = _qkv(2, 40, 4, 1, seed=2)
    jf = j_flat_cross_kv(jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16), kv_int8)
    tf = flat_cross_kv(torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16(), kv_int8)
    for name in ("k", "v", "k_scale", "v_scale"):
        got = getattr(tf, name)
        want = np.asarray(getattr(jf, name), np.float32)
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.float().numpy(), want, err_msg=name)


@pytest.mark.parametrize("kv_int8", [True, False])
@pytest.mark.parametrize("B,S,H,G", [(2, 96, 4, 5), (1, 200, 2, 3)])
def test_plain_matches_jax_kernel(kv_int8, B, S, H, G):
    q, k, v = _qkv(B, S, H, G)
    jf = j_flat_cross_kv(jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16), kv_int8)
    want = j_cross(jnp.asarray(q, jnp.bfloat16), jf.k, jf.v, jf.k_scale, jf.v_scale, interpret=True)
    tf = flat_cross_kv(torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16(), kv_int8)
    got = cross_attn.cross_attention_decode(torch.from_numpy(q).bfloat16(), *tf)
    assert got.dtype == torch.float32 and got.shape == (B, G, H * 64)
    # tests/test_cross_attn_kernel.py tolerances (bf16 q and weights).
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0.04, rtol=0.04)


def test_wrapper_rejects_head_dims_outside_the_contract():
    q = torch.zeros((1, 2, 96), dtype=torch.bfloat16)  # Dh = 32 with 3 heads
    kv = torch.zeros((1, 8, 96), dtype=torch.int8)
    s = torch.ones((1, 3, 8))
    with pytest.raises(ValueError):
        cross_attn.cross_attention_decode(q, kv, kv, s, s)


# The flagship (int8 and bf16), the prompt, small S, S one past a chunk,
# S beyond one CTA per (b, h), long S.
@pytest.mark.parametrize(
    "B,S,H,kv_int8",
    [(8, 1500, 20, True), (8, 1500, 20, False), (2, 96, 4, True), (2, 300, 4, True), (1, 2100, 2, True),
     (1, 1, 2, True), (2, 63, 4, False), (2, 65, 4, True), (8, 3000, 20, True), (1, 36000, 2, True)],
)
def test_launch_plan_covers_s_once_with_no_empty_cta(B, S, H, kv_int8):
    p = cross_attn.launch_plan(B, S, H, kv_int8)
    assert 1 <= p.cluster <= 8 and p.rows_pad % 64 == 0
    assert p.smem_bytes == cross_attn.smem_bytes(p.rows_pad, kv_int8) <= 232_448
    covered = np.zeros(S, int)
    for r in range(p.cluster):
        s0 = r * p.rows_pad
        assert s0 < S  # every CTA owns at least one position
        covered[s0 : s0 + p.rows_pad] += 1
    assert (covered == 1).all()


def test_launch_plan_cuts_the_split_until_every_cluster_is_resident():
    # 160 (b, h) of the flagship: a card that holds 154 clusters of 4 and 203
    # of 3 runs clusters of 3 in one wave.
    held = {6: 100, 5: 120, 4: 154, 3: 203}
    p = cross_attn.launch_plan(8, 1500, 20, True, max_clusters=lambda rows_pad, cluster: held[cluster])
    assert p.cluster == 3 and p.rows_pad == 512
    assert cross_attn.launch_plan(8, 1500, 20, True, max_clusters=lambda *a: 0).cluster == 6  # none fit: the largest


def test_launch_plan_raises_when_the_logits_do_not_fit():
    with pytest.raises(ValueError):
        cross_attn.launch_plan(1, 50_000, 2, True)
