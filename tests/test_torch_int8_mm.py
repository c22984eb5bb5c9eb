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


@pytest.mark.parametrize(
    "M,K,N", [(40, 1280, 1280), (40, 1280, 3840), (40, 1280, 5120), (40, 5120, 1280), (256, 1280, 5120), (1, 128, 128)]
)
def test_split_k_covers_k_with_nonempty_splits(M, K, N):
    splits, per_split = int8_mm.split_k(M, K, N)
    k_tiles = K // 64
    assert 1 <= splits <= min(k_tiles, 8)  # a cluster holds the splits of one tile
    assert (splits - 1) * per_split < k_tiles <= splits * per_split
