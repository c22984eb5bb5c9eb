"""whisperx_tpu_torch CUDA kernels against their plain versions, on the card.

Imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch: ``python -m pytest --noconftest tests/test_torch_kernels_cuda.py``.
Every test needs a CUDA device and skips without one.
"""

import pytest
import torch

from whisperx_tpu_torch.models.whisper import flat_cross_kv
from whisperx_tpu_torch.ops import cross_attn, int8_mm

torch.set_num_threads(2)


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
@pytest.mark.parametrize("kv_int8", [True, False])
# The flagship beam step and prompt, a small S (one CTA per head), G > 16
# (several blocks of query rows), and S beyond 8 x 256 (eight CTAs of more
# than 256 positions each).
@pytest.mark.parametrize("B,G,S,H", [(8, 5, 1500, 20), (8, 4, 1500, 20), (2, 3, 96, 4), (2, 20, 300, 4), (1, 3, 2100, 2)])
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
