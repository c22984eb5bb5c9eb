"""The decoder's self-attention over its static cache, on the CPU:
``ops/self_attn_decode.py``'s route rule, its plain version against the
attention the decoder ran before the kernel's wrapper existed (kept below
as ``cached_attention_oracle``, written as ``MultiHeadAttention.forward``
had it), and the wrapper's contract. The kernel itself is held to the plain
version on the card (``test_torch_kernels_cuda.py``)."""

import pytest
import torch

from whisperx_tpu_torch.ops import self_attn_decode as sad
from whisperx_tpu_torch.ops.attention import matmul_f32
from whisperx_tpu_torch.ops.quant import PACKED_INT4, store_kv, unpack_int4

torch.set_num_threads(2)

H, DH = 2, 64
W = H * DH
ROWS, S = 3, 128


def cached_attention_oracle(q, k, v, cache, cache_index, mask, dt):
    """The decoder's cached self-attention as ``models/whisper.py`` ran it
    inline: (rows, T, H, Dh) fp32 projections → (rows, T, H * Dh)."""
    head_dim = q.shape[-1]
    scale = head_dim**-0.25
    q = (q * scale).to(dt)
    ks = vs = None
    if cache["k"].dtype in (torch.int8, PACKED_INT4):
        bits = 4 if cache["k"].dtype == PACKED_INT4 else 8
        qk, kss = store_kv(k, bits)
        qv, vss = store_kv(v, bits)
        for name, val in (("k", qk), ("v", qv), ("k_scale", kss), ("v_scale", vss)):
            cache[name].index_copy_(1, cache_index, val)
        ks, vs = cache["k_scale"], cache["v_scale"]
    else:
        cache["k"].index_copy_(1, cache_index, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, cache_index, v.to(cache["v"].dtype))
    k, v = cache["k"], cache["v"]
    if k.dtype == PACKED_INT4:
        k, v = unpack_int4(k), unpack_int4(v)
    Tq = q.shape[1]
    logits = matmul_f32(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1))
    logits = logits * scale
    if ks is not None:
        logits = logits * ks[..., 0].transpose(1, 2)[:, :, None, :]
    if mask is not None:
        logits = logits + mask
    weights = torch.softmax(logits, dim=-1)
    if vs is not None:
        weights = weights * vs[..., 0].transpose(1, 2)[:, :, None, :]
    out = torch.matmul(weights.to(dt), v.to(dt).permute(0, 2, 1, 3))
    return out.permute(0, 2, 1, 3).reshape(q.shape[0], Tq, H * DH)


def filled_cache(kind: str, gen) -> dict:
    """A cache whose every slot holds earlier tokens: int8 or int4 with
    their scales, or bf16 / fp32 values."""
    old_k = torch.randn((ROWS, S, H, DH), generator=gen)
    old_v = torch.randn((ROWS, S, H, DH), generator=gen)
    if kind in ("int8", "int4"):
        bits = 8 if kind == "int8" else 4
        k, ks = store_kv(old_k, bits)
        v, vs = store_kv(old_v, bits)
        return {"k": k, "v": v, "k_scale": ks, "v_scale": vs}
    dt = {"bf16": torch.bfloat16, "fp32": torch.float32}[kind]
    return {"k": old_k.to(dt), "v": old_v.to(dt)}


def fused_qkv(T: int, gen):
    """q, k, v as views of one fused (rows, T, 3 W) projection output."""
    y = torch.randn((ROWS, T, 3 * W), generator=gen) * 2
    return y[..., :W], y[..., W : 2 * W], y[..., 2 * W :]


def causal_mask(positions: torch.Tensor) -> torch.Tensor:
    k_pos = torch.arange(S)[None, :]
    return torch.where(k_pos <= positions[:, None], 0.0, -1e9).to(torch.float32)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cache_dtype", [torch.int8, torch.bfloat16, PACKED_INT4, torch.float32])
@pytest.mark.parametrize("tokens", [1, 4])
def test_route_rule(device, dtype, cache_dtype, tokens):
    kernel = (
        device == "cuda" and dtype == torch.bfloat16 and cache_dtype in (torch.int8, torch.bfloat16) and tokens == 1
    )
    assert sad.resolve_self_attn_impl(torch.device(device), dtype, cache_dtype, DH, tokens) == (
        "kernel" if kernel else "plain"
    )


@pytest.mark.parametrize("head_dim", [32, 80, 128])
def test_route_rule_takes_only_heads_of_64(head_dim):
    assert sad.resolve_self_attn_impl("cuda", torch.bfloat16, torch.int8, head_dim, 1) == "plain"


@pytest.mark.parametrize(
    "kind,dtype", [("int8", torch.bfloat16), ("bf16", torch.bfloat16), ("int4", torch.bfloat16), ("fp32", torch.float32)]
)
@pytest.mark.parametrize("positions", [(0,), (63,), (64,), (127,), (0, 1, 2, 3)])
def test_plain_version_is_the_decoders_cached_attention(kind, dtype, positions):
    """Bit for bit: the output and every byte of the cache, one token at
    slots 0, 63, 64 and the last, and a 4-token prompt from slot 0."""
    gen = torch.Generator().manual_seed(len(positions) * 1000 + positions[0])
    cache = filled_cache(kind, gen)
    want_cache = {name: t.clone() for name, t in cache.items()}
    q, k, v = fused_qkv(len(positions), gen)
    pos = torch.tensor(positions)
    mask = causal_mask(pos)
    got = sad.self_attention_plain(q, k, v, cache, pos, mask, dtype)
    split = [t.reshape(ROWS, len(positions), H, DH) for t in (q, k, v)]
    want = cached_attention_oracle(*split, want_cache, pos, mask, dtype)
    assert got.dtype == want.dtype == dtype and torch.equal(got, want)
    for name in cache:
        assert torch.equal(cache[name], want_cache[name]), name


@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("position", [0, 63, 64, 127])
def test_wrapper_on_the_cpu_runs_the_plain_version(kind, position):
    gen = torch.Generator().manual_seed(position)
    cache = filled_cache(kind, gen)
    plain_cache = {name: t.clone() for name, t in cache.items()}
    q, k, v = fused_qkv(1, gen)
    pos = torch.tensor([position])
    got = sad.self_attention_decode(q, k, v, cache, pos, causal_mask(pos), torch.bfloat16)
    want = sad.self_attention_plain(q, k, v, plain_cache, pos, causal_mask(pos), torch.bfloat16)
    assert torch.equal(got, want)
    assert all(torch.equal(cache[name], plain_cache[name]) for name in cache)


def _contract_cases():
    """(what, q, k, v, cache, positions, dtype) outside the wrapper's contract."""
    gen = torch.Generator().manual_seed(7)
    q, k, v = fused_qkv(1, gen)
    pos = torch.tensor([5])
    int8 = filled_cache("int8", gen)
    q2, k2, v2 = fused_qkv(2, gen)
    long = {"k": torch.zeros((ROWS, 449, H, DH), dtype=torch.int8), "v": torch.zeros((ROWS, 449, H, DH), dtype=torch.int8),
            "k_scale": torch.zeros((ROWS, 449, H, 1)), "v_scale": torch.zeros((ROWS, 449, H, 1))}
    narrow = {"k": torch.zeros((ROWS, S, 2 * H, DH // 2), dtype=torch.int8),
              "v": torch.zeros((ROWS, S, 2 * H, DH // 2), dtype=torch.int8),
              "k_scale": torch.zeros((ROWS, S, 2 * H, 1)), "v_scale": torch.zeros((ROWS, S, 2 * H, 1))}
    scales = {**int8, "k_scale": int8["k_scale"][:, :, :1]}
    return [
        ("two tokens", q2, k2, v2, int8, torch.tensor([5, 6]), torch.bfloat16),
        ("fp32 compute", q, k, v, int8, pos, torch.float32),
        ("int4 cache", q, k, v, filled_cache("int4", gen), pos, torch.bfloat16),
        ("fp32 cache", q, k, v, filled_cache("fp32", gen), pos, torch.bfloat16),
        ("heads of 32", q, k, v, narrow, pos, torch.bfloat16),
        ("449 slots", q, k, v, long, pos, torch.bfloat16),
        ("k of another width", q, k[..., :DH], v, int8, pos, torch.bfloat16),
        ("rows unlike the cache's", q[:2], k[:2], v[:2], int8, pos, torch.bfloat16),
        ("scales of one head", q, k, v, scales, pos, torch.bfloat16),
        ("a 0-d position", q, k, v, int8, torch.tensor(5), torch.bfloat16),
    ]


@pytest.mark.parametrize("case", range(10))
def test_wrapper_raises_outside_its_contract(case):
    what, q, k, v, cache, pos, dtype = _contract_cases()[case]
    with pytest.raises(ValueError, match="contract"):
        sad.self_attention_decode(q, k, v, cache, pos, causal_mask(pos.reshape(-1)), dtype)
