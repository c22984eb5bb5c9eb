"""The decode cross-attention route: which path the rule takes.

``decode/engine.py:resolve_cross_impl`` decides from what the engine can
observe (device, compute dtype, the cross K/V's width, a layer's local
heads), so these cases need no card: a CUDA device object is only a name
until a tensor is put on it. Imports neither JAX nor the JAX package.
"""

import dataclasses
from types import SimpleNamespace

import pytest
import torch

from torch_routes import force_routes
from whisperx_tpu_torch.decode.engine import WhisperEngine, resolve_cross_impl
from whisperx_tpu_torch.decode.search import SearchOptions
from whisperx_tpu_torch.models.whisper import FlatCrossKV

BF16, F32 = torch.bfloat16, torch.float32

# (device, dtype, kv_cache_dtype, local width, local heads, WHISPERX_CROSS_ATTN) → route
CASES = [
    # The card takes the kernel where it computes the einsum's function.
    ("cuda", BF16, "int8", 1280, 20, None, "pallas"),  # large-v2, the benchmark's configuration
    ("cuda", BF16, "model", 1280, 20, None, "pallas"),  # bf16 cross K/V
    ("cuda", BF16, "int8", 640, 10, None, "pallas"),  # large-v2 split over two ranks
    ("cuda", BF16, "int8", 384, 6, None, "pallas"),  # tiny
    ("cuda", BF16, "int8", 512, 8, None, "pallas"),  # base
    ("cuda", BF16, "int8", 768, 12, None, "pallas"),  # small
    ("cuda:1", BF16, "int8", 1024, 16, None, "pallas"),  # medium, another card
    # Everywhere else the einsum.
    ("cpu", BF16, "int8", 1280, 20, None, "xla"),
    ("cpu", F32, "model", 1280, 20, None, "xla"),
    ("cuda", F32, "int8", 1280, 20, None, "xla"),  # fp32 compute: the kernel takes bf16 queries
    ("cuda", F32, "model", 1280, 20, None, "xla"),
    ("cuda", BF16, "int4", 1280, 20, None, "xla"),  # int4 would get int8 cross K/V under the kernel
    ("cuda", BF16, "int8", 320, 5, None, "xla"),  # large-v2 over four ranks: an odd head count
    ("cuda", BF16, "int8", 64, 2, None, "xla"),  # heads of 32
    ("cuda", BF16, "int8", 128, 1, None, "xla"),  # one head of 128
    # WHISPERX_CROSS_ATTN is the JAX package's variable, which its tests
    # set in the same process: the port's rule reads none, whatever its value.
    ("cuda", BF16, "int8", 1280, 20, "xla", "pallas"),
    ("cuda", BF16, "model", 1280, 20, "xla", "pallas"),
    ("cpu", F32, "int8", 128, 2, "pallas", "xla"),
    ("cpu", BF16, "model", 128, 2, "pallas", "xla"),
    ("cuda", BF16, "int8", 1280, 20, "auto", "pallas"),
    ("cpu", BF16, "int8", 1280, 20, "auto", "xla"),
    ("cuda", BF16, "int8", 1280, 20, "kernel", "pallas"),
]


def stub_engine(device: str, dtype: torch.dtype, width: int, n_head: int) -> WhisperEngine:
    """An engine over a stand-in model that has what the route reads."""
    attn = SimpleNamespace(width=width, n_head=n_head)
    model = SimpleNamespace(
        config=None, device=torch.device(device), dtype=dtype, decoder=SimpleNamespace(layers=[SimpleNamespace(cross_attn=attn)])
    )
    return WhisperEngine(model, tokenizer=None)


@pytest.mark.parametrize("device,dtype,kv,width,n_head,env,want", CASES)
def test_cross_route(monkeypatch, device, dtype, kv, width, n_head, env, want):
    if env is None:
        monkeypatch.delenv("WHISPERX_CROSS_ATTN", raising=False)
    else:
        monkeypatch.setenv("WHISPERX_CROSS_ATTN", env)
    assert stub_engine(device, dtype, width, n_head)._cross_impl(SearchOptions(kv_cache_dtype=kv)) == want
    bits = {"model": 0, "int8": 8, "int4": 4}[kv]  # the rule alone, as the engine calls it
    assert resolve_cross_impl(torch.device(device), dtype, bits, width, n_head) == want


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("kv", ["model", "int8", "int4"])
def test_cpu_default_prepares_the_einsum_cross_kv(monkeypatch, dtype, kv):
    """On the CPU the rule builds the einsum path's cross K/V, whatever the
    dtype and the KV width: tuples, not the kernel's ``FlatCrossKV``; forced
    to "pallas" (the tests' seam), the engine builds the kernel's layout."""
    from whisperx_tpu_torch.decode.tokenizer import WhisperTokenizer
    from whisperx_tpu_torch.models.configs import TEST_CONFIG
    from whisperx_tpu_torch.models.whisper import Whisper

    cfg = dataclasses.replace(TEST_CONFIG, n_text_state=128, n_audio_state=128, n_text_head=2, n_audio_head=2)
    engine = WhisperEngine(Whisper(cfg, dtype=dtype, device="cpu"), WhisperTokenizer.dummy(cfg.n_vocab, language="en"))
    mel = torch.zeros((1, cfg.n_mels, 3000))
    prompt = engine.build_prompt(1)
    opts = engine.build_options(beam_size=2, max_new_tokens=2, kv_cache_dtype=kv)
    for flat in (False, True):
        if flat:
            force_routes(monkeypatch, cross="pallas")
        with torch.inference_mode():
            _, cache, _, key = engine._prepare("beam", mel, prompt, opts)
        assert key is None  # the host loop on the CPU
        assert all(isinstance(kv_, FlatCrossKV) == flat for kv_ in cache["cross"])
