"""The decode cross-attention route: which path "auto" takes, and what wins.

``decode/engine.py:resolve_cross_impl`` decides from what the engine can
observe (device, compute dtype, the cross K/V's width, a layer's local
heads), so these cases need no card: a CUDA device object is only a name
until a tensor is put on it. Imports neither JAX nor the JAX package.
"""

import dataclasses
from types import SimpleNamespace

import pytest
import torch

from whisperx_tpu_torch.decode.engine import WhisperEngine, resolve_cross_impl
from whisperx_tpu_torch.decode.search import SearchOptions
from whisperx_tpu_torch.models.whisper import FlatCrossKV

BF16, F32 = torch.bfloat16, torch.float32

# (device, dtype, kv_cache_dtype, local width, local heads, preference, WHISPERX_CROSS_ATTN) → route
CASES = [
    # "auto" on the card takes the kernel where it computes the einsum's function.
    ("cuda", BF16, "int8", 1280, 20, "auto", None, "pallas"),  # large-v2, the benchmark's configuration
    ("cuda", BF16, "model", 1280, 20, "auto", None, "pallas"),  # bf16 cross K/V
    ("cuda", BF16, "int8", 640, 10, "auto", None, "pallas"),  # large-v2 split over two ranks
    ("cuda", BF16, "int8", 384, 6, "auto", None, "pallas"),  # tiny
    ("cuda:1", BF16, "int8", 1024, 16, "auto", None, "pallas"),  # medium, another card
    # Everywhere else "auto" keeps the einsum.
    ("cpu", BF16, "int8", 1280, 20, "auto", None, "xla"),
    ("cpu", F32, "model", 1280, 20, "auto", None, "xla"),
    ("cuda", F32, "int8", 1280, 20, "auto", None, "xla"),  # fp32 compute: the kernel takes bf16 queries
    ("cuda", F32, "model", 1280, 20, "auto", None, "xla"),
    ("cuda", BF16, "int4", 1280, 20, "auto", None, "xla"),  # int4 would get int8 cross K/V under the kernel
    ("cuda", BF16, "int8", 320, 5, "auto", None, "xla"),  # large-v2 over four ranks: an odd head count
    ("cuda", BF16, "int8", 64, 2, "auto", None, "xla"),  # heads of 32
    ("cuda", BF16, "int8", 128, 1, "auto", None, "xla"),  # one head of 128
    # An explicit route is kept, on any device and dtype.
    ("cuda", BF16, "int8", 1280, 20, "xla", None, "xla"),
    ("cpu", F32, "int8", 128, 2, "pallas", None, "pallas"),
    ("cuda", BF16, "int4", 1280, 20, "pallas", None, "pallas"),
    # WHISPERX_CROSS_ATTN wins over the options, both ways; other values are ignored.
    ("cuda", BF16, "int8", 1280, 20, "auto", "xla", "xla"),
    ("cuda", BF16, "int8", 1280, 20, "pallas", "xla", "xla"),
    ("cpu", F32, "int8", 128, 2, "auto", "pallas", "pallas"),
    ("cpu", F32, "int8", 128, 2, "xla", "pallas", "pallas"),
    ("cuda", BF16, "int8", 1280, 20, "auto", "auto", "pallas"),
    ("cpu", BF16, "int8", 1280, 20, "auto", "auto", "xla"),
    ("cuda", BF16, "int8", 1280, 20, "xla", "kernel", "xla"),
]


def stub_engine(device: str, dtype: torch.dtype, width: int, n_head: int) -> WhisperEngine:
    """An engine over a stand-in model that has what the route reads."""
    attn = SimpleNamespace(width=width, n_head=n_head)
    model = SimpleNamespace(
        config=None, device=torch.device(device), dtype=dtype, decoder=SimpleNamespace(layers=[SimpleNamespace(cross_attn=attn)])
    )
    return WhisperEngine(model, tokenizer=None)


@pytest.mark.parametrize("device,dtype,kv,width,n_head,pref,env,want", CASES)
def test_cross_route(monkeypatch, device, dtype, kv, width, n_head, pref, env, want):
    if env is None:
        monkeypatch.delenv("WHISPERX_CROSS_ATTN", raising=False)
    else:
        monkeypatch.setenv("WHISPERX_CROSS_ATTN", env)
    opts = SearchOptions(kv_cache_dtype=kv, cross_attn=pref)
    assert stub_engine(device, dtype, width, n_head)._cross_impl(opts) == want
    if env is None:  # the rule alone, as the engine calls it
        bits = {"model": 0, "int8": 8, "int4": 4}[kv]
        assert resolve_cross_impl(pref, torch.device(device), dtype, bits, width, n_head) == want


def test_cross_route_refuses_an_unknown_preference(monkeypatch):
    monkeypatch.delenv("WHISPERX_CROSS_ATTN", raising=False)
    with pytest.raises(ValueError, match="cross_attn"):
        stub_engine("cuda", BF16, 1280, 20)._cross_impl(SearchOptions(cross_attn="flash"))
    with pytest.raises(ValueError, match="cross_attn"):
        resolve_cross_impl("einsum", "cpu", F32, 0, 1280, 20)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("kv", ["model", "int8", "int4"])
def test_cpu_default_prepares_the_einsum_cross_kv(monkeypatch, dtype, kv):
    """On the CPU "auto" builds the einsum path's cross K/V, whatever the
    dtype and the KV width: tuples, not the kernel's ``FlatCrossKV``; an
    explicit "pallas" builds the kernel's layout."""
    from whisperx_tpu_torch.decode.tokenizer import WhisperTokenizer
    from whisperx_tpu_torch.models.configs import TEST_CONFIG
    from whisperx_tpu_torch.models.whisper import Whisper

    monkeypatch.delenv("WHISPERX_CROSS_ATTN", raising=False)
    cfg = dataclasses.replace(TEST_CONFIG, n_text_state=128, n_audio_state=128, n_text_head=2, n_audio_head=2)
    engine = WhisperEngine(Whisper(cfg, dtype=dtype, device="cpu"), WhisperTokenizer.dummy(cfg.n_vocab, language="en"))
    mel = torch.zeros((1, cfg.n_mels, 3000))
    prompt = engine.build_prompt(1)
    for pref, flat in (("auto", False), ("pallas", True)):
        opts = dataclasses.replace(engine.build_options(beam_size=2, max_new_tokens=2, kv_cache_dtype=kv), cross_attn=pref)
        with torch.inference_mode():
            _, cache, _, key = engine._prepare("beam", mel, prompt, opts)
        assert key is None  # the host loop on the CPU
        assert all(isinstance(kv_, FlatCrossKV) == flat for kv_ in cache["cross"])
