"""The encoders' self-attention route: which path the rule takes.

``ops/attention.py:resolve_attn_impl`` decides from what the call's tensors
show (device, dtype, head dim), so these cases need no card: a CUDA device
object is only a name until a tensor is put on it. Imports neither JAX nor
the JAX package.
"""

import dataclasses

import pytest
import torch

from torch_routes import force_routes
from whisperx_tpu_torch.ops import attention as ta
from whisperx_tpu_torch.ops import flash_attn

BF16, F32, F16 = torch.bfloat16, torch.float32, torch.float16

# (device, dtype, head dim, WHISPERX_ATTN) → route
CASES = [
    # The card takes the kernel for bf16 heads of 64.
    ("cuda", BF16, 64, None, "flash"),  # Whisper large-v2 and wav2vec2 base, whole or split over ranks
    ("cuda:1", BF16, 64, None, "flash"),  # another card
    # Everywhere else the JAX package's default.
    ("cpu", BF16, 64, None, "xla"),
    ("cpu", F32, 64, None, "xla"),
    ("cuda", F32, 64, None, "xla"),  # an fp32 model: the kernel takes bf16
    ("cuda", F16, 64, None, "xla"),
    ("cuda", BF16, 32, None, "xla"),  # heads of 32
    ("cuda", BF16, 80, None, "xla"),
    ("cuda", BF16, 128, None, "xla"),
    ("meta", BF16, 64, None, "xla"),  # no card behind the tensors
    # WHISPERX_ATTN is the JAX package's variable, which its tests set in
    # the same process: the port's rule reads none, whatever its value.
    ("cuda", BF16, 64, "xla", "flash"),
    ("cuda:1", BF16, 64, "xla", "flash"),
    ("cpu", F32, 64, "flash", "xla"),
    ("cpu", BF16, 64, "flash", "xla"),
    ("cuda", BF16, 64, "auto", "flash"),
    ("cpu", BF16, 64, "auto", "xla"),
    ("cuda", BF16, 64, "kernel", "flash"),
]


@pytest.mark.parametrize("device,dtype,head_dim,env,want", CASES)
def test_attn_route(monkeypatch, device, dtype, head_dim, env, want):
    if env is None:
        monkeypatch.delenv("WHISPERX_ATTN", raising=False)
    else:
        monkeypatch.setenv("WHISPERX_ATTN", env)
    assert ta.resolve_attn_impl(torch.device(device), dtype, head_dim) == want


@pytest.mark.parametrize("model", ["whisper", "wav2vec2"])
def test_attn_route_refuses_an_unknown_impl(model):
    """``Whisper`` and ``Wav2Vec2ForCTC`` take ``attn_impl="auto"`` alone: no
    value picks a route."""
    from whisperx_tpu_torch.models.configs import TEST_CONFIG, WAV2VEC2_TEST
    from whisperx_tpu_torch.models.wav2vec2 import Wav2Vec2ForCTC
    from whisperx_tpu_torch.models.whisper import Whisper

    cls, cfg = {"whisper": (Whisper, TEST_CONFIG), "wav2vec2": (Wav2Vec2ForCTC, WAV2VEC2_TEST)}[model]
    for impl in ("xla", "flash", "pallas"):
        with pytest.raises(ValueError, match="attn_impl"):
            cls(cfg, attn_impl=impl, device="cpu")
    assert not any(hasattr(m, "attn_impl") for m in cls(cfg, attn_impl="auto", device="cpu").modules())


@pytest.fixture
def routes(monkeypatch):
    """Counts of the calls that reach each path of ``fused_self_attention``."""
    calls = {"xla": 0, "flash": 0}
    naive, flash = ta._naive, ta.flash_attention

    def counted(path, fn):
        def wrapper(*args, **kw):
            calls[path] += 1
            return fn(*args, **kw)

        return wrapper

    monkeypatch.setattr(ta, "_naive", counted("xla", naive))
    monkeypatch.setattr(ta, "flash_attention", counted("flash", flash))
    return calls


def _whisper_encoder():
    from whisperx_tpu_torch.models import whisper as tw
    from whisperx_tpu_torch.models.configs import TEST_CONFIG
    from whisperx_tpu_torch.models.convert import whisper_from_jax

    cfg = dataclasses.replace(TEST_CONFIG, n_text_state=128, n_audio_state=128, n_text_head=2, n_audio_head=2)
    model = whisper_from_jax(tw.random_params(cfg, seed=0, scale=0.05), cfg, dtype=BF16, device="cpu")
    mel = torch.randn((1, cfg.n_mels, 3000), generator=torch.Generator().manual_seed(0)) * 0.5
    return model, lambda: model.encode(mel), cfg.n_audio_layer


def _wav2vec2():
    from whisperx_tpu_torch.models import wav2vec2 as tw2
    from whisperx_tpu_torch.models.configs import WAV2VEC2_TEST
    from whisperx_tpu_torch.models.convert import wav2vec2_from_jax

    cfg = dataclasses.replace(WAV2VEC2_TEST, hidden_size=128, intermediate_size=256)
    model = wav2vec2_from_jax(tw2.random_params(cfg, seed=0), cfg, dtype=BF16, device="cpu")
    wavs = torch.randn((2, 16_000), generator=torch.Generator().manual_seed(1)) * 0.1
    return model, lambda: model(wavs, sample_lengths=torch.tensor([16_000, 9_000])), cfg.num_layers


@pytest.mark.parametrize("build", [_whisper_encoder, _wav2vec2], ids=["whisper_encoder", "wav2vec2"])
def test_cpu_bf16_encoders_keep_the_naive_path_under_auto(monkeypatch, routes, build):
    """A bf16 encoder with heads of 64 on the CPU runs ``_naive`` once a
    layer and never the flash path: the rule takes the kernel only on a
    CUDA device. Forced to "flash" (the tests' seam), the same model takes
    the flash path, and launches nothing on the CPU."""
    model, forward, n_layers = build()
    before = flash_attn.launches
    with torch.inference_mode():
        forward()
        assert routes == {"xla": n_layers, "flash": 0}
        force_routes(monkeypatch, attn="flash")
        forward()
    assert routes == {"xla": n_layers, "flash": n_layers} and flash_attn.launches == before
