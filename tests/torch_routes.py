"""The one way to force a kernel route in the port's tests.

The port has no route option: ``ops/attention.py:resolve_attn_impl``,
``decode/engine.py:resolve_cross_impl``, ``vad/model.py:band_route`` and
``ops/self_attn_decode.py:resolve_self_attn_impl`` decide from what the
call can observe. A test that holds a path the rule would not take here
(the flash path or the cross-attention kernel's layout on the CPU, the
einsum or the plain self-attention on the card, the torch band-pass on the
CPU) patches the rule for the test's duration.
"""

from whisperx_tpu_torch.decode import engine
from whisperx_tpu_torch.models import whisper
from whisperx_tpu_torch.ops import attention
from whisperx_tpu_torch.vad import model as vad_model


def force_routes(monkeypatch, attn=None, cross=None, vad=None, self_attn=None):
    """Make every encoder self-attention take ``attn`` ("xla" | "flash"),
    every decode the cross-attention route ``cross`` ("xla" | "pallas"),
    every ``SpeechBandVAD`` the band-pass route ``vad`` ("numpy" | "torch",
    on the scorer's device) and every decoder self-attention over its cache
    the route ``self_attn`` ("plain", the kernel's oracle on the card),
    until ``monkeypatch`` undoes it. None leaves that rule as it is."""
    if attn is not None:
        monkeypatch.setattr(attention, "resolve_attn_impl", lambda device, dtype, head_dim: attn)
    if cross is not None:
        monkeypatch.setattr(engine, "resolve_cross_impl", lambda device, dtype, kv_bits, width, n_head: cross)
    if vad is not None:
        monkeypatch.setattr(vad_model, "band_route", lambda device: vad)
    if self_attn is not None:
        monkeypatch.setattr(whisper, "resolve_self_attn_impl", lambda device, dtype, cache_dtype, head_dim, tokens: self_attn)
