"""Model-family configuration presets.

Whisper architecture hyperparameters for every released size (public model
card facts; the reference reaches them through faster-whisper model names,
whisperx/asr.py:275-288). A copy of ``whisperx_tpu/models/configs.py``: the
port keeps its own so it never imports the JAX package (tests hold the two
equal).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    name: str = "tiny"
    n_mels: int = 80
    n_vocab: int = 51865
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4
    num_languages: int = 99  # 100 for large-v3 (adds "yue")

    @property
    def is_multilingual(self) -> bool:
        return self.n_vocab >= 51865

    @property
    def head_dim(self) -> int:
        return self.n_audio_state // self.n_audio_head


def _cfg(name, state, head, layer, **kw) -> WhisperConfig:
    return WhisperConfig(
        name=name,
        n_audio_state=state,
        n_audio_head=head,
        n_audio_layer=layer,
        n_text_state=state,
        n_text_head=head,
        n_text_layer=layer,
        **kw,
    )


WHISPER_CONFIGS = {
    "tiny.en": _cfg("tiny.en", 384, 6, 4, n_vocab=51864),
    "tiny": _cfg("tiny", 384, 6, 4),
    "base.en": _cfg("base.en", 512, 8, 6, n_vocab=51864),
    "base": _cfg("base", 512, 8, 6),
    "small.en": _cfg("small.en", 768, 12, 12, n_vocab=51864),
    "small": _cfg("small", 768, 12, 12),
    "medium.en": _cfg("medium.en", 1024, 16, 24, n_vocab=51864),
    "medium": _cfg("medium", 1024, 16, 24),
    "large-v1": _cfg("large-v1", 1280, 20, 32),
    "large-v2": _cfg("large-v2", 1280, 20, 32),
    "large-v3": _cfg("large-v3", 1280, 20, 32, n_vocab=51866, n_mels=128, num_languages=100),
    "large": _cfg("large-v3", 1280, 20, 32, n_vocab=51866, n_mels=128, num_languages=100),
    "large-v3-turbo": _cfg("large-v3-turbo", 1280, 20, 32, n_vocab=51866, n_mels=128, num_languages=100),
}
# turbo has a 4-layer decoder
WHISPER_CONFIGS["large-v3-turbo"] = dataclasses.replace(
    WHISPER_CONFIGS["large-v3-turbo"], n_text_layer=4
)
WHISPER_CONFIGS["turbo"] = WHISPER_CONFIGS["large-v3-turbo"]

# distil-whisper: full encoder, 2-layer decoder (4 for distil-small.en) —
# the reference reaches these through faster-whisper model names too.
WHISPER_CONFIGS["distil-large-v2"] = dataclasses.replace(
    WHISPER_CONFIGS["large-v2"], name="distil-large-v2", n_text_layer=2
)
WHISPER_CONFIGS["distil-large-v3"] = dataclasses.replace(
    WHISPER_CONFIGS["large-v3"], name="distil-large-v3", n_text_layer=2
)
WHISPER_CONFIGS["distil-medium.en"] = dataclasses.replace(
    WHISPER_CONFIGS["medium.en"], name="distil-medium.en", n_text_layer=2
)
WHISPER_CONFIGS["distil-small.en"] = dataclasses.replace(
    WHISPER_CONFIGS["small.en"], name="distil-small.en", n_text_layer=4
)

# A miniature config for unit tests: full architecture, trivial sizes.
TEST_CONFIG = WhisperConfig(
    name="test",
    n_mels=80,
    n_vocab=51865,
    n_audio_ctx=1500,
    n_audio_state=64,
    n_audio_head=2,
    n_audio_layer=2,
    n_text_ctx=448,
    n_text_state=64,
    n_text_head=2,
    n_text_layer=2,
)


def get_whisper_config(name: str) -> WhisperConfig:
    if name not in WHISPER_CONFIGS:
        raise ValueError(f"unknown whisper model: {name!r}; options: {sorted(WHISPER_CONFIGS)}")
    return WHISPER_CONFIGS[name]


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    """wav2vec2 CTC architecture (base/large presets + test-size)."""

    name: str = "base"
    vocab_size: int = 32
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    # Feature-extractor conv stack: (dim, kernel, stride) per layer.
    conv_layers: tuple = (
        (512, 10, 5),
        (512, 3, 2),
        (512, 3, 2),
        (512, 3, 2),
        (512, 3, 2),
        (512, 2, 2),
        (512, 2, 2),
    )
    conv_bias: bool = False
    do_stable_layer_norm: bool = False  # True for large/xlsr-style models
    feat_extract_norm: str = "group"  # "group" (base) or "layer" (large)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5

    @property
    def total_stride(self) -> int:
        s = 1
        for _, _, stride in self.conv_layers:
            s *= stride
        return s  # 320: one emission frame per 20 ms

    @property
    def receptive_field(self) -> int:
        rf, s = 1, 1
        for _, kernel, stride in self.conv_layers:
            rf += (kernel - 1) * s
            s *= stride
        return rf  # 400 samples


WAV2VEC2_BASE = Wav2Vec2Config(name="base")
WAV2VEC2_LARGE = Wav2Vec2Config(
    name="large",
    hidden_size=1024,
    num_layers=24,
    num_heads=16,
    intermediate_size=4096,
    conv_bias=True,
    do_stable_layer_norm=True,
    feat_extract_norm="layer",
)
WAV2VEC2_TEST = Wav2Vec2Config(
    name="test",
    vocab_size=32,
    hidden_size=64,
    num_layers=2,
    num_heads=2,
    intermediate_size=128,
)
