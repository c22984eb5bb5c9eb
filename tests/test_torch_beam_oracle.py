"""The port's beam search against an independent oracle: HF torch
``WhisperForConditionalGeneration.generate(num_beams=5)`` on the same tiny
random weights, converted by the port's own ``models/convert.py``.

The five regimes of the JAX package's oracle (``tests/test_beam_oracle.py``),
as one parametrised test: EOS never fires; EOS-biased weights, so that every
sequence finishes mid-horizon (the finished merge and the early exit); the
same at length penalty 1.0; suppressed tokens; a multi-token decoder prompt
(``prefix``). The port's beam runs through ``decode/search.py:BeamLoop``,
the static-state body that the device loop captures, driven here by the host
loop. The known divergences from HF (the GNMT length penalty, EOS admission
from all 2K candidates, the CT2 early exit) are the JAX package's, and are
described in its test.
"""

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

torch.set_num_threads(2)

MAX_NEW = 12
K = 5


def _build(vocab: int, seed: int, eos_bias: float = 0.0):
    """A tiny random HF Whisper and the port's engine on its weights."""
    from transformers import WhisperConfig as HFWhisperConfig
    from transformers import WhisperForConditionalGeneration

    from whisperx_tpu_torch.decode.engine import WhisperEngine
    from whisperx_tpu_torch.decode.tokenizer import WhisperTokenizer
    from whisperx_tpu_torch.models.configs import WhisperConfig
    from whisperx_tpu_torch.models.convert import convert_whisper, whisper_from_jax

    hf_cfg = HFWhisperConfig(
        vocab_size=vocab, num_mel_bins=80, d_model=64,
        encoder_layers=2, encoder_attention_heads=2,
        decoder_layers=2, decoder_attention_heads=2,
        decoder_ffn_dim=256, encoder_ffn_dim=256,
        max_source_positions=32, max_target_positions=48,
        pad_token_id=0, bos_token_id=0, eos_token_id=1, decoder_start_token_id=2,
    )
    torch.manual_seed(seed)
    hf_model = WhisperForConditionalGeneration(hf_cfg).eval()
    if eos_bias:
        # Point the tied EOS row at the typical decoder state, so that beams
        # finish mid-horizon.
        with torch.no_grad():
            h = hf_model.model(
                input_features=torch.randn(2, 80, 64),
                decoder_input_ids=torch.randint(0, vocab, (2, 8)),
            ).last_hidden_state.mean(dim=(0, 1))
            hf_model.model.decoder.embed_tokens.weight[1] = eos_bias * h / h.norm()

    cfg = WhisperConfig(
        name="test", n_mels=80, n_vocab=vocab, n_audio_ctx=32, n_audio_state=64,
        n_audio_head=2, n_audio_layer=2, n_text_ctx=48, n_text_state=64,
        n_text_head=2, n_text_layer=2,
    )
    sd = {k: v.numpy() for k, v in hf_model.state_dict().items()}
    model = whisper_from_jax(convert_whisper(sd, cfg), cfg, device="cpu")
    return hf_model, WhisperEngine(model, WhisperTokenizer.dummy(vocab, language="en"))


def _beam_tokens(engine, mel: np.ndarray, prompt: np.ndarray, opts) -> np.ndarray:
    """``engine.decode_beam``'s stages without the no-speech probability
    (the dummy tokenizer's <|nospeech|> lies outside a 100-token
    vocabulary): encoder, cross K/V, prompt, then ``search.beam_decode``."""
    from whisperx_tpu_torch.decode.search import beam_decode

    model = engine.model
    with torch.inference_mode():
        cache = model.empty_cache(len(prompt), cache_len=engine._cache_len(prompt.shape[1], opts))
        cache["cross"] = model.compute_cross_kv(model.encode(torch.from_numpy(mel)))
        logits, cache = model.decode_step(torch.from_numpy(prompt), cache, 0)
        expanded = [{n: b.repeat_interleave(K, dim=0) for n, b in layer.items()} for layer in cache["self"]]
        return beam_decode(engine._step_fn(cache["cross"]), logits[:, -1], expanded, prompt.shape[1], opts)[0].numpy()


def _content(seq: list) -> list:
    """Tokens up to (not including) the first EOS: HF pads with pad_token_id,
    the port with EOT."""
    return seq[: seq.index(1)] if 1 in seq else seq


# name: (vocab, weights seed, eos_bias, length_penalty, batch, trials, input
# seed, suppressed ids, prefix length)
CASES = {
    "unfinished": (100, 0, 0.0, 0.0, 4, 6, 0, (), 0),
    "finish": (32, 0, 0.45, 0.0, 4, 5, 1, (), 0),
    "length penalty one": (32, 2, 0.45, 1.0, 4, 5, 2, (), 0),
    "suppression": (100, 1, 0.0, 0.0, 3, 4, 5, (7, 11, 49, 50, 51, 52, 53), 0),
    "prefix": (100, 3, 0.0, 0.0, 3, 4, 11, (), 3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_beam_matches_hf_generate(case):
    from whisperx_tpu_torch.decode.search import SearchOptions

    vocab, wseed, eos_bias, alpha, batch, trials, seed, banned, n_prefix = CASES[case]
    hf_model, engine = _build(vocab, wseed, eos_bias)
    opts = SearchOptions(
        beam_size=K, patience=1.0, length_penalty=alpha, max_new_tokens=MAX_NEW,
        temperature=0.0, suppress_tokens=banned, suppress_blank=False,
        blank_tokens=(), eot=1, banned_tokens=(),
    )
    rng = np.random.default_rng(seed)
    agree = finished = total = 0
    for _ in range(trials):
        mel = rng.standard_normal((batch, 80, 64)).astype(np.float32) * 2.0
        # The decoder start token, then a forced continuation for "prefix".
        start = [2] + (rng.integers(3, 100, n_prefix).tolist() if n_prefix else [])
        prompt = np.tile(np.asarray([start], np.int64), (batch, 1))
        with torch.no_grad():
            hf_seqs = hf_model.generate(
                input_features=torch.from_numpy(mel),
                decoder_input_ids=torch.from_numpy(prompt),
                num_beams=K, max_length=len(start) + MAX_NEW,
                length_penalty=alpha, early_stopping=False, do_sample=False,
                begin_suppress_tokens=None, suppress_tokens=list(banned) or None,
            ).numpy()
        tokens = _beam_tokens(engine, mel, prompt, opts)
        for b in range(batch):
            hf_gen = hf_seqs[b].tolist()
            if hf_gen[: len(start)] == start and len(start) > 1:
                hf_gen = hf_gen[len(start) :]  # HF echoes a multi-token decoder prompt
            ours = _content(tokens[b].tolist())
            assert not set(ours) & set(banned)
            total += 1
            finished += len(ours) < MAX_NEW
            agree += _content(hf_gen) == ours
    assert total == batch * trials
    if eos_bias:
        assert finished >= total // 2, "EOS bias failed to produce finished beams"
    assert agree == total, f"{case}: beam mismatch vs HF generate: {agree}/{total}"
