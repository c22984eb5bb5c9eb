"""large-v3-turbo's shape (128 mels, a 4-layer decoder under a deeper
encoder, the 51,866-token vocabulary with 100 languages) at test width, on
the CPU, held to the benchmark's plain reference (``perfbench/reference/``:
fp32 PyTorch, no kernels, nothing of the port), and the precision rule of
``models/whisper.py``: bf16 only at a product's inputs, fp32 between.

The port decodes as the engine does: a prompt pass, then one cached step a
token, over the cross-attention kernel's flat bf16 K/V (its plain version
here) and a bf16 self cache.
"""

import importlib
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from whisperx_tpu_torch.models import whisper as tw
from whisperx_tpu_torch.models.configs import WhisperConfig
from whisperx_tpu_torch.models.convert import whisper_from_jax

PERFBENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "perfbench")

TURBO = WhisperConfig(
    name="turbo-test", n_mels=128, n_vocab=51866, n_audio_ctx=1500, n_audio_state=128, n_audio_head=2,
    n_audio_layer=6, n_text_ctx=448, n_text_state=128, n_text_head=2, n_text_layer=4, num_languages=100,
)
HF = {
    "d_model": 128, "encoder_layers": 6, "decoder_layers": 4, "encoder_attention_heads": 2,
    "decoder_attention_heads": 2, "num_mel_bins": 128, "vocab_size": 51866,
    "max_source_positions": 1500, "max_target_positions": 448,
}
ROWS, STEPS = 8, 48
# Weights of std 0.1 at width 128 give logits of std ~1, as the benchmark's
# std 0.02 at width 1280 gives about 0.7: log-probs that move with the path.
SCALE = 0.1

# Mean over the rows of |summed log-prob of the path - the fp32
# reference's|, in nats. Over seeds 25-29 the bf16 port read 0.018-0.037
# under the precision rule (0.026-0.037 with the residual stream, GELU and
# the projections' outputs in bf16), the reference with bf16 product inputs
# alone 0.011-0.023: what rounding the inputs of the products costs. The
# fp8 reference read 0.44-0.74. 0.1 leaves bf16 rounding 2.7x of room on
# its worst seed and fails fp8 rounding by 4.4x on its best.
SCORE_TOL = 0.1


def _reference():
    """``perfbench/reference``'s whisper and tokens modules, imported as a
    package of their own (no path of the benchmark on ``sys.path``)."""
    name = "perfbench_reference"
    if name not in sys.modules:
        where = os.path.join(PERFBENCH, "reference")
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(where, "__init__.py"), submodule_search_locations=[where]
        )
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return importlib.import_module(f"{name}.whisper"), importlib.import_module(f"{name}.tokens")


@pytest.fixture(scope="module")
def setup():
    return make_setup()


def make_setup(seed: int = 25) -> dict:
    """bf16-valued weights (so that the fp32 and bf16 models and the
    reference hold the same numbers), log-mels of seeded noise bursts, a
    fixed path of allowed tokens, the fp32 model and the reference's tree."""
    rw, rt = _reference()
    params = bf16_values(tw.fuse_qkv_params(tw.random_params(TURBO, seed=seed, scale=SCALE)))
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((ROWS, 480000)) * np.repeat(rng.random((ROWS, 300)) < 0.6, 1600, axis=1) * 0.1)
    with torch.inference_mode():
        mel = rw.log_mel(torch.from_numpy(audio.astype(np.float32)), 128)
    ok = [np.flatnonzero(rt.allowed(TURBO.n_vocab, first=s == 0).numpy()) for s in range(STEPS)]
    path = torch.tensor([[rng.choice(ok[s]) for s in range(STEPS)] for _ in range(ROWS)])
    prompt = torch.tensor(rt.prompt(TURBO.n_vocab)).expand(ROWS, -1)
    f32 = whisper_from_jax(params, TURBO, device="cpu")
    tree = {k: v.float() for k, v in f32.state_dict().items()}
    return dict(rw=rw, rt=rt, params=params, mel=mel, path=path, prompt=prompt, f32=f32, tree=tree)


def bf16_values(tree):
    return {k: bf16_values(v) if isinstance(v, dict) else torch.from_numpy(v).bfloat16().float().numpy()
            for k, v in tree.items()}


def port_logits(model, mel, prompt, path) -> torch.Tensor:
    """(ROWS, STEPS, V) logits of the port: the prompt pass's last position,
    then one cached step a token of ``path``, over flat cross K/V in the
    compute dtype (the cross-attention kernel's layout)."""
    with torch.inference_mode():
        states = model.encode(mel.to(model.dtype))
        cache = model.empty_cache(ROWS)
        cache["cross"] = [tw.flat_cross_kv(k, v, kv_int8=False) if model.dtype == torch.bfloat16 else (k, v)
                          for k, v in model.compute_cross_kv(states)]
        logits, cache = model.decode_step(prompt, cache, 0)
        out = [logits[:, -1]]
        P = prompt.shape[1]
        for s in range(STEPS - 1):
            logits, cache = model.decode_step(path[:, s : s + 1], cache, torch.tensor(P + s))
            out.append(logits[:, -1])
    return torch.stack(out, dim=1)


def ref_logits(s, precision: str) -> torch.Tensor:
    ref = s["rw"].Whisper(s["tree"], HF, precision)
    with torch.inference_mode():
        cross = ref.cross_kv(ref.encode(s["mel"]))
        seq = torch.cat([s["prompt"], s["path"][:, :-1]], dim=1)
        return ref.logits(cross, seq, STEPS)


def path_scores(s, logits) -> torch.Tensor:
    """Each row's summed log-prob of the path, every step normalised over
    the tokens the request allows (``reference/tokens.py``)."""
    total = torch.zeros(ROWS, dtype=torch.float64)
    for k in range(STEPS):
        lp = s["rt"].masked_log_probs(logits[:, k].float(), TURBO.n_vocab, first=k == 0)
        total += torch.gather(lp, -1, s["path"][:, k, None])[:, 0].double()
    return total


@pytest.fixture(scope="module")
def exact(setup):
    return ref_logits(setup, "exact")


def test_fp32_cached_decode_gives_the_reference_teacher_forced_logits(setup, exact):
    got = port_logits(setup["f32"], setup["mel"], setup["prompt"], setup["path"])
    assert got.shape == exact.shape == (ROWS, STEPS, TURBO.n_vocab)
    torch.testing.assert_close(got, exact, atol=2e-4, rtol=1e-4)


def score_errs(setup, exact):
    bf16 = whisper_from_jax(setup["params"], TURBO, dtype=torch.bfloat16, device="cpu")
    want = path_scores(setup, exact)
    port = (path_scores(setup, port_logits(bf16, setup["mel"], setup["prompt"], setup["path"])) - want).abs()
    fp8 = (path_scores(setup, ref_logits(setup, "fp8")) - want).abs()
    return port, fp8


def test_bf16_path_score_is_near_fp32_and_fp8_is_not(setup, exact):
    port, fp8 = score_errs(setup, exact)
    assert port.mean() <= SCORE_TOL, f"bf16 port: {port.tolist()}"
    assert fp8.mean() > SCORE_TOL, f"fp8 reference: {fp8.tolist()}"


def test_bf16_blocks_and_dense_return_fp32(setup):
    model = whisper_from_jax(setup["params"], TURBO, dtype=torch.bfloat16, device="cpu")
    x = torch.randn((2, 7, TURBO.n_text_state))
    with torch.inference_mode():
        enc = model.encoder.layers[0]
        assert enc.attn.qkv(x.bfloat16()).dtype == torch.float32
        assert enc.mlp.fc1(x).dtype == torch.float32
        assert enc(x).dtype == torch.float32
        states = model.encode(setup["mel"][:2].bfloat16())
        assert states.dtype == torch.bfloat16  # the cross K/V projections' input
        cache = model.empty_cache(2)
        assert cache["self"][0]["k"].dtype == torch.bfloat16
        cache["cross"] = [tw.flat_cross_kv(k, v, kv_int8=False) for k, v in model.compute_cross_kv(states)]
        dec = model.decoder.layers[0]
        y, _ = dec(x[:, :1], self_cache=cache["self"][0], cache_index=torch.tensor([0]),
                   cross_kv=cache["cross"][0], self_mask=torch.zeros((1, TURBO.n_text_ctx)))
        assert y.dtype == torch.float32
        assert model.decoder._embed(torch.zeros((2, 1), dtype=torch.long)).dtype == torch.float32
