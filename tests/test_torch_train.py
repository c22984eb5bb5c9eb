"""whisperx_tpu_torch's training step against the JAX package's
(``whisperx_tpu/train.py``): the same parameter tree, mel, tokens and mask
through both, on a 128-wide Whisper with heads of 64 (the flash kernel's
head size; ``TEST_CONFIG``'s heads of 32 do not fit it)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_routes import force_routes
from whisperx_tpu import train as jtrain
from whisperx_tpu.models.configs import TEST_CONFIG
from whisperx_tpu.models.whisper import Whisper as JWhisper
from whisperx_tpu_torch import train as ttrain
from whisperx_tpu_torch.models import whisper as tw
from whisperx_tpu_torch.models.convert import jax_path, whisper_from_jax, whisper_to_jax
from whisperx_tpu_torch.ops import flash_attn

torch.set_num_threads(2)

SMALL = dataclasses.replace(TEST_CONFIG, n_text_state=128, n_audio_state=128, n_text_head=2, n_audio_head=2)
LR = 1e-3
STEPS = 3


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    params = tw.random_params(SMALL, seed=0, scale=0.05)
    mel = (rng.standard_normal((2, SMALL.n_mels, 3000)) * 0.5).astype(np.float32)
    tokens = rng.integers(0, 1000, (2, 10)).astype(np.int32)
    mask = np.ones((2, 10), np.float32)
    mask[1, 7:] = 0.0  # a partial mask: the second row's last targets do not count
    return params, mel, tokens, mask


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_run(params, mel, tokens, mask, dtype):
    """JAX's jitted train step, STEPS times: (losses, params after)."""
    model = JWhisper(SMALL, dtype=dtype)
    opt = jtrain.make_optimizer(lr=LR)
    step = jax.jit(jtrain.make_train_step(model, opt))
    state, p, losses = opt.init(params), params, []
    for _ in range(STEPS):
        p, state, loss = step(p, state, mel, tokens, mask)
        losses.append(float(loss))
    return losses, _flat(p)


def _port_model(params, dtype):
    return whisper_from_jax(params, SMALL, dtype=dtype, device="cpu").trainable()


def _port_run(params, mel, tokens, mask, dtype):
    """The port's train step, STEPS times: (losses, params after, the first
    step's gradients as a flat JAX-layout dict)."""
    model = _port_model(params, dtype)
    step = ttrain.make_train_step(model, ttrain.make_optimizer(model.parameters(), lr=LR))
    losses, grads = [], None
    for i in range(STEPS):
        losses.append(float(step(*(torch.from_numpy(x) for x in (mel, tokens, mask)))))
        if i == 0:
            grads = _flat(_grad_tree(model))
    return losses, _flat(whisper_to_jax(model)), grads


def _grad_tree(model) -> dict:
    tree: dict = {}
    for name, p in model.named_parameters():
        arr = p.grad.float().numpy()
        path = jax_path(name)
        if path[-1] == "kernel" and arr.ndim == 3:
            arr = arr.transpose(2, 1, 0)
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = arr
    return tree


def _jax_grads(params, mel, tokens, mask, dtype) -> dict:
    """Gradients of JAX's training loss (the composition of
    ``whisperx_tpu/train.py:loss_fn``) at ``params``."""
    model = JWhisper(SMALL, dtype=dtype)

    def loss_fn(p):
        logits = model.apply({"params": p}, mel, tokens[:, :-1])
        return jtrain.cross_entropy_loss(logits, tokens[:, 1:], mask[:, 1:])

    return _flat(jax.jit(jax.grad(loss_fn))(params))


def _rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def test_fp32_train_step_matches_jax(batch):
    """fp32, "xla" attention: three AdamW steps (lr 1e-3) give JAX's losses
    and JAX's parameters, leaf by leaf. This also holds torch's AdamW to
    optax.adamw. Tolerance: losses 1e-5 relative; leaves 1e-4 absolute.
    Each step moves a weight by up to lr; the two frameworks sum in other
    orders, and Adam's m̂/√v̂ magnifies that where a gradient is near 0
    (measured worst: 3.6e-5, the encoder's positional embedding)."""
    params, mel, tokens, mask = batch
    want_losses, want = _jax_run(params, mel, tokens, mask, jnp.float32)
    losses, got, _ = _port_run(params, mel, tokens, mask, torch.float32)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], want[key], atol=1e-4, rtol=0, err_msg=key)
    moved = max(np.abs(want[k] - v).max() for k, v in _flat(params).items())
    assert moved > 10 * 1e-4  # the steps moved the weights well beyond the tolerance


def _assert_bf16_grads_close(got: dict, want: dict, what: str) -> None:
    """Gradients of two bf16 runs: each leaf within 10% relative L2 (bf16
    keeps 8 bits, and roundings compound through the layers: the worst leaf
    measured 3.2%), the whole tree within 2%."""
    assert got.keys() == want.keys()
    for key in want:
        assert _rel_l2(got[key], want[key]) < 0.1, f"{what}: {key}"
    num = sum(np.sum((got[k] - want[k]).astype(np.float64) ** 2) for k in want)
    den = sum(np.sum(want[k].astype(np.float64) ** 2) for k in want)
    assert np.sqrt(num / den) < 0.02, what


def _assert_bf16_params_close(got: dict, want: dict, start: dict, what: str) -> None:
    """Parameters after STEPS bf16 AdamW steps: Adam's first step moves each
    weight by lr·sign(g), so a weight whose tiny gradient changes sign
    between two bf16 runs lands 2·lr away. Hold the share of such weights
    (beyond lr/10 apart) under 1% (measured: 0.2%), and every weight within
    2·STEPS·lr."""
    n = bad = 0
    for key in want:
        diff = np.abs(got[key] - want[key])
        assert diff.max() <= 2 * STEPS * LR * 1.01, f"{what}: {key}"
        n, bad = n + diff.size, bad + int(np.sum(diff > LR / 10))
    assert bad / n < 0.01, f"{what}: {bad} of {n} weights apart"
    assert max(np.abs(want[k] - v).max() for k, v in start.items()) > LR  # the weights moved


def test_bf16_xla_train_step_matches_jax(batch):
    """bf16 compute over fp32 masters, "xla" attention (the JAX default):
    losses within 2e-4 relative over three steps (measured 4.4e-5), the first
    step's gradients and the parameters after as the helpers above state."""
    params, mel, tokens, mask = batch
    want_losses, want = _jax_run(params, mel, tokens, mask, jnp.bfloat16)
    losses, got, grads = _port_run(params, mel, tokens, mask, torch.bfloat16)
    np.testing.assert_allclose(losses, want_losses, rtol=2e-4)
    _assert_bf16_grads_close(grads, _jax_grads(params, mel, tokens, mask, jnp.bfloat16), "bf16 xla vs JAX")
    _assert_bf16_params_close(got, want, _flat(params), "bf16 xla vs JAX")


def test_bf16_flash_train_step_matches_xla_step(monkeypatch, batch):
    """The port's bf16 "flash" step (gradients through ``FlashAttention``,
    the backward kernels' plain versions here) against its bf16 "xla" step:
    losses within 5e-4 relative (measured 1.6e-4 at the third step),
    gradients and parameters as the helpers state; the encoder's attention
    projections (what the flash backward feeds) within 2% relative L2
    (measured 0.5%). The whole bf16 flash step is not held against JAX's
    interpreted one (minutes on the CPU): the stock kernels' gradients are
    held to the port's in ``test_torch_attention.py``. The CPU's rule gives
    "xla"; the tests' seam forces "flash"."""
    params, mel, tokens, mask = batch
    xla_losses, xla, xla_grads = _port_run(params, mel, tokens, mask, torch.bfloat16)
    before = (flash_attn.launches, flash_attn.launches_bwd_dq, flash_attn.launches_bwd_dkv)
    force_routes(monkeypatch, attn="flash")
    losses, got, grads = _port_run(params, mel, tokens, mask, torch.bfloat16)
    assert (flash_attn.launches, flash_attn.launches_bwd_dq, flash_attn.launches_bwd_dkv) == before  # CPU: plain
    np.testing.assert_allclose(losses, xla_losses, rtol=5e-4)
    _assert_bf16_grads_close(grads, xla_grads, "bf16 flash vs xla")
    for i in range(SMALL.n_audio_layer):
        for proj in ("query", "key", "value"):
            key = f"['encoder']['layers_{i}']['attn']['{proj}']['kernel']"
            assert _rel_l2(grads[key], xla_grads[key]) < 0.02, key
    _assert_bf16_params_close(got, xla, _flat(params), "bf16 flash vs xla")


def test_train_step_reduces_loss():
    """Mirror of ``tests/test_checkpoint_train.py::test_train_step_reduces_loss``
    on the port (fp32, lr 1e-3, five steps on one batch)."""
    params = tw.random_params(SMALL, seed=0)
    model = _port_model(params, torch.float32)
    step = ttrain.make_train_step(model, ttrain.make_optimizer(model.parameters(), lr=1e-3))
    rng = np.random.default_rng(0)
    mel = torch.from_numpy(rng.standard_normal((2, 80, 3000)).astype(np.float32) * 0.3)
    tokens = torch.from_numpy(rng.integers(0, 1000, (2, 10)).astype(np.int32))
    mask = torch.ones((2, 10))
    losses = [float(step(mel, tokens, mask)) for _ in range(5)]
    assert losses[-1] < losses[0], f"loss did not decrease: {losses}"
    assert np.isfinite(losses).all()


def test_train_step_timings_split_the_step(batch):
    params, mel, tokens, mask = batch
    model = _port_model(params, torch.float32)
    timings: dict = {}
    step = ttrain.make_train_step(model, ttrain.make_optimizer(model.parameters()), timings=timings)
    loss = step(*(torch.from_numpy(x) for x in (mel, tokens, mask)))
    assert loss.shape == () and loss.dtype == torch.float32 and loss.grad_fn is None
    assert sorted(timings) == ["backward", "forward", "optimizer"]
    assert all(len(v) == 1 and v[0] >= 0 for v in timings.values())


@pytest.mark.parametrize("all_masked", [False, True])
def test_cross_entropy_matches_jax(all_masked):
    """Random logits with a partial mask (and a mask of zeros: the
    denominator's floor of 1 gives 0)."""
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((3, 7, 50)) * 3).astype(np.float32)
    targets = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.4).astype(np.float32) * (not all_masked)
    want = float(jtrain.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask)))
    got = ttrain.cross_entropy_loss(*(torch.from_numpy(x) for x in (logits, targets, mask)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-7)
    # bf16 logits are widened before the log-softmax, as in JAX.
    got16 = ttrain.cross_entropy_loss(torch.from_numpy(logits).bfloat16(), torch.from_numpy(targets), torch.from_numpy(mask))
    want16 = float(jtrain.cross_entropy_loss(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(targets), jnp.asarray(mask)))
    np.testing.assert_allclose(float(got16), want16, rtol=1e-6, atol=1e-7)


def test_optimizer_is_optax_adamw():
    opt = ttrain.make_optimizer([torch.nn.Parameter(torch.zeros(3))])
    group = opt.param_groups[0]
    assert isinstance(opt, torch.optim.AdamW)
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (1e-5, (0.9, 0.999), 1e-8, 0.01)


def test_trainable_turns_on_gradients_and_refuses_quantized(batch):
    params = batch[0]
    model = whisper_from_jax(params, SMALL, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    assert model.trainable() is model and all(p.requires_grad for p in model.parameters())
    assert not any(p.requires_grad for p in model.trainable(False).parameters())
    quantized = whisper_from_jax(tw.quantize_params(params), SMALL, device="cpu")
    with pytest.raises(ValueError, match="quantized"):
        quantized.trainable()


def test_fp32_gradients_match_jax(batch):
    """The first step's fp32 gradients against ``jax.grad`` of JAX's
    training loss, leaf by leaf (Adam's update hides a gradient's scale, so
    the parameters alone would not show a wrong one). The teacher-forced
    ``Whisper.forward`` writes the decoder's K/V into a zeroed cache in
    place where JAX builds a new buffer; equal decoder gradients show that
    the in-place writes route them right. Tolerance: 1e-4 of each leaf's
    largest gradient, 1e-3 relative (fp32 sums in other orders)."""
    params, mel, tokens, mask = batch
    want = _jax_grads(params, mel, tokens, mask, jnp.float32)
    model = _port_model(params, torch.float32)
    step = ttrain.make_train_step(model, ttrain.make_optimizer(model.parameters(), lr=LR))
    step(*(torch.from_numpy(x) for x in (mel, tokens, mask)))
    got = _flat(_grad_tree(model))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-4 * np.abs(want[key]).max(), rtol=1e-3, err_msg=key)
