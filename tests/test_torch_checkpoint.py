"""whisperx_tpu_torch's checkpoints (``utils/checkpoint.py``) against the JAX
package's (``whisperx_tpu/utils/checkpoint.py``): a file saved by either
loads in the other with equal leaves, and the port's parameter tree
(``whisper_to_jax``) is the JAX package's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperx_tpu.models.configs import TEST_CONFIG
from whisperx_tpu.models.whisper import Whisper as JWhisper
from whisperx_tpu.models.whisper import init_whisper_params
from whisperx_tpu.models.whisper import quantize_params as j_quantize
from whisperx_tpu.utils import checkpoint as jckpt
from whisperx_tpu_torch.models import whisper as tw
from whisperx_tpu_torch.models.convert import read_safetensors, whisper_from_jax, whisper_to_jax, write_safetensors
from whisperx_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)

SMALL = dataclasses.replace(TEST_CONFIG, n_text_state=128, n_audio_state=128, n_text_head=2, n_audio_head=2)


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_equal(got, want) -> None:
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _trees():
    """A float tree, its bf16 cast (JAX's), and an int8 + kernel_scale tree."""
    _, params = init_whisper_params(TEST_CONFIG, seed=0)
    params = jax.tree_util.tree_map(np.asarray, params)
    bf16 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), params)
    return {"fp32": params, "bf16": bf16, "int8": jax.tree_util.tree_map(np.asarray, j_quantize(params))}


@pytest.fixture(scope="module")
def trees():
    return _trees()


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
def test_jax_save_port_load(tmp_path, trees, kind):
    """JAX saves, the port loads: equal leaves, bf16 widened to fp32 (as
    JAX's own load gives it back), int8 kept."""
    path = str(tmp_path / "j.safetensors")
    jckpt.save_params(trees[kind], path)
    got = tckpt.load_params(path)
    _assert_trees_equal(got, jax.tree_util.tree_map(np.asarray, jckpt.load_params(path)))
    if kind == "bf16":
        _assert_trees_equal(got, jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), trees[kind]))


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
def test_port_save_jax_load(tmp_path, trees, kind):
    """The port saves (its own writer, no safetensors package), JAX loads
    (through the safetensors package): equal leaves; and the two packages'
    files hold the same tensors."""
    path, jpath = str(tmp_path / "t.safetensors"), str(tmp_path / "j.safetensors")
    tckpt.save_params(trees[kind], path)
    jckpt.save_params(trees[kind], jpath)
    got = jax.tree_util.tree_map(np.asarray, jckpt.load_params(path))
    want = jax.tree_util.tree_map(np.asarray, jckpt.load_params(jpath))
    _assert_trees_equal(got, want)
    _assert_trees_equal(tckpt.load_params(path), tckpt.load_params(jpath))
    if kind == "int8":
        leaf = got["decoder"]["layers_0"]["attn"]["query"]
        assert leaf["kernel"].dtype == np.int8 and leaf["kernel_scale"].dtype == np.float32


def test_port_saves_torch_leaves(tmp_path):
    """Leaves may be torch tensors: bf16 widens exactly, int8 stays."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32)).bfloat16()
    i8 = torch.from_numpy(rng.integers(-127, 128, (5,)).astype(np.int8))
    path = str(tmp_path / "x.safetensors")
    tckpt.save_params({"a": {"w": x}, "b": i8}, path)
    got = tckpt.load_params(path)
    np.testing.assert_array_equal(got["a"]["w"], x.float().numpy())
    assert got["b"].dtype == np.int8 and np.array_equal(got["b"], i8.numpy())
    assert tckpt.load_params(path, dtype=np.float16)["a"]["w"].dtype == np.float16


def test_forward_after_roundtrip(tmp_path):
    """A port model saved through ``whisper_to_jax`` + ``save_params`` and
    rebuilt from ``load_params`` gives the same logits, bit for bit; and
    JAX, loading the same file, gives the port's logits (fp32, 1e-4)."""
    params = tw.random_params(SMALL, seed=0, scale=0.05)
    model = whisper_from_jax(params, SMALL, device="cpu")
    rng = np.random.default_rng(0)
    mel = (rng.standard_normal((1, 80, 3000)) * 0.5).astype(np.float32)
    tokens = rng.integers(0, 1000, (1, 5)).astype(np.int32)
    path = str(tmp_path / "w.safetensors")
    tckpt.save_params(whisper_to_jax(model), path)
    again = whisper_from_jax(tckpt.load_params(path), SMALL, device="cpu")
    with torch.no_grad():
        want = model(torch.from_numpy(mel), torch.from_numpy(tokens).long())
        got = again(torch.from_numpy(mel), torch.from_numpy(tokens).long())
    assert torch.equal(got, want)
    jlogits = JWhisper(SMALL).apply({"params": jckpt.load_params(path)}, jnp.asarray(mel), jnp.asarray(tokens))
    np.testing.assert_allclose(np.asarray(jlogits), want.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("quantized,fused", [(False, False), (True, False), (True, True), ("decoder", False)])
def test_tree_roundtrip(quantized, fused):
    """``whisper_to_jax(whisper_from_jax(tree))`` is ``tree``: every leaf,
    conv kernels in Flax's (W, I, O), int8 kernels with their scales."""
    tree = tw.random_params(SMALL, seed=1, scale=0.05)
    if quantized:
        tree = tw.quantize_params(tree, scope="all" if quantized is True else quantized)
    if fused:
        tree = tw.fuse_qkv_params(tree)
    _assert_trees_equal(whisper_to_jax(whisper_from_jax(tree, SMALL, device="cpu")), tree)


def test_write_safetensors_streams_and_checks(tmp_path):
    """The hand-written writer: tensors made one at a time in order, read
    back by ``read_safetensors``; a shape that disagrees with the header
    raises."""
    made = []

    def make(i, shape, dtype):
        def f():
            made.append(i)
            return np.arange(np.prod(shape)).reshape(shape).astype(dtype)

        return f

    specs = [("a", (2, 3), np.float16), ("b/c", (4,), np.int8), ("d", (), np.float32)]
    path = str(tmp_path / "s.safetensors")
    write_safetensors(path, [(n, s, d, make(i, s, d)) for i, (n, s, d) in enumerate(specs)])
    assert made == [0, 1, 2]
    got = read_safetensors(path)
    for name, shape, dtype in specs:
        assert got[name].dtype == dtype and got[name].shape == shape
        np.testing.assert_array_equal(got[name], np.arange(np.prod(shape)).reshape(shape).astype(dtype))
    with pytest.raises(ValueError, match="header says"):
        write_safetensors(path, [("a", (2, 2), np.float32, lambda: np.zeros((3,), np.float32))])
