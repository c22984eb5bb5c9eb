"""The (data, model) mesh over ``torch.distributed`` ranks.

Port of ``whisperx_tpu/parallel/mesh.py``. The JAX package drives a mesh of
chips from one process and lets pjit insert the collectives; here every rank
is a process that drives one device, holds its own slice of the weights and
calls the collectives itself:

- "data": the ranks of one model group hold the same weights; VAD-cut chunk
  batches, alignment batches and diarization windows split their rows over
  this axis (:func:`shard_batch`, :func:`pad_rows_to_mesh`), and every rank
  gathers the rows back in rank order (:func:`gather_rows`), so that it
  returns the global result a pjit program returns;
- "model": Megatron tensor parallelism inside the modules (attention heads
  and MLP hidden units split, partial products all-reduced), per the rules
  of ``parallel/partition.py``.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose ``device``
attribute records this rank's ``torch.device``.
"""

from __future__ import annotations

import math
import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import DeviceLike
from .distributed import local_device

AXES = ("data", "model")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, *, device: DeviceLike = None) -> DeviceMesh:
    """Build a (data, model) mesh over the ranks of the process group.

    With defaults, every rank goes to the data axis (pure data parallelism,
    the right layout for models that fit on one card). Set ``n_model`` to
    split the weights over that many ranks. ``device`` is this rank's
    device (``None``: its card, :func:`~.distributed.local_device`). Every
    rank calls this, in the same order as its other collectives. Without a
    process group, this process becomes a world of one (NCCL on a card,
    gloo on the CPU), which is a legal mesh of shape (1, 1).
    """
    dev = local_device() if device is None else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.init()
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://127.0.0.1:{_free_port()}",
            world_size=1,
            rank=0,
        )
    total = dist.get_world_size()
    if n_data is None:
        if total % n_model:
            raise ValueError(f"{total} ranks not divisible by model={n_model}")
        n_data = total // n_model
    if n_data * n_model != total:
        raise ValueError(f"mesh {n_data}x{n_model} != {total} ranks")
    mesh = init_device_mesh(dev.type, (n_data, n_model), mesh_dim_names=AXES)
    mesh.device = dev
    return mesh


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``."""
    dev = getattr(mesh, "device", None)
    return dev if dev is not None else (local_device() if mesh.device_type == "cuda" else torch.device("cpu"))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate on ``axis``."""
    return int(mesh.get_local_rank(axis))


def model_group(mesh: Optional[DeviceMesh]):
    """The process group of this rank's "model" axis, or None where the
    axis has one rank (nothing to reduce)."""
    if mesh is None or axis_size(mesh, "model") == 1:
        return None
    return mesh.get_group("model")


def data_sharding(mesh: DeviceMesh):
    """Placements of a batch-leading array: dim 0 split over "data",
    replicated over "model"."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0), Replicate())


def replicated(mesh: DeviceMesh):
    """Placements of an array every rank holds whole."""
    from torch.distributed.tensor import Replicate

    return (Replicate(), Replicate())


def shard_batch(mesh: DeviceMesh, batch) -> torch.Tensor:
    """This rank's rows of a host batch (B, ...) on its device: the
    ``B / n_data`` rows at its "data" coordinate. B must divide."""
    n = axis_size(mesh, "data")
    B = batch.shape[0]
    if B % n:
        raise ValueError(f"batch of {B} rows does not tile the data axis of {n}")
    b = B // n
    i = axis_index(mesh, "data")
    rows = batch[i * b : (i + 1) * b]
    t = torch.from_numpy(np.ascontiguousarray(rows)) if isinstance(rows, np.ndarray) else rows.contiguous()
    dev = mesh_device(mesh)
    if dev.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def pad_rows_to_mesh(mesh: DeviceMesh, rows, granule: int = 8) -> torch.Tensor:
    """Pad (B, ...) host rows to a data-axis-divisible granule and shard.

    Used by the align/diarize stages to run their window/segment batches
    data-parallel: the row count rounds up to lcm(granule, n_data) (zero
    rows), then dim 0 splits over "data" (:func:`shard_batch`)."""
    n = axis_size(mesh, "data")
    g = granule * n // math.gcd(granule, n)
    B = rows.shape[0]
    Bp = max(g, -(-B // g) * g)
    if Bp != B:
        rows = np.concatenate([rows, np.zeros((Bp - B,) + rows.shape[1:], rows.dtype)], axis=0)
    return shard_batch(mesh, rows)


def gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order of
    ``group`` (``t`` itself where the group is None). All ranks pass
    tensors of one shape; one ``all_gather`` (NCCL, and gloo on CPU and
    CUDA tensors, accept it)."""
    if group is None or dist.get_world_size(group) == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def gather_rows(mesh: Optional[DeviceMesh], t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Per-rank row results → the global rows, on every rank: ``t``
    gathered over "data" along ``dim`` in rank order (the inverse of
    :func:`shard_batch`)."""
    if mesh is None or axis_size(mesh, "data") == 1:
        return t
    return gather_cat(t, dim, mesh.get_group("data"))
