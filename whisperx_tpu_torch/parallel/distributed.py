"""Process bootstrap and file-level data parallelism over ``torch.distributed``.

Port of ``whisperx_tpu/parallel/distributed.py``. The JAX package runs one
process per host over many chips; the port runs one process per card (rank),
as ``torchrun`` starts them. :func:`initialize` joins the ranks into one
process group; every other function here reads the rank and the world size
from it (rank 0 of a world of one before it, or without it).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
):
    """Join this process to the world of ranks (a no-op for one process).

    The arguments default from the JAX package's environment names
    (``COORDINATOR_ADDRESS`` as ``host:port``, ``NUM_PROCESSES``,
    ``PROCESS_ID``), then from torchrun's (``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``). ``backend`` defaults to NCCL when a card is
    present and gloo otherwise; ``backend="gloo"`` also carries CUDA tensors
    (how several ranks share one card, which NCCL refuses). On a card the
    rank's device becomes the current one (:func:`local_device`). Call once
    at program start, on every rank; a second call is a no-op.
    """
    if dist.is_initialized():
        return
    if coordinator_address is None:
        coordinator_address = os.environ.get("COORDINATOR_ADDRESS")
    if coordinator_address is None and all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE")):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"  # torchrun's
    num_processes = num_processes or _env_int("NUM_PROCESSES") or _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("PROCESS_ID")
    if process_id is None:
        process_id = _env_int("RANK")

    if coordinator_address is None and num_processes in (None, 1):
        return  # single-process run
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize: a world of several processes needs the coordinator address, "
            f"the number of processes and this process's id (got {coordinator_address!r}, "
            f"{num_processes!r}, {process_id!r})"
        )
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        torch.cuda.set_device(local_device(process_id))
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes),
        rank=int(process_id),
    )


def _env_int(name: str):
    v = os.environ.get(name)
    return int(v) if v is not None else None


def rank() -> int:
    """This process's rank (0 outside a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The number of ranks (1 outside a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device(process_id: Optional[int] = None) -> torch.device:
    """This rank's card: ``cuda:<LOCAL_RANK mod card count>`` (torchrun's
    ``LOCAL_RANK``, else the rank), so that ranks beyond the host's card
    count share cards. Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("local_device: no CUDA device; pass device='cpu' where a device is asked for")
    local = _env_int("LOCAL_RANK")
    if local is None:
        local = rank() if process_id is None else process_id
    return torch.device("cuda", local % torch.cuda.device_count())


def local_batch_slice(global_batch: int) -> slice:
    """This rank's rows of a data-parallel global batch."""
    per_rank = global_batch // world_size()
    start = rank() * per_rank
    return slice(start, start + per_rank)


def process_info() -> dict:
    """Rank and world size; each rank drives one device, so the local device
    count is 1 and the global one the world size."""
    return {
        "process_index": rank(),
        "process_count": world_size(),
        "local_devices": 1,
        "global_devices": world_size(),
    }


def shard_files(files, process_index: Optional[int] = None, process_count: Optional[int] = None):
    """Static round-robin split of a file list across ranks.

    The coarsest (and cheapest) data parallelism for batch transcription
    jobs: each rank owns every process_count-th file and needs no
    coordination beyond the initial handshake. Use for CLI fleets; use
    ``local_batch_slice`` when sharding chunk batches of a single file
    instead.
    """
    pi = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    return [f for i, f in enumerate(files) if i % pc == pi]
