"""Data and tensor parallelism over ``torch.distributed`` (one process per
device): the port of ``whisperx_tpu/parallel``."""

from .mesh import data_sharding, make_mesh, pad_rows_to_mesh, replicated, shard_batch
from .partition import W2V2_RULES, WHISPER_RULES, partition_specs, shard_params

__all__ = [
    "data_sharding",
    "make_mesh",
    "pad_rows_to_mesh",
    "replicated",
    "shard_batch",
    "W2V2_RULES",
    "WHISPER_RULES",
    "partition_specs",
    "shard_params",
]
