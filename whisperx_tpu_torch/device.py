"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card. Raises when CUDA is asked for and absent:
    the port never falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "whisperx_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    return dev


# Rows a device forward takes at once in ``map_rows``: 64 five-second windows
# hold ~1.3 GB of ResNet34 activations at the stem, ~160 MB of SincNet's.
ROW_CHUNK = 64


def map_rows(fn: Callable[[torch.Tensor], torch.Tensor], rows: np.ndarray, device: torch.device) -> np.ndarray:
    """``fn`` over the rows of a host array, ``ROW_CHUNK`` rows at a time on
    ``device`` so that memory stays bounded (rows are independent, so the
    result does not depend on the cut); the outputs concatenated on the host
    as float32."""
    out = []
    with torch.inference_mode():
        for i in range(0, rows.shape[0], ROW_CHUNK):
            chunk = torch.from_numpy(np.ascontiguousarray(rows[i : i + ROW_CHUNK], np.float32)).to(device)
            out.append(fn(chunk).float().cpu().numpy())
    return np.concatenate(out, axis=0)
