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


def map_rows(
    fn: Callable[[torch.Tensor], torch.Tensor], rows: np.ndarray, device: torch.device, mesh=None
) -> np.ndarray:
    """``fn`` over the rows of a host array, ``ROW_CHUNK`` rows at a time on
    ``device`` so that memory stays bounded (rows are independent, so the
    result does not depend on the cut); the outputs concatenated on the host
    as float32. Under a ``parallel.make_mesh`` mesh the rows pad to
    ``pad_rows_to_mesh``'s granule, each rank maps its own share on its
    device, and every rank gets all the rows back (a collective: every rank
    calls it)."""
    if mesh is not None:
        from .parallel.mesh import gather_rows, pad_rows_to_mesh

        with torch.inference_mode():
            local = pad_rows_to_mesh(mesh, np.asarray(rows, np.float32))
            out = torch.cat([fn(local[i : i + ROW_CHUNK]).float() for i in range(0, local.shape[0], ROW_CHUNK)])
            return gather_rows(mesh, out)[: rows.shape[0]].cpu().numpy()
    out = []
    with torch.inference_mode():
        for i in range(0, rows.shape[0], ROW_CHUNK):
            chunk = torch.from_numpy(np.ascontiguousarray(rows[i : i + ROW_CHUNK], np.float32)).to(device)
            out.append(fn(chunk).float().cpu().numpy())
    return np.concatenate(out, axis=0)
