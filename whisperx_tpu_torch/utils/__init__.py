"""Host-side helpers shared across the framework.

A copy of the framework-free helpers of ``whisperx_tpu/utils/__init__.py``
(reference: whisperx/utils.py:129-189,433-437): timestamp formatting, safe
console encoding, zlib compression ratio, NaN interpolation, row bucketing.
The port keeps its own so it never imports the JAX package (tests hold the two
equal). ``enable_compile_cache`` configures JAX's compilation cache and has no
counterpart here.
"""

from __future__ import annotations

import sys
import zlib

import numpy as np


def exact_div(x: int, y: int) -> int:
    assert x % y == 0
    return x // y


def str2bool(string: str) -> bool:
    table = {"True": True, "False": False}
    if string not in table:
        raise ValueError(f"Expected one of {set(table)}, got {string}")
    return table[string]


def optional_int(string: str):
    return None if string == "None" else int(string)


def optional_float(string: str):
    return None if string == "None" else float(string)


def compression_ratio(text: str) -> float:
    """Bytes-per-compressed-byte; high values flag repetitive hallucination."""
    text_bytes = text.encode("utf-8")
    return len(text_bytes) / len(zlib.compress(text_bytes))


_SYSTEM_ENCODING = sys.getdefaultencoding()


def make_safe(string: str) -> str:
    """Replace characters the console encoding can't represent with '?'."""
    if _SYSTEM_ENCODING == "utf-8":
        return string
    return string.encode(_SYSTEM_ENCODING, errors="replace").decode(_SYSTEM_ENCODING)


def format_timestamp(
    seconds: float, always_include_hours: bool = False, decimal_marker: str = "."
) -> str:
    """Render seconds as [HH:]MM:SS<marker>mmm (srt/vtt timestamp syntax)."""
    assert seconds >= 0, "non-negative timestamp expected"
    ms = round(seconds * 1000.0)
    hours, ms = divmod(ms, 3_600_000)
    minutes, ms = divmod(ms, 60_000)
    secs, ms = divmod(ms, 1_000)
    hours_marker = f"{hours:02d}:" if always_include_hours or hours > 0 else ""
    return f"{hours_marker}{minutes:02d}:{secs:02d}{decimal_marker}{ms:03d}"


def interpolate_nans(values, method: str = "nearest") -> np.ndarray:
    """Fill NaNs in a 1-D float sequence.

    Same healing behaviour as the reference (whisperx/utils.py:433-437, which
    uses pandas interpolate+ffill+bfill): interior NaNs take the nearest
    non-NaN value, leading/trailing NaNs copy the closest valid endpoint. With
    fewer than two valid points, it degenerates to forward/backward fill.
    Accepts anything array-like (including pandas Series); returns numpy.
    """
    x = np.asarray(values, dtype=np.float64).copy()
    valid = ~np.isnan(x)
    if valid.sum() == 0:
        return x
    idx_valid = np.flatnonzero(valid)
    if valid.sum() == 1:
        x[:] = x[idx_valid[0]]
        return x
    positions = np.arange(len(x))
    if method == "nearest":
        # For each position, index of nearest valid sample.
        right = np.searchsorted(idx_valid, positions, side="left")
        right = np.clip(right, 0, len(idx_valid) - 1)
        left = np.clip(right - 1, 0, len(idx_valid) - 1)
        pick_left = np.abs(positions - idx_valid[left]) <= np.abs(idx_valid[right] - positions)
        nearest = np.where(pick_left, idx_valid[left], idx_valid[right])
        x = x[nearest]
    else:  # linear, then edge fill
        x = np.interp(positions, idx_valid, x[idx_valid])
    return x


def bucket_rows(n: int, granule: int = 8) -> int:
    """Round a batch-row/window count up to a granule (bounds the number of
    distinct shapes that variable-size host batches produce)."""
    return max(granule, -(-n // granule) * granule)


__all__ = [
    "exact_div",
    "str2bool",
    "optional_int",
    "optional_float",
    "compression_ratio",
    "make_safe",
    "format_timestamp",
    "interpolate_nans",
    "bucket_rows",
]
