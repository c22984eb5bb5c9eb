"""Lower precision for the control: the reference computed one step below
the configuration's precision. "int4" (below int8 weights): weights
rounded to int4 per output channel, activations as they are. "fp8" (below
bfloat16 compute): weights rounded to e4m3 per output channel and every
product's inputs rounded to e4m3 per row (the projections', and the
attention's queries, keys, probabilities and values), as fp8 matmuls and an
fp8 attention take them."""

from __future__ import annotations

import torch

_QMAX = {"int4": 7.0}


def lower(w: torch.Tensor, mode: str, axis) -> torch.Tensor:
    """``w`` (fp32) rounded to ``mode`` with one scale per slice along the
    dims ``axis`` reduces over; "exact" returns ``w`` as it is."""
    if mode == "exact":
        return w
    amax = w.abs().amax(dim=axis, keepdim=True).clamp_min(1e-12)
    if mode in _QMAX:
        s = amax / _QMAX[mode]
        return torch.round(w / s).clamp_(-_QMAX[mode], _QMAX[mode]) * s
    if mode == "fp8":
        s = amax / 448.0
        return (w / s).to(torch.float8_e4m3fn).float() * s
    raise ValueError(f"unknown precision {mode!r}: exact, int4 or fp8")


def lower_input(x: torch.Tensor, mode: str) -> torch.Tensor:
    """A product's input as ``mode`` computes with it: e4m3 per row (last
    dim) for "fp8", unchanged otherwise."""
    if mode != "fp8":
        return x
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s
