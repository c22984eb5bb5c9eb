"""int4 packing and the int8/int4 quantization of K/V, shared by the models
and the decode kernels' wrappers.

Ports of ``whisperx_tpu/models/whisper.py:quantize_kv`` and of the JAX
package's int4 arrays, which torch has no type for: int4 values are stored
packed two to a byte (:data:`PACKED_INT4`).
"""

from __future__ import annotations

import torch

# Storage type of int4 values: two signed nibbles a byte. A uint8 buffer is
# always packed int4, so a cache or a kernel says its own width.
PACKED_INT4 = torch.uint8


def pack_int4(q: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """int8 values in [-8, 7] → :data:`PACKED_INT4`, two to a byte along
    ``dim`` (of even length): element 2i in the low nibble, 2i + 1 in the
    high one."""
    u = q.movedim(dim, -1).contiguous().view(torch.uint8)
    p = (u[..., 0::2] & 0xF) | (u[..., 1::2] << 4)
    return p.movedim(-1, dim).contiguous()


def unpack_int4(p: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: int8 values, ``dim`` twice as long.
    Arithmetic shifts of the int8 byte sign-extend both nibbles."""
    s = p.view(torch.int8)
    d = dim % p.dim()
    return torch.stack([(s << 4) >> 4, s >> 4], dim=d + 1).flatten(d, d + 1)


def quantize_kv(x: torch.Tensor, bits: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8/int4 quantization of K/V tensors.

    Returns (int8 values, in [-7, 7] for ``bits=4``; fp32 scales with a
    trailing singleton dim), as ``whisperx_tpu/models/whisper.py:quantize_kv``.
    """
    qmax = 7.0 if bits == 4 else 127.0
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) / qmax
    q = torch.clamp(torch.round(xf / torch.clamp(scale, min=1e-8)), -qmax, qmax)
    return q.to(torch.int8), scale


def store_kv(x: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize_kv` with the values as a cache holds them: int8, or
    int4 packed along Dh."""
    q, scale = quantize_kv(x, bits)
    return (pack_int4(q) if bits == 4 else q), scale
