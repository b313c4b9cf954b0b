"""3D Morton (Z-order) codes (counterpart of ingp_tpu/core/morton.py).

Kept in int64 with 32-bit masks: torch's uint32 support is partial."""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _expand_bits(v):
    v = v.to(torch.int64) & _M32
    v = (v | (v << 16)) & 0xFF0000FF
    v = (v | (v << 8)) & 0x0F00F00F
    v = (v | (v << 4)) & 0xC30C30C3
    v = (v | (v << 2)) & 0x49249249
    return v


def _compact_bits(x):
    x = x.to(torch.int64) & 0x49249249
    x = (x | (x >> 2)) & 0xC30C30C3
    x = (x | (x >> 4)) & 0x0F00F00F
    x = (x | (x >> 8)) & 0xFF0000FF
    x = (x | (x >> 16)) & 0x0000FFFF
    return x


def morton3d(coords):
    """(N, 3) int coords (< 1024) -> (N,) int32 Morton codes."""
    x, y, z = (_expand_bits(coords[..., d]) for d in range(3))
    return (x | (y << 1) | (z << 2)).to(torch.int32)


def morton3d_invert(codes):
    """(N,) Morton codes -> (N, 3) int32 coords."""
    c = codes.to(torch.int64) & _M32
    return torch.stack([_compact_bits(c), _compact_bits(c >> 1),
                        _compact_bits(c >> 2)], -1).to(torch.int32)
