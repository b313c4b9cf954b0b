"""Cascade geometry of the occupancy grid (counterpart of
ingp_tpu/core/cascade.py)."""
from __future__ import annotations

import math

import torch

SQRT3 = 1.7320508075688772


def n_cascades(scale: float) -> int:
    """max(1+ceil(log2(2*scale)), 1)."""
    return max(1 + int(math.ceil(math.log2(2 * scale))), 1)


def calc_dt(t, exp_step_factor: float, max_samples: int, grid_size: int,
            scale: float):
    """Exponential step size, clamped to [sqrt3/max_samples,
    sqrt3*2*scale/grid_size]."""
    return torch.clamp(t * exp_step_factor, SQRT3 / max_samples,
                       SQRT3 * 2 * scale / grid_size)


def mip_from_pos(x, cascades: int):
    """Cascade level from position (..., 3): frexp exponent + 1."""
    _, e = torch.frexp(x.abs().amax(-1))
    return torch.clamp(e + 1, 0, cascades - 1)


def mip_from_dt(dt, grid_size: int, cascades: int):
    """Cascade level whose cells the step spans at most once."""
    _, e = torch.frexp(dt * grid_size)
    return torch.clamp(e, 0, cascades - 1)


def mip_bound(mip, scale: float):
    """Half-extent of cascade `mip`'s cube: min(2^(mip-1), scale)."""
    return torch.clamp(torch.exp2(mip.to(torch.float32) - 1.0), max=scale)


def cell_coord(x, mip, grid_size: int, scale: float):
    """Integer cell coordinate (..., 3) int32 of x at cascade `mip`,
    and the cascade bound."""
    bound = mip_bound(mip, scale)
    f = 0.5 * (x / bound[..., None] + 1.0) * grid_size
    return torch.clamp(f, 0.0, grid_size - 1.0).to(torch.int32), bound


def cell_index(coord, mip, grid_size: int):
    """Flat row-major cell id: mip*gs^3 + (z*gs + y)*gs + x."""
    gs = grid_size
    return ((mip * gs + coord[..., 2]) * gs + coord[..., 1]) * gs \
        + coord[..., 0]
