"""Brick-packed multiresolution grid encoder (counterpart of
ingp_tpu/ops/brickgrid.py, forward).

One stored row holds the (B+1)^3-point corner lattice of a B^3-cell
brick (B = 2: 27 points x F features, lane p*F + f for point
p = 9i + 3j + k, padded to `row_width`), so a trilinear interpolation
reads one row. Coarse levels are dense; levels whose brick grid exceeds
2^log2_bricks hash the brick coordinate with the Instant-NGP primes.

The trilerp reduce runs in kernel K2 (kernels/brickreduce.py), which
takes the table and the row ids and gathers inside the kernel; it
stands for ingp_tpu's gather followed by `reduce_feats(_jac)`. The
encoders are differentiable w.r.t. the f32 master table through K2's
backward (ops/gather.py `table_read`) and w.r.t. the positions through
its position-cotangent variant (`frac = pos - pos_grid` keeps the
autograd link from `level_lf` back to x).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import prng
from ..kernels.brickreduce import brick_reduce_read
from .gather import table_read

_PRIMES = (1, 2654435761, 805459861)
_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class BrickGridConfig:
    """Static configuration; log2_bricks bounds the hashed-level brick
    count. The derived fields follow ingp_tpu's BrickGridConfig."""
    n_levels: int = 16
    n_features: int = 8
    log2_bricks: int = 16
    base_resolution: int = 16
    per_level_scale: float = 1.3819
    brick_size: int = 2
    # ----- derived -----
    scales: tuple = dataclasses.field(default=None)
    resolutions: tuple = dataclasses.field(default=None)
    brick_res: tuple = dataclasses.field(default=None)
    hashed: tuple = dataclasses.field(default=None)
    offsets: tuple = dataclasses.field(default=None)
    total_bricks: int = dataclasses.field(default=None)

    def __post_init__(self):
        T = 1 << self.log2_bricks
        B = self.brick_size
        scales, res, bres, hashed, offsets = [], [], [], [], []
        off = 0
        for lvl in range(self.n_levels):
            scale = self.base_resolution * (self.per_level_scale ** lvl) - 1
            r = int(np.ceil(scale)) + 1
            br = -(-r // B)
            use_hash = br ** 3 > T
            scales.append(float(scale))
            res.append(r)
            bres.append(br)
            hashed.append(use_hash)
            offsets.append(off)
            off += T if use_hash else br ** 3
        object.__setattr__(self, "scales", tuple(scales))
        object.__setattr__(self, "resolutions", tuple(res))
        object.__setattr__(self, "brick_res", tuple(bres))
        object.__setattr__(self, "hashed", tuple(hashed))
        object.__setattr__(self, "offsets", tuple(offsets))
        object.__setattr__(self, "total_bricks", off)

    @property
    def lattice_pts(self) -> int:
        return (self.brick_size + 1) ** 3

    @property
    def row_width(self) -> int:
        """Stored row width, padded to a multiple of 128 lanes."""
        return -(-self.lattice_pts * self.n_features // 128) * 128

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features


def brickgrid_init(cfg: BrickGridConfig, key, device=None):
    """(total_bricks, row_width) f32 table, uniform in [-1e-4, 1e-4],
    drawn from the PRNG key as the JAX package draws it."""
    return prng.uniform(key, (cfg.total_bricks, cfg.row_width), -1e-4,
                        1e-4, device)


def brick_coords(cfg: BrickGridConfig, xT):
    """Channel-major (3, N) positions in [0,1]^3 -> (rows (L, N) int32
    table rows incl. hashing and level offsets, local (3, L, N) int32
    cell in brick, frac (3, L, N) f32)."""
    dev = xT.device
    B = cfg.brick_size
    scales = torch.tensor(cfg.scales, dtype=torch.float32, device=dev)
    res = torch.tensor(cfg.resolutions, dtype=torch.float32, device=dev)
    bres = torch.tensor(cfg.brick_res, dtype=torch.int64, device=dev)
    offsets = torch.tensor(cfg.offsets, dtype=torch.int64, device=dev)
    hashed = torch.tensor(cfg.hashed, dtype=torch.bool, device=dev)
    mask = (1 << cfg.log2_bricks) - 1

    pos = xT[:, None, :] * scales[None, :, None] + 0.5       # (3, L, N)
    pos_grid = torch.minimum(torch.floor(pos).clamp_min(0.0),
                             (res - 2.0)[None, :, None])
    frac = pos - pos_grid
    cell = pos_grid.to(torch.int32)
    bc = torch.div(cell, B, rounding_mode="floor")
    local = cell - bc * B
    b64 = bc.to(torch.int64)
    # uint32 hash of the JAX package: products wrap at 2^32; the mask
    # keeps only low bits, which the int64 products carry exactly
    h = ((b64[0] * _PRIMES[0]) ^ ((b64[1] * _PRIMES[1]) & _M32)
         ^ ((b64[2] * _PRIMES[2]) & _M32)) & mask
    br = bres[:, None]
    dense = (b64[2] * br + b64[1]) * br + b64[0]
    rows = (torch.where(hashed[:, None], h, dense) + offsets[:, None]
            ).to(torch.int32)
    return rows, local, frac


def level_lf(cfg: BrickGridConfig, local, frac, level_lo: int = 0,
             level_hi: int | None = None):
    """(8, Lw, N) kernel operand [lx, ly, lz, fx, fy, fz, scale, 0] for
    the level window [level_lo, level_hi) of local/frac (3, Lw, N)."""
    level_hi = cfg.n_levels if level_hi is None else level_hi
    _, Lw, N = frac.shape
    sc = torch.tensor(cfg.scales[level_lo:level_hi], dtype=torch.float32,
                      device=frac.device)
    return torch.cat([local.to(torch.float32), frac,
                      sc[None, :, None].expand(1, Lw, N),
                      torch.zeros((1, Lw, N), device=frac.device)], 0)


def _check_brick2(cfg: BrickGridConfig):
    if cfg.brick_size != 2:
        raise NotImplementedError("the brick reduce covers brick_size 2")


def _encode(cfg, table, x, chunk, storage_dtype, x_cm, with_jac, jac_lo,
            jac_hi):
    _check_brick2(cfg)
    xc = (x.float() if x_cm else x.float().T).contiguous()
    read = table_read(table, storage_dtype)
    feats, jacs = [], []
    for n0 in range(0, xc.shape[1], chunk):
        rows, local, frac = brick_coords(cfg, xc[:, n0:n0 + chunk])
        f, j = brick_reduce_read(read, rows, level_lf(cfg, local, frac),
                                 cfg.n_features, with_jac, jac_lo, jac_hi)
        feats.append(f)
        jacs.append(j)
    feats = torch.cat(feats, 0)
    return (feats, torch.cat(jacs, 1)) if with_jac else feats


def brickgrid_encode(cfg: BrickGridConfig, table, x, chunk: int = 16384,
                     storage_dtype=None, x_cm: bool = False):
    """Encode positions in [0,1]^3 ((N, 3), or (3, N) with x_cm) ->
    (N, L*F) features, one fused gather+reduce (K2) per chunk."""
    return _encode(cfg, table, x, chunk, storage_dtype, x_cm, False, 0,
                   None)


def brickgrid_encode_grad(cfg: BrickGridConfig, table, x,
                          chunk: int = 16384, jac_lo: int = 0,
                          jac_hi: int | None = None, storage_dtype=None,
                          x_cm: bool = False):
    """Encode + analytic d(feat)/dx: (feats (N, L*F), jac (3, N, L*Fj))."""
    return _encode(cfg, table, x, chunk, storage_dtype, x_cm, True,
                   jac_lo, jac_hi)
