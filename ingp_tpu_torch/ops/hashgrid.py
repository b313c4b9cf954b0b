"""Multiresolution hash-grid encoding (counterpart of
ingp_tpu/ops/hashgrid.py).

All level tables live in one **row-major** (total_rows, F) f32 master
table (the JAX package keeps it feature-major, (F, total_rows), for the
TPU's lanes): one corner is one row of F features, 32 bytes at F 8.
`models/ngp.py` `params_from_numpy` / `params_to_numpy` transpose it
to and from the JAX layout.

The encode is plain PyTorch with autograd: per cube corner, one gather
of (L*N) rows from the table read (`ops/gather.py` `table_read`, the
bf16 storage copy where asked), times the trilinear weight. The
gather's backward adds its cotangent into the read's one f32 master
gradient with `index_add_`. Levels whose dense grid fits the hash map
are indexed directly, finer ones hash with the Instant-NGP primes.

Coordinates: inputs in [0, 1]^3, level scale_l = Nmin * b^l - 1,
pos = x * scale_l + 0.5, corners clamped to [0, res_l - 1].
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import prng
from .gather import table_read

# Instant-NGP spatial hash primes; the products wrap mod 2^32
_PRIMES = (1, 2654435761, 805459861)
_CORNERS = [((c & 1), ((c >> 1) & 1), ((c >> 2) & 1)) for c in range(8)]


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    """Static configuration of one hash-grid encoder (the JAX package's
    fields and derived tuples: per level its scale, resolution, whether
    it hashes, and its first row; levels' row counts round up to 128)."""
    n_levels: int = 16
    n_features: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 1.3819
    scales: tuple = dataclasses.field(default=None)
    resolutions: tuple = dataclasses.field(default=None)
    hashed: tuple = dataclasses.field(default=None)
    offsets: tuple = dataclasses.field(default=None)
    total_rows: int = dataclasses.field(default=None)

    def __post_init__(self):
        T = 1 << self.log2_hashmap_size
        scales, resolutions, hashed, offsets = [], [], [], []
        off = 0
        for lvl in range(self.n_levels):
            scale = self.base_resolution * (self.per_level_scale ** lvl) - 1.0
            res = int(np.ceil(scale)) + 1
            use_hash = res ** 3 > T
            size = T if use_hash else res ** 3
            scales.append(float(scale))
            resolutions.append(res)
            hashed.append(use_hash)
            offsets.append(off)
            off += -(-size // 128) * 128
        object.__setattr__(self, "scales", tuple(scales))
        object.__setattr__(self, "resolutions", tuple(resolutions))
        object.__setattr__(self, "hashed", tuple(hashed))
        object.__setattr__(self, "offsets", tuple(offsets))
        object.__setattr__(self, "total_rows", off)

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features

    @property
    def hashmap_size(self) -> int:
        return 1 << self.log2_hashmap_size


def hashgrid_init(cfg: HashGridConfig, key, device=None):
    """(total_rows, F) f32 table, uniform in [-1e-4, 1e-4]: the JAX
    package's (F, total_rows) draw from the PRNG key, transposed."""
    return prng.uniform(key, (cfg.n_features, cfg.total_rows), -1e-4, 1e-4,
                        device).T.contiguous()


class _SinkGather(torch.autograd.Function):
    """storage[rows] in f32; the backward adds the cotangent into the
    read's f32 master gradient (its sink) and returns the token's."""

    @staticmethod
    def forward(ctx, token, sink, storage, rows):
        ctx.save_for_backward(rows)
        ctx.sink = sink
        return storage[rows].float()

    @staticmethod
    def backward(ctx, ct):
        rows, = ctx.saved_tensors
        ctx.sink.buffer().index_add_(0, rows, ct.float())
        return ctx.sink.token_grad(), None, None, None


def _gather(read, rows):
    if read.token is None:
        return read.storage[rows].float()
    return _SinkGather.apply(read.token, read.sink, read.storage, rows)


def corner_rows(cfg: HashGridConfig, corner):
    """Table rows (L, N) int64 of integer corner coordinates (3, L, N),
    already clamped to [0, res - 1]: hashed levels XOR the products with
    the primes (their low 32 bits are the uint32 products) and mask with
    the hash map size; dense levels index (c2*res + c1)*res + c0."""
    dev = corner.device
    res = torch.tensor(cfg.resolutions, device=dev)[:, None]
    off = torch.tensor(cfg.offsets, device=dev)[:, None]
    hashed = torch.tensor(cfg.hashed, device=dev)[:, None]
    h = ((corner[0] * _PRIMES[0]) ^ (corner[1] * _PRIMES[1])
         ^ (corner[2] * _PRIMES[2])) & 0xFFFFFFFF & (cfg.hashmap_size - 1)
    dense = (corner[2] * res + corner[1]) * res + corner[0]
    return torch.where(hashed, h, dense) + off


def _encode(cfg: HashGridConfig, table, x, storage_dtype, x_cm, with_jac):
    read = table_read(table, storage_dtype)
    L, F = cfg.n_levels, cfg.n_features
    dev = table.device
    xT = x.float() if x_cm else x.float().T
    N = xT.shape[1]
    scales = torch.tensor(cfg.scales, dtype=torch.float32, device=dev)
    res = torch.tensor(cfg.resolutions, dtype=torch.int64, device=dev)
    # x * scale + 0.5 rounded once, as a fused multiply-add gives it (the
    # f64 product of two f32 values is exact)
    pos = (xT[:, None, :].double() * scales[None, :, None].double()
           + 0.5).float()                                       # (3, L, N)
    pos_grid = torch.floor(pos)
    frac = pos - pos_grid
    pos_grid = pos_grid.to(torch.int64)
    hi = (res - 1)[None, :, None]
    acc = torch.zeros((L, N, F), device=dev)
    dacc = torch.zeros((3, L, N, F), device=dev) if with_jac else None
    for bits in _CORNERS:
        b = torch.tensor(bits, dtype=torch.int64, device=dev)[:, None, None]
        corner = torch.minimum(torch.clamp(pos_grid + b, min=0), hi)
        rows = corner_rows(cfg, corner).reshape(-1)
        feats = _gather(read, rows).reshape(L, N, F)
        fb = b.float()
        per_dim = fb * frac + (1.0 - fb) * (1.0 - frac)         # (3, L, N)
        w = per_dim[0] * per_dim[1] * per_dim[2]
        acc = acc + feats * w[..., None]
        if with_jac:
            # d w / d frac_d = (2 b_d - 1) * prod_{e != d} per_dim_e
            dw = torch.stack([(2.0 * fb[d] - 1.0)
                              * per_dim[(d + 1) % 3] * per_dim[(d + 2) % 3]
                              for d in range(3)])               # (3, L, N)
            dacc = dacc + feats[None] * dw[..., None]
    out = acc.permute(1, 0, 2).reshape(N, L * F)
    if not with_jac:
        return out
    # d frac / d x = scale_l
    dacc = dacc * scales[None, :, None, None]
    return out, dacc.permute(0, 2, 1, 3).reshape(3, N, L * F)


def hashgrid_encode(cfg: HashGridConfig, table, x, storage_dtype=None,
                    x_cm: bool = False):
    """Features (N, L*F) f32, level-major, of positions x (N, 3) (or
    (3, N) with x_cm) in [0, 1]^3, read from the (total_rows, F) master
    `table` (through a copy at storage_dtype where given)."""
    return _encode(cfg, table, x, storage_dtype, x_cm, False)


def hashgrid_encode_grad(cfg: HashGridConfig, table, x, storage_dtype=None,
                         x_cm: bool = False):
    """(feats (N, L*F), jac (3, N, L*F)): the encode and its analytic
    spatial jacobian d feats / d x_d from the same corner gathers
    (positions on the clamp boundary get the clamped interpolation's
    derivative, as in the JAX package)."""
    return _encode(cfg, table, x, storage_dtype, x_cm, True)
