"""Stream-dedup brick-grid encoding over a ray-contiguous compact
sample stream (counterpart of ingp_tpu/ops/streambrick.py, forward,
grouped path).

The compact batch packs each ray's t-ordered samples contiguously, so
consecutive samples usually share a brick at all but the finest levels.
The stream is cut into tiles of TS samples; per tile and level, runs of
equal consecutive row ids are deduplicated into a unique-row table of
static capacity (the level group's cap Ug). A run past the cap marks its
cells as overflowed (local = -9), which gives them exact zero features
at that level instead of aliasing another run's row.

Coarse levels are planned in groups of similar cap (`group_levels`) and
reduced by kernel K1 (kernels/rayreduce.py), which reads each cell's
unique row from the table by its id; fine levels, whose runs are about
one sample long, go straight to kernel K2 (kernels/brickreduce.py),
which reads each sample's row by its id. Neither gathers rows into a
block first. This is the grouped path, the TPU default
(ingp_tpu/ops/streambrick.py:172-190).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.brickreduce import brick_reduce
from ..kernels.rayreduce import fused_ray_reduce
from .brickgrid import BrickGridConfig, brick_coords, level_lf
from .gather import storage_cast

SQRT3 = float(np.sqrt(3.0))


def stream_caps(cfg: BrickGridConfig, tile: int, max_samples: int = 1024,
                slack: float = 1.5, seg_est: int = 4) -> tuple:
    """Static per-level unique-run capacities U_l for a TS-sample tile:
    within-ray brick crossings times slack, plus ray-boundary breaks
    (tile / seg_est), plus 4."""
    dt = SQRT3 / max_samples
    B = cfg.brick_size
    caps = []
    for sc in cfg.scales:
        runs = tile * sc * dt / B * slack + tile / seg_est + 4.0
        caps.append(int(min(tile, np.ceil(runs))))
    return tuple(caps)


def group_levels(caps, penalty: int = 32, align: int = 16):
    """Partition the dedup levels into contiguous groups sharing one
    aligned cap, minimising total unique slots plus a per-group
    penalty. Returns [(lo, hi, Ug)]."""
    Lc = len(caps)
    if Lc == 0:
        return []
    up = lambda c: -(-int(c) // align) * align  # noqa: E731
    INF = 1 << 60
    best = [0] + [INF] * Lc
    choice = [(0, 0)] * (Lc + 1)
    for j in range(1, Lc + 1):
        for i in range(j):
            ug = up(caps[j - 1])
            c = best[i] + (j - i) * ug + penalty
            if c < best[j]:
                best[j], choice[j] = c, (i, ug)
    groups = []
    j = Lc
    while j > 0:
        i, ug = choice[j]
        groups.append((i, j, ug))
        j = i
    return groups[::-1]


def split_levels(caps, tile: int, direct_frac: float = 0.7) -> int:
    """First level read directly (per-sample gather): the first whose
    cap is within direct_frac of the tile size."""
    for lvl, c in enumerate(caps):
        if c >= direct_frac * tile:
            return lvl
    return len(caps)


def _single_pad(tile: int, chunk: int) -> int:
    """Single-chunk pad target: 8 tiles when the chunk size allows it."""
    return 8 * tile if chunk % (8 * tile) == 0 else tile


def _unique_plan_uniform(rows, valid, Ug: int):
    """Run-dedup plan with one cap, batch axis (tile, level).

    rows: (Lg, T, TS) int32; valid: (T, TS) bool. Returns uid
    (T*Lg, TS) int32 slot per cell in [0, Ug), urows (T*Lg, Ug) int32
    table row per slot, overflow (Lg, T, TS) bool (the cell's run is
    past the cap)."""
    Lg, T, TS = rows.shape
    prev = torch.cat([torch.full((Lg, T, 1), -1, dtype=rows.dtype,
                                 device=rows.device), rows[:, :, :-1]], 2)
    new = (rows != prev) & valid[None]
    run = torch.cumsum(new.to(torch.int32), 2)
    uid = torch.clamp(run - 1, 0, Ug - 1).to(torch.int32)
    overflow = run > Ug
    s_iota = torch.arange(TS, dtype=torch.int32, device=rows.device)
    keys = torch.where(new & ~overflow, s_iota, TS + s_iota)
    # keys are distinct per (level, tile): the Ug smallest list the
    # run-opening samples first, in stream order
    order = torch.topk(keys, min(Ug, TS), dim=2, largest=False,
                       sorted=True).indices
    urows = torch.gather(rows, 2, order)
    if Ug > TS:
        urows = torch.cat([urows, urows[:, :, :1].expand(Lg, T, Ug - TS)],
                          2)
    uid = uid.permute(1, 0, 2).reshape(T * Lg, TS)
    urows = urows.permute(1, 0, 2).reshape(T * Lg, Ug)
    return uid.contiguous(), urows.contiguous(), overflow


def _plan_groups(caps_c, rows_c, T: int, TS: int):
    """Dedup plans of every level group: [(lo, hi, Ug, uid, urows,
    overflow)]."""
    ones = torch.ones((T, TS), dtype=torch.bool, device=rows_c.device)
    return [(lo, hi, Ug) + _unique_plan_uniform(rows_c[lo:hi], ones, Ug)
            for lo, hi, Ug in group_levels(caps_c)]


def _grouped_reduce(cfg, plans, src, loc4, frc4, T, TS, jac_lo, jac_hi,
                    with_jac):
    """One K1 launch per level group, reading the group's unique rows
    from `src` (the storage table) by id. loc4/frc4: (3, Lc, T, TS).
    Returns (feats (N, Lc*F), jac (3, N, Lc*Fj) or None)."""
    F = cfg.n_features
    Fj = (F if jac_hi is None else jac_hi) - jac_lo
    N = T * TS
    dev = loc4.device
    feats_parts, jac_parts = [], []
    for lo, hi, Ug, uid, urows, ovf in plans:
        Lg = hi - lo

        def to_b(a):                    # (3, Lg, T, TS) -> (3, T*Lg, TS)
            return a.permute(0, 2, 1, 3).reshape(3, T * Lg, TS)
        sc = torch.tensor(cfg.scales[lo:hi], dtype=torch.float32,
                          device=dev)
        loc_g = torch.where(ovf[None], -9.0, loc4[:, lo:hi].float())
        lf = torch.cat([to_b(loc_g), to_b(frc4[:, lo:hi]),
                        sc[None, None, :, None].expand(1, T, Lg, TS
                                                       ).reshape(1, T * Lg,
                                                                 TS),
                        torch.zeros((1, T * Lg, TS), device=dev)], 0)
        feats_cm, jac_cm = fused_ray_reduce(src, urows, uid, lf, F,
                                            with_jac, jac_lo, jac_hi)
        feats_parts.append(feats_cm.reshape(F, T, Lg, TS).permute(1, 3, 2, 0)
                           .reshape(N, Lg * F))
        if with_jac:
            jac_parts.append(jac_cm.reshape(3, Fj, T, Lg, TS)
                             .permute(0, 2, 4, 3, 1).reshape(3, N, Lg * Fj))
    feats = torch.cat(feats_parts, 1)
    return feats, (torch.cat(jac_parts, 2) if with_jac else None)


def _direct_reduce(cfg, src, rows_d, local, frac, Lc, jac_lo, jac_hi,
                   with_jac):
    """Fine levels [Lc, L): per-sample rows straight from the storage
    table through K2, which fuses the gather (the JAX form takes
    pre-gathered rows instead of `src` and `rows_d`)."""
    lf = level_lf(cfg, local[:, Lc:], frac[:, Lc:], Lc, cfg.n_levels)
    return brick_reduce(src, rows_d.contiguous(), lf, cfg.n_features,
                        with_jac, jac_lo, jac_hi)


def _tile_classes(cfg, tile, slack, seg_est, direct_frac):
    """Formula caps of a tile and the first directly read level: the one
    tile class of an unsorted stream (ingp_tpu's `_tile_classes` with no
    sorted head and no cap override)."""
    caps = stream_caps(cfg, tile, slack=slack, seg_est=seg_est)
    return caps, split_levels(caps, tile, direct_frac)


def _encode_chunk_stream(cfg, src, caps, Lc, TS, xT, jac_lo, jac_hi,
                         with_jac):
    """One chunk: xT (3, Nc) ray-contiguous positions, Nc = T*TS.
    Returns feats (Nc, L*F) and, with_jac, jac (3, Nc, L*Fj)."""
    L = cfg.n_levels
    T = xT.shape[1] // TS
    rows, local, frac = brick_coords(cfg, xT)
    fs, js = [], []
    if Lc > 0:
        plans = _plan_groups(caps[:Lc], rows[:Lc].reshape(Lc, T, TS), T, TS)
        f, j = _grouped_reduce(cfg, plans, src,
                               local[:, :Lc].reshape(3, Lc, T, TS),
                               frac[:, :Lc].reshape(3, Lc, T, TS), T, TS,
                               jac_lo, jac_hi, with_jac)
        fs.append(f)
        js.append(j)
    if Lc < L:
        f, j = _direct_reduce(cfg, src, rows[Lc:], local, frac, Lc, jac_lo,
                              jac_hi, with_jac)
        fs.append(f)
        js.append(j)
    feats = torch.cat(fs, 1)
    return (feats, torch.cat(js, 2)) if with_jac else (feats, None)


def _stream(cfg, table, x_cm, tile, chunk, storage_dtype, slack, seg_est,
            direct_frac, jac_lo, jac_hi, with_jac):
    if cfg.brick_size != 2:
        raise NotImplementedError("the stream encoder covers brick_size 2")
    storage = storage_cast(table, storage_dtype)
    src = table if storage is None else storage
    x = x_cm.float()
    N = x.shape[1]
    pad = (-N) % (chunk if N > chunk else _single_pad(tile, chunk))
    xp = torch.nn.functional.pad(x, (0, pad))
    step = min(chunk, xp.shape[1])
    caps, Lc = _tile_classes(cfg, tile, slack, seg_est, direct_frac)
    feats, jacs = [], []
    for n0 in range(0, xp.shape[1], step):
        f, j = _encode_chunk_stream(cfg, src, caps, Lc, tile,
                                    xp[:, n0:n0 + step], jac_lo, jac_hi,
                                    with_jac)
        feats.append(f)
        jacs.append(j)
    feats = torch.cat(feats, 0)[:N]
    return (feats, torch.cat(jacs, 1)[:, :N]) if with_jac else feats


def streambrick_encode(cfg: BrickGridConfig, table, x_cm, tile: int = 256,
                       chunk: int = 65536, storage_dtype=None,
                       slack: float = 1.5, seg_est: int = 4,
                       direct_frac: float = 0.7):
    """Encode a ray-contiguous compact stream x_cm (3, N) in [0,1]^3 ->
    (N, L*F). N is zero-padded to whole chunks (or, for one chunk, to 8
    tiles); the pad tail forms one run."""
    return _stream(cfg, table, x_cm, tile, chunk, storage_dtype, slack,
                   seg_est, direct_frac, 0, None, False)


def streambrick_encode_grad(cfg: BrickGridConfig, table, x_cm,
                            tile: int = 256, chunk: int = 65536,
                            jac_lo: int = 0, jac_hi: int | None = None,
                            storage_dtype=None, slack: float = 1.5,
                            seg_est: int = 4, direct_frac: float = 0.7):
    """Encode + analytic jacobian: (feats (N, L*F), jac (3, N, L*Fj))."""
    return _stream(cfg, table, x_cm, tile, chunk, storage_dtype, slack,
                   seg_est, direct_frac, jac_lo, jac_hi, True)
