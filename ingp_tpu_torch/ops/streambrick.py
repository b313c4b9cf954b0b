"""Stream-dedup brick-grid encoding over a ray-contiguous compact sample
stream (counterpart of ingp_tpu/ops/streambrick.py).

The compact batch packs each ray's t-ordered samples contiguously, so
consecutive samples usually share a brick at all but the finest levels.
The stream is cut into tiles of TS samples; per tile and level, runs of
equal consecutive row ids are deduplicated into a unique-row table of
static capacity. A run past the cap marks its cells as overflowed
(local = -9), which gives them exact zero features at that level
instead of aliasing another run's row.

A chunk's tiles form one or two classes (`_tile_classes`): consecutive
tile ranges with their own per-level caps, the tight head class of a
stream sorted by per-ray kept count and the rest, or one class of
auto-calibrated caps (`caps_override`, from `run_count_quantiles`).
Coarse levels are planned in groups of similar cap (`group_levels`,
one aligned cap a group) where JAX takes its grouped path on the TPU,
else level by level at each level's own cap (`_grouped`), and reduced
by kernel K1 (kernels/rayreduce.py), which reads each cell's unique row
from the table by its id; fine levels, whose runs are about one sample
long, go straight to kernel K2 (kernels/brickreduce.py), which reads
each sample's row by its id. Neither gathers rows into a block first.

Both encoders are differentiable w.r.t. the f32 master table: every K1
and K2 launch of one call reads one `table_read`, and their backward
kernels add into its single f32 accumulator. The positions get the
direct levels' gradient (K2's position-cotangent variant) and none from
the dedup levels: K1's backward gives lf no cotangent, as JAX's
`_frr_bwd` returns a zero one.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.brickreduce import brick_reduce_read
from ..kernels.rayreduce import ray_reduce
from .brickgrid import BrickGridConfig, brick_coords, level_lf
from .gather import table_read

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


def _grouped_reduce(cfg, plans, read, loc4, frc4, T, TS, jac_lo, jac_hi,
                    with_jac):
    """One K1 launch per plan (a level group, or one level), reading its
    unique rows from the table read by id. loc4/frc4: (3, Lc, T, TS).
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
        feats_cm, jac_cm = ray_reduce(read, urows, uid, lf, F, with_jac,
                                      jac_lo, jac_hi)
        feats_parts.append(feats_cm.reshape(F, T, Lg, TS).permute(1, 3, 2, 0)
                           .reshape(N, Lg * F))
        if with_jac:
            jac_parts.append(jac_cm.reshape(3, Fj, T, Lg, TS)
                             .permute(0, 2, 4, 3, 1).reshape(3, N, Lg * Fj))
    feats = torch.cat(feats_parts, 1)
    return feats, (torch.cat(jac_parts, 2) if with_jac else None)


def _direct_reduce(cfg, read, rows_d, local, frac, Lc, jac_lo, jac_hi,
                   with_jac):
    """Fine levels [Lc, L): per-sample rows straight from the storage
    table through K2, which fuses the gather (the JAX form takes
    pre-gathered rows instead of the table and `rows_d`)."""
    lf = level_lf(cfg, local[:, Lc:], frac[:, Lc:], Lc, cfg.n_levels)
    return brick_reduce_read(read, rows_d.contiguous(), lf, cfg.n_features,
                             with_jac, jac_lo, jac_hi)


def run_count_quantiles(cfg: BrickGridConfig, u_cm, tile: int,
                        q: float = 0.995):
    """Per-level q-quantile over the TS-sample tiles of the unique-run
    count each tile of the stream u_cm (3, N) (normalised, ray-
    contiguous, unpadded) produces: the measured quantity the caps must
    cover (the trainer's cap auto-calibration). Returns (L,) int32;
    zeros when the stream is shorter than one tile."""
    rows, _, _ = brick_coords(cfg, u_cm.float())
    L, N = rows.shape
    T = N // tile
    if T == 0:
        return torch.zeros(L, dtype=torch.int32, device=u_cm.device)
    r3 = rows[:, :T * tile].reshape(L, T, tile)
    prev = torch.cat([torch.full((L, T, 1), -1, dtype=r3.dtype,
                                 device=r3.device), r3[:, :, :-1]], 2)
    runs = (r3 != prev).sum(2)
    k = min(T - 1, int(np.ceil(q * (T - 1))))
    return torch.sort(runs, 1).values[:, k].to(torch.int32)


def _tile_classes(cfg, tile, T, slack, seg_est, seg_head, head_frac,
                  direct_frac, caps_override=None):
    """Per-chunk tile classes [(caps, Lc, Tc)]: consecutive ranges of Tc
    tiles of a chunk of T tiles, each with its per-level caps and its
    first directly read level Lc.

    caps_override (the auto-calibrated caps, one per level) makes one
    class of those caps, clamped to be monotone in level (what
    group_levels and split_levels assume) and at most the tile. Else,
    with seg_head and head_frac set on a sorted stream, the first
    int(T*head_frac)//8*8 tiles, which hold the longest segments, take
    the caps of the tighter breaks budget tile/seg_head, at the level
    split of the rest (no class when T < 16 or the head would be empty
    or all); the rest keep the formula caps."""
    if caps_override is not None:
        caps, m = [], 1
        for c in caps_override:
            m = max(m, int(c))
            caps.append(min(tile, m))
        caps = tuple(caps)
        return [(caps, split_levels(caps, tile, direct_frac), T)]
    caps_tail = stream_caps(cfg, tile, slack=slack, seg_est=seg_est)
    Lc_tail = split_levels(caps_tail, tile, direct_frac)
    if not seg_head or head_frac <= 0.0 or T < 16:
        return [(caps_tail, Lc_tail, T)]
    Th = int(T * head_frac) // 8 * 8
    if Th <= 0 or Th >= T:
        return [(caps_tail, Lc_tail, T)]
    caps_head = stream_caps(cfg, tile, slack=slack, seg_est=seg_head)
    Lc_head = min(split_levels(caps_head, tile, direct_frac), Lc_tail)
    return [(caps_head, Lc_head, Th), (caps_tail, Lc_tail, T - Th)]


def _grouped(cfg, TS, classes) -> bool:
    """Whether the chunk's dedup levels are planned in level groups of one
    aligned cap (the grouped path) or each level at its own cap U_l.

    The JAX package takes its grouped path on the TPU only where its
    kernel covers every class (ingp_tpu/ops/streambrick.py:172-189,
    :451-530): rows of 32*F lanes, TS a multiple of 128 and every class's
    tile count a multiple of 8; elsewhere it plans each level at its
    exact cap U_l (`_dedup_feats`), so a run overflows at U_l instead of
    at the group's aligned cap. The port plans as JAX would."""
    return (cfg.row_width == 32 * cfg.n_features and TS % 128 == 0
            and all(Tc % 8 == 0 for _, Lc, Tc in classes if Lc > 0))


def _encode_class(cfg, read, caps, Lc, grouped, TS, rows, local, frac,
                  jac_lo, jac_hi, with_jac):
    """One tile class: rows (L, Nc), local/frac (3, L, Nc), Nc = Tc*TS.
    Returns feats (Nc, L*F) and jac (3, Nc, L*Fj) or None."""
    L = cfg.n_levels
    T = rows.shape[1] // TS
    fs, js = [], []
    if Lc > 0:
        groups = group_levels(caps[:Lc]) if grouped else \
            [(lvl, lvl + 1, int(caps[lvl])) for lvl in range(Lc)]
        rows_c = rows[:Lc].reshape(Lc, T, TS)
        ones = torch.ones((T, TS), dtype=torch.bool, device=rows.device)
        plans = [(lo, hi, Ug) + _unique_plan_uniform(rows_c[lo:hi], ones, Ug)
                 for lo, hi, Ug in groups]
        f, j = _grouped_reduce(cfg, plans, read,
                               local[:, :Lc].reshape(3, Lc, T, TS),
                               frac[:, :Lc].reshape(3, Lc, T, TS), T, TS,
                               jac_lo, jac_hi, with_jac)
        fs.append(f)
        js.append(j)
    if Lc < L:
        f, j = _direct_reduce(cfg, read, rows[Lc:], local, frac, Lc, jac_lo,
                              jac_hi, with_jac)
        fs.append(f)
        js.append(j)
    feats = torch.cat(fs, 1)
    return (feats, torch.cat(js, 2)) if with_jac else (feats, None)


def _encode_chunk_stream(cfg, read, classes, TS, xT, jac_lo, jac_hi,
                         with_jac):
    """One chunk: xT (3, Nc) ray-contiguous positions, Nc = T*TS, cut
    into the consecutive tile ranges of `classes` [(caps, Lc, Tc)].
    Returns feats (Nc, L*F) and, with_jac, jac (3, Nc, L*Fj)."""
    rows, local, frac = brick_coords(cfg, xT)
    grouped = _grouped(cfg, TS, classes)
    fs, js = [], []
    n0 = 0
    for caps, Lc, Tc in classes:
        sl = slice(n0, n0 + Tc * TS)
        n0 += Tc * TS
        f, j = _encode_class(cfg, read, caps, Lc, grouped, TS, rows[:, sl],
                             local[:, :, sl], frac[:, :, sl], jac_lo, jac_hi,
                             with_jac)
        fs.append(f)
        js.append(j)
    feats = torch.cat(fs, 0)
    return (feats, torch.cat(js, 1)) if with_jac else (feats, None)


def _stream(cfg, table, x_cm, tile, chunk, storage_dtype, slack, seg_est,
            direct_frac, seg_head, head_frac, caps_override, jac_lo, jac_hi,
            with_jac):
    if cfg.brick_size != 2:
        raise NotImplementedError("the stream encoder covers brick_size 2")
    read = table_read(table, storage_dtype)
    x = x_cm.float()
    N = x.shape[1]
    pad = (-N) % (chunk if N > chunk else _single_pad(tile, chunk))
    xp = torch.nn.functional.pad(x, (0, pad))
    step = min(chunk, xp.shape[1])
    classes = _tile_classes(cfg, tile, step // tile, slack, seg_est,
                            seg_head, head_frac, direct_frac, caps_override)
    feats, jacs = [], []
    for n0 in range(0, xp.shape[1], step):
        f, j = _encode_chunk_stream(cfg, read, classes, tile,
                                    xp[:, n0:n0 + step], jac_lo, jac_hi,
                                    with_jac)
        feats.append(f)
        jacs.append(j)
    feats = torch.cat(feats, 0)[:N]
    return (feats, torch.cat(jacs, 1)[:, :N]) if with_jac else feats


def streambrick_encode(cfg: BrickGridConfig, table, x_cm, tile: int = 256,
                       chunk: int = 65536, storage_dtype=None,
                       slack: float = 1.5, seg_est: int = 4,
                       direct_frac: float = 0.7, seg_head: int = 0,
                       head_frac: float = 0.0, caps_override=None):
    """Encode a ray-contiguous compact stream x_cm (3, N) in [0,1]^3 ->
    (N, L*F). N is zero-padded to whole chunks (or, for one chunk, to 8
    tiles); the pad tail forms one run. seg_head/head_frac: the sorted
    head class (valid only on a stream sorted by per-ray kept count);
    caps_override: per-level caps replacing the formula's
    (`_tile_classes`)."""
    return _stream(cfg, table, x_cm, tile, chunk, storage_dtype, slack,
                   seg_est, direct_frac, seg_head, head_frac, caps_override,
                   0, None, False)


def streambrick_encode_grad(cfg: BrickGridConfig, table, x_cm,
                            tile: int = 256, chunk: int = 65536,
                            jac_lo: int = 0, jac_hi: int | None = None,
                            storage_dtype=None, slack: float = 1.5,
                            seg_est: int = 4, direct_frac: float = 0.7,
                            seg_head: int = 0, head_frac: float = 0.0,
                            caps_override=None):
    """Encode + analytic jacobian: (feats (N, L*F), jac (3, N, L*Fj))."""
    return _stream(cfg, table, x_cm, tile, chunk, storage_dtype, slack,
                   seg_est, direct_frac, seg_head, head_frac, caps_override,
                   jac_lo, jac_hi, True)
