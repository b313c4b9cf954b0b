"""Occupancy-grid ray marching into fixed-capacity sample segments
(counterpart of ingp_tpu/ops/march.py:43-389).

The march visits a deterministic per-ray dt lattice whatever the
occupancy; occupancy only selects which lattice points become samples.
So the lattice is evaluated in closed form over all (ray, step) pairs,
looked up in the occupancy grid in one batched pass, and the first S
occupied points of each ray are kept.

The block marcher reads occupancy from a 16^3-cell neighbourhood row
per run of `block_q` lattice steps (`build_block_table`); samples whose
window coordinates leave the row are marked occupied, so it never drops
a sample the exact march keeps.

`march_rays` is the exact-skip march that both replace: a loop over
iterations that steps dt in occupied cells and jumps whole dt steps past
the exit face of an empty one. No render path runs it; it is the
oracle that the tests hold the lattice and block marchers to.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as nnf

from ..core.cascade import (SQRT3, calc_dt, cell_coord, cell_exit_t,
                            cell_index, mip_from_dt, mip_from_pos)
from .pack import as_int32_bits, bitfield_lookup

_BLOCK_WIN = 16      # window cells per axis
_BLOCK_STRIDE = 4    # anchor granularity


@dataclasses.dataclass(frozen=True)
class MarchConfig:
    """Static march parameters."""
    grid_size: int = 128
    cascades: int = 1
    scale: float = 0.5
    exp_step_factor: float = 0.0
    max_samples: int = 1024   # sets dt_min
    capacity: int = 128       # S: per-ray sample slots
    iters: int = 512          # M: lattice length

    @property
    def block_q(self) -> int:
        """Lattice steps per block-march run."""
        return 16 if self.exp_step_factor == 0.0 else 4


def _lattice_t(t1, k, exp_step_factor: float, max_samples: int,
               grid_size: int, scale: float):
    """t of lattice step k (k: (M,) shared or (R, S) per ray; t1: (R,))."""
    lo = SQRT3 / max_samples
    hi = SQRT3 * 2 * scale / grid_size
    kf = k.to(torch.float32)
    if kf.ndim == 1:
        kf = kf[None, :]
    t1 = t1[:, None]
    f = exp_step_factor
    if f == 0.0 or lo >= hi:
        return t1 + kf * lo
    n1 = torch.clamp(torch.ceil((lo / f - t1) / lo), min=0.0)
    t_n1 = t1 + n1 * lo
    log1pf = math.log1p(f)
    n2 = torch.clamp(torch.ceil(torch.log(hi / f / t_n1) / log1pf), min=0.0)
    t_geo = t_n1 * torch.exp2(math.log2(1.0 + f) * (kf - n1))
    t_geo_end = t_n1 * torch.exp(n2 * log1pf)
    return torch.where(
        kf < n1, t1 + kf * lo,
        torch.where(kf < n1 + n2, t_geo, t_geo_end + (kf - n1 - n2) * hi))


def _lattice_geometry(cfg: MarchConfig, rays_o, rays_d, hits_t, noise):
    """(t_start, ts_m, dt_m, in_range, mip, [nx, ny, nz]), planes (R, M)."""
    t1, t2 = hits_t[:, 0], hits_t[:, 1]
    dt0 = calc_dt(t1, cfg.exp_step_factor, cfg.max_samples, cfg.grid_size,
                  cfg.scale)
    t_start = t1 + dt0 * noise
    k = torch.arange(cfg.iters, dtype=torch.int32, device=rays_o.device)
    ts_m = _lattice_t(t_start, k, cfg.exp_step_factor, cfg.max_samples,
                      cfg.grid_size, cfg.scale)
    dt_m = calc_dt(ts_m, cfg.exp_step_factor, cfg.max_samples,
                   cfg.grid_size, cfg.scale)
    in_range = (t1[:, None] >= 0) & (ts_m >= 0) & (ts_m < t2[:, None])
    xs = [rays_o[:, d:d + 1] + ts_m * rays_d[:, d:d + 1] for d in range(3)]
    mx = torch.maximum(xs[0].abs(), torch.maximum(xs[1].abs(), xs[2].abs()))
    _, e_pos = torch.frexp(mx)
    mip = torch.maximum(torch.clamp(e_pos + 1, 0, cfg.cascades - 1),
                        mip_from_dt(dt_m, cfg.grid_size, cfg.cascades))
    bound = torch.clamp(torch.exp2(mip.to(torch.float32) - 1.0),
                        max=cfg.scale)
    gs = cfg.grid_size
    ns = [torch.clamp(0.5 * (x / bound + 1.0) * gs, 0.0, gs - 1.0
                      ).to(torch.int32) for x in xs]
    return t_start, ts_m, dt_m, in_range, mip, ns


def _pack_march(cfg: MarchConfig, occ, t_start):
    """(R, M) occupancy -> fixed (R, S) segments; ts/deltas recomputed in
    closed form from the kept lattice indices."""
    R, M = occ.shape
    S = cfg.capacity
    k = torch.arange(M, dtype=torch.int32, device=occ.device)[None, :]
    keys = torch.where(occ, k, M + k)
    # keys are distinct per row, so the S smallest are the first S
    # occupied lattice steps in order
    ks = torch.topk(keys, min(S, M), dim=1, largest=False, sorted=True
                    ).values
    if S > M:
        ks = nnf.pad(ks, (0, S - M), value=2 * M)
    n_samples = torch.clamp(occ.sum(1), max=S).to(torch.int32)
    valid = torch.arange(S, device=occ.device)[None, :] < n_samples[:, None]
    kk = torch.where(valid, ks, torch.zeros_like(ks))
    ts_s = _lattice_t(t_start, kk, cfg.exp_step_factor, cfg.max_samples,
                      cfg.grid_size, cfg.scale)
    dt_s = calc_dt(ts_s, cfg.exp_step_factor, cfg.max_samples,
                   cfg.grid_size, cfg.scale)
    zero = torch.zeros((), device=occ.device)
    return {
        "ts": torch.where(valid, ts_s, zero),
        "deltas": torch.where(valid, dt_s, zero),
        "valid": valid,
        "n_samples": n_samples,
        "total_samples": n_samples.sum(),
    }


def march_rays_lattice(cfg: MarchConfig, bitfield, rays_o, rays_d, hits_t,
                       noise):
    """March R rays through the occupancy bitfield.

    bitfield: (cascades*G^3/32,) int32 words; rays_o, rays_d: (R, 3);
    hits_t: (R, 2) from ray_aabb_intersect; noise: (R,) in [0, 1).
    Returns dict ts, deltas (R, S), valid (R, S) bool, n_samples (R,),
    total_samples ()."""
    t_start, _, _, in_range, mip, ns = _lattice_geometry(
        cfg, rays_o, rays_d, hits_t, noise)
    gs = cfg.grid_size
    idx = ((mip * gs + ns[2]) * gs + ns[1]) * gs + ns[0]
    occ = bitfield_lookup(bitfield, idx) & in_range
    return _pack_march(cfg, occ, t_start)


def march_rays(cfg: MarchConfig, bitfield, rays_o, rays_d, hits_t, noise):
    """The exact-skip march of R rays through the occupancy bitfield
    (counterpart of ingp_tpu/ops/march.py:63-130), same arguments and
    result as march_rays_lattice: cfg.iters iterations, each either a
    sample (occupied cell: advance dt) or a skip (empty cell: advance
    whole dt steps past the cell's exit face, at least one); the
    occupied iterations fill each ray's first S slots in order."""
    R = rays_o.shape[0]
    S, M = cfg.capacity, cfg.iters
    dev = rays_o.device
    t1, t2 = hits_t[:, 0], hits_t[:, 1]
    inv_d = 1.0 / rays_d
    dt0 = calc_dt(t1, cfg.exp_step_factor, cfg.max_samples, cfg.grid_size,
                  cfg.scale)
    t = torch.where(t1 >= 0, t1 + dt0 * noise, t1)
    cnt = torch.zeros(R, dtype=torch.int32, device=dev)
    ts_m, dt_m, occ_m = [], [], []
    for _ in range(M):
        active = (t >= 0) & (t < t2) & (cnt < S)
        x = rays_o + t[:, None] * rays_d
        dt = calc_dt(t, cfg.exp_step_factor, cfg.max_samples, cfg.grid_size,
                     cfg.scale)
        mip = torch.maximum(mip_from_pos(x, cfg.cascades),
                            mip_from_dt(dt, cfg.grid_size, cfg.cascades))
        coord, bound = cell_coord(x, mip, cfg.grid_size, cfg.scale)
        occ = bitfield_lookup(bitfield, cell_index(coord, mip,
                                                   cfg.grid_size)) & active
        t_exit = cell_exit_t(x, t, coord, bound, rays_d, inv_d,
                             cfg.grid_size)
        n_steps = torch.clamp(torch.ceil((t_exit - t) / dt), min=1.0)
        t_next = torch.where(occ, t + dt, t + n_steps * dt)
        ts_m.append(t)
        dt_m.append(dt)
        occ_m.append(occ)
        t = torch.where(active, t_next, t)
        cnt = cnt + occ.to(torch.int32)
    occ_m = torch.stack(occ_m)                                  # (M, R)
    slot = torch.cumsum(occ_m.to(torch.int32), 0) - 1
    ray_ids = torch.arange(R, dtype=torch.int64, device=dev)[None, :]
    ok = occ_m & (slot < S)
    flat = (ray_ids * S + slot)[ok]
    ts = torch.zeros(R * S, dtype=torch.float32, device=dev)
    deltas = torch.zeros(R * S, dtype=torch.float32, device=dev)
    ts[flat] = torch.stack(ts_m).to(torch.float32)[ok]
    deltas[flat] = torch.stack(dt_m).to(torch.float32)[ok]
    n_samples = torch.clamp(cnt, max=S)
    valid = torch.arange(S, device=dev)[None, :] < n_samples[:, None]
    return {
        "ts": ts.reshape(R, S),
        "deltas": deltas.reshape(R, S),
        "valid": valid,
        "n_samples": n_samples,
        "total_samples": n_samples.sum(),
    }


def build_block_table(bitfield, grid_size: int, cascades: int):
    """Occupancy words -> (cascades, (G/4)^3, 128) int32 neighbourhood
    rows. Window cell (lx, ly, lz) of a row is bit ((ly&1)<<4)|lx of word
    lz*8 + (ly>>1) (ingp_tpu/ops/march.py:278)."""
    gs = grid_size
    anch = gs // _BLOCK_STRIDE
    dev = bitfield.device
    shifts32 = torch.arange(32, dtype=torch.int32, device=dev)
    occ = ((bitfield[:, None] >> shifts32[None, :]) & 1).to(torch.int64)
    occ = occ.reshape(cascades, gs, gs, gs)                    # [c, z, y, x]
    shifts16 = torch.arange(16, dtype=torch.int64, device=dev)
    tables = []
    for c in range(cascades):
        o = nnf.pad(occ[c], (0, _BLOCK_WIN) * 3)
        # bits16[z, y, ax]: the 16 x-cells from 4*ax, low bit first
        win = o.unfold(2, _BLOCK_WIN, _BLOCK_STRIDE)[:, :, :anch]
        bits16 = (win << shifts16).sum(-1)
        words = []
        for lz in range(_BLOCK_WIN):
            for yp in range(_BLOCK_WIN // 2):
                lo = bits16[lz::4, 2 * yp::4][:anch, :anch]
                hi = bits16[lz::4, 2 * yp + 1::4][:anch, :anch]
                words.append(lo | (hi << 16))
        tables.append(torch.stack(words, -1).reshape(anch ** 3, 128))
    return as_int32_bits(torch.stack(tables))


def march_rays_block(cfg: MarchConfig, block_table, rays_o, rays_d,
                     hits_t, noise):
    """Block-march variant of march_rays_lattice (same contract; reads
    the neighbourhood table from build_block_table)."""
    R = rays_o.shape[0]
    M, Q = cfg.iters, cfg.block_q
    gs = cfg.grid_size
    anch = gs // _BLOCK_STRIDE
    amax = gs - _BLOCK_WIN
    if M % Q:
        raise ValueError("march_iters must be a multiple of the run length")
    nrun = M // Q

    t_start, _, _, in_range, mip, ns = _lattice_geometry(
        cfg, rays_o, rays_d, hits_t, noise)
    runs = [n.reshape(R, nrun, Q) for n in ns]
    mip_r = mip.reshape(R, nrun, Q)
    run_mip = mip_r[:, :, 0]

    def anchor(cq):
        mn = torch.minimum(cq[:, :, 0], cq[:, :, -1])
        return torch.clamp(mn // _BLOCK_STRIDE * _BLOCK_STRIDE, max=amax)
    ax, ay, az = (anchor(r) for r in runs)
    row = (((run_mip * anch + az // _BLOCK_STRIDE) * anch
            + ay // _BLOCK_STRIDE) * anch + ax // _BLOCK_STRIDE)

    lx = runs[0] - ax[:, :, None]
    ly = runs[1] - ay[:, :, None]
    lz = runs[2] - az[:, :, None]
    in_win = (((lx | ly | lz) >= 0) & (lx < _BLOCK_WIN) & (ly < _BLOCK_WIN)
              & (lz < _BLOCK_WIN) & (mip_r == run_mip[:, :, None]))
    lxc, lyc, lzc = (torch.clamp(v, 0, _BLOCK_WIN - 1) for v in (lx, ly, lz))
    bit = ((lyc & 1) << 4) | lxc
    word_idx = (row.to(torch.int64)[:, :, None] * 128
                + (lzc * 8 + (lyc >> 1)))
    wordval = block_table.reshape(-1)[word_idx]
    bit_occ = ((wordval >> bit) & 1) > 0
    occ = torch.where(in_win, bit_occ, True).reshape(R, M) & in_range
    return _pack_march(cfg, occ, t_start)
