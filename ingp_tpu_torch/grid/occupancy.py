"""Occupancy-grid lifecycle (counterpart of ingp_tpu/grid/occupancy.py):
visibility marking, the periodic density refresh and the bitfield and
block-table derivation that ends it.

Cells are addressed row-major (x fastest). The refresh's random draws
(the uniform and occupied cell samples and the position jitter) are
explicit inputs: `grid_draws` makes them from a PRNG key on the device,
as the JAX package draws them from its key (core/prng.py).

Grid state (a dict):
  density_grid: (C, G3) float32; -1 marks camera-invisible cells
  count_grid:   (C, G3) float32 visibility counts
  bitfield:     (C*G3/32,) int32 words holding the uint32 occupancy bits
  block_table:  (C, (G/4)^3, 128) int32 block-march neighbourhood rows
"""
from __future__ import annotations

import torch

from ..core import prng
from ..ops.march import build_block_table
from ..ops.pack import packbits_u32

NEAR_DISTANCE = 0.01


def grid_init(cascades: int, grid_size: int, device=None):
    """Empty grid state (ingp_tpu/grid/occupancy.py:50)."""
    g3 = grid_size ** 3
    return {
        "density_grid": torch.zeros((cascades, g3), device=device),
        "count_grid": torch.zeros((cascades, g3), device=device),
        "bitfield": torch.zeros((cascades * g3 // 32,), dtype=torch.int32,
                                device=device),
        "block_table": torch.zeros((cascades, (grid_size // 4) ** 3, 128),
                                   dtype=torch.int32, device=device),
    }


def grid_from_density(grid, density_grid: torch.Tensor, threshold,
                      grid_size: int, cascades: int):
    """Grid state with a new (cascades, G^3) density grid: the bitfield
    marks cells above `threshold` and the block marcher's neighbourhood
    table is rebuilt from it, as the tail of a grid refresh does."""
    bitfield = packbits_u32(density_grid.reshape(-1), threshold)
    return {
        "density_grid": density_grid,
        "count_grid": grid["count_grid"],
        "bitfield": bitfield,
        "block_table": build_block_table(bitfield, grid_size, cascades),
    }


def all_cell_coords(grid_size: int, device=None):
    """(G3, 3) int64 cell coordinates of the row-major flat index."""
    idx = torch.arange(grid_size ** 3, device=device)
    return torch.stack([idx % grid_size, (idx // grid_size) % grid_size,
                        idx // (grid_size * grid_size)], -1)


def cascade_world_coords(coords, c: int, grid_size: int, scale: float):
    """Cell-centre world positions of cascade c and the half cell size."""
    s = min(2.0 ** (c - 1), scale)
    half = s / grid_size
    unit = coords.to(torch.float32) / (grid_size - 1) * 2.0 - 1.0
    return unit * (s - half), half


def mark_invisible_cells(grid, K, poses, img_w: int, img_h: int,
                         grid_size: int, cascades: int, scale: float):
    """Mark cells no camera sees with density -1 and fill count_grid with
    the share of cameras that see each cell (ingp_tpu:73-113). K (3, 3);
    poses (N, 3, 4) c2w."""
    K = torch.as_tensor(K, dtype=torch.float32, device=poses.device)
    w2c_R = poses[:, :3, :3].transpose(1, 2)
    w2c_T = -torch.einsum("nij,nj->ni", w2c_R, poses[:, :3, 3])
    coords = all_cell_coords(grid_size, poses.device)
    density, counts = [], []
    for c in range(cascades):
        xyzs_w, _ = cascade_world_coords(coords, c, grid_size, scale)
        xyzs_c = torch.einsum("nij,gj->ngi", w2c_R, xyzs_w) \
            + w2c_T[:, None, :]
        uvd = torch.einsum("ij,ngj->ngi", K, xyzs_c)
        depth = uvd[..., 2]
        uv = uvd[..., :2] / torch.where(depth[..., None] == 0, 1e-9,
                                        depth[..., None])
        in_image = ((depth >= 0) & (uv[..., 0] >= 0) & (uv[..., 0] < img_w)
                    & (uv[..., 1] >= 0) & (uv[..., 1] < img_h))
        covered = (depth >= NEAR_DISTANCE) & in_image
        count = covered.sum(0) / poses.shape[0]
        too_near = ((depth < NEAR_DISTANCE) & in_image).any(0)
        density.append(torch.where((count > 0) & ~too_near, 0.0, -1.0))
        counts.append(count)
    return {"density_grid": torch.stack(density),
            "count_grid": torch.stack(counts).float(),
            "bitfield": grid["bitfield"], "block_table": grid["block_table"]}


def grid_draws(key, grid_size: int, cascades: int, warmup: bool,
               device=None):
    """The random inputs of one refresh from the PRNG key, per cascade
    (the JAX package's draws from the same key): `idx_u` (M,) uniform
    cell ids and `u_occ` (M,) uniforms in [0, 1) for the occupied draw
    (absent in warmup, which sweeps every cell), and `jitter` (n, 3)
    uniforms in [-1, 1) that scale the half cell size."""
    g3 = grid_size ** 3
    M = g3 // 4
    out = []
    for _ in range(cascades):
        key, k_cells, k_occ, k_jit = prng.split(key, 4)
        d = {}
        if not warmup:
            d["idx_u"] = prng.randint(k_cells, (M,), 0, g3, device)
            d["u_occ"] = prng.uniform(k_occ, (M,), device=device)
        n = g3 if warmup else 2 * M
        d["jitter"] = prng.uniform(k_jit, (n, 3), -1.0, 1.0, device)
        out.append(d)
    return out


def sample_occupied(u, mask):
    """Inverse-CDF draw of len(u) cell ids from the occupied set, u in
    [0, 1) (ingp_tpu `_sample_occupied`). Returns (idx, n_occ)."""
    cdf = torch.cumsum(mask.to(torch.int32), 0)
    n_occ = cdf[-1]
    v = (u * torch.clamp(n_occ, min=1)).to(torch.int32)
    idx = torch.searchsorted(cdf, v, right=True)
    return torch.clamp(idx, 0, mask.shape[0] - 1), n_occ


def eval_density_chunked(density_fn, xyz, chunk: int = 65536):
    """density_fn over (n, 3) world positions, `chunk` at a time."""
    return torch.cat([density_fn(xyz[i:i + chunk])
                      for i in range(0, xyz.shape[0], chunk)])


@torch.no_grad()
def update_density_grid(density_fn, grid, draws, density_threshold,
                        grid_size: int, cascades: int, scale: float,
                        warmup: bool, decay: float = 0.95,
                        erode: bool = False):
    """One periodic grid refresh (ingp_tpu:145-212): every cell in
    warmup, else M uniform and M occupied cells per cascade
    (M = G3/4); tmp = the max sigma at each drawn cell (jittered within
    it), density = max(density * decay, tmp) except on invisible (-1)
    cells; the bitfield marks cells above min(mean positive density,
    threshold). density_fn(x (n, 3)) -> (n,) sigma; draws from
    `grid_draws`."""
    g3 = grid_size ** 3
    dg = grid["density_grid"]
    coords_all = all_cell_coords(grid_size, dg.device)
    tmp = torch.zeros_like(dg)
    for c in range(cascades):
        d = draws[c]
        if warmup:
            idx, coords = None, coords_all
        else:
            idx_u = d["idx_u"]
            idx_o, n_occ = sample_occupied(d["u_occ"],
                                           dg[c] > density_threshold)
            idx_o = torch.where(n_occ > 0, idx_o, idx_u)
            idx = torch.cat([idx_u, idx_o])
            coords = coords_all[idx]
        xyzs_w, half = cascade_world_coords(coords, c, grid_size, scale)
        sigmas = eval_density_chunked(density_fn,
                                      xyzs_w + d["jitter"] * half)
        if warmup:
            tmp[c] = torch.maximum(tmp[c], sigmas)
        else:
            cell_max = torch.zeros(g3, device=dg.device).scatter_reduce(
                0, idx.to(torch.int64), sigmas, "amax")
            tmp[c] = torch.maximum(tmp[c], cell_max)
    if erode:
        decay_v = torch.clamp(
            decay ** (1.0 / torch.clamp(grid["count_grid"], min=1e-6)),
            0.1, 0.95)
    else:
        decay_v = decay
    new_dg = torch.where(dg < 0, dg, torch.maximum(dg * decay_v, tmp))
    pos = new_dg > 0
    mean_density = torch.where(pos, new_dg, 0.0).sum() \
        / torch.clamp(pos.sum(), min=1)
    threshold = torch.clamp(mean_density, max=density_threshold)
    return grid_from_density(grid, new_dg, threshold, grid_size, cascades)
