"""Occupancy-grid state (counterpart of ingp_tpu/grid/occupancy.py, the
parts the test render needs: grid_init and the bitfield/block-table
derivation that ends every grid refresh)."""
from __future__ import annotations

import torch

from ..ops.march import build_block_table
from ..ops.pack import packbits_u32


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


def grid_from_density(grid, density_grid: torch.Tensor, threshold: float,
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
