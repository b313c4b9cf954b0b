"""Implicit transient-mask model (counterpart of
ingp_tpu/models/implicit_mask.py): a hash grid over (u, v, img_idx)
-> a 64-unit MLP -> a sigmoid mask that down-weights the RGB loss on
transient pixels. Grid: L 8, F 2, T 2^16, base resolution 16, per-level
scale exp(ln(2048/16)/7).

The mask's table is row-major (total_rows, F) like the model's hash
tables; `models/ngp.py` `hash_layout` transposes it to and from the JAX
package's (F, total_rows) wherever it is the "table" leaf of a "msk"
subtree (params, Adam moments, checkpoints).
"""
from __future__ import annotations

import numpy as np

from ..core import prng
from ..ops.hashgrid import HashGridConfig, hashgrid_encode, hashgrid_init
from .mlp import mlp_apply, mlp_init

MASK_GRID_CFG = HashGridConfig(
    n_levels=8, n_features=2, log2_hashmap_size=16, base_resolution=16,
    per_level_scale=float(np.exp(np.log(2048 / 16) / 7)))


def mask_init(key, device=None):
    """{"table": (total_rows, 2), "net": MLP 16 -> 64 -> 1}, drawn from
    the PRNG key as the JAX package's mask_init draws them."""
    k1, k2 = prng.split(key)
    return {"table": hashgrid_init(MASK_GRID_CFG, k1, device),
            "net": mlp_init((MASK_GRID_CFG.out_dim, 64, 1), k2, device)}


def mask_apply(params, uvi):
    """uvi (N, 3) in [0, 1] (u, v, img_idx / N_imgs) -> mask (N, 1)."""
    h = hashgrid_encode(MASK_GRID_CFG, params["table"], uvi)
    return mlp_apply(params["net"], h, "relu", "sigmoid")
