"""Ray geometry (counterpart of ingp_tpu/core/rays.py:22,56)."""
from __future__ import annotations

import numpy as np
import torch


def get_ray_directions(H, W, K, flatten=True):
    """Pixel -> camera-space ray directions, [right down front]
    convention, pixel centres at +0.5. Returns float32 numpy (H*W, 3)
    (or (H, W, 3) when not flatten), as the JAX package does."""
    K = np.asarray(K, dtype=np.float64)
    v, u = np.meshgrid(np.arange(H, dtype=np.float32),
                       np.arange(W, dtype=np.float32), indexing="ij")
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    directions = np.stack([(u - cx + 0.5) / fx,
                           (v - cy + 0.5) / fy,
                           np.ones_like(u)], -1).astype(np.float32)
    return directions.reshape(-1, 3) if flatten else directions


def get_rays(directions: torch.Tensor, c2w: torch.Tensor):
    """Camera-space dirs (N, 3) + c2w (3, 4) or (N, 3, 4) -> world
    (rays_o, rays_d), both (N, 3). Directions are not normalised."""
    if c2w.ndim == 2:
        rays_d = directions @ c2w[:, :3].T
        rays_o = c2w[:, 3].expand_as(rays_d)
    else:
        rays_d = torch.einsum("nc,nbc->nb", directions, c2w[..., :3])
        rays_o = c2w[..., 3].expand_as(rays_d)
    return rays_o, rays_d
