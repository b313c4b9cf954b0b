"""Ray geometry (counterpart of ingp_tpu/core/rays.py:22,56,77)."""
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


def axisangle_to_R(v):
    """Rodrigues axis-angle -> rotation matrix, (B, 3) -> (B, 3, 3) (or
    (3,) -> (3, 3)); differentiable, with the +1e-7 norm guard and the
    sqrt(|v|^2 + 1e-14) norm that keeps the gradient finite at v = 0."""
    squeeze = v.ndim == 1
    if squeeze:
        v = v[None]
    zero = torch.zeros_like(v[:, :1])
    skew = torch.stack([
        torch.cat([zero, -v[:, 2:3], v[:, 1:2]], 1),
        torch.cat([v[:, 2:3], zero, -v[:, 0:1]], 1),
        torch.cat([-v[:, 1:2], v[:, 0:1], zero], 1)], 1)
    norm = torch.sqrt((v * v).sum(1) + 1e-14)[:, None, None] + 1e-7
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    R = eye + (torch.sin(norm) / norm) * skew \
        + ((1 - torch.cos(norm)) / norm ** 2) * (skew @ skew)
    return R[0] if squeeze else R
