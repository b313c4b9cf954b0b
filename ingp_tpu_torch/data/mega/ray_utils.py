"""Mega-NeRF ray tensors on the host (counterpart of
ingp_tpu/data/mega/ray_utils.py): unit directions in Mega-NeRF's camera
axes (x right, y up, z back), and (o, d, near, far) rays whose bounds an
altitude range clamps where a ray crosses its planes."""
from __future__ import annotations

import numpy as np


def get_ray_directions(W, H, fx, fy, cx, cy, center_pixels):
    """(H, W, 3) float32 unit directions through each pixel (its centre
    with center_pixels); y and z point up and back."""
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    if center_pixels:
        i = i + 0.5
        j = j + 0.5
    directions = np.stack([(i - cx) / fx, -(j - cy) / fy,
                           -np.ones_like(i)], -1)
    return (directions /
            np.linalg.norm(directions, axis=-1, keepdims=True)
            ).astype(np.float32)


def _truncate_with_plane_intersection(rays_o, rays_d, altitude, bounds):
    """Set bounds (..., 1), in place, to the distance from the origin to
    the plane x = altitude (x is down in Mega-NeRF's world) for the rays
    that start above it and head down to it; the others keep theirs."""
    boundable = (rays_o[..., 0] < altitude) & (rays_d[..., 0] > 0)
    if not boundable.any():
        return
    ro = rays_o[boundable]
    rd = rays_d[boundable]
    si = (altitude - ro[:, 0]) / rd[:, 0]
    hit = ro + si[:, None] * rd
    bounds[boundable] = np.linalg.norm(ro - hit, axis=-1)[:, None]


def get_rays(directions, c2w, near, far, ray_altitude_range=None):
    """(..., 3) directions and a (3, 4) c2w -> (..., 8) float32 [origin,
    unit direction, near, far]; with ray_altitude_range (lo, hi), near
    becomes at least the distance to the plane at lo and far at most the
    distance to the plane at hi, never below near."""
    rays_d = directions @ c2w[:, :3].T
    rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(c2w[:, 3], rays_d.shape).copy()

    near_b = np.full(rays_o.shape[:-1] + (1,), near, np.float32)
    far_b = np.full(rays_o.shape[:-1] + (1,), far, np.float32)
    if ray_altitude_range is not None:
        _truncate_with_plane_intersection(rays_o, rays_d,
                                          ray_altitude_range[0], near_b)
        near_b = np.maximum(near_b, near)
        _truncate_with_plane_intersection(rays_o, rays_d,
                                          ray_altitude_range[1], far_b)
        far_b = np.minimum(far_b, far)
        far_b = np.maximum(near_b, far_b)
    return np.concatenate([rays_o, rays_d, near_b, far_b],
                          -1).astype(np.float32)
