"""Ray/box and ray/sphere intersection (counterpart of
ingp_tpu/core/intersect.py)."""
from __future__ import annotations

import torch


def ray_aabb_intersect(rays_o, rays_d, center, half_size):
    """Slab test of N rays against one axis-aligned box.

    rays_o, rays_d: (N, 3); center, half_size: (3,) tensors.
    Returns (N, 2) [t_near, t_far], both -1 where the ray misses;
    t_near is clamped to >= 0."""
    center = center.to(rays_o).reshape(1, 3)
    half_size = half_size.to(rays_o).reshape(1, 3)
    inv_d = 1.0 / rays_d
    t_min = (center - half_size - rays_o) * inv_d
    t_max = (center + half_size - rays_o) * inv_d
    t_near = torch.minimum(t_min, t_max).amax(-1).clamp_min(0.0)
    t_far = torch.maximum(t_min, t_max).amin(-1)
    hit = t_far >= t_near
    miss = torch.full_like(t_near, -1.0)
    return torch.stack([torch.where(hit, t_near, miss),
                        torch.where(hit, t_far, miss)], -1)


def ray_sphere_intersect(rays_o, rays_d, center, radius):
    """Quadratic test of N rays against one sphere.

    rays_o, rays_d: (N, 3); center: (3,) tensor; radius: a float.
    Returns (N, 2) [t_near, t_far], both -1 where the ray misses;
    t_near is clamped to >= 0."""
    center = center.to(rays_o).reshape(1, 3)
    oc = rays_o - center
    a = (rays_d * rays_d).sum(-1)
    b = 2.0 * (oc * rays_d).sum(-1)
    c = (oc * oc).sum(-1) - radius ** 2
    disc = b * b - 4 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = torch.clamp((-b - sq) / (2 * a), min=0.0)
    t2 = (-b + sq) / (2 * a)
    hit = (disc >= 0) & (t2 >= 0)
    miss = torch.full_like(t1, -1.0)
    return torch.stack([torch.where(hit, t1, miss),
                        torch.where(hit, t2, miss)], -1)
