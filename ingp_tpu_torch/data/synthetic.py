"""Procedural sphere scene with analytic ground truth (the port's own
numpy copy of ingp_tpu/data/synthetic.py: trace_scene, look_at_pose and
SyntheticDataset give the same arrays for the same arguments)."""
from __future__ import annotations

import numpy as np

from ..core.rays import get_ray_directions
from .base import BaseDataset

# scene: spheres (center, radius, albedo) inside [-0.5, 0.5]^3
SPHERES = [
    (np.array([0.0, 0.05, 0.0]), 0.22, np.array([0.80, 0.25, 0.15])),
    (np.array([-0.22, -0.18, 0.12]), 0.12, np.array([0.20, 0.55, 0.85])),
    (np.array([0.22, -0.2, -0.1]), 0.10, np.array([0.95, 0.85, 0.30])),
]
_LIGHT_DIR = np.array([0.5, -0.8, 0.3]) / np.linalg.norm([0.5, -0.8, 0.3])


def trace_scene(rays_o, rays_d):
    """Analytic ray trace. Returns (rgb (N,3), depth (N,), hit (N,),
    normal (N,3), seg (N,) sphere index + 1, 0 = background)."""
    N = len(rays_o)
    best_t = np.full(N, np.inf)
    rgb = np.zeros((N, 3), np.float32)
    normal = np.zeros((N, 3), np.float32)
    seg = np.zeros(N, np.int64)
    d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    for si, (c, r, albedo) in enumerate(SPHERES):
        oc = rays_o - c
        b = 2 * np.sum(oc * d, -1)
        cc = np.sum(oc * oc, -1) - r * r
        disc = b * b - 4 * cc
        hit = disc > 0
        t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / 2, np.inf)
        closer = hit & (t > 0) & (t < best_t)
        best_t = np.where(closer, t, best_t)
        p = rays_o + t[:, None] * d
        n = (p - c) / r
        shade = np.clip(np.sum(n * (-_LIGHT_DIR), -1), 0, 1) * 0.8 + 0.2
        rgb[closer] = (albedo[None] * shade[:, None])[closer]
        normal[closer] = n[closer]
        seg[closer] = si + 1
    depth = np.where(np.isfinite(best_t), best_t, 0.0).astype(np.float32)
    return rgb, depth, np.isfinite(best_t), normal, seg


def look_at_pose(eye, target=np.zeros(3), up=np.array([0, -1.0, 0])):
    """c2w with [right down front] convention (OpenCV)."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd, eye], 1).astype(np.float32)


def sphere_density_grid(grid_size: int, cascades: int, scale: float):
    """(cascades, grid_size^3) float32 density grid that is 1 in cells
    whose centre lies inside a scene sphere and 0 elsewhere, in the
    row-major cell order of the occupancy grid (x fastest). Cell
    centres follow the grid refresh's placement
    (ingp_tpu/grid/occupancy.py _cascade_world_coords)."""
    gs = grid_size
    idx = np.arange(gs ** 3)
    coords = np.stack([idx % gs, (idx // gs) % gs, idx // (gs * gs)], -1)
    out = np.zeros((cascades, gs ** 3), np.float32)
    for c in range(cascades):
        s = min(2.0 ** (c - 1), scale)
        half = s / gs
        x = (coords.astype(np.float32) / (gs - 1) * 2.0 - 1.0) * (s - half)
        inside = np.zeros(len(idx), bool)
        for center, r, _ in SPHERES:
            inside |= np.sum((x - center) ** 2, -1) < r * r
        out[c] = inside
    return out


class SyntheticDataset(BaseDataset):
    """Analytic sphere scene; split='train' n_train views, 'test'
    n_test views."""

    def __init__(self, root_dir="", split="train", downsample=1.0,
                 img_size=128, n_train=20, n_test=4, seed=0, **kwargs):
        super().__init__(root_dir, split, downsample)
        w = h = int(img_size * downsample)
        f = 1.1 * w
        self.K = np.float32([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
        self.img_wh = (w, h)
        self.directions = get_ray_directions(h, w, self.K)

        n = n_train if split.startswith("train") else n_test
        rng = np.random.default_rng(seed if split.startswith("train")
                                    else seed + 1)
        poses, rays, labels, normals = [], [], [], []
        for i in range(n):
            theta = 2 * np.pi * (i / n) + rng.uniform(0, 0.3)
            phi = rng.uniform(-0.9, 0.9)
            eye = 1.35 * np.array([np.cos(theta) * np.cos(phi),
                                   np.sin(phi),
                                   np.sin(theta) * np.cos(phi)])
            c2w = look_at_pose(eye)
            poses.append(c2w)
            ro = np.broadcast_to(c2w[:, 3], self.directions.shape)
            rd = self.directions @ c2w[:, :3].T
            rgb, depth, hit, nrm, seg = trace_scene(ro, rd)
            rays.append(rgb)
            labels.append(seg)
            normals.append(nrm)
        self.poses = np.stack(poses)
        self.rays = np.stack(rays).astype(np.float32)
        self.labels = np.stack(labels)
        self.normals = np.stack(normals).astype(np.float32)
