"""3D plane fitting: least squares and RANSAC (counterpart of
ingp_tpu/utility/fit_plane.py).

RANSAC draws its hypotheses as the JAX package does, three distinct
point indices per iteration from numpy's `default_rng(seed)`, one
`choice` call per iteration in the same order (degenerate triples draw
too), then scores all of them at once on the device: one (iters, N)
float64 distance matrix, chunked over iterations to bound its memory.
The first hypothesis with the most inliers wins, as JAX's loop keeps the
first best.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

# float64 entries of the distance matrix held at once
_CHUNK_ELEMS = 1 << 27


class Plane:
    """ax + by + cz + d = 0, kept as (unit normal, center)."""

    def __init__(self, params=(1, 1, 1, 1)):
        a, b, c, d = params
        normal = np.array([a, b, c], np.float64)
        norm = np.linalg.norm(normal)
        self.normal = normal / norm
        self.center = (-d / norm) * self.normal

    def move_by_distance(self, d):
        self.center = self.center + self.normal * d

    def square_error(self, points):
        diff = (points - self.center) @ self.normal
        return diff ** 2

    def mean_square_error(self, points):
        return float(np.mean(self.square_error(points)))

    def absolute_error(self, points):
        return np.abs((points - self.center) @ self.normal)

    def mean_absolute_error(self, points):
        return float(np.mean(self.absolute_error(points)))


def _points(points, dev):
    return torch.as_tensor(np.asarray(points, np.float64), device=dev) \
        if not torch.is_tensor(points) else points.to(dev, torch.float64)


def plane_lse(points, device=None):
    """Least-squares plane through points (n, 3) -> (normal, d), numpy
    float64; the SVD runs on the device. The normal's sign is the SVD's
    (either sign is a solution; `d` flips with it)."""
    pts = _points(points, resolve_device(device))
    centroid = pts.mean(0)
    _, _, vt = torch.linalg.svd(pts - centroid, full_matrices=False)
    normal = vt[-1]
    return normal.cpu().numpy(), float(-normal @ centroid)


def _distances(pts, p0, normals):
    """|(points - p0_i) . n_i| for every hypothesis i: (I, N)."""
    return torch.abs(sum((pts[None, :, j] - p0[:, None, j])
                         * normals[:, None, j] for j in range(3)))


def plane_ransac(points, n_iters=200, threshold=0.01, seed=0, device=None):
    """RANSAC plane fit. Returns (Plane, inlier mask (N,) numpy bool)."""
    dev = resolve_device(device)
    pts = _points(points, dev)
    n = pts.shape[0]
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(n, 3, replace=False)
                    for _ in range(n_iters)])
    tri = pts[torch.as_tensor(idx, device=dev)]               # (I, 3, 3)
    p0 = tri[:, 0]
    normals = torch.linalg.cross(tri[:, 1] - p0, tri[:, 2] - p0)
    norms = torch.linalg.norm(normals, dim=1)
    ok = norms >= 1e-12
    normals = normals / torch.where(ok, norms, 1.0)[:, None]
    step = max(1, _CHUNK_ELEMS // max(n, 1))
    counts = torch.cat([
        (_distances(pts, p0[i:i + step], normals[i:i + step]) < threshold
         ).sum(1) for i in range(0, n_iters, step)])
    counts = torch.where(ok, counts, -1)
    if not bool(ok.any()):
        raise ValueError("plane_ransac: every sampled triple is collinear")
    best = int(torch.argmax(counts))          # the first of the maxima
    inliers = _distances(pts, p0[best:best + 1],
                         normals[best:best + 1])[0] < threshold
    normal, d = plane_lse(pts[inliers], dev)
    return (Plane((normal[0], normal[1], normal[2], d)),
            inliers.cpu().numpy())
