"""The snow-seeding sampler (counterpart of ingp_tpu/data/snow.py,
`SnowSeed`): a grid of downward rays launched from a plane above the
scene, to seed particles onto up-facing surfaces. Outside the dataset
registry, as in JAX."""
from __future__ import annotations

import numpy as np


class SnowSeed:
    def __init__(self, up, height, R, interval=0.01, range_=2.0,
                 batch_size=8192):
        up = np.asarray(up, np.float32)
        self.up = up / np.linalg.norm(up)
        self.height = float(height)
        self.batch_size = batch_size

        principle = self.up * self.height
        resolution = int(2 * range_ / interval)
        ax = np.linspace(-range_, range_, resolution, dtype=np.float32)
        u, v = np.meshgrid(ax, ax)
        self.coord_2d = np.stack([u, v], -1).reshape(-1, 2)
        zeros = np.zeros_like(u)
        rays_o = np.stack([u, zeros, v], -1).reshape(-1, 3, 1)
        R = np.asarray(R, np.float32)
        self.rays_o = (R @ rays_o).reshape(-1, 3) + principle
        self.rays_d = -self.up

    def __len__(self):
        return 1000

    def sample_batch(self, rng: np.random.Generator, batch_size=None):
        """batch_size rays drawn with replacement: origins, the one
        downward direction, and their (u, v) on the plane."""
        bs = batch_size or self.batch_size
        idx = rng.integers(0, len(self.rays_o), bs)
        return {
            "rays_o": self.rays_o[idx],
            "rays_d": np.broadcast_to(self.rays_d, (bs, 3)).copy(),
            "coord_2d": self.coord_2d[idx],
        }
