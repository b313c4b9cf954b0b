"""Dataset container (counterpart of ingp_tpu/data/base.py, the parts
the test render needs). Plain numpy, no framework dependency."""
from __future__ import annotations

import numpy as np


class BaseDataset:
    def __init__(self, root_dir, split="train", downsample=1.0):
        self.root_dir = root_dir
        self.split = split
        self.downsample = downsample
        self.rays = np.zeros((0, 0, 3), np.float32)
        self.poses = np.zeros((0, 3, 4), np.float32)

    def __len__(self):
        if self.split.startswith("train"):
            return 1000
        return len(self.poses)

    @property
    def n_images(self):
        return len(self.poses)

    def test_item(self, idx):
        """Whole-image sample for evaluation."""
        sample = {"pose": self.poses[idx], "img_idxs": idx}
        if len(self.rays) > 0:
            rays = self.rays[idx]
            sample["rgb"] = rays[:, :3]
            if hasattr(self, "labels"):
                sample["label"] = self.labels[idx]
        return sample
