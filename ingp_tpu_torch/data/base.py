"""Dataset container (counterpart of ingp_tpu/data/base.py): training
batches (`sample_batch`) and whole test images (`test_item`). Plain
numpy, no framework dependency. `load_rays` reads a split's images
straight into one stacked array."""
from __future__ import annotations

import numpy as np

from .color_utils import read_image


def load_rays(img_paths, img_wh, channels=3):
    """(N, h*w, channels) float32 of the images at img_paths, each read
    (alpha blended to white, resized to img_wh) into its slot of one
    array allocated up front: the JAX loaders' np.stack of a list,
    without the list's copy (100 views at 800x800 are 768 MB). Channels
    past the third are left for the caller to fill."""
    if not img_paths:
        raise ValueError("no images to load")
    w, h = img_wh
    rays = np.empty((len(img_paths), w * h, channels), np.float32)
    for i, path in enumerate(img_paths):
        rays[i, :, :3] = read_image(path, img_wh)
    return rays


class BaseDataset:
    def __init__(self, root_dir, split="train", downsample=1.0):
        self.root_dir = root_dir
        self.split = split
        self.downsample = downsample
        self.rays = np.zeros((0, 0, 3), np.float32)
        self.poses = np.zeros((0, 3, 4), np.float32)
        self.batch_size = 8192
        self.ray_sampling_strategy = "all_images"

    def __len__(self):
        if self.split.startswith("train"):
            return 1000
        return len(self.poses)

    @property
    def n_images(self):
        return len(self.poses)

    def sample_batch(self, rng: np.random.Generator, batch_size=None,
                     strategy=None):
        """One training batch of batch_size rays: img_idxs, pix_idxs, uv,
        rgb, and label / depth / normal / exposure where the dataset has
        them (ingp_tpu/data/base.py:38-72; the same draws from the same
        numpy Generator)."""
        bs = batch_size or self.batch_size
        strategy = strategy or self.ray_sampling_strategy
        if strategy == "all_images":
            img_idxs = rng.integers(0, len(self.poses), bs)
        elif strategy == "same_image":
            img_idxs = np.full(bs, rng.integers(0, len(self.poses)),
                               np.int64)
        else:
            raise ValueError(f"unknown strategy {strategy}")
        w, h = self.img_wh
        pix_idxs = rng.integers(0, w * h, bs)
        rays = self.rays[img_idxs, pix_idxs]
        sample = {
            "img_idxs": img_idxs.astype(np.int32),
            "pix_idxs": pix_idxs.astype(np.int32),
            "uv": np.stack([pix_idxs // w, pix_idxs % w], -1
                           ).astype(np.float32),
            "rgb": rays[:, :3],
        }
        for attr, key in (("labels", "label"), ("depths_2d", "depth"),
                          ("normals", "normal")):
            if hasattr(self, attr):
                sample[key] = getattr(self, attr)[img_idxs, pix_idxs]
        if self.rays.shape[-1] == 4:
            sample["exposure"] = rays[:, 3:]
        return sample

    def test_item(self, idx):
        """Whole-image sample for evaluation: pose, img_idxs, and rgb,
        label, depth and the image's exposure (its first pixel's) where
        the dataset has them (ingp_tpu/data/base.py:74-86)."""
        sample = {"pose": self.poses[idx], "img_idxs": idx}
        if len(self.rays) > 0:
            rays = self.rays[idx]
            sample["rgb"] = rays[:, :3]
            if hasattr(self, "labels"):
                sample["label"] = self.labels[idx]
            if hasattr(self, "depths_2d"):
                sample["depth"] = self.depths_2d[idx]
            if rays.shape[1] == 4:
                sample["exposure"] = rays[0, 3]
        return sample
