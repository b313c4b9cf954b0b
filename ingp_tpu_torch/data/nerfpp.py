"""NeRF++-format loader (counterpart of ingp_tpu/data/nerfpp.py)."""
from __future__ import annotations

import glob
import os

import numpy as np

from ..core.rays import get_ray_directions
from .base import BaseDataset, load_rays
from .image_io import image_size


class NeRFPPDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0, **kwargs):
        super().__init__(root_dir, split, downsample)
        self.read_intrinsics()
        if kwargs.get("read_meta", True):
            self.read_meta(split)

    def read_intrinsics(self):
        K = np.loadtxt(
            glob.glob(os.path.join(self.root_dir,
                                   "train/intrinsics/*.txt"))[0],
            dtype=np.float32).reshape(4, 4)[:3, :3]
        K[:2] *= self.downsample
        w, h = image_size(
            glob.glob(os.path.join(self.root_dir, "train/rgb/*"))[0])
        w, h = int(w * self.downsample), int(h * self.downsample)
        self.K = K.astype(np.float32)
        self.directions = get_ray_directions(h, w, self.K)
        self.img_wh = (w, h)

    def read_meta(self, split):
        if split == "test_traj":
            pose_files = sorted(glob.glob(
                os.path.join(self.root_dir, "camera_path/pose/*.txt")))
            poses = [np.loadtxt(p).reshape(4, 4)[:3] for p in pose_files]
        else:
            if split == "trainval":
                parts = ("train", "val")
            else:
                parts = (split,)
            img_paths = [p for s in parts for p in sorted(glob.glob(
                os.path.join(self.root_dir, s, "rgb/*")))]
            pose_files = [p for s in parts for p in sorted(glob.glob(
                os.path.join(self.root_dir, s, "pose/*.txt")))]
            n = min(len(img_paths), len(pose_files))
            poses = [np.loadtxt(p).reshape(4, 4)[:3]
                     for p in pose_files[:n]]
            self.rays = load_rays(img_paths[:n], self.img_wh)
        self.poses = np.stack(poses).astype(np.float32)
