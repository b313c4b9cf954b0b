"""NeRF-synthetic (Blender transforms_*.json) loader (counterpart of
ingp_tpu/data/nerf.py)."""
from __future__ import annotations

import json
import os

import numpy as np

from ..core.rays import get_ray_directions
from .base import BaseDataset, load_rays


class NeRFDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0, **kwargs):
        super().__init__(root_dir, split, downsample)
        self.read_intrinsics()
        if kwargs.get("read_meta", True):
            self.read_meta(split)

    def read_intrinsics(self):
        with open(os.path.join(self.root_dir, "transforms_train.json")) as f:
            meta = json.load(f)
        w = h = int(800 * self.downsample)
        fx = fy = 0.5 * 800 / np.tan(0.5 * meta["camera_angle_x"]) \
            * self.downsample
        self.K = np.float32([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]])
        self.directions = get_ray_directions(h, w, self.K)
        self.img_wh = (w, h)

    def read_meta(self, split):
        with open(os.path.join(self.root_dir,
                               f"transforms_{split}.json")) as f:
            meta = json.load(f)
        # the cameras' distance from the origin is normalised to 1.5
        # (1.0 for Easyship)
        pose_radius_scale = 1.0 if "Easyship" in self.root_dir else 1.5
        poses, paths = [], []
        for frame in meta["frames"]:
            c2w = np.array(frame["transform_matrix"], np.float64)[:3, :4]
            if "Jrender" in self.root_dir:
                c2w[:, :2] *= -1
            else:
                c2w[:, 1:3] *= -1  # [right up back] -> [right down front]
            c2w[:, 3] /= np.linalg.norm(c2w[:, 3]) / pose_radius_scale
            poses.append(c2w.astype(np.float32))
            paths.append(os.path.join(self.root_dir,
                                      f"{frame['file_path']}.png"))
        self.rays = load_rays(paths, self.img_wh)
        self.poses = np.stack(poses).astype(np.float32)
