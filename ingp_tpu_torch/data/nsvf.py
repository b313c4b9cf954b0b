"""NSVF-format loader: Synthetic-NSVF, Synthetic-NeRF (lego's
configs/lego.txt), BlendedMVS and TanksAndTemples (counterpart of
ingp_tpu/data/nsvf.py)."""
from __future__ import annotations

import glob
import os

import numpy as np

from ..core.rays import get_ray_directions
from .base import BaseDataset, load_rays


class NSVFDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0, **kwargs):
        super().__init__(root_dir, split, downsample)
        self.read_intrinsics()
        if kwargs.get("read_meta", True):
            xyz_min, xyz_max = np.loadtxt(
                os.path.join(root_dir, "bbox.txt"))[:6].reshape(2, 3)
            self.shift = (xyz_max + xyz_min) / 2
            self.scale = (xyz_max - xyz_min).max() / 2 * 1.05
            # the scenes' own fudge factors
            if "Mic" in self.root_dir:
                self.scale *= 1.2
            elif "Lego" in self.root_dir:
                self.scale *= 1.1
            self.read_meta(split)

    def read_intrinsics(self):
        if "Synthetic" in self.root_dir or "Ignatius" in self.root_dir:
            with open(os.path.join(self.root_dir, "intrinsics.txt")) as f:
                fx = fy = float(f.readline().split()[0]) * self.downsample
            if "Synthetic" in self.root_dir:
                w = h = int(800 * self.downsample)
            else:
                w, h = int(1920 * self.downsample), int(1080 * self.downsample)
            K = np.float32([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]])
        else:
            K = np.loadtxt(os.path.join(self.root_dir, "intrinsics.txt"),
                           dtype=np.float32)[:3, :3]
            if "BlendedMVS" in self.root_dir:
                w, h = int(768 * self.downsample), int(576 * self.downsample)
            elif "Tanks" in self.root_dir:
                w, h = int(1920 * self.downsample), int(1080 * self.downsample)
            else:
                raise ValueError(
                    f"cannot infer image size for {self.root_dir}")
            K[:2] *= self.downsample
        self.K = K.astype(np.float32)
        self.directions = get_ray_directions(h, w, self.K)
        self.img_wh = (w, h)

    def _norm_pose(self, c2w):
        c2w = c2w.copy()
        c2w[:, 3] -= self.shift
        c2w[:, 3] /= 2 * self.scale  # the scene inside [-0.5, 0.5]
        return c2w

    def read_meta(self, split):
        poses = []
        if split == "test_traj":  # BlendedMVS / TanksAndTemples paths
            if "Ignatius" in self.root_dir:
                pose_files = sorted(glob.glob(
                    os.path.join(self.root_dir, "test_pose/*.txt")))
                traj = [np.loadtxt(p) for p in pose_files]
            else:
                traj = np.loadtxt(
                    os.path.join(self.root_dir, "test_traj.txt")
                ).reshape(-1, 4, 4)
            for pose in traj:
                c2w = np.array(pose, np.float64)[:3]
                c2w[:, 0] *= -1  # [left down front] -> [right down front]
                poses.append(self._norm_pose(c2w).astype(np.float32))
        else:
            if split == "train":
                prefix = "0_"
            elif split == "trainval":
                prefix = "[0-1]_"
            elif split == "val":
                prefix = "1_"
            elif "Synthetic" in self.root_dir:
                prefix = "2_"
            elif split == "test":
                prefix = "1_"
            else:
                raise ValueError(f"{split} split not recognized!")
            img_paths = sorted(glob.glob(
                os.path.join(self.root_dir, "rgb", prefix + "*.png")))
            pose_files = sorted(glob.glob(
                os.path.join(self.root_dir, "pose", prefix + "*.txt")))
            n = min(len(img_paths), len(pose_files))
            for pose in pose_files[:n]:
                c2w = np.loadtxt(pose)[:3]
                poses.append(self._norm_pose(c2w).astype(np.float32))
            self.rays = load_rays(img_paths[:n], self.img_wh)
            if "Jade" in self.root_dir or "Fountain" in self.root_dir:
                # a black background -> white
                self.rays[np.all(self.rays <= 0.1, -1)] = 1.0
        self.poses = np.stack(poses).astype(np.float32)
