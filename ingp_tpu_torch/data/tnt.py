"""TanksAndTemples (with background) loader, Playground's
(configs/Playground.txt; counterpart of ingp_tpu/data/tnt.py): prefix
splits (0_ train, 1_ test), intrinsics.txt, the scene scaled by the
largest camera distance, the optional semantic .pgm and mono-depth .npy
channels, and the camera_path / render_train trajectories."""
from __future__ import annotations

import glob
import os

import numpy as np

from ..core.rays import get_ray_directions, normalize, path_rays
from .base import BaseDataset, load_rays
from .color_utils import read_semantic
from .image_io import image_size


def _sort_key(x):
    if len(x) > 2 and x[-10] == "_":
        return x[-9:]
    return x


def _load_c2w(path):
    m = np.loadtxt(path).reshape(-1, 4)
    if len(m) == 3:
        m = np.concatenate([m, [[0, 0, 0, 1.0]]], 0)
    return m


class TNTDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0,
                 cam_scale_factor=0.95, render_train=False, **kwargs):
        super().__init__(root_dir, split, downsample)

        img_dir_name = "images" if os.path.exists(
            os.path.join(root_dir, "images")) else "rgb"
        img_files = sorted(os.listdir(os.path.join(root_dir, img_dir_name)),
                           key=_sort_key)
        if split == "train":
            prefix = "0_"
        elif split == "val":
            prefix = "1_"
        elif "Synthetic" in self.root_dir:
            prefix = "2_"
        else:
            prefix = "1_"  # the real scenes' test views

        def files(folder, ext):
            return sorted(glob.glob(os.path.join(
                self.root_dir, folder, prefix + "*" + ext)), key=_sort_key)

        imgs = files(img_dir_name, ".png")
        semantics = files("semantic", ".pgm") if kwargs.get(
            "use_sem", False) else []
        depths = files("depth", ".npy") if kwargs.get(
            "depth_mono", False) else []
        pose_files = files("pose", ".txt")

        w, h = image_size(os.path.join(root_dir, img_dir_name, img_files[0]))
        w, h = int(w * downsample), int(h * downsample)
        K = np.loadtxt(os.path.join(root_dir, "intrinsics.txt"),
                       dtype=np.float32)
        if K.shape[0] > 4:
            K = K.reshape(4, 4)
        K = K[:3, :3] * downsample
        K[2, 2] = 1.0
        self.K = K
        self.img_wh = (w, h)
        self.directions = get_ray_directions(
            h, w, self.K,
            anti_aliasing_factor=kwargs.get("anti_aliasing_factor", 1.0))

        # -- poses ----------------------------------------------------------
        self.has_render_traj = False
        if split == "test" and not render_train:
            self.has_render_traj = os.path.exists(
                os.path.join(root_dir, "camera_path"))
        c2w = np.stack([_load_c2w(p) for p in pose_files])
        self.up = -normalize(c2w[:, :3, 1].mean(0))
        norm_pose_files = sorted(
            os.listdir(os.path.join(root_dir, "pose")), key=_sort_key)
        norm_poses = np.stack([_load_c2w(os.path.join(root_dir, "pose", x))
                               for x in norm_pose_files])
        scale = np.linalg.norm(norm_poses[..., 3], axis=-1).max()

        render_c2w = None
        if self.has_render_traj or render_train:
            pose_dir = "camera_path/pose" if not render_train else "pose"
            names = sorted(
                [x for x in os.listdir(os.path.join(root_dir, pose_dir))
                 if x.endswith(".txt")], key=lambda x: int(x[-9:-4]))
            all_render = [_load_c2w(os.path.join(root_dir, pose_dir, x))
                          for x in names]
            if render_train:  # three views between each pair of train views
                interp = []
                for i, pose in enumerate(all_render):
                    if len(interp) >= 600:
                        break
                    interp.append(pose)
                    if 0 < i < len(all_render) - 1:
                        nxt = all_render[i + 1]
                        interp += [(pose * 3 + nxt) / 4, (pose + nxt) / 2,
                                   (pose + nxt * 3) / 4]
                all_render = interp
            render_c2w = np.stack(all_render)
            self.c2w = render_c2w
        c2w[..., 3] /= scale
        if render_c2w is not None:
            render_c2w[..., 3] /= scale

        # -- rays -----------------------------------------------------------
        self.poses = np.stack([c2w[i][:3].astype(np.float32)
                               for i in range(len(imgs))])
        self.rays = load_rays(imgs, self.img_wh)
        if "Jade" in self.root_dir or "Fountain" in self.root_dir:
            self.rays[np.all(self.rays <= 0.1, -1)] = 1.0
        if semantics:
            classes = kwargs.get("num_classes", 7)
            self.labels = np.stack([read_semantic(semantics[i], self.img_wh,
                                                  classes)
                                    for i in range(len(imgs))])
        if depths:
            self.depths_2d = np.stack(
                [np.load(d).reshape(-1) for d in depths]).astype(np.float32)
        if (self.has_render_traj or render_train) and \
                not split.startswith("train"):
            self.render_traj_rays = self.get_path_rays(render_c2w)

    def get_path_rays(self, c2w_list):
        """{index: (h*w, 6) rays} along the c2w poses."""
        return path_rays(self.directions, c2w_list)
