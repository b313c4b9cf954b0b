"""COLMAP-reconstruction loader (counterpart of ingp_tpu/data/colmap.py):
SIMPLE_RADIAL / PINHOLE / OPENCV intrinsics, every eighth image held out
for test, the spheric test_traj and the B-spline render_traj, optional
semantic labels, and the HDR-NeRF exposure branch (`_hdr_split`)."""
from __future__ import annotations

import glob
import os

import numpy as np

from ..core.rays import (create_spheric_poses, generate_interpolated_path,
                         get_ray_directions, normalize, path_rays)
from .base import BaseDataset, load_rays
from .color_utils import read_semantic
from .colmap_utils import (qvec2rotmat, read_cameras_binary,
                           read_images_binary, read_points3d_binary)

# HDR-NeRF's exposure times per scene, by the image name's last digit
HDR_EXPOSURES = {
    **{s: {e: 1 / 8 * 4 ** e for e in range(5)}
       for s in ("bathroom", "bear", "chair", "desk")},
    **{s: {e: 1 / 16 * 4 ** e for e in range(5)}
       for s in ("diningroom", "dog")},
    "sofa": {0: 0.25, 1: 1, 2: 2, 3: 4, 4: 16},
    "sponza": {0: 0.5, 1: 2, 2: 4, 3: 8, 4: 32},
    "box": {0: 2 / 3, 1: 1 / 3, 2: 1 / 6, 3: 0.1, 4: 0.05},
    "computer": {0: 1 / 3, 1: 1 / 8, 2: 1 / 15, 3: 1 / 30, 4: 1 / 60},
    "flower": {0: 1 / 3, 1: 1 / 6, 2: 0.1, 3: 0.05, 4: 1 / 45},
    "luckycat": {0: 2, 1: 1, 2: 0.5, 3: 0.25, 4: 0.125},
}


class ColmapDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0, **kwargs):
        super().__init__(root_dir, split, downsample)
        self.read_intrinsics(**kwargs)
        if kwargs.get("read_meta", True):
            self.read_meta(split, **kwargs)

    def read_intrinsics(self, **kwargs):
        cam = read_cameras_binary(
            os.path.join(self.root_dir, "sparse/0/cameras.bin"))[1]
        h = int(cam.height * self.downsample)
        w = int(cam.width * self.downsample)
        self.img_wh = (w, h)
        if cam.model == "SIMPLE_RADIAL":
            fx = fy = cam.params[0] * self.downsample
            cx = cam.params[1] * self.downsample
            cy = cam.params[2] * self.downsample
        elif cam.model in ("PINHOLE", "OPENCV"):
            fx = cam.params[0] * self.downsample
            fy = cam.params[1] * self.downsample
            cx = cam.params[2] * self.downsample
            cy = cam.params[3] * self.downsample
        else:
            raise ValueError(f"unsupported camera model {cam.model}")
        self.K = np.float32([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
        self.directions = get_ray_directions(
            h, w, self.K,
            anti_aliasing_factor=kwargs.get("anti_aliasing_factor", 1.0))

    def read_meta(self, split, **kwargs):
        imdata = read_images_binary(
            os.path.join(self.root_dir, "sparse/0/images.bin"))
        img_names = [imdata[k].name for k in imdata]
        perm = np.argsort(img_names)
        if "360" in self.root_dir and self.downsample < 1:
            folder = f"images_{int(1 / self.downsample)}"
            sem_folder = f"semantic_{int(1 / self.downsample)}"
        else:
            folder, sem_folder = "images", "semantic"
        img_paths = [os.path.join(self.root_dir, folder, name)
                     for name in sorted(img_names)]
        sem_paths = [os.path.join(self.root_dir, sem_folder,
                                  os.path.splitext(name)[0] + ".pgm")
                     for name in sorted(img_names)]

        bottom = np.array([[0, 0, 0, 1.0]])
        w2c = []
        for k in imdata:
            im = imdata[k]
            w2c.append(np.concatenate([np.concatenate(
                [qvec2rotmat(im.qvec), im.tvec.reshape(3, 1)], 1), bottom],
                0))
        poses = np.linalg.inv(np.stack(w2c))[perm, :3]  # c2w
        pts3d_rec = read_points3d_binary(
            os.path.join(self.root_dir, "sparse/0/points3D.bin"))
        pts3d = np.array([pts3d_rec[k].xyz for k in pts3d_rec])

        self.poses, self.pts3d = poses, pts3d
        self.up = -normalize(self.poses[:, :3, 1].mean(0))
        scale = np.linalg.norm(self.poses[..., 3], axis=-1).max()
        self.poses[..., 3] /= scale
        self.pts3d /= scale

        if split == "test_traj":
            self.poses = create_spheric_poses(
                1.2, self.poses[:, 1, 3].mean()).astype(np.float32)[:, :3]
            return

        exposures = None
        if "HDR-NeRF" in self.root_dir:
            img_paths, exposures = self._hdr_split(split)
        else:
            if split == "train":
                keep = [i for i in range(len(img_paths)) if i % 8 != 0]
            else:
                keep = [i for i in range(len(img_paths)) if i % 8 == 0]
            render_c2w = self.poses.copy()
            img_paths = [img_paths[i] for i in keep]
            sem_paths = [sem_paths[i] for i in keep]
            self.poses = self.poses[keep]
            if split == "test" and kwargs.get("render_traj", False):
                render_c2w = generate_interpolated_path(
                    self.poses, 120)[400:800]

        self.rays = load_rays(img_paths, self.img_wh,
                              3 if exposures is None else 4)
        if exposures is not None:
            self.rays[..., 3] = np.float32(exposures)[:, None]
        self.poses = self.poses.astype(np.float32)

        if kwargs.get("use_sem", False):
            classes = kwargs.get("num_classes", 7)
            self.labels = np.stack([read_semantic(p, self.img_wh, classes)
                                    for p in sem_paths])
        if split == "test" and "HDR-NeRF" not in self.root_dir:
            self.render_traj_rays = self.get_path_rays(render_c2w)

    def _hdr_split(self, split):
        """HDR-NeRF's image lists and exposure per image: the synthetic
        scenes (syndata, PNG) train on exposures 0, 2, 4 of the last 18
        views and test on 1, 3 of the first 17; the real ones (.jpg)
        alternate views."""
        scene = os.path.basename(os.path.normpath(self.root_dir))
        if "syndata" in self.root_dir:
            self.unit_exposure_rgb = 0.73
            if split == "train":
                img_paths = sorted(glob.glob(os.path.join(
                    self.root_dir, "train/*[024].png")))
                self.poses = np.repeat(self.poses[-18:], 3, 0)
            else:
                img_paths = sorted(glob.glob(os.path.join(
                    self.root_dir, "test/*[13].png")))
                self.poses = np.repeat(self.poses[:17], 2, 0)
        else:
            self.unit_exposure_rgb = 0.5
            d = os.path.join(self.root_dir, "input_images")
            if split == "train":
                img_paths = [p for e in "024" for p in sorted(
                    glob.glob(os.path.join(d, f"*{e}.jpg")))[::2]]
                self.poses = np.tile(self.poses[::2], (3, 1, 1))
            else:
                img_paths = [p for e in "13" for p in sorted(
                    glob.glob(os.path.join(d, f"*{e}.jpg")))[1::2]]
                self.poses = np.tile(self.poses[1::2], (2, 1, 1))
        table = HDR_EXPOSURES.get(scene, {e: 1.0 for e in range(5)})
        exposures = [table[int(os.path.splitext(p)[0][-1])]
                     for p in img_paths]
        return img_paths, exposures

    def get_path_rays(self, c2w_list):
        """{index: (h*w, 6) rays} along the c2w poses."""
        return path_rays(self.directions, c2w_list)
