"""The Mega-NeRF loader (counterpart of ingp_tpu/data/mega/dataset.py):
a frame window of the train images in memory, the poses remapped from
Mega-NeRF's axes to OpenCV's and centred, and an interpolated camera path;
plus `load_filesystem_dataset`, the entry point of the out-of-core ray
store.

A scene is Mega-NeRF's tree: coordinates.pt (origin_drb,
pose_scale_factor) and {train,val}/metadata/NNNNNN.pt (W, H, c2w,
intrinsics, distortion), each with its image in {train,val}/rgbs/ (.jpg,
.JPG, .png or .PNG, tried in that order). The .pt files load through
torch.load(weights_only=False), as the JAX package loads them.

As in JAX: MegaDataset ignores `split` (its test split is its train
frames), reads the frame window from the keywords mega_frame_start /
mega_frame_end (default 0-10), which the trainers never pass, and every
item is built with is_val=True (ROADMAP.md Queue 3)."""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ...core.rays import (generate_interpolated_path, get_ray_directions,
                          path_rays)
from ..base import BaseDataset
from .image_metadata import ImageMetadata


def _load_pt(path):
    """A torch-saved dict with its tensors as numpy arrays."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    return {k: (v.numpy() if hasattr(v, "numpy") else v)
            for k, v in obj.items()}


def get_metadata_item(metadata_path: Path, image_index: int,
                      scale_factor: int, is_val: bool) -> ImageMetadata:
    """The ImageMetadata of one metadata .pt, its size and intrinsics
    divided by scale_factor, its image the first of .jpg, .JPG, .png,
    .PNG beside it in rgbs/."""
    image_path = None
    for ext in (".jpg", ".JPG", ".png", ".PNG"):
        cand = metadata_path.parent.parent / "rgbs" / \
            f"{metadata_path.stem}{ext}"
        if cand.exists():
            image_path = cand
            break
    if image_path is None:
        raise FileNotFoundError(f"no rgbs/{metadata_path.stem}.(jpg|JPG|"
                                f"png|PNG) beside {metadata_path}")
    meta = _load_pt(metadata_path)
    return ImageMetadata(image_path, meta["c2w"],
                         meta["W"] // scale_factor,
                         meta["H"] // scale_factor,
                         np.asarray(meta["intrinsics"]) / scale_factor,
                         image_index, None, is_val)


def _collect(train_paths, val_paths, scale_factor):
    """(train items, val items), indexed by name over train then val;
    every item flagged is_val=True, as the JAX package flags them."""
    image_indices = {p.name: i
                     for i, p in enumerate(train_paths + val_paths)}
    train = [get_metadata_item(p, image_indices[p.name], scale_factor,
                               True) for p in train_paths]
    val = [get_metadata_item(p, image_indices[p.name], scale_factor, True)
           for p in val_paths]
    return train, val


def get_image_metadata(dataset_path, scale_factor=1, train_every=20):
    """(train items, val items): every train_every-th train image and all
    of val."""
    dataset_path = Path(dataset_path)
    cand = sorted((dataset_path / "train" / "metadata").iterdir())
    train_paths = [cand[i] for i in range(0, len(cand), train_every)]
    val_paths = sorted((dataset_path / "val" / "metadata").iterdir())
    train_paths.sort(key=lambda x: x.name)
    return _collect(train_paths, val_paths, scale_factor)


def get_image_metadata_partial(dataset_path, start, end, scale_factor=1):
    """(train items, val items): the train images from the one whose name
    holds the six-digit start to the one that holds end (from the first,
    to the last, where none does), and all of val."""
    dataset_path = Path(dataset_path)
    cand = sorted((dataset_path / "train" / "metadata").iterdir())
    start_id, end_id = 0, len(cand)
    for i, p in enumerate(cand):
        if "{:0>6d}".format(start) in p.name:
            start_id = i
        if "{:0>6d}".format(end) in p.name:
            end_id = i + 1
    train_paths = cand[start_id:end_id]
    val_paths = sorted((dataset_path / "val" / "metadata").iterdir())
    return _collect(train_paths, val_paths, scale_factor)


# Mega-NeRF's poses are x right, y up, z back after the column swap below;
# this swaps the world's x and y and flips z, to OpenCV's axes
_ROT = np.array([[0, 1, 0], [1, 0, 0], [0, 0, -1]], np.float32)


class MegaDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=0.25,
                 train_every=6, **kwargs):
        super().__init__(root_dir, split, downsample)
        scale_factor = int(1 / downsample)
        start = kwargs.get("mega_frame_start", 0)
        end = kwargs.get("mega_frame_end", 10)
        items, _ = get_image_metadata_partial(
            root_dir, start=start, end=end, scale_factor=scale_factor)

        item = items[0]
        h, w = item.H, item.W
        self.img_wh = (w, h)
        fx, fy, sx, sy = item.intrinsics[:4]
        self.K = np.float32([[fx, 0, sx], [0, fy, sy], [0, 0, 1]])
        self.directions = get_ray_directions(
            h, w, self.K,
            anti_aliasing_factor=kwargs.get("anti_aliasing_factor", 1.0))

        poses = []
        self.rays = np.empty((len(items), w * h, 3), np.float32)
        for i, item in enumerate(items):
            self.rays[i] = (item.load_image() / 255.0).reshape(-1, 3)
            c2w = item.c2w
            c2w = np.concatenate([-c2w[:, 1:2], c2w[:, 0:1], c2w[:, 2:]],
                                 -1)
            c2w = np.concatenate(
                [_ROT @ c2w[:3, :3] @ np.linalg.inv(_ROT),
                 _ROT @ c2w[:3, 3:]], -1)
            poses.append(c2w)
        poses = np.stack(poses).astype(np.float32)
        poses[:, :, -1] -= poses[:, :, -1].mean(0, keepdims=True)

        self.poses = poses
        render_poses = generate_interpolated_path(poses, n_interp=4)
        self.render_traj_rays = self.get_path_rays(render_poses)

    def get_path_rays(self, c2w_list):
        """{index: (h*w, 6) rays} along the c2w poses."""
        return path_rays(self.directions, c2w_list)


def load_filesystem_dataset(dataset_path, near=1.0, far=1e5,
                            ray_altitude_range=None, center_pixels=True,
                            chunk_paths=None, num_chunks=200,
                            scale_factor=1, disk_flush_size=10_000_000,
                            split="train"):
    """The out-of-core store of a scene's train (or val) split: every
    20th train image, near and far divided by coordinates.pt's
    pose_scale_factor, chunks under chunk_paths."""
    from .filesystem_dataset import FilesystemDataset
    train_items, val_items = get_image_metadata(
        dataset_path, scale_factor=scale_factor)
    items = train_items if split == "train" else val_items
    coord = _load_pt(Path(dataset_path) / "coordinates.pt")
    pose_scale_factor = coord["pose_scale_factor"]
    return FilesystemDataset(
        items, near / pose_scale_factor, far / pose_scale_factor,
        ray_altitude_range, center_pixels,
        [Path(x) for x in sorted(chunk_paths)], num_chunks, scale_factor,
        disk_flush_size)
