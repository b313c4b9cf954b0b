"""The in-memory Mega-NeRF ray store (counterpart of
ingp_tpu/data/mega/memory_dataset.py): every image's rays with the same
altitude-clamped bounds as the filesystem store, its keep mask applied,
in three flat arrays, behind FilesystemDataset's sampling surface
(load_chunk / get_state / set_state do nothing: there is one chunk)."""
from __future__ import annotations

import numpy as np

from .ray_utils import get_ray_directions, get_rays


class MemoryDataset:
    def __init__(self, metadata_items, near, far, ray_altitude_range,
                 center_pixels):
        rgbs, rays, indices = [], [], []
        for item in metadata_items:
            image_rgbs = item.load_image().reshape(-1, 3) / 255.0
            dirs = get_ray_directions(item.W, item.H,
                                      *item.intrinsics[:4],
                                      center_pixels)
            image_rays = get_rays(dirs, item.c2w, near, far,
                                  ray_altitude_range).reshape(-1, 8)
            keep = item.load_mask()
            img_idx = np.full(len(image_rgbs), item.image_index, np.int32)
            if keep is not None:
                m = keep.reshape(-1)
                image_rgbs, image_rays, img_idx = (
                    image_rgbs[m], image_rays[m], img_idx[m])
            rgbs.append(image_rgbs.astype(np.float32))
            rays.append(image_rays)
            indices.append(img_idx)

        self._rgbs = np.concatenate(rgbs)
        self._rays = np.concatenate(rays)
        self._img_indices = np.concatenate(indices)

    def load_chunk(self):
        pass

    def get_state(self):
        return None

    def set_state(self, chosen):
        pass

    def __len__(self):
        return self._rgbs.shape[0]

    def __getitem__(self, idx):
        return {"rgbs": self._rgbs[idx],
                "rays": self._rays[idx],
                "img_indices": self._img_indices[idx]}

    def sample_batch(self, rng, batch_size):
        idx = rng.integers(0, len(self), batch_size)
        return self[idx]
