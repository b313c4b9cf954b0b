"""One Mega-NeRF image, read when asked (counterpart of
ingp_tpu/data/mega/image_metadata.py): its pixels through the port's own
JPEG / PNG decoder and PIL's Lanczos resize (image_io), its keep mask
from a zipped torch tensor."""
from __future__ import annotations

from zipfile import ZipFile

import numpy as np
import torch

from ..image_io import read_rgb, resize_lanczos, resize_nearest


class ImageMetadata:
    def __init__(self, image_path, c2w, W, H, intrinsics, image_index,
                 mask_path=None, is_val=False):
        self.image_path = image_path
        self.c2w = np.asarray(c2w, np.float32)
        self.W = int(W)
        self.H = int(H)
        self.intrinsics = np.asarray(intrinsics, np.float32)
        self.image_index = image_index
        self._mask_path = mask_path
        self.is_val = is_val

    def load_image(self):
        """(H, W, 3) float32 in [0, 255]: the file as PIL's
        Image.open(p).convert("RGB") reads it, resized with PIL's LANCZOS
        when its size is not (W, H)."""
        rgbs = read_rgb(self.image_path)
        if rgbs.shape[:2] != (self.H, self.W):
            rgbs = resize_lanczos(rgbs, (self.W, self.H))
        return np.asarray(rgbs, np.float32)

    def load_mask(self):
        """(H, W) bool keep mask, or None: the tensor saved (torch.save)
        as the zip member named as the zip itself, resized by the nearest
        pixel when its size is not (W, H)."""
        if self._mask_path is None:
            return None
        with ZipFile(self._mask_path) as zf:
            with zf.open(self._mask_path.name) as f:
                keep = torch.load(f, map_location="cpu").numpy()
        if keep.shape[:2] != (self.H, self.W):
            keep = resize_nearest(keep.astype(np.uint8),
                                  (self.W, self.H)).astype(bool)
        return keep
