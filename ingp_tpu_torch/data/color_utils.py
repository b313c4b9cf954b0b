"""Image, normal and semantic reads of the loaders (counterpart of
ingp_tpu/data/color_utils.py:9-60), through the port's own codec
(image_io) where the JAX package calls imageio and cv2: PNG, JPEG and PGM
files are told apart by their first bytes, as imageio tells them."""
from __future__ import annotations

import numpy as np

from .image_io import imread, resize_linear, resize_nearest


def srgb_to_linear(img):
    limit = 0.04045
    return np.where(img > limit, ((img + 0.055) / 1.055) ** 2.4,
                    img / 12.92)


def linear_to_srgb(img):
    limit = 0.0031308
    img = np.where(img > limit, 1.055 * img ** (1 / 2.4) - 0.055,
                   12.92 * img)
    return np.minimum(img, 1.0)  # the "clamp" tonemapper


def _read_unit(path, wh):
    """An image in [0, 1] as float32, alpha blended to white, resized to
    wh (w, h) as cv2.resize does."""
    img = imread(path).astype(np.float32) / 255.0
    if img.ndim == 3 and img.shape[2] == 4:
        img = img[..., :3] * img[..., -1:] + (1 - img[..., -1:])
    return resize_linear(img, wh)


def read_image(img_path, img_wh):
    """RGB(A) image -> (h*w, 3) float32, alpha blended to white."""
    img = _read_unit(img_path, img_wh)
    return img.reshape(-1, img.shape[-1]).astype(np.float32)


def read_normal(norm_path, norm_wh):
    """Normal map -> ((h*w, 3) unit normals, (h*w,) up mask): [0, 1] ->
    [-1, 1], y and z flipped, up where the normal's y exceeds 0.5."""
    norm = _read_unit(norm_path, norm_wh)
    norm = norm.reshape(-1, 3) + 1e-6
    norm = norm * 2.0 - 1.0
    norm[:, 1:] = -norm[:, 1:]
    norm = norm / np.linalg.norm(norm, axis=-1, keepdims=True)
    norm_up = (norm[:, 1] > 0.5).astype(np.float32)
    return norm.astype(np.float32), norm_up


def read_normal_up(img_path, img_wh):
    """Binary up-facing mask image -> (h*w,) float32."""
    img = resize_linear(imread(img_path).astype(np.float32) / 255.0,
                        img_wh)
    return (img.reshape(-1) > 0).astype(np.float32)


def read_semantic(sem_path, sem_wh, classes=7):
    """Semantic labels (.pgm) -> (h*w,) int64, resized by the nearest
    pixel."""
    label = resize_nearest(imread(sem_path).astype(np.uint16), sem_wh)
    return label.reshape(-1).astype(np.int64)
