"""Box and guided image filters (counterpart of ingp_tpu/utils/filters.py,
the reference's utils.py:44-82), in numpy without cv2.

`box_filter` is cv2.blur((2r+1, 2r+1)) with BORDER_REFLECT: the image is
padded by repeating its edge pixels mirrored ("fedcba|abcdef|fedcba",
numpy's "symmetric" pad), and each pixel takes the mean of its window,
summed in float64 and rounded to float32.
"""
from __future__ import annotations

import numpy as np


def _window_sums(a, r, axis):
    """Sums of the 2r+1 consecutive elements centred on each index of a
    (padded by r on both sides along axis)."""
    c = np.cumsum(a, axis=axis)
    c = np.concatenate([np.zeros_like(np.take(c, [0], axis=axis)), c],
                       axis=axis)
    n = a.shape[axis] - 2 * r
    hi = np.take(c, np.arange(2 * r + 1, 2 * r + 1 + n), axis=axis)
    lo = np.take(c, np.arange(0, n), axis=axis)
    return hi - lo


def box_filter(image, r):
    """(h, w[, c]) mean filter with a (2r+1) x (2r+1) window, mirrored
    edges; float32."""
    img = np.asarray(image, np.float32)
    k = 2 * r + 1
    pad = [(r, r), (r, r)] + [(0, 0)] * (img.ndim - 2)
    a = np.pad(img.astype(np.float64), pad, mode="symmetric")
    s = _window_sums(_window_sums(a, r, 0), r, 1)
    return (s / (k * k)).astype(np.float32)


def guided_filter(image_p, image_i, r, eps=0.1):
    """He et al.'s guided filter: smooth image_p guided by image_i."""
    p = np.asarray(image_p, np.float32)
    i = np.asarray(image_i, np.float32)
    mean_p = box_filter(p, r)
    mean_i = box_filter(i, r)
    corr_ip = box_filter(i * p, r)
    corr_ii = box_filter(i * i, r)
    var_i = corr_ii - mean_i * mean_i
    cov_ip = corr_ip - mean_i * mean_p
    a = cov_ip / (var_i + eps ** 2)
    b = mean_p - a * mean_i
    return box_filter(a, r) * i + box_filter(b, r)
