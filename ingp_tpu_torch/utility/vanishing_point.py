"""Vertical vanishing-point / up-vector estimation (counterpart of
ingp_tpu/utility/vanishing_point.py).

The JAX package detects line segments with OpenCV's LSD, RANSACs the
vertical vanishing point from the near-vertical ones and back-projects
it through the intrinsics to an up direction. The port's LSD is a host
C++ helper (csrc/lsd.cpp: OpenCV's detector at its defaults, segments in
OpenCV's order), which g++ builds at first use into utility/_build/; a
failed build raises. The grey image is cv2's fixed-point RGB2GRAY, and
the RANSAC draws its pairs from numpy's `default_rng(seed)` one
`choice` call per iteration as the JAX package does, then scores every
hypothesis at once on the device (an (iterations, segments) float64
matrix).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..native.build import build_shared

CSRC = Path(__file__).resolve().parent / "csrc" / "lsd.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# cv2's RGB2GRAY on 8-bit (OpenCV 5): (9798 R + 19235 G + 3735 B + 2^14)
# >> 15
GRAY_COEFFS = (9798, 19235, 3735)
_i64, _ptr = ctypes.c_int64, ctypes.c_void_p


def build_helper(force: bool = False) -> Path:
    """The detector's library, compiled by g++ into utility/_build/ first
    when it is missing (or when force is set); raise RuntimeError when
    g++ is missing or fails. No FMA contraction: the detector's float
    arithmetic is OpenCV's, operation for operation."""
    return build_shared(CSRC, BUILD_DIR, "libingp_lsd",
                        "the line segment detector",
                        ("-O2", "-ffp-contract=off"), force)


@functools.lru_cache(maxsize=None)
def load_helper() -> ctypes.CDLL:
    """The helper's library, built first if its source has none."""
    lib = ctypes.CDLL(str(build_helper()))
    lib.ingp_lsd_detect.argtypes = [_ptr, _i64, _i64, _ptr, _i64]
    lib.ingp_lsd_detect.restype = _i64
    return lib


def _u8(gray):
    gray = np.ascontiguousarray(gray)
    if gray.dtype != np.uint8 or gray.ndim != 2:
        raise ValueError(f"the line segment detector takes uint8 (H, W), "
                         f"not {gray.dtype} {gray.shape}")
    return gray


def detect_line_segments(gray):
    """(N, 4) float32 line segments (x1, y1, x2, y2) of a uint8 (H, W)
    image, as cv2.createLineSegmentDetector().detect gives them."""
    gray = _u8(gray)
    h, w = gray.shape
    fn = load_helper().ingp_lsd_detect
    cap = max(64, h * w // 64)
    while True:
        out = np.empty((cap, 4), np.float32)
        n = fn(gray.ctypes.data, h, w, out.ctypes.data, cap)
        if n <= cap:
            return out[:n].copy()
        cap = n


def rgb_to_gray(image):
    """cv2.cvtColor(image, COLOR_RGB2GRAY) of uint8 RGB, bit for bit."""
    rgb = np.asarray(image).astype(np.int32)
    r, g, b = GRAY_COEFFS
    return ((rgb[..., 0] * r + rgb[..., 1] * g + rgb[..., 2] * b
             + (1 << 14)) >> 15).astype(np.uint8)


def _homog_lines(segs):
    """Segments -> homogeneous line coefficients via cross product."""
    p1 = np.concatenate([segs[:, :2], np.ones((len(segs), 1))], 1)
    p2 = np.concatenate([segs[:, 2:], np.ones((len(segs), 1))], 1)
    lines = np.cross(p1, p2)
    return lines / np.linalg.norm(lines[:, :2], axis=1, keepdims=True)


def estimate_vertical_vp(image, angle_tol_deg=25.0, n_iters=500,
                         inlier_tol=2.0, seed=0, device=None):
    """RANSAC the vertical vanishing point from near-vertical segments.

    Returns (vp (3,) homogeneous float64, inlier count) or (None, 0).
    """
    dev = resolve_device(device)
    gray = rgb_to_gray(image) if np.ndim(image) == 3 else image
    segs = detect_line_segments(gray)
    if len(segs) < 2:
        return None, 0
    d = segs[:, 2:] - segs[:, :2]
    ang = np.abs(np.degrees(np.arctan2(d[:, 0], d[:, 1])))
    segs = segs[np.minimum(ang, 180 - ang) < angle_tol_deg]
    if len(segs) < 2:
        return None, 0
    lines = _homog_lines(segs)
    rng = np.random.default_rng(seed)
    pairs = np.stack([rng.choice(len(lines), 2, replace=False)
                      for _ in range(n_iters)])
    L = torch.as_tensor(lines, device=dev)
    vps = torch.linalg.cross(L[pairs[:, 0]], L[pairs[:, 1]])     # (I, 3)
    skip = (vps[:, 2].abs() < 1e-9) & (torch.linalg.norm(vps[:, :2], dim=1)
                                       < 1e-6)
    denom = torch.where(vps[:, 2].abs() > 1e-9, vps[:, 2].abs(), 1e-9)
    err = (L @ vps.T).abs().T / denom[:, None]                   # (I, N)
    counts = torch.where(skip, 0, (err < inlier_tol).sum(1))
    best = int(torch.argmax(counts))          # the first of the maxima
    if int(counts[best]) == 0:
        return None, 0
    return vps[best].cpu().numpy(), int(counts[best])


def estimate_up_vector(image, K, device=None):
    """Up direction in the camera frame from the vertical vanishing
    point: normalize(K^-1 vp), its sign fixed to point screen-up; None
    where no vanishing point is found."""
    vp, _ = estimate_vertical_vp(image, device=device)
    if vp is None:
        return None
    ray = np.linalg.inv(K) @ vp
    n = np.linalg.norm(ray)
    if n < 1e-9:
        return None
    up = ray / n
    if up[1] > 0:  # OpenCV y axis points down
        up = -up
    return up.astype(np.float32)
