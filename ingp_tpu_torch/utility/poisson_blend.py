"""Poisson (gradient-domain) image blending (counterpart of
ingp_tpu/utility/poisson_blend.py).

The system is the JAX package's exactly: over the h x w region, 4 on the
diagonal and -1 for each 4-neighbour inside the region; on the right the
source's Laplacian over an edge-padded source, plus, for each neighbour
beyond the region's edge, the target's pixel at that position clipped to
the target (read before the channel is written). That matrix is
T_h (x) I + I (x) T_w with T = tridiag(-1, 2, -1), which the 2-D
discrete sine transform (DST-I) diagonalises exactly: the solve is two
DSTs and a division by the eigenvalues, in float64 on the device, each
DST an FFT of the odd extension of length 2(n + 1) along its axis.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device


def _dst1(x, dim):
    """DST-I along `dim`: y_k = sum_j x_j sin(pi (j+1)(k+1) / (n+1))."""
    x = x.movedim(dim, -1)
    z = torch.zeros_like(x[..., :1])
    v = torch.cat([z, x, z, -x.flip(-1)], -1)
    y = -torch.fft.fft(v, dim=-1).imag[..., 1:x.shape[-1] + 1] / 2
    return y.movedim(-1, dim)


def _clip(i, n):
    return min(max(i, 0), n - 1)


def _eig(n, dev):
    k = torch.arange(1, n + 1, dtype=torch.float64, device=dev)
    return 2.0 - 2.0 * torch.cos(k * (math.pi / (n + 1)))


def poisson_blending(img_src, mask_tblr, img_tar, pos_xy, device=None):
    """Blend img_src[mask region] into img_tar at pos_xy by matching
    source gradients with target boundary conditions.

    mask_tblr: (x_min, x_max, y_min, y_max) region in img_src.
    pos_xy: top-left placement in img_tar. Returns the blended copy of
    img_tar as a float64 numpy array, clipped to [0, 1] where img_tar's
    largest value is at most 1, else to [0, 255].
    """
    dev = resolve_device(device)
    x_min, x_max, y_min, y_max = mask_tblr
    h, w = x_max - x_min, y_max - y_min
    px, py = pos_xy
    tar = torch.as_tensor(np.asarray(img_tar, np.float64), device=dev)
    src = torch.as_tensor(np.asarray(img_src, np.float64)[
        x_min:x_max, y_min:y_max], device=dev).permute(2, 0, 1)
    H, W = tar.shape[:2]
    # the source's Laplacian, edge-padded
    s = torch.nn.functional.pad(src[None], (1, 1, 1, 1), mode="replicate")[0]
    b = (4 * src - s[:, :-2, 1:-1] - s[:, 2:, 1:-1] - s[:, 1:-1, :-2]
         - s[:, 1:-1, 2:])
    # the target beyond each edge of the region, at clipped positions
    t = tar.permute(2, 0, 1)
    rows = torch.arange(px, px + h, device=dev).clamp(0, H - 1)
    cols = torch.arange(py, py + w, device=dev).clamp(0, W - 1)
    b[:, h - 1, :] += t[:, _clip(px + h, H)][:, cols]
    b[:, 0, :] += t[:, _clip(px - 1, H)][:, cols]
    b[:, :, w - 1] += t[:, rows, _clip(py + w, W)]
    b[:, :, 0] += t[:, rows, _clip(py - 1, W)]
    # A = T_h (x) I + I (x) T_w, solved through the 2-D DST-I
    lam = _eig(h, dev)[:, None] + _eig(w, dev)[None, :]
    sol = _dst1(_dst1(_dst1(_dst1(b, 1), 2) / lam, 1), 2) \
        * (4.0 / ((h + 1) * (w + 1)))
    out = tar.clone()
    out[px:px + h, py:py + w] = sol.permute(1, 2, 0)
    hi = 1.0 if np.max(img_tar) <= 1.0 else 255.0
    return torch.clamp(out, 0.0, hi).cpu().numpy()
