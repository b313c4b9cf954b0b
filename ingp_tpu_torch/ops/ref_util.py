"""Ref-NeRF utilities (counterpart of ingp_tpu/ops/ref_util.py): the
reflection of a view direction about a normal and the integrated
directional encoding (Ref-NeRF eq. 6-8: spherical harmonics of the
reflected direction attenuated by the von Mises-Fisher concentration).
The coefficient tables are numpy, computed once per degree."""
from __future__ import annotations

import math

import numpy as np
import torch


def reflect(viewdirs, normals):
    """u = 2 (n . v) n - v along the last axis."""
    return 2.0 * (normals * viewdirs).sum(-1, keepdim=True) * normals \
        - viewdirs


def generalized_binomial_coeff(a, k):
    return np.prod(a - np.arange(k)) / math.factorial(k)


def assoc_legendre_coeff(l, m, k):
    """Coefficient of cos^k sin^m in P_l^m."""
    return ((-1) ** m * 2 ** l * math.factorial(l) / math.factorial(k)
            / math.factorial(l - k - m)
            * generalized_binomial_coeff(0.5 * (l + k + m - 1.0), l))


def sph_harm_coeff(l, m, k):
    return (np.sqrt((2.0 * l + 1.0) * math.factorial(l - m)
                    / (4.0 * np.pi * math.factorial(l + m)))
            * assoc_legendre_coeff(l, m, k))


def get_ml_array(deg_view):
    """(2, n) array of the (m, l) pairs the encoding uses, l = 1, 2, 4, ..."""
    ml_list = []
    for i in range(deg_view):
        l = 2 ** i
        for m in range(l + 1):
            ml_list.append((m, l))
    return np.array(ml_list).T


def _int_pow(z, m: int):
    """z ** m for a complex tensor and an integer m >= 0, by products."""
    out = torch.ones_like(z)
    for _ in range(m):
        out = out * z
    return out


def generate_ide_fn(deg_view):
    """The integrated directional encoding fn(xyz (..., 3), kappa_inv
    (..., 1)) -> (..., 2 * n): real parts, then imaginary parts."""
    if deg_view > 5:
        raise ValueError("Only deg_view of at most 5 is numerically "
                         "stable.")
    ml_array = get_ml_array(deg_view)
    l_max = 2 ** (deg_view - 1)
    mat = np.zeros((l_max + 1, ml_array.shape[1]))
    for i, (m, l) in enumerate(ml_array.T):
        for k in range(l - m + 1):
            mat[k, i] = sph_harm_coeff(l, m, k)
    m_pow = [int(m) for m in ml_array[0]]
    sigma = (0.5 * ml_array[1] * (ml_array[1] + 1)).astype(np.float32)
    mat32 = mat.astype(np.float32)

    def integrated_dir_enc_fn(xyz, kappa_inv):
        x, y, z = xyz[..., 0:1], xyz[..., 1:2], xyz[..., 2:3]
        vmz = torch.cat([z ** i for i in range(mat.shape[0])], -1)
        xy = torch.complex(x, y)
        vmxy = torch.cat([_int_pow(xy, m) for m in m_pow], -1)
        sph = vmxy * (vmz @ torch.as_tensor(mat32, device=xyz.device)
                      ).to(vmxy.dtype)
        ide = sph * torch.exp(-torch.as_tensor(sigma, device=xyz.device)
                              * kappa_inv)
        return torch.cat([ide.real, ide.imag], -1)

    return integrated_dir_enc_fn
