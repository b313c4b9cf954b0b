"""Real spherical-harmonics direction encoding, degree <= 4
(counterpart of ingp_tpu/ops/sh.py)."""
from __future__ import annotations

import torch


def sh_encode_cm(d_cm, degree: int):
    """Unit directions, channel-major (3, N) -> (degree**2, N)."""
    return torch.stack(_sh_components(d_cm[0], d_cm[1], d_cm[2], degree), 0)


def sh_encode(d, degree: int):
    """Unit directions (..., 3) -> (..., degree**2)."""
    return torch.stack(_sh_components(d[..., 0], d[..., 1], d[..., 2],
                                      degree), -1)


def _sh_components(x, y, z, degree: int):
    if degree < 1 or degree > 4:
        raise ValueError(f"sh_encode supports degree 1..4, got {degree}")
    out = [torch.full_like(x, 0.28209479177387814)]
    if degree >= 2:
        out += [-0.48860251190291987 * y, 0.48860251190291987 * z,
                -0.48860251190291987 * x]
    if degree >= 3:
        xy, yz, xz = x * y, y * z, x * z
        x2, y2, z2 = x * x, y * y, z * z
        out += [1.0925484305920792 * xy, -1.0925484305920792 * yz,
                0.94617469575755997 * z2 - 0.31539156525252005,
                -1.0925484305920792 * xz, 0.54627421529603959 * (x2 - y2)]
    if degree >= 4:
        out += [
            0.59004358992664352 * y * (-3.0 * x2 + y2),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * z2),
            0.3731763325901154 * z * (5.0 * z2 - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * z2),
            1.4453057213202769 * z * (x2 - y2),
            0.59004358992664352 * x * (-x2 + 3.0 * y2),
        ]
    return out
