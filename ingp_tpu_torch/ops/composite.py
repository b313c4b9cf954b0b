"""Volume compositing on dense (R, S) sample segments (counterpart of
ingp_tpu/ops/composite.py:31,49, forward). Both functions run kernel K3
(kernels/composite.py): a sample contributes iff it is valid and the
transmittance before it exceeds T_threshold, w = (1 - e^{-sigma dt}) T.
"""
from __future__ import annotations

import torch

from ..kernels.composite import composite


def render_weights(sigmas, deltas, valid, T_threshold):
    """(ws (R, S), Ts (R, S)): weights with early stop, and the
    transmittance before each sample."""
    out = composite(sigmas, deltas, torch.zeros_like(sigmas), valid,
                    T_threshold, with_Ts=True)
    return out["ws"], out["Ts"]


def composite_rays(sigmas, rgbs, deltas, ts, valid, T_threshold,
                   normals_pred=None, normals_raw=None, sems=None):
    """Front-to-back composite of every per-sample quantity.

    rgbs, normals (3, R, S) and sems (classes, R, S) are channel-major;
    composited outputs are ray-major (R, C). Returns dict ws, opacity,
    depth, rgb, vr_samples, and normal_pred / normal_raw / semantic when
    given."""
    extras = [(k, v) for k, v in (("normal_pred", normals_pred),
                                  ("normal_raw", normals_raw),
                                  ("semantic", sems)) if v is not None]
    aux = torch.cat([v for _, v in extras], 0).contiguous() \
        if extras else None
    out = composite(sigmas, deltas, ts, valid, T_threshold,
                    rgbs=rgbs.contiguous(), aux=aux)
    res = {"ws": out["ws"], "opacity": out["opacity"],
           "depth": out["depth"], "rgb": out["rgb"],
           "vr_samples": out["count"]}
    c0 = 0
    for k, v in extras:
        res[k] = out["aux"][:, c0:c0 + v.shape[0]]
        c0 += v.shape[0]
    return res
