"""Volume compositing on dense (R, S) sample segments (counterpart of
ingp_tpu/ops/composite.py). `render_weights` and `composite_rays` run
kernel K3 (kernels/composite.py): a sample contributes iff it is valid
and the transmittance before it exceeds T_threshold,
w = (1 - e^{-sigma dt}) T; `composite_rays` is differentiable through
K3's backward. `distortion_loss` and `ref_loss` are plain tensor code
under autograd, as the JAX package leaves them to XLA and AD, and so is
`composite_alpha`, which no render path calls (the JAX package keeps it
as part of the reference's compositing API).
"""
from __future__ import annotations

import torch

from ..kernels.composite import composite


def render_weights(sigmas, deltas, valid, T_threshold):
    """(ws (R, S), Ts (R, S)): weights with early stop, and the
    transmittance before each sample."""
    out = composite(sigmas, deltas, None, valid, T_threshold, with_Ts=True)
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


def distortion_loss(ws, deltas, ts, valid):
    """Mip-NeRF-360 distortion loss per ray (R,):
    sum_s 2 (wts_in ws_ex - ws_in wts_ex) + w^2 dt / 3, with inclusive
    (in) and exclusive (ex) running sums along the samples."""
    w = torch.where(valid, ws, 0.0)
    wt = w * ts
    ws_in = torch.cumsum(w, -1)
    wts_in = torch.cumsum(wt, -1)
    ws_ex = ws_in - w
    wts_ex = wts_in - wt
    per_sample = 2.0 * (wts_in * ws_ex - ws_in * wts_ex) \
        + (1.0 / 3.0) * w * w * torch.where(valid, deltas, 0.0)
    return per_sample.sum(-1)


def ref_loss(sigmas, normals_diff, normals_ori, deltas, valid, T_threshold):
    """Ref-NeRF normal-consistency composites (Ro (R,), Rp (R, 3)) of the
    channel-major squared normal difference (3, R, S) and the back-facing
    penalty (R, S). The caller passes detached sigmas, so the weights
    carry no gradient and these terms shape the normals only."""
    ws, _ = render_weights(sigmas, deltas, valid, T_threshold)
    Rp = (ws[None] * normals_diff).sum(-1).T
    Ro = (ws * normals_ori).sum(-1)
    return Ro, Rp


def composite_alpha(sigmas, deltas, valid):
    """Per-sample alphas and weights without the early stop:
    (alphas (R, S), ws (R, S)), w = (1 - e^{-sigma dt}) T."""
    sd = torch.where(valid, sigmas * deltas, 0.0)
    c = torch.cumsum(sd, -1)
    Ts = torch.exp(-(c - sd))
    alphas = 1.0 - torch.exp(-sd)
    return alphas, torch.where(valid, alphas * Ts, 0.0)
