"""Dense-sampling oracle renderer: no occupancy grid, no compaction
(counterpart of ingp_tpu/models/oracle.py).

A simple renderer that the tests hold the march + compact + composite
path to: stratified depths in the ray's [t1, t2] (optionally warped
exponentially), hierarchical inverse-CDF resampling (`sample_pdf`), and
the per-sample forward composited through `ops/composite.py`. Random
draws come from `core/prng.py` keys, so a key gives the JAX oracle's
draws.
"""
from __future__ import annotations

import torch

from ..core import prng
from ..core.intersect import ray_aabb_intersect
from ..ops.composite import composite_rays
from .ngp import NGPConfig, ngp_forward
from .rendering import clamp_near


def stratified_z(key, t1, t2, n_samples: int, perturb: bool,
                 exp_warp: bool = False):
    """(R,) near / far -> (R, n_samples) sample depths, jittered within
    their strata from `key` when perturb, denser near the camera
    (t1 (t2/t1)^u) with exp_warp."""
    R = t1.shape[0]
    dev = t1.device
    u = torch.linspace(0.0, 1.0, n_samples, device=dev).expand(R, n_samples)
    if perturb:
        mids = 0.5 * (u[:, 1:] + u[:, :-1])
        upper = torch.cat([mids, u[:, -1:]], -1)
        lower = torch.cat([u[:, :1], mids], -1)
        rnd = prng.uniform(key, (R, n_samples), device=dev)
        u = lower + (upper - lower) * rnd
    if exp_warp:
        safe_t1 = torch.clamp(t1, min=1e-4)[:, None]
        return safe_t1 * (t2[:, None] / safe_t1) ** u
    return t1[:, None] + (t2 - t1)[:, None] * u


def sample_pdf(key, bins, weights, n_importance: int, det: bool = False):
    """Inverse-CDF samples (R, n_importance) of the piecewise-constant
    density `weights` (R, M) over the bin edges `bins` (R, M + 1);
    evenly spaced quantiles when det, else uniform draws from `key`."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)   # (R, M+1)
    shape = (cdf.shape[0], n_importance)
    if det:
        u = torch.linspace(0.0, 1.0, n_importance, device=cdf.device
                           ).expand(shape).contiguous()
    else:
        u = prng.uniform(key, shape, device=cdf.device)
    idx = torch.searchsorted(cdf.contiguous(), u)
    below = torch.clamp(idx - 1, 0, cdf.shape[-1] - 1)
    above = torch.clamp(idx, 0, cdf.shape[-1] - 1)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    nb = bins.shape[-1] - 1
    bin_b = torch.gather(bins, -1, torch.clamp(below, 0, nb))
    bin_a = torch.gather(bins, -1, torch.clamp(above, 0, nb))
    denom = torch.where(cdf_a - cdf_b < 1e-5, 1.0, cdf_a - cdf_b)
    t = (u - cdf_b) / denom
    return bin_b + t * (bin_a - bin_b)


@torch.no_grad()
def render_rays_oracle(model_cfg: NGPConfig, params, rays_o, rays_d, key,
                       n_samples: int = 256, perturb: bool = False,
                       exp_warp: bool = False, embedding_a=None):
    """Dense stratified render of R rays (R, 3) through the scene box:
    composite_rays' outputs plus the depths "ts" and intervals "deltas"
    (R, n_samples). embedding_a: (R, embed_a_len) or None."""
    R = rays_o.shape[0]
    dev = rays_o.device
    hits = clamp_near(ray_aabb_intersect(
        rays_o, rays_d, torch.zeros(3, device=dev),
        torch.full((3,), model_cfg.scale, device=dev)))
    t1, t2 = hits[:, 0], hits[:, 1]
    hit = t1 >= 0
    z = stratified_z(key, torch.where(hit, t1, 0.0),
                     torch.where(hit, t2, 1.0), n_samples, perturb, exp_warp)
    deltas = torch.diff(z, dim=-1)
    deltas = torch.cat([deltas, deltas[:, -1:]], -1)
    xyz = rays_o[:, None, :] + z[..., None] * rays_d[:, None, :]
    dirs = rays_d[:, None, :].expand_as(xyz)
    emb = None
    if embedding_a is not None:
        emb = embedding_a[:, None, :].expand(
            R, n_samples, embedding_a.shape[-1]).reshape(R * n_samples, -1)
    sigmas, rgbs, nraw, npred, sems = ngp_forward(
        model_cfg, params, xyz.reshape(-1, 3), dirs.reshape(-1, 3),
        embedding_a=emb)
    valid = hit[:, None].expand(R, n_samples).contiguous()

    def cm(a):
        return a.reshape(R, n_samples, -1).permute(2, 0, 1).contiguous()
    out = composite_rays(sigmas.reshape(R, n_samples).contiguous(), cm(rgbs),
                         deltas.contiguous(), z.contiguous(), valid, 0.0,
                         normals_pred=cm(npred), normals_raw=cm(nraw),
                         sems=cm(sems))
    out["ts"] = z
    out["deltas"] = deltas
    return out
