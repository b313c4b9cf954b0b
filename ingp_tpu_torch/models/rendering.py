"""Test-time rendering: intersect -> march -> sigma prepass -> visibility
cut -> full forward -> composite (counterpart of
ingp_tpu/models/rendering.py `render_rays_test`, :320-425).

The reference's alive-ray early exit becomes a cheap sigma-only prepass
over every occupied sample; only samples with transmittance above
T_threshold are compacted into the full network batch.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.intersect import ray_aabb_intersect
from ..ops.composite import composite_rays, render_weights
from ..ops.march import MarchConfig, march_rays_block, march_rays_lattice
from ..ops.pack import (compact_samples, gather_samples, ray_ids_for,
                        scatter_back, scatter_back_cm)
from .ngp import NGPConfig, ngp_forward_cm, ngp_sigma_cm

MAX_SAMPLES = 1024
NEAR_DISTANCE = 0.01


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Rendering parameters of the test render: the fields of ingp_tpu's
    RenderConfig that it reads. The port always composites through
    kernel K3 (no pallas_composite); random_bg, stop_header_grads,
    run_stats and stream_sort matter only to training and come with the
    training slice."""
    exp_step_factor: float = 0.0
    T_threshold: float = 1e-4
    max_samples: int = MAX_SAMPLES
    capacity: int = 192
    march_iters: int = 1024
    samples_per_ray: int = 48
    use_skybox: bool = False

    def march_cfg(self, model: NGPConfig) -> MarchConfig:
        return MarchConfig(
            grid_size=model.grid_size, cascades=model.cascades,
            scale=model.scale, exp_step_factor=self.exp_step_factor,
            max_samples=self.max_samples, capacity=self.capacity,
            iters=self.march_iters)


def clamp_near(hits_t):
    """Push entry points below NEAR_DISTANCE out to it."""
    t1 = hits_t[:, 0]
    t1 = torch.where((t1 >= 0) & (t1 < NEAR_DISTANCE),
                     torch.full_like(t1, NEAR_DISTANCE), t1)
    return torch.stack([t1, hits_t[:, 1]], -1)


@torch.no_grad()
def render_rays_test(model_cfg: NGPConfig, render_cfg: RenderConfig, params,
                     bitfield, rays_o, rays_d, block_table=None):
    """Inference render of (R, 3) rays: normalised normals, argmax
    semantics and hit points, as ingp_tpu's render_rays_test."""
    res = _render_rays_test_inner(model_cfg, render_cfg, params, bitfield,
                                  rays_o, rays_d, block_table)

    def norm(v):
        return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                               min=1e-9)

    return {
        "rgb": res["rgb"],
        "depth": res["depth"],
        "opacity": res["opacity"],
        "normal_pred": norm(res["normal_pred"]),
        "normal_raw": norm(res["normal_raw"]),
        "semantic": torch.argmax(res["semantic"], -1),
        "semantic_probs": res["semantic"],
        "total_samples": res["total_samples"],
        "points": rays_o + rays_d * res["depth"][:, None],
    }


def _render_rays_test_inner(model_cfg, render_cfg, params, bitfield,
                            rays_o, rays_d, block_table=None):
    if render_cfg.use_skybox:
        raise NotImplementedError("the skybox is not ported yet")
    R = rays_o.shape[0]
    K = R * render_cfg.samples_per_ray
    dev = rays_o.device

    hits_t = clamp_near(ray_aabb_intersect(
        rays_o, rays_d, torch.zeros(3, device=dev),
        torch.full((3,), model_cfg.scale, device=dev)))
    mcfg = render_cfg.march_cfg(model_cfg)
    noise = torch.zeros(R, device=dev)
    if block_table is not None:
        march = march_rays_block(mcfg, block_table, rays_o, rays_d, hits_t,
                                 noise)
    else:
        march = march_rays_lattice(mcfg, bitfield, rays_o, rays_d, hits_t,
                                   noise)
    ts, deltas, valid = march["ts"], march["deltas"], march["valid"]
    o_cm, d_cm = rays_o.T, rays_d.T

    # phase 1: sigma-only prepass on every occupied sample
    plan = compact_samples(valid, K)
    rids = ray_ids_for(plan)
    t_k = gather_samples(ts, plan)
    xyz_cm = o_cm[:, rids] + t_k[None] * d_cm[:, rids]
    sig_k = torch.where(plan.slot_valid,
                        ngp_sigma_cm(model_cfg, params, xyz_cm, stream=True),
                        0.0)
    sigmas = scatter_back(sig_k, plan).contiguous()
    valid_k = plan.cell_valid.contiguous()

    # early termination: keep the samples whose transmittance is still
    # above the threshold
    _, Ts = render_weights(sigmas, deltas, valid_k, render_cfg.T_threshold)
    visible = valid_k & (Ts > render_cfg.T_threshold)

    # phase 2: full forward on the visible samples only
    plan2 = compact_samples(visible, K)
    rids2 = ray_ids_for(plan2)
    t_k2 = gather_samples(ts, plan2)
    dir2_cm = d_cm[:, rids2]
    xyz2_cm = o_cm[:, rids2] + t_k2[None] * dir2_cm
    _, rgbs_cm, nraw_cm, npred_cm, sems_cm = ngp_forward_cm(
        model_cfg, params, xyz2_cm, dir2_cm, stream=True)
    pad2 = ~plan2.slot_valid[None]

    def back(v):
        return scatter_back_cm(torch.where(pad2, 0.0, v), plan2)

    results = composite_rays(sigmas, back(rgbs_cm), deltas, ts, visible,
                             render_cfg.T_threshold,
                             normals_pred=back(npred_cm),
                             normals_raw=back(nraw_cm), sems=back(sems_cm))
    results["total_samples"] = march["total_samples"]
    # zero background (the skybox is off): rgb + 0 * (1 - opacity)
    return results
