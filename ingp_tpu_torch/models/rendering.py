"""Rendering (counterpart of ingp_tpu/models/rendering.py).

Training (`render_rays`, :130-317): intersect -> march -> global sample
budget -> kept-count ray sort (unless `stream_sort` is off) ->
compaction -> full forward (stream encoder, the sorted stream with its
head class; the per-ray appearance codes follow the sort and the
compaction to the samples) -> scatter back -> composite (K3) -> Ref-NeRF
composites and distortion -> inverse permute -> with `run_stats`, the
measured run counts of the stream (`stream_runs`) -> background
(`_finish_render`,
:81-93: a fixed or random colour, or the skybox behind its gate, in the
caller's ray order). Differentiable w.r.t. the parameters and, through
the sample positions and directions (the march's t values held fixed),
w.r.t. the rays.

Test (`render_rays_test`, :320-427): intersect -> march -> sigma prepass
-> visibility cut -> full forward -> composite -> skybox background,
without gradients. The reference's alive-ray early exit becomes a cheap
sigma-only prepass over every occupied sample; only samples with
transmittance above T_threshold are compacted into the full network
batch.

A per-ray exposure (R, 1) is refused: the JAX renderer hands it to the
per-sample forward, where its log is added to (K, 1) log radiance, and
that fails to broadcast unless R == K (ingp_tpu/models/rendering.py:219,
ingp_tpu/models/ngp.py:424-427). A single exposure (one element) is
passed through, as JAX broadcasts it.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.intersect import ray_aabb_intersect
from ..ops.composite import (composite_rays, distortion_loss, ref_loss,
                             render_weights)
from ..ops.march import MarchConfig, march_rays_block, march_rays_lattice
from ..ops.pack import (compact_samples, gather_samples, ray_ids_for,
                        scatter_back, scatter_back_cm)
from ..ops.streambrick import run_count_quantiles
from .ngp import (NGPConfig, _normalize_coords, ngp_forward_cm,
                  ngp_forward_skybox, ngp_sigma_cm)

MAX_SAMPLES = 1024
NEAR_DISTANCE = 0.01


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Rendering parameters: the fields of ingp_tpu's RenderConfig that
    the port reads. The port always composites through kernel K3 (no
    pallas_composite); random_bg and stop_header_grads stay out (the
    trainer reads hparams.random_bg and draws the background; training
    never stops the heads' gradients and the test render always does).
    stream_sort: order the training stream's rays by kept count (the
    kept sample set stays that of the unsorted pack); run_stats: report
    the per-level run-count quantiles of the training stream, the input
    of the trainer's cap auto-calibration."""
    exp_step_factor: float = 0.0
    T_threshold: float = 1e-4
    max_samples: int = MAX_SAMPLES
    capacity: int = 192
    march_iters: int = 1024
    samples_per_ray: int = 48
    use_skybox: bool = False
    run_stats: bool = False
    stream_sort: bool = True

    def march_cfg(self, model: NGPConfig) -> MarchConfig:
        return MarchConfig(
            grid_size=model.grid_size, cascades=model.cascades,
            scale=model.scale, exp_step_factor=self.exp_step_factor,
            max_samples=self.max_samples, capacity=self.capacity,
            iters=self.march_iters)


# per-ray result keys of the train renderer that are inverse-permuted
# back to the caller's ray order (ingp_tpu/models/rendering.py:100-118)
_PER_RAY_KEYS = frozenset({
    "ws", "opacity", "depth", "rgb", "vr_samples", "normal_pred",
    "normal_raw", "semantic", "sigmas", "valid", "ts", "deltas",
    "Ro", "Rp", "distortion",
})


def _inv_permute_results(results, inv):
    unknown = set(results) - _PER_RAY_KEYS
    if unknown:
        raise KeyError(f"unclassified per-ray result keys {sorted(unknown)}")
    return {k: v[inv] for k, v in results.items()}


def _check_exposure(exposure):
    if exposure is not None and exposure.numel() != 1:
        raise NotImplementedError(
            f"a per-ray exposure {tuple(exposure.shape)}: the JAX renderer "
            f"adds its log to per-sample log radiance, which fails to "
            f"broadcast (ingp_tpu/models/rendering.py:219, "
            f"ingp_tpu/models/ngp.py:424-427), so the port has no "
            f"reference to hold it to")


def _finish_render(model_cfg, render_cfg, params, results, rays_d,
                   bg_color, skybox_gate):
    """Background in the caller's ray order: rgb + bg (1 - opacity), bg
    the colour bg_color (3,) (none: black), or with the skybox
    gate * sky(rays_d) + (1 - gate) * that colour."""
    R = rays_d.shape[0]
    base_bg = bg_color.expand(R, 3) if bg_color is not None else \
        torch.zeros((R, 3), device=rays_d.device)
    if render_cfg.use_skybox:
        sky = ngp_forward_skybox(model_cfg, params, rays_d)
        rgb_bg = skybox_gate * sky + (1.0 - skybox_gate) * base_bg
    else:
        rgb_bg = base_bg
    results["rgb"] = results["rgb"] \
        + rgb_bg * (1.0 - results["opacity"][:, None])
    return results


def clamp_near(hits_t):
    """Push entry points below NEAR_DISTANCE out to it."""
    t1 = hits_t[:, 0]
    t1 = torch.where((t1 >= 0) & (t1 < NEAR_DISTANCE),
                     torch.full_like(t1, NEAR_DISTANCE), t1)
    return torch.stack([t1, hits_t[:, 1]], -1)


def _march(model_cfg, render_cfg, bitfield, rays_o, rays_d, noise,
           block_table):
    """The march's samples (ts, deltas, valid) of the rays, held fixed
    w.r.t. them: pose refinement's gradient reaches the rays through the
    sample positions o + t d alone. JAX's march takes stop-gradient rays
    too (ingp_tpu/models/rendering.py:160-167) but not its entry points
    hits_t, so for a camera outside the scene's box its t values carry a
    gradient through the box intersection; inside the box the entry
    clamps to NEAR_DISTANCE and carries none (ROADMAP.md Queue 3)."""
    rays_o, rays_d = rays_o.detach(), rays_d.detach()
    dev = rays_o.device
    hits_t = clamp_near(ray_aabb_intersect(
        rays_o, rays_d, torch.zeros(3, device=dev),
        torch.full((3,), model_cfg.scale, device=dev)))
    mcfg = render_cfg.march_cfg(model_cfg)
    if block_table is not None:
        return march_rays_block(mcfg, block_table, rays_o, rays_d, hits_t,
                                noise)
    return march_rays_lattice(mcfg, bitfield, rays_o, rays_d, hits_t, noise)


def render_rays(model_cfg: NGPConfig, render_cfg: RenderConfig, params,
                bitfield, rays_o, rays_d, noise, embedding_a=None,
                exposure=None, bg_color=None, skybox_gate=1.0,
                block_table=None, stats_gate=None):
    """Training render of (R, 3) rays with start jitter noise (R,) in
    [0, 1); differentiable w.r.t. params (and embedding_a).

    embedding_a: (R, embed_a_len) per-ray appearance codes, or None.
    exposure: one exposure (a one-element tensor) or None; a per-ray
      exposure raises (see the module's docstring).
    bg_color: (3,) background colour, or None for black.
    skybox_gate: 0 or 1 (a float or a 0-d tensor); with use_skybox the
      background is gate * skybox + (1 - gate) * bg_color.
    stats_gate: with run_stats, whether to measure the stream's run
      counts this call (None: measure); results then hold "stream_runs"
      (L,) int32 (`streambrick.run_count_quantiles` on the rgb brick
      table's levels).

    Returns the per-ray results of ingp_tpu's render_rays (rgb, depth,
    opacity, normal_pred/raw, semantic, vr_samples, ws/ts/deltas/valid/
    sigmas (R, S) for the losses, Ro, Rp, distortion) and total_samples.
    """
    _check_exposure(exposure)
    R = rays_o.shape[0]
    S = render_cfg.capacity
    K = R * render_cfg.samples_per_ray
    march = _march(model_cfg, render_cfg, bitfield, rays_o, rays_d, noise,
                   block_table)
    ts, deltas, valid = march["ts"], march["deltas"], march["valid"]
    o_cm, d_cm, emb, inv = rays_o.T, rays_d.T, embedding_a, None
    if render_cfg.stream_sort:
        # the global budget first, in compact_samples' sample-major
        # order, so the kept sample set is that of an unsorted pack; then
        # rays by descending kept count (stable, as jnp.argsort), striped
        # over the encoder's chunks so that each chunk sees the whole
        # spectrum (the head class of every chunk holds its longest)
        cum = torch.cumsum(valid.T.reshape(-1).to(torch.int32), 0)
        valid = valid & (cum.reshape(S, R).T <= K)
        perm = torch.argsort(-valid.sum(-1), stable=True)
        nc = max(1, -(-K // model_cfg.encode_chunk))
        if nc > 1:
            perm = torch.cat([perm[c::nc] for c in range(nc)])
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(R, device=perm.device)
        valid, ts, deltas = valid[perm], ts[perm], deltas[perm]
        o_cm, d_cm = o_cm[:, perm], d_cm[:, perm]
        emb = embedding_a[perm] if embedding_a is not None else None
    plan = compact_samples(valid, K)
    rids = ray_ids_for(plan)
    t_k = gather_samples(ts, plan)
    dir_cm = d_cm[:, rids]
    xyz_cm = o_cm[:, rids] + t_k[None] * dir_cm
    emb_k = emb[rids] if emb is not None else None
    sig_k, rgbs_cm, nraw_cm, npred_cm, sems_cm = ngp_forward_cm(
        model_cfg, params, xyz_cm, dir_cm, embedding_a=emb_k,
        exposure=exposure,
        stream="sorted" if render_cfg.stream_sort else True)
    sig_k = torch.where(plan.slot_valid, sig_k, 0.0)
    sigmas = scatter_back(sig_k, plan)
    nraw = scatter_back_cm(nraw_cm, plan)
    npred = scatter_back_cm(npred_cm, plan)
    valid_k = plan.cell_valid.contiguous()
    results = composite_rays(sigmas, scatter_back_cm(rgbs_cm, plan), deltas,
                             ts, valid_k, render_cfg.T_threshold,
                             normals_pred=npred, normals_raw=nraw,
                             sems=scatter_back_cm(sems_cm, plan))
    results.update(ts=ts, deltas=deltas, valid=valid_k, sigmas=sigmas)
    # Ref-NeRF normal consistency on detached weights
    dir_n = dir_cm / torch.clamp(torch.linalg.norm(dir_cm, dim=0,
                                                   keepdim=True), min=1e-6)
    ori_k = torch.clamp((nraw_cm * dir_n).sum(0), min=0.0) ** 2
    results["Ro"], results["Rp"] = ref_loss(
        sigmas.detach(), (nraw - npred) ** 2, scatter_back(ori_k, plan),
        deltas, valid_k, render_cfg.T_threshold)
    results["distortion"] = distortion_loss(results["ws"], deltas, ts,
                                            valid_k)
    if inv is not None:
        results = _inv_permute_results(results, inv)
    results["total_samples"] = march["total_samples"]
    if render_cfg.run_stats and (stats_gate is None or stats_gate):
        # the encoder's own stream (unpadded), on the rgb brick table's
        # levels: its runs bound the density table's too
        results["stream_runs"] = run_count_quantiles(
            model_cfg.rgb_brick_cfg,
            _normalize_coords(model_cfg, xyz_cm.detach()),
            model_cfg.stream_tile)
    return _finish_render(model_cfg, render_cfg, params, results, rays_d,
                          bg_color, skybox_gate)


@torch.no_grad()
def render_rays_test(model_cfg: NGPConfig, render_cfg: RenderConfig, params,
                     bitfield, rays_o, rays_d, embedding_a=None,
                     exposure=None, block_table=None):
    """Inference render of (R, 3) rays with per-ray appearance codes
    embedding_a (R, embed_a_len) or None and one exposure or None:
    normalised normals, argmax semantics and hit points, as ingp_tpu's
    render_rays_test; with use_skybox the skybox fills the background,
    else it is black."""
    _check_exposure(exposure)
    res = _render_rays_test_inner(model_cfg, render_cfg, params, bitfield,
                                  rays_o, rays_d, embedding_a, exposure,
                                  block_table)

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
                            rays_o, rays_d, embedding_a, exposure,
                            block_table=None):
    R = rays_o.shape[0]
    K = R * render_cfg.samples_per_ray
    march = _march(model_cfg, render_cfg, bitfield, rays_o, rays_d,
                   torch.zeros(R, device=rays_o.device), block_table)
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
    emb2 = embedding_a[rids2] if embedding_a is not None else None
    _, rgbs_cm, nraw_cm, npred_cm, sems_cm = ngp_forward_cm(
        model_cfg, params, xyz2_cm, dir2_cm, embedding_a=emb2,
        exposure=exposure, stop_header_grads=True, stream=True)
    pad2 = ~plan2.slot_valid[None]

    def back(v):
        return scatter_back_cm(torch.where(pad2, 0.0, v), plan2)

    results = composite_rays(sigmas, back(rgbs_cm), deltas, ts, visible,
                             render_cfg.T_threshold,
                             normals_pred=back(npred_cm),
                             normals_raw=back(nraw_cm), sems=back(sems_cm))
    results["total_samples"] = march["total_samples"]
    if render_cfg.use_skybox:
        results["rgb"] = results["rgb"] + ngp_forward_skybox(
            model_cfg, params, rays_d) * (1.0 - results["opacity"][:, None])
    return results
