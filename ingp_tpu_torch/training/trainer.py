"""Training system (counterpart of ingp_tpu/training/trainer.py): the
hparams -> config mapping (:46-113), and `NeRFSystem` on one device or
over a data-parallel `World` -- parameters, optimiser, occupancy grid,
the training step (:233-406) with
the sparsity prior (:279-295), the model features (appearance
embeddings, the transient mask, the random background, the skybox behind
its warmup gate, the HDR unit-exposure anchor, pose refinement
(`optimize_ext`: :165-181, :251-256); :261-315), the grid
refresh cadence, `render_image` (:584-658), `validate` (:660-707), the
training loop `fit` (:709-834) and the checkpoint state (:864-935).

The step is eager PyTorch: render_rays, the losses, autograd (the
encoders' and the composite's backward are kernels K1, K2 and K3 bwd),
then optax's chain clip_by_global_norm(50) -> adam(cosine decay,
eps 1e-8) written out: the clip by hand (optax scales by 50/|g| only
when |g| >= 50, with no epsilon), torch.optim.Adam for the moments, and
the learning rate of update t computed from t, the count of updates
before it. With `optimize_ext` the per-image pose corrections
params["ext"] = {"dR", "dT"} (zeros, (N_images, 3)) rotate and shift the
batch's poses before the rays are cast, and take their own constant Adam
at 1e-6 after the shared clip (optax.multi_transform in JAX): the
second parameter group of the optimiser. Their gradient reaches them
through the sample positions; the march's t values are held fixed (see
`models/rendering.py`). With `stream_autocal` (and stream dedup) the
stream's caps come from the measured run counts of the training batches
(`_maybe_grow_stream_caps`, :495-545), and ride the checkpoints. The
loop writes the JAX loop's validation images (`_dump_val_images`,
:836-861) and draws its batches from the native sampler (`native/`,
:726-737) unless told otherwise.

Data parallelism (JAX's shard_map step, :231-398): with a `World` of n
ranks (`parallel/mesh.py`) every rank runs the per-ray pipeline on its
shard of the rays (R/n rays, an R/n-scaled sample budget, its own
compaction plan and stream), with its slice of the ray noise drawn over
the global batch and of the sparsity prior's points; loss, mse,
s_per_ray, the loss terms and every gradient leaf are averaged over the
ranks (stream_runs takes the maximum), and clip and Adam then run on
every rank on the same averaged gradients, so the parameters stay
replicated. After each grid refresh rank 0's grid is broadcast. With
--num_gpus one global batch of batch_size rays is split n ways; with
--distributed (`world.feeds_own_batch`) each rank feeds its own
batch_size rays. The test render then splits each chunk over the ranks
(--num_gpus) or `validate` deals the views round-robin (--distributed).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time

import numpy as np
import torch

from ..core import prng
from ..core.rays import axisangle_to_R, get_rays
from ..device import resolve_device
from ..grid.occupancy import (grid_draws, grid_init, mark_invisible_cells,
                              update_density_grid)
from ..models.implicit_mask import mask_apply, mask_init
from ..models.ngp import (NGPConfig, hash_layout, log_radiance_to_rgb,
                          ngp_init, ngp_sigma, ngp_sigma_cm,
                          params_from_numpy, params_to_numpy, tree_map)
from ..models.rendering import (MAX_SAMPLES, RenderConfig, render_rays,
                                render_rays_test)
from ..ops.march import build_block_table
from ..ops.streambrick import stream_caps
from ..parallel.distributed import all_gather_metrics, broadcast_int
from ..parallel.mesh import (all_reduce_max, all_reduce_mean, barrier,
                             broadcast_tree, gather_rows, shard_batch)
from ..render.offline import render_chunks
from ..utils.ckpt import (AsyncCkptManager, load_ckpt, save_ckpt,
                          slim_state, step_state_path)
from ..utils.loggers import make_logger
from .losses import LossConfig, compute_losses, total_loss
from .metrics import mse, psnr, ssim

REAL_DATASETS = ("colmap", "nerfpp", "tnt", "kitti", "mega", "highbay")
SPARSITY_POINTS = 16384     # uniform points of the sparsity prior
VAL_DUMP_EVERY = 10000      # the JAX loop's validation image cadence
EXT_LR = 1e-6               # the pose corrections' constant Adam rate
PROFILE_STEPS = (20, 30)    # profile_dir's window after fit's first step


def model_config_from_hparams(h) -> NGPConfig:
    """The JAX trainer's mapping; optional attrs override the flagship
    encoder op-point."""
    return NGPConfig(
        scale=h.scale,
        rgb_act="none" if h.use_exposure else "sigmoid",
        use_skybox=h.use_skybox,
        embed_a=h.embed_a,
        embed_a_len=h.embed_a_len,
        classes=h.num_classes,
        compute_dtype=getattr(h, "compute_dtype", "float32"),
        grid_size=getattr(h, "grid_size", 128),
        density_L=getattr(h, "density_L", 16),
        density_F=getattr(h, "density_F", 8),
        density_log2T=getattr(h, "density_log2T", 19),
        rgb_L=getattr(h, "rgb_L", 16),
        rgb_F=getattr(h, "rgb_F", 8),
        rgb_log2T=getattr(h, "rgb_log2T", 21),
        encoder=getattr(h, "encoder", "hash"),
        table_dtype=getattr(h, "table_dtype", "float32"),
        encode_chunk=getattr(h, "encode_chunk", 16384),
        stream_dedup=getattr(h, "stream_dedup", False),
        stream_tile=getattr(h, "stream_tile", 256),
        stream_slack=getattr(h, "stream_slack", 1.5),
        stream_seg=getattr(h, "stream_seg", 4),
        stream_direct_frac=getattr(h, "stream_direct_frac", 0.7),
        stream_seg_head=getattr(h, "stream_seg_head", 20),
        stream_head_frac=getattr(h, "stream_head_frac", 0.0),
    )


def render_config_from_hparams(h, test=False) -> RenderConfig:
    """The JAX trainer's mapping (T_threshold 1e-2 when test; the run
    counts only in training, with stream_autocal and stream dedup)."""
    return RenderConfig(
        exp_step_factor=1.0 / 256 if h.dataset_name in REAL_DATASETS
        else 0.0,
        T_threshold=1e-2 if test else 1e-4,
        max_samples=MAX_SAMPLES,
        capacity=getattr(h, "capacity", 192),
        march_iters=getattr(h, "march_iters", 1024),
        samples_per_ray=getattr(h, "samples_per_ray", 48),
        use_skybox=h.use_skybox,
        run_stats=(not test and bool(getattr(h, "stream_autocal", False))
                   and bool(getattr(h, "stream_dedup", False))),
        stream_sort=getattr(h, "stream_sort", True),
    )


def loss_config_from_hparams(h) -> LossConfig:
    return LossConfig(
        lambda_sparsity=getattr(h, "sparsity_loss", 0.0),
        embed_msk=h.embed_msk,
        normal_ref=h.normal_ref,
        normal_mono=h.normal_mono,
        semantic=h.render_semantic,
        depth_mono=h.depth_mono,
        depth_scale=h.scale,
        lambda_distortion=1e-4 if h.dataset_name == "mega" else 3e-4,
    )


def cosine_lr(lr: float, total_steps: int, t: int, alpha: float = 1 / 30):
    """optax.cosine_decay_schedule(lr, total_steps, alpha) at count t."""
    frac = min(t, total_steps) / total_steps
    return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac))
                 + alpha)


def clip_by_global_norm(grads, max_norm: float = 50.0):
    """optax.clip_by_global_norm in place on a list of gradients: scaled
    by max_norm / |g| when the global norm |g| >= max_norm (no epsilon,
    unlike torch.nn.utils.clip_grad_norm_), untouched otherwise; no
    host sync."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    return [g.mul_(scale) for g in grads]


def tree_leaves(tree, prefix=()):
    """[(path, tensor)] of a nested dict / list tree, in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in
                tree_leaves(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in
                tree_leaves(v, prefix + (i,))]
    return [(prefix, tree)]


def _check_ported(h):
    """Raise on training features the port does not have yet: LPIPS (its
    weights are absent), which would otherwise be dropped without a
    word."""
    if getattr(h, "eval_lpips", None):
        raise NotImplementedError("not ported yet: ['eval_lpips']")


def _datasets_from_hparams(h):
    """(train, test) datasets that hparams name (JAX trainer :133-148),
    kitti's with its sequence, frame window, test frames and nvs."""
    from ..data import dataset_dict
    ctor = dataset_dict[h.dataset_name]
    kw = dict(root_dir=h.root_dir, downsample=h.downsample)
    if h.dataset_name == "kitti":
        kw.update(seq_id=h.kitti_seq, frame_start=h.kitti_start,
                  frame_end=h.kitti_end, test_id=h.kitti_test_id, nvs=h.nvs)
    return ctor(split=h.split, **kw), ctor(split="test", **kw)


def _check_depth(loss_cfg, train_dataset):
    """Refuse depth_mono on a dataset without mono depth: the JAX step
    indexes the batch's "depth" (ingp_tpu/training/losses.py:151-152) and
    fails with a KeyError inside its jitted step. The kitti and highbay
    loaders read no depth, so configs/kitti360_nvs_1538.txt, which sets
    depth_mono, fails there in JAX."""
    if loss_cfg.depth_mono and not hasattr(train_dataset, "depths_2d"):
        raise ValueError(
            f"depth_mono is set, but the {type(train_dataset).__name__} "
            f"train split has no mono depth (depths_2d): the depth loss "
            f"would index a batch key its sampler never writes, where the "
            f"JAX step fails with KeyError 'depth' (ROADMAP.md Queue 3); "
            f"drop depth_mono")


def _check_finite(what, tree):
    """Raise FloatingPointError naming the first leaf of tree (a dict or
    list of tensors) that holds a NaN or an infinity (debug_nans)."""
    for path, t in tree_leaves(tree):
        if not bool(torch.isfinite(t).all()):
            name = "/".join(str(k) for k in (what,) + tuple(path))
            raise FloatingPointError(f"debug_nans: non-finite value in "
                                     f"{name}")


@contextlib.contextmanager
def _anomaly_as_fpe():
    """autograd's anomaly mode, its NaN report re-raised as
    FloatingPointError (which names the backward op)."""
    try:
        with torch.autograd.detect_anomaly(check_nan=True):
            yield
    except RuntimeError as e:
        if "nan values" not in str(e):
            raise
        raise FloatingPointError(f"debug_nans: {e}") from e


def _host_array(x):
    """A C-contiguous numpy copy of an array leaf (numpy or CPU tensor)."""
    return np.array(np.asarray(x.detach() if torch.is_tensor(x) else x),
                    order="C")


class NeRFSystem:
    """Parameters, optimiser state and occupancy grid of one scene, with
    the single-device training step and test rendering.

    Args:
      hparams: the JAX trainer's hparams namespace. Its `ckpt_load`, where
        set, is loaded at the end of the constructor.
      train_dataset: dataset whose poses and directions the rays are cast
        from (and whose poses mark the invisible cells); default, with
        test_dataset, the datasets that hparams name.
      test_dataset: dataset that `validate` renders (default: none, or
        the named dataset's test split).
      device: where everything lives (default CUDA; "cpu" runs the
        kernels' plain versions).
      seed: the seed of the random draws, which follow the JAX
        trainer's keys (core/prng.py): the initial params from
        PRNGKey(seed), a step's ray jitter and prior points from
        fold_in(PRNGKey(seed + 1), step), a grid refresh's draws from
        PRNGKey(step), so one seed gives the JAX system's draws (default:
        `hparams.seed`, or 0 where the namespace has none).
      params: optional numpy tree {"model": ngp_init tree, "embedding_a":
        (N_images, embed_a_len)[, "msk": mask_init tree][, "ext": {"dR",
        "dT"} (N_images, 3)]} (the JAX system's `params`, in its layouts)
        to start from; with optimize_ext and no "ext", zero corrections.
      world: a data-parallel `parallel.mesh.World` of more than one rank
        (default none: one device); `device` defaults to its device.

    hparams.debug_nans runs each step's backward in autograd's anomaly
    mode and checks the loss, every loss term and every gradient leaf:
    the first NaN or infinity raises FloatingPointError naming the leaf
    or the backward op (JAX's jax_debug_nans).
    """

    WARMUP_STEPS = 256
    UPDATE_INTERVAL = 16
    # cap auto-calibration: slots above the measured quantile, and the
    # cadence of the reads (the grid's)
    AUTOCAL_MARGIN = 8
    AUTOCAL_EVERY = 16
    BATCH_KEYS = ("img_idxs", "pix_idxs", "uv", "rgb", "label", "depth",
                  "normal", "exposure")
    # the step's injected draws: the ray jitter, the prior's points and
    # the random background colour
    DRAW_KEYS = ("noise", "sparsity_points", "bg_color")

    def __init__(self, hparams, train_dataset=None, test_dataset=None,
                 device=None, seed=None, params=None, world=None):
        _check_ported(hparams)
        if train_dataset is None:
            train_dataset, test_dataset = _datasets_from_hparams(hparams)
        self.hparams = hparams
        self.world = world if world is not None and world.size > 1 else None
        self.is_main = self.world is None or self.world.is_main
        # ranks a test-render chunk is split over (--num_gpus semantics)
        self.render_shards = 1 if (self.world is None
                                   or self.world.feeds_own_batch) \
            else self.world.size
        self.debug_nans = bool(getattr(hparams, "debug_nans", False))
        if device is None and world is not None:
            device = world.device
        self.device = dev = resolve_device(device)
        self.model_cfg = model_config_from_hparams(hparams)
        self.render_cfg = render_config_from_hparams(hparams)
        self.render_cfg_test = render_config_from_hparams(hparams, test=True)
        self.loss_cfg = loss_config_from_hparams(hparams)
        _check_depth(self.loss_cfg, train_dataset)
        self.train_dataset = train_dataset
        self.test_dataset = test_dataset
        train_dataset.batch_size = getattr(hparams, "batch_size", 8192)
        train_dataset.ray_sampling_strategy = getattr(
            hparams, "ray_sampling_strategy", "all_images")
        if seed is None:
            seed = getattr(hparams, "seed", 0)
        k_model, k_emb, k_msk = prng.split(prng.prng_key(seed), 3)
        self.base_key = prng.prng_key(seed + 1)
        if params is None:
            params = {
                "model": ngp_init(self.model_cfg, k_model, dev),
                "embedding_a": 0.01 * prng.normal(
                    k_emb, (train_dataset.n_images, hparams.embed_a_len),
                    dev),
            }
            if hparams.embed_msk:
                params["msk"] = mask_init(k_msk, dev)
        else:
            params = params_from_numpy(params, dev, self.model_cfg)
        self.optimize_ext = bool(getattr(hparams, "optimize_ext", False))
        if self.optimize_ext and "ext" not in params:
            n = train_dataset.n_images
            params["ext"] = {"dR": torch.zeros((n, 3), device=dev),
                             "dT": torch.zeros((n, 3), device=dev)}
        self.params = tree_map(lambda t: t.float().requires_grad_(), params)
        self.total_steps = (getattr(hparams, "num_epochs", 1)
                            + getattr(hparams, "normal_epochs", 0)) \
            * getattr(hparams, "steps_per_epoch", 1000)
        self.lr = getattr(hparams, "lr", 1e-2)
        # group 0 at the cosine rate (set before every update); the pose
        # corrections in a group of their own at EXT_LR
        leaves = tree_leaves(self.params)
        groups = [{"params": [t for k, t in leaves if k[0] != "ext"]}]
        if self.optimize_ext:
            groups.append({"params": [t for k, t in leaves
                                      if k[0] == "ext"], "lr": EXT_LR})
        self.optimizer = torch.optim.Adam(groups, lr=self.lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        cfg = self.model_cfg
        w, h = train_dataset.img_wh
        self.poses = torch.as_tensor(train_dataset.poses, device=dev)
        self.directions = torch.as_tensor(train_dataset.directions,
                                          device=dev)
        self.grid = mark_invisible_cells(
            grid_init(cfg.cascades, cfg.grid_size, dev), train_dataset.K,
            self.poses, w, h, cfg.grid_size, cfg.cascades, cfg.scale)
        self.global_step = 0
        if getattr(hparams, "ckpt_load", None):
            self.load(hparams.ckpt_load)

    # ------------------------------------------------------------------
    def lr_at(self, t: int) -> float:
        return cosine_lr(self.lr, self.total_steps, t)

    def _on_device(self, v):
        return torch.as_tensor(v if torch.is_tensor(v) else np.asarray(v),
                               device=self.device)

    def step_draws(self, n: int, step=None):
        """Training step `step`'s draws (default: this step's), JAX's from
        fold_in(PRNGKey(seed + 1), step), hashed on the host: "noise", the
        ray jitter (n,) uniform in [0, 1), from the first key of its
        split; with random_bg "bg_color" (3,) uniform in [0, 1), from the
        second; and with a sparsity prior "sparsity_points"
        (SPARSITY_POINTS, 3) uniform in [-scale, scale]^3. CPU tensors;
        `stage_batch` copies them to the device."""
        key = prng.fold_in(self.base_key,
                           self.global_step if step is None else step)
        k_noise, k_bg = prng.split(key)
        out = {"noise": prng.uniform(k_noise, (n,))}
        if self.hparams.random_bg:
            out["bg_color"] = prng.uniform(k_bg, (3,))
        if self.loss_cfg.lambda_sparsity > 0:
            s = self.model_cfg.scale
            out["sparsity_points"] = prng.uniform(
                prng.fold_in(key, 7), (SPARSITY_POINTS, 3), -s, s)
        return out

    def draws_for(self, n: int, step=None):
        """The draws of this process's batch of n rays: `step_draws(n)`,
        except under --distributed, where the noise is drawn over the
        global n x world.size rays and this rank takes its slice (JAX
        draws it over the global batch before the shard_map)."""
        w = self.world
        if w is None or not w.feeds_own_batch:
            return self.step_draws(n, step)
        out = self.step_draws(w.size * n, step)
        out["noise"] = out["noise"][w.rank * n:(w.rank + 1) * n]
        return out

    def loss_and_grads(self, batch, noise, sparsity_points=None,
                       bg_color=None):
        """(aux, grads) of one batch on the current grid: aux as
        `train_step` returns it plus "mse" (the psnr's), grads a tree
        like params (zeros for leaves the loss does not reach). With a
        sparsity prior (lambda_sparsity > 0), its density is taken at
        sparsity_points (N, 3), and with random_bg the background is
        bg_color (3,); each where not given is this step's draw. The
        skybox's gate is open from step WARMUP_STEPS on."""
        h = self.hparams
        p = self.params
        b = {k: self._on_device(v) for k, v in batch.items()
             if k in self.BATCH_KEYS}
        img = b["img_idxs"].long()
        pose = self.poses[img]
        if self.optimize_ext:
            # pose refinement: R <- axisangle_to_R(dR) R, t <- t + dT
            ext = p["ext"]
            rot = axisangle_to_R(ext["dR"][img]) @ pose[..., :3]
            pose = torch.cat([rot, (pose[..., 3] + ext["dT"][img])[..., None]],
                             -1)
        rays_o, rays_d = get_rays(self.directions[b["pix_idxs"].long()],
                                  pose)
        draws = None
        if (h.random_bg and bg_color is None) or (
                self.loss_cfg.lambda_sparsity > 0 and sparsity_points is None):
            draws = self.stage_batch(self.step_draws(0))
        if h.random_bg:
            bg_color = self._on_device(bg_color) if bg_color is not None \
                else draws["bg_color"]
        # the run counts only on the adoption cadence (read after this
        # step's update, hence global_step + 1)
        results = render_rays(
            self.model_cfg, self.render_cfg, p["model"],
            self.grid["bitfield"], rays_o.contiguous(), rays_d.contiguous(),
            self._on_device(noise),
            embedding_a=p["embedding_a"][img] if h.embed_a else None,
            exposure=b.get("exposure"),
            bg_color=bg_color if h.random_bg else None,
            skybox_gate=float(self.global_step >= self.WARMUP_STEPS),
            block_table=self.grid["block_table"],
            stats_gate=(self.global_step + 1) % self.AUTOCAL_EVERY == 0)
        if self.loss_cfg.lambda_sparsity > 0:
            pts = self._on_device(sparsity_points) \
                if sparsity_points is not None else draws["sparsity_points"]
            results["sparsity"] = ngp_sigma(self.model_cfg, p["model"], pts)
        mask = None
        if h.embed_msk:
            # (u, v, image) scaled into [0, 1], as the JAX step feeds it
            w, hh = self.train_dataset.img_wh
            uv = b["uv"]
            mask = mask_apply(p["msk"], torch.stack(
                [uv[:, 0] / hh, uv[:, 1] / w,
                 b["img_idxs"].float() / self.train_dataset.n_images], -1))
        loss_d = compute_losses(self.loss_cfg, results, b,
                                step=self.global_step, mask=mask)
        unit_rgb = getattr(self.train_dataset, "unit_exposure_rgb", None)
        if h.use_exposure and unit_rgb is not None:
            # the HDR anchor: unit exposure of zero log radiance
            out = log_radiance_to_rgb(
                self.model_cfg, p["model"],
                torch.zeros((1, 3), device=self.device),
                exposure=torch.ones((1, 1), device=self.device))
            loss_d["unit_exposure"] = 0.5 * (
                out - self._on_device(unit_rgb).float()) ** 2
        loss = total_loss(loss_d)
        if self.debug_nans:
            _check_finite("loss", {"total": loss, **loss_d})
        leaves = [t for _, t in tree_leaves(self.params)]
        with _anomaly_as_fpe() if self.debug_nans else \
                contextlib.nullcontext():
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        by_id = {id(t): g for t, g in zip(leaves, gs)}
        grads = tree_map(lambda t: torch.zeros_like(t) if by_id[id(t)] is None
                         else by_id[id(t)], self.params)
        if self.debug_nans:
            _check_finite("grad", grads)
        err = mse(results["rgb"].detach(), b["rgb"])
        aux = {
            "loss": loss.detach(),
            "mse": err,
            "psnr": -10.0 * torch.log10(err),
            "s_per_ray": results["total_samples"] / rays_o.shape[0],
            "loss_terms": {k: v.detach().mean() for k, v in loss_d.items()},
        }
        if "stream_runs" in results:
            aux["stream_runs"] = results["stream_runs"]
        return aux, grads

    def train_step(self, batch):
        """One optimisation step on the current grid (no grid refresh),
        with the ray jitter batch["noise"], the prior's points
        batch["sparsity_points"] and the background batch["bg_color"] or,
        without them, this step's draws (`draws_for`). Over a world, the
        batch is the global batch (--num_gpus) or this rank's own
        (--distributed), and the step is `data_parallel_grads`'.
        Returns aux (loss, psnr, s_per_ray, loss_terms)."""
        if "noise" not in batch:
            batch = {**self.stage_batch(self.draws_for(
                len(batch["pix_idxs"]))), **batch}
        if self.world is None:
            aux, grads = self.loss_and_grads(batch, batch["noise"],
                                             batch.get("sparsity_points"),
                                             batch.get("bg_color"))
        else:
            aux, grads = self.data_parallel_grads(batch)
        return self.apply_grads(aux, grads)

    def shard_of(self, batch, rank):
        """Rank `rank`'s shard of a staged batch and its draws: its rows of
        the per-ray keys (--num_gpus; under --distributed the batch is
        already this rank's) and, when SPARSITY_POINTS splits evenly over
        the ranks, its slice of the prior's points (JAX trainer
        :284-293: the mean over the ranks is then the mean over all
        points)."""
        w = self.world
        local = dict(batch)
        if not w.feeds_own_batch:
            per_ray = {k: v for k, v in batch.items()
                       if k in self.BATCH_KEYS or k == "noise"}
            local.update(shard_batch(w, per_ray, rank))
        pts = local.get("sparsity_points")
        if pts is not None and SPARSITY_POINTS % w.size == 0:
            per = SPARSITY_POINTS // w.size
            local["sparsity_points"] = pts[rank * per:(rank + 1) * per]
        return local

    def data_parallel_grads(self, batch):
        """(aux, grads) of the data-parallel step: each rank this process
        runs takes `loss_and_grads` of its shard (`shard_of`), then loss,
        mse, s_per_ray, the loss terms and the gradients are averaged over
        every rank and, with run_stats, stream_runs takes the maximum,
        (L,) -1 where this step measured none (JAX trainer :347-358)."""
        parts, runs = [], []
        for r in self.world.ranks:
            local = self.shard_of(batch, r)
            aux, grads = self.loss_and_grads(
                local, local["noise"], local.get("sparsity_points"),
                local.get("bg_color"))
            aux.pop("psnr")
            runs.append(aux.pop("stream_runs", None))
            parts.append((aux, grads))
        aux, grads = all_reduce_mean(self.world, parts)
        if self.render_cfg.run_stats:
            sentinel = torch.full((self.model_cfg.rgb_brick_cfg.n_levels,),
                                  -1, dtype=torch.int32, device=self.device)
            aux["stream_runs"] = all_reduce_max(
                self.world, [sentinel if r is None else r for r in runs])
        return aux, grads

    def apply_grads(self, aux, grads):
        """The update of a step from its (averaged) gradients: clip, Adam
        at this step's rate, the step count and, on the adoption cadence,
        the cap auto-calibration. aux's psnr comes from its (averaged)
        mse, as JAX's step derives it (:389-391)."""
        aux = dict(aux)
        aux["psnr"] = -10.0 * torch.log10(aux.pop("mse"))
        gl = clip_by_global_norm([g for _, g in tree_leaves(grads)])
        for (_, p), g in zip(tree_leaves(self.params), gl):
            p.grad = g
        self.optimizer.param_groups[0]["lr"] = self.lr_at(self.global_step)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.global_step += 1
        if "stream_runs" in aux:
            self._maybe_grow_stream_caps(aux["stream_runs"])
        return aux

    def _maybe_grow_stream_caps(self, runs):
        """Cap auto-calibration (JAX trainer :495-545), on its cadence:
        the measured per-level run counts plus AUTOCAL_MARGIN, aligned up
        to 8, floored at the formula caps (an early stream, before the
        grid carves, measures far under them, and undersized caps
        overflow cells into zero features) and capped at the tile; the
        first reading is adopted, later ones only grow a level's cap.
        The new caps replace model_cfg's; every encode after this reads
        them, the test render's too."""
        if self.global_step % self.AUTOCAL_EVERY:
            return
        runs = np.asarray(runs.cpu() if torch.is_tensor(runs) else runs)
        if np.any(runs < 0):
            return
        cfg = self.model_cfg
        tile = cfg.stream_tile
        target = np.minimum((runs + self.AUTOCAL_MARGIN + 7) // 8 * 8, tile)
        floor = np.asarray(stream_caps(cfg.rgb_brick_cfg, tile,
                                       slack=cfg.stream_slack,
                                       seg_est=cfg.stream_seg))
        target = np.minimum(np.maximum(target, floor), tile)
        cur = cfg.stream_caps
        if cur is None:
            new = tuple(int(c) for c in target)
        elif np.any(target > np.asarray(cur)):
            new = tuple(int(max(c, t)) for c, t in zip(cur, target))
        else:
            return
        self.model_cfg = dataclasses.replace(cfg, stream_caps=new)
        print(f"[autocal] step {self.global_step}: stream caps -> {new}",
              flush=True)

    def maybe_update_grid(self):
        """The grid refresh every UPDATE_INTERVAL steps (every cell while
        global_step < WARMUP_STEPS), its draws from PRNGKey(global_step).

        A deliberate departure from the JAX trainer, which takes the
        refresh's densities at the compute dtype: here the density MLP
        runs at f32 whatever the compute dtype, so at bf16 the refresh is
        JAX's update_density_grid with its ngp_sigma at f32 compute
        (tests/test_torch_sparsity.py holds it there). At bf16, a fresh
        model's hidden activations (features ~1e-4 against biases ~0.1)
        round to the same values in nearly every cell, so the first
        sweep's field is flat and "density > mean" marks nearly all or
        nearly none of the cells as the rounding falls; from a nearly
        empty start the sparsity prior drives every density to zero, in
        the JAX package as in the port (PERF.md). At f32 the field is
        continuous and about half the cells start occupied.
        """
        if self.global_step % self.UPDATE_INTERVAL:
            return
        cfg = self.model_cfg
        warmup = self.global_step < self.WARMUP_STEPS
        draws = grid_draws(prng.prng_key(self.global_step), cfg.grid_size,
                           cfg.cascades, warmup, self.device)
        model = self.params["model"]
        sigma_cfg = dataclasses.replace(cfg, compute_dtype="float32")
        self.grid = update_density_grid(
            lambda x: ngp_sigma_cm(sigma_cfg, model, x.T), self.grid, draws,
            self.hparams.density_threshold * MAX_SAMPLES / math.sqrt(3),
            cfg.grid_size, cfg.cascades, cfg.scale, warmup,
            erode=self.hparams.dataset_name == "colmap")
        if self.debug_nans:
            _check_finite("grid", {"density_grid":
                                   self.grid["density_grid"]})
        if self.world is not None:
            # every rank refreshed from the same draws; rank 0's grid is
            # taken so that a last-bit difference between ranks cannot
            # flip a cell of one rank's bitfield
            broadcast_tree(self.world, self.grid)

    def training_step(self, batch):
        """Grid refresh on its cadence, then one optimisation step."""
        self.maybe_update_grid()
        return self.train_step(batch)

    # ------------------------------------------------------------------
    def adam_state_to_numpy(self):
        """{"mu", "nu": trees like params (numpy copies, the JAX package's
        layouts), "count": updates so far}."""
        st = self.optimizer.state

        def get(key):
            return params_to_numpy(
                tree_map(lambda t: st[t][key] if t in st
                         else torch.zeros_like(t), self.params),
                self.model_cfg)
        return {"mu": get("exp_avg"), "nu": get("exp_avg_sq"),
                "count": self.global_step}

    def adam_state_from_numpy(self, state):
        """Load Adam moments and the update count (e.g. from the JAX
        system's ScaleByAdamState, in its layouts)."""
        mu = dict(tree_leaves(hash_layout(state["mu"], self.model_cfg)))
        nu = dict(tree_leaves(hash_layout(state["nu"], self.model_cfg)))
        for path, t in tree_leaves(self.params):
            self.optimizer.state[t] = {
                "step": torch.tensor(float(state["count"])),
                "exp_avg": torch.as_tensor(_host_array(mu[path]),
                                           device=self.device),
                "exp_avg_sq": torch.as_tensor(_host_array(nu[path]),
                                              device=self.device)}
        self.global_step = int(state["count"])

    def params_to_numpy(self):
        """The parameters as numpy copies in the JAX package's layouts."""
        return params_to_numpy(self.params, self.model_cfg)

    # ------------------------------------------------------------------
    def state(self):
        """{"params", "opt_state": adam_state_to_numpy(), "grid", "step"
        [, "stream_caps" (L,) int32, the auto-calibrated caps once
        adopted]}: numpy copies, the JAX package's layouts."""
        s = {"params": self.params_to_numpy(),
             "opt_state": self.adam_state_to_numpy(),
             "grid": {k: _host_array(v.cpu())
                      for k, v in self.grid.items()},
             "step": self.global_step}
        if self.model_cfg.stream_caps is not None:
            s["stream_caps"] = np.asarray(self.model_cfg.stream_caps,
                                          np.int32)
        return s

    def save(self, path):
        save_ckpt(path, self.state())

    def load(self, path):
        self.load_state(load_ckpt(path))

    def load_state(self, state):
        """Load a state() tree (numpy or CPU tensor leaves). The params it
        holds replace the system's (a slim checkpoint's too), its Adam
        state, grid and adopted stream caps where it has them; the step
        always."""
        new = params_from_numpy(
            tree_map(_host_array, state["params"]), self.device,
            self.model_cfg)
        with torch.no_grad():
            for k in self.params:
                if k not in new:
                    continue
                for (path, t), (_, v) in zip(tree_leaves(self.params[k]),
                                             tree_leaves(new[k])):
                    if t.shape != v.shape:
                        raise ValueError(f"checkpoint {k} {path}: shape "
                                         f"{tuple(v.shape)}, the system's "
                                         f"{tuple(t.shape)}")
                    t.copy_(v)
        if "opt_state" in state:
            self.adam_state_from_numpy(state["opt_state"])
        if "grid" in state:
            # the JAX package's bitfield is uint32, the port's int32
            grid = {k: torch.as_tensor(_host_array(v).view(np.int32)
                                       if np.asarray(v).dtype == np.uint32
                                       else _host_array(v),
                                       device=self.device)
                    for k, v in state["grid"].items()}
            if "block_table" not in grid:
                cfg = self.model_cfg
                grid["block_table"] = build_block_table(
                    grid["bitfield"], cfg.grid_size, cfg.cascades)
            self.grid = grid
        if state.get("stream_caps") is not None:
            caps = tuple(int(c) for c in _host_array(state["stream_caps"]))
            self.model_cfg = dataclasses.replace(self.model_cfg,
                                                 stream_caps=caps)
        self.global_step = int(state.get("step", 0))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def render_image(self, pose, chunk_size=None, embedding=None):
        """Whole-image test render, its chunk capped so that chunk *
        samples_per_ray <= 1.5M network samples a rank. With embed_a every
        ray takes the appearance code `embedding` ((1, embed_a_len) or
        (embed_a_len,); default: image 0's). Over the ranks of a
        --num_gpus world (render_shards > 1) each chunk is split over
        them (`_render_sharded`): every rank must call it."""
        n_dev = self.render_shards
        chunk = chunk_size or self.hparams.chunk_size
        spr = max(self.render_cfg_test.samples_per_ray, 1)
        chunk = min(chunk, max(n_dev * 1_500_000 // spr, 4096))
        pose = torch.as_tensor(np.asarray(pose), device=self.device)
        rays_o, rays_d = get_rays(self.directions, pose)
        if self.hparams.embed_a and embedding is None:
            embedding = self.params["embedding_a"][0:1]
        emb = embedding if self.hparams.embed_a else None
        if n_dev > 1:
            return self._render_sharded(rays_o, rays_d, chunk, emb)
        return render_chunks(
            self.model_cfg, self.render_cfg_test, self.params["model"],
            self.grid["bitfield"], rays_o, rays_d, chunk, embedding_a=emb,
            block_table=self.grid["block_table"])

    def _render_sharded(self, rays_o, rays_d, chunk, embedding):
        """The test render with each chunk split over the world's ranks
        (JAX trainer :584-658, `_sharded_test_render` :547-582): the chunk
        is a multiple of n; a tail chunk pads to the chunk, a lone chunk to
        the next multiple of n, by repeating its last ray; rank r renders
        rows [r m, (r+1) m) of the padded chunk at its own sample budget
        (m rays), the rows are gathered in rank order and total_samples
        summed over the ranks."""
        w, n_dev = self.world, self.render_shards
        chunk = max(chunk // n_dev, 1) * n_dev
        n = rays_o.shape[0]
        emb_full = None
        if embedding is not None:
            emb_full = torch.as_tensor(embedding, device=self.device
                                       ).reshape(1, -1).float().expand(n, -1)
        outs, total = [], 0
        for i in range(0, n, chunk):
            sl = slice(i, min(i + chunk, n))
            parts = [rays_o[sl], rays_d[sl]] + (
                [emb_full[sl]] if emb_full is not None else [])
            blk = chunk if (i > 0 or n > chunk) else \
                -(-parts[0].shape[0] // n_dev) * n_dev
            pad = blk - parts[0].shape[0]
            if pad:
                parts = [torch.cat([p, p[-1:].expand(pad, -1)])
                         for p in parts]
            m = blk // n_dev
            shards = []
            for r in w.ranks:
                rs = [p[r * m:(r + 1) * m].contiguous() for p in parts]
                shards.append(render_rays_test(
                    self.model_cfg, self.render_cfg_test,
                    self.params["model"], self.grid["bitfield"], rs[0],
                    rs[1], embedding_a=rs[2] if len(rs) > 2 else None,
                    block_table=self.grid["block_table"]))
            res = {k: gather_rows(w, [s[k] for s in shards])
                   for k in shards[0] if k != "total_samples"}
            total += int(gather_rows(w, [
                torch.as_tensor(s["total_samples"], device=self.device
                                ).reshape(1) for s in shards]).sum())
            if pad:
                res = {k: v[:-pad] for k, v in res.items()}
            outs.append(res)
        merged = {k: torch.cat([o[k] for o in outs], 0) for k in outs[0]}
        merged["total_samples"] = total
        return merged

    def validate(self, max_images=None):
        """Mean PSNR and SSIM of the test split's views. Under
        --distributed the views go round-robin over the ranks, each
        rendering whole views, and the per-view metrics are gathered
        (NaN-padded to a common length; JAX trainer :660-706); every rank
        returns the same means."""
        w, h = self.test_dataset.img_wh
        n = len(self.test_dataset.poses)
        if max_images:
            n = min(n, max_images)
        pc, pid = (self.world.size, self.world.rank) if (
            self.world is not None and self.world.feeds_own_batch) else (1, 0)
        psnrs, ssims = [], []
        for i in range(pid, n, pc):
            item = self.test_dataset.test_item(i)
            res = self.render_image(item["pose"])
            pred = torch.clamp(res["rgb"], 0, 1).reshape(h, w, 3)
            gt = torch.as_tensor(item["rgb"], device=self.device
                                 ).reshape(h, w, 3)
            psnrs.append(float(psnr(pred, gt)))
            ssims.append(float(ssim(pred, gt)))
        if pc > 1:
            pad = [float("nan")] * (-(-n // pc) - len(psnrs))
            psnrs = [v for v in all_gather_metrics(psnrs + pad)
                     if np.isfinite(v)]
            ssims = [v for v in all_gather_metrics(ssims + pad)
                     if np.isfinite(v)]
        return {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims))}

    def _dump_val_images(self, ckpt_dir, step):
        """The test split's first view rendered to ckpt_dir/val as
        <step>_rgb.png, _depth.png (TURBO over twice the scene scale),
        _normal.png and _normal_raw.png (camera-frame normals) and, with
        render_semantic, _semantic.png (JAX trainer :836-861)."""
        from ..utils.vis import (convert_normal, depth2img, save_image,
                                 semantic2img)
        w, h = self.test_dataset.img_wh
        item = self.test_dataset.test_item(0)
        res = {k: v.cpu().numpy() for k, v in
               self.render_image(item["pose"]).items()
               if torch.is_tensor(v)}
        img_dir = os.path.join(ckpt_dir, "val")
        os.makedirs(img_dir, exist_ok=True)

        def save(image, tag):
            save_image(image, os.path.join(img_dir, f"{step:05d}_{tag}.png"))
        save(np.clip(res["rgb"].reshape(h, w, 3), 0, 1), "rgb")
        depth = depth2img(res["depth"].reshape(h, w),
                          scale=2 * self.hparams.scale)[..., ::-1]
        save(depth / 255.0, "depth")
        for key in ("normal_pred", "normal_raw"):
            nrm = convert_normal(res[key].reshape(h, w, 3), item["pose"])
            save(np.clip((nrm + 1) / 2, 0, 1), key.replace("_pred", ""))
        if self.hparams.render_semantic:
            sem = semantic2img(res["semantic"].reshape(h, w),
                               self.hparams.num_classes)[..., ::-1]
            save(sem / 255.0, "semantic")


    # ------------------------------------------------------------------
    def stage_batch(self, batch):
        """A host batch's step keys (BATCH_KEYS and DRAW_KEYS) on the
        device. On the card the copies go through pinned host memory
        without blocking, so a batch staged right after a step was
        dispatched uploads while that step runs."""
        out = {}
        for k, v in batch.items():
            if k not in self.BATCH_KEYS + self.DRAW_KEYS:
                continue
            t = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
            if self.device.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t.to(self.device)
        return out

    def fit(self, log_every=100, ckpt_dir=None, rng=None, on_step=None,
            use_native_loader=None):
        """The training loop from global_step to the schedule's end
        (JAX trainer :709-834): each batch staged while the step before it
        runs; a log line every log_every steps; with ckpt_dir, a metrics
        logger there, an epoch checkpoint under ckpt_dir/steps (and a
        resume from its latest step when the system starts at step 0,
        unless hparams.no_resume), and the final `last` and `last_slim`
        checkpoints; every VAL_DUMP_EVERY steps after step 0 the
        validation images of the test split's first view go to
        ckpt_dir/val (`_dump_val_images`). on_step(step, aux) is called
        after every step.

        The batches (JAX trainer :726-737, :776-777): with
        use_native_loader None (the default) from the native sampler
        (`native.NativeBatchSampler`, seeded with hparams.seed, so the
        port draws JAX's batches), or, where its constructor refuses the
        dataset's layout, from the dataset's numpy `sample_batch` with a
        line saying so; True: the native sampler or raise; False: numpy,
        from rng or a generator seeded with hparams.seed ([seed, rank]
        under --distributed). rng is ignored while the native sampler
        draws. A failed build of the sampler's library raises
        RuntimeError (JAX falls back to numpy).

        Over a world: log lines, the logger and the validation images on
        rank 0; epoch checkpoints written by rank 0, the resume step
        broadcast from it and loaded by every rank; `last` and
        `last_slim` written by rank 0 after a barrier.

        With hparams.profile_dir, steps first+20 to first+29 run under
        torch.profiler (CPU and CUDA activities), each in a
        record_function("train_step") range, and the Chrome trace goes
        to profile_dir/trace[_rank<r>].json (JAX's jax.profiler window,
        :774, :790-793)."""
        h = self.hparams
        seed = getattr(h, "seed", 0)
        w = self.world
        if rng is None:
            rng = np.random.default_rng(
                [seed, w.rank] if w is not None and w.feeds_own_batch
                else seed)
        native = self.native_sampler(use_native_loader)
        logger = ckpt_mgr = None
        try:
            if ckpt_dir:
                os.makedirs(ckpt_dir, exist_ok=True)
                steps_dir = os.path.join(ckpt_dir, "steps")
                latest = None
                if self.is_main:
                    ckpt_mgr = AsyncCkptManager(steps_dir)
                    latest = ckpt_mgr.latest_step()
                    logger = make_logger(getattr(h, "logger", "jsonl"),
                                         ckpt_dir,
                                         getattr(h, "exp_name", "exp"))
                if w is not None:
                    latest = broadcast_int(latest)
                if (latest is not None and self.global_step == 0
                        and not getattr(h, "no_resume", False)):
                    self.load_state(load_ckpt(step_state_path(steps_dir,
                                                              latest)))
                    if self.is_main:
                        print(f"resumed from {ckpt_dir}/steps @ step "
                              f"{self.global_step}", flush=True)
            self._run(self.total_steps, native, rng, log_every, logger,
                      ckpt_mgr, on_step, ckpt_dir)
        finally:
            if native is not None:
                native.close()
            if logger:
                logger.close()
            if ckpt_mgr:
                ckpt_mgr.close()
        if ckpt_dir:
            if w is not None:
                barrier(w)
            if self.is_main:
                self.save(os.path.join(ckpt_dir, "last"))
                save_ckpt(os.path.join(ckpt_dir, "last_slim"),
                          slim_state(self.state()))
        return self

    def native_sampler(self, use_native_loader=None):
        """The native sampler that `fit` draws from (seeded with
        hparams.seed on every rank, as JAX seeds it), or None for numpy:
        use_native_loader None takes it wherever its constructor accepts
        the train dataset's layout (else a line says why not), True
        raises where it does not, False never takes it. The caller
        closes it."""
        if use_native_loader is False:
            return None
        from ..native import NativeBatchSampler
        try:
            return NativeBatchSampler(
                self.train_dataset, self.train_dataset.batch_size,
                seed=getattr(self.hparams, "seed", 0),
                strategy=self.train_dataset.ray_sampling_strategy)
        except (ValueError, AttributeError) as e:
            if use_native_loader:
                raise
            if self.is_main:
                print(f"native loader unavailable ({e}); numpy sampler",
                      flush=True)
            return None

    def _run(self, total_steps, native, rng, log_every, logger, ckpt_mgr,
             on_step, ckpt_dir):
        h = self.hparams
        t0 = time.time()
        rays_done = 0
        first = self.global_step
        profile_dir = getattr(h, "profile_dir", None)
        prof = None

        def batch_of(step):
            b = native.next_batch() if native is not None \
                else self.train_dataset.sample_batch(rng)
            return self.stage_batch({**self.draws_for(
                len(b["pix_idxs"]), step), **b})

        staged = batch_of(first)
        try:
            for step in range(first, total_steps):
                if profile_dir and step == first + PROFILE_STEPS[0]:
                    prof = self._start_profile()
                if prof is not None and step == first + PROFILE_STEPS[1]:
                    self._stop_profile(prof, profile_dir)
                    prof = None
                with torch.profiler.record_function("train_step") \
                        if prof is not None else contextlib.nullcontext():
                    aux = self.training_step(staged)
                if step + 1 < total_steps:
                    staged = batch_of(step + 1)
                rays_done += h.batch_size
                if on_step is not None:
                    on_step(step, aux)
                if log_every and step % log_every == 0 and self.is_main:
                    rays_s = rays_done / max(time.time() - t0, 1e-9)
                    print(f"step {step:6d} loss {float(aux['loss']):.5f} "
                          f"psnr {float(aux['psnr']):.2f} "
                          f"s/ray {float(aux['s_per_ray']):.1f} "
                          f"rays/s {rays_s:,.0f}", flush=True)
                    if logger:
                        logger.log_metrics(step, {
                            "loss": float(aux["loss"]),
                            "train/psnr": float(aux["psnr"]),
                            "train/s_per_ray": float(aux["s_per_ray"]),
                            "train/rays_per_s": rays_s,
                            "lr": self.lr_at(step),
                        })
                if ckpt_dir and step > 0 and step % VAL_DUMP_EVERY == 0:
                    if self.is_main:
                        self._dump_val_images(ckpt_dir, step)
                    elif self.render_shards > 1:
                        # rank 0's dump renders its view over every rank
                        self.render_image(
                            self.test_dataset.test_item(0)["pose"])
                if ckpt_mgr and (step + 1) % h.steps_per_epoch == 0:
                    ckpt_mgr.save(step + 1, self.state())
        finally:
            if prof is not None:
                self._stop_profile(prof, profile_dir)

    def _start_profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            # Kineto tears CUPTI down at the window's end only when asked:
            # left subscribed, it slows every later host-bound step of the
            # process (by ~14-17% on the bench step on an H100, PERF.md)
            os.environ.setdefault("TEARDOWN_CUPTI", "1")
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        return prof

    def _stop_profile(self, prof, profile_dir):
        """End the profile and write its Chrome trace into profile_dir."""
        prof.__exit__(None, None, None)
        os.makedirs(profile_dir, exist_ok=True)
        name = "trace.json" if self.world is None else \
            f"trace_rank{self.world.rank}.json"
        path = os.path.join(profile_dir, name)
        prof.export_chrome_trace(path)
        if self.is_main:
            print(f"profile: steps {PROFILE_STEPS[0]}-"
                  f"{PROFILE_STEPS[1] - 1} after the first -> {path}",
                  flush=True)
