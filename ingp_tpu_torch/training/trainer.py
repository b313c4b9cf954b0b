"""Training system (counterpart of ingp_tpu/training/trainer.py): the
hparams -> config mapping (:46-113), and `NeRFSystem` on one device --
parameters, optimiser, occupancy grid, the training step (:233-406), the
grid refresh cadence, `render_image` (:584-658) and `validate`
(:660-707).

The step is eager PyTorch: render_rays, the losses, autograd (the
encoders' and the composite's backward are kernels K1, K2 and K3 bwd),
then optax's chain clip_by_global_norm(50) -> adam(cosine decay,
eps 1e-8) written out: the clip by hand (optax scales by 50/|g| only
when |g| >= 50, with no epsilon), torch.optim.Adam for the moments, and
the learning rate of update t computed from t, the count of updates
before it. The shard_map path, checkpoints, `fit` and the cap
auto-calibration are not ported.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.rays import get_rays
from ..device import resolve_device
from ..grid.occupancy import (grid_draws, grid_init, mark_invisible_cells,
                              update_density_grid)
from ..models.ngp import (NGPConfig, ngp_init, ngp_sigma_cm,
                          params_from_numpy, params_to_numpy)
from ..models.rendering import (MAX_SAMPLES, RenderConfig, render_rays,
                                render_rays_test)
from .losses import LossConfig, compute_losses, total_loss
from .metrics import mse, psnr, ssim

REAL_DATASETS = ("colmap", "nerfpp", "tnt", "kitti", "mega", "highbay")


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
    )


def render_config_from_hparams(h, test=False) -> RenderConfig:
    """The JAX trainer's mapping (T_threshold 1e-2 when test)."""
    return RenderConfig(
        exp_step_factor=1.0 / 256 if h.dataset_name in REAL_DATASETS
        else 0.0,
        T_threshold=1e-2 if test else 1e-4,
        max_samples=MAX_SAMPLES,
        capacity=getattr(h, "capacity", 192),
        march_iters=getattr(h, "march_iters", 1024),
        samples_per_ray=getattr(h, "samples_per_ray", 48),
        use_skybox=h.use_skybox,
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


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _check_ported(h):
    """Raise on training features the port does not have yet."""
    off = [k for k in ("embed_msk", "optimize_ext", "random_bg")
           if getattr(h, k, False)]
    if getattr(h, "sparsity_loss", 0.0) > 0:
        off.append("sparsity_loss")
    if getattr(h, "stream_head_frac", 0.0) > 0:
        off.append("stream_head_frac")
    if not getattr(h, "stream_sort", True):
        off.append("stream_sort=False")
    # cap auto-calibration, checkpoint resume and LPIPS (its weights are
    # absent) would otherwise be dropped without a word
    off += [k for k in ("stream_autocal", "ckpt_load", "eval_lpips")
            if getattr(h, k, None)]
    if off:
        raise NotImplementedError(f"not ported yet: {off}")


class NeRFSystem:
    """Parameters, optimiser state and occupancy grid of one scene, with
    the single-device training step and test rendering.

    Args:
      hparams: the JAX trainer's hparams namespace.
      train_dataset: dataset whose poses and directions the rays are cast
        from (and whose poses mark the invisible cells).
      test_dataset: dataset that `validate` renders (default: none).
      device: where everything lives (default CUDA; "cpu" runs the
        kernels' plain versions).
      seed: seed of the torch.Generator that draws the initial params,
        the ray jitter and the grid refresh's draws (default:
        `hparams.seed`, or 0 where the namespace has none).
      params: optional numpy tree {"model": ngp_init tree, "embedding_a":
        (N_images, embed_a_len)} (the JAX system's `params`) to start from.
    """

    WARMUP_STEPS = 256
    UPDATE_INTERVAL = 16
    BATCH_KEYS = ("img_idxs", "pix_idxs", "rgb", "label", "depth",
                  "normal")

    def __init__(self, hparams, train_dataset, test_dataset=None,
                 device=None, seed=None, params=None):
        _check_ported(hparams)
        self.hparams = hparams
        self.device = dev = resolve_device(device)
        self.model_cfg = model_config_from_hparams(hparams)
        self.render_cfg = render_config_from_hparams(hparams)
        self.render_cfg_test = render_config_from_hparams(hparams, test=True)
        self.loss_cfg = loss_config_from_hparams(hparams)
        self.train_dataset = train_dataset
        self.test_dataset = test_dataset
        train_dataset.batch_size = getattr(hparams, "batch_size", 8192)
        train_dataset.ray_sampling_strategy = getattr(
            hparams, "ray_sampling_strategy", "all_images")
        if seed is None:
            seed = getattr(hparams, "seed", 0)
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        if params is None:
            n_img = train_dataset.n_images
            params = {
                "model": ngp_init(self.model_cfg, self.generator, dev),
                "embedding_a": 0.01 * torch.randn(
                    (n_img, hparams.embed_a_len), generator=self.generator,
                    device=dev),
            }
        else:
            params = params_from_numpy(params, dev)
        self.params = tree_map(lambda t: t.float().requires_grad_(), params)
        self.total_steps = (getattr(hparams, "num_epochs", 1)
                            + getattr(hparams, "normal_epochs", 0)) \
            * getattr(hparams, "steps_per_epoch", 1000)
        self.lr = getattr(hparams, "lr", 1e-2)
        self.optimizer = torch.optim.Adam(
            [t for _, t in tree_leaves(self.params)], lr=self.lr,
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

    # ------------------------------------------------------------------
    def lr_at(self, t: int) -> float:
        return cosine_lr(self.lr, self.total_steps, t)

    def _on_device(self, v):
        return torch.as_tensor(v if torch.is_tensor(v) else np.asarray(v),
                               device=self.device)

    def loss_and_grads(self, batch, noise):
        """(aux, grads) of one batch on the current grid: aux as
        `train_step` returns it, grads a tree like params (zeros for
        leaves the loss does not reach)."""
        b = {k: self._on_device(v) for k, v in batch.items()
             if k in self.BATCH_KEYS}
        rays_o, rays_d = get_rays(self.directions[b["pix_idxs"].long()],
                                  self.poses[b["img_idxs"].long()])
        results = render_rays(self.model_cfg, self.render_cfg,
                              self.params["model"], self.grid["bitfield"],
                              rays_o.contiguous(), rays_d.contiguous(),
                              self._on_device(noise),
                              block_table=self.grid["block_table"])
        loss_d = compute_losses(self.loss_cfg, results, b,
                                step=self.global_step)
        loss = total_loss(loss_d)
        leaves = [t for _, t in tree_leaves(self.params)]
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        by_id = {id(t): g for t, g in zip(leaves, gs)}
        grads = tree_map(lambda t: torch.zeros_like(t) if by_id[id(t)] is None
                         else by_id[id(t)], self.params)
        aux = {
            "loss": loss.detach(),
            "psnr": -10.0 * torch.log10(mse(results["rgb"].detach(),
                                            b["rgb"])),
            "s_per_ray": results["total_samples"] / rays_o.shape[0],
            "loss_terms": {k: v.detach().mean() for k, v in loss_d.items()},
        }
        return aux, grads

    def train_step(self, batch):
        """One optimisation step on the current grid (no grid refresh),
        with the ray jitter batch["noise"] or, without it, a draw from
        the system's generator. Returns aux (loss, psnr, s_per_ray,
        loss_terms)."""
        noise = batch.get("noise")
        if noise is None:
            noise = torch.rand(len(batch["pix_idxs"]),
                               generator=self.generator, device=self.device)
        aux, grads = self.loss_and_grads(batch, noise)
        gl = clip_by_global_norm([g for _, g in tree_leaves(grads)])
        for (_, p), g in zip(tree_leaves(self.params), gl):
            p.grad = g
        self.optimizer.param_groups[0]["lr"] = self.lr_at(self.global_step)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.global_step += 1
        return aux

    def maybe_update_grid(self):
        """The grid refresh every UPDATE_INTERVAL steps (every cell while
        global_step < WARMUP_STEPS), its draws from the system's
        generator."""
        if self.global_step % self.UPDATE_INTERVAL:
            return
        cfg = self.model_cfg
        warmup = self.global_step < self.WARMUP_STEPS
        draws = grid_draws(self.generator, cfg.grid_size, cfg.cascades,
                           warmup, self.device)
        model = self.params["model"]
        self.grid = update_density_grid(
            lambda x: ngp_sigma_cm(cfg, model, x.T), self.grid, draws,
            self.hparams.density_threshold * MAX_SAMPLES / math.sqrt(3),
            cfg.grid_size, cfg.cascades, cfg.scale, warmup,
            erode=self.hparams.dataset_name == "colmap")

    def training_step(self, batch):
        """Grid refresh on its cadence, then one optimisation step."""
        self.maybe_update_grid()
        return self.train_step(batch)

    # ------------------------------------------------------------------
    def adam_state_to_numpy(self):
        """{"mu", "nu": trees like params, "count": updates so far}."""
        st = self.optimizer.state

        def get(key):
            return tree_map(lambda t: st[t][key].detach().cpu().numpy()
                            if t in st else np.zeros(tuple(t.shape),
                                                     np.float32),
                            self.params)
        return {"mu": get("exp_avg"), "nu": get("exp_avg_sq"),
                "count": self.global_step}

    def adam_state_from_numpy(self, state):
        """Load Adam moments and the update count (e.g. from the JAX
        system's ScaleByAdamState)."""
        mu = dict(tree_leaves(state["mu"]))
        nu = dict(tree_leaves(state["nu"]))
        for path, t in tree_leaves(self.params):
            self.optimizer.state[t] = {
                "step": torch.tensor(float(state["count"])),
                "exp_avg": torch.as_tensor(np.asarray(mu[path]),
                                           device=self.device).clone(),
                "exp_avg_sq": torch.as_tensor(np.asarray(nu[path]),
                                              device=self.device).clone()}
        self.global_step = int(state["count"])

    def params_to_numpy(self):
        return params_to_numpy(self.params)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def render_image(self, pose, chunk_size=None):
        """Chunked whole-image test render. The chunk is capped so that
        chunk * samples_per_ray <= 1.5M network samples; a tail chunk
        pads up to the full chunk by repeating its last ray."""
        chunk = chunk_size or self.hparams.chunk_size
        spr = max(self.render_cfg_test.samples_per_ray, 1)
        chunk = min(chunk, max(1_500_000 // spr, 4096))
        pose = torch.as_tensor(np.asarray(pose), device=self.device)
        rays_o, rays_d = get_rays(self.directions, pose)
        n = rays_o.shape[0]
        outs = []
        for i in range(0, n, chunk):
            ro, rd = rays_o[i:i + chunk], rays_d[i:i + chunk]
            blk = chunk if (i > 0 or n > chunk) else ro.shape[0]
            pad = blk - ro.shape[0]
            if pad:
                ro = torch.cat([ro, ro[-1:].expand(pad, 3)])
                rd = torch.cat([rd, rd[-1:].expand(pad, 3)])
            res = render_rays_test(self.model_cfg, self.render_cfg_test,
                                   self.params["model"],
                                   self.grid["bitfield"], ro.contiguous(),
                                   rd.contiguous(),
                                   block_table=self.grid["block_table"])
            if pad:
                res = {k: v[:-pad] if v.ndim >= 1 and v.shape[0] == blk
                       else v for k, v in res.items()}
            outs.append(res)
        merged = {k: torch.cat([o[k] for o in outs], 0)
                  for k in outs[0] if k != "total_samples"}
        merged["total_samples"] = sum(int(o["total_samples"]) for o in outs)
        return merged

    def validate(self, max_images=None):
        """Mean PSNR and SSIM of the test split's views."""
        w, h = self.test_dataset.img_wh
        n = len(self.test_dataset.poses)
        if max_images:
            n = min(n, max_images)
        psnrs, ssims = [], []
        for i in range(n):
            item = self.test_dataset.test_item(i)
            res = self.render_image(item["pose"])
            pred = torch.clamp(res["rgb"], 0, 1).reshape(h, w, 3)
            gt = torch.as_tensor(item["rgb"], device=self.device
                                 ).reshape(h, w, 3)
            psnrs.append(float(psnr(pred, gt)))
            ssims.append(float(ssim(pred, gt)))
        return {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims))}

