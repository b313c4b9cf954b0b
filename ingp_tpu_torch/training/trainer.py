"""Training system (counterpart of ingp_tpu/training/trainer.py): the
hparams -> config mapping (:46-113), and `NeRFSystem` on one device --
parameters, optimiser, occupancy grid, the training step (:233-406) with
the sparsity prior (:279-295), the grid refresh cadence, `render_image`
(:584-658), `validate` (:660-707), the training loop `fit` (:709-834)
and the checkpoint state (:864-935).

The step is eager PyTorch: render_rays, the losses, autograd (the
encoders' and the composite's backward are kernels K1, K2 and K3 bwd),
then optax's chain clip_by_global_norm(50) -> adam(cosine decay,
eps 1e-8) written out: the clip by hand (optax scales by 50/|g| only
when |g| >= 50, with no epsilon), torch.optim.Adam for the moments, and
the learning rate of update t computed from t, the count of updates
before it. The shard_map path, the cap auto-calibration, the native
batch loader and the validation image dumps are not ported.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time

import numpy as np
import torch

from ..core import prng
from ..core.rays import get_rays
from ..device import resolve_device
from ..grid.occupancy import (grid_draws, grid_init, mark_invisible_cells,
                              update_density_grid)
from ..models.ngp import (NGPConfig, hash_layout, ngp_init, ngp_sigma,
                          ngp_sigma_cm, params_from_numpy, params_to_numpy)
from ..models.rendering import (MAX_SAMPLES, RenderConfig, render_rays,
                                render_rays_test)
from ..ops.march import build_block_table
from ..utils.ckpt import AsyncCkptManager, load_ckpt, save_ckpt, slim_state
from ..utils.loggers import make_logger
from .losses import LossConfig, compute_losses, total_loss
from .metrics import mse, psnr, ssim

REAL_DATASETS = ("colmap", "nerfpp", "tnt", "kitti", "mega", "highbay")
SPARSITY_POINTS = 16384     # uniform points of the sparsity prior
VAL_DUMP_EVERY = 10000      # the JAX loop's validation image cadence


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
    if getattr(h, "stream_head_frac", 0.0) > 0:
        off.append("stream_head_frac")
    if not getattr(h, "stream_sort", True):
        off.append("stream_sort=False")
    # cap auto-calibration and LPIPS (its weights are absent) would
    # otherwise be dropped without a word
    off += [k for k in ("stream_autocal", "eval_lpips")
            if getattr(h, k, None)]
    if off:
        raise NotImplementedError(f"not ported yet: {off}")


def _datasets_from_hparams(h):
    """(train, test) datasets that hparams name (JAX trainer :133-148)."""
    from ..data import dataset_dict
    ctor = dataset_dict[h.dataset_name]
    kw = dict(root_dir=h.root_dir, downsample=h.downsample)
    return ctor(split=h.split, **kw), ctor(split="test", **kw)


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
        (N_images, embed_a_len)} (the JAX system's `params`, in its
        layouts) to start from.
    """

    WARMUP_STEPS = 256
    UPDATE_INTERVAL = 16
    BATCH_KEYS = ("img_idxs", "pix_idxs", "rgb", "label", "depth",
                  "normal")
    # the step's injected draws: the ray jitter and the prior's points
    DRAW_KEYS = ("noise", "sparsity_points")

    def __init__(self, hparams, train_dataset=None, test_dataset=None,
                 device=None, seed=None, params=None):
        _check_ported(hparams)
        if train_dataset is None:
            train_dataset, test_dataset = _datasets_from_hparams(hparams)
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
        k_model, k_emb, _ = prng.split(prng.prng_key(seed), 3)
        self.base_key = prng.prng_key(seed + 1)
        if params is None:
            params = {
                "model": ngp_init(self.model_cfg, k_model, dev),
                "embedding_a": 0.01 * prng.normal(
                    k_emb, (train_dataset.n_images, hparams.embed_a_len),
                    dev),
            }
        else:
            params = params_from_numpy(params, dev, self.model_cfg)
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
        ray jitter (n,) uniform in [0, 1), and with a sparsity prior
        "sparsity_points" (SPARSITY_POINTS, 3) uniform in [-scale,
        scale]^3. CPU tensors; `stage_batch` copies them to the device."""
        key = prng.fold_in(self.base_key,
                           self.global_step if step is None else step)
        out = {"noise": prng.uniform(prng.split(key)[0], (n,))}
        if self.loss_cfg.lambda_sparsity > 0:
            s = self.model_cfg.scale
            out["sparsity_points"] = prng.uniform(
                prng.fold_in(key, 7), (SPARSITY_POINTS, 3), -s, s)
        return out

    def loss_and_grads(self, batch, noise, sparsity_points=None):
        """(aux, grads) of one batch on the current grid: aux as
        `train_step` returns it, grads a tree like params (zeros for
        leaves the loss does not reach). With a sparsity prior
        (lambda_sparsity > 0), its density is taken at sparsity_points
        (N, 3), or at this step's draw."""
        b = {k: self._on_device(v) for k, v in batch.items()
             if k in self.BATCH_KEYS}
        rays_o, rays_d = get_rays(self.directions[b["pix_idxs"].long()],
                                  self.poses[b["img_idxs"].long()])
        results = render_rays(self.model_cfg, self.render_cfg,
                              self.params["model"], self.grid["bitfield"],
                              rays_o.contiguous(), rays_d.contiguous(),
                              self._on_device(noise),
                              block_table=self.grid["block_table"])
        if self.loss_cfg.lambda_sparsity > 0:
            pts = self._on_device(sparsity_points) \
                if sparsity_points is not None \
                else self.stage_batch(self.step_draws(0))["sparsity_points"]
            results["sparsity"] = ngp_sigma(self.model_cfg,
                                            self.params["model"], pts)
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
        with the ray jitter batch["noise"] and the prior's points
        batch["sparsity_points"] or, without them, this step's draws.
        Returns aux (loss, psnr, s_per_ray, loss_terms)."""
        if "noise" not in batch:
            batch = {**self.stage_batch(self.step_draws(
                len(batch["pix_idxs"]))), **batch}
        aux, grads = self.loss_and_grads(batch, batch["noise"],
                                         batch.get("sparsity_points"))
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
        """{"params", "opt_state": adam_state_to_numpy(), "grid", "step"}:
        numpy copies, the JAX package's layouts (its `state()` less the
        auto-calibrated stream caps, which the port does not have)."""
        return {"params": self.params_to_numpy(),
                "opt_state": self.adam_state_to_numpy(),
                "grid": {k: _host_array(v.cpu())
                         for k, v in self.grid.items()},
                "step": self.global_step}

    def save(self, path):
        save_ckpt(path, self.state())

    def load(self, path):
        self.load_state(load_ckpt(path))

    def load_state(self, state):
        """Load a state() tree (numpy or CPU tensor leaves). The params it
        holds replace the system's (a slim checkpoint's too), its Adam
        state and grid where it has them; the step always."""
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
        self.global_step = int(state.get("step", 0))

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
        (JAX trainer :709-834): batches from the train dataset's numpy
        sampler (seeded from hparams.seed unless rng is given), each
        staged while the step before it runs; a log line every
        log_every steps; with ckpt_dir, a metrics logger there, an
        epoch checkpoint under ckpt_dir/steps (and a resume from its
        latest step when the system starts at step 0), and the final
        `last` and `last_slim` checkpoints. on_step(step, aux) is
        called after every step.

        Raises NotImplementedError, before any step, for what the port
        does not have: the native loader (use_native_loader=True),
        hparams.profile_dir, and with ckpt_dir a run that would reach a
        multiple of VAL_DUMP_EVERY steps, where the JAX loop writes
        validation images."""
        h = self.hparams
        if use_native_loader:
            raise NotImplementedError(
                "the native batch loader is not ported yet (ROADMAP.md "
                "Queue 1 item 7)")
        if getattr(h, "profile_dir", None):
            raise NotImplementedError("profile_dir is not ported yet")
        rng = rng or np.random.default_rng(h.seed)
        total_steps = self.total_steps
        logger = ckpt_mgr = None
        try:
            if ckpt_dir:
                os.makedirs(ckpt_dir, exist_ok=True)
                ckpt_mgr = AsyncCkptManager(os.path.join(ckpt_dir, "steps"))
                latest = ckpt_mgr.latest_step()
                if (latest is not None and self.global_step == 0
                        and not getattr(h, "no_resume", False)):
                    self.load_state(ckpt_mgr.restore(latest))
                    print(f"resumed from {ckpt_dir}/steps @ step "
                          f"{self.global_step}", flush=True)
                dump = -(-max(self.global_step, 1) // VAL_DUMP_EVERY) \
                    * VAL_DUMP_EVERY
                if dump < total_steps:
                    raise NotImplementedError(
                        f"this run reaches step {dump}, where the training "
                        f"loop writes validation images; utils/vis is not "
                        f"ported yet (ROADMAP.md Queue 1 item 3)")
                logger = make_logger(getattr(h, "logger", "jsonl"),
                                     ckpt_dir, getattr(h, "exp_name", "exp"))
            self._run(total_steps, rng, log_every, logger, ckpt_mgr, on_step)
        finally:
            if logger:
                logger.close()
            if ckpt_mgr:
                ckpt_mgr.close()
        if ckpt_dir:
            self.save(os.path.join(ckpt_dir, "last"))
            save_ckpt(os.path.join(ckpt_dir, "last_slim"),
                      slim_state(self.state()))
        return self

    def _run(self, total_steps, rng, log_every, logger, ckpt_mgr, on_step):
        h = self.hparams
        t0 = time.time()
        rays_done = 0

        def batch_of(step):
            b = self.train_dataset.sample_batch(rng)
            return self.stage_batch({**self.step_draws(
                len(b["pix_idxs"]), step), **b})

        staged = batch_of(self.global_step)
        for step in range(self.global_step, total_steps):
            aux = self.training_step(staged)
            if step + 1 < total_steps:
                staged = batch_of(step + 1)
            rays_done += h.batch_size
            if on_step is not None:
                on_step(step, aux)
            if log_every and step % log_every == 0:
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
            if ckpt_mgr and (step + 1) % h.steps_per_epoch == 0:
                ckpt_mgr.save(step + 1, self.state())
