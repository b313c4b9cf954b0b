"""Minimal NeRF system for test rendering (counterpart of the parts of
ingp_tpu/training/trainer.py that the test render uses: the hparams ->
config mapping, :46-100, and `NeRFSystem.render_image`, :584-658).
Optimisation, `fit` and `validate` come with the training slice."""
from __future__ import annotations

import numpy as np
import torch

from ..core.rays import get_rays
from ..device import resolve_device
from ..grid.occupancy import grid_init
from ..models.ngp import NGPConfig, ngp_init, params_from_numpy
from ..models.rendering import MAX_SAMPLES, RenderConfig, render_rays_test

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


class NeRFSystem:
    """Holds the model parameters and the occupancy grid, and renders
    test views.

    Args:
      hparams: the JAX trainer's hparams namespace.
      test_dataset: dataset whose `directions` the views are cast from.
      device: where everything lives (default CUDA; "cpu" runs the
        kernels' plain versions).
      seed: seed of the torch.Generator that draws the initial params.
      params: optional numpy `ngp_init` tree to start from instead.
    """

    def __init__(self, hparams, test_dataset, device=None, seed=0,
                 params=None):
        self.hparams = hparams
        self.device = resolve_device(device)
        self.model_cfg = model_config_from_hparams(hparams)
        self.render_cfg_test = render_config_from_hparams(hparams, test=True)
        self.test_dataset = test_dataset
        self.directions = torch.as_tensor(test_dataset.directions,
                                          device=self.device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.params = ngp_init(self.model_cfg, gen, self.device)
        else:
            self.params = params_from_numpy(params, self.device)
        self.grid = grid_init(self.model_cfg.cascades,
                              self.model_cfg.grid_size, self.device)

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
                                   self.params, self.grid["bitfield"],
                                   ro.contiguous(), rd.contiguous(),
                                   block_table=self.grid["block_table"])
            if pad:
                res = {k: v[:-pad] if v.ndim >= 1 and v.shape[0] == blk
                       else v for k, v in res.items()}
            outs.append(res)
        merged = {k: torch.cat([o[k] for o in outs], 0)
                  for k in outs[0] if k != "total_samples"}
        merged["total_samples"] = sum(int(o["total_samples"]) for o in outs)
        return merged
