"""Auxiliary render passes (counterpart of ingp_tpu/render/aux_heads.py):
semantic pseudo-labels and up-facing-surface masks of every pose of a
dataset, written as PGM. Like the JAX passes they render through
`render_chunks` without a block table, so the march is the per-point
lattice marcher.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..core.rays import get_rays
from ..data.image_io import write_pgm
from .offline import render_chunks


def _pose_renders(model_cfg, render_cfg, params, bitfield, dataset,
                  chunk_size, embedding_a):
    """(index, render_chunks outputs as numpy) of each dataset pose."""
    dev = bitfield.device
    directions = torch.as_tensor(dataset.directions, device=dev)
    for i in range(len(dataset.poses)):
        rays_o, rays_d = get_rays(
            directions, torch.as_tensor(dataset.poses[i], device=dev))
        res = render_chunks(model_cfg, render_cfg, params, bitfield, rays_o,
                            rays_d, chunk_size, embedding_a=embedding_a)
        yield i, {k: v.cpu().numpy() for k, v in res.items()
                  if torch.is_tensor(v)}


def render_semantic_labels(model_cfg, render_cfg, params, bitfield,
                           dataset, out_dir, chunk_size=131072,
                           embedding_a=None):
    """The argmax semantic label of every pixel of every dataset pose,
    as out_dir/semantic_pred/%05d.pgm. Returns that directory."""
    w, h = dataset.img_wh
    d = os.path.join(out_dir, "semantic_pred")
    os.makedirs(d, exist_ok=True)
    for i, res in _pose_renders(model_cfg, render_cfg, params, bitfield,
                                dataset, chunk_size, embedding_a):
        label = res["semantic"].reshape(h, w).astype(np.uint8)
        write_pgm(os.path.join(d, f"{i:05d}.pgm"), label)
    return d


def render_up_normal_masks(model_cfg, render_cfg, params, bitfield,
                           dataset, up, out_dir, chunk_size=131072,
                           cos_threshold=0.5, embedding_a=None):
    """Masks of the surfaces that face `up`, as
    out_dir/normal_up/msk_%05d.pgm: 255 cos(normal, up) where that
    cosine is above cos_threshold and the composited normal is nonzero,
    else 0. Returns that directory."""
    w, h = dataset.img_wh
    up = np.asarray(up, np.float32)
    up = up / np.linalg.norm(up)
    d = os.path.join(out_dir, "normal_up")
    os.makedirs(d, exist_ok=True)
    for i, res in _pose_renders(model_cfg, render_cfg, params, bitfield,
                                dataset, chunk_size, embedding_a):
        normal = res["normal_pred"].reshape(-1, 3)
        nrm = np.linalg.norm(normal, axis=-1, keepdims=True)
        valid = (nrm != 0)[:, 0]
        cos = (normal @ up) / np.maximum(nrm[:, 0], 1e-6)
        near_up = (cos > cos_threshold) & valid
        mask = (near_up * cos * 255).clip(0, 255).reshape(h, w)
        write_pgm(os.path.join(d, f"msk_{i:05d}.pgm"), mask.astype(np.uint8))
    return d
