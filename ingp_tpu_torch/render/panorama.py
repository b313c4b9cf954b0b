"""Equirectangular panoramas (counterpart of ingp_tpu/render/panorama.py).

`render_panorama` casts a longitude / latitude grid of rays from a scene
point, renders it in chunks (no block table: the per-point lattice
marcher, as in the JAX package) and writes rgb, opacity and inpaint-mask
PNGs; `sample_panorama` is the inverse lookup, directions -> bilinear
samples of a panorama (grid_sample's align_corners=True rule, with the
JAX package's clamping at the edges).
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..data.image_io import write_png
from .offline import render_chunks


def panorama_directions(H, W, v_forward, v_down, v_right, device=None):
    """(H*W, 3) float32 unit directions of an H x W equirect grid around
    the basis v_forward, v_down, v_right."""
    f32 = dict(dtype=torch.float32, device=device)
    fwd, down, right = (torch.as_tensor(np.asarray(v, np.float32),
                                        device=device)
                        for v in (v_forward, v_down, v_right))
    u, v = torch.meshgrid(torch.arange(W, **f32), torch.arange(H, **f32),
                          indexing="xy")
    thetas = ((u - W / 2 + 0.5) * 2 * math.pi / W).reshape(-1, 1)
    phis = ((v - H / 2 + 0.5) * math.pi / H).reshape(-1, 1)
    d = (torch.sin(phis) * down[None]
         + torch.cos(phis) * torch.sin(thetas) * right[None]
         + torch.cos(phis) * torch.cos(thetas) * fwd[None])
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def render_panorama(model_cfg, render_cfg, params, bitfield, out_dir,
                    pano_hw=(512, 1024), origin=(0.0, 0.0, 0.0),
                    v_forward=(0, 0, 1.0), v_down=(0, 1.0, 0),
                    v_right=(1.0, 0, 0), pano_radius=0.0,
                    chunk_size=131072, embedding_a=None):
    """Render the panorama around `origin` (rays start pano_radius out
    along their direction) and write out_dir/panorama/{rgb, opacity,
    mask}/0.png (mask: 255 where the opacity is below 0.5). Returns
    numpy {"rgb" (H, W, 3), "opacity" (H, W), "mask", "directions"}."""
    H, W = pano_hw
    dev = bitfield.device
    rays_d = panorama_directions(H, W, v_forward, v_down, v_right, dev)
    rays_o = torch.as_tensor(np.asarray(origin, np.float32), device=dev
                             ).expand_as(rays_d) + rays_d * pano_radius
    res = render_chunks(model_cfg, render_cfg, params, bitfield, rays_o,
                        rays_d, chunk_size, embedding_a=embedding_a)
    rgb = np.clip(res["rgb"].cpu().numpy().reshape(H, W, 3), 0, 1)
    opacity = res["opacity"].cpu().numpy().reshape(H, W)
    mask = (opacity < 0.5).astype(np.uint8) * 255
    for sub, img in [("rgb", (rgb * 255).astype(np.uint8)),
                     ("opacity", (opacity * 255).astype(np.uint8)),
                     ("mask", mask)]:
        d = os.path.join(out_dir, "panorama", sub)
        os.makedirs(d, exist_ok=True)
        write_png(os.path.join(d, "0.png"), img)
    return {"rgb": rgb, "opacity": opacity, "mask": mask,
            "directions": rays_d.cpu().numpy()}


def sample_panorama(directions, panorama, v_forward, v_down, v_right):
    """Bilinear samples (n, C) of an (H, W, C) panorama in the directions
    (n, 3), in float64, returned in the panorama's dtype."""
    panorama = torch.as_tensor(panorama)
    dev = panorama.device
    d = torch.as_tensor(directions, device=dev).to(torch.float64)
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-9)
    basis = torch.as_tensor(np.stack([v_forward, v_right, v_down]),
                            device=dev).to(torch.float64)
    x, y, z = (d @ basis.T).T
    thetas = torch.atan(torch.where(x != 0, y / torch.where(x != 0, x, 1.0),
                                    0.0))
    thetas = thetas + math.pi * ((x < 0) & (y > 0)) \
        - math.pi * ((x < 0) & (y < 0))
    phis = torch.asin(torch.clamp(z, -1, 1))
    H, W, _ = panorama.shape
    fx = (thetas / math.pi + 1) / 2 * (W - 1)
    fy = (phis * 2 / math.pi + 1) / 2 * (H - 1)
    x0 = torch.clamp(torch.floor(fx).long(), 0, W - 1)
    y0 = torch.clamp(torch.floor(fy).long(), 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    wx = (fx - x0)[:, None]
    wy = (fy - y0)[:, None]
    p = panorama.to(torch.float64)
    out = (p[y0, x0] * ((1 - wx) * (1 - wy)) + p[y0, x1] * (wx * (1 - wy))
           + p[y1, x0] * ((1 - wx) * wy) + p[y1, x1] * (wx * wy))
    return out.to(panorama.dtype)
