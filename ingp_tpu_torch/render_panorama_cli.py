"""Panorama entry point of the port: `python -m
ingp_tpu_torch.render_panorama_cli --config cfg.txt --ckpt_load ...`
(counterpart of ingp_tpu/render_panorama_cli.py, with its flags:
--pano_h, --pano_w, --pano_radius, --v_forward, --v_down, --v_right,
--pano_origin). Writes results/<dataset_name>/<exp_name>/panorama/
{rgb, opacity, mask}/0.png.
"""
from __future__ import annotations

import os

from .render.panorama import render_panorama
from .training.config import get_opts
from .training.trainer import NeRFSystem


def add_args(parser):
    """The flags that this entry point adds to training's."""
    parser.add_argument("--pano_h", type=int, default=512)
    parser.add_argument("--pano_w", type=int, default=1024)
    parser.add_argument("--pano_radius", type=float, default=0.0)
    parser.add_argument("--v_forward", type=float, nargs=3,
                        default=[0, 0, 1.0])
    parser.add_argument("--v_down", type=float, nargs=3,
                        default=[0, 1.0, 0])
    parser.add_argument("--v_right", type=float, nargs=3,
                        default=[1.0, 0, 0])
    parser.add_argument("--pano_origin", type=float, nargs=3,
                        default=[0.0, 0.0, 0.0])


def main(argv=None, device=None):
    """Render the panorama as the flags say on the card (or on
    `device`); returns render_panorama's result."""
    args = get_opts(argv, add_args)
    system = NeRFSystem(args, device=device)
    out_dir = os.path.join("results", args.dataset_name, args.exp_name)
    emb = system.params["embedding_a"][0:1].detach() if args.embed_a \
        else None
    res = render_panorama(
        system.model_cfg, system.render_cfg_test, system.params["model"],
        system.grid["bitfield"], out_dir, pano_hw=(args.pano_h, args.pano_w),
        origin=args.pano_origin, v_forward=args.v_forward,
        v_down=args.v_down, v_right=args.v_right,
        pano_radius=args.pano_radius, chunk_size=args.chunk_size,
        embedding_a=emb)
    print(f"wrote panorama to {out_dir}/panorama "
          f"(opacity mean {res['opacity'].mean():.3f})", flush=True)
    return res


if __name__ == "__main__":
    main()
