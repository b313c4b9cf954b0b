"""Mesh extraction entry point of the port: `python -m
ingp_tpu_torch.extract_mesh_cli --config cfg.txt --ckpt_load ...`
(counterpart of ingp_tpu/extract_mesh_cli.py, with its flags
--mesh_resolution X Y Z and --sigma_threshold). Writes
results/<dataset_name>/<exp_name>/mesh.ply.
"""
from __future__ import annotations

import os

from .models.ngp import ngp_sigma
from .render.mesh import extract_mesh
from .training.config import get_opts
from .training.trainer import NeRFSystem


def add_args(parser):
    """The flags that this entry point adds to training's."""
    parser.add_argument("--mesh_resolution", type=int, nargs=3,
                        default=[512, 128, 512],
                        help="density probe grid")
    parser.add_argument("--sigma_threshold", type=float, default=10.0)


def main(argv=None, device=None):
    """Extract the mesh as the flags say on the card (or on `device`);
    returns (vertices, faces)."""
    hparams = get_opts(argv, add_args)
    system = NeRFSystem(hparams, device=device)
    out_dir = os.path.join("results", hparams.dataset_name, hparams.exp_name)
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, "mesh.ply")
    cfg = system.model_cfg
    verts, faces = extract_mesh(
        lambda params, x: ngp_sigma(cfg, params, x),
        system.params["model"], hparams.scale,
        resolution=tuple(hparams.mesh_resolution),
        sigma_threshold=hparams.sigma_threshold, out_path=out_path)
    print(f"wrote {len(verts)} verts / {len(faces)} faces to {out_path}",
          flush=True)
    return verts, faces


if __name__ == "__main__":
    main()
