"""Export LPIPS(alex) weights to the self-contained .npz that
training/lpips.py reads (counterpart of ingp_tpu/utils/export_lpips.py).

The JAX package's exporter downloads the AlexNet trunk through
torchvision. This one reads both parts from local files, so it runs on a
machine with neither network nor torchvision:

    python -m ingp_tpu_torch.utils.export_lpips lpips_alex.npz \\
        ALEXNET.pth ALEX_LINS.pth

- ALEXNET.pth: torchvision's AlexNet (IMAGENET1K_V1) state dict, or at
  least its trunk, `features.{0,3,6,8,10}.{weight,bias}`;
- ALEX_LINS.pth: LPIPS v0.1 `alex.pth` (richzhang/PerceptualSimilarity,
  `lin{i}.model.1.weight`).

It writes the keys and layouts of the JAX exporter (conv weights HWIO),
so either package reads the file:

    python -m ingp_tpu_torch.train ... --eval_lpips \\
        --lpips_weights lpips_alex.npz
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..training.lpips import SCALE, SHIFT

# AlexNet's conv layers in torchvision's `features` Sequential
TRUNK = (0, 3, 6, 8, 10)


def export(out_path: str, alexnet_path: str, lins_path: str) -> None:
    trunk = torch.load(alexnet_path, map_location="cpu", weights_only=True)
    lins = torch.load(lins_path, map_location="cpu", weights_only=True)
    out = {}
    for i, j in enumerate(TRUNK):
        # torch OIHW -> HWIO
        out[f"conv{i}_w"] = trunk[f"features.{j}.weight"].detach().numpy(
            ).transpose(2, 3, 1, 0)
        out[f"conv{i}_b"] = trunk[f"features.{j}.bias"].detach().numpy()
    for i in range(5):
        out[f"lin{i}"] = (
            lins[f"lin{i}.model.1.weight"].detach().numpy().reshape(-1))
    out["shift"] = np.asarray(SHIFT, np.float32)
    out["scale"] = np.asarray(SCALE, np.float32)
    np.savez(out_path, **out)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    if len(sys.argv) != 4:
        raise SystemExit("usage: python -m ingp_tpu_torch.utils."
                         "export_lpips OUT.npz ALEXNET.pth ALEX_LINS.pth")
    export(*sys.argv[1:])
