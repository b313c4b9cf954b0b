"""Training entry point of the port: `python -m ingp_tpu_torch.train
--config cfg.txt ...` (counterpart of ingp_tpu/train.py).

Parses the flags (training/config.py), builds `NeRFSystem(hparams)` on
the card (or on `device`), trains with `fit` into
ckpts/<dataset_name>/<exp_name> (epoch checkpoints, `last`, `last_slim`)
unless --val_only, then validates on the test split and prints
`test/psnr .. test/ssim ..`.
"""
from __future__ import annotations

import os

import numpy as np

from .training.config import get_opts
from .training.trainer import NeRFSystem


def _check_ported(h):
    """Raise on what the JAX entry point does and the port does not."""
    off = []
    if not h.no_save_test and not h.val_only:
        off.append("the offline test render (pass --no_save_test; "
                   "ROADMAP.md Queue 1 item 8)")
    if h.distributed or h.coordinator_address:
        off.append("--distributed / --coordinator_address (ROADMAP.md "
                   "Queue 1 item 9)")
    if h.num_gpus > 1:
        off.append("--num_gpus > 1 (ROADMAP.md Queue 1 item 9)")
    if h.debug_nans:
        off.append("--debug_nans")
    if off:
        raise NotImplementedError(f"not ported yet: {'; '.join(off)}")


def main(argv=None, device=None):
    """Train and validate as the flags say; returns the test metrics
    {"psnr", "ssim"}. device: where the system lives (default CUDA)."""
    hparams = get_opts(argv)
    if hparams.val_only and not hparams.ckpt_load:
        raise ValueError("you need to provide --ckpt_load when --val_only")
    _check_ported(hparams)
    np.random.seed(hparams.seed)
    system = NeRFSystem(hparams, device=device)
    ckpt_dir = os.path.join("ckpts", hparams.dataset_name, hparams.exp_name)
    os.makedirs(ckpt_dir, exist_ok=True)
    if not hparams.val_only:
        system.fit(ckpt_dir=ckpt_dir)
    metrics = system.validate()
    print(f"test/psnr {metrics['psnr']:.3f}  test/ssim "
          f"{metrics['ssim']:.4f}", flush=True)
    return metrics


if __name__ == "__main__":
    main()
