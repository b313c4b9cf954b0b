"""Training entry point of the port: `python -m ingp_tpu_torch.train
--config cfg.txt ...` (counterpart of ingp_tpu/train.py).

Parses the flags (training/config.py, plus the port's --profile_dir),
builds `NeRFSystem(hparams)` on the card (or on `device`), trains with
`fit` into ckpts/<dataset_name>/<exp_name> (epoch checkpoints, `last`,
`last_slim`) unless --val_only, then validates on the test split and
prints `test/psnr .. test/ssim ..`; after training, unless
--no_save_test, rank 0 renders the test split (or the camera path) into
results/<dataset_name>/<exp_name> (`render.offline.render_for_test`).

Data parallelism (JAX: ingp_tpu/train.py:27-42):
- `--num_gpus n` (n > 1) starts n ranks itself, processes made with the
  spawn start method that join a group over a file in a temporary
  directory, unless this process already is a rank of a group; rank r
  runs on cuda:(r % cards), one global batch of batch_size rays is split
  n ways. NCCL when each rank has a card, gloo when ranks share one.
- `--distributed` (or a --coordinator_address) joins a group through
  `parallel.init_distributed(coordinator_address, num_processes,
  process_id)`, env:// without them (torchrun); each process feeds its
  own batch_size rays (a global batch of n x batch_size) and
  --num_gpus is ignored.
Every rank returns the metrics; rank 0 prints.

--debug_nans stops at the first NaN or infinity in a loss term or a
gradient (FloatingPointError; `NeRFSystem`'s docstring), where JAX
turns on jax_debug_nans.
"""
from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch.distributed as dist

from .parallel.distributed import init_distributed
from .parallel.mesh import world_from_group
from .render.offline import render_for_test
from .training.config import get_opts
from .training.trainer import NeRFSystem


def _port_args(parser):
    """The port's own flags (the JAX CLI reads profile_dir from a
    namespace only)."""
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler Chrome trace of "
                             "steps 20-29 of fit here")


def parse_args(argv=None):
    return get_opts(argv, add_args=_port_args)


def _rank_main(index, argv, device, init_method, n, threads, queue):
    """Rank `index` of a --num_gpus run: join the group, train, report;
    torch's intra-op threads as many as the parent's."""
    import torch
    torch.set_num_threads(threads)
    init_distributed(init_method, n, index, device=device)
    try:
        queue.put((index, main(argv, device=device)))
    finally:
        dist.destroy_process_group()


def _spawn(argv, device, n):
    """Run n ranks of `main(argv)` in spawned processes; rank 0's
    metrics."""
    import torch
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="ingp-dp-")
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    try:
        mp.start_processes(
            _rank_main, args=(argv, device,
                              f"file://{os.path.join(tmp, 'store')}", n,
                              torch.get_num_threads(), queue),
            nprocs=n, join=True, start_method="spawn")
        results = dict(queue.get() for _ in range(n))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return results[0]


def main(argv=None, device=None):
    """Train and validate as the flags say; returns the test metrics
    {"psnr", "ssim"} and with --eval_lpips "lpips". device: where the
    system lives (default CUDA)."""
    hparams = parse_args(argv)
    if hparams.val_only and not hparams.ckpt_load:
        raise ValueError("you need to provide --ckpt_load when --val_only")
    world = None
    if hparams.distributed or hparams.coordinator_address:
        if init_distributed(hparams.coordinator_address,
                            hparams.num_processes, hparams.process_id,
                            device=device):
            world = world_from_group(device, feeds_own_batch=True)
    elif hparams.num_gpus > 1:
        if not dist.is_initialized():
            return _spawn(argv, device, hparams.num_gpus)
        world = world_from_group(device)
    np.random.seed(hparams.seed)
    system = NeRFSystem(hparams, device=device, world=world)
    ckpt_dir = os.path.join("ckpts", hparams.dataset_name, hparams.exp_name)
    os.makedirs(ckpt_dir, exist_ok=True)
    if not hparams.val_only:
        system.fit(ckpt_dir=ckpt_dir)
    metrics = system.validate()
    if system.is_main:
        lp = f"  test/lpips {metrics['lpips']:.4f}" if "lpips" in metrics \
            else ""
        print(f"test/psnr {metrics['psnr']:.3f}  test/ssim "
              f"{metrics['ssim']:.4f}{lp}", flush=True)
        if not hparams.no_save_test and not hparams.val_only:
            render_for_test(hparams, system=system)
    return metrics


if __name__ == "__main__":
    main()
