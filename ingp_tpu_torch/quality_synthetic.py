"""The port's quality gate on the hermetic synthetic scene:

    python -m ingp_tpu_torch.quality_synthetic [--steps 600 --seed 0 ...]

Trains the bench-width brick model (the hparams of
benchmarking/quality_synthetic.py, the JAX package's quality run, plus
the stream-dedup encoder: bf16 tables and MLPs, capacity 48, 24 samples
per ray, encode chunk 98,304, so the 196,608-sample stream runs in two
chunks, and the sparsity prior) for 600 steps of 8192 rays drawn by
`sample_batch` from 100 train views at 256 px, then validates on 4 test
views and prints `RESULT novel-view psnr .. ssim ..`.

Exits 1 below the bar: novel-view PSNR >= 26.0 dB and SSIM >= 0.865.
The bar sits under the healthy readings of this configuration in the
JAX package's quality runs (26.13-26.77 dB, SSIM 0.872-0.886,
PERF_NOTES.md) and far above their failure signatures (24.04 / 0.818 for
a ray-noise defect, 20.3-21.1 / 0.75-0.76 for stream-cap overflow).
Those are image-quality numbers, not speeds.
"""
from __future__ import annotations

import argparse
import sys
import time
from types import SimpleNamespace

import numpy as np

PSNR_BAR = 26.0
SSIM_BAR = 0.865


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--capacity", type=int, default=48)
    ap.add_argument("--spr", type=int, default=24)
    ap.add_argument("--chunk", type=int, default=98304)
    ap.add_argument("--img_size", type=int, default=256)
    ap.add_argument("--n_train", type=int, default=100)
    ap.add_argument("--sparsity", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the init and a step's draws (the JAX "
                         "trainer's keys) and of the batch sampler; the "
                         "JAX quality run's is 0")
    return ap


def gate_hparams(args, **overrides):
    """The quality run's hparams namespace (`overrides` replace fields,
    e.g. the model's widths for a small test)."""
    h = dict(
        dataset_name="synthetic", root_dir="", split="train",
        downsample=1.0, scale=0.5, use_skybox=False, use_exposure=False,
        embed_a=False, embed_a_len=4, embed_msk=False, num_classes=7,
        batch_size=args.batch, ray_sampling_strategy="all_images",
        num_epochs=1, normal_epochs=0, steps_per_epoch=args.steps,
        lr=1e-2, density_threshold=1e-2, depth_mono=False,
        normal_mono=False, normal_ref=True, optimize_ext=False,
        random_bg=False, render_semantic=False, chunk_size=131072,
        seed=args.seed, ckpt_load=None, compute_dtype="bfloat16",
        capacity=args.capacity, march_iters=1024,
        samples_per_ray=args.spr, encoder="brick",
        table_dtype="bfloat16", encode_chunk=args.chunk,
        sparsity_loss=args.sparsity, stream_dedup=True, stream_tile=256,
        stream_slack=1.5, stream_seg=4, stream_direct_frac=0.7,
        stream_sort=True, stream_seg_head=20, stream_head_frac=0.0,
        stream_autocal=False)
    h.update(overrides)
    return SimpleNamespace(**h)


def run(argv=None, device=None, on_step=None, **overrides):
    """Train and validate; returns {"psnr", "ssim", "train_s",
    "rays_per_s", "losses"} (the loss of every step). on_step(step, aux)
    is called after every step."""
    from .data.synthetic import SyntheticDataset
    from .training.trainer import NeRFSystem
    args = build_parser().parse_args(argv)
    h = gate_hparams(args, **overrides)
    tr = SyntheticDataset(split="train", img_size=args.img_size,
                          n_train=args.n_train)
    te = SyntheticDataset(split="test", img_size=args.img_size, n_test=4)
    system = NeRFSystem(h, tr, te, device=device)
    rng = np.random.default_rng(args.seed)
    losses = []
    t0 = time.time()
    for step in range(args.steps):
        aux = system.training_step(
            system.stage_batch(tr.sample_batch(rng, args.batch)))
        losses.append(aux["loss"])
        if on_step is not None:
            on_step(step, aux)
        if step % 100 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(aux['loss']):.5f} "
                  f"psnr {float(aux['psnr']):.2f} "
                  f"s/ray {float(aux['s_per_ray']):.1f}", flush=True)
    losses = [float(v) for v in losses]
    dt = time.time() - t0
    print(f"train: {args.steps} steps in {dt:.1f}s "
          f"({args.steps * args.batch / dt:,.0f} rays/s incl. host)",
          flush=True)
    m = system.validate()
    print(f"RESULT novel-view psnr {m['psnr']:.2f} ssim {m['ssim']:.4f}",
          flush=True)
    return {**m, "train_s": dt, "rays_per_s": args.steps * args.batch / dt,
            "losses": losses}


def passes(metrics) -> bool:
    return metrics["psnr"] >= PSNR_BAR and metrics["ssim"] >= SSIM_BAR


def main(argv=None) -> int:
    m = run(argv)
    ok = passes(m)
    print(f"gate {'passed' if ok else 'FAILED'}: bar psnr >= {PSNR_BAR} and "
          f"ssim >= {SSIM_BAR}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
