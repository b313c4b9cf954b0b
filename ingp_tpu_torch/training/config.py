"""Experiment flags (the port's own copy of ingp_tpu/training/config.py:
the same flags, defaults and `--config` merge order).

`--config file.txt` reads the `key = value` txt format of configs/*.txt;
flags given on the command line override the file's values
(configargparse semantics). Flags for what the port has not ported yet
parse as they do in the JAX package; the trainer and `train.main`
refuse them where they would act.
"""
from __future__ import annotations

import argparse
import os
import shlex
import sys

DATASET_CHOICES = ["nerf", "nsvf", "colmap", "nerfpp", "rtmv", "tnt",
                   "kitti", "mega", "highbay", "synthetic"]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="ingp_tpu_torch")
    parser.add_argument("--config", type=str, default=None,
                        help="config file path (key = value lines)")
    # common args for all datasets (opt.py:9-20)
    parser.add_argument("--root_dir", type=str, default=None)
    parser.add_argument("--dataset_name", type=str, default="nerf",
                        choices=DATASET_CHOICES)
    parser.add_argument("--split", type=str, default="train",
                        choices=["train", "trainval"])
    parser.add_argument("--downsample", type=float, default=1.0)
    parser.add_argument("--anti_aliasing_factor", type=float, default=1.0)
    # model parameters (opt.py:22-36)
    parser.add_argument("--scale", type=float, default=0.5)
    parser.add_argument("--use_skybox", action="store_true", default=False)
    parser.add_argument("--use_exposure", action="store_true", default=False)
    parser.add_argument("--embed_a", action="store_true", default=False)
    parser.add_argument("--embed_a_len", type=int, default=4)
    parser.add_argument("--embed_msk", action="store_true", default=False)
    parser.add_argument("--num_classes", type=int, default=7)
    # kitti (opt.py:38-48)
    parser.add_argument("--kitti_seq", type=int, default=0)
    parser.add_argument("--kitti_start", type=int, default=1538)
    parser.add_argument("--kitti_end", type=int, default=1601)
    parser.add_argument("--kitti_test_id", type=int, nargs="+", default=[])
    parser.add_argument("--nvs", action="store_true", default=False)
    # mega (opt.py:50-52)
    parser.add_argument("--mega_frame_start", type=int, default=753)
    parser.add_argument("--mega_frame_end", type=int, default=846)
    # training options (opt.py:54-78)
    parser.add_argument("--batch_size", type=int, default=8192)
    parser.add_argument("--ray_sampling_strategy", type=str,
                        default="all_images",
                        choices=["all_images", "same_image"])
    parser.add_argument("--num_epochs", type=int, default=30)
    parser.add_argument("--normal_epochs", type=int, default=20)
    parser.add_argument("--num_gpus", type=int, default=1,
                        help="data-parallel device count")
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--density_threshold", type=float, default=1e-2)
    parser.add_argument("--depth_mono", action="store_true", default=False)
    parser.add_argument("--normal_mono", action="store_true", default=False)
    parser.add_argument("--normal_ref", action="store_true", default=False)
    # experimental (opt.py:80-85)
    parser.add_argument("--optimize_ext", action="store_true", default=False)
    parser.add_argument("--random_bg", action="store_true", default=False)
    # validation (opt.py:87-97)
    parser.add_argument("--eval_lpips", action="store_true", default=False)
    parser.add_argument("--lpips_weights", type=str, default=None,
                        help="exported LPIPS .npz; required with "
                             "--eval_lpips")
    parser.add_argument("--val_only", action="store_true", default=False)
    parser.add_argument("--no_save_test", action="store_true", default=False)
    parser.add_argument("--render_traj", action="store_true", default=False)
    parser.add_argument("--render_train", action="store_true", default=False)
    # misc (opt.py:99-105)
    parser.add_argument("--exp_name", type=str, default="exp")
    parser.add_argument("--ckpt_load", type=str, default=None)
    parser.add_argument("--ckpt_save", type=str, default="checkpoint.ckpt")
    # render (opt.py:107-121)
    parser.add_argument("--render_rgb", action="store_true", default=False)
    parser.add_argument("--render_depth", action="store_true", default=False)
    parser.add_argument("--render_normal", action="store_true",
                        default=False)
    parser.add_argument("--render_semantic", action="store_true",
                        default=False)
    parser.add_argument("--normal_composite", action="store_true",
                        default=False)
    parser.add_argument("--render_points", action="store_true",
                        default=False)
    parser.add_argument("--chunk_size", type=int, default=131072)
    # framework extras (not in opt.py)
    parser.add_argument("--steps_per_epoch", type=int, default=1000,
                        help="pseudo-epoch length (datasets/base.py:17-20)")
    parser.add_argument("--compute_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--capacity", type=int, default=192,
                        help="per-ray sample slots S")
    parser.add_argument("--march_iters", type=int, default=1024)
    parser.add_argument("--samples_per_ray", type=int, default=48,
                        help="network batch budget K/R")
    parser.add_argument("--seed", type=int, default=20220806)  # train.py:402
    # model-size overrides (default = reference op-point networks.py:36,63)
    parser.add_argument("--grid_size", type=int, default=128)
    parser.add_argument("--density_L", type=int, default=16)
    parser.add_argument("--density_F", type=int, default=8)
    parser.add_argument("--density_log2T", type=int, default=19)
    parser.add_argument("--rgb_L", type=int, default=16)
    parser.add_argument("--rgb_F", type=int, default=8)
    parser.add_argument("--rgb_log2T", type=int, default=21)
    parser.add_argument("--encoder", type=str, default="hash",
                        choices=["hash", "brick", "fused"],
                        help="hash = multiresolution hash grid; brick "
                             "= packed brick rows; fused = brick with "
                             "density+rgb features in one row")
    parser.add_argument("--table_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--pallas_composite", action="store_true",
                        default=False,
                        help="the JAX package's Pallas composite; the "
                             "port always composites through its kernel")
    parser.add_argument("--stream_autocal", action="store_true",
                        default=False,
                        help="derive stream-dedup run caps from "
                             "MEASURED per-tile run statistics of real "
                             "batches (adopt-then-grow; a few "
                             "recompiles) instead of the --stream_seg "
                             "formula guess")
    parser.add_argument("--stream_dedup", action="store_true",
                        default=False,
                        help="stream-dedup encoding on the compacted "
                             "ray-contiguous batch (ops/streambrick.py):"
                             " one table row per brick run of the "
                             "stream; brick/fused encoders")
    parser.add_argument("--stream_tile", type=int, default=256)
    parser.add_argument("--stream_slack", type=float, default=1.5)
    parser.add_argument("--stream_seg", type=int, default=4)
    parser.add_argument("--stream_direct_frac", type=float, default=0.7,
                        help="levels whose run cap exceeds this "
                             "fraction of the tile skip dedup (direct "
                             "per-sample gather); 0.0 = per-sample-"
                             "exact everywhere")
    parser.add_argument("--no_stream_sort", dest="stream_sort",
                        action="store_false", default=True,
                        help="disable kept-count ray ordering of the "
                             "compact stream (stream-composite path)")
    parser.add_argument("--stream_seg_head", type=int, default=20,
                        help="tight breaks budget (tile/seg) for the "
                             "head tile class of a SORTED stream")
    parser.add_argument("--stream_head_frac", type=float, default=0.0,
                        help="fraction of each chunk's tiles in the "
                             "tight head class (0 = single class)")
    parser.add_argument("--sparsity_loss", type=float, default=0.0,
                        help="global mean-sigma sparsity prior weight "
                             "(carves unsupervised fog; not in the "
                             "reference)")
    parser.add_argument("--logger", type=str, default="jsonl",
                        choices=["jsonl", "tb", "wandb", "none"],
                        help="experiment logger backend "
                             "(utils/loggers.py; replaces WandbLogger, "
                             "train.py:419-422)")
    parser.add_argument("--debug_nans", action="store_true", default=False,
                        help="stop at the first NaN (not ported)")
    # multi-host data parallelism (not ported)
    parser.add_argument("--distributed", action="store_true", default=False,
                        help="multi-host data parallelism (not ported)")
    parser.add_argument("--coordinator_address", type=str, default=None)
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    return parser


def parse_config_file(path):
    """`key = value` lines -> CLI token list (configargparse txt format)."""
    tokens = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, val = (s.strip() for s in line.split("=", 1))
            if val.lower() in ("true",):
                tokens.append(f"--{key}")
            elif val.lower() in ("false",):
                pass
            elif val.startswith("["):  # list value
                tokens.append(f"--{key}")
                tokens += shlex.split(val.strip("[]").replace(",", " "))
            else:
                tokens += [f"--{key}", val]
    return tokens


def get_opts(argv=None, add_args=None):
    """The flags of argv (default: the command line), a --config file's
    values under them; add_args(parser), when given, adds an entry
    point's own flags first."""
    parser = build_parser()
    if add_args is not None:
        add_args(parser)
    args, _ = parser.parse_known_args(argv)
    if args.config:
        cfg_tokens = parse_config_file(args.config)
        # config-file values first, CLI overrides (configargparse order)
        merged = cfg_tokens + (argv if argv is not None else sys.argv[1:])
        args = parser.parse_args(merged)
    if args.eval_lpips:
        # fail at parse time rather than skip the metric at eval time
        if not args.lpips_weights or not os.path.exists(args.lpips_weights):
            parser.error(
                "--eval_lpips needs --lpips_weights pointing at an "
                "exported LPIPS .npz")
    return args
