#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (ingp_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--profile | --reference-spread]

Phases, each line flushed and stamped with elapsed seconds:

1. device: torch's device name and nvidia-smi's name and power limit;
2. build: two nvcc calls, started together, compile the kernels'
   library (ingp_tpu_torch/kernels/csrc/*.cu but the probes: K1-K3 and
   their backward kernels, which the training path loads) and the
   probes' (csrc/probe_*.cu);
2b. native: g++ builds the native batch sampler's library (fit's
   default sampler), whose 100 batches of bench.py's dataset at 8192
   rays must equal the direct gather rays[img, pix] (and the labels,
   normals and uv) and a second sampler's of the same seed; ms a batch
   beside the numpy sampler's;
3. render: NeRFSystem.render_image of one 256x256 synthetic test view
   at the bench's full model width (bf16 brick tables of 2^19 / 2^21
   parameters per level, 16 levels, capacity 48, 24 samples per ray),
   random weights from a seed, occupancy marked from the scene's
   spheres. A first render captures each forward kernel's first
   full-width inputs; the launch counts are then reset and a second
   render is timed and counted;
4. kernels: K1, K2 and K3 on the render's captured inputs against their
   plain PyTorch versions on the card, and K3 forward beside the body it
   replaced ("before/after", as in phase 6);
5. reference: a small configuration rendered on the card (kernels) and
   on the CPU (plain versions) from the same parameters must agree;
6. train: NeRFSystem.training_step at bench.py's configuration and full
   width (SyntheticDataset train split, 256 px, 16 views, 8192-ray
   batches; the grid from mark_invisible_cells and the warmup refresh),
   random weights from a seed: 3 warm-up and 16 settling steps, then 30
   timed steps on batches staged on the card, as bench.py times them
   (step ms, training rays/s, peak memory, launches per step of all six
   kernels, the losses of the first and the last step, which must be
   finite and falling). The first step records the first inputs of
   every variant of every kernel that it launches (K1 and K2 on each
   table, with and without a jacobian; the grid refresh's K2; K3 with
   rgb and with Ts only, the latter without ts; the backward kernels of
   both tables), and the
   later untimed steps count every kernel's calls by variant and shape;
   after the untimed steps each variant is held against its plain
   version run on the CPU (-9 cells and non-included samples must give
   exact zeros), with times (CUDA events from the host, and from a CUDA
   graph; the backward kernels into a reused gradient, K2's also with
   the gradient cold in the L2) and the bound, and so are the last
   untimed step's K1 and K2 backward launches (the first step's are
   mostly zero padding; these stand in the kernels line); K1 forward is
   timed at each level-group shape, K1 backward at each of the first
   step's and the last untimed step's from a CUDA graph; then
   "before/after": the K1 backward, K2 forward, K2 backward, K3 backward
   and K3 forward bodies that the current kernels replaced (the split's
   `full` variants) are held to the same outputs (K3 forward's ws, Ts
   and count bitwise) and timed beside them on the recorded inputs, from
   the host and from a CUDA graph, K2 backward also on the last untimed
   step's launches with the K2 bwd split's stubs; then `fit` for 32
   steps with hparams.profile_dir set: the Chrome trace must hold 10
   "train_step" ranges (steps 20-29) and name the K1, K2 and K3 kernels
   (its path and size printed);
7. features: configs/Playground.txt's model flags (appearance codes of
   8, the transient mask, the random background) and the skybox on the
   training step of phase 6 at full width: 3 untimed steps with the
   skybox's gate closed, 3 at the trainer's WARMUP_STEPS with it open,
   then 20 timed steps (step ms, training rays/s and peak memory beside
   phase 6's); the first step's kernel variants (K3 bwd's opacity
   cotangent now carrying the background's -bg . dC) against their
   plain versions on the CPU as in phase 6; one 256x256 test view with
   image 0's appearance code and the skybox, timed, its K3 launches
   checked; and a small step with the same features plus the HDR
   tonemapper and its unit-exposure anchor, gate open, card against CPU
   as in phase 9;
8. fused: the training step of phase 6 on the fused encoder (one table
   of 715,199 rows x 512 lanes: 8 density and 8 rgb features a lattice
   point, an f32 master read through a bf16 copy), with the sorted head
   class (stream_head_frac 0.5, stream_seg_head 20: 384 head tiles of
   768) and the cap auto-calibration: 64 steps, the last 30 timed (step
   ms, training rays/s and peak memory beside phase 6's), the
   calibration's reads and adopted caps (at least three reads); the
   first step's K1 (F = 16, the jacobian window [0, 8), by tile class),
   K2 (F = 16, with and without the window), K3 and backward launches
   held against their plain versions on the CPU at phase 6's
   tolerances, K1 and K2 launches a step by variant; one step each with
   stream_sort off, with stream_dedup off on the fused model and on
   phase 6's brick model; two pose-refinement steps on a fused model,
   the first's launches of K2's position-cotangent variant at F = 16
   held against their plain version; a slim checkpoint whose load into
   a fresh system restores the adopted caps and the table; one 256x256
   test view with the adopted caps;
9. train reference: one small training step on the card and on the CPU
   from the same parameters, batch and noise must agree;
9b. parallel: data parallelism at bench.py's width with --num_gpus
   semantics, two ranks (spawned processes) on the one card over gloo
   (NCCL refuses two ranks on one card), 4096 rays each of the 8192-ray
   global batch: (a) f32 at a non-binding budget (capacity = samples a
   ray = 24), step 1's mean loss to rtol 1e-4 of one process's on the
   same global batch and draws, its averaged gradients to 1e-4 of each
   leaf's largest value, the ranks' parameters bitwise equal after 3
   steps; (b) the bench's binding budget (48 / 24, bf16), 3 steps'
   losses to rtol 5e-3 of one process's, rank 0's first-step kernel
   launches against their plain versions on the CPU at phase 6's
   tolerances, launches a step per rank, step ms, global rays/s,
   all-reduce ms and peak memory per rank; the sharded 256x256 view
   against one process's at rtol 1e-4, atol 1e-5; then
   `ingp_tpu_torch.train.main` with --distributed over localhost TCP
   for 20 steps of configs/synthetic_smoke.txt, validating round-robin,
   both ranks returning the same metrics. A rank that fails fails it;
10. probes: the probes' own path (ingp_tpu_torch/probes, the Hopper
   forms of the TPU layout probes under benchmarking/; what each
   module's main() runs on the card, `probes.common.measure`) over
   every variant of the four probe kernels at the probes' full shapes,
   with the launch counts set to 0 before it and read after it: each
   variant is launched and held against its plain version on the card
   -- gathers bitwise equal, the K1/K2 split's forward variants within
   1e-5 of the largest value + 1e-7 and its backward variants within
   1e-5 + 1e-12 -- and fails unless that check launched its kernel;
   then it is timed (CUDA-event median of 10 runs) beside its bound,
   its plain version and the library call; the in-block gathers also
   from a CUDA graph beside the launch floor (a one-element fill from a
   graph, measured once) and the host's dispatch of a call, with a
   "before/after" line for each shape whose body was replaced (the old
   body's graph ms, host ms and host dispatch against the new one's, the
   library call, the floor, the bound, and both launches' grid, threads
   and cluster), and the in-block gathers' ragged, largest-table and
   4-byte-offset cases of the card tests, bitwise. Every probe kernel
   must have been launched by the timed runs (the checks' launches are
   left out of the counts); none runs on the training path;
11. cli: `ingp_tpu_torch.train.main` on configs/synthetic_smoke.txt at
   its own 500 steps of 2048 rays (the hash encoder, f32 tables, the
   sparsity prior), in a temporary working directory, with the launch
   counts set to 0 before it: the step time, the losses of the first and
   last 50 steps (finite and falling), the test PSNR (at most 1 dB under
   the JAX CLI's on the same config, JAX_CLI_PSNR) and SSIM, and with
   --eval_lpips on LPIPS weights drawn from a seed a finite LPIPS; the
   checkpoints `last` and `last_slim` must exist, and `--ckpt_load last
   --val_only` must give the same metrics to 1e-6; then the hash
   encode, its jacobian and its table gradient on the card against the
   CPU, within 1e-5 of the largest value;
11b. utility: LPIPS and the utility/ tools on the card against the CPU
   (`phase_utility`): LPIPS with TF32 off, on process-wide, and on with
   LPIPS's own pin bypassed (which must miss the 1e-5 the others hold),
   plane_ransac, a Poisson blend, the ocean's synthesis, the line
   segment detector's g++ build and the up vector of a rendered facade,
   and a Motion-JPEG AVI round trip;
12. quality: the port's quality gate (`ingp_tpu_torch.quality_synthetic`
   at its defaults: 600 steps of 8192 rays over 100 views at 256 px,
   a stream of two chunks, the sparsity prior), with the launch counts
   set to 0 before it, and its RESULT line. The first step's K2 forward
   and backward launches of the sparsity prior, at (16, 16384), and K1
   forward and backward launches of the second stream chunk are held
   against their plain versions on the CPU, with times and bounds, as in
   phase 6; then a miss of the bar (novel PSNR >= 26.0, SSIM >= 0.865)
   fails the run;
13. data: configs/lego.txt trained from disk through
   `ingp_tpu_torch.train.main` in a temporary working directory, on an
   NSVF Synthetic-NeRF fixture of the sphere scene that the port's own
   writer puts under .../Synthetic_NeRF/Lego (100 train and 4 test
   opaque RGBA views of 800x800, Paeth-filtered rows; the loader's Lego
   scale): the train split's load seconds, the ms per image spent
   decoding and unfiltering (the g++-built helper), 500 steps of 16,384
   rays at the config's own model (the hash encoder: K3 forward and
   backward), median ms per step, rays/s, peak memory, launches per
   step; the losses finite and falling and the test PSNR at least 5 dB
   above that of a constant image at the test views' mean colour, or
   the run fails; `_dump_val_images` once, every PNG read back through
   the port's reader. Then the same config with the bench's brick model
   (encoder brick, stream dedup, bf16, capacity 48, 24 samples per ray)
   on the loaded datasets for 20 steps: K1, K2 and K3 forward and
   backward at lego's batch, launches per step, and each kernel variant
   of its first step held against its plain version on the CPU with its
   times, as in phase 6. Then configs/Playground.txt (tnt, appearance
   codes, the transient mask, the random background) on a 64x36 TNT
   fixture for 20 steps, through `train.main` without --no_save_test, so
   that it ends with `render_for_test` of the fixture's camera path;
14. offline, in phase 13's working directory: `render_for_test(hparams,
   system=...)` of the first of the 4 test views (OFFLINE_BRICK_VIEWS)
   and `extract_mesh` at 512x128x512
   (sigma 10) on phase 13's brick system, timed, with the launch counts
   set to 0 before each, the first render chunk's K1, K2 and K3 forward
   variants and the first probe chunk's K2 forward held against their
   plain versions on the CPU as in phase 6; then the three CLIs on
   lego's `last` checkpoint: `render_cli` (the first test view, 800x800,
   with the ms per view and rays/s, rgb.mp4 or the skip line, and the
   frame equal to phase 13's `_dump_val_images` of the same view), the
   panorama at 512x1024 (its three PNGs read back, the opacity mean) and
   `extract_mesh_cli` at 512x128x512 with --sigma_threshold 10 (the
   probe's and the isosurface's ms, the vertex and face counts, the .ply
   header read back, a non-empty mesh with every vertex inside the
   scene box); then the TNT run's trajectory frames read back and both
   aux-head passes (semantic labels, up-normal masks) on its system,
   each pass's K3 launches counted;
15. kitti, in a temporary working directory: a KITTI-360 fixture at the
   dataset's image size (1408x376, both rectified cameras, 16 frames
   with OXTS, semantic PNGs and .npy normals; the port's own writer);
   configs/kitti360_nvs_1538.txt less its depth_mono line (no loader
   gives a mono depth; JAX's step fails on it) through `train.main` for
   48 steps with its window cut to the fixture's 16 frames and one test
   frame, the frames loaded at downsample 0.5 (704x188, the uint8
   resize), to its end-of-run render (every PNG read back); then, on
   the loaded datasets, 16 steps with --optimize_ext on the config's
   hash encoder and 16 on the bench's stream-brick encoder
   (ms per step, losses, launches per step, the pose corrections'
   norms, which must have moved), the first brick step's launches of the
   K2 backward's position-cotangent variant held against their plain
   version on the CPU with their graph time and bytes bound, and 4 brick
   steps without pose refinement, which must launch it no time; one
   small step with pose refinement, card against CPU, every gradient
   leaf (ext's too) to 1e-4 of its largest value; then a highbay fixture
   through `train.main` for 10 steps;
16. the kernels JSON line (`launches`: the training window's count for
   the six package kernels, the probes phase's for the probe kernels,
   phase 15's stream-brick pose-refinement steps' for the K2 backward's
   position-cotangent variant; phase 8's for the rows of its F = 16
   launches; `launches_per_train_step` for all), then
   the result line.

With --reference-spread, only the device and build phases run, then
the small card-vs-CPU step of phases "train reference" and "features"
(gate open, and closed) at batch seeds 5-10, unchecked, one line of its
worst gradient leaves each, and each step once more on the CPU in
float64 on the f32 step's samples and cells (`float64_replay`), with
the trilinear weights exact and with the f32 step's own (F64_MODES):
lines of whether both sides fed the encoder the same samples and
fractions, and of the card's and the f32 CPU step's distance to each
float64 step, over each leaf and on the entries where the two differ;
it exits 0 without the result lines.

With --profile, a torch.profiler pass over one more render and one more
training step prints the CUDA time per op and of each launch of the
port's kernels, and the step's backward nodes of K1/K2/K3 with the
sinks' zero fills (not part of the check).

Exits non-zero, printing no result line, when CUDA is unavailable or any
check fails.
"""
from __future__ import annotations

import collections
import contextlib
import inspect
import json
import re
import subprocess
import sys
import time
from types import SimpleNamespace

T0 = time.time()

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 non-tensor flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

DEVICE = "cuda"
IMG_SIZE = 256        # bench.py's synthetic image size
N_VIEWS = 16          # bench.py's training views
BATCH = 8192          # bench.py's rays per training step
STEPS_WARMUP, STEPS_SETTLE, STEPS_MEASURE = 3, 16, 30
# the last untimed step, whose K2 bwd launches are checked, timed and
# stand in the kernels line too: the first step's are ~80% the stream's
# zero-padded tail, whose zero cotangents add nothing
LATE_STEP = STEPS_WARMUP + STEPS_SETTLE - 1

# kernels line name -> (launcher symbol, source, TPU kernel it replaces)
KERNELS = {
    "fused_ray_reduce": ("ingp_ray_reduce_fwd",
                         "ingp_tpu_torch/kernels/csrc/rayreduce.cu",
                         "ingp_tpu/ops/pallas/rayreduce_pallas.py:232"),
    "brick_reduce": ("ingp_brick_reduce_fwd",
                     "ingp_tpu_torch/kernels/csrc/brickreduce.cu",
                     "ingp_tpu/ops/pallas/brickreduce_pallas.py:190"),
    "composite": ("ingp_composite_fwd",
                  "ingp_tpu_torch/kernels/csrc/composite.cu",
                  "ingp_tpu/ops/pallas/composite_pallas.py:110"),
    "fused_ray_reduce_bwd": ("ingp_ray_reduce_bwd",
                             "ingp_tpu_torch/kernels/csrc/rayreduce.cu",
                             "ingp_tpu/ops/pallas/rayreduce_pallas.py:305"),
    "brick_reduce_bwd": ("ingp_brick_reduce_bwd",
                         "ingp_tpu_torch/kernels/csrc/brickreduce.cu",
                         "ingp_tpu/ops/pallas/brickreduce_pallas.py:224"),
    "composite_bwd": ("ingp_composite_bwd",
                      "ingp_tpu_torch/kernels/csrc/composite.cu",
                      "ingp_tpu/ops/pallas/composite_pallas.py:137"),
}
FWD = ("fused_ray_reduce", "brick_reduce", "composite")

# the probes' kernels: kernels line name -> (module of
# ingp_tpu_torch.probes, launcher symbols, source, TPU kernel it
# replaces, the variant whose numbers stand in the kernels line)
PROBES = {
    "probe_kernel_split": (
        "kernel_split", ("ingp_probe_split_fwd", "ingp_probe_split_bwd",
                         "ingp_probe_split_k2"),
        "ingp_tpu_torch/kernels/csrc/probe_split.cu",
        "benchmarking/probe_kernel_split.py:185", "fwd full, random uid"),
    "probe_row_gather": (
        "row_layouts", ("ingp_probe_row_gather",),
        "ingp_tpu_torch/kernels/csrc/probe_rows.cu",
        "benchmarking/probe_row_layouts.py:147", "(256,) bfloat16"),
    "probe_onchip_gather": (
        "vmem_gather", ("ingp_probe_onchip_gather",),
        "ingp_tpu_torch/kernels/csrc/probe_onchip.cu",
        "benchmarking/probe_vmem_gather.py:89", "(a) l2, (8192, 256) f32"),
    "probe_gather": (
        "gather_layouts", ("ingp_probe_gather",),
        "ingp_tpu_torch/kernels/csrc/probe_gather.cu",
        "benchmarking/probe_gather_layouts.py:123",
        "axis 0, (512, 128) -> (256, 128)"),
}
PROBE_ITERS = 10

# the bodies that the current K1 backward, K2 forward, K2 backward and K3
# backward replaced (the split's `full` variants,
# ingp_tpu_torch/probes/kernel_split.py), timed beside them on these
# recorded training variants
BEFORE_AFTER = (("fused_ray_reduce_bwd", "density table, jac"),
                ("fused_ray_reduce_bwd", "rgb table, no jac"),
                ("brick_reduce", "density table, jac"),
                ("brick_reduce", "rgb table, no jac"),
                ("brick_reduce", "density table, no jac"),
                ("brick_reduce_bwd", "density table, jac"),
                ("brick_reduce_bwd", "rgb table, no jac"),
                ("composite_bwd", "rgb and aux"))
# the K3 forward variants of the training step timed beside the body the
# current kernel replaced (the split's `k3 fwd full`); the render's
# "rgb and aux" launch too
K3_FWD_BEFORE_AFTER = ("rgb and aux", "weights, Ts")
# the backward kernels whose launches of step LATE_STEP are recorded,
# checked and stand in the kernels line
LATE = ("fused_ray_reduce_bwd", "brick_reduce_bwd")
# the K2 bwd split's variants timed on training's recorded K2 bwd inputs
# (not contiguous-reads: it hands cells other cells' cotangents, which on
# these inputs puts nonzero cotangents on the padded tail's one row)
K2B_SPLIT = ("full", "shipping", "no-atomics", "vector-atomics")

# the training variant whose time and bound stand in the kernels line
PRIMARY = {"fused_ray_reduce": "density table, jac",
           "brick_reduce": "density table, jac",
           "composite": "rgb and aux",
           "fused_ray_reduce_bwd": "density table, jac",
           "brick_reduce_bwd": "density table, jac",
           "composite_bwd": "rgb and aux"}


def log(msg: str) -> None:
    print(f"[{time.time() - T0:8.2f}s] {msg}", flush=True)


def bench_hparams(**kw):
    """bench.py's hparams namespace with its environment defaults."""
    h = dict(dataset_name="synthetic", root_dir="", split="train",
             downsample=1.0, scale=0.5, use_skybox=False, use_exposure=False,
             embed_a=False, embed_a_len=4, embed_msk=False, num_classes=7,
             batch_size=BATCH, ray_sampling_strategy="all_images",
             num_epochs=20, normal_epochs=0, steps_per_epoch=1000, lr=1e-2,
             density_threshold=1e-2, depth_mono=False, normal_mono=False,
             normal_ref=True, optimize_ext=False, random_bg=False,
             render_semantic=False, chunk_size=131072, seed=0,
             ckpt_load=None, compute_dtype="bfloat16", capacity=48,
             march_iters=1024, samples_per_ray=24, encoder="brick",
             table_dtype="bfloat16", encode_chunk=196608, stream_dedup=True,
             stream_tile=256, stream_seg=4, stream_slack=1.5,
             stream_direct_frac=0.7, stream_sort=True, stream_seg_head=20,
             stream_head_frac=0.0)
    h.update(kw)
    return SimpleNamespace(**h)


SMALL = dict(density_L=4, rgb_L=4, density_log2T=12, rgb_log2T=12,
             grid_size=32, encode_chunk=4096, compute_dtype="float32",
             table_dtype="float32")


def launch_counts() -> dict:
    """Launches of each kernel (the probes' too) since the counts were
    last cleared."""
    from ingp_tpu_torch.kernels import build
    counts = {name: build.LAUNCHES[k[0]] for name, k in KERNELS.items()}
    counts.update({name: sum(build.LAUNCHES[s] for s in p[1])
                   for name, p in PROBES.items()})
    return counts


def clear_counts() -> None:
    from ingp_tpu_torch.kernels import build
    build.LAUNCHES.clear()


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of fn() over reps runs, CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bound_of(nbytes, flops):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the HBM rate and the f32 operations over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def max_err(outs, refs) -> tuple[float, float]:
    """(max |out - ref|, max |ref|) over matching tensors."""
    err = scale = 0.0
    for a, b in zip(outs, refs):
        if b is None or b.numel() == 0:
            continue
        err = max(err, float((a.float() - b.float()).abs().max()))
        scale = max(scale, float(b.float().abs().max()))
    return err, scale


def to_dev(x, dev):
    """x (a tensor, or a tuple, list or dict of them) on dev."""
    import torch
    if torch.is_tensor(x):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: to_dev(v, dev) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_dev(v, dev) for v in x)
    return x


class Recorder:
    """Stands in for a function in the module that calls it, passes every
    call through, counts the calls by (variant, shape(arguments)) (shape
    None: by variant) and, with keep, keeps the arguments (by parameter
    name) and the result of the first call of each variant that
    `variant(arguments)` names, and the arguments of the first call of
    each (variant, shape); None names no variant."""

    def __init__(self, module, name, variant, shape=None, keep=True):
        self.module, self.name, self.variant = module, name, variant
        self.shape, self.keep = shape, keep
        self.fn = getattr(module, name)
        self.sig = inspect.signature(self.fn.fn if isinstance(
            self.fn, Recorder) else self.fn)
        self.calls = {}
        self.shapes = {}      # (variant, shape) -> arguments, with keep
        self.counts = collections.Counter()
        setattr(module, name, self)

    def __call__(self, *args, **kw):
        out = self.fn(*args, **kw)
        bound = self.sig.bind(*args, **kw)
        bound.apply_defaults()
        a = dict(bound.arguments)
        v = self.variant(a)
        if v is not None:
            key = (v, None if self.shape is None else self.shape(a))
            self.counts[key] += 1
            if self.keep and v not in self.calls:
                self.calls[v] = (a, out)
            if self.keep and key not in self.shapes:
                self.shapes[key] = a
        return out

    def restore(self):
        setattr(self.module, self.name, self.fn)


def table_namer(cfg):
    """table(t, jac) -> "<density|rgb> table, <jac|no jac>", the variant
    name of a K1/K2 call on table t (told apart by its row count)."""
    tables = {cfg.density_brick_cfg.total_bricks: "density",
              cfg.rgb_brick_cfg.total_bricks: "rgb"}
    if len(tables) != 2:
        raise AssertionError("the tables' row counts do not tell them apart")

    def table(t, jac):
        name = tables.get(t.shape[0], f"{t.shape[0]}-row")
        return f"{name} table, {'jac' if jac else 'no jac'}"
    return table


def record_kernels(cfg, names, keep=True, table=None, k1_class=None):
    """Recorders on the wrappers of the kernels `names`, keyed by
    variant: the table a K1/K2 call reads (by its row count, or as
    `table(t, jac)` names it) and whether it has a jacobian, with
    k1_class also a K1 call's tile class (`k1_class(urows)`); which
    outputs a K3 call makes. Calls are counted by variant and shape:
    K1's (batch rows, slots), K2's (levels, samples), K3's (rays,
    samples)."""
    from ingp_tpu_torch.kernels import brickreduce as k2
    from ingp_tpu_torch.kernels import composite as k3
    from ingp_tpu_torch.kernels import rayreduce as k1
    table = table or table_namer(cfg)

    def k1_table(t, jac, urows):
        v = table(t, jac)
        return v if k1_class is None else f"{v}, {k1_class(urows)}"

    def k3_fwd(a):
        v = "rgb and aux" if a["rgbs"] is not None else "weights"
        return v + (", Ts" if a["with_Ts"] else "")

    where = {
        "fused_ray_reduce": (k1, lambda a: k1_table(
            a["table"], a["with_jac"], a["urows"])),
        "brick_reduce": (k2, lambda a: table(a["table"], a["with_jac"])),
        "composite": (k3, k3_fwd),
        "fused_ray_reduce_bwd": (k1, lambda a: k1_table(
            a["grad"], a["djac"] is not None, a["urows"])),
        "brick_reduce_bwd": (k2, lambda a: table(
            a["grad"], a["djac"] is not None)),
        "composite_bwd": (k3, lambda a: "rgb and aux"),
    }
    wrapper = {"composite": "composite_fwd"}
    shape = {"fused_ray_reduce": "urows", "brick_reduce": "rows",
             "composite": "sigmas", "fused_ray_reduce_bwd": "urows",
             "brick_reduce_bwd": "rows", "composite_bwd": "sigmas"}
    return {n: Recorder(where[n][0], wrapper.get(n, n), where[n][1],
                        lambda a, k=shape[n]: tuple(a[k].shape), keep)
            for n in names}


def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {name} (count {count}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    print(smi, flush=True)
    return name, count, smi


def phase_build():
    """The two kernel libraries (`kernels.build`: K1-K3 for the training
    path, and the probes'), one nvcc call each, both started together;
    then each kernel instantiation's registers and spills."""
    from ingp_tpu_torch.kernels import build
    t = time.time()
    reports = build.build_libraries(("kernels", "probes"))
    build.load_library()
    build.load_probe_library()
    log(f"build: " + ", ".join(
        f"{lib} {len(build.sources(lib))} sources -> "
        f"{build.library_path(lib).name}" for lib in reports)
        + f"; two nvcc calls side by side, {time.time() - t:.2f} s")
    # one line per kernel instantiation: registers and spill bytes
    for lib, report in reports.items():
        name = spill = None
        for line in report.splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
            elif "spill stores" in line:
                spill = line.split(",")[1].strip()
            elif "Used" in line and "registers" in line and name:
                regs = line.split("Used")[1].split(",")[0].strip()
                log(f"  ptxas {lib}: {kernel_label(name)[:72]}: {regs}, "
                    f"{spill}")
                name = None


def kernel_label(mangled):
    """A mangled kernel name less its anonymous namespace, so that the
    printed head shows the template arguments (`23brick_reduce_bwd_
    kernelILi16ELb1ELb1ELb1EE...`: F 16, JAC, BF16, POS)."""
    m = re.match(r"_ZN(\d+)_GLOBAL__N_", mangled)
    return mangled[3 + len(m.group(1)) + int(m.group(1)):] if m else mangled


def make_system(h, img_size, device, seed=0):
    """A system over one test view, for rendering it."""
    from ingp_tpu_torch.data.synthetic import SyntheticDataset
    from ingp_tpu_torch.training.trainer import NeRFSystem
    ds = SyntheticDataset(split="test", img_size=img_size, n_test=1)
    system = NeRFSystem(h, ds, device=device, seed=seed)
    set_sphere_grid(system)
    return ds, system


def set_sphere_grid(system):
    """Occupancy marked from the scene's spheres."""
    import torch
    from ingp_tpu_torch.data.synthetic import sphere_density_grid
    from ingp_tpu_torch.grid.occupancy import grid_from_density
    cfg = system.model_cfg
    dg = torch.as_tensor(sphere_density_grid(cfg.grid_size, cfg.cascades,
                                             cfg.scale),
                         device=system.device)
    system.grid = grid_from_density(system.grid, dg, 0.5, cfg.grid_size,
                                    cfg.cascades)


def check_render(out, ds, system, n_rays):
    """Finite outputs of the right shapes; rays that cannot reach an
    occupied cell composite to exactly zero."""
    import numpy as np
    import torch
    from ingp_tpu_torch.core.intersect import ray_aabb_intersect
    from ingp_tpu_torch.data.synthetic import SPHERES
    for k, v in out.items():
        if k == "total_samples":
            continue
        if v.shape[0] != n_rays:
            raise AssertionError(f"{k}: shape {tuple(v.shape)}")
        if not bool(torch.isfinite(v.float()).all()):
            raise AssertionError(f"{k}: non-finite values")
    if out["total_samples"] <= 0:
        raise AssertionError("no samples marched")
    op = out["opacity"].cpu().numpy()
    o = np.array(np.broadcast_to(ds.poses[0][:, 3], ds.directions.shape))
    d = ds.directions @ ds.poses[0][:, :3].T
    hits = ray_aabb_intersect(torch.as_tensor(o), torch.as_tensor(d),
                              torch.zeros(3),
                              torch.full((3,), system.model_cfg.scale))
    miss = (hits[:, 0] < 0).numpy()
    # a ray passing farther than radius + one cell diagonal from every
    # sphere centre crosses no cell whose centre is inside a sphere
    dn = d / np.linalg.norm(d, axis=1, keepdims=True)
    cell = np.sqrt(3) * 2 * system.model_cfg.scale \
        / system.model_cfg.grid_size
    far = np.ones(len(d), bool)
    for c, r, _ in SPHERES:
        oc = c - o
        dist = np.linalg.norm(oc - (oc * dn).sum(1, keepdims=True) * dn,
                              axis=1)
        far &= dist > r + cell
    empty = miss | far
    if (op[empty] != 0).any():
        raise AssertionError("rays through empty space have opacity")
    if not (op[~empty] > 0).any():
        raise AssertionError("no ray through the spheres has opacity")
    return int(miss.sum()), int(far.sum())


def check_launched(launches, what):
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched in {what}")


def phase_render(h):
    import torch
    from ingp_tpu_torch.models import rendering as render_mod
    t = time.time()
    ds, system = make_system(h, IMG_SIZE, DEVICE)
    torch.cuda.synchronize()
    cfg = system.model_cfg
    log(f"render: model density {cfg.density_brick_cfg.total_bricks} x "
        f"{cfg.density_brick_cfg.row_width}, rgb "
        f"{cfg.rgb_brick_cfg.total_bricks} x {cfg.rgb_brick_cfg.row_width} "
        f"f32 rows; grid {cfg.grid_size}^3 x {cfg.cascades}; "
        f"{time.time() - t:.2f} s set-up")

    # the first launches with a jacobian come from the first stream
    # chunk of the first render chunk's full forward; that chunk's
    # compact plan (its second compaction) tells real samples from
    # padding slots
    recs = record_kernels(cfg, FWD)
    seen = [0]

    def second_call(a):
        seen[0] += 1
        return "full forward" if seen[0] == 2 else None
    plans = Recorder(render_mod, "compact_samples", second_call)
    t = time.time()
    system.render_image(ds.poses[0])
    torch.cuda.synchronize()
    for r in (*recs.values(), plans):
        r.restore()
    log(f"render: warm-up view {time.time() - t:.2f} s (inputs captured)")

    clear_counts()
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    out = system.render_image(ds.poses[0])
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = {k: n for k, n in launch_counts().items() if k in FWD}
    n_rays = ds.directions.shape[0]
    log(f"render: {n_rays} rays, total_samples {out['total_samples']}, "
        f"{wall * 1e3:.1f} ms wall, {n_rays / wall:.1f} rays/s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{launches}")
    check_launched(launches, "the render")
    miss, far = check_render(out, ds, system, n_rays)
    log(f"render: outputs finite; {miss} AABB-miss and {far} far rays "
        f"composite to zero; opacity mean "
        f"{float(out['opacity'].mean()):.4f}")
    return system, ds, recs, plans.calls["full forward"][1]


def _local_ok(lf):
    """(cells,) bool: the cell reads a row; its local coordinates are in
    [0, 1] (the -9 overflow marker reads nothing and gives zeros)."""
    loc = lf[0:3].reshape(3, -1)
    return ((loc >= 0) & (loc <= 1)).all(0)


def _corner_points(rows, lf, ok):
    """Distinct (table row, lattice point) pairs that the ok cells read:
    the 8 corners p = 9(lx+a) + 3(ly+b) + (lz+c) of each cell's row."""
    import torch
    loc = lf[0:3].reshape(3, -1)[:, ok].long()
    base = rows.reshape(-1)[ok].long() * 27
    keys = [base + 9 * (loc[0] + a) + 3 * (loc[1] + b) + (loc[2] + c)
            for a in (0, 1) for b in (0, 1) for c in (0, 1)]
    return int(torch.unique(torch.cat(keys)).numel())


def compare(name, tag, fn, plain, views, nbytes, flops, ref_dev, atol,
            timed=None):
    """The kernel `fn()` against its plain version `plain(dev)` run on
    ref_dev, on views(outputs on the CPU) -> (compared, zeros): lists of
    tensors to hold within 1e-5 of the largest |plain value| (+ atol),
    and tensors that must be exact zeros in both. Times the kernel (20
    runs of `timed`, default fn) and the plain version on the card (3
    runs). Returns the numbers of a kernels line row."""
    import torch
    out = fn()
    torch.cuda.synchronize()
    ref = plain(ref_dev)
    (cmp_o, zero_o), (cmp_r, zero_r) = views(to_dev(out, "cpu")), \
        views(to_dev(ref, "cpu"))
    err, scale = max_err(cmp_o, cmp_r)
    tol = 1e-5 * scale + atol
    for a, b in zip(zero_o, zero_r):
        if bool(a.any()) or bool(b.any()):
            raise AssertionError(f"{name} [{tag}]: -9 cells are not exact "
                                 f"zeros")
    from ingp_tpu_torch.probes.common import graph_ms
    ms = cuda_ms(timed or fn, 20)
    g_ms = graph_ms(timed or fn)
    plain_ms = cuda_ms(lambda: plain(DEVICE), 3)
    bound_ms, by = bound_of(nbytes, flops)
    log(f"kernel {name} [{tag}]: max_abs_err {err:.3e} (tol {tol:.3e}, max "
        f"|plain| {scale:.3e}, plain on the {ref_dev}); {ms:.4f} ms "
        f"(from a CUDA graph {g_ms:.4f} ms) vs plain {plain_ms:.3f} ms; "
        f"bound {bound_ms:.4f} ms ({nbytes / 1e6:.2f} MB, "
        f"{flops / 1e9:.3f} GFLOP)")
    if not err <= tol:
        raise AssertionError(f"{name} [{tag}] disagrees with its plain "
                             f"version")
    return {"max_abs_err": err, "ms": ms, "graph_ms": g_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by}


def check_marked(name, tag, fn, lf, cells_of):
    """The -9 marker written into every 7th cell of a copy of lf: kernel
    and plain version (both on the card) give exact zeros there."""
    lfm = lf.clone()
    lfm[0:3].reshape(3, -1)[:, ::7] = -9.0
    for t in fn(lfm):
        if t is not None and bool(cells_of(t)[::7].any()):
            raise AssertionError(f"{name} [{tag}]: marked cells not zero")
    log(f"kernel {name} [{tag}]: -9 written into "
        f"{(lf[0].numel() + 6) // 7} cells reads as exact zeros")


def _k1_size(a):
    """(bytes, f32 operations, slots read, (row, point) pairs read) of K1
    forward on arguments a: the distinct (row, point) pairs, slot ids,
    uid and lf it reads, the outputs it writes."""
    import torch
    urows, uid, lf, F = a["urows"], a["uid"], a["lf"], a["F"]
    with_jac = a["with_jac"]
    Fj = (F if a["jac_hi"] is None else a["jac_hi"]) - a["jac_lo"]
    B, U = urows.shape
    K = uid.shape[1]
    cells = B * K
    u = uid.reshape(-1).long()
    ok = _local_ok(lf) & (u >= 0) & (u < U)
    slot = (torch.arange(cells, device=uid.device) // K) * U \
        + u.clamp(0, U - 1)
    n_pts = _corner_points(urows.reshape(-1)[slot], lf, ok)
    n_slots_read = int(torch.unique(slot[ok]).numel())
    nbytes = (n_pts * F * a["table"].element_size() + n_slots_read * 4
              + cells * 4 + cells * 4 * (6 + with_jac)
              + cells * 4 * (F + 3 * Fj * with_jac))
    return (nbytes, int(ok.sum()) * 8 * (F + 3 * Fj * with_jac) * 2,
            n_slots_read, n_pts)


def k1_group_times(rec, phase="train"):
    """K1 forward at every level-group shape the first training step
    launched (the check above takes the first one of each variant): host
    and CUDA-graph ms beside the bound, on that shape's recorded
    arguments; then the graph ms summed over the step's launches (each
    shape's time times its count) beside the bound's sum."""
    from ingp_tpu_torch.kernels import rayreduce as k1
    from ingp_tpu_torch.probes.common import graph_ms
    out = {}
    tot = [0.0, 0.0]
    for (v, shape), a in sorted(rec.shapes.items()):
        fn = lambda a=a: k1.fused_ray_reduce(**a)   # noqa: E731
        ms, g = cuda_ms(fn, 20), graph_ms(fn)
        bound, _ = bound_of(*_k1_size(a)[:2])
        out[(v, shape)] = {"ms": ms, "graph_ms": g, "bound_ms": bound}
        n = rec.counts[(v, shape)]
        tot = [tot[0] + n * g, tot[1] + n * bound]
        log(f"kernel fused_ray_reduce [{phase}, {v}] group {shape}: {ms:.4f} "
            f"ms, from a CUDA graph {g:.4f} ms, bound {bound:.4f} ms (graph "
            f"at {bound / g:.1%} of the bound); {n} launches in the step")
    log(f"kernel fused_ray_reduce [{phase}]: graph ms summed over the "
        f"step's {sum(rec.counts.values())} launches {tot[0]:.4f}, bound "
        f"{tot[1]:.4f} (at {tot[1] / max(tot[0], 1e-9):.1%} of the bound)")
    return out


def check_k1(a, tag, ref_dev, real=None):
    """K1 forward on captured arguments a; real: (cells,) bool, the cells
    of real samples (default all)."""
    import torch
    from ingp_tpu_torch.kernels import rayreduce as k1
    table, urows, uid, lf = (a[k] for k in ("table", "urows", "uid", "lf"))
    U = urows.shape[1]
    real = torch.ones(uid.numel(), dtype=torch.bool, device=uid.device) \
        if real is None else real
    u = uid.reshape(-1).long()
    ok = _local_ok(lf) & (u >= 0) & (u < U)
    nbytes, flops, n_slots_read, n_pts = _k1_size(a)
    log(f"kernel fused_ray_reduce [{tag}]: table {tuple(table.shape)} "
        f"{table.dtype}, urows {tuple(urows.shape)}, uid "
        f"{tuple(uid.shape)}; {int(real.sum())} real cells, "
        f"{int((real & ~ok).sum())} of them -9; {n_slots_read} slots and "
        f"{n_pts} (row, point) pairs read")
    cmp_m, zero_m = (real & ok).cpu(), (real & ~ok).cpu()

    def cells_of(t):
        return t.reshape(t.shape[0], -1).T

    res = compare(
        "fused_ray_reduce", tag, lambda: k1.fused_ray_reduce(**a),
        lambda dev: k1.fused_ray_reduce_plain(**to_dev(a, dev)),
        lambda o: ([cells_of(t)[cmp_m] for t in o if t is not None],
                   [cells_of(t)[zero_m] for t in o if t is not None]),
        nbytes, flops, ref_dev, 1e-7)
    check_marked("fused_ray_reduce", tag,
                 lambda m: (k1.fused_ray_reduce(**{**a, "lf": m})
                            + k1.fused_ray_reduce_plain(**{**a, "lf": m})),
                 lf, cells_of)
    return res


def check_k2(a, tag, ref_dev, real=None):
    """K2 forward on captured arguments a; real: (samples,) bool, the
    real samples (default all)."""
    import torch
    from ingp_tpu_torch.kernels import brickreduce as k2
    table, rws, lf, F = a["table"], a["rows"], a["lf"], a["F"]
    with_jac, jac_lo, jac_hi = a["with_jac"], a["jac_lo"], a["jac_hi"]
    Lw, Nn = rws.shape
    Fj = (F if jac_hi is None else jac_hi) - jac_lo
    cells = Lw * Nn
    real = (torch.ones(Nn, dtype=torch.bool, device=rws.device)
            if real is None else real).repeat(Lw)
    r = rws.reshape(-1)
    ok = _local_ok(lf) & (r >= 0) & (r < table.shape[0])
    n_pts = _corner_points(rws, lf, ok)
    log(f"kernel brick_reduce [{tag}]: table {tuple(table.shape)} "
        f"{table.dtype}, rows {tuple(rws.shape)}; {int(real.sum())} real "
        f"cells, {int((real & ~ok).sum())} of them -9; "
        f"{int(torch.unique(r[ok]).numel())} distinct rows and {n_pts} "
        f"(row, point) pairs read")
    nbytes = (n_pts * F * table.element_size() + cells * 4
              + cells * 4 * (6 + with_jac)
              + cells * 4 * (F + 3 * Fj * with_jac))
    flops = int(ok.sum()) * 8 * (F + 3 * Fj * with_jac) * 2
    cmp_m, zero_m = (real & ok).cpu(), (real & ~ok).cpu()

    def k2_cells(o):
        f = o[0].reshape(Nn, Lw, F).transpose(0, 1).reshape(cells, F)
        if o[1] is None:
            return [f]
        return [f, o[1].reshape(3, Nn, Lw, Fj).permute(2, 1, 0, 3)
                .reshape(cells, 3 * Fj)]

    res = compare(
        "brick_reduce", tag, lambda: k2.brick_reduce(**a),
        lambda dev: k2.brick_reduce_plain(**to_dev(a, dev)),
        lambda o: ([t[cmp_m] for t in k2_cells(o)],
                   [t[zero_m] for t in k2_cells(o)]),
        nbytes, flops, ref_dev, 1e-7)
    check_marked("brick_reduce", tag,
                 lambda m: (k2_cells(k2.brick_reduce(**{**a, "lf": m}))
                            + k2_cells(k2.brick_reduce_plain(
                                **{**a, "lf": m}))),
                 lf, lambda t: t)
    return res


def check_k3(a, tag, ref_dev):
    """K3 forward on captured arguments a; sample counts must be equal."""
    import torch
    from ingp_tpu_torch.kernels import composite as k3
    from ingp_tpu_torch.probes.kernel_split import k3f_bytes
    R, S = a["sigmas"].shape
    c3 = 0 if a["rgbs"] is None else 3
    C = 0 if a["aux"] is None else a["aux"].shape[0]
    log(f"kernel composite [{tag}]: sigmas {(R, S)}, rgb {c3 > 0}, aux "
        f"channels {C}, ts {a['ts'] is not None}, Ts {a['with_Ts']}")
    counts = (k3.composite_fwd(**a)["count"].cpu(),
              k3.composite_plain(**to_dev(a, ref_dev))["count"].cpu())
    if not torch.equal(*counts):
        raise AssertionError(f"composite [{tag}]: sample counts differ "
                             f"from plain")
    nbytes, flops = k3f_bytes(a)
    res = compare(
        "composite", tag, lambda: k3.composite_fwd(**a),
        lambda dev: k3.composite_plain(**to_dev(a, dev)),
        lambda o: ([v.reshape(R, -1) for k, v in sorted(o.items())
                    if k != "count"], []),
        nbytes, flops, ref_dev, 1e-7)
    # how far each side lies from the plain version in float64 on the same
    # inputs (reported only: near the T > thr cut float64 may include
    # other samples)
    exact = k3.composite_plain(**{
        k: v.double() if torch.is_tensor(v) and v.is_floating_point() else v
        for k, v in to_dev(a, "cpu").items()})
    off = {who: max(float((o[k].double() - exact[k]).abs().max())
                    for k in exact if k != "count")
           for who, o in (("kernel", to_dev(k3.composite_fwd(**a), "cpu")),
                          ("plain", k3.composite_plain(**to_dev(a, "cpu"))))}
    log(f"kernel composite [{tag}]: from the plain version in float64: "
        f"kernel {off['kernel']:.3e}, plain version in float32 "
        f"{off['plain']:.3e}")
    return res


def _zero_grad(a, dev):
    """a with a zero f32 gradient of its shape on dev."""
    import torch
    return {**to_dev(a, dev),
            "grad": torch.zeros(a["grad"].shape, dtype=torch.float32,
                                device=dev)}


def _bwd_timed(name, tag, fn, a):
    """A backward kernel's timed call: fn into one zeroed gradient reused
    by every run (the step adds into its sink the same way). Also logs
    the time with a freshly zeroed gradient allocated inside each call,
    how the backward rows were timed before (it adds the fill of the
    whole master, 212 MB for the density table)."""
    grad = _zero_grad(a, DEVICE)
    fresh = cuda_ms(lambda: fn(**_zero_grad(a, DEVICE)), 20)
    log(f"kernel {name} [{tag}]: {fresh:.4f} ms with a freshly zeroed "
        f"{tuple(a['grad'].shape)} gradient in each timed call")
    return lambda: fn(**grad)


def cold_ms(fn, grad, reps: int = 10) -> float:
    """Median milliseconds of fn() adding into grad, with grad zeroed and
    then a 256 MB scratch written before each run, outside the timed
    window: the gradient's rows are cold in the 50 MB L2, as the step
    finds them right after its sink's zero fill."""
    import torch
    flush = torch.empty(2 ** 26, device=DEVICE)
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        grad.zero_()
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def k2_sharing(rws, ok):
    """How K2's cells share rows on recorded inputs: runs (consecutive
    valid samples at one level that read one row), distinct rows and the
    most cells on one row."""
    import torch
    Lw, Nn = rws.shape
    level = torch.arange(Lw, device=rws.device).repeat_interleave(Nn)[ok]
    r = rws.reshape(-1)[ok].long()
    start = torch.ones_like(r, dtype=torch.bool)
    start[1:] = (r[1:] != r[:-1]) | (level[1:] != level[:-1])
    lens = torch.bincount(torch.cumsum(start, 0) - 1)
    _, per_row = torch.unique(r, return_counts=True)
    n = max(int(ok.sum()), 1)
    return {"cells": int(ok.sum()), "runs": int(start.sum()),
            "cells_per_run": n / max(int(start.sum()), 1),
            "runs_of_1": float((lens == 1).float().mean()),
            "longest_run": int(lens.max()) if lens.numel() else 0,
            "rows": int(per_row.numel()),
            "most_cells_on_a_row": int(per_row.max()) if per_row.numel()
            else 0}


def _k2b_cells(a):
    """(ok, live): (cells,) bool masks, level-major, of the K2 backward's
    cells on arguments a that read a row, and of those the ones with a
    nonzero cotangent."""
    rws, lf, F, dj = a["rows"], a["lf"], a["F"], a["djac"]
    Lw, Nn = rws.shape
    Fj = 0 if dj is None else dj.shape[2] // Lw
    r = rws.reshape(-1)
    ok = _local_ok(lf) & (r >= 0) & (r < a["grad"].shape[0])
    ct = a["dfeats"].reshape(Nn, Lw, F).abs().sum(-1)
    if dj is not None:
        ct = ct + dj.reshape(3, Nn, Lw, Fj).abs().sum((0, 3))
    return ok, ok & (ct.T.reshape(-1) != 0)


def k2b_size(a, tag):
    """(bytes, f32 operations) of K2 backward on arguments a, logged with
    how its cells share rows: the cells that read a row, those of them
    with a nonzero cotangent (live), and the runs, distinct (row, point)
    pairs and rows of the live cells."""
    rws, lf, F, dj = a["rows"], a["lf"], a["F"], a["djac"]
    Lw, Nn = rws.shape
    Fj = 0 if dj is None else dj.shape[2] // Lw
    ok, live = _k2b_cells(a)
    n_pts = _corner_points(rws, lf, ok)
    n_live = _corner_points(rws, lf, live)
    sh = k2_sharing(rws, live)
    log(f"kernel brick_reduce_bwd [{tag}]: grad {tuple(a['grad'].shape)}, "
        f"rows {tuple(rws.shape)}, bf16 {a['bf16']}; {int(ok.sum())} cells "
        f"read a row, {sh['cells']} of them live (a nonzero cotangent); "
        f"the live cells add {8 * sh['cells']} corners into {n_live} "
        f"(row, point) pairs, in {sh['runs']} runs of consecutive samples "
        f"at one level on one row ({sh['cells_per_run']:.3f} cells per "
        f"run, {sh['runs_of_1']:.1%} of runs 1 cell, the longest "
        f"{sh['longest_run']}), on {sh['rows']} distinct rows, at most "
        f"{sh['most_cells_on_a_row']} on one row")
    # rows, the 6 lf planes (7 with a jacobian: the scale), cotangents
    return (Lw * Nn * 4 * (1 + 6 + (dj is not None) + F + 3 * Fj)
            + n_pts * F * 8, int(ok.sum()) * 8 * (12 + 2 * F + 7 * Fj))


def _k1b_size(a):
    """(bytes, f32 operations, cells that read a row, slots, (row, point)
    pairs) of K1 backward on arguments a: uid, lf and the cotangents of
    every cell, the slots' rows and the (row, point) pairs it adds
    into."""
    import torch
    urows, uid, lf, F = a["urows"], a["uid"], a["lf"], a["F"]
    dj = a["djac"]
    B, U = urows.shape
    K = uid.shape[1]
    Fj = 0 if dj is None else dj.shape[0] // 3
    u = uid.reshape(-1).long()
    ok = _local_ok(lf) & (u >= 0) & (u < U)
    cells = B * K
    slot = (torch.arange(cells, device=uid.device) // K) * U \
        + u.clamp(0, U - 1)
    n_pts = _corner_points(urows.reshape(-1)[slot], lf, ok)
    n_slots = int(torch.unique(slot[ok]).numel())
    nbytes = cells * 4 * (1 + 6 + (dj is not None) + F + 3 * Fj) \
        + n_slots * 4 + n_pts * F * 8
    n_ok = int(ok.sum())
    return nbytes, n_ok * 8 * (12 + 2 * F + 7 * Fj), n_ok, n_slots, n_pts


def check_k1_bwd(a, tag):
    """K1 backward on captured arguments a, against the plain version on
    the CPU."""
    import torch
    from ingp_tpu_torch.kernels import rayreduce as k1
    urows, uid, lf, dj = a["urows"], a["uid"], a["lf"], a["djac"]
    B, K = uid.shape
    cells = B * K
    nbytes, flops, n_ok, n_slots, n_pts = _k1b_size(a)
    log(f"kernel fused_ray_reduce_bwd [{tag}]: grad "
        f"{tuple(a['grad'].shape)}, urows {tuple(urows.shape)}, uid "
        f"{tuple(uid.shape)}, bf16 {a['bf16']}; {n_ok} cells read a row "
        f"({cells - n_ok} -9 or out of [0, U)), {n_slots} slots, {n_pts} "
        f"(row, point) pairs")
    res = compare(
        "fused_ray_reduce_bwd", tag,
        lambda: k1.fused_ray_reduce_bwd(**_zero_grad(a, DEVICE)),
        lambda dev: k1.fused_ray_reduce_bwd_plain(**_zero_grad(a, dev)),
        lambda o: ([o], []), nbytes, flops, "cpu", 1e-12,
        _bwd_timed("fused_ray_reduce_bwd", tag, k1.fused_ray_reduce_bwd,
                   a))
    # -9 written into every 7th cell, cotangents only on those cells:
    # the kernel and the plain version add exactly nothing
    mark = torch.zeros(cells, dtype=torch.bool, device=lf.device)
    mark[::7] = True
    mark = mark.reshape(B, K)
    lfm = lf.clone()
    lfm[0:3].reshape(3, -1)[:, ::7] = -9.0
    for fn in (k1.fused_ray_reduce_bwd, k1.fused_ray_reduce_bwd_plain):
        out = fn(**{**_zero_grad(a, DEVICE), "lf": lfm,
                    "dfeats": a["dfeats"] * mark,
                    "djac": None if dj is None else dj * mark})
        if bool(out.any()):
            raise AssertionError(f"fused_ray_reduce_bwd [{tag}]: -9 cells "
                                 f"add to the gradient")
    log(f"kernel fused_ray_reduce_bwd [{tag}]: cotangents on "
        f"{int(mark.sum())} cells marked -9 add exact zeros (kernel and "
        f"plain)")
    return res


def check_k2_bwd(a, tag):
    """K2 backward on captured arguments a, against the plain version on
    the CPU."""
    import torch
    from ingp_tpu_torch.kernels import brickreduce as k2
    rws, lf, F, dj = a["rows"], a["lf"], a["F"], a["djac"]
    Lw, Nn = rws.shape
    Fj = 0 if dj is None else dj.shape[2] // Lw
    cells = Lw * Nn
    nbytes, flops = k2b_size(a, tag)
    timed = _bwd_timed("brick_reduce_bwd", tag, k2.brick_reduce_bwd, a)
    res = compare(
        "brick_reduce_bwd", tag,
        lambda: k2.brick_reduce_bwd(**_zero_grad(a, DEVICE)),
        lambda dev: k2.brick_reduce_bwd_plain(**_zero_grad(a, dev)),
        lambda o: ([o], []), nbytes, flops, "cpu", 1e-12, timed)
    grad = _zero_grad(a, DEVICE)
    res["cold_ms"] = cold_ms(lambda: k2.brick_reduce_bwd(**grad),
                             grad["grad"])
    log(f"kernel brick_reduce_bwd [{tag}]: {res['cold_ms']:.4f} ms with the "
        f"gradient zeroed and the L2 flushed before each run (outside the "
        f"timed window); {res['ms']:.4f} ms into one reused gradient, "
        f"{res['graph_ms']:.4f} ms from a CUDA graph")
    mark = torch.zeros(cells, dtype=torch.bool, device=lf.device)
    mark[::7] = True
    mark = mark.reshape(Lw, Nn).T.repeat_interleave(F, 1)   # (N, Lw*F)
    markj = mark.reshape(Nn, Lw, F)[..., :Fj].reshape(Nn, -1)
    lfm = lf.clone()
    lfm[0:3].reshape(3, -1)[:, ::7] = -9.0
    for fn in (k2.brick_reduce_bwd, k2.brick_reduce_bwd_plain):
        out = fn(**{**_zero_grad(a, DEVICE), "lf": lfm,
                    "dfeats": a["dfeats"] * mark,
                    "djac": None if dj is None else dj * markj})
        if bool(out.any()):
            raise AssertionError(f"brick_reduce_bwd [{tag}]: -9 cells add "
                                 f"to the gradient")
    log(f"kernel brick_reduce_bwd [{tag}]: cotangents on "
        f"{(cells + 6) // 7} cells marked -9 add exact zeros (kernel and "
        f"plain)")
    return res


def check_k3_bwd(a, tag):
    """K3 backward on captured arguments a, against the plain version on
    the CPU; dsigma must be exactly zero on samples not included."""
    import torch
    from ingp_tpu_torch.kernels import composite as k3
    sig, valid, C = a["sigmas"], a["valid"], a["aux"].shape[0]
    R, S = sig.shape
    log(f"kernel composite_bwd [{tag}]: sigmas {(R, S)}, aux channels {C}; "
        f"cotangents max |dO| {float(a['dO'].abs().max()):.3e} (a "
        f"background adds -bg . dC), |dC| {float(a['dC'].abs().max()):.3e}, "
        f"|dD| {float(a['dD'].abs().max()):.3e}")
    nbytes = R * S * (4 * 3 + 1 + 12 + 4 * C + 4) + R * 4 * (2 + 3 + C) \
        + R * S * 4 * (1 + 3 + C)
    flops = R * S * (40 + 4 * C)
    res = compare(
        "composite_bwd", tag, lambda: k3.composite_bwd(**a),
        lambda dev: k3.composite_bwd_plain(**to_dev(a, dev)),
        lambda o: (list(o), []), nbytes, flops, "cpu", 1e-12)
    dsig = k3.composite_bwd(**a)[0]
    # the include rule as K3 forward applies it, from its own Ts
    Ts = k3.composite_fwd(sig, a["deltas"], a["ts"], valid,
                          a["T_threshold"], with_Ts=True)["Ts"]
    excluded = ~(valid & (Ts > a["T_threshold"]))
    if bool(dsig[excluded].any()):
        raise AssertionError("composite_bwd: gradient on a sample that is "
                             "not included")
    log(f"kernel composite_bwd [{tag}]: dsigma exactly zero on the "
        f"{int(excluded.sum())} samples not included")
    return res


CHECKS = {"fused_ray_reduce": lambda a, tag: check_k1(a, tag, "cpu"),
          "brick_reduce": lambda a, tag: check_k2(a, tag, "cpu"),
          "composite": lambda a, tag: check_k3(a, tag, "cpu"),
          "fused_ray_reduce_bwd": check_k1_bwd,
          "brick_reduce_bwd": check_k2_bwd,
          "composite_bwd": check_k3_bwd}


def phase_kernels(recs, plan, cfg):
    """The forward kernels on the render's captured inputs against their
    plain versions on the card, on the cells of real samples. Returns
    {kernel: max_abs_err}."""
    import torch
    from ingp_tpu_torch.ops.streambrick import _single_pad
    # the real samples of the captured stream chunk: the full forward's
    # compaction keeps n_valid of its slots, and the stream's first chunk
    # holds the first Nc slots
    n_valid = int(plan.n_valid)
    n_slots = plan.slot_valid.numel()
    Nc = cfg.encode_chunk if n_slots > cfg.encode_chunk else \
        n_slots + (-n_slots) % _single_pad(cfg.stream_tile, cfg.encode_chunk)
    tag = "render, density table, jac"

    a, _ = recs["fused_ray_reduce"].calls["density table, jac"]
    B = a["urows"].shape[0]
    K = a["uid"].shape[1]
    Tt = Nc // K
    if B % Tt:
        raise AssertionError(f"K1 batch {B} is no multiple of {Tt} tiles")
    cell = torch.arange(B * K, device=a["uid"].device)
    sample = (cell // K) // (B // Tt) * K + cell % K
    errs = {"fused_ray_reduce": check_k1(a, tag, DEVICE,
                                         sample < n_valid)["max_abs_err"]}

    a, _ = recs["brick_reduce"].calls["density table, jac"]
    if a["rows"].shape[1] != Nc:
        raise AssertionError(f"K2 captured {a['rows'].shape[1]} samples, "
                             f"expected {Nc}")
    real = torch.arange(Nc, device=a["rows"].device) < n_valid
    errs["brick_reduce"] = check_k2(a, tag, DEVICE, real)["max_abs_err"]

    a, _ = recs["composite"].calls["rgb and aux"]
    res = check_k3(a, "render, rgb and aux", DEVICE)
    errs["composite"] = res["max_abs_err"]
    k3_fwd_before_after([("render, rgb and aux", a, res["bound_ms"])])
    return errs


def phase_reference():
    """A small configuration on the card (kernels) and on the CPU (plain
    versions) from the same parameters."""
    import numpy as np
    ds, gpu = make_system(bench_hparams(**SMALL), 16, DEVICE, seed=3)
    for k in ("density_table", "rgb_table"):
        gpu.params["model"][k].data.mul_(1e3)
    _, cpu = make_system(bench_hparams(**SMALL), 16, "cpu")
    cpu.params = cpu_params(gpu)
    a = gpu.render_image(ds.poses[0])
    b = cpu.render_image(ds.poses[0])
    if a["total_samples"] != b["total_samples"]:
        raise AssertionError(f"total_samples {a['total_samples']} (card) vs "
                             f"{b['total_samples']} (cpu)")
    worst = {}
    for k in ("rgb", "depth", "opacity", "normal_pred", "normal_raw",
              "semantic_probs"):
        d = float((a[k].cpu() - b[k]).abs().max())
        worst[k] = d
        # f32 throughout; the kernels sum in another order (and with
        # fused multiply-adds) than the plain versions. normal_raw
        # normalises a gradient that can be short, so it gets 1e-3.
        tol = 1e-3 if k == "normal_raw" else 1e-5
        if not d <= tol:
            raise AssertionError(f"reference {k}: {d} > {tol}")
    if not bool((a["opacity"].cpu() > 0).any()):
        raise AssertionError("reference render is empty")
    log(f"reference: 16x16 view, {a['total_samples']} samples, card vs cpu "
        f"max diffs {json.dumps({k: float(np.float32(v)) for k, v in worst.items()})}")


def stage(batch, device):
    """A numpy batch on the card (bench.py stages its batches before the
    timed window)."""
    import numpy as np
    import torch
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items()}


def phase_train(h):
    """bench.py's training loop at full width. Every kernel variant of
    the first step is checked on its recorded inputs after the untimed
    steps, and the recordings are dropped before the timed window (they
    would raise its peak memory). Returns the system, the checks'
    numbers and the launch counts of the timed steps."""
    import math
    import numpy as np
    import torch
    from ingp_tpu_torch.data.synthetic import SyntheticDataset
    from ingp_tpu_torch.training.trainer import NeRFSystem, tree_leaves
    t = time.time()
    held = torch.cuda.memory_allocated() / 2 ** 30
    tr = SyntheticDataset(split="train", img_size=IMG_SIZE, n_train=N_VIEWS)
    te = SyntheticDataset(split="test", img_size=IMG_SIZE, n_test=1)
    system = NeRFSystem(h, tr, te, device=DEVICE, seed=0)
    torch.cuda.synchronize()
    n_inv = int((system.grid["density_grid"] < 0).sum())
    log(f"train: {tr.n_images} views of {tr.img_wh}, {n_inv} cells no "
        f"camera sees; set-up {time.time() - t:.2f} s")
    recs = record_kernels(system.model_cfg, KERNELS)
    rng = np.random.default_rng(0)
    losses = []
    t = time.time()
    n_untimed = STEPS_WARMUP + STEPS_SETTLE
    for i in range(n_untimed):
        late = record_kernels(system.model_cfg, LATE) \
            if i == LATE_STEP else {}
        aux = system.training_step(tr.sample_batch(rng, BATCH))
        for r in late.values():
            r.restore()
        losses.append(aux["loss"])
        if i == 0:
            torch.cuda.synchronize()
            log(f"train: first step (warmup grid sweep of "
                f"{system.model_cfg.grid_size ** 3} cells) "
                f"{time.time() - t:.2f} s; kernel variants recorded "
                f"{ {k: list(r.calls) for k, r in recs.items()} }")
            for name, r in recs.items():
                r.restore()
                if PRIMARY[name] not in r.calls:
                    raise AssertionError(f"{name} [{PRIMARY[name]}] was "
                                         f"not called")
            census = record_kernels(system.model_cfg, KERNELS, keep=False)
    for r in census.values():
        r.restore()
    torch.cuda.synchronize()
    log(f"train: {STEPS_WARMUP} warm-up + {STEPS_SETTLE} settling steps "
        f"{time.time() - t:.2f} s")
    refresh = [s for s in range(1, n_untimed)
               if s % system.UPDATE_INTERVAL == 0]
    for name, r in census.items():
        log(f"train: {name} calls in steps 1-{n_untimed - 1} (grid "
            f"refreshes at steps {refresh}) by variant and shape: "
            f"{ {f'{v} {sh}': n for (v, sh), n in sorted(r.counts.items())} }")
    del census
    with torch.no_grad():
        checks = check_train_kernels(recs)
        for name in LATE:
            checks[name].update(check_late(name, late[name].calls))
        k1_group_times(recs["fused_ray_reduce"])
        k1_bwd_group_times(recs["fused_ray_reduce_bwd"],
                           late["fused_ray_reduce_bwd"])
        k3_fwd_before_after([(f"train, {tag}", recs["composite"].calls[tag][0],
                              checks["composite"][tag]["bound_ms"])
                             for tag in K3_FWD_BEFORE_AFTER])
        before_after(before_after_rows(recs, checks,
                                       late["brick_reduce_bwd"].calls))
    del recs, late
    batches = [stage(tr.sample_batch(rng, BATCH), system.device)
               for _ in range(STEPS_MEASURE)]
    torch.cuda.synchronize()
    clear_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    for b in batches:
        aux = system.training_step(b)
        losses.append(aux["loss"])
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(v) for v in losses]
    step_ms = dt / STEPS_MEASURE * 1e3
    log(f"train: {STEPS_MEASURE} steps x {BATCH} rays in {dt:.3f} s: "
        f"{step_ms:.2f} ms/step, {STEPS_MEASURE * BATCH / dt:.1f} "
        f"training rays/s, peak {peak:.2f} GiB, s_per_ray "
        f"{float(aux['s_per_ray']):.2f}, psnr {float(aux['psnr']):.2f}")
    first = STEPS_WARMUP + STEPS_SETTLE
    refreshes = sum(1 for s in range(first, first + STEPS_MEASURE)
                    if s % system.UPDATE_INTERVAL == 0)
    log(f"train: launches per step "
        f"{ {k: n / STEPS_MEASURE for k, n in launches.items()} } "
        f"(the window holds {refreshes} grid refreshes)")
    log(f"train: loss first step {losses[0]:.6f}, last step "
        f"{losses[-1]:.6f}; mean of the first 5 {np.mean(losses[:5]):.6f},"
        f" of the last 5 {np.mean(losses[-5:]):.6f}")
    check_launched({k: launches[k] for k in KERNELS}, "training")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("non-finite training loss")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError("the training loss did not fall")
    for path, p in tree_leaves(system.params):
        if not bool(torch.isfinite(p).all()):
            raise AssertionError(f"non-finite parameter {path}")
    stats = {"step_ms": step_ms, "rays_per_s": STEPS_MEASURE * BATCH / dt,
             "peak_gib": peak, "held_gib": held}
    profile_fit(system)
    return system, checks, launches, stats


# phase "features": configs/Playground.txt's model flags and the skybox at
# bench.py's width; untimed steps with the skybox's gate closed, then at
# the trainer's WARMUP_STEPS with it open, then a timed window
FEATURES = dict(embed_a=True, embed_a_len=8, embed_msk=True, random_bg=True,
                use_skybox=True)
FEATURE_STEPS_CLOSED, FEATURE_STEPS_OPEN, FEATURE_STEPS_MEASURE = 3, 3, 20


def phase_features(train_stats):
    """The training step with the model features on (FEATURES) at full
    width, as phase "train" runs it: FEATURE_STEPS_CLOSED untimed steps
    with the skybox's gate closed (the random background behind the
    rays), whose first records every kernel variant it launches; then
    global_step set to WARMUP_STEPS and FEATURE_STEPS_OPEN untimed steps
    with the gate open; then FEATURE_STEPS_MEASURE timed steps on staged
    batches, with the launch counts set to 0 before them (step ms,
    training rays/s and peak memory beside phase "train"'s). The first
    step's variants are then held against their plain versions on the
    CPU (K3 bwd's opacity cotangent carries the background's -bg . dC);
    one 256x256 test view with image 0's appearance code and the skybox
    is rendered twice (the second timed), the first's K3 launches held
    against their plain versions; and a small step with the features and use_exposure (the
    HDR anchor's unit_exposure_rgb set on the dataset), gate open, must
    agree between the card and the CPU (`reference_step`). Returns
    {kernel: {variant: numbers}}."""
    import math
    import numpy as np
    import torch
    from ingp_tpu_torch.data.synthetic import SyntheticDataset
    from ingp_tpu_torch.training.trainer import NeRFSystem, tree_leaves
    t = time.time()
    held = torch.cuda.memory_allocated() / 2 ** 30
    tr = SyntheticDataset(split="train", img_size=IMG_SIZE, n_train=N_VIEWS)
    te = SyntheticDataset(split="test", img_size=IMG_SIZE, n_test=1)
    system = NeRFSystem(bench_hparams(**FEATURES), tr, te, device=DEVICE,
                        seed=0)
    torch.cuda.synchronize()
    log(f"features: {FEATURES}; parameters "
        f"{sorted(system.params)}, model heads "
        f"{sorted(k for k in system.params['model'] if 'net' in k)}; "
        f"set-up {time.time() - t:.2f} s")
    recs = record_kernels(system.model_cfg, KERNELS)
    rng = np.random.default_rng(1)
    losses, gates = [], []
    t = time.time()
    for i in range(FEATURE_STEPS_CLOSED + FEATURE_STEPS_OPEN):
        if i == FEATURE_STEPS_CLOSED:
            system.global_step = system.WARMUP_STEPS
        gates.append(system.global_step >= system.WARMUP_STEPS)
        aux = system.training_step(tr.sample_batch(rng, BATCH))
        losses.append(aux["loss"])
        if i == 0:
            for name, r in recs.items():
                r.restore()
                if PRIMARY[name] not in r.calls:
                    raise AssertionError(f"features: {name} "
                                         f"[{PRIMARY[name]}] was not called")
    torch.cuda.synchronize()
    log(f"features: {len(gates)} untimed steps (skybox gate open: {gates}) "
        f"{time.time() - t:.2f} s; loss terms {sorted(aux['loss_terms'])}")
    batches = [stage(tr.sample_batch(rng, BATCH), system.device)
               for _ in range(FEATURE_STEPS_MEASURE)]
    torch.cuda.synchronize()
    clear_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    for b in batches:
        aux = system.training_step(b)
        losses.append(aux["loss"])
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = dt / FEATURE_STEPS_MEASURE * 1e3
    log(f"features: {FEATURE_STEPS_MEASURE} steps x {BATCH} rays in "
        f"{dt:.3f} s: {step_ms:.2f} ms/step, "
        f"{FEATURE_STEPS_MEASURE * BATCH / dt:.1f} training rays/s, peak "
        f"{peak:.2f} GiB of which {held:.2f} GiB held by the earlier "
        f"phases' systems (phase train: {train_stats['step_ms']:.2f} "
        f"ms/step, {train_stats['rays_per_s']:.1f} rays/s, peak "
        f"{train_stats['peak_gib']:.2f} GiB of which "
        f"{train_stats['held_gib']:.2f} held before it); s_per_ray "
        f"{float(aux['s_per_ray']):.2f}, psnr {float(aux['psnr']):.2f}")
    log(f"features: launches per step "
        f"{ {k: launches[k] / FEATURE_STEPS_MEASURE for k in KERNELS} }")
    check_launched({k: launches[k] for k in KERNELS}, "the features phase")
    losses = [float(v) for v in losses]
    log(f"features: loss first step {losses[0]:.6f}, last {losses[-1]:.6f}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("features: non-finite training loss")
    for path, p in tree_leaves(system.params):
        if not bool(torch.isfinite(p).all()):
            raise AssertionError(f"features: non-finite parameter {path}")
    with torch.no_grad():
        checks = {name: {f"features, {tag}":
                         CHECKS[name](a, f"features, {tag}")
                         for tag, (a, _) in r.calls.items()}
                  for name, r in recs.items()}
    del recs, batches
    checks["composite"].update(feature_render(system, te))
    reference_step("features reference",
                   bench_hparams(**SMALL, **FEATURES, use_exposure=True,
                                 batch_size=512, samples_per_ray=16),
                   step=NeRFSystem.WARMUP_STEPS, unit_exposure_rgb=0.5)
    del system
    torch.cuda.empty_cache()
    return checks


def feature_render(system, te):
    """One test view of the featured system (image 0's appearance code,
    the skybox behind every ray): a first render records K3's launches,
    a second is timed with the launch counts set to 0 before it; the
    recorded launches are held against their plain versions on the CPU.
    Returns K3's {variant: numbers}."""
    import torch
    recs = record_kernels(system.model_cfg, ("composite",))
    system.render_image(te.poses[0])
    recs["composite"].restore()
    clear_counts()
    torch.cuda.synchronize()
    t = time.time()
    out = system.render_image(te.poses[0])
    torch.cuda.synchronize()
    wall = time.time() - t
    n = te.directions.shape[0]
    launches = {k: v for k, v in launch_counts().items() if k in FWD}
    log(f"features render: {n} rays, total_samples {out['total_samples']}, "
        f"{wall * 1e3:.1f} ms wall, {n / wall:.1f} rays/s; launches "
        f"{launches}")
    check_launched(launches, "the featured render")
    for k, v in out.items():
        if k != "total_samples" and (v.shape[0] != n or not bool(
                torch.isfinite(v.float()).all())):
            raise AssertionError(f"features render: {k} {tuple(v.shape)}")
    empty = out["opacity"] == 0
    sky = out["rgb"][empty]
    if not bool(empty.any()) or not bool((sky > 0).any()):
        raise AssertionError("features render: no skybox behind empty rays")
    log(f"features render: {int(empty.sum())} empty rays show the skybox "
        f"(rgb mean {sky.mean(0).tolist()})")
    with torch.no_grad():
        return {f"features render, {tag}":
                check_k3(a, f"features render, {tag}", "cpu")
                for tag, (a, _) in recs["composite"].calls.items()}


# phase "fused": bench.py's configuration on the fused encoder (one table
# of 8 density + 8 rgb features a lattice point, 512-lane rows), the
# sorted head class and the cap auto-calibration on
FUSED = dict(encoder="fused", stream_head_frac=0.5, stream_seg_head=20,
             stream_autocal=True)
FUSED_STEPS, FUSED_MEASURE = 64, 30
# the kernels line rows of the F = 16 launches: row name -> (kernel, the
# first step's variant whose numbers stand in the row)
FUSED_ROWS = {
    "fused_ray_reduce, F 16": ("fused_ray_reduce",
                               "grid table, jac, head class"),
    "brick_reduce, F 16": ("brick_reduce", "grid table, jac"),
    "fused_ray_reduce_bwd, F 16": ("fused_ray_reduce_bwd",
                                   "grid table, jac, head class"),
    "brick_reduce_bwd, F 16": ("brick_reduce_bwd", "grid table, jac"),
}


def grid_table_name(t, jac):
    """The fused encoder's one table: "grid table, <jac|no jac>"."""
    return f"grid table, {'jac' if jac else 'no jac'}"


def k1_class_of(system):
    """urows -> the tile class ("head class", "tail class" or "one
    class") of a K1 launch of the system's stream encoder, by the shape
    (tiles x levels, cap) of its level groups under the system's current
    caps; "other" for a shape of none."""
    from ingp_tpu_torch.ops import streambrick as sb

    def name(urows):
        cfg = system.model_cfg
        bcfg, TS = cfg.fused_brick_cfg, cfg.stream_tile
        classes = sb._tile_classes(
            bcfg, TS, cfg.encode_chunk // TS, cfg.stream_slack,
            cfg.stream_seg, cfg.stream_seg_head, cfg.stream_head_frac,
            cfg.stream_direct_frac, cfg.stream_caps)
        grouped = sb._grouped(bcfg, TS, classes)
        names = ["one class"] if len(classes) == 1 else ["head class",
                                                         "tail class"]
        for (caps, Lc, Tc), nm in zip(classes, names):
            groups = sb.group_levels(caps[:Lc]) if grouped else \
                [(lv, lv + 1, caps[lv]) for lv in range(Lc)]
            if any(tuple(urows.shape) == (Tc * (hi - lo), Ug)
                   for lo, hi, Ug in groups):
                return nm
        return "other"
    return name


def phase_fused(train_system, train_stats):
    """bench.py's training loop on the fused encoder (FUSED) at full
    width: FUSED_STEPS steps, the last FUSED_MEASURE timed on staged
    batches with the launch counts set to 0 before them (step ms,
    training rays/s and peak memory beside phase "train"'s), the
    auto-calibration's reads (every 16 steps) and adopted caps; the first
    step's launches of every kernel variant (K1 at F = 16 by tile class)
    held against their plain versions on the CPU at phase "train"'s
    tolerances, and its K1 and K2 launches counted by variant and shape
    over the untimed steps. Then one step each with stream_sort off, with
    stream_dedup off (the fused model, and phase "train"'s brick model),
    two pose-refinement steps on a fused model whose first launches of
    K2's position-cotangent variant at F = 16 are checked, a slim
    checkpoint whose load restores the adopted caps, and one 256x256 test
    view with them. Returns ({kernel: {variant: numbers}}, {row: launches
    in the timed window (the variant row: in the pose-refinement step)})."""
    import dataclasses
    import math
    import os
    import tempfile
    import numpy as np
    import torch
    from ingp_tpu_torch.data.synthetic import SyntheticDataset
    from ingp_tpu_torch.kernels import brickreduce as k2
    from ingp_tpu_torch.kernels import build
    from ingp_tpu_torch.training.trainer import NeRFSystem, tree_leaves
    from ingp_tpu_torch.utils.ckpt import save_ckpt, slim_state
    t_phase = t = time.time()
    held = torch.cuda.memory_allocated() / 2 ** 30
    tr = SyntheticDataset(split="train", img_size=IMG_SIZE, n_train=N_VIEWS)
    te = SyntheticDataset(split="test", img_size=IMG_SIZE, n_test=1)
    h = bench_hparams(**FUSED)
    system = NeRFSystem(h, tr, te, device=DEVICE, seed=0)
    torch.cuda.synchronize()
    cfg = system.model_cfg
    grid = system.params["model"]["grid_table"]
    log(f"fused: {FUSED}; grid_table {tuple(grid.shape)} f32 "
        f"({grid.numel() * 4 / 1e9:.2f} GB master, read through a bf16 "
        f"copy), {cfg.fused_brick_cfg.n_features} features a point; "
        f"set-up {time.time() - t:.2f} s")
    k1_class = k1_class_of(system)
    recs = record_kernels(cfg, KERNELS, table=grid_table_name,
                          k1_class=k1_class)
    reads = []
    grow = system._maybe_grow_stream_caps

    def read_caps(runs):
        if system.global_step % system.AUTOCAL_EVERY == 0:
            reads.append((system.global_step, runs.cpu().tolist()))
        grow(runs)
    system._maybe_grow_stream_caps = read_caps
    rng = np.random.default_rng(2)
    losses, trail = [], []
    n_untimed = FUSED_STEPS - FUSED_MEASURE
    t = time.time()
    for i in range(n_untimed):
        aux = system.training_step(tr.sample_batch(rng, BATCH))
        losses.append(aux["loss"])
        trail.append(system.model_cfg.stream_caps)
        if i == 0:
            for name, r in recs.items():
                r.restore()
            log(f"fused: first step {time.time() - t:.2f} s; kernel "
                f"variants recorded "
                f"{ {k: list(r.calls) for k, r in recs.items()} }")
            for name, (kernel, tag) in FUSED_ROWS.items():
                if tag not in recs[kernel].calls:
                    raise AssertionError(f"fused: {kernel} [{tag}] was not "
                                         f"called")
            census = record_kernels(cfg, ("fused_ray_reduce",
                                          "brick_reduce",
                                          "fused_ray_reduce_bwd",
                                          "brick_reduce_bwd"), keep=False,
                                    table=grid_table_name, k1_class=k1_class)
    for r in census.values():
        r.restore()
    torch.cuda.synchronize()
    log(f"fused: {n_untimed} untimed steps {time.time() - t:.2f} s")
    for name, r in census.items():
        per = collections.Counter()
        for (v, _), n in r.counts.items():
            per[v] += n / (n_untimed - 1)
        log(f"fused: {name} launches a step in steps 1-{n_untimed - 1} by "
            f"variant {dict(per)}; by variant and shape "
            f"{ {f'{v} {sh}': n for (v, sh), n in sorted(r.counts.items())} }")
    del census
    batches = [stage(tr.sample_batch(rng, BATCH), system.device)
               for _ in range(FUSED_MEASURE)]
    torch.cuda.synchronize()
    clear_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    for b in batches:
        aux = system.training_step(b)
        losses.append(aux["loss"])
        trail.append(system.model_cfg.stream_caps)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = dt / FUSED_MEASURE * 1e3
    log(f"fused: {FUSED_MEASURE} steps x {BATCH} rays in {dt:.3f} s: "
        f"{step_ms:.2f} ms/step, {FUSED_MEASURE * BATCH / dt:.1f} training "
        f"rays/s, peak {peak:.2f} GiB of which {held:.2f} GiB held by the "
        f"earlier phases' systems (phase train's brick step: "
        f"{train_stats['step_ms']:.2f} ms/step, "
        f"{train_stats['rays_per_s']:.1f} rays/s, peak "
        f"{train_stats['peak_gib']:.2f} GiB of which "
        f"{train_stats['held_gib']:.2f} held before it); s_per_ray "
        f"{float(aux['s_per_ray']):.2f}, psnr {float(aux['psnr']):.2f}")
    log(f"fused: launches per step "
        f"{ {k: launches[k] / FUSED_MEASURE for k in KERNELS} }")
    check_launched({k: launches[k] for k in KERNELS}, "the fused phase")
    losses = [float(v) for v in losses]
    log(f"fused: loss first step {losses[0]:.6f}, last {losses[-1]:.6f}; "
        f"mean of the first 5 {np.mean(losses[:5]):.6f}, of the last 5 "
        f"{np.mean(losses[-5:]):.6f}")
    changes = [(i + 1, c) for i, c in enumerate(trail)
               if c != (trail[i - 1] if i else None)]
    log(f"fused: auto-calibration reads (step, per-level run counts) "
        f"{reads}; adopted caps (after step, caps) {changes}")
    if len(reads) < 3 or system.model_cfg.stream_caps is None:
        raise AssertionError(f"fused: {len(reads)} caps reads, caps "
                             f"{system.model_cfg.stream_caps}")
    if not all(math.isfinite(v) for v in losses) or \
            not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError("fused: the training loss is not finite and "
                             "falling")
    for path, p in tree_leaves(system.params):
        if not bool(torch.isfinite(p).all()):
            raise AssertionError(f"fused: non-finite parameter {path}")
    with torch.no_grad():
        checks = {name: {f"fused, {tag}": CHECKS[name](a, f"fused, {tag}")
                         for tag, (a, _) in r.calls.items()}
                  for name, r in recs.items()}
        k1_group_times(recs["fused_ray_reduce"], "fused")
    del recs, batches
    torch.cuda.empty_cache()

    def one_step(what, sys_, **replace):
        """One step of sys_ with its model or render config replaced."""
        model = {k: v for k, v in replace.items()
                 if hasattr(sys_.model_cfg, k)}
        render = {k: v for k, v in replace.items() if k not in model}
        old = sys_.model_cfg, sys_.render_cfg
        sys_.model_cfg = dataclasses.replace(old[0], **model)
        sys_.render_cfg = dataclasses.replace(old[1], **render)
        clear_counts()
        try:
            t = time.time()
            loss = float(sys_.training_step(tr.sample_batch(rng, BATCH))
                         ["loss"])
            torch.cuda.synchronize()
        finally:
            sys_.model_cfg, sys_.render_cfg = old
        n = {k: v for k, v in launch_counts().items() if v}
        log(f"fused {what}: one step {(time.time() - t) * 1e3:.1f} ms, loss "
            f"{loss:.6f}, launches {n}")
        if not math.isfinite(loss):
            raise AssertionError(f"fused {what}: non-finite loss")
        return n

    n = one_step("stream_sort off", system, stream_sort=False)
    check_launched({k: n.get(k, 0) for k in KERNELS}, "the unsorted step")
    for what, sys_ in (("stream_dedup off", system),
                       ("brick, stream_dedup off", train_system)):
        n = one_step(what, sys_, stream_dedup=False)
        if n.get("fused_ray_reduce") or not n.get("brick_reduce_bwd"):
            raise AssertionError(f"fused {what}: launches {n}")

    # pose refinement on a fused model: the per-sample levels' position
    # cotangent (row 4b) at F = 16
    ext = NeRFSystem(bench_hparams(**FUSED, optimize_ext=True), tr, te,
                     device=DEVICE, seed=0)
    rec = Recorder(k2, "brick_reduce_bwd_and_pos",
                   lambda a: grid_table_name(a["storage"],
                                             a["djac"] is not None))
    try:
        ext.training_step(tr.sample_batch(rng, BATCH))
    finally:
        rec.restore()
    clear_counts()
    ext.training_step(tr.sample_batch(rng, BATCH))
    torch.cuda.synchronize()
    pos_launches = build.LAUNCHES[POS_KERNEL[1]]
    row4 = build.LAUNCHES[KERNELS["brick_reduce_bwd"][0]]
    log(f"fused ext: second step's launches "
        f"{ {k: v for k, v in launch_counts().items() if v} }, "
        f"{POS_KERNEL[0]} {pos_launches} (row 4 alone {row4}); |ext| "
        f"{ext_norms(ext)}")
    if not pos_launches or row4 or not all(
            v > 0 for v in ext_norms(ext).values()):
        raise AssertionError("fused ext: no position cotangent, or row 4 "
                             "launched without it")
    del ext
    torch.cuda.empty_cache()
    with torch.no_grad():
        checks[POS_KERNEL[0]] = {
            f"fused ext, {tag}": check_k2_bwd_and_pos(a, f"fused ext, {tag}")
            for tag, (a, _) in rec.calls.items()}
    del rec

    # the adopted caps through a slim checkpoint into a fresh system
    caps = system.model_cfg.stream_caps
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "last_slim")
        t = time.time()
        save_ckpt(path, slim_state(system.state()))
        fresh = NeRFSystem(h, tr, te, device=DEVICE, seed=1)
        before = fresh.model_cfg.stream_caps
        fresh.load(path)
        same = torch.equal(fresh.params["model"]["grid_table"],
                           system.params["model"]["grid_table"])
        log(f"fused checkpoint: slim checkpoint {os.path.getsize(path) / 1e9:.2f}"
            f" GB written and loaded in {time.time() - t:.2f} s; caps before "
            f"the load {before}, after {fresh.model_cfg.stream_caps}, the "
            f"system's {caps}; grid table equal {same}")
        if fresh.model_cfg.stream_caps != caps or before is not None \
                or not same:
            raise AssertionError("fused checkpoint: the caps or the table "
                                 "were not restored")
        del fresh
    torch.cuda.empty_cache()

    clear_counts()
    torch.cuda.synchronize()
    t = time.time()
    out = system.render_image(te.poses[0])
    torch.cuda.synchronize()
    wall = time.time() - t
    n_rays = te.directions.shape[0]
    rl = {k: v for k, v in launch_counts().items() if k in FWD}
    log(f"fused render: {n_rays} rays with caps {caps}, total_samples "
        f"{out['total_samples']}, {wall * 1e3:.1f} ms wall, "
        f"{n_rays / wall:.1f} rays/s; launches {rl}; opacity mean "
        f"{float(out['opacity'].mean()):.4f}")
    check_launched(rl, "the fused render")
    for k, v in out.items():
        if k != "total_samples" and (v.shape[0] != n_rays or not bool(
                torch.isfinite(v.float()).all())):
            raise AssertionError(f"fused render: {k} {tuple(v.shape)}")
    del system
    torch.cuda.empty_cache()
    log(f"fused: phase {time.time() - t_phase:.1f} s")
    rows = {name: launches[kernel] for name, (kernel, _) in
            FUSED_ROWS.items()}
    rows[f"{POS_KERNEL[0]}, F 16"] = pos_launches
    return checks, rows


def check_train_kernels(recs):
    """Every kernel variant of the first training step on its recorded
    inputs, against its plain version run on the CPU. Forward: 1e-5 of
    the largest |value| (+1e-7), the tolerance of the render's checks.
    Backward: a cell's per-lane cotangent has the same bits on the card
    and the CPU (each operation rounded on its own, in one order) and K1
    sums a slot's cells in the same order, so only the f32 atomic adds
    into the master gradient run in another order -- 1e-5 of the largest
    |value| (+1e-12). Returns {kernel: {variant: numbers}}."""
    out = {}
    for name, r in recs.items():
        out[name] = {}
        for tag, (a, _) in r.calls.items():
            out[name][tag] = CHECKS[name](a, f"train, {tag}")
    return out


def check_late(name, late):
    """Backward kernel `name` on the launches of step LATE_STEP (late,
    {variant: (arguments, output)}) against the plain version on the
    CPU, keyed "step LATE_STEP, <variant>"."""
    if PRIMARY[name] not in late:
        raise AssertionError(f"{name} [{PRIMARY[name]}] was not called in "
                             f"step {LATE_STEP}")
    return {f"step {LATE_STEP}, {tag}":
            CHECKS[name](a, f"train step {LATE_STEP}, {tag}")
            for tag, (a, _) in late.items()}


def k1_bwd_group_times(first, late):
    """K1 backward at every level-group shape of the first step (first)
    and of step LATE_STEP (late), Recorders with the first arguments of
    each (variant, shape): CUDA-graph ms into one reused zeroed gradient
    beside the bound, one line per shape, then the sums over the step's
    launches."""
    import torch
    from ingp_tpu_torch.kernels import rayreduce as k1
    from ingp_tpu_torch.probes.common import graph_ms
    sums = {}
    rows = collections.defaultdict(dict)
    for when, rec in (("first", first), ("late", late)):
        grads = {}
        total = 0.0
        for (v, shape), a in sorted(rec.shapes.items()):
            g = grads.get(v)
            if g is None:
                g = grads[v] = torch.zeros(a["grad"].shape, device=DEVICE)
            g.zero_()
            ms = graph_ms(lambda a=a, g=g: k1.fused_ray_reduce_bwd(
                **{**a, "grad": g}))
            bound, _ = bound_of(*_k1b_size(a)[:2])
            n = rec.counts[(v, shape)]
            total += ms * n
            rows[(v, shape)][when] = (ms, bound, n)
        sums[when] = total
        del grads
    for (v, shape), r in sorted(rows.items()):
        parts = [f"{'first step' if w == 'first' else f'step {LATE_STEP}'} "
                 f"{ms:.4f} ms from a CUDA graph (bound {b:.4f} ms, graph at "
                 f"{b / ms:.1%} of it; {n} launch{'es' * (n > 1)})"
                 for w, (ms, b, n) in sorted(r.items())]
        log(f"kernel fused_ray_reduce_bwd [train, {v}] group {shape}: "
            + "; ".join(parts))
    log(f"kernel fused_ray_reduce_bwd: graph ms summed over the step's "
        f"launches: first step {sums['first']:.4f} ms, step {LATE_STEP} "
        f"{sums['late']:.4f} ms")


def k3_fwd_before_after(rows):
    """The K3 forward body that the current kernel replaced (the split's
    `k3 fwd full`, handed a plane of zeros where the call has no ts, as
    the step gave it before) beside the kernel, on recorded arguments,
    rows (tag, arguments, bound ms). ws, Ts and count must be bitwise
    equal to the old body's, the other outputs within the forward check's
    tolerance; then each is timed in turns old, new, new, old (CUDA-event
    medians of 20 runs from the host) and replayed from a CUDA graph."""
    import torch
    from ingp_tpu_torch.kernels import composite as k3
    from ingp_tpu_torch.probes import kernel_split as ps
    from ingp_tpu_torch.probes.common import graph_ms
    for tag, a, bound in rows:
        a_old = a if a["ts"] is not None else {
            **a, "ts": torch.zeros_like(a["sigmas"])}
        old = lambda: ps.split_k3f("full", **a_old)   # noqa: E731
        new = lambda: k3.composite_fwd(**a)           # noqa: E731
        o, n = old(), new()
        bitwise = ["ws", "count"] + (["Ts"] if a["with_Ts"] else [])
        for k in bitwise:
            if not torch.equal(o[k], n[k]):
                raise AssertionError(f"before/after composite [{tag}]: {k} "
                                     f"differs from the old body's")
        rest = sorted(set(n) - set(bitwise))
        err, scale = max_err([n[k] for k in rest], [o[k] for k in rest])
        if not err <= 1e-5 * scale + 1e-7:
            raise AssertionError(f"before/after composite [{tag}]: the new "
                                 f"kernel and the old body differ by "
                                 f"{err:.3e}")
        del o, n
        t = [cuda_ms(fn, 20) for fn in (old, new, new, old)]
        g = [graph_ms(fn) for fn in (old, new)]
        was, now = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        log(f"before/after composite [{tag}]: old (the replaced K3 fwd "
            f"body{', reading a zero ts plane' if a['ts'] is None else ''})"
            f" {was:.4f} ms ({t[0]:.4f}, {t[3]:.4f}), new {now:.4f} ms "
            f"({t[1]:.4f}, {t[2]:.4f}) from the host; replayed from a CUDA "
            f"graph old {g[0]:.4f} ms, new {g[1]:.4f} ms ({g[0] / g[1]:.2f}x, "
            f"new at {bound / g[1]:.1%} of the bound {bound:.4f} ms, old at "
            f"{bound / g[0]:.1%}); {', '.join(bitwise)} bitwise equal to the "
            f"old body's, {', '.join(rest)} agree to {err:.3e} (max "
            f"{scale:.3e})")


def _old_new(name, a):
    """The replaced body (the K1/K2/K3 split's `full` variant) and the
    current kernel on recorded arguments a: (old, new, gradient or None,
    atol, what). A backward pair adds into one gradient, zeroed before
    each output is compared."""
    import torch
    from ingp_tpu_torch.kernels import brickreduce as k2
    from ingp_tpu_torch.kernels import composite as k3
    from ingp_tpu_torch.kernels import rayreduce as k1
    from ingp_tpu_torch.probes import kernel_split as ps
    if name == "composite_bwd":
        return (lambda: ps.split_k3b("full", **a),
                lambda: k3.composite_bwd(**a), None, 1e-12,
                "the replaced K3 bwd body")
    window = a["jac_lo"] == 0 and a["jac_hi"] in (None, a["F"])
    if a["F"] != ps.F or not window:
        raise AssertionError(f"{name}: the split's full body takes F = 8 "
                             f"and the full window")
    if name == "brick_reduce":
        args = (a["table"], a["rows"], a["lf"])
        return (lambda: ps.split_k2("full", *args, a["with_jac"]),
                lambda: k2.brick_reduce(*args, a["F"], a["with_jac"],
                                        a["jac_lo"], a["jac_hi"]),
                None, 1e-7, "the replaced K2 fwd body")
    grad = torch.zeros_like(a["grad"])
    if name == "brick_reduce_bwd":
        # the split's old body takes contiguous cotangents; the kernel
        # gets them as the step hands them over
        dj = None if a["djac"] is None else a["djac"].contiguous()
        old_args = (grad, a["rows"], a["lf"], a["dfeats"].contiguous(), dj)
        args = (grad, a["rows"], a["lf"], a["dfeats"], a["djac"])
        return (lambda: ps.split_k2b("full", *old_args, bf16=a["bf16"]),
                lambda: k2.brick_reduce_bwd(*args, a["F"], a["jac_lo"],
                                            a["jac_hi"], a["bf16"]),
                grad, 1e-12, "the replaced K2 bwd body")
    args = (grad, a["urows"], a["uid"], a["lf"], a["dfeats"], a["djac"])
    return (lambda: ps.split_bwd("full", *args, bf16=a["bf16"]),
            lambda: k1.fused_ray_reduce_bwd(*args, a["F"], a["jac_lo"],
                                            a["jac_hi"], a["bf16"]),
            grad, 1e-12, "the replaced K1 bwd body")


def _flat_outs(out):
    return [t.clone() for t in (out if isinstance(out, (tuple, list))
                                else (out,)) if t is not None]


def before_after_rows(recs, checks, late):
    """The rows of `before_after`: the first step's BEFORE_AFTER
    variants (recs) and the K2 bwd launches of step LATE_STEP (late,
    {variant: (arguments, output)}), each with the bound of its check."""
    rows = [(name, f"train, {tag}", recs[name].calls[tag][0],
             checks[name][tag]["bound_ms"]) for name, tag in BEFORE_AFTER]
    for tag, (a, _) in late.items():
        rows.append(("brick_reduce_bwd", f"train step {LATE_STEP}, {tag}", a,
                     checks["brick_reduce_bwd"][f"step {LATE_STEP}, {tag}"]
                     ["bound_ms"]))
    return rows


def before_after(rows):
    """The bodies that the current K1 backward, K2 forward, K2 backward
    and K3 backward replaced (the split's `full` variants) beside them,
    on recorded inputs, rows (kernel, tag, arguments, bound ms): the
    first training step's BEFORE_AFTER variants and the last untimed
    step's K2 bwd launches. The two outputs are held to each other at the
    check's tolerance, then each timed
    in turns old, new, new, old (CUDA-event medians of 20 runs). One line
    each: old ms, new ms, the bound, old / new, both replayed from a CUDA
    graph (the device's time without the host's dispatch of the
    wrapper) and, for K2 bwd, both with the gradient's rows cold in the
    L2 (`cold_ms`). For K2 bwd also the K2 bwd split's stubs on the same
    inputs (K2B_SPLIT), from a CUDA graph and cold."""
    from ingp_tpu_torch.probes.common import graph_ms
    for name, tag, a, bound in rows:
        old, new, grad, atol, what = _old_new(name, a)
        outs = []
        for fn in (old, new):
            if grad is not None:
                grad.zero_()
            outs.append(_flat_outs(fn()))
        err, scale = max_err(outs[1], outs[0])
        if not err <= 1e-5 * scale + atol:
            raise AssertionError(f"before/after {name} [{tag}]: the new "
                                 f"kernel and {what} differ by {err:.3e}")
        del outs
        t = [cuda_ms(fn, 20) for fn in (old, new, new, old)]
        g = [graph_ms(fn) for fn in (old, new)]
        was, now = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        cold = ""
        if name == "brick_reduce_bwd":
            c = [cold_ms(fn, grad) for fn in (old, new, new, old)]
            cold = (f"; L2-cold old {(c[0] + c[3]) / 2:.4f} ms, new "
                    f"{(c[1] + c[2]) / 2:.4f} ms")
        log(f"before/after {name} [{tag}]: old ({what}) "
            f"{was:.4f} ms ({t[0]:.4f}, {t[3]:.4f}), new {now:.4f} ms "
            f"({t[1]:.4f}, {t[2]:.4f}), bound {bound:.4f} ms; old/new "
            f"{was / now:.2f}x, new at {bound / now:.1%} of the bound; "
            f"replayed from a CUDA graph (no host dispatch) old "
            f"{g[0]:.4f} ms, new {g[1]:.4f} ms ({g[0] / g[1]:.2f}x){cold}; "
            f"outputs agree to {err:.3e} (max {scale:.3e})")
        if name == "brick_reduce_bwd":
            k2b_split(a, tag, grad)


def k2b_split(a, tag, grad):
    """The K2 bwd split's variants (K2B_SPLIT) on one recorded launch,
    from a CUDA graph and with the gradient cold, and the share of
    `full`'s time each stub takes away (1 - stub / full)."""
    import torch
    from ingp_tpu_torch.probes import kernel_split as ps
    from ingp_tpu_torch.probes.common import graph_ms
    scratch = torch.zeros(ps.k2b_blocks(a["rows"].numel()),
                          device=DEVICE)
    args = (grad, a["rows"], a["lf"], a["dfeats"].contiguous(),
            None if a["djac"] is None else a["djac"].contiguous(), scratch)
    g, c = {}, {}
    for mode in K2B_SPLIT:
        fn = lambda m=mode: ps.split_k2b(m, *args,  # noqa: E731
                                         bf16=a["bf16"])
        g[mode], c[mode] = graph_ms(fn), cold_ms(fn, grad)
    shares = ", ".join(
        f"{m} {g[m]:.4f} / {c[m]:.4f} ms ({1 - g[m] / g['full']:+.1%} / "
        f"{1 - c[m] / c['full']:+.1%})" for m in K2B_SPLIT if m != "full")
    log(f"k2 bwd split [{tag}] (graph / L2-cold; share of full "
        f"taken away): full {g['full']:.4f} / {c['full']:.4f} ms; "
        f"{shares}")


def cpu_params(system):
    """A copy of a system's parameters on the CPU, requiring grad."""
    from ingp_tpu_torch.models.ngp import params_from_numpy
    from ingp_tpu_torch.training.trainer import tree_map
    return tree_map(lambda t: t.requires_grad_(),
                    params_from_numpy(system.params_to_numpy(), "cpu"))


def phase_train_reference():
    """One small training step's loss and gradients on the card (kernels)
    and on the CPU (plain versions), from the same parameters, batch,
    noise and grid (`reference_step`)."""
    reference_step("train reference", bench_hparams(
        **SMALL, batch_size=512, samples_per_ray=16))


def reference_step(what, h, step=0, unit_exposure_rgb=None, batch_seed=5,
                   check=True, f64=False):
    """One small training step's loss and gradients at global step
    `step` on the card (kernels) and on the CPU (plain versions), from
    the same parameters, batch (drawn from batch_seed), noise, grid and
    draws (both systems draw the same background from the same seed).
    f32 throughout; sums in other orders (atomics, cuBLAS against the
    CPU's matmul), so with check the loss is held to rtol 1e-5 and each
    gradient leaf to 1e-4 of its largest |value|, norm_net's to 1e-3 (it
    reaches the loss only through the Ref-NeRF term of the normalised
    density gradient, which amplifies rounding where that gradient is
    short). Returns {leaf: error as a fraction of its largest value}; with
    f64 also the card's and the CPU's inputs to the encoder compared
    (`shared_inputs`) and, for each of F64_MODES, ({leaf: the card's
    distance}, {leaf: the CPU's distance}, {leaf: both sides' distance
    on the entries where they differ}) to the same step in float64
    (`float64_grads`), each side's on its own samples and cells."""
    import numpy as np
    from ingp_tpu_torch.data.synthetic import SyntheticDataset
    from ingp_tpu_torch.training.trainer import NeRFSystem
    tr = SyntheticDataset(split="train", img_size=32, n_train=4)
    if unit_exposure_rgb is not None:
        tr.unit_exposure_rgb = unit_exposure_rgb
    gpu = NeRFSystem(h, tr, device=DEVICE, seed=3)
    for k in ("density_table", "rgb_table"):
        gpu.params["model"][k].data.mul_(1e3)
    cpu = NeRFSystem(h, tr, device="cpu", seed=3,
                     params=gpu.params_to_numpy())
    set_sphere_grid(gpu)
    set_sphere_grid(cpu)
    gpu.global_step = cpu.global_step = step
    rng = np.random.default_rng(batch_seed)
    batch = tr.sample_batch(rng, 512)
    noise = rng.random(512, dtype=np.float32)
    if not f64:
        return hold_step(what, gpu, cpu, batch, noise, check)[0]
    worst, gb, ga = hold_step(what, gpu, cpu, batch, noise, check,
                              card_grads=True)
    tapes = {}
    for side, system in (("card", gpu), ("cpu", cpu)):
        tapes[side] = {"march": [], "coords": []}
        with float64_replay(tapes[side], record=True):
            system.loss_and_grads(batch, noise)
    shared = shared_inputs(tapes["card"], tapes["cpu"])
    # the CPU's f32 step on the card's own samples
    tapes["card"] = {k: [host(x) for x in v] for k, v in tapes["card"].items()}
    on_card = {"march": [], "coords": [],
               "samples": list(tapes["card"]["march"])}
    with float64_replay(on_card, record=True):
        _, gc = cpu.loss_and_grads(batch, noise)
    shared["card_vs_cpu_on_card_samples"] = leaf_distances(ga, gc)
    # each side's float64 steps replay its own samples and cells
    out = {}
    for mode in F64_MODES:
        g64 = {side: float64_grads(
            h, tr, gpu.params_to_numpy(), step, batch, noise,
            {k: list(tapes[side][k]) for k in ("march", "coords")},
            own_frac=mode == "f32 frac") for side in ("card", "cpu")}
        out[mode] = (leaf_distances(ga, g64["card"]),
                     leaf_distances(gb, g64["cpu"]),
                     split_distances(ga, gb, g64["card"], g64["cpu"]))
    return worst, shared, out


def hold_step(what, gpu, cpu, batch, noise, check=True, card_grads=False):
    """One step's loss and gradients of a card system and a CPU system
    on the same batch and noise: with check, the loss to rtol 1e-5 and
    each gradient leaf to 1e-4 of its largest |value|, norm_net's to 1e-3
    (see `reference_step`). Returns ({leaf: error as a fraction of its
    largest value}, the CPU's gradients[, the card's with card_grads])."""
    from ingp_tpu_torch.training.trainer import tree_leaves
    aux_a, ga = gpu.loss_and_grads(batch, noise)
    aux_b, gb = cpu.loss_and_grads(batch, noise)
    la, lb = float(aux_a["loss"]), float(aux_b["loss"])
    if check and not abs(la - lb) <= 1e-5 * abs(lb):
        raise AssertionError(f"{what}: loss {la} (card) vs {lb} (cpu)")
    worst = {}
    for (path, a), (_, b) in zip(tree_leaves(ga), tree_leaves(gb)):
        scale = float(b.abs().max())
        rel = float((a.cpu() - b).abs().max()) / scale if scale else \
            float(a.abs().max())
        name = ".".join(str(x) for x in path)
        worst[name] = rel
        tol = 1e-3 if "norm_net" in path else 1e-4
        if check and not rel <= tol:
            raise AssertionError(f"{what}: gradient {name}: {rel} of its "
                                 f"largest value > {tol}")
    log(f"{what}: {len(noise)} rays, loss {la:.8f} (card) vs {lb:.8f} "
        f"(cpu); loss terms {sorted(aux_a['loss_terms'])}; gradient leaves "
        f"agree to "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in worst.items()})}"
        f" of their largest values")
    return (worst, gb, ga) if card_grads else (worst, gb)


# the float64 steps of --reference-spread: "exact" takes each brick's
# trilinear weights from the float64 position less the recorded corner,
# "f32 frac" takes the f32 step's own weights (cast), so that the f32
# rounding of the positions and fractions, which the card's torch ops
# and the CPU's may round apart, is no longer a distance of either side
F64_MODES = ("exact", "f32 frac")


@contextlib.contextmanager
def float64_replay(tape, record, own_frac=False):
    """With record, the step runs as it is (on the samples of
    `tape["samples"]` in place of its march's, where given) and `tape`
    keeps the march's samples and `brick_coords`' cells (rows, local
    cell, integer grid corner, f32 fraction, the positions and the
    config). Without, a CPU
    step replays them in float64: torch's float32 (and `Tensor.float`)
    stand for float64 and each brick's trilinear weights come from the
    float64 position less the recorded corner (with own_frac, the
    recorded f32 fraction), so that the float64 step keeps the f32
    step's samples and cells and differs from it only in rounding."""
    import torch
    from ingp_tpu_torch.models import rendering
    from ingp_tpu_torch.ops import brickgrid, gather, streambrick
    march0, coords0 = rendering._march, brickgrid.brick_coords
    saved = (torch.float32, torch.float, torch.Tensor.float,
             dict(gather._DTYPES), torch.get_default_dtype())

    def march(*a, **k):
        if record:
            tape["march"].append(tape["samples"].pop(0) if tape.get(
                "samples") is not None else march0(*a, **k))
            return tape["march"][-1]
        return {n: v.double() if v.is_floating_point() else v
                for n, v in tape["march"].pop(0).items()}

    def coords(cfg, xT):
        if record:
            rows, local, frac = coords0(cfg, xT)
            sc = torch.tensor(cfg.scales, device=xT.device)[None, :, None]
            tape["coords"].append((rows, local,
                                   xT[:, None] * sc + 0.5 - frac, frac,
                                   xT, cfg))
            return rows, local, frac
        rows, local, corner, frac, _, _ = tape["coords"].pop(0)
        sc = torch.tensor(cfg.scales, dtype=saved[0]).double()
        pos = xT.double()[:, None] * sc[None, :, None]
        if own_frac:
            # the recorded value, with the position's derivative kept
            return rows, local, frac.double() + (pos - pos.detach())
        return rows, local, pos + 0.5 - corner.double()

    rendering._march = march
    brickgrid.brick_coords = streambrick.brick_coords = coords
    if not record:
        torch.float32 = torch.float = torch.float64
        torch.Tensor.float = torch.Tensor.double
        gather._DTYPES["float32"] = torch.float64
        torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        rendering._march = march0
        brickgrid.brick_coords = streambrick.brick_coords = coords0
        torch.float32, torch.float, torch.Tensor.float = saved[:3]
        gather._DTYPES.clear()
        gather._DTYPES.update(saved[3])
        torch.set_default_dtype(saved[4])


def float64_grads(h, tr, params, step, batch, noise, tape, own_frac=False):
    """The gradients of `reference_step`'s step on the CPU in float64,
    replaying the recorded f32 step's samples and cells (with own_frac
    its trilinear weights too)."""
    import numpy as np
    from ingp_tpu_torch.training.trainer import NeRFSystem, tree_map
    sys64 = NeRFSystem(h, tr, device="cpu", seed=3, params=params)
    set_sphere_grid(sys64)
    sys64.global_step = step
    sys64.params = tree_map(lambda t: t.detach().double().requires_grad_(),
                            sys64.params)
    b64 = {k: v.astype(np.float64) if getattr(v, "dtype", None) ==
           np.float32 else v for k, v in batch.items()}
    with float64_replay(tape, record=False, own_frac=own_frac):
        _, g64 = sys64.loss_and_grads(b64, noise.astype(np.float64))
    if tape["march"] or tape["coords"]:
        raise AssertionError("float64 step: the replay left samples unused")
    return g64


def host(x):
    """A recorded tape entry (a march dict or a `brick_coords` tuple)
    with its tensors on the CPU."""
    import torch
    if isinstance(x, dict):
        return {k: v.cpu() for k, v in x.items()}
    return tuple(v.cpu() if torch.is_tensor(v) else v for v in x)


def shared_inputs(card, cpu) -> dict:
    """How far the card's f32 step and the CPU's feed the encoder the
    same inputs: the march's samples (float fields' max abs difference,
    integer fields' mismatches); for each of the CPU's recorded
    `brick_coords` calls, `brick_coords` of the same positions on the
    card (rows' mismatches, the fraction's max abs difference); each
    side's own positions and cells, call by call (`own_*`: the
    positions' max abs difference and how many differ, the fractions'
    max abs difference, rows' mismatches); the number of `brick_coords`
    calls each side made."""
    from ingp_tpu_torch.ops import brickgrid
    out = {"march_float": 0.0, "march_int": 0, "rows": 0, "frac": 0.0,
           "own_xT": 0.0, "own_xT_differ": 0, "own_frac": 0.0,
           "own_rows": 0,
           "coords_calls": [len(card["coords"]), len(cpu["coords"])]}
    for a, b in zip(card["coords"], cpu["coords"]):
        if a[4].shape != b[4].shape:
            out["own_shapes_differ"] = True
            continue
        d = (a[4].cpu() - b[4]).abs()
        out["own_xT"] = max(out["own_xT"], float(d.max()) if d.numel()
                            else 0.0)
        out["own_xT_differ"] += int((d > 0).sum())
        out["own_frac"] = max(out["own_frac"], float(
            (a[3].cpu() - b[3]).abs().max()) if b[3].numel() else 0.0)
        out["own_rows"] += int((a[0].cpu() != b[0]).sum())
    if len(card["march"]) != len(cpu["march"]):
        out["march_calls"] = [len(card["march"]), len(cpu["march"])]
    for a, b in zip(card["march"], cpu["march"]):
        for k, v in b.items():
            w = a[k].cpu()
            if w.shape != v.shape:
                out[f"march_shape_{k}"] = [list(w.shape), list(v.shape)]
            elif v.is_floating_point():
                out["march_float"] = max(out["march_float"], float(
                    (w - v).abs().max()) if v.numel() else 0.0)
            else:
                out["march_int"] += int((w != v).sum())
    for rows, _, _, frac, xT, cfg in cpu["coords"]:
        r, _, f = brickgrid.brick_coords(cfg, xT.to(DEVICE))
        out["rows"] += int((r.cpu() != rows).sum())
        out["frac"] = max(out["frac"], float((f.cpu() - frac).abs().max())
                          if frac.numel() else 0.0)
    return out


def split_distances(ga, gb, g64a, g64b, floor=1e-5) -> dict:
    """{leaf: (entries where the card's gradients ga and the CPU's gb
    differ by more than floor of gb's largest value, ga's max distance
    to g64a and gb's to g64b on them, as fractions of the float64
    step's largest value)}."""
    from ingp_tpu_torch.training.trainer import tree_leaves
    out = {}
    for (path, a), (_, b), (_, c), (_, d) in zip(
            tree_leaves(ga), tree_leaves(gb), tree_leaves(g64a),
            tree_leaves(g64b)):
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        scale, sc, sd = (float(t.abs().max()) for t in (b, c, d))
        if not (scale and sc and sd):
            continue
        m = (a - b).abs() > floor * scale
        n = int(m.sum())
        name = ".".join(str(x) for x in path)
        out[name] = (n, float((a - c)[m].abs().max()) / sc if n else 0.0,
                     float((b - d)[m].abs().max()) / sd if n else 0.0)
    return out


def leaf_distances(grads, g64) -> dict:
    """{leaf: max |g - g64| as a fraction of g64's largest value}."""
    from ingp_tpu_torch.training.trainer import tree_leaves
    out = {}
    for (path, a), (_, b) in zip(tree_leaves(grads), tree_leaves(g64)):
        scale = float(b.abs().max())
        if scale:
            out[".".join(str(x) for x in path)] = float(
                (a.detach().cpu().double() - b).abs().max()) / scale
    return out


def reference_spread(seeds=range(5, 11)):
    """`reference_step` of phase "train reference" and of phase
    "features" (gate open, and closed with the random background behind
    the rays) at each batch seed, unchecked, each with its float64 steps
    (`float64_grads`, F64_MODES): per step the four worst leaves card
    against CPU, whether both sides fed the encoder the same samples and
    fractions (`shared_inputs`) and the card against the CPU's f32 step
    on the card's samples, then per mode the card's and the f32 CPU
    step's distance to float64 (each on its own samples and cells) on
    the leaves the check bounds at 1e-4,
    and both sides' distance on the entries where they differ by more
    than 1e-5 of the largest value (`split_distances`;
    `--reference-spread`; the checks use seed 5). Ends with each side's
    worst over all steps per mode."""
    def fmt(d):
        return json.dumps({k: float(f"{v:.3g}") for k, v in d.items()})

    small = dict(SMALL, batch_size=512, samples_per_ray=16)
    feat = bench_hparams(**small, **FEATURES, use_exposure=True)
    worst_side = {(m, s): {} for m in F64_MODES
                  for s in ("card", "cpu", "card where they differ",
                            "cpu where they differ")}
    for what, h, step in (
            ("train", bench_hparams(**small), 0),
            ("features, gate open", feat, 256),
            ("features, gate closed", feat, 0)):
        for seed in seeds:
            tag = f"{what}, batch seed {seed}"
            worst, shared, dist = reference_step(
                f"spread {tag}", h, step, 0.5 if h is feat else None, seed,
                check=False, f64=True)
            top = sorted(worst.items(), key=lambda kv: -kv[1])[:4]
            log(f"spread [{tag}]: worst leaves {fmt(dict(top))}")
            on_card = shared.pop("card_vs_cpu_on_card_samples")
            top = sorted(on_card.items(), key=lambda kv: -kv[1])[:4]
            log(f"spread inputs [{tag}]: card against CPU "
                f"{json.dumps(shared)}; the card against the CPU's step on "
                f"the card's samples {fmt(dict(top))}")
            for mode, (card, cpu, split) in dist.items():
                sides = {"card": card, "cpu": cpu,
                         "card where they differ":
                             {k: v[1] for k, v in split.items()},
                         "cpu where they differ":
                             {k: v[2] for k, v in split.items()}}
                for side, d in sides.items():
                    tab = {k: v for k, v in d.items() if "norm_net" not in k}
                    acc = worst_side[(mode, side)]
                    for k, v in tab.items():
                        acc[k] = max(acc.get(k, 0), v)
                    if side in ("card", "cpu"):
                        top = sorted(tab.items(), key=lambda kv: -kv[1])[:4]
                        log(f"spread float64 {mode} [{tag}]: {side} to "
                            f"float64 {fmt(dict(top))}")
                differ = {k: v for k, v in split.items()
                          if "norm_net" not in k and v[0]}
                log(f"spread float64 {mode} [{tag}]: where card and CPU "
                    f"differ by > 1e-5 (entries, card, cpu to float64): "
                    + json.dumps({k: [n, float(f"{c:.3g}"),
                                      float(f"{u:.3g}")]
                                  for k, (n, c, u) in differ.items()}))
    for (mode, side), d in worst_side.items():
        top = sorted(d.items(), key=lambda kv: -kv[1])[:6]
        log(f"spread float64 {mode}, worst over all steps: {side} "
            f"{fmt(dict(top))}")


# the JAX CLI's test PSNR on configs/synthetic_smoke.txt (`python -m
# ingp_tpu.train --config configs/synthetic_smoke.txt`, 500 steps, JAX on
# the CPU; PERF.md): the port's CLI run may land at most CLI_PSNR_SLACK dB
# below it
JAX_CLI_PSNR = 21.097
CLI_PSNR_SLACK = 1.0
CLI_CONFIG = "configs/synthetic_smoke.txt"


def _repo_file(rel):
    """The path of rel, a file of the repository."""
    import os
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), rel)


class StepLog:
    """While active, records the loss and the host clock after every
    `NeRFSystem.training_step`."""

    def __enter__(self):
        from ingp_tpu_torch.training.trainer import NeRFSystem
        self.cls, self.fn = NeRFSystem, NeRFSystem.training_step
        self.losses, self.times = [], []
        log_ = self

        def step(system, batch):
            aux = log_.fn(system, batch)
            log_.losses.append(aux["loss"])
            log_.times.append(time.time())
            return aux
        NeRFSystem.training_step = step
        return self

    def __exit__(self, *exc):
        self.cls.training_step = self.fn

    def step_ms(self) -> float:
        """Median host milliseconds between consecutive steps."""
        import numpy as np
        return float(np.median(np.diff(self.times))) * 1e3


def check_falling(losses, n, what):
    """Finite losses whose mean over the last n steps is below that over
    the first n."""
    import numpy as np
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{what}: non-finite training loss")
    first, last = np.mean(losses[:n]), np.mean(losses[-n:])
    log(f"{what}: loss mean of the first {n} steps {first:.6f}, of the "
        f"last {n} {last:.6f}")
    if not last < first:
        raise AssertionError(f"{what}: the training loss did not fall")


def check_hash_encode(cfg, table):
    """The hash encode with its jacobian, and the table gradient of a
    random cotangent of both, on the card against the same calls on the
    CPU: within 1e-5 of the largest |CPU value|. table: (total_rows, F)
    f32 on the CPU."""
    import torch
    from ingp_tpu_torch.ops.hashgrid import hashgrid_encode_grad
    gen = torch.Generator().manual_seed(0)
    n = 65536
    # points in the cube and up to 1% outside it (the corner clamp)
    x = torch.rand((3, n), generator=gen) * 1.02 - 0.01
    L, F = cfg.n_levels, cfg.n_features
    cf = torch.randn((n, L * F), generator=gen)
    cj = torch.randn((3, n, L * F), generator=gen)
    outs = {}
    for dev in (DEVICE, "cpu"):
        t = table.to(dev).requires_grad_()
        f, j = hashgrid_encode_grad(cfg, t, x.to(dev), x_cm=True)
        ((f * cf.to(dev)).sum() + (j * cj.to(dev)).sum()).backward()
        outs[dev] = [v.detach().cpu() for v in (f, j, t.grad)]
    worst = {}
    for name, a, b in zip(("feats", "jac", "table grad"), outs[DEVICE],
                          outs["cpu"]):
        err, scale = max_err([a], [b])
        worst[name] = err / scale
        if not err <= 1e-5 * scale:
            raise AssertionError(f"hash encode {name}: card vs cpu {err} > "
                                 f"1e-5 of {scale}")
    log(f"cli: hash encode of {n} points, {L} levels x {F} features "
        f"({sum(cfg.hashed)} hashed), card vs cpu: "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in worst.items()})} "
        f"of the largest values")


def phase_cli():
    """`ingp_tpu_torch.train.main` on configs/synthetic_smoke.txt at its
    own 500 steps of 2048 rays (the hash encoder, f32, the sparsity
    prior), in a temporary working directory: the step time, the
    losses (finite and falling), the test PSNR (at most CLI_PSNR_SLACK
    dB under JAX_CLI_PSNR) and SSIM, with --eval_lpips on LPIPS weights
    drawn from a seed (`random_lpips_params`, written to the temporary
    directory) a finite `lpips`, the checkpoints `last` and `last_slim`,
    a `--ckpt_load last --val_only` run that must give the same metrics
    to 1e-6, and the hash encode on the card against the CPU. Returns the
    launch counts of the training run."""
    import os
    import tempfile
    import torch
    from ingp_tpu_torch import train as train_cli
    from ingp_tpu_torch.core import prng
    from ingp_tpu_torch.training import lpips
    from ingp_tpu_torch.training.config import get_opts
    from ingp_tpu_torch.training.trainer import model_config_from_hparams
    from ingp_tpu_torch.utils.ckpt import load_ckpt
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="ingp_cli_") as tmp:
        weights = os.path.join(tmp, "lpips_random.npz")
        lpips.save_lpips(weights, lpips.random_lpips_params(prng.prng_key(0)))
        argv = ["--config", _repo_file(CLI_CONFIG), "--eval_lpips",
                "--lpips_weights", weights]
        h = get_opts(argv)
        os.chdir(tmp)
        try:
            t = time.time()
            clear_counts()
            with StepLog() as steps:
                metrics = train_cli.main(argv)
            torch.cuda.synchronize()
            launches = launch_counts()
            wall = time.time() - t
            ckpt_dir = os.path.join(tmp, "ckpts", h.dataset_name, h.exp_name)
            for name in ("last", "last_slim"):
                if not os.path.isfile(os.path.join(ckpt_dir, name)):
                    raise AssertionError(f"cli: no checkpoint {name}")
            last = os.path.join(ckpt_dir, "last")
            again = train_cli.main(argv + ["--ckpt_load", last,
                                           "--val_only"])
            table = load_ckpt(last)["params"]["model"]["density_table"]
        finally:
            os.chdir(cwd)
    n = len(steps.losses)
    log(f"cli: {CLI_CONFIG}, {n} steps x {h.batch_size} rays, encoder "
        f"{h.encoder}, in {wall:.2f} s with validation and checkpoints; "
        f"{steps.step_ms():.2f} ms/step (median host time between steps); "
        f"launches {launches}")
    check_launched({k: launches[k] for k in ("composite", "composite_bwd")},
                   "the cli run")
    check_falling(steps.losses, 50, "cli")
    log(f"cli: test/psnr {metrics['psnr']:.4f} test/ssim "
        f"{metrics['ssim']:.4f} test/lpips {metrics.get('lpips', 'absent')} "
        f"(random LPIPS weights; JAX's CLI on the CPU: psnr {JAX_CLI_PSNR}); "
        f"--ckpt_load last --val_only: psnr {again['psnr']:.4f} ssim "
        f"{again['ssim']:.4f} lpips {again.get('lpips', 'absent')}")
    import math
    if not math.isfinite(metrics.get("lpips", math.nan)):
        raise AssertionError(f"cli: --eval_lpips gave {metrics}")
    if not metrics["psnr"] >= JAX_CLI_PSNR - CLI_PSNR_SLACK:
        raise AssertionError(f"cli: test psnr {metrics['psnr']} more than "
                             f"{CLI_PSNR_SLACK} dB under {JAX_CLI_PSNR}")
    for k in ("psnr", "ssim", "lpips"):
        if not abs(again[k] - metrics[k]) <= 1e-6:
            raise AssertionError(f"cli: the reloaded checkpoint gives {k} "
                                 f"{again[k]}, the run {metrics[k]}")
    check_hash_encode(model_config_from_hparams(h).density_grid_cfg,
                      table.T.contiguous())
    return launches


class ChunkIndex:
    """While active, `index` is the stream chunk (0, 1, ...) that the
    stream encoder is reducing, -1 outside an encoder call."""

    def __enter__(self):
        from ingp_tpu_torch.ops import streambrick as sb
        self.sb, self.stream, self.chunk = (sb, sb._stream,
                                            sb._encode_chunk_stream)
        self.index = -1

        def stream(*a, **k):
            self.index = -1
            try:
                return self.stream(*a, **k)
            finally:
                self.index = -1

        def chunk(*a, **k):
            self.index += 1
            return self.chunk(*a, **k)
        sb._stream, sb._encode_chunk_stream = stream, chunk
        return self

    def __exit__(self, *exc):
        self.sb._stream, self.sb._encode_chunk_stream = (self.stream,
                                                         self.chunk)


class PriorFlag:
    """While active, `on` is true inside the trainer's sparsity-prior
    density call (`ngp_sigma`)."""

    def __enter__(self):
        from ingp_tpu_torch.training import trainer
        self.mod, self.fn, self.on = trainer, trainer.ngp_sigma, False

        def sigma(*a, **k):
            self.on = True
            try:
                return self.fn(*a, **k)
            finally:
                self.on = False
        trainer.ngp_sigma = sigma
        return self

    def __exit__(self, *exc):
        self.mod.ngp_sigma = self.fn


def record_quality(cfg, chunks, prior):
    """Recorders of the gate's new launches: K2 forward and backward of
    the sparsity prior, and K1 forward and backward of the second stream
    chunk (the backward ones told apart by the row ids they share with
    their forward launch)."""
    from ingp_tpu_torch.kernels import brickreduce as k2
    from ingp_tpu_torch.kernels import rayreduce as k1
    table = table_namer(cfg)
    ids = {"k1": set(), "k2": set()}

    def k1_fwd(a):
        if chunks.index != 1:
            return None
        ids["k1"].add(a["uid"].data_ptr())
        return f"{table(a['table'], a['with_jac'])}, chunk 2"

    def k2_fwd(a):
        if not prior.on:
            return None
        ids["k2"].add(a["rows"].data_ptr())
        return f"{table(a['table'], a['with_jac'])}, sparsity prior"

    def k1_bwd(a):
        if a["uid"].data_ptr() not in ids["k1"]:
            return None
        return f"{table(a['grad'], a['djac'] is not None)}, chunk 2"

    def k2_bwd(a):
        if a["rows"].data_ptr() not in ids["k2"]:
            return None
        return f"{table(a['grad'], a['djac'] is not None)}, sparsity prior"

    return {"fused_ray_reduce": Recorder(k1, "fused_ray_reduce", k1_fwd),
            "brick_reduce": Recorder(k2, "brick_reduce", k2_fwd),
            "fused_ray_reduce_bwd": Recorder(k1, "fused_ray_reduce_bwd",
                                             k1_bwd),
            "brick_reduce_bwd": Recorder(k2, "brick_reduce_bwd", k2_bwd)}


def phase_quality():
    """The port's quality gate (`ingp_tpu_torch.quality_synthetic` at its
    defaults: 600 steps of 8192 rays, two stream chunks, the sparsity
    prior) with the launch counts set to 0 before it; a miss of its bar
    fails the run. The first step's K2 forward and backward launches of
    the prior and K1 forward and backward launches of the second stream
    chunk are held against their plain versions on the CPU, with times
    and bounds, as phase "train" does. Returns ({kernel: {variant:
    numbers}}, launch counts)."""
    import torch
    from ingp_tpu_torch import quality_synthetic as gate
    from ingp_tpu_torch.training.trainer import model_config_from_hparams
    cfg = model_config_from_hparams(gate.gate_hparams(
        gate.build_parser().parse_args([])))
    recs = {}

    def on_step(step, aux):
        if step == 0:
            for r in recs.values():
                r.restore()
            prior_ctx.__exit__()
            chunk_ctx.__exit__()

    t = time.time()
    clear_counts()
    chunk_ctx, prior_ctx = ChunkIndex(), PriorFlag()
    recs = record_quality(cfg, chunk_ctx.__enter__(), prior_ctx.__enter__())
    try:
        metrics = gate.run([], device=DEVICE, on_step=on_step)
    finally:
        for r in recs.values():
            r.restore()
        prior_ctx.__exit__()
        chunk_ctx.__exit__()
    torch.cuda.synchronize()
    launches = launch_counts()
    log(f"quality: {len(metrics['losses'])} steps in "
        f"{metrics['train_s']:.2f} s ({metrics['rays_per_s']:.1f} training "
        f"rays/s incl. host), whole phase {time.time() - t:.2f} s; launches "
        f"{ {k: n for k, n in launches.items() if k in KERNELS} }")
    check_launched({k: launches[k] for k in KERNELS}, "the quality gate")
    check_falling(metrics["losses"], 50, "quality")
    checks = {}
    with torch.no_grad():
        for name, r in recs.items():
            if not r.calls:
                raise AssertionError(f"quality: no {name} launch recorded")
            checks[name] = {f"quality, {tag}":
                            CHECKS[name](a, f"quality step 0, {tag}")
                            for tag, (a, _) in r.calls.items()}
    del recs
    if not gate.passes(metrics):
        raise AssertionError(f"quality gate missed: psnr {metrics['psnr']} "
                             f"(bar {gate.PSNR_BAR}), ssim "
                             f"{metrics['ssim']} (bar {gate.SSIM_BAR})")
    log(f"quality: novel-view psnr {metrics['psnr']:.4f} >= "
        f"{gate.PSNR_BAR}, ssim {metrics['ssim']:.4f} >= {gate.SSIM_BAR}")
    return checks, launches


# phase "data": configs/lego.txt from disk at its full width on an NSVF
# fixture of the sphere scene (DATA_VIEWS train and test views of 800 px,
# as Synthetic-NeRF's), DATA_STEPS steps (the test PSNR must clear the
# constant image's by DATA_PSNR_MARGIN; on the native sampler's stream
# 500 steps clear it by 5.79 dB and 800 by 6.12 on an H100, PERF.md;
# 500 leave the run's time limit room); the same with the bench's brick model
# (BRICK_FLAGS) for DATA_BRICK_STEPS steps, whose kernels are checked at
# lego's batch; configs/Playground.txt on a small TNT fixture
LEGO_CONFIG = "configs/lego.txt"
PLAYGROUND_CONFIG = "configs/Playground.txt"
DATA_VIEWS = (100, 4)
DATA_STEPS, DATA_BRICK_STEPS, TNT_STEPS = 500, 20, 20
BRICK_FLAGS = ["--encoder", "brick", "--stream_dedup", "--compute_dtype",
               "bfloat16", "--table_dtype", "bfloat16", "--capacity", "48",
               "--samples_per_ray", "24"]
# the test PSNR must clear a constant image at the test set's mean colour
# by this much: a transposed image or a wrong pose convention trains
# toward that constant
DATA_PSNR_MARGIN = 5.0


class Patch:
    """While active, owner.name is replaced by the subclass's `call`,
    which reaches the original as self.fn (a plain function is set, so
    that a method still receives its instance)."""

    def __init__(self, owner, name):
        self.owner, self.name = owner, name

    def __enter__(self):
        self.fn = getattr(self.owner, self.name)
        patch = self

        def call(*a, **k):
            return patch.call(*a, **k)
        setattr(self.owner, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.fn)


class Clock(Patch):
    """While active, times every call of owner.name: calls and seconds
    in all, and with key(arguments) the seconds by key; with sync, each
    call ends with a synchronize, so that its time is the card's."""

    def __init__(self, owner, name, key=None, sync=False):
        super().__init__(owner, name)
        self.key, self.sync = key, sync
        self.calls, self.seconds, self.by_key = 0, 0.0, {}

    def call(self, *a, **k):
        t = time.perf_counter()
        try:
            out = self.fn(*a, **k)
            if self.sync:
                import torch
                torch.cuda.synchronize()
            return out
        finally:
            dt = time.perf_counter() - t
            self.calls += 1
            self.seconds += dt
            if self.key is not None:
                key = self.key(*a, **k)
                self.by_key[key] = self.by_key.get(key, 0.0) + dt

    def ms_per_call(self) -> float:
        return self.seconds / max(self.calls, 1) * 1e3


class Span(Patch):
    """While active, each call of owner.name starts with the launch
    counts at 0 and keeps, at its end (after a synchronize), its launch
    counts, its seconds and its result (for `NeRFSystem.fit`: the
    system)."""

    def call(self, *a, **k):
        import torch
        torch.cuda.synchronize()
        clear_counts()
        t = time.perf_counter()
        self.result = self.fn(*a, **k)
        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - t
        self.launches = launch_counts()
        return self.result


def const_psnr(ds):
    """Mean PSNR over the views of ds of the constant image at the mean
    colour of all of them."""
    import numpy as np
    rgb = ds.rays[..., :3]
    mse = ((rgb - rgb.reshape(-1, 3).mean(0)) ** 2).mean(axis=(1, 2))
    return float(np.mean(-10 * np.log10(mse)))


def train_from_disk(what, argv, steps, falling=True):
    """`ingp_tpu_torch.train.main(argv)` in the current directory with the
    launch counts, step times, losses, peak memory and the system of its
    fit; its losses must be finite and, with falling, fall. Returns
    (test metrics, the fit's span)."""
    import math
    import torch
    from ingp_tpu_torch import train as train_cli
    from ingp_tpu_torch.training.trainer import NeRFSystem
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    with Span(NeRFSystem, "fit") as span, StepLog() as log_:
        metrics = train_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if len(log_.losses) != steps:
        raise AssertionError(f"{what}: {len(log_.losses)} steps, expected "
                             f"{steps}")
    per_step = {k: span.launches[k] / steps for k in KERNELS}
    h = span.result.hparams
    log(f"{what}: {steps} steps x {h.batch_size} rays of "
        f"{span.result.train_dataset.img_wh} images, encoder {h.encoder}: "
        f"{log_.step_ms():.2f} ms/step (median host time between steps), "
        f"{h.batch_size / log_.step_ms() * 1e3:.1f} training rays/s, peak "
        f"{peak:.2f} GiB, {wall:.2f} s with set-up and validation; "
        f"launches per step {per_step}")
    if falling:
        check_falling(log_.losses, min(20, max(steps // 4, 1)), what)
    elif not all(math.isfinite(float(v)) for v in log_.losses):
        raise AssertionError(f"{what}: non-finite training loss")
    log(f"{what}: test/psnr {metrics['psnr']:.4f} test/ssim "
        f"{metrics['ssim']:.4f}")
    return metrics, span


def data_brick(argv, tr, te, what="data"):
    """The config of argv (lego's in phase "data", mega's in phase
    "mega": `what`) with the bench's brick model (BRICK_FLAGS) on the
    loaded datasets tr and te: DATA_BRICK_STEPS steps of the config's
    batch, the first recording its kernel variants, the launch
    counts of the others per step; then each recorded variant held
    against its plain version on the CPU with its times, as in phase
    "train"; the losses must be finite. Returns {kernel: {variant:
    numbers}}, and the system."""
    import math
    import numpy as np
    import torch
    from ingp_tpu_torch.training.config import get_opts
    from ingp_tpu_torch.training.trainer import NeRFSystem
    h = get_opts(argv + BRICK_FLAGS)
    system = NeRFSystem(h, tr, te, device=DEVICE)
    recs = record_kernels(system.model_cfg, KERNELS)
    rng = np.random.default_rng(h.seed)
    try:
        losses = [system.training_step(tr.sample_batch(rng))["loss"]]
    finally:
        for r in recs.values():
            r.restore()
    torch.cuda.synchronize()
    clear_counts()
    t = time.time()
    for _ in range(DATA_BRICK_STEPS - 1):
        losses.append(system.training_step(tr.sample_batch(rng))["loss"])
    torch.cuda.synchronize()
    n = DATA_BRICK_STEPS - 1
    step_ms = (time.time() - t) / n * 1e3
    launches = launch_counts()
    log(f"{what} brick: {n} steps x {h.batch_size} rays after the first, "
        f"encoder {h.encoder}, encode_chunk "
        f"{system.model_cfg.encode_chunk}: {step_ms:.2f} ms/step with "
        f"host sampling, {h.batch_size / step_ms * 1e3:.1f} training "
        f"rays/s; launches per step "
        f"{ {k: launches[k] / n for k in KERNELS} }")
    check_launched({k: launches[k] for k in KERNELS},
                   f"the {what} brick steps")
    losses = [float(v) for v in losses]
    log(f"{what} brick: loss first step {losses[0]:.6f}, last "
        f"{losses[-1]:.6f}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{what} brick: non-finite training loss")
    with torch.no_grad():
        return {name: {f"{what}, {tag}": CHECKS[name](a, f"{what}, {tag}")
                       for tag, (a, _) in r.calls.items()}
                for name, r in recs.items()}, system


def phase_data():
    """configs/lego.txt from disk through `ingp_tpu_torch.train.main`, in a
    temporary working directory: an NSVF Synthetic-NeRF fixture of the
    sphere scene under .../Synthetic_NeRF/Lego (DATA_VIEWS 800 px RGBA
    views, Paeth-filtered rows, written by the port's own writer in one
    process per CPU); the train split's load seconds and the ms per
    image spent decoding and unfiltering; DATA_STEPS steps of lego's
    16,384 rays (the config's hash encoder: only K3 of the kernels),
    median ms per step, rays/s, peak memory, launches per step; the
    losses finite and falling, the test PSNR at least DATA_PSNR_MARGIN dB
    above the constant image's; `_dump_val_images` once, every PNG it
    wrote read back. Then lego.txt with the bench's brick model on the
    loaded datasets (`data_brick`): K1, K2 and K3 forward and backward
    at lego's batch. Then configs/Playground.txt (tnt, appearance
    codes, the transient mask, the random background) on a small TNT
    fixture for TNT_STEPS steps, through `train.main` to its end-of-run
    render of the camera path. Then phase "offline" (`phase_offline`) in
    the same directory, on lego's checkpoint, the brick system and the
    TNT system. Returns ({kernel: {variant: numbers}} of phase "data",
    the same of phase "offline")."""
    import os
    import tempfile
    import torch
    from ingp_tpu_torch import train as train_cli
    from ingp_tpu_torch.data import color_utils, image_io
    from ingp_tpu_torch.data.nsvf import NSVFDataset
    from ingp_tpu_torch.utils.blender_fixture import (write_nsvf_scene,
                                                      write_tnt_scene)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="ingp_data_") as tmp:
        os.chdir(tmp)
        try:
            root = os.path.join(tmp, "Synthetic_NeRF", "Lego")
            t = time.time()
            n_train, n_test = DATA_VIEWS
            write_nsvf_scene(root, 800, n_train, n_test)
            log(f"data: wrote the NSVF fixture ({n_train} + {n_test} "
                f"views of 800x800 RGBA, Paeth rows) in "
                f"{time.time() - t:.2f} s with {os.cpu_count()} processes")

            def lego(steps, *flags):
                return ["--config", _repo_file(LEGO_CONFIG), "--root_dir",
                        root, "--num_epochs", "1", "--steps_per_epoch",
                        str(steps), "--no_save_test", *flags]
            with Clock(NSVFDataset, "read_meta",
                       key=lambda ds, split: split) as load, \
                    Clock(color_utils, "imread") as decode, \
                    Clock(image_io, "unfilter") as unfilter:
                metrics, span = train_from_disk("data", lego(DATA_STEPS),
                                                DATA_STEPS)
            log(f"data: load s by split {load.by_key}; per image "
                f"{decode.ms_per_call():.2f} ms decoding (imread, "
                f"{decode.calls} images) of which "
                f"{unfilter.ms_per_call():.2f} ms unfiltering (the g++ "
                f"helper)")
            check_launched({"composite": span.launches["composite"],
                            "composite_bwd": span.launches["composite_bwd"]},
                           "the lego run")
            system = span.result
            floor = const_psnr(system.test_dataset)
            log(f"data: test psnr {metrics['psnr']:.4f} against "
                f"{floor:.4f} for the constant image at the test views' "
                f"mean colour")
            if not metrics["psnr"] >= floor + DATA_PSNR_MARGIN:
                raise AssertionError(
                    f"data: test psnr {metrics['psnr']} is not "
                    f"{DATA_PSNR_MARGIN} dB above the constant image's "
                    f"{floor}")
            ckpt_dir = os.path.join(tmp, "ckpts", "nsvf", "lego")
            t = time.time()
            dump_step = system.global_step
            system._dump_val_images(ckpt_dir, dump_step)
            names = sorted(os.listdir(os.path.join(ckpt_dir, "val")))
            w, h = system.test_dataset.img_wh
            for name in names:
                img = image_io.read_png(os.path.join(ckpt_dir, "val", name))
                if img.shape != (h, w, 3):
                    raise AssertionError(f"data: {name} reads back as "
                                         f"{img.shape}")
            if len(names) != 4:
                raise AssertionError(f"data: the dump wrote {names}")
            log(f"data: _dump_val_images at step {system.global_step} "
                f"wrote {names} in {time.time() - t:.2f} s; each reads "
                f"back as {w}x{h} RGB")
            tr, te = system.train_dataset, system.test_dataset
            del span, system
            torch.cuda.empty_cache()
            checks, brick = data_brick(lego(DATA_STEPS), tr, te)
            del tr, te

            tnt = os.path.join(tmp, "TanksAndTempleBG", "Playground")
            write_tnt_scene(tnt)
            with Span(train_cli, "render_for_test") as traj_frames:
                _, span = train_from_disk("data tnt", [
                    "--config", _repo_file(PLAYGROUND_CONFIG), "--root_dir",
                    tnt, "--num_epochs", "1", "--steps_per_epoch",
                    str(TNT_STEPS)], TNT_STEPS, falling=False)
            h = span.result.hparams
            log(f"data tnt: {type(span.result.train_dataset).__name__}, "
                f"embed_a {h.embed_a}, embed_msk {h.embed_msk}, random_bg "
                f"{h.random_bg}, parameters {sorted(span.result.params)}")
            check_launched({"composite": span.launches["composite"],
                            "composite_bwd": span.launches["composite_bwd"]},
                           "the tnt run")
            dump_png = os.path.join(ckpt_dir, "val",
                                    f"{dump_step:05d}_rgb.png")
            lego_argv = ["--config", _repo_file(LEGO_CONFIG), "--root_dir",
                         root]
            offline_checks = phase_offline(brick, lego_argv, dump_png, span,
                                           traj_frames)
        finally:
            os.chdir(cwd)
    return checks, offline_checks


# phase "kitti": configs/kitti360_nvs_1538.txt from a KITTI-360 fixture at
# the dataset's own image size, pose refinement on the hash and the
# stream-brick encoders (the K2 backward's position-cotangent variant),
# and a highbay fixture
KITTI_CONFIG = "configs/kitti360_nvs_1538.txt"
KITTI_FRAMES = (1538, 1554)   # the window's 16 frames (the config's 64)
KITTI_TEST_ID = 1545          # one test frame (the config's 5)
# the config's run loads the 1408x376 frames at downsample 0.5 (the uint8
# resize) and takes 50 steps: the grid's warmup sweeps (every 16 steps,
# 4 cascades of 128^3 cells through the plain hash encoder) and the
# validation and render of the test views take most of its time (PERF.md
# §5); 48 steps hold 3 sweeps (20 were too few for its loss to fall),
# which leaves the run's time limit room
KITTI_DOWNSAMPLE = 0.5
# EXT_STEPS: the grid's second warmup sweep comes at step 16, outside
KITTI_STEPS, EXT_STEPS, HIGHBAY_STEPS = 48, 16, 10
HIGHBAY_WH = (160, 100)       # 2 valid stereo frames of 4
# the K2 backward's position-cotangent variant (the table gradient and
# the sample positions' cotangent in one launch): its kernels line row
POS_KERNEL = ("brick_reduce_bwd_and_pos", "ingp_brick_reduce_bwd_and_pos",
              "ingp_tpu_torch/kernels/csrc/brickreduce.cu",
              "ingp_tpu/ops/pallas/brickreduce_pallas.py:224")
# rounds of the in-turn graph timing of the variant beside row 4 alone
POS_ROUNDS = 3


def kitti_config_copy(path):
    """configs/kitti360_nvs_1538.txt without its depth_mono line, written
    to path: neither the port's nor JAX's kitti loader reads a mono depth,
    and JAX's step fails on the key (the port refuses it)."""
    with open(_repo_file(KITTI_CONFIG)) as f:
        lines = [ln for ln in f if not ln.startswith("depth_mono")]
    with open(path, "w") as f:
        f.write("".join(lines))
    return path


def _bwd_and_pos_plain(b):
    """The variant's plain version on arguments b: (the table gradient
    of brick_reduce_bwd_plain, dpos of brick_reduce_bwd_pos_plain)."""
    from ingp_tpu_torch.kernels import brickreduce as k2
    args = (b["rows"], b["lf"], b["dfeats"], b["djac"], b["F"],
            b["jac_lo"], b["jac_hi"])
    grad = k2.brick_reduce_bwd_plain(b["grad"], *args, bf16=b["bf16"])
    return grad, k2.brick_reduce_bwd_pos_plain(b["storage"], *args)


def check_k2_bwd_and_pos(a, tag):
    """The K2 backward's position-cotangent variant on captured arguments
    a, against both plain versions on the CPU: dpos to 1e-5 of its
    largest |value| (+1e-12), the table gradient to K2 backward's
    tolerance (1e-5 of its largest |value| + 1e-12: the atomics add in
    any order); dpos exact zeros on every cell that is not live (all-zero
    cotangents, -9, a row outside the table), on the recorded inputs and
    with all three marks written into a copy. Then, from CUDA graphs in
    POS_ROUNDS rounds of turns, row 4 alone (`brick_reduce_bwd`, the POS
    = false launch) and the variant on the same inputs, each into one
    reused gradient: the difference is the position cotangent's added
    cost, beside its bound (the corner points of the live cells, read
    from the storage table, and 12 bytes of dpos a cell). The row's bound
    is row 4's bound plus that."""
    import torch
    from ingp_tpu_torch.kernels import brickreduce as k2
    from ingp_tpu_torch.probes.common import graph_ms
    storage, rws, lf, F, dj = (a["storage"], a["rows"], a["lf"], a["F"],
                               a["djac"])
    Lw, Nn = rws.shape
    Fj = 0 if dj is None else dj.shape[2] // Lw
    cells = Lw * Nn
    nbytes, flops = k2b_size(a, tag)
    ok, live = _k2b_cells(a)
    n_pts = _corner_points(rws, lf, live)
    add_bytes = n_pts * F * storage.element_size() + 12 * cells
    add_flops = int(live.sum()) * 8 * (2 * F + 6 * Fj + 24)
    log(f"kernel {POS_KERNEL[0]} [{tag}]: storage {tuple(storage.shape)} "
        f"{storage.dtype}, rows {tuple(rws.shape)}, jacobian cotangent "
        f"{dj is not None}; {int(live.sum())} live cells read {n_pts} "
        f"(row, point) pairs of the storage; {int((ok & ~live).sum())} "
        f"cells with all-zero cotangents and {int((~ok).sum())} marked -9 "
        f"or outside the table write exact zeros")
    refs = {}

    def plain(dev):
        refs[str(dev)] = _bwd_and_pos_plain(_zero_grad(a, dev))
        return refs[str(dev)]

    def run(b):
        return b["grad"], k2.brick_reduce_bwd_and_pos(**b)
    grad = _zero_grad(a, DEVICE)
    res = compare(POS_KERNEL[0], tag, lambda: run(_zero_grad(a, DEVICE)),
                  plain, lambda o: ([o[1]], []), nbytes + add_bytes,
                  flops + add_flops, "cpu", 1e-12,
                  lambda: k2.brick_reduce_bwd_and_pos(**grad))
    out_g, out_p = to_dev(run(_zero_grad(a, DEVICE)), "cpu")
    ref_g, ref_p = refs["cpu"]
    err, scale = max_err([out_g], [ref_g])
    if not err <= 1e-5 * scale + 1e-12:
        raise AssertionError(f"{POS_KERNEL[0]} [{tag}]: the table gradient "
                             f"disagrees with brick_reduce_bwd_plain")
    dead = ~live.reshape(Lw, Nn).cpu()
    if bool(out_p[:, dead].any()) or bool(ref_p[:, dead].any()):
        raise AssertionError(f"{POS_KERNEL[0]} [{tag}]: dpos not zero on "
                             f"cells that are not live")
    log(f"kernel {POS_KERNEL[0]} [{tag}]: table gradient max_abs_err "
        f"{err:.3e} (max |plain| {scale:.3e}); dpos exact zeros on the "
        f"{int(dead.sum())} cells that are not live (kernel and plain)")
    # the three marks in a copy: -9 on every 7th cell, a row outside the
    # table on every 11th from the 3rd, zero cotangents on every 5th
    lfm, rwm = lf.clone(), rws.clone()
    lfm[0:3].reshape(3, -1)[:, ::7] = -9.0
    rwm.view(-1)[3::11] = storage.shape[0] + 3
    quiet = torch.zeros(cells, dtype=torch.bool, device=lf.device)
    quiet[::5] = True
    keep = ~quiet.reshape(Lw, Nn).T                       # (N, Lw)
    marked = {**a, "lf": lfm, "rows": rwm,
              "dfeats": a["dfeats"] * keep.repeat_interleave(F, 1),
              "djac": None if dj is None else
              dj * keep.repeat_interleave(Fj, 1)}
    for who, (_, p) in (("kernel", run(_zero_grad(marked, DEVICE))),
                        ("plain", _bwd_and_pos_plain(
                            _zero_grad(marked, DEVICE)))):
        p = p.reshape(3, -1)
        for what, idx in (("-9", slice(0, None, 7)),
                          ("outside the table", slice(3, None, 11)),
                          ("zero cotangents", slice(0, None, 5))):
            if bool(p[:, idx].any()):
                raise AssertionError(f"{POS_KERNEL[0]} [{tag}]: {who} dpos "
                                     f"not zero on cells marked {what}")
    log(f"kernel {POS_KERNEL[0]} [{tag}]: -9, rows outside the table and "
        f"zero cotangents written into every 7th, 11th and 5th cell: dpos "
        f"exact zeros there (kernel and plain)")
    # row 4 alone and the variant from CUDA graphs, in turns
    bwd = {k: grad[k] for k in ("grad", "rows", "lf", "dfeats", "djac", "F",
                                "jac_lo", "jac_hi", "bf16")}
    fns = {"row 4": lambda: k2.brick_reduce_bwd(**bwd),
           "variant": lambda: k2.brick_reduce_bwd_and_pos(**grad)}
    times = {k: [] for k in fns}
    for i in range(POS_ROUNDS):
        for k in (fns if i % 2 == 0 else reversed(list(fns))):
            times[k].append(graph_ms(fns[k]))
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    add_bound, add_by = bound_of(add_bytes, add_flops)
    res.update(row4_graph_ms=med["row 4"], variant_graph_ms=med["variant"],
               added_ms=med["variant"] - med["row 4"],
               added_bound_ms=add_bound)
    log(f"kernel {POS_KERNEL[0]} [{tag}]: from CUDA graphs in {POS_ROUNDS} "
        f"rounds of turns, the variant {med['variant']:.4f} ms, row 4 alone "
        f"{med['row 4']:.4f} ms: the position cotangent adds "
        f"{res['added_ms']:.4f} ms against its bound {add_bound:.4f} ms "
        f"({add_by}: {n_pts} live corner points x {F} x "
        f"{storage.element_size()} B + 12 B x {cells} cells = "
        f"{add_bytes / 1e6:.3f} MB); rounds {times}")
    return res


def ext_norms(system):
    import torch
    return {k: float(torch.linalg.norm(v.detach())) for k, v in
            system.params["ext"].items()}


def ext_steps(what, h, tr, te, steps, record=None):
    """`steps` training steps of NeRFSystem(h) on the loaded datasets,
    the launch counts set to 0 after the first (whose position-cotangent
    launches, with record, are kept): losses, ms per step, launches per
    step and the pose corrections' norms. Returns (system, launches,
    step ms, recorder)."""
    import math
    import numpy as np
    import torch
    from ingp_tpu_torch.kernels import brickreduce as k2
    from ingp_tpu_torch.kernels import build
    from ingp_tpu_torch.training.trainer import NeRFSystem
    system = NeRFSystem(h, tr, te, device=DEVICE)
    rng = np.random.default_rng(h.seed)
    rec = None
    if record:
        table = table_namer(system.model_cfg)
        rec = Recorder(k2, "brick_reduce_bwd_and_pos",
                       lambda a: table(a["storage"], a["djac"] is not None))
    try:
        losses = [system.training_step(tr.sample_batch(rng))["loss"]]
    finally:
        if rec is not None:
            rec.restore()
    torch.cuda.synchronize()
    clear_counts()
    t = time.time()
    for _ in range(steps - 1):
        losses.append(system.training_step(tr.sample_batch(rng))["loss"])
    torch.cuda.synchronize()
    n = steps - 1
    step_ms = (time.time() - t) / n * 1e3
    launches = {**launch_counts(),
                POS_KERNEL[0]: build.LAUNCHES[POS_KERNEL[1]]}
    losses = [float(v) for v in losses]
    log(f"{what}: {n} steps x {h.batch_size} rays after the first, encoder "
        f"{h.encoder}, stream_dedup {h.stream_dedup}, optimize_ext "
        f"{h.optimize_ext}: {step_ms:.2f} ms/step with host sampling; "
        f"launches per step "
        f"{ {k: v / n for k, v in launches.items() if v} }; loss first "
        f"{losses[0]:.6f}, last {losses[-1]:.6f}, mean of the last 5 "
        f"{np.mean(losses[-5:]):.6f}"
        + (f"; |ext| {ext_norms(system)}" if h.optimize_ext else ""))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{what}: non-finite training loss")
    return system, launches, step_ms, rec


def ext_reference_step(kitti_root, argv):
    """One small f32 step with pose refinement on the kitti fixture (at
    downsample 0.125) on the card and on the CPU from the same
    parameters, batch and noise, on the stream-brick encoder: the loss to
    rtol 1e-5 and each gradient leaf, ext's dR and dT included, to 1e-4
    of its largest |value| (norm_net's to 1e-3, as `reference_step`).
    The tables are scaled per level, coarse to fine 1e4 to 10: a smooth
    field (tests/test_torch_pose_refine.py)."""
    import numpy as np
    import torch
    from ingp_tpu_torch.data import dataset_dict
    from ingp_tpu_torch.training.config import get_opts
    from ingp_tpu_torch.training.trainer import NeRFSystem
    h = get_opts(argv + ["--optimize_ext", "--encoder", "brick",
                         "--stream_dedup", "--scale", "2.0",
                         "--batch_size", "512", "--samples_per_ray", "16",
                         "--capacity", "48", "--march_iters", "256",
                         "--grid_size", "32", "--density_L", "4",
                         "--rgb_L", "4", "--density_log2T", "12",
                         "--rgb_log2T", "12"])
    h.encode_chunk = 4096
    kw = dict(root_dir=kitti_root, downsample=0.125, seq_id=h.kitti_seq,
              frame_start=h.kitti_start, frame_end=h.kitti_end,
              test_id=h.kitti_test_id, nvs=h.nvs)
    tr = dataset_dict["kitti"](split="train", **kw)
    gpu = NeRFSystem(h, tr, device=DEVICE, seed=3)
    cfg = gpu.model_cfg
    with torch.no_grad():
        for name, base in (("density", 1.0), ("rgb", 0.1)):
            gc = getattr(cfg, f"{name}_brick_cfg")
            tab = gpu.params["model"][f"{name}_table"]
            ends = list(gc.offsets[1:]) + [tab.shape[0]]
            for lvl, (lo, hi) in enumerate(zip(gc.offsets, ends)):
                tab[lo:hi] *= base * 10.0 ** (4 - lvl)
    cpu = NeRFSystem(h, tr, device="cpu", seed=3,
                     params=gpu.params_to_numpy())
    set_sphere_grid(gpu)
    set_sphere_grid(cpu)
    rng = np.random.default_rng(5)
    batch = tr.sample_batch(rng, 512)
    _, grads = hold_step(f"kitti ext reference ({tr.n_images} views of "
                         f"{tr.img_wh})", gpu, cpu, batch,
                         rng.random(512, dtype=np.float32))
    dr, dt = (float(grads["ext"][k].abs().max()) for k in ("dR", "dT"))
    log(f"kitti ext reference: largest |ext gradient| dR {dr:.4e}, dT "
        f"{dt:.4e}")
    if not (dr > 0 and dt > 0):
        raise AssertionError("kitti ext reference: no gradient reached ext")


def phase_kitti():
    """The KITTI-360 and highbay loaders and pose refinement, in a
    temporary working directory: a KITTI-360 fixture at the dataset's
    image size (1408x376, both rectified cameras, KITTI_FRAMES' 16 frames
    with OXTS, semantics and .npy normals; the port's own writer);
    configs/kitti360_nvs_1538.txt (less its depth_mono line) through
    `train.main` for KITTI_STEPS steps with its window cut to the
    fixture's frames and one test frame, the frames loaded at
    KITTI_DOWNSAMPLE, to its end-of-run render of the test views; on the
    loaded datasets, EXT_STEPS steps with
    --optimize_ext on the config's hash encoder and on the stream-brick
    encoder of the bench (whose first step's position-cotangent launches
    are held against their plain version on the CPU), and 4 stream-brick
    steps without it (no position-cotangent launch); one small step with
    pose refinement, card against CPU; then a highbay fixture through
    `train.main` for HIGHBAY_STEPS steps. Returns ({kernel: {variant:
    numbers}}, the position-cotangent kernel's launches and launches per
    step in the stream-brick pose-refinement run)."""
    import os
    import tempfile
    import torch
    from ingp_tpu_torch import train as train_cli
    from ingp_tpu_torch.data import image_io
    from ingp_tpu_torch.training.config import get_opts
    from ingp_tpu_torch.utils.street_fixture import (write_highbay_scene,
                                                     write_kitti_scene)
    t_phase = time.time()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="ingp_kitti_") as tmp:
        os.chdir(tmp)
        try:
            root = os.path.join(tmp, "KITTI-360")
            t = time.time()
            write_kitti_scene(root, frames=range(*KITTI_FRAMES))
            log(f"kitti: wrote the KITTI-360 fixture (frames "
                f"{KITTI_FRAMES[0]}-{KITTI_FRAMES[1] - 1}, 2 cameras of "
                f"1408x376, semantics, normals, OXTS) in "
                f"{time.time() - t:.2f} s")
            argv = ["--config", kitti_config_copy(
                        os.path.join(tmp, "kitti360_nvs_1538.txt")),
                    "--root_dir", root, "--kitti_start",
                    str(KITTI_FRAMES[0]), "--kitti_end",
                    str(KITTI_FRAMES[1] - 1), "--kitti_test_id",
                    str(KITTI_TEST_ID)]
            argv += ["--downsample", str(KITTI_DOWNSAMPLE)]
            metrics, span = train_from_disk("kitti", argv + [
                "--num_epochs", "1", "--normal_epochs", "0",
                "--steps_per_epoch", str(KITTI_STEPS)], KITTI_STEPS)
            system = span.result
            tr, te = system.train_dataset, system.test_dataset
            out = os.path.join(tmp, "results", "kitti", "kitti360_nvs_1538")
            names = sorted(os.listdir(out))
            w, h = te.img_wh
            for name in names:
                if name.endswith(".png"):
                    img = image_io.read_png(os.path.join(out, name))
                    if img.shape[:2] != (h, w):
                        raise AssertionError(f"kitti: {name} reads back as "
                                             f"{img.shape}")
            if not any(n.endswith("_semantic.png") for n in names):
                raise AssertionError(f"kitti: the render wrote {names}")
            log(f"kitti: {type(tr).__name__} train {tr.n_images} views, "
                f"test {te.n_images}; sun_dir {tr.sun_dir.tolist()}; the "
                f"end-of-run render wrote {names}, each {w}x{h}")
            check_launched({"composite": span.launches["composite"],
                            "composite_bwd": span.launches["composite_bwd"]},
                           "the kitti run")
            del span, system
            torch.cuda.empty_cache()

            h = get_opts(argv + ["--optimize_ext"])
            system, _, _, _ = ext_steps("kitti ext hash", h, tr, te,
                                        EXT_STEPS)
            if not all(v > 0 for v in ext_norms(system).values()):
                raise AssertionError("kitti ext hash: the poses did not "
                                     "move")
            del system
            h = get_opts(argv + BRICK_FLAGS + ["--optimize_ext"])
            system, launches, step_ms, rec = ext_steps(
                "kitti ext brick", h, tr, te, EXT_STEPS, record=True)
            if not all(v > 0 for v in ext_norms(system).values()):
                raise AssertionError("kitti ext brick: the poses did not "
                                     "move")
            check_launched({k: launches[k] for k in
                            ("fused_ray_reduce", "brick_reduce",
                             "fused_ray_reduce_bwd", POS_KERNEL[0])},
                           "the kitti ext brick steps")
            if launches["brick_reduce_bwd"]:
                raise AssertionError(f"kitti ext brick: row 4 launched "
                                     f"without the position cotangent: "
                                     f"launches {launches}")
            pos_launches = launches[POS_KERNEL[0]]
            del system
            with torch.no_grad():
                checks = {POS_KERNEL[0]: {
                    f"kitti ext, {tag}": check_k2_bwd_and_pos(a, f"kitti ext, "
                                                          f"{tag}")
                    for tag, (a, _) in rec.calls.items()}}
            del rec
            torch.cuda.empty_cache()
            _, plain_launches, _, _ = ext_steps(
                "kitti brick", get_opts(argv + BRICK_FLAGS), tr, te, 4)
            if plain_launches[POS_KERNEL[0]] or \
                    not plain_launches["brick_reduce_bwd"]:
                raise AssertionError(f"kitti brick without optimize_ext: "
                                     f"launches {plain_launches}")
            del tr, te
            torch.cuda.empty_cache()
            ext_reference_step(root, argv)

            hb = os.path.join(tmp, "highbay")
            t = time.time()
            write_highbay_scene(hb, img_wh=HIGHBAY_WH, n_images=4,
                                valid=(1, 2))
            log(f"kitti highbay: wrote the fixture ({HIGHBAY_WH}, 2 valid "
                f"stereo frames) in {time.time() - t:.2f} s")
            _, span = train_from_disk("kitti highbay", [
                "--dataset_name", "highbay", "--root_dir", hb, "--exp_name",
                "highbay", "--scale", "2.0", "--num_epochs", "1",
                "--normal_epochs", "0", "--steps_per_epoch",
                str(HIGHBAY_STEPS), "--batch_size",
                "4096", "--no_save_test"], HIGHBAY_STEPS, falling=False)
            log(f"kitti highbay: {type(span.result.train_dataset).__name__}"
                f", {span.result.train_dataset.n_images} views of "
                f"{span.result.train_dataset.img_wh}")
            del span
        finally:
            os.chdir(cwd)
    log(f"kitti: phase {time.time() - t_phase:.1f} s")
    return checks, (pos_launches, pos_launches / (EXT_STEPS - 1))


# phase "mega": Mega-NeRF's loader on a scene the port writes at Mill19's
# image size (baseline JPEGs through the port's own codec), trained at
# Mega-NeRF's Mill19 scale with the bench's stream-brick encoder, and the
# two out-of-memory ray stores
MEGA_WH = (4608, 3456)         # Mill19's frames (mega_fixture.MILL19_WH)
MEGA_FRAMES = (2, 1)           # train, val (cut for the run's time)
MEGA_DOWNSAMPLE = 0.25         # 1152x864, the scale Mega-NeRF trains at
MEGA_STEPS = 150
MEGA_QUALITY = 95
MEGA_PSNR = 35.0               # decoded full-size frame against its pixels
# small JPEGs (h, w) for the helper against the plain decoder: partial
# MCUs on both edges, one MCU, one pixel
MEGA_SMALL = ((37, 53), (17, 33), (16, 16), (1, 1))
# the test render's cut: the test split is the train frames at
# 1152x864, and after 300 steps the grid is still about half occupied (its
# refresh keeps max(0.95 x old, new) every 16 steps), so every ray fills
# its capacity; on an H100 (700 W) the validation and the end-of-run
# render took ~30 s a view at the bench's capacity 48 and 24 samples a
# ray, ~11 s at 16 and 8. These flags cut the samples a ray to 8 marched
# and 4 kept, in training and in the render alike
MEGA_CUT = ["--capacity", "8", "--samples_per_ray", "4"]
MEGA_CHUNKS = 8                # FilesystemDataset chunks
MEGA_FLUSH = 400_000           # rays a flush (3 flushes of one frame)
MEGA_BUDGET_S = 150.0


def mega_small_jpegs():
    """The JPEG helper built by g++ (timed), then write_jpeg's files at
    MEGA_SMALL sizes, 4:4:4 and 4:2:0, each decoded by the helper
    (read_jpeg_bytes) and by decode_jpeg_plain: they must be equal byte
    for byte. Returns the build's seconds."""
    import numpy as np
    from ingp_tpu_torch.data import image_io
    from ingp_tpu_torch.utils import mega_fixture
    t = time.time()
    image_io.build_helper("jpeg", force=True)
    build_s = time.time() - t
    pose = mega_fixture.scene_poses(3)[1]
    n = 0
    for h, w in MEGA_SMALL:
        img = mega_fixture.frame(pose, (w, h))
        for sub in ("4:4:4", "4:2:0"):
            data = image_io.encode_jpeg(img, MEGA_QUALITY, sub)
            got = image_io.read_jpeg_bytes(data)
            ref = image_io.decode_jpeg_plain(data)
            if got.shape != ref.shape or not np.array_equal(got, ref):
                raise AssertionError(f"mega: the JPEG helper's decode of a "
                                     f"{w}x{h} {sub} file differs from the "
                                     f"plain decoder's")
            n += 1
    log(f"mega: the JPEG helper (data/csrc/jpeg_decode.cpp) built by g++ "
        f"in {build_s:.2f} s; {n} small JPEGs ({MEGA_SMALL} h x w, "
        f"4:4:4 and 4:2:0, quality {MEGA_QUALITY}) decode equal to "
        f"decode_jpeg_plain")
    return build_s


def mega_stores(root, tmp):
    """FilesystemDataset (through load_filesystem_dataset: every 20th
    train frame, here the first, at MEGA_DOWNSAMPLE) and MemoryDataset on
    the same frame: write and load times; every ray stored once (the
    chunks' pixel indices are a permutation of the frame's); a store
    built again on the same directory reuses its chunks, and set_state
    returns to a chunk by name with the same rays."""
    import os
    from pathlib import Path
    import numpy as np
    from ingp_tpu_torch.data.mega import dataset as mds
    from ingp_tpu_torch.data.mega import filesystem_dataset as mfs
    from ingp_tpu_torch.data.mega.memory_dataset import MemoryDataset
    sf = int(1 / MEGA_DOWNSAMPLE)
    chunk_dir = os.path.join(tmp, "mega_chunks")
    kw = dict(near=1.0, far=1e5, chunk_paths=[chunk_dir],
              num_chunks=MEGA_CHUNKS, scale_factor=sf,
              disk_flush_size=MEGA_FLUSH)
    t = time.time()
    fs = mds.load_filesystem_dataset(root, **kw)
    write_s = time.time() - t
    t = time.time()
    rows, states, pix = 0, [], []
    for _ in range(MEGA_CHUNKS):
        fs.load_chunk()
        rows += len(fs)
        states.append(fs.get_state())
        pix.append(mfs.read_chunk(Path(fs.get_state()))["pixel_indices"])
    load_s = (time.time() - t) / MEGA_CHUNKS
    w, h = MEGA_WH[0] // sf, MEGA_WH[1] // sf
    if rows != w * h or not np.array_equal(np.sort(np.concatenate(pix)),
                                           np.arange(w * h)):
        raise AssertionError(f"mega stores: {rows} rays in the chunks, not "
                             f"each of the frame's {w * h} once")
    fs.set_state(states[2])
    third = fs._loaded_rays.copy()
    real = mfs.FilesystemDataset._write_chunks
    mfs.FilesystemDataset._write_chunks = None  # a rewrite would fail
    try:
        again = mds.load_filesystem_dataset(root, **kw)
    finally:
        mfs.FilesystemDataset._write_chunks = real
    again.load_chunk()
    again.set_state(states[2])
    if again.get_state() != states[2] or \
            not np.array_equal(again._loaded_rays, third):
        raise AssertionError("mega stores: the resumed store's chunk differs")
    items = mds.get_image_metadata(root, scale_factor=sf)[0]
    t = time.time()
    mem = MemoryDataset(items, fs._near, fs._far, None, True)
    mem_s = time.time() - t
    if len(mem) != rows:
        raise AssertionError(f"mega stores: MemoryDataset holds {len(mem)} "
                             f"rays, the chunks {rows}")
    batch = mem.sample_batch(np.random.default_rng(0), 4096)
    if not np.isfinite(batch["rays"]).all():
        raise AssertionError("mega stores: non-finite rays")
    log(f"mega stores: FilesystemDataset of {len(items)} frame at {w}x{h}: "
        f"{MEGA_CHUNKS} chunks (.npy columns, pixel indices) written in "
        f"{write_s:.2f} s (decode, Lanczos, {-(-rows // MEGA_FLUSH)} "
        f"flushes), {load_s * 1e3:.1f} ms a chunk to load (rays rebuilt); "
        f"{rows} rays, each once; reused and resumed at chunk "
        f"{os.path.basename(states[2])}; MemoryDataset in {mem_s:.2f} s")


def phase_mega():
    """Mega-NeRF on the card, in a temporary working directory: small
    JPEGs, the C++ helper against the plain decoder (`mega_small_jpegs`);
    a Mega-NeRF scene at Mill19's 4608x3456 (MEGA_FRAMES train and val
    frames, baseline JPEG at MEGA_QUALITY, 4:2:0, the port's own encoder)
    and one frame decoded at full size against its pixels (PSNR at least
    MEGA_PSNR); `train.main` with --dataset_name mega at MEGA_DOWNSAMPLE
    (the frames load at 1152x864 through the JPEG decoder and the
    Lanczos resize) and the bench's stream-brick encoder for MEGA_STEPS
    steps, its samples a ray cut by MEGA_CUT, its validation of the test
    split (the train frames) and its end-of-run render; the load's
    seconds split into decode and Lanczos;
    on the loaded datasets, the first step's K1-K3 launches against
    their plain versions (`data_brick`); then the ray stores
    (`mega_stores`). Returns {kernel: {variant: numbers}}."""
    import os
    import tempfile
    import numpy as np
    import torch
    from ingp_tpu_torch.data import image_io
    from ingp_tpu_torch.data.mega import dataset as mds
    from ingp_tpu_torch.data.mega import image_metadata
    from ingp_tpu_torch.utils import mega_fixture
    t_phase = time.time()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="ingp_mega_") as tmp:
        os.chdir(tmp)
        try:
            mega_small_jpegs()
            root = os.path.join(tmp, "mill19", "scene")
            t = time.time()
            info = mega_fixture.write_mega_scene(
                root, *MEGA_FRAMES, img_wh=MEGA_WH, quality=MEGA_QUALITY)
            log(f"mega: wrote the scene ({MEGA_FRAMES[0]} train + "
                f"{MEGA_FRAMES[1]} val frames of {MEGA_WH[0]}x{MEGA_WH[1]}, "
                f"JPEG quality {MEGA_QUALITY} 4:2:0) in "
                f"{time.time() - t:.2f} s with {os.cpu_count()} processes")
            path = os.path.join(root, "train", "rgbs", "000000.jpg")
            t = time.time()
            img = image_io.read_jpeg(path)
            dec_s = time.time() - t
            t = time.time()
            image_io.resize_lanczos(img, (int(MEGA_WH[0] * MEGA_DOWNSAMPLE),
                                          int(MEGA_WH[1] * MEGA_DOWNSAMPLE)))
            lz_s = time.time() - t
            ref = mega_fixture.frame(info["poses"][0], MEGA_WH)
            mse = float(((img.astype(np.float64) - ref) ** 2).mean())
            psnr = 10 * np.log10(255 ** 2 / max(mse, 1e-12))
            log(f"mega: one {MEGA_WH[0]}x{MEGA_WH[1]} frame "
                f"({os.path.getsize(path)} bytes): decode {dec_s * 1e3:.1f} "
                f"ms, Lanczos to 1/{int(1 / MEGA_DOWNSAMPLE)} "
                f"{lz_s * 1e3:.1f} ms; PSNR {psnr:.2f} dB against the "
                f"written pixels")
            if not psnr >= MEGA_PSNR:
                raise AssertionError(f"mega: the decoded frame is at {psnr} "
                                     f"dB, under {MEGA_PSNR}")
            del img, ref

            argv = ["--dataset_name", "mega", "--root_dir", root,
                    "--downsample", str(MEGA_DOWNSAMPLE), "--exp_name",
                    "mega", "--num_epochs", "1", "--normal_epochs", "0",
                    "--steps_per_epoch", str(MEGA_STEPS), "--render_rgb"]
            with Clock(mds.MegaDataset, "__init__",
                       key=lambda *a, **k: k.get("split")) as load, \
                    Clock(image_metadata, "read_rgb") as decode, \
                    Clock(image_metadata, "resize_lanczos") as lanczos:
                metrics, span = train_from_disk(
                    "mega", argv + BRICK_FLAGS + MEGA_CUT, MEGA_STEPS)
            log(f"mega: load s by split {load.by_key}; per frame "
                f"{decode.ms_per_call():.1f} ms decoding ({decode.calls} "
                f"frames) and {lanczos.ms_per_call():.1f} ms Lanczos")
            launches = {k: span.launches[k] / MEGA_STEPS for k in KERNELS}
            check_launched({k: span.launches[k] for k in KERNELS},
                           "the mega run")
            system = span.result
            tr, te = system.train_dataset, system.test_dataset
            w, h = tr.img_wh
            if (w, h) != tuple(int(v * MEGA_DOWNSAMPLE) for v in MEGA_WH) \
                    or tr.rays.shape[0] != MEGA_FRAMES[0]:
                raise AssertionError(f"mega: {tr.rays.shape[0]} frames of "
                                     f"{tr.img_wh}")
            out = os.path.join(tmp, "results", "mega", "mega")
            names = sorted(os.listdir(out))
            for name in names:
                shape = image_io.read_png(os.path.join(out, name)).shape
                if shape != (h, w, 3):
                    raise AssertionError(f"mega: {name} reads back as "
                                         f"{shape}")
            if len(names) != len(te.poses):
                raise AssertionError(f"mega: the render wrote {names}")
            floor = const_psnr(te)
            log(f"mega: K1-K3 launches per step {launches}; test psnr "
                f"{metrics['psnr']:.4f} against {floor:.4f} for the "
                f"constant image; the end-of-run render wrote {names}")
            del span, system
            torch.cuda.empty_cache()
            checks, _ = data_brick(argv, tr, te, what="mega")
            del tr, te
            torch.cuda.empty_cache()
            mega_stores(root, tmp)
        finally:
            os.chdir(cwd)
    took = time.time() - t_phase
    log(f"mega: phase {took:.1f} s (budget {MEGA_BUDGET_S:.0f} s)")
    return checks


def phase_probes():
    """Every variant of each probe kernel at the probe's full shapes,
    against its plain version on the card (`probes.common.measure`
    raises on a mismatch or when the check launched no kernel), timed
    beside its bound, its plain version (one run) and the library call.
    Returns ({kernels line name: {variant: numbers}}, {kernels line
    name: launches of the timed runs})."""
    import importlib
    import torch
    from ingp_tpu_torch.kernels import build
    from ingp_tpu_torch.probes import common
    from ingp_tpu_torch.probes import gather_layouts, kernel_split, vmem_gather
    out = {}
    checks = collections.Counter()
    floor = common.floor_ms()
    log(f"probes: launch floor {floor:.4f} ms (a one-element zero_() "
        f"replayed from a CUDA graph)")
    clear_counts()
    for name, (mod, _, _, _, primary) in PROBES.items():
        t = time.time()
        module = importlib.import_module(f"ingp_tpu_torch.probes.{mod}")
        kw = {}
        if module is kernel_split:
            kw["fwd_modes"] = list(kernel_split.FWD_MODES) + [
                m for m in kernel_split.ROWPAIR_MODES if m != "full"]
        cases = module.cases(torch.device(DEVICE), **kw)
        res = {}
        for c in cases:
            res[c.variant] = common.measure(c, PROBE_ITERS, plain_iters=1,
                                            floor=floor)
            checks[c.symbol] += res[c.variant]["check_launches"]
            log(f"probe {common.line(c, res[c.variant])}")
        if primary not in res:
            raise AssertionError(f"{name}: no variant {primary!r}")
        if module is kernel_split:
            for line in kernel_split.piece_shares(
                    {v: r["ms"] for v, r in res.items()}):
                log(f"probe {line}")
        if module is vmem_gather:
            floor_w = vmem_gather.write_floor(torch.device(DEVICE))
            for line in vmem_gather.floor_lines(
                    [(c, res[c.variant]) for c in cases], floor_w):
                log(f"probe {line}")
            res[primary]["write_floor"] = floor_w
        if module is gather_layouts:
            for line in gather_layouts.before_after(
                    [(c, res[c.variant]) for c in cases]):
                log(f"probe {line}")
            n0 = build.LAUNCHES[gather_layouts.SYMBOL]
            edges = gather_layouts.edge_checks(torch.device(DEVICE))
            checks[gather_layouts.SYMBOL] += (
                build.LAUNCHES[gather_layouts.SYMBOL] - n0)
            log(f"probe gather_layouts: {len(edges)} launches beyond the "
                f"probe's shapes bitwise equal to their plain versions "
                f"(ragged rows, each op's largest table, 4-byte-offset "
                f"views)")
        del cases
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"probe {name}: {len(res)} variants checked in "
            f"{time.time() - t:.2f} s")
        out[name] = res
    launches = {name: sum(build.LAUNCHES[s] - checks[s] for s in p[1])
                for name, p in PROBES.items()}
    log(f"probes: launches {launches} (the checks' "
        f"{dict(sorted(checks.items()))} left out)")
    check_launched({s: build.LAUNCHES[s] - checks[s]
                    for p in PROBES.values() for s in p[1]}, "the probes")
    return out, launches


def kernel_device_ms(prof) -> dict:
    """Device milliseconds of each launch of the port's kernels (and of
    the fills) in a profile, in launch order, by kernel name."""
    from torch.autograd import DeviceType
    names = ("ray_reduce_fwd_kernel", "ray_reduce_bwd_kernel",
             "brick_reduce_fwd_kernel", "brick_reduce_bwd_kernel",
             "composite_fwd_kernel", "composite_bwd_kernel", "FillFunctor")
    out = collections.defaultdict(list)
    for ev in sorted(prof.events(), key=lambda e: e.time_range.start):
        if ev.device_type != DeviceType.CUDA:
            continue
        for n in names:
            if n in ev.name:
                out[n].append(ev.time_range.elapsed_us() / 1e3)
    return dict(out)


class SinkFills:
    """While active, a `torch.profiler.record_function` range "K2 bwd
    <table>: sink zero fill" around `GradSink.buffer` (the fill of the
    f32 master gradient, inside the profile's `BrickReduceFnBackward`
    node): a profile's `key_averages` give its device time,
    `kernel_device_ms` the kernels'."""

    def __init__(self, tables):
        self.tables = tables

    def __enter__(self):
        from torch.profiler import record_function
        from ingp_tpu_torch.ops import gather
        self.buffer = buffer = gather.GradSink.buffer
        tables = self.tables

        def sink_buffer(sink):
            name = tables.get(sink.shape[0], sink.shape[0])
            with record_function(f"K2 bwd {name}: sink zero fill"):
                return buffer(sink)

        gather.GradSink.buffer = sink_buffer
        return self

    def __exit__(self, *exc):
        from ingp_tpu_torch.ops import gather
        gather.GradSink.buffer = self.buffer


def profile_summary(prof) -> dict:
    """Of one profiled step: the device time of all ops (self), of the
    backward nodes of K1/K2/K3, of each SinkFills range and of the
    backward kernels, in ms."""
    from torch.autograd import DeviceType
    avgs = prof.key_averages()
    # the device's own rows, as the table's "Self CUDA time total"
    self_total = sum(a.self_device_time_total for a in avgs
                     if a.device_type == DeviceType.CUDA
                     and not getattr(a, "is_user_annotation", False)) / 1e3
    rows = {a.key: a.device_time_total / 1e3 for a in avgs
            if a.key.startswith("K2 bwd ") or a.key in (
                "BrickReduceFnBackward", "CompositeFnBackward",
                "RayReduceFnBackward")}
    rows.update({k: sum(ms) for k, ms in kernel_device_ms(prof).items()
                 if "bwd" in k})
    return {"cuda_total": self_total, **dict(sorted(rows.items()))}


def phase_profile(system, ds, train_system):
    """CUDA time by op of one render and of one training step (a step
    off the grid-refresh cadence), each with its wall time and the
    device time of each launch of the port's kernels; the step's also
    summed by backward node, sink fill and backward kernel."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    batch = stage(train_system.train_dataset.sample_batch(
        np.random.default_rng(1), BATCH), train_system.device)
    cfg = train_system.model_cfg
    tables = {cfg.density_brick_cfg.total_bricks: "density",
              cfg.rgb_brick_cfg.total_bricks: "rgb"}

    def step():
        while train_system.global_step % train_system.UPDATE_INTERVAL == 0:
            train_system.training_step(batch)
        train_system.training_step(batch)

    def profiled(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof, \
                SinkFills(tables):
            t = time.time()
            fn()
            torch.cuda.synchronize()
            return prof, time.time() - t

    for what, fn in (("render", lambda: system.render_image(ds.poses[0])),
                     ("train step", step)):
        prof, wall = profiled(fn)
        log(f"  prof {what}: {wall * 1e3:.1f} ms wall (the table's last "
            f"line gives the CUDA self time)")
        table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=30,
                                          max_name_column_width=60)
        for line in table.splitlines():
            log(f"  prof {what}: {line}")
        for name, ms in kernel_device_ms(prof).items():
            each = sorted(ms, reverse=True)[:12]
            log(f"  prof {what}: {name}: {len(ms)} launches, device "
                f"{sum(ms):.4f} ms (largest: "
                f"{', '.join(f'{t:.4f}' for t in each)})")
    summary = {k: round(v, 4) for k, v in profile_summary(prof).items()}
    log(f"  prof train step: device ms by part {summary}")


OFFLINE_PANO_HW = (512, 1024)
OFFLINE_MESH_RES = (512, 128, 512)
OFFLINE_SIGMA = 10.0
# the brick system's render_for_test renders the first of the 4 test
# views (~11-21 s a view, host-bound), which leaves the run's time limit
# room for phase "parallel"
OFFLINE_BRICK_VIEWS = 1


class Tap(Patch):
    """While active, every call of owner.name passes through and
    appends record(arguments, keyword arguments, result) to `seen`."""

    def __init__(self, owner, name, record):
        super().__init__(owner, name)
        self.record = record
        self.seen = []

    def call(self, *a, **k):
        out = self.fn(*a, **k)
        self.seen.append(self.record(a, k, out))
        return out


def budget_taps():
    """A Tap on the test render's march recording (rays, marched
    samples) of each chunk: the sigma prepass keeps at most rays x
    samples_per_ray of them (`_render_rays_test_inner`)."""
    from ingp_tpu_torch.models import rendering as rendering_mod
    return Tap(rendering_mod, "_march",
               lambda a, k, out: (a[3].shape[0], int(out["total_samples"])))


def overflows(seen, spr):
    """'n of m chunks' whose marched samples exceed the budget."""
    return (f"{sum(s > r * spr for r, s in seen)} of {len(seen)} chunks, "
            f"marched samples per ray up to "
            f"{max(s / r for r, s in seen):.1f} (budget {spr})")


class FirstCall(Patch):
    """While active, the wrappers of the kernels `names` are recorded
    (`record_kernels`) during the first call of owner.name only: the
    first render chunk's or probe chunk's launches."""

    def __init__(self, owner, name, cfg, names):
        super().__init__(owner, name)
        self.cfg, self.names = cfg, names
        self.recs = None

    def call(self, *a, **k):
        if self.recs is not None:
            return self.fn(*a, **k)
        self.recs = record_kernels(self.cfg, self.names)
        try:
            return self.fn(*a, **k)
        finally:
            for r in self.recs.values():
                r.restore()

    def checks(self, what):
        """Each recorded variant against its plain version (CHECKS)."""
        import torch
        with torch.no_grad():
            return {name: {f"{what}, {tag}": CHECKS[name](a, f"{what}, {tag}")
                           for tag, (a, _) in r.calls.items()}
                    for name, r in self.recs.items()}


def read_ply_vertices(path):
    """(vertex count, face count, (V, 3) float32 vertices) of a binary
    PLY as render/mesh.py writes it; the body's length must match."""
    import numpy as np
    data = open(path, "rb").read()
    head, body = data.split(b"end_header\n", 1)
    counts = {}
    for line in head.decode().splitlines():
        if line.startswith("element "):
            _, name, n = line.split()
            counts[name] = int(n)
    nv, nf = counts["vertex"], counts["face"]
    if len(body) != 12 * nv + 13 * nf:
        raise AssertionError(f"{path}: {len(body)} body bytes for {nv} "
                             f"vertices and {nf} faces")
    return nv, nf, np.frombuffer(body[:12 * nv], "<f4").reshape(nv, 3)


def offline_brick(system):
    """`render_for_test(hparams, system=...)` and `extract_mesh` on phase
    "data"'s brick system: views and mesh timed, launches counted, the
    first render chunk's K1, K2 and K3 forward variants and the first
    probe chunk's K2 forward held against their plain versions."""
    import os
    from ingp_tpu_torch.models.ngp import ngp_sigma
    from ingp_tpu_torch.render import mesh as mesh_mod
    from ingp_tpu_torch.render import offline as offline_mod
    import copy
    h = system.hparams
    h.exp_name = "lego_brick"
    cfg = system.model_cfg
    full = system.test_dataset
    te = copy.copy(full)
    te.poses = full.poses[:OFFLINE_BRICK_VIEWS]
    te.rays = full.rays[:OFFLINE_BRICK_VIEWS]
    w, hh = te.img_wh
    n = len(te.poses)
    system.test_dataset = te
    try:
        with FirstCall(offline_mod, "render_rays_test", cfg, FWD) as first, \
                Span(offline_mod, "render_for_test") as span:
            out_dir = offline_mod.render_for_test(h, system=system)
    finally:
        system.test_dataset = full
    per_view = {k: span.launches[k] / n for k in FWD}
    log(f"offline brick render: render_for_test, {n} views of {w}x{hh} in "
        f"chunks of {h.chunk_size} rays: {span.seconds / n * 1e3:.2f} ms "
        f"per view, {n * w * hh / span.seconds:,.0f} rays/s; launches per "
        f"view {per_view}; wrote {sorted(os.listdir(out_dir))}")
    check_launched({k: span.launches[k] for k in FWD}, "the brick render")
    checks = first.checks("offline render")

    probe = SimpleNamespace(fn=lambda p, x: ngp_sigma(cfg, p, x))
    path = os.path.join(out_dir, "mesh.ply")
    with FirstCall(probe, "fn", cfg, ("brick_reduce",)) as first, \
            Span(mesh_mod, "extract_mesh") as span, \
            Clock(mesh_mod, "marching_cubes", sync=True) as iso:
        verts, faces = mesh_mod.extract_mesh(
            lambda p, x: probe.fn(p, x), system.params["model"], h.scale,
            OFFLINE_MESH_RES, OFFLINE_SIGMA, out_path=path)
    chunks = -(-OFFLINE_MESH_RES[0] * OFFLINE_MESH_RES[1]
               * OFFLINE_MESH_RES[2] // 2 ** 17)
    log(f"offline brick mesh: extract_mesh at {OFFLINE_MESH_RES}, sigma "
        f"{OFFLINE_SIGMA}: {span.seconds:.2f} s ({iso.seconds:.2f} s the "
        f"isosurface), {len(verts)} vertices, {len(faces)} faces; launches "
        f"{ {k: span.launches[k] for k in FWD} } over {chunks} probe chunks")
    check_launched({"brick_reduce": span.launches["brick_reduce"]},
                   "the brick mesh probe")
    for name, c in first.checks("offline mesh").items():
        checks.setdefault(name, {}).update(c)
    return checks


def frame0_against_dump(system, img, dump_png, first_view):
    """Frame 0 of render_cli against phase "data"'s dump of the same view
    (`render_image`, whose chunk is capped at 1.5 M samples). The two
    chunkings give the sigma prepass other sample budgets (rays x
    samples_per_ray a chunk; the JAX renderer's too), so a chunk whose
    marched samples exceed its budget drops samples that the other
    chunking keeps: the difference is reported with the chunks that
    overflow. The bound: every pixel that differs lies in a chunk that
    overflowed in one chunking or the other, and frame 0 re-rendered
    through `render_chunks` at render_image's chunk equals the dump in
    every value. Returns failures."""
    import os
    import numpy as np
    import torch
    from ingp_tpu_torch.core.rays import get_rays
    from ingp_tpu_torch.data.image_io import read_png
    from ingp_tpu_torch.render.offline import render_chunks
    dump = read_png(dump_png)
    spr = system.render_cfg_test.samples_per_ray
    d = np.abs(img.astype(np.int32) - dump.astype(np.int32))
    log(f"offline render_cli: frame 0 against the dump "
        f"{os.path.basename(dump_png)}: {int((d > 0).sum())} of {d.size} "
        f"values differ, by at most {int(d.max())}; its chunks over the "
        f"sample budget: {overflows(first_view, spr)}")
    chunk = min(system.hparams.chunk_size, max(1_500_000 // spr, 4096))
    te = system.test_dataset
    pose = torch.as_tensor(te.poses[0], device=system.device)
    rays_o, rays_d = get_rays(torch.as_tensor(te.directions,
                                              device=system.device), pose)
    with budget_taps() as budget:
        res = render_chunks(system.model_cfg, system.render_cfg_test,
                            system.params["model"], system.grid["bitfield"],
                            rays_o, rays_d, chunk,
                            block_table=system.grid["block_table"])
    w, h = te.img_wh
    again = (np.clip(res["rgb"].cpu().numpy().reshape(h, w, 3), 0, 1)
             * 255).astype(np.uint8)
    same = int((again != dump).sum())
    log(f"offline render_cli: frame 0 through render_chunks at "
        f"render_image's chunk of {chunk} rays: {same} values differ from "
        f"the dump; chunks over the budget: {overflows(budget.seen, spr)}")

    def over(seen, size):
        m = np.zeros(w * h, bool)
        for c, (r, n) in enumerate(seen):
            m[c * size:c * size + r] |= n > r * spr
        return m
    outside = int(((d > 0).any(-1).reshape(-1)
                   & ~(over(first_view, system.hparams.chunk_size)
                       | over(budget.seen, chunk))).sum())
    log(f"offline render_cli: pixels of frame 0 that differ outside the "
        f"overflowing chunks: {outside}")
    failures = []
    if same:
        failures.append(f"frame 0 at render_image's chunk differs from the "
                        f"dump in {same} values")
    if outside:
        failures.append(f"{outside} pixels of frame 0 differ from the dump "
                        f"outside the overflowing chunks")
    return failures


def first_test_view_root(root):
    """A sibling of the NSVF fixture root whose test split is its first
    test view alone (links to the fixture's files: every train frame, so
    that the checkpoint's per-image tables fit, and the first test
    frame)."""
    import glob
    import os
    view0 = f"{root}_view0"
    for sub in ("rgb", "pose"):
        os.makedirs(os.path.join(view0, sub), exist_ok=True)
        names = sorted(glob.glob(os.path.join(root, sub, "0_*")))
        names += sorted(glob.glob(os.path.join(root, sub, "2_*")))[:1]
        for path in names:
            os.symlink(path, os.path.join(view0, sub, os.path.basename(path)))
    for name in ("intrinsics.txt", "bbox.txt"):
        os.symlink(os.path.join(root, name), os.path.join(view0, name))
    return view0


def offline_lego(lego_argv, dump_png):
    """The three CLIs on lego's `last` checkpoint (the hash model of phase
    "data", in its working directory): render_cli (on the first test view
    alone, `first_test_view_root`, to keep the run's time; an mp4 or the
    skip line, frame 0 against phase "data"'s dump of the same view),
    render_panorama_cli and extract_mesh_cli. Returns failures."""
    import os
    import shutil
    import numpy as np
    from ingp_tpu_torch import (extract_mesh_cli, render_cli,
                                render_panorama_cli)
    from ingp_tpu_torch.data.image_io import read_png
    from ingp_tpu_torch.render import mesh as mesh_mod
    from ingp_tpu_torch.render import offline as offline_mod
    from ingp_tpu_torch.render import panorama as panorama_mod
    failures = []
    with Span(render_cli, "main") as span, \
            Clock(offline_mod, "render_chunks", sync=True) as chunks, \
            Tap(offline_mod, "_load_last", lambda a, k, out: a[0]) as sys_, \
            budget_taps() as budget:
        i = lego_argv.index("--root_dir") + 1
        out_dir = render_cli.main(
            lego_argv[:i] + [first_test_view_root(lego_argv[i])]
            + lego_argv[i + 1:])
    names = sorted(os.listdir(out_dir))
    frames = [x for x in names if x.endswith("_rgb.png")]
    n = len(frames)
    img = read_png(os.path.join(out_dir, frames[0]))
    hh, w = img.shape[:2]
    log(f"offline render_cli: lego's last, {n} views of {w}x{hh}: "
        f"{chunks.seconds / max(n, 1) * 1e3:.2f} ms per view (render_chunks),"
        f" {n * w * hh / chunks.seconds:,.0f} rays/s, {span.seconds:.2f} s "
        f"with set-up; launches {span.launches['composite']} K3 fwd; wrote "
        f"{names}")
    check_launched({"composite": span.launches["composite"]},
                   "render_cli")
    has_mp4 = "rgb.mp4" in names
    log(f"offline render_cli: rgb.mp4 "
        f"{'written' if has_mp4 else 'skipped'} (ffmpeg on PATH: "
        f"{shutil.which('ffmpeg')})")
    if n != 1 or has_mp4 != bool(shutil.which("ffmpeg")):
        failures.append(f"render_cli wrote {names}")
    failures += frame0_against_dump(sys_.seen[0], img, dump_png,
                                    budget.seen[:len(budget.seen) // n])
    del sys_

    pano = lego_argv + ["--ckpt_load", "ckpts/nsvf/lego/last", "--pano_h",
                        str(OFFLINE_PANO_HW[0]), "--pano_w",
                        str(OFFLINE_PANO_HW[1])]
    with Span(render_panorama_cli, "main") as span, \
            Clock(panorama_mod, "render_chunks", sync=True) as chunks:
        res = render_panorama_cli.main(pano)
    H, W = OFFLINE_PANO_HW
    shapes = {sub: read_png(os.path.join(out_dir, "panorama", sub,
                                         "0.png")).shape
              for sub in ("rgb", "opacity", "mask")}
    log(f"offline render_panorama_cli: {H}x{W} in {chunks.seconds:.2f} s "
        f"(render_chunks), {H * W / chunks.seconds:,.0f} rays/s, "
        f"{span.seconds:.2f} s with set-up; opacity mean "
        f"{float(res['opacity'].mean()):.4f}; launches "
        f"{span.launches['composite']} K3 fwd; PNGs read back {shapes}")
    check_launched({"composite": span.launches["composite"]},
                   "render_panorama_cli")
    if shapes != {"rgb": (H, W, 3), "opacity": (H, W), "mask": (H, W)}:
        failures.append(f"panorama PNGs {shapes}")

    mesh = lego_argv + ["--ckpt_load", "ckpts/nsvf/lego/last",
                        "--mesh_resolution",
                        *(str(r) for r in OFFLINE_MESH_RES),
                        "--sigma_threshold", str(OFFLINE_SIGMA)]
    with Span(extract_mesh_cli, "main") as span, \
            Clock(mesh_mod, "probe_density", sync=True) as probe, \
            Clock(mesh_mod, "marching_cubes", sync=True) as iso:
        verts, faces = extract_mesh_cli.main(mesh)
    nv, nf, v = read_ply_vertices(os.path.join(out_dir, "mesh.ply"))
    scale = float(np.abs(v).max()) if nv else 0.0
    log(f"offline extract_mesh_cli: {OFFLINE_MESH_RES}, sigma "
        f"{OFFLINE_SIGMA}: probe {probe.seconds * 1e3:.1f} ms, isosurface "
        f"{iso.seconds * 1e3:.1f} ms, {span.seconds:.2f} s with set-up; "
        f"{len(verts)} vertices, {len(faces)} faces; the .ply header says "
        f"{nv} / {nf}; largest |coordinate| {scale:.6f}")
    if (nv, nf) != (len(verts), len(faces)) or nf == 0:
        failures.append(f"mesh.ply: {nv} vertices, {nf} faces")
    if scale > 0.5 * (1 + 1e-6):
        failures.append(f"a mesh vertex lies outside the scene box: {scale}")
    return failures


def offline_tnt(span, traj_frames):
    """Playground's end-of-run render (`train.main` without
    --no_save_test in phase "data": the camera path, the mean appearance
    code, rgb, depth and normal frames) read back, then both aux-head
    passes on its system. Returns failures."""
    import os
    from ingp_tpu_torch.data.image_io import read_pgm, read_png
    from ingp_tpu_torch.render import aux_heads
    system = span.result
    h = system.hparams
    out_dir = os.path.join("results", h.dataset_name, h.exp_name)
    names = sorted(os.listdir(out_dir))
    te = system.test_dataset
    w, hh = te.img_wh
    n = len(te.render_traj_rays)
    want = sorted(f"{i:05d}_{k}.png" for i in range(n)
                  for k in ("rgb", "depth", "normal"))
    pngs = [x for x in names if x.endswith(".png")]
    shapes = {read_png(os.path.join(out_dir, x)).shape for x in pngs}
    log(f"offline tnt: train.main's end-of-run render of the camera path "
        f"({n} poses, embed_a {h.embed_a}): {traj_frames.seconds:.2f} s, "
        f"launches {traj_frames.launches['composite']} K3 fwd; wrote "
        f"{names}, PNGs of {shapes}")
    failures = []
    if pngs != want or shapes != {(hh, w, 3)}:
        failures.append(f"tnt trajectory frames {names}")
    if traj_frames.launches["composite"] <= 0:
        failures.append("the tnt trajectory render launched no K3")
    model = system.params["model"]
    args = (system.model_cfg, system.render_cfg_test, model,
            system.grid["bitfield"], te)
    emb = system.params["embedding_a"][0:1].detach()
    with Span(aux_heads, "render_semantic_labels") as sem, \
            Span(aux_heads, "render_up_normal_masks") as up:
        d_sem = aux_heads.render_semantic_labels(
            *args, out_dir, chunk_size=h.chunk_size, embedding_a=emb)
        d_up = aux_heads.render_up_normal_masks(
            *args, te.up, out_dir, chunk_size=h.chunk_size, embedding_a=emb)
    got = {d: sorted(os.listdir(d)) for d in (d_sem, d_up)}
    shapes = {read_pgm(os.path.join(d, x)).shape
              for d, xs in got.items() for x in xs}
    log(f"offline aux heads: semantic labels {sem.seconds:.2f} s, up-normal "
        f"masks {up.seconds:.2f} s; launches {sem.launches['composite']} / "
        f"{up.launches['composite']} K3 fwd; wrote {got}, PGMs of {shapes}")
    check_launched({"composite": sem.launches["composite"]},
                   "the semantic pass")
    check_launched({"composite": up.launches["composite"]},
                   "the up-normal pass")
    if shapes != {(hh, w)} or [len(x) for x in got.values()] != \
            [len(te.poses)] * 2:
        failures.append(f"aux passes wrote {got}")
    return failures


ORACLE_RAYS = 2048
# the dense oracle's bound in tests/test_render.py: the two quadratures
# differ (the marcher's dt lattice, the oracle's strata)
ORACLE_TOL = 0.05


def oracle_rays(n, z0, spread):
    """n rays from z = z0 towards +z through the box centre (seeded),
    as tests/test_torch_oracle.py casts them."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    ro = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n),
                   np.full(n, z0)], -1)
    rd = np.stack([rng.uniform(-spread, spread, n),
                   rng.uniform(-spread, spread, n), np.ones(n)], -1)
    return (torch.as_tensor(ro, dtype=torch.float32, device=DEVICE),
            torch.as_tensor(rd, dtype=torch.float32, device=DEVICE))


def offline_oracles(system):
    """The render layer's oracles on the card, as
    tests/test_torch_oracle.py holds them on the CPU: the exact-skip
    `march_rays` against the lattice and block marchers at the brick
    system's grid geometry and constant step, on the occupancy grid of
    the fixtures' sphere scene (ts and deltas to 1e-5, the block march
    equal to the lattice march on one cascade);
    the dense `render_rays_oracle` against the test render
    (`render_rays_test`: the block march, the sample budget, K1-K3
    forward) on a random field at the system's widths on a full grid
    with room for every sample, within ORACLE_TOL. Returns failures."""
    import dataclasses
    import torch
    from ingp_tpu_torch.core import prng
    from ingp_tpu_torch.core.intersect import ray_aabb_intersect
    from ingp_tpu_torch.data.synthetic import sphere_density_grid
    from ingp_tpu_torch.grid.occupancy import grid_from_density
    from ingp_tpu_torch.models.ngp import ngp_init
    from ingp_tpu_torch.models.oracle import render_rays_oracle
    from ingp_tpu_torch.models.rendering import (clamp_near,
                                                 render_rays_test)
    from ingp_tpu_torch.ops import march
    cfg = system.model_cfg
    failures = []
    mcfg = dataclasses.replace(system.render_cfg_test.march_cfg(cfg),
                               exp_step_factor=0.0)
    ro, rd = oracle_rays(ORACLE_RAYS, -2.0, 0.2)
    hits = clamp_near(ray_aabb_intersect(
        ro, rd, torch.zeros(3, device=DEVICE),
        torch.full((3,), cfg.scale, device=DEVICE)))
    noise = torch.zeros(ORACLE_RAYS, device=DEVICE)
    grid = grid_from_density(
        system.grid, torch.as_tensor(sphere_density_grid(
            cfg.grid_size, cfg.cascades, cfg.scale), device=DEVICE),
        0.5, cfg.grid_size, cfg.cascades)
    bits, table = grid["bitfield"], grid["block_table"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    exact = march.march_rays(mcfg, bits, ro, rd, hits, noise)
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t
    lat = march.march_rays_lattice(mcfg, bits, ro, rd, hits, noise)
    blk = march.march_rays_block(mcfg, table, ro, rd, hits, noise)
    n_bad = int((lat["n_samples"] != exact["n_samples"]).sum())
    ts_err = float(((lat["ts"] - exact["ts"]).abs()
                    - 1e-5 * exact["ts"].abs()).max())
    dt_err = float(((lat["deltas"] - exact["deltas"]).abs()
                    - 1e-5 * exact["deltas"].abs()).max())
    blk_same = all(torch.equal(blk[k], lat[k])
                   for k in ("ts", "deltas", "valid"))
    log(f"offline oracle march: {ORACLE_RAYS} rays, {mcfg.grid_size}^3 x "
        f"{mcfg.cascades} grid, capacity {mcfg.capacity}: exact-skip "
        f"march_rays {exact_s * 1e3:.1f} ms, {int(exact['total_samples'])} "
        f"samples; lattice rays with another count {n_bad}, ts beyond "
        f"rtol 1e-5 by {ts_err:.3g}, deltas by {dt_err:.3g}; block march "
        f"equal to lattice {blk_same}")
    if int(exact["total_samples"]) == 0 or n_bad or ts_err > 1e-6 \
            or dt_err > 0 or (mcfg.cascades == 1 and not blk_same):
        failures.append("the lattice or block march differs from the "
                        "exact-skip march")

    params = ngp_init(cfg, prng.prng_key(0), DEVICE)
    params["density_table"] = params["density_table"] * 2e3
    full = torch.full_like(bits, -1)
    full_table = march.build_block_table(full, cfg.grid_size, cfg.cascades)
    rcfg = dataclasses.replace(system.render_cfg_test, capacity=1024,
                               march_iters=1104, samples_per_ray=1024,
                               T_threshold=1e-4, exp_step_factor=0.0)
    ro, rd = oracle_rays(ORACLE_RAYS, -1.4, 0.1)
    with torch.no_grad():
        fast = render_rays_test(cfg, rcfg, params, full, ro, rd,
                                block_table=full_table)
        oracle = render_rays_oracle(cfg, params, ro, rd, prng.prng_key(0),
                                    n_samples=1024)
    errs = {k: float((fast[k].float() - oracle[k].float()).abs().max())
            for k in ("opacity", "rgb", "depth")}
    log(f"offline oracle render: {ORACLE_RAYS} rays, test render (block "
        f"march, capacity 1024) against the dense oracle (1024 strata) on "
        f"a random field at the system's widths: max |diff| "
        f"{ {k: round(v, 5) for k, v in errs.items()} } (bound "
        f"{ORACLE_TOL}), oracle opacity mean "
        f"{float(oracle['opacity'].mean()):.3f}")
    if float(oracle["opacity"].max()) < 0.3 or \
            max(errs.values()) > ORACLE_TOL:
        failures.append(f"the test render differs from the dense oracle: "
                        f"{errs}")
    return failures


def phase_offline(brick, lego_argv, dump_png, tnt_span, traj_frames):
    """Phase "offline", in phase "data"'s working directory: the brick
    system's render_for_test and mesh (`offline_brick`), the marchers
    and the test render against their oracles (`offline_oracles`), the
    three CLIs on lego's checkpoint (`offline_lego`), Playground's
    trajectory frames and aux passes (`offline_tnt`). Returns {kernel:
    {variant: numbers}}; fails if any check failed."""
    import torch
    checks = offline_brick(brick)
    failures = offline_oracles(brick)
    del brick
    torch.cuda.empty_cache()
    failures += offline_lego(lego_argv, dump_png)
    failures += offline_tnt(tnt_span, traj_frames)
    if failures:
        raise AssertionError(f"offline: {failures}")
    return checks


# ---------------------------------------------------------------- native

NATIVE_BATCHES = 100


UTILITY_LPIPS = (8, 256)          # image pairs, side
UTILITY_PLANE_POINTS = 1_000_000
UTILITY_BLEND = 256               # blended region side (target 320)
UTILITY_OCEAN = (512, 120, 8)     # resolution, frames, frames on the CPU
UTILITY_SCENE = (480, 640)        # the vanishing-point scene
UTILITY_VP = (347.0, -1400.0)     # its verticals' vanishing point
UTILITY_VIDEO = (30, 256)         # AVI frames, side


def vp_scene(h, w, vp, seed=0, n=24):
    """An RGB facade of dark quads on a light wall whose sides run to vp
    (a numpy half-plane fill, so that the check needs no cv2)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 200, np.uint8)
    yy, xx = np.mgrid[0:h, 0:w] + 0.5
    for _ in range(n):
        x0, y0 = rng.uniform(10, w - 80), rng.uniform(h * 0.4, h - 5)
        top, wd = rng.uniform(5, y0 - 40), rng.uniform(20, 70)
        t = (y0 - top) / (y0 - vp[1])
        quad = [(x0, y0), (x0 + wd, y0),
                (x0 + wd + (vp[0] - x0 - wd) * t, top),
                (x0 + (vp[0] - x0) * t, top)]
        inside = np.ones((h, w), bool)
        for (ax, ay), (bx, by) in zip(quad, quad[1:] + quad[:1]):
            inside &= (bx - ax) * (yy - ay) - (by - ay) * (xx - ax) <= 0
        img[inside] = rng.integers(0, 120, 3)
    return img


def phase_utility():
    """The port's utility tools and LPIPS on the card, each against the
    same call on the CPU: LPIPS of UTILITY_LPIPS image pairs (rtol 1e-5),
    again with TF32 switched on process-wide (`lpips` pins it off for its
    convolutions), and once with the pin bypassed, which must miss 1e-5;
    plane_ransac on 1 M seeded points (inlier masks
    equal); a 256 x 256 Poisson blend (1e-9); the ocean's 120 frames at
    512 against the CPU's first 8 (1e-4 of the largest value); the line
    segment detector's g++ build and estimate_up_vector on a rendered
    facade with a known vertical vanishing point (within 1 degree); a
    Motion-JPEG AVI round trip (above 35 dB)."""
    import math
    import os
    import tempfile
    import numpy as np
    import torch
    from ingp_tpu_torch.core import prng
    from ingp_tpu_torch.training import lpips
    from ingp_tpu_torch.utility import (fit_plane, ocean_wave, poisson_blend,
                                        vanishing_point, video)
    t_phase = time.time()

    def timed(fn, dev):
        """fn(dev) and its ms; on the card its second call (the first
        builds cuFFT plans and cuDNN's choices)."""
        if dev == DEVICE:
            fn(dev)
            torch.cuda.synchronize()
        t = time.time()
        out = fn(dev)
        if dev == DEVICE:
            torch.cuda.synchronize()
        return out, (time.time() - t) * 1e3

    # LPIPS
    n, side = UTILITY_LPIPS
    rng = np.random.default_rng(0)
    a = rng.random((n, side, side, 3), dtype=np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    params = {d: lpips.random_lpips_params(prng.prng_key(0), device=d)
              for d in (DEVICE, "cpu")}
    want, cpu_ms = timed(lambda d: lpips.lpips(params[d], a, b), "cpu")
    pin = lpips._no_tf32
    # TF32 off and on process-wide, then on with lpips' pin bypassed: the
    # negative control, which must miss the bound the pin holds
    for tf32, pinned in ((False, True), (True, True), (True, False)):
        saved = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        if not pinned:
            lpips._no_tf32 = contextlib.nullcontext
        try:
            got, ms = timed(lambda d: lpips.lpips(params[d], a, b), DEVICE)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = saved
            lpips._no_tf32 = pin
        rel = float(((got.cpu() - want).abs() / want.abs()).max())
        how = ("on process-wide" if pinned else
               "on, the pin bypassed") if tf32 else "off process-wide"
        log(f"utility lpips: {n} pairs of {side}x{side}, TF32 {how}: "
            f"{ms:.2f} ms (cpu {cpu_ms:.2f} ms), rel err {rel:.3g} (bound "
            f"1e-5; values {float(want.min()):.5f}-"
            f"{float(want.max()):.5f})")
        if pinned and not rel <= 1e-5:
            raise AssertionError(f"utility lpips: card vs cpu {rel} > 1e-5 "
                                 f"with TF32 {how}")
        if not pinned and not rel > 1e-5:
            raise AssertionError(f"utility lpips: TF32 with the pin "
                                 f"bypassed is within 1e-5 ({rel}), so the "
                                 f"check cannot see the pin")

    # plane fit
    rng = np.random.default_rng(1)
    m = UTILITY_PLANE_POINTS
    pts = rng.uniform(-1, 1, (m, 3))
    on = rng.random(m) < 0.6
    pts[on, 2] = 0.3 * pts[on, 0] - 0.2 * pts[on, 1] + 0.4 \
        + rng.normal(0, 0.002, on.sum())
    fits = {}
    for d in ("cpu", DEVICE):
        fits[d], ms = timed(lambda dv: fit_plane.plane_ransac(
            pts, n_iters=200, threshold=0.01, seed=0, device=dv), d)
        log(f"utility plane_ransac [{d}]: {m} points, 200 hypotheses: "
            f"{ms:.2f} ms, {int(fits[d][1].sum())} inliers, normal "
            f"{np.round(fits[d][0].normal, 6).tolist()}")
    if not np.array_equal(fits["cpu"][1], fits[DEVICE][1]):
        raise AssertionError("utility plane_ransac: the card's inlier mask "
                             "differs from the CPU's")
    dc = float(np.abs(fits["cpu"][0].center - fits[DEVICE][0].center).max())
    if not dc <= 1e-9:
        raise AssertionError(f"utility plane_ransac: centers differ by {dc}")

    # Poisson blend
    rng = np.random.default_rng(2)
    k = UTILITY_BLEND
    src = rng.uniform(0, 255, (k + 20, k + 20, 3))
    tar = rng.uniform(0, 255, (k + 64, k + 64, 3))
    blends = {}
    for d in ("cpu", DEVICE):
        blends[d], ms = timed(lambda dv: poisson_blend.poisson_blending(
            src, (10, 10 + k, 5, 5 + k), tar, (30, 40), device=dv), d)
        log(f"utility poisson_blending [{d}]: {k}x{k} region: {ms:.2f} ms")
    err = float(np.abs(blends["cpu"] - blends[DEVICE]).max())
    log(f"utility poisson_blending: card vs cpu max abs err {err:.3g}")
    if not err <= 1e-9:
        raise AssertionError(f"utility poisson_blending: {err} > 1e-9")

    # ocean waves
    res, frames, on_cpu = UTILITY_OCEAN
    times = np.arange(frames, dtype=np.float32) / np.float32(15.0)

    def ocean(dv, nt):
        spec = ocean_wave.init_spectrum((-5.0, 5.0), res, 500.0, dv)
        h0, h0s, ph = ocean_wave.seed_field(prng.prng_key(0), spec)
        return ocean_wave.synthesize(h0, h0s, ph, times[:nt], 1e4, res,
                                     500.0)
    disp, ms = timed(lambda dv: ocean(dv, frames), DEVICE)
    ref, cpu_ms = timed(lambda dv: ocean(dv, on_cpu), "cpu")
    err = float((disp[:on_cpu].cpu() - ref).abs().max())
    scale = float(ref.abs().max())
    log(f"utility ocean: {frames} frames at {res}x{res}: {ms:.2f} ms "
        f"(cpu {cpu_ms:.2f} ms for {on_cpu}); first {on_cpu} frames: max "
        f"abs err {err:.3g} of largest {scale:.4g}")
    if not (torch.isfinite(disp).all() and err <= 1e-4 * scale):
        raise AssertionError(f"utility ocean: {err} > 1e-4 x {scale}")

    # the line segment detector and the up vector
    t = time.time()
    vanishing_point.build_helper(force=True)
    log(f"utility lsd: g++ build {time.time() - t:.2f} s")
    h, w = UTILITY_SCENE
    img = vp_scene(h, w, UTILITY_VP)
    K = np.array([[500.0, 0, w / 2], [0, 500.0, h / 2], [0, 0, 1]])
    t = time.time()
    segs = vanishing_point.detect_line_segments(
        vanishing_point.rgb_to_gray(img))
    lsd_ms = (time.time() - t) * 1e3
    up, ms = timed(lambda dv: vanishing_point.estimate_up_vector(
        img, K, device=dv), DEVICE)
    ray = np.linalg.inv(K) @ np.array([*UTILITY_VP, 1.0])
    ray = ray / np.linalg.norm(ray) * (-1 if ray[1] > 0 else 1)
    ang = float(np.degrees(np.arccos(np.clip(up @ ray, -1, 1)))) \
        if up is not None else math.inf
    log(f"utility vanishing point: {w}x{h} scene, {len(segs)} segments in "
        f"{lsd_ms:.2f} ms, estimate_up_vector {ms:.2f} ms: up "
        f"{None if up is None else np.round(up, 5).tolist()}, "
        f"{ang:.4f} degrees from the true vertical")
    if not ang <= 1.0:
        raise AssertionError(f"utility vanishing point: {ang} degrees")

    # video
    nf, side = UTILITY_VIDEO
    yy, xx = np.mgrid[0:side, 0:side]
    clip = [np.stack([127 + 100 * np.sin(xx / 19 + i / 5),
                      127 + 100 * np.cos(yy / 23 - i / 7),
                      127 + 60 * np.sin((xx + yy) / 31)], -1).astype(np.uint8)
            for i in range(nf)]
    with tempfile.TemporaryDirectory(prefix="ingp_video_") as tmp:
        path = os.path.join(tmp, "clip.avi")
        t = time.time()
        video.write_avi(path, clip, fps=30)
        back = video.read_avi(path)
        ms = (time.time() - t) * 1e3
        size = os.path.getsize(path)
    psnr = min(10 * math.log10(255.0 ** 2 / float(np.mean(
        (f.astype(np.float64) - g) ** 2))) for f, g in zip(clip, back))
    log(f"utility video: {nf} frames of {side}x{side} to a Motion-JPEG AVI "
        f"({size} bytes) and back in {ms:.2f} ms, worst frame {psnr:.2f} dB")
    if not (len(back) == nf and psnr > 35.0):
        raise AssertionError(f"utility video: {len(back)} frames, "
                             f"{psnr} dB")
    log(f"utility: phase {time.time() - t_phase:.1f} s")


def phase_native():
    """The native batch sampler (`ingp_tpu_torch.native`) that `fit` draws
    from by default: its library built by g++ here, NATIVE_BATCHES
    batches of bench.py's dataset at BATCH rays held to the direct gather
    rays[img, pix] (rgb, labels, normals, uv) and to a second sampler of
    the same seed (batch n is a function of (seed, n)); ms a batch beside
    the numpy sampler's."""
    import numpy as np
    from ingp_tpu_torch.data.synthetic import SyntheticDataset
    from ingp_tpu_torch.native import NativeBatchSampler, build
    t = time.time()
    path = build.build_library(force=True)
    log(f"native: g++ built {path.name} in {time.time() - t:.2f} s")
    tr = SyntheticDataset(split="train", img_size=IMG_SIZE, n_train=N_VIEWS)
    w = tr.img_wh[0]
    with NativeBatchSampler(tr, BATCH, seed=0) as a, \
            NativeBatchSampler(tr, BATCH, seed=0) as b:
        t = time.perf_counter()
        got = [a.next_batch() for _ in range(NATIVE_BATCHES)]
        native_ms = (time.perf_counter() - t) / NATIVE_BATCHES * 1e3
        for i, x in enumerate(got):
            img, pix = x["img_idxs"], x["pix_idxs"]
            direct = {"rgb": tr.rays[img, pix][:, :3],
                      "label": tr.labels[img, pix],
                      "normal": tr.normals[img, pix],
                      "uv": np.stack([pix // w, pix % w], -1
                                     ).astype(np.float32)}
            for k, v in direct.items():
                if not np.array_equal(x[k], v):
                    raise AssertionError(f"native batch {i}: {k} is not "
                                         f"the direct gather")
            y = b.next_batch()
            for k in x:
                if not np.array_equal(x[k], y[k]):
                    raise AssertionError(f"native batch {i}: {k} differs "
                                         f"between two samplers of seed 0")
    rng = np.random.default_rng(0)
    t = time.perf_counter()
    for _ in range(NATIVE_BATCHES):
        tr.sample_batch(rng, BATCH)
    numpy_ms = (time.perf_counter() - t) / NATIVE_BATCHES * 1e3
    log(f"native: {NATIVE_BATCHES} batches of {BATCH} rays equal to the "
        f"direct gather and to a second sampler; {native_ms:.3f} ms a "
        f"batch (the consumer's wait and copy; the gather runs on the "
        f"sampler's thread), numpy sample_batch {numpy_ms:.3f} ms")
    return {"native_ms": native_ms, "numpy_ms": numpy_ms}


# -------------------------------------------------------------- parallel

PARALLEL_RANKS = 2
PARALLEL_STEPS = 3
PARALLEL_CLI_STEPS = 20


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _param_digest(system):
    import hashlib
    from ingp_tpu_torch.training.trainer import tree_leaves
    h = hashlib.sha256()
    for _, t in tree_leaves(system.params):
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _grads_close(what, got, ref, tol=1e-4):
    """Each leaf of got within tol of the largest |value| of ref's."""
    from ingp_tpu_torch.training.trainer import tree_leaves
    worst = 0.0
    for (path, a), (_, b) in zip(tree_leaves(got), tree_leaves(ref)):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        if not err <= tol * scale:
            raise AssertionError(f"{what}: gradient {path}: {err} > {tol} "
                                 f"x {scale}")
        worst = max(worst, err / scale if scale else 0.0)
    return worst


def _parallel_rank(rank, port, cli_port, workdir, queue):
    """One rank of phase "parallel" (a process of its own, on the one
    card): --num_gpus semantics over gloo for (a), (b) and the render,
    then the --distributed CLI. Rank 0 also runs the single-process
    references and checks its first step's kernels."""
    import os
    import numpy as np
    import torch
    import torch.distributed as dist
    from ingp_tpu_torch import train as train_cli
    from ingp_tpu_torch.data.synthetic import SyntheticDataset
    from ingp_tpu_torch.parallel import init_distributed, world_from_group
    from ingp_tpu_torch.training import trainer as tt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(f"localhost:{port}", PARALLEL_RANKS, rank,
                     device=DEVICE)
    world = world_from_group(DEVICE)
    main = rank == 0
    out = {"rank": rank, "backend": world.backend,
           "device": str(world.device)}
    tr = SyntheticDataset(split="train", img_size=IMG_SIZE, n_train=N_VIEWS)
    te = SyntheticDataset(split="test", img_size=IMG_SIZE, n_test=1)
    rng = np.random.default_rng(1)
    batches = [tr.sample_batch(rng, BATCH) for _ in range(PARALLEL_STEPS)]

    def staged(system, b):
        return {**system.stage_batch(system.draws_for(BATCH)),
                **stage(b, system.device)}

    # (a) a non-binding budget at f32: the first step's mean loss and
    # averaged gradients against one process's on the same global batch
    # and draws; the ranks' parameters after PARALLEL_STEPS steps
    h = bench_hparams(capacity=24, samples_per_ray=24,
                      compute_dtype="float32", table_dtype="float32")
    dp = tt.NeRFSystem(h, tr, te, world=world, seed=0)
    one = tt.NeRFSystem(h, tr, te, device=DEVICE, seed=0) if main else None
    dp.maybe_update_grid()
    aux, grads = dp.data_parallel_grads(staged(dp, batches[0]))
    if main:
        one.maybe_update_grid()
        sb = staged(one, batches[0])
        aux1, grads1 = one.loss_and_grads(sb, sb["noise"],
                                          sb.get("sparsity_points"))
        la, lb = float(aux["loss"]), float(aux1["loss"])
        if not abs(la - lb) <= 1e-4 * abs(lb):
            raise AssertionError(f"parallel (a): loss {la} vs {lb}")
        out["a_loss"] = (la, lb)
        out["a_grad_worst"] = _grads_close("parallel (a)", grads, grads1)
        del sb, aux1, grads1
    dp.apply_grads(aux, grads)
    del aux, grads
    for b in batches[1:]:
        dp.training_step(b)
    digests = [None] * PARALLEL_RANKS
    dist.all_gather_object(digests, _param_digest(dp))
    if len(set(digests)) != 1:
        raise AssertionError(f"parallel (a): the ranks' parameters differ "
                             f"after {PARALLEL_STEPS} steps: {digests}")
    out["a_digest"] = digests[0][:16]
    del dp, one
    torch.cuda.empty_cache()

    # (b) the bench's binding budget (48 / 24, bf16): losses against one
    # process's; rank 0 records and checks its first step's kernels;
    # the all-reduce timed, the later steps timed
    h = bench_hparams()
    dp = tt.NeRFSystem(h, tr, te, world=world, seed=0)
    recs = record_kernels(dp.model_cfg, KERNELS) if main else {}
    real_mean = tt.all_reduce_mean
    reduce_ms = []

    def timed_mean(w, trees):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = real_mean(w, trees)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t) * 1e3)
        return r
    tt.all_reduce_mean = timed_mean
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    try:
        for i, b in enumerate(batches):
            if i == 1:
                for r in recs.values():
                    r.restore()
                clear_counts()
            sb = stage(b, dp.device)
            torch.cuda.synchronize()
            dist.barrier()
            t = time.perf_counter()
            aux = dp.training_step(sb)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            losses.append(float(aux["loss"]))
    finally:
        tt.all_reduce_mean = real_mean
        for r in recs.values():
            r.restore()
    launches = launch_counts()
    out["b_launches_per_step"] = {k: launches[k] / (PARALLEL_STEPS - 1)
                                  for k in KERNELS}
    out["b_losses"] = losses
    out["b_step_ms"] = step_ms
    out["b_reduce_ms"] = reduce_ms
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if main:
        for name, r in recs.items():
            if PRIMARY[name] not in r.calls:
                raise AssertionError(f"parallel: {name} "
                                     f"[{PRIMARY[name]}] was not called")
        with torch.no_grad():
            out["checks"] = {name: {tag: CHECKS[name](a, f"parallel, {tag}")
                                    for tag, (a, _) in r.calls.items()}
                             for name, r in recs.items()}
        del recs
        one = tt.NeRFSystem(h, tr, te, device=DEVICE, seed=0)
        ref = [float(one.training_step(stage(b, one.device))["loss"])
               for b in batches]
        out["b_ref_losses"] = ref
        for i, (la, lb) in enumerate(zip(losses, ref)):
            if not abs(la - lb) <= 5e-3 * abs(lb):
                raise AssertionError(f"parallel (b): step {i} loss {la} vs "
                                     f"{lb} (rtol 5e-3)")
        del one
    dist.barrier()
    del dp
    torch.cuda.empty_cache()

    # the sharded test render at a non-binding budget against one
    # process's view
    h = bench_hparams(capacity=24, samples_per_ray=24,
                      compute_dtype="float32", table_dtype="float32")
    dp = tt.NeRFSystem(h, tr, te, world=world, seed=0)
    set_sphere_grid(dp)
    torch.cuda.synchronize()
    t = time.perf_counter()
    view = dp.render_image(te.poses[0])
    torch.cuda.synchronize()
    out["render_ms"] = (time.perf_counter() - t) * 1e3
    if main:
        one = tt.NeRFSystem(h, tr, te, device=DEVICE, seed=0)
        set_sphere_grid(one)
        ref = one.render_image(te.poses[0])
        if view["total_samples"] != ref["total_samples"]:
            raise AssertionError(f"parallel render: {view['total_samples']} "
                                 f"samples vs {ref['total_samples']}")
        for k in ("rgb", "depth", "opacity"):
            if not torch.allclose(view[k], ref[k], rtol=1e-4, atol=1e-5):
                d = float((view[k] - ref[k]).abs().max())
                raise AssertionError(f"parallel render: {k} differs by {d}")
        out["render_err"] = float((view["rgb"] - ref["rgb"]).abs().max())
        out["render_samples"] = int(view["total_samples"])
        out["render_opacity"] = float(view["opacity"].max())
        del one
    del dp
    torch.cuda.empty_cache()
    dist.destroy_process_group()

    # the --distributed CLI over localhost TCP, validating round-robin
    os.chdir(workdir)
    clear_counts()
    t = time.perf_counter()
    metrics = train_cli.main([
        "--config", _repo_file(CLI_CONFIG), "--steps_per_epoch",
        str(PARALLEL_CLI_STEPS), "--distributed", "--coordinator_address",
        f"localhost:{cli_port}", "--num_processes", str(PARALLEL_RANKS),
        "--process_id", str(rank)], device=DEVICE)
    out["cli_s"] = time.perf_counter() - t
    out["cli_metrics"] = metrics
    out["cli_launches"] = {k: v for k, v in launch_counts().items() if v}
    dist.destroy_process_group()
    queue.put(out)


def phase_parallel():
    """Data parallelism at bench.py's width with --num_gpus semantics:
    PARALLEL_RANKS processes on the one card, joined over gloo (NCCL
    refuses two ranks on one card), BATCH / PARALLEL_RANKS rays each of
    the global batch: (a) f32 at a non-binding budget (capacity = samples
    a ray = 24), the first step's mean loss to rtol 1e-4 of one process's
    on the same global batch and draws and its averaged gradients to
    1e-4 of each leaf's largest value, the ranks' parameters bitwise
    equal after PARALLEL_STEPS steps; (b) the bench's binding budget
    (48 / 24, bf16), each step's loss to rtol 5e-3 of one process's
    (JAX's bound for the binding case), rank 0's first-step kernel
    launches against their plain versions at phase "train"'s tolerances,
    launches a step per rank; the sharded 256x256 view against one
    process's at rtol 1e-4, atol 1e-5; then `train.main` with
    --distributed over localhost TCP for PARALLEL_CLI_STEPS steps of
    configs/synthetic_smoke.txt, validating round-robin. Prints the
    global rays/s, step ms, all-reduce ms a step and peak memory per
    rank. A rank that fails fails the phase."""
    import tempfile
    import numpy as np
    import torch.multiprocessing as mp
    t = time.time()
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    with tempfile.TemporaryDirectory() as workdir:
        mp.start_processes(_parallel_rank,
                           args=(_free_port(), _free_port(), workdir, queue),
                           nprocs=PARALLEL_RANKS, join=True,
                           start_method="spawn")
        outs = sorted((queue.get() for _ in range(PARALLEL_RANKS)),
                      key=lambda o: o["rank"])
    r0 = outs[0]
    log(f"parallel: {PARALLEL_RANKS} ranks over {r0['backend']} on "
        f"{[o['device'] for o in outs]}; NCCL across cards not measured "
        f"(one card)")
    log(f"parallel (a) f32, capacity 24 = samples a ray: step 1 loss "
        f"{r0['a_loss'][0]:.8f} vs one process {r0['a_loss'][1]:.8f}; "
        f"averaged gradients within {r0['a_grad_worst']:.3g} of each "
        f"leaf's largest value; parameters after {PARALLEL_STEPS} steps "
        f"bitwise equal on the ranks (sha256 {r0['a_digest']})")
    log(f"parallel (b) bench 48 / 24 bf16: losses {r0['b_losses']} vs one "
        f"process {r0['b_ref_losses']}")
    for o in outs:
        timed = o["b_step_ms"][1:]
        step = float(np.mean(timed)) if timed else float("nan")
        log(f"parallel (b) rank {o['rank']}: step ms {o['b_step_ms']} "
            f"(steps 2-{PARALLEL_STEPS}: {step:.1f} ms, "
            f"{BATCH / step * 1e3:,.0f} global rays/s), all-reduce ms "
            f"{[round(v, 1) for v in o['b_reduce_ms']]}, peak "
            f"{o['peak_gib']:.2f} GiB, launches a step "
            f"{o['b_launches_per_step']}")
        check_launched(o["b_launches_per_step"], f"parallel rank "
                                                  f"{o['rank']}")
    log(f"parallel render: 256x256 view split over the ranks, "
        f"{r0['render_samples']} samples, max opacity "
        f"{r0['render_opacity']:.4f}, rgb within {r0['render_err']:.3g} of "
        f"one process's; {r0['render_ms']:.1f} ms")
    m = [o["cli_metrics"] for o in outs]
    if m[0] != m[1] or not all(np.isfinite(list(m[0].values()))):
        raise AssertionError(f"parallel cli: the ranks' metrics {m}")
    log(f"parallel cli: --distributed, {PARALLEL_CLI_STEPS} steps of "
        f"{CLI_CONFIG}, validated round-robin: {m[0]} on both ranks; "
        f"{r0['cli_s']:.1f} s; rank 0 launches {r0['cli_launches']}")
    log(f"parallel: {time.time() - t:.1f} s")
    return r0["checks"]


# --------------------------------------------------------------- profile

PROFILE_FIT_STEPS = 32


def profile_fit(system):
    """`fit` for PROFILE_FIT_STEPS steps with hparams.profile_dir set: the
    Chrome trace must hold 10 "train_step" ranges (steps 20-29 after the
    first) and name the K1, K2 and K3 kernels."""
    import os
    import tempfile
    h = system.hparams
    total = system.total_steps
    with tempfile.TemporaryDirectory() as d:
        h.profile_dir = d
        system.total_steps = system.global_step + PROFILE_FIT_STEPS
        t = time.time()
        try:
            system.fit(log_every=0)
        finally:
            system.total_steps = total
            h.profile_dir = None
        path = os.path.join(d, "trace.json")
        size = os.path.getsize(path)
        with open(path) as f:
            trace = json.load(f)["traceEvents"]
        # the host's ranges (a CUDA trace adds a gpu_user_annotation
        # event of the same name for each)
        spans = sum(e.get("name") == "train_step"
                    and e.get("cat") == "user_annotation" for e in trace)
        names = {e.get("name", "") for e in trace if e.get("cat") == "kernel"}
    kernels = {k: sum(k in n for n in names) for k in (
        "ray_reduce_fwd_kernel", "ray_reduce_bwd_kernel",
        "brick_reduce_fwd_kernel", "brick_reduce_bwd_kernel",
        "composite_fwd_kernel", "composite_bwd_kernel")}
    log(f"train profile: fit of {PROFILE_FIT_STEPS} steps with profile_dir "
        f"in {time.time() - t:.1f} s; {path} (deleted after), "
        f"{size / 2 ** 20:.1f} MiB, {len(trace)} events, {spans} "
        f"train_step ranges, kernel names {kernels}")
    if spans != 10:
        raise AssertionError(f"profile: {spans} train_step ranges, not 10")
    missing = [k for k, n in kernels.items() if not n]
    if missing:
        raise AssertionError(f"profile: no {missing} in the trace")


def kernel_rows(render_errs, train_checks, other_checks, launches, probes,
                probe_launches):
    """The kernels line: each kernel's launches in the timed training
    steps, its largest error over every variant checked (render,
    training, the features phase and the quality gate: other_checks,
    {kernel: {variant: numbers}}), and the time and bound of its
    PRIMARY training variant (K2 bwd's on step LATE_STEP's launch);
    then each probe kernel, its launches in the probes phase (per
    training step: 0), its largest error over its variants and the
    numbers of its PROBES variant."""
    rows = []
    for name, (_, source, replaces) in KERNELS.items():
        checks = train_checks[name]
        err = max([c["max_abs_err"] for c in checks.values()]
                  + [c["max_abs_err"]
                     for c in other_checks.get(name, {}).values()]
                  + [render_errs.get(name, 0.0)])
        p = checks.get(f"step {LATE_STEP}, {PRIMARY[name]}",
                       checks[PRIMARY[name]])
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "launches_per_train_step":
                         launches[name] / STEPS_MEASURE,
                     "max_abs_err": err, "ms": p["ms"],
                     "graph_ms": p["graph_ms"],
                     "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
                     "bound_by": p["bound_by"], "library_ms": None})
    for name, (_, _, source, replaces, primary) in PROBES.items():
        p = probes[name][primary]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": probe_launches[name],
                     "launches_per_train_step":
                         launches[name] / STEPS_MEASURE,
                     "max_abs_err": max(r["max_abs_err"]
                                        for r in probes[name].values()),
                     "ms": p["ms"], "plain_ms": p["plain_ms"],
                     "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
                     "library_ms": p["library_ms"]})
    return rows


def pos_kernel_row(checks, launches, per_step):
    """The kernels line row of the K2 backward's position-cotangent
    variant: its launches in phase "kitti"'s stream-brick pose-refinement
    steps (or phase "fused"'s), its largest error over the variants
    checked, and the numbers of its density-table variant (else its
    first), with the position cotangent's added cost over row 4 alone
    and that cost's bound."""
    p = checks.get("kitti ext, density table, jac",
                   next(iter(checks.values())))
    name, _, source, replaces = POS_KERNEL
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "launches_per_train_step": per_step,
            "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
            "ms": p["ms"], "graph_ms": p["graph_ms"],
            "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
            "bound_by": p["bound_by"], "library_ms": None,
            "added_ms": p["added_ms"],
            "added_bound_ms": p["added_bound_ms"]}


def fused_kernel_rows(checks, launches):
    """The kernels line rows of the F = 16 launches (phase "fused"): each
    K1 / K2 kernel's launches in the phase's timed steps, its largest
    error over the variants of the phase's first step and the numbers of
    its FUSED_ROWS variant; K2's position-cotangent variant with its
    launches in the phase's second pose-refinement step."""
    rows = []
    for name, (kernel, tag) in FUSED_ROWS.items():
        _, source, replaces = KERNELS[kernel]
        c = checks[kernel]
        p = c[f"fused, {tag}"]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "launches_per_train_step":
                         launches[name] / FUSED_MEASURE,
                     "max_abs_err": max(v["max_abs_err"]
                                        for v in c.values()),
                     "ms": p["ms"], "graph_ms": p["graph_ms"],
                     "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
                     "bound_by": p["bound_by"], "library_ms": None})
    pos = f"{POS_KERNEL[0]}, F 16"
    row = pos_kernel_row(checks[POS_KERNEL[0]], launches[pos],
                         launches[pos])
    rows.append({**row, "name": pos})
    return rows


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    import ingp_tpu_torch  # noqa: F401  (fails outside the repository)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, count, smi = phase_device()
    phase_build()
    if "--reference-spread" in argv:
        reference_spread()
        return 0
    phase_native()
    system, ds, recs, plan = phase_render(bench_hparams())
    render_errs = phase_kernels(recs, plan, system.model_cfg)
    del recs, plan
    phase_reference()
    train_system, train_checks, launches, train_stats = phase_train(
        bench_hparams())
    feature_checks = phase_features(train_stats)
    fused_checks, fused_launches = phase_fused(train_system, train_stats)
    phase_train_reference()
    parallel_checks = phase_parallel()
    probes, probe_launches = phase_probes()
    phase_cli()
    phase_utility()
    quality_checks, _ = phase_quality()
    data_checks, offline_checks = phase_data()
    kitti_checks, pos_launches = phase_kitti()
    mega_checks = phase_mega()
    if "--profile" in argv:
        phase_profile(system, ds, train_system)
    log(f"done in {time.time() - T0:.1f} s")
    other_checks = {k: {**quality_checks.get(k, {}),
                        **feature_checks.get(k, {}),
                        **(fused_checks.get(k, {}) if k.startswith(
                            "composite") else {}),
                        **data_checks.get(k, {}),
                        **offline_checks.get(k, {}),
                        **mega_checks.get(k, {}),
                        **parallel_checks.get(k, {})} for k in KERNELS}
    rows = kernel_rows(render_errs, train_checks, other_checks, launches,
                       probes, probe_launches)
    rows.append(pos_kernel_row(kitti_checks[POS_KERNEL[0]], *pos_launches))
    rows += fused_kernel_rows(fused_checks, fused_launches)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
