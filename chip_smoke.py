#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (ingp_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--profile]

Phases, each line flushed and stamped with elapsed seconds:

1. device: torch's device name and nvidia-smi's name and power limit;
2. build: one nvcc call compiles ingp_tpu_torch/kernels/csrc/*.cu;
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
   step's launches with the K2 bwd split's stubs;
7. train reference: one small training step on the card and on the CPU
   from the same parameters, batch and noise must agree;
8. probes: the probes' own path (ingp_tpu_torch/probes, the Hopper
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
9. cli: `ingp_tpu_torch.train.main` on configs/synthetic_smoke.txt at
   its own 500 steps of 2048 rays (the hash encoder, f32 tables, the
   sparsity prior), in a temporary working directory, with the launch
   counts set to 0 before it: the step time, the losses of the first and
   last 50 steps (finite and falling), the test PSNR (at most 1 dB under
   the JAX CLI's on the same config, JAX_CLI_PSNR) and SSIM; the
   checkpoints `last` and `last_slim` must exist, and `--ckpt_load last
   --val_only` must give the same PSNR and SSIM to 1e-6; then the hash
   encode, its jacobian and its table gradient on the card against the
   CPU, within 1e-5 of the largest value;
10. quality: the port's quality gate (`ingp_tpu_torch.quality_synthetic`
   at its defaults: 600 steps of 8192 rays over 100 views at 256 px,
   a stream of two chunks, the sparsity prior), with the launch counts
   set to 0 before it, and its RESULT line. The first step's K2 forward
   and backward launches of the sparsity prior, at (16, 16384), and K1
   forward and backward launches of the second stream chunk are held
   against their plain versions on the CPU, with times and bounds, as in
   phase 6; then a miss of the bar (novel PSNR >= 26.0, SSIM >= 0.865)
   fails the run;
11. the kernels JSON line (`launches`: the training window's count for
   the six package kernels, the probes phase's for the probe kernels;
   `launches_per_train_step` for all), then the result line.

With --profile, a torch.profiler pass over one more render and one more
training step prints the CUDA time per op and of each launch of the
port's kernels, and the step's backward nodes of K1/K2/K3 with the
sinks' zero fills (not part of the check).

Exits non-zero, printing no result line, when CUDA is unavailable or any
check fails.
"""
from __future__ import annotations

import collections
import inspect
import json
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


def record_kernels(cfg, names, keep=True):
    """Recorders on the wrappers of the kernels `names`, keyed by
    variant: the table a K1/K2 call reads (by its row count) and whether
    it has a jacobian; which outputs a K3 call makes. Calls are counted
    by variant and shape: K1's (batch rows, slots), K2's (levels,
    samples), K3's (rays, samples)."""
    from ingp_tpu_torch.kernels import brickreduce as k2
    from ingp_tpu_torch.kernels import composite as k3
    from ingp_tpu_torch.kernels import rayreduce as k1
    table = table_namer(cfg)

    def k3_fwd(a):
        v = "rgb and aux" if a["rgbs"] is not None else "weights"
        return v + (", Ts" if a["with_Ts"] else "")

    where = {
        "fused_ray_reduce": (k1, lambda a: table(a["table"],
                                                 a["with_jac"])),
        "brick_reduce": (k2, lambda a: table(a["table"], a["with_jac"])),
        "composite": (k3, k3_fwd),
        "fused_ray_reduce_bwd": (k1, lambda a: table(
            a["grad"], a["djac"] is not None)),
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
    from ingp_tpu_torch.kernels import build
    t = time.time()
    report = build.build_library()
    build.load_library()
    log(f"build: {len(build.sources())} sources, one nvcc call, "
        f"{time.time() - t:.2f} s -> {build.library_path().name}")
    # one line per kernel instantiation: registers and spill bytes
    name = spill = None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spill = line.split(",")[1].strip()
        elif "Used" in line and "registers" in line and name:
            regs = line.split("Used")[1].split(",")[0].strip()
            log(f"  ptxas: {name[:72]}: {regs}, {spill}")
            name = None


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


def k1_group_times(rec):
    """K1 forward at every level-group shape the first training step
    launched (the check above takes the first one of each variant): host
    and CUDA-graph ms beside the bound, on that shape's recorded
    arguments."""
    from ingp_tpu_torch.kernels import rayreduce as k1
    from ingp_tpu_torch.probes.common import graph_ms
    out = {}
    for (v, shape), a in sorted(rec.shapes.items()):
        fn = lambda a=a: k1.fused_ray_reduce(**a)   # noqa: E731
        ms, g = cuda_ms(fn, 20), graph_ms(fn)
        bound, _ = bound_of(*_k1_size(a)[:2])
        out[(v, shape)] = {"ms": ms, "graph_ms": g, "bound_ms": bound}
        log(f"kernel fused_ray_reduce [train, {v}] group {shape}: {ms:.4f} "
            f"ms, from a CUDA graph {g:.4f} ms, bound {bound:.4f} ms (graph "
            f"at {bound / g:.1%} of the bound)")
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


def k2b_size(a, tag):
    """(bytes, f32 operations) of K2 backward on arguments a, logged with
    how its cells share rows: the cells that read a row, those of them
    with a nonzero cotangent (live), and the runs, distinct (row, point)
    pairs and rows of the live cells."""
    rws, lf, F, dj = a["rows"], a["lf"], a["F"], a["djac"]
    Lw, Nn = rws.shape
    Fj = 0 if dj is None else dj.shape[2] // Lw
    r = rws.reshape(-1)
    ok = _local_ok(lf) & (r >= 0) & (r < a["grad"].shape[0])
    ct = a["dfeats"].reshape(Nn, Lw, F).abs().sum(-1)
    if dj is not None:
        ct = ct + dj.reshape(3, Nn, Lw, Fj).abs().sum((0, 3))
    live = ok & (ct.T.reshape(-1) != 0)
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
    log(f"kernel composite_bwd [{tag}]: sigmas {(R, S)}, aux channels {C}")
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
    return system, checks, launches


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
    noise and grid. f32 throughout; sums in other orders (atomics, cuBLAS
    against the CPU's matmul), so the loss is held to rtol 1e-5 and each
    gradient leaf to 1e-4 of its largest |value|, norm_net's to 1e-3 (it
    reaches the loss only through the Ref-NeRF term of the normalised
    density gradient, which amplifies rounding where that gradient is
    short)."""
    import numpy as np
    from ingp_tpu_torch.data.synthetic import SyntheticDataset
    from ingp_tpu_torch.training.trainer import NeRFSystem, tree_leaves
    h = bench_hparams(**SMALL, batch_size=512, samples_per_ray=16)
    tr = SyntheticDataset(split="train", img_size=32, n_train=4)
    gpu = NeRFSystem(h, tr, device=DEVICE, seed=3)
    for k in ("density_table", "rgb_table"):
        gpu.params["model"][k].data.mul_(1e3)
    cpu = NeRFSystem(h, tr, device="cpu", params=gpu.params_to_numpy())
    set_sphere_grid(gpu)
    set_sphere_grid(cpu)
    rng = np.random.default_rng(5)
    batch = tr.sample_batch(rng, 512)
    noise = rng.random(512, dtype=np.float32)
    aux_a, ga = gpu.loss_and_grads(batch, noise)
    aux_b, gb = cpu.loss_and_grads(batch, noise)
    la, lb = float(aux_a["loss"]), float(aux_b["loss"])
    if not abs(la - lb) <= 1e-5 * abs(lb):
        raise AssertionError(f"small step loss {la} (card) vs {lb} (cpu)")
    worst = {}
    for (path, a), (_, b) in zip(tree_leaves(ga), tree_leaves(gb)):
        scale = float(b.abs().max())
        rel = float((a.cpu() - b).abs().max()) / scale if scale else 0.0
        name = ".".join(str(x) for x in path)
        worst[name] = rel
        tol = 1e-3 if "norm_net" in path else 1e-4
        if not rel <= tol:
            raise AssertionError(f"small step gradient {name}: {rel} of "
                                 f"its largest value > {tol}")
    log(f"train reference: 512 rays, loss {la:.8f} (card) vs {lb:.8f} "
        f"(cpu); gradient leaves agree to "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in worst.items()})} "
        f"of their largest values")


# the JAX CLI's test PSNR on configs/synthetic_smoke.txt (`python -m
# ingp_tpu.train --config configs/synthetic_smoke.txt`, 500 steps, JAX on
# the CPU; PERF.md): the port's CLI run may land at most CLI_PSNR_SLACK dB
# below it
JAX_CLI_PSNR = 21.097
CLI_PSNR_SLACK = 1.0
CLI_CONFIG = "configs/synthetic_smoke.txt"


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
    dB under JAX_CLI_PSNR) and SSIM, the checkpoints `last` and
    `last_slim`, a `--ckpt_load last --val_only` run that must give the
    same metrics to 1e-6, and the hash encode on the card against the
    CPU. Returns the launch counts of the training run."""
    import os
    import tempfile
    import torch
    from ingp_tpu_torch import train as train_cli
    from ingp_tpu_torch.training.config import get_opts
    from ingp_tpu_torch.training.trainer import model_config_from_hparams
    from ingp_tpu_torch.utils.ckpt import load_ckpt
    config = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          CLI_CONFIG)
    argv = ["--config", config]
    h = get_opts(argv)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="ingp_cli_") as tmp:
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
        f"{metrics['ssim']:.4f} (JAX's CLI on the CPU: psnr {JAX_CLI_PSNR}); "
        f"--ckpt_load last --val_only: psnr {again['psnr']:.4f} ssim "
        f"{again['ssim']:.4f}")
    if not metrics["psnr"] >= JAX_CLI_PSNR - CLI_PSNR_SLACK:
        raise AssertionError(f"cli: test psnr {metrics['psnr']} more than "
                             f"{CLI_PSNR_SLACK} dB under {JAX_CLI_PSNR}")
    for k in ("psnr", "ssim"):
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
    from ingp_tpu_torch.probes import gather_layouts, kernel_split
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


def kernel_rows(render_errs, train_checks, quality_checks, launches, probes,
                probe_launches):
    """The kernels line: each kernel's launches in the timed training
    steps, its largest error over every variant checked (render,
    training and the quality gate), and the time and bound of its
    PRIMARY training variant (K2 bwd's on step LATE_STEP's launch);
    then each probe kernel, its launches in the probes phase (per
    training step: 0), its largest error over its variants and the
    numbers of its PROBES variant."""
    rows = []
    for name, (_, source, replaces) in KERNELS.items():
        checks = train_checks[name]
        err = max([c["max_abs_err"] for c in checks.values()]
                  + [c["max_abs_err"]
                     for c in quality_checks.get(name, {}).values()]
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
    system, ds, recs, plan = phase_render(bench_hparams())
    render_errs = phase_kernels(recs, plan, system.model_cfg)
    del recs, plan
    phase_reference()
    train_system, train_checks, launches = phase_train(bench_hparams())
    phase_train_reference()
    probes, probe_launches = phase_probes()
    phase_cli()
    quality_checks, _ = phase_quality()
    if "--profile" in argv:
        phase_profile(system, ds, train_system)
    log(f"done in {time.time() - T0:.1f} s")
    print(json.dumps({"kernels": kernel_rows(render_errs, train_checks,
                                             quality_checks, launches,
                                             probes, probe_launches)}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
