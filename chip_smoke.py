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
   spheres. A first render captures each kernel's first full-width
   inputs; the launch counts are then reset and a second render is
   timed and counted;
4. kernels: K1, K2 and K3 on the captured inputs against their plain
   PyTorch versions, with times (CUDA events) and the bytes bound;
5. reference: a small configuration rendered on the card (kernels) and
   on the CPU (plain versions) from the same parameters must agree;
6. the kernels JSON line, then the result line.

With --profile, a torch.profiler pass over one more render prints the
CUDA time per kernel name (not part of the check).

Exits non-zero, printing no result line, when CUDA is unavailable or any
check fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from types import SimpleNamespace

T0 = time.time()

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 non-tensor flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def log(msg: str) -> None:
    print(f"[{time.time() - T0:8.2f}s] {msg}", flush=True)


def bench_hparams(**kw):
    """The bench.py defaults that shape the model and the test render."""
    h = dict(dataset_name="synthetic", scale=0.5, use_skybox=False,
             use_exposure=False, embed_a=False, embed_a_len=4,
             num_classes=7, chunk_size=131072, compute_dtype="bfloat16",
             capacity=48, march_iters=1024, samples_per_ray=24,
             encoder="brick", table_dtype="bfloat16", encode_chunk=196608,
             stream_dedup=True, stream_tile=256, stream_seg=4,
             stream_slack=1.5, stream_direct_frac=0.7)
    h.update(kw)
    return SimpleNamespace(**h)


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


def max_err(outs, refs) -> tuple[float, float]:
    """(max |out - ref|, max |ref|) over matching tensors."""
    err = scale = 0.0
    for a, b in zip(outs, refs):
        if b is None:
            continue
        err = max(err, float((a.float() - b.float()).abs().max()))
        scale = max(scale, float(b.float().abs().max()))
    return err, scale


class Recorder:
    """Stands in for a function in the module that calls it, passes every
    call through, and keeps the arguments and the result of the first
    call that `want` accepts."""

    def __init__(self, module, name, want):
        self.module, self.name, self.want = module, name, want
        self.fn = getattr(module, name)
        self.args = self.result = None
        setattr(module, name, self)

    def __call__(self, *args, **kw):
        out = self.fn(*args, **kw)
        if self.args is None and self.want(args, kw):
            self.args, self.result = (args, kw), out
        return out

    def restore(self):
        setattr(self.module, self.name, self.fn)


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
    import torch
    from ingp_tpu_torch.data.synthetic import (SyntheticDataset,
                                               sphere_density_grid)
    from ingp_tpu_torch.grid.occupancy import grid_from_density
    from ingp_tpu_torch.training.trainer import NeRFSystem
    ds = SyntheticDataset(split="test", img_size=img_size, n_test=1)
    system = NeRFSystem(h, ds, device=device, seed=seed)
    cfg = system.model_cfg
    dg = torch.as_tensor(sphere_density_grid(cfg.grid_size, cfg.cascades,
                                             cfg.scale), device=device)
    system.grid = grid_from_density(system.grid, dg, 0.5, cfg.grid_size,
                                    cfg.cascades)
    return ds, system


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


def nth_call(n):
    """A Recorder predicate that accepts the n-th call (from 0)."""
    seen = [0]

    def want(args, kw):
        seen[0] += 1
        return seen[0] == n + 1
    return want


def phase_render(h, img_size=256, device="cuda"):
    import torch
    from ingp_tpu_torch.kernels import brickreduce as k2
    from ingp_tpu_torch.kernels import composite as k3
    from ingp_tpu_torch.kernels import rayreduce as k1
    from ingp_tpu_torch.models import rendering as render_mod
    from ingp_tpu_torch.ops import composite as comp_mod
    from ingp_tpu_torch.ops import streambrick as sb_mod
    t = time.time()
    ds, system = make_system(h, img_size, device)
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
    recs = [
        Recorder(sb_mod, "fused_ray_reduce",
                 lambda a, kw: a[5] if len(a) > 5 else kw.get("with_jac")),
        Recorder(sb_mod, "brick_reduce",
                 lambda a, kw: a[4] if len(a) > 4 else kw.get("with_jac")),
        Recorder(comp_mod, "composite",
                 lambda a, kw: kw.get("rgbs") is not None),
        Recorder(render_mod, "compact_samples", nth_call(1)),
    ]
    t = time.time()
    system.render_image(ds.poses[0])
    torch.cuda.synchronize()
    for r in recs:
        r.restore()
    log(f"render: warm-up view {time.time() - t:.2f} s (inputs captured)")

    wrappers = {"fused_ray_reduce": k1.fused_ray_reduce,
                "brick_reduce": k2.brick_reduce, "composite": k3.composite}
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    out = system.render_image(ds.poses[0])
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = {k: w.launches for k, w in wrappers.items()}
    n_rays = ds.directions.shape[0]
    log(f"render: {n_rays} rays, total_samples {out['total_samples']}, "
        f"{wall * 1e3:.1f} ms wall, {n_rays / wall:.1f} rays/s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{launches}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched")
    miss, far = check_render(out, ds, system, n_rays)
    log(f"render: outputs finite; {miss} AABB-miss and {far} far rays "
        f"composite to zero; opacity mean "
        f"{float(out['opacity'].mean()):.4f}")
    return system, ds, recs, launches


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


def phase_kernels(recs, launches, cfg):
    """Each kernel against its plain version on the captured inputs."""
    import torch
    from ingp_tpu_torch.kernels import brickreduce as k2
    from ingp_tpu_torch.kernels import composite as k3
    from ingp_tpu_torch.kernels import rayreduce as k1
    from ingp_tpu_torch.ops.streambrick import _single_pad
    rows = []

    def report(name, source, replaces, fn, plain, views, nbytes, flops):
        """views(outputs) -> (compared, zeros): lists of (cells, channels)
        views of the outputs on the real cells that read a row, and on
        the real cells marked -9, which must be exact zeros."""
        out = fn()
        ref = plain()
        torch.cuda.synchronize()
        (cmp_o, zero_o), (cmp_r, zero_r) = views(out), views(ref)
        err, scale = max_err(cmp_o, cmp_r)
        tol = 1e-5 * scale + 1e-7
        for a, b in zip(zero_o, zero_r):
            if not (torch.equal(a, b) and not bool(a.any())):
                raise AssertionError(f"{name}: -9 cells are not exact "
                                     f"zeros")
        ms = cuda_ms(fn, 20)
        plain_ms = cuda_ms(plain, 3)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS * 1e3
        bound_ms = max(t_bytes, t_ops)
        log(f"kernel {name}: max_abs_err {err:.3e} (tol {tol:.3e}, max "
            f"|plain| {scale:.3e}); {ms:.4f} ms vs plain {plain_ms:.3f} ms;"
            f" bound {bound_ms:.4f} ms ({nbytes / 1e6:.2f} MB, "
            f"{flops / 1e9:.3f} GFLOP)")
        if not err <= tol:
            raise AssertionError(f"{name} disagrees with its plain version")
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms,
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations",
                     "library_ms": None})

    def check_marked(name, fn, lf, cells_of):
        """The -9 marker written into every 7th cell of a copy of lf:
        kernel and plain version give exact zeros there."""
        lfm = lf.clone()
        lfm[0:3].reshape(3, -1)[:, ::7] = -9.0
        outs = fn(lfm)
        for t in outs:
            if t is not None and bool(cells_of(t)[::7].any()):
                raise AssertionError(f"{name}: marked cells not zero")
        log(f"kernel {name}: -9 written into "
            f"{(lf[0].numel() + 6) // 7} cells reads as exact zeros")

    # the real samples of the captured stream chunk: the first render
    # chunk's second compaction keeps n_valid of its slots, and the
    # stream's first chunk holds the first Nc slots
    plan = recs[3].result
    n_valid = int(plan.n_valid)
    n_slots = plan.slot_valid.numel()
    Nc = cfg.encode_chunk if n_slots > cfg.encode_chunk else \
        n_slots + (-n_slots) % _single_pad(cfg.stream_tile, cfg.encode_chunk)

    # K1: (table, urows, uid, lf, F, with_jac, jac_lo, jac_hi)
    (table, urows, uid, lf, F, with_jac, jac_lo, jac_hi), _ = recs[0].args
    B, U = urows.shape
    K = uid.shape[1]
    Tt = Nc // K
    if B % Tt:
        raise AssertionError(f"K1 batch {B} is no multiple of {Tt} tiles")
    Fj = (F if jac_hi is None else jac_hi) - jac_lo
    cells = B * K
    cell = torch.arange(cells, device=uid.device)
    sample = (cell // K) // (B // Tt) * K + cell % K
    real = sample < n_valid
    u = uid.reshape(-1).long()
    ok = _local_ok(lf) & (u >= 0) & (u < U)
    slot = (cell // K) * U + u.clamp(0, U - 1)
    n_pts = _corner_points(urows.reshape(-1)[slot], lf, ok)
    n_slots_read = int(torch.unique(slot[ok]).numel())
    log(f"kernel fused_ray_reduce: captured table {tuple(table.shape)} "
        f"{table.dtype}, urows {tuple(urows.shape)}, uid "
        f"{tuple(uid.shape)}, jac {with_jac}; {int(real.sum())} real "
        f"cells, {int((real & ~ok).sum())} of them -9; {n_slots_read} "
        f"slots and {n_pts} (row, point) pairs read")
    nbytes = (n_pts * F * table.element_size() + n_slots_read * 4
              + cells * 4 + cells * 4 * (6 + with_jac)
              + cells * 4 * (F + 3 * Fj * with_jac))
    flops = int(ok.sum()) * 8 * (F + 3 * Fj * with_jac) * 2

    def k1_cells(t):
        return t.reshape(t.shape[0], -1).T

    report("fused_ray_reduce", "ingp_tpu_torch/kernels/csrc/rayreduce.cu",
           "ingp_tpu/ops/pallas/rayreduce_pallas.py:232",
           lambda: k1.fused_ray_reduce(table, urows, uid, lf, F, with_jac,
                                       jac_lo, jac_hi),
           lambda: k1.fused_ray_reduce_plain(table, urows, uid, lf, F,
                                             with_jac, jac_lo, jac_hi),
           lambda o: ([k1_cells(t)[real & ok] for t in o if t is not None],
                      [k1_cells(t)[real & ~ok] for t in o
                       if t is not None]),
           nbytes, flops)
    check_marked("fused_ray_reduce",
                 lambda m: (k1.fused_ray_reduce(table, urows, uid, m, F,
                                                with_jac, jac_lo, jac_hi)
                            + k1.fused_ray_reduce_plain(
                                table, urows, uid, m, F, with_jac, jac_lo,
                                jac_hi)),
                 lf, k1_cells)

    # K2: (table, rows, lf, F, with_jac, jac_lo, jac_hi)
    (table, rws, lf2, F, with_jac, jac_lo, jac_hi), _ = recs[1].args
    Lw, Nn = rws.shape
    if Nn != Nc:
        raise AssertionError(f"K2 captured {Nn} samples, expected {Nc}")
    Fj = (F if jac_hi is None else jac_hi) - jac_lo
    cells = Lw * Nn
    real2 = (torch.arange(Nn, device=rws.device) < n_valid).repeat(Lw)
    r = rws.reshape(-1)
    ok2 = _local_ok(lf2) & (r >= 0) & (r < table.shape[0])
    n_pts = _corner_points(rws, lf2, ok2)
    log(f"kernel brick_reduce: captured table {tuple(table.shape)} "
        f"{table.dtype}, rows {tuple(rws.shape)}, jac {with_jac}; "
        f"{int(real2.sum())} real cells, {int((real2 & ~ok2).sum())} of "
        f"them -9; {int(torch.unique(r[ok2]).numel())} distinct rows and "
        f"{n_pts} (row, point) pairs read")
    nbytes = (n_pts * F * table.element_size() + cells * 4
              + cells * 4 * (6 + with_jac)
              + cells * 4 * (F + 3 * Fj * with_jac))
    flops = int(ok2.sum()) * 8 * (F + 3 * Fj * with_jac) * 2

    def k2_cells(o):
        f = o[0].reshape(Nn, Lw, F).transpose(0, 1).reshape(cells, F)
        if o[1] is None:
            return [f]
        return [f, o[1].reshape(3, Nn, Lw, Fj).permute(2, 1, 0, 3)
                .reshape(cells, 3 * Fj)]

    report("brick_reduce", "ingp_tpu_torch/kernels/csrc/brickreduce.cu",
           "ingp_tpu/ops/pallas/brickreduce_pallas.py:190",
           lambda: k2.brick_reduce(table, rws, lf2, F, with_jac, jac_lo,
                                   jac_hi),
           lambda: k2.brick_reduce_plain(table, rws, lf2, F, with_jac,
                                         jac_lo, jac_hi),
           lambda o: ([t[real2 & ok2] for t in k2_cells(o)],
                      [t[real2 & ~ok2] for t in k2_cells(o)]),
           nbytes, flops)
    check_marked("brick_reduce",
                 lambda m: (k2_cells(k2.brick_reduce(
                     table, rws, m, F, with_jac, jac_lo, jac_hi))
                     + k2_cells(k2.brick_reduce_plain(
                         table, rws, m, F, with_jac, jac_lo, jac_hi))),
                 lf2, lambda t: t)

    # K3: (sigmas, deltas, ts, valid, thr) + rgbs/aux keywords
    args, kw = recs[2].args
    sig = args[0]
    R, S = sig.shape
    C = kw["aux"].shape[0] if kw.get("aux") is not None else 0
    log(f"kernel composite: captured sigmas {tuple(sig.shape)}, aux "
        f"channels {C}")
    counts = (k3.composite(*args, **kw)["count"],
              k3.composite_plain(*args, **kw)["count"])
    if not torch.equal(*counts):
        raise AssertionError("composite: sample counts differ from plain")
    nbytes = R * S * (4 * 3 + 1 + 4 * 3 + 4 * C + 4) + R * 4 * (2 + 3 + C + 1)
    flops = R * S * (12 + 2 * (3 + C))
    report("composite", "ingp_tpu_torch/kernels/csrc/composite.cu",
           "ingp_tpu/ops/pallas/composite_pallas.py:110",
           lambda: k3.composite(*args, **kw),
           lambda: k3.composite_plain(*args, **kw),
           lambda o: ([v.reshape(R, -1) for k, v in o.items()
                       if k != "count"], []),
           nbytes, flops)
    return rows


def phase_reference():
    """A small configuration on the card (kernels) and on the CPU (plain
    versions) from the same parameters."""
    import numpy as np
    import torch
    from ingp_tpu_torch.models.ngp import params_from_numpy, params_to_numpy
    small = dict(density_L=4, rgb_L=4, density_log2T=12, rgb_log2T=12,
                 grid_size=32, encode_chunk=4096, compute_dtype="float32",
                 table_dtype="float32")
    ds, gpu = make_system(bench_hparams(**small), 16, "cuda", seed=3)
    for k in ("density_table", "rgb_table"):
        gpu.params[k] = gpu.params[k] * 1e3
    _, cpu = make_system(bench_hparams(**small), 16, "cpu")
    cpu.params = params_from_numpy(params_to_numpy(gpu.params), "cpu")
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


def phase_profile(system, ds):
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        system.render_image(ds.poses[0])
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=25, max_name_column_width=60)
    for line in table.splitlines():
        log(f"  prof: {line}")


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
    system, ds, recs, launches = phase_render(bench_hparams())
    rows = phase_kernels(recs, launches, system.model_cfg)
    phase_reference()
    if "--profile" in argv:
        phase_profile(system, ds)
    log(f"done in {time.time() - T0:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
