"""What the probes share: a variant's case (its kernel, its plain version,
the library call beside it and the bytes it must move), the check of a
kernel against its plain version, CUDA-event timing and the bound."""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Callable

import torch

from ..device import resolve_device
from ..kernels import build

CUDA = torch.device("cuda")

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 non-tensor flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# kernel against plain: "equal" (a gather is a copy: bitwise), "fwd"
# (K1's forward tolerance, 1e-5 of the largest |value| + 1e-7) or "bwd"
# (K1's backward tolerance, 1e-5 of the largest |value| + 1e-12: only
# the order of f32 sums differs)
ATOL = {"fwd": 1e-7, "bwd": 1e-12}


@dataclass
class Case:
    """One variant of a probe on inputs already on its device.

    kernel(), plain() and library() each compute the variant's outputs
    (a tensor or a tuple of tensors; library() may compute something
    else, see `library_name`); `rows` and `row_bytes` give the useful
    gathered bytes where the probe reports a rate per row. `timed`, where
    given, is what the kernel's time is taken of (kernel() may also
    clear and copy its outputs for the comparison). `symbol` is the
    launcher (`kernels.build.LAUNCHES` key) kernel() must reach on the
    card. `graph`: also time
    the kernel and the library call replayed from a CUDA graph, which
    leaves out the host's dispatch of each call (for launch-bound
    variants). `launch`, where given: on the card, the kernel's launch
    (grid, threads, cluster) as a dict."""
    probe: str
    variant: str
    kernel: Callable
    plain: Callable
    library: Callable | None
    library_name: str
    nbytes: float
    flops: float
    tol: str
    symbol: str
    rows: int = 0
    row_bytes: int = 0
    timed: Callable | None = None
    graph: bool = False
    launch: Callable | None = None


def _flat(out):
    return [t for t in (out if isinstance(out, (tuple, list)) else (out,))
            if t is not None]


def bound_of(nbytes, flops):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the HBM rate and the f32 operations over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def compare(case: Case):
    """Run the kernel and its plain version once each and hold them to
    the case's tolerance. Returns (max |kernel - plain|, max |plain|);
    raises AssertionError on a mismatch."""
    out = _flat(case.kernel())
    ref = _flat(case.plain())
    if len(out) != len(ref):
        raise AssertionError(f"{case.probe} [{case.variant}]: "
                             f"{len(out)} outputs vs {len(ref)}")
    err = scale = 0.0
    for a, b in zip(out, ref):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{case.probe} [{case.variant}]: "
                                 f"{a.shape} {a.dtype} vs {b.shape} "
                                 f"{b.dtype}")
        if case.tol == "equal" and not torch.equal(a, b):
            raise AssertionError(f"{case.probe} [{case.variant}]: not "
                                 f"bitwise equal to its plain version")
        if a.dtype.is_floating_point:
            a, b = a.float(), b.float()
        else:
            a, b = a.long(), b.long()
        err = max(err, float((a - b).abs().max()))
        scale = max(scale, float(b.abs().max()))
    if case.tol != "equal" and not err <= 1e-5 * scale + ATOL[case.tol]:
        raise AssertionError(f"{case.probe} [{case.variant}]: max_abs_err "
                             f"{err:.3e} > 1e-5 * {scale:.3e} + "
                             f"{ATOL[case.tol]:g}")
    return err, scale


def time_ms(fn, iters: int, device) -> float:
    """Median milliseconds of fn(): CUDA events on the card, the host
    clock on the CPU, after one untimed call."""
    fn()
    if device.type != "cuda":
        times = []
        for _ in range(iters):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        return sorted(times)[len(times) // 2]
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def graph_ms(fn, launches: int = 20, iters: int = 5) -> float:
    """Median milliseconds per call of fn() replayed from a CUDA graph
    of `launches` calls: the device's time without the host's dispatch."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    return time_ms(g.replay, iters, CUDA) / launches


def floor_ms() -> float:
    """The launch floor: milliseconds per call of a one-element zero_()
    replayed from a CUDA graph, the least any graphed launch takes."""
    z = torch.empty(1, device=CUDA)
    return graph_ms(z.zero_)


def dispatch_ms(fn, calls: int = 100, iters: int = 5) -> float:
    """Median host milliseconds per call of fn() over `calls` calls made
    back to back while the device runs behind: the host's dispatch of a
    call (Python, allocation, launch) without the device's time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t) * 1e3 / calls)
        torch.cuda.synchronize()
    return sorted(times)[len(times) // 2]


def measure(case: Case, iters: int, plain_iters: int = 0,
            floor: float | None = None) -> dict:
    """On the card: check the kernel against its plain version (raising
    if kernel() launched no `case.symbol` there), then time the kernel
    and the library call (and the plain version when plain_iters > 0).
    The numbers of a kernels-line row; `check_launches` counts the
    launches the check made. A graphed case also carries `floor`
    (`floor_ms()`, taken once per phase by the caller) as floor_ms, and
    the host's dispatch of the kernel and the library call."""
    n0 = build.LAUNCHES[case.symbol]
    err, scale = compare(case)
    checked = build.LAUNCHES[case.symbol] - n0
    if checked <= 0:
        raise AssertionError(f"{case.probe} [{case.variant}]: "
                             f"{case.symbol} was not launched")
    ms = time_ms(case.timed or case.kernel, iters, CUDA)
    lib = time_ms(case.library, iters, CUDA) if case.library else None
    plain = time_ms(case.plain, plain_iters, CUDA) if plain_iters \
        else None
    bound, by = bound_of(case.nbytes, case.flops)
    r = {"max_abs_err": err, "max_abs_plain": scale, "ms": ms,
         "plain_ms": plain, "bound_ms": bound, "bound_by": by,
         "library_ms": lib, "check_launches": checked}
    if case.graph:
        r["graph_ms"] = graph_ms(case.timed or case.kernel)
        r["library_graph_ms"] = graph_ms(case.library)
        r["floor_ms"] = floor
        r["dispatch_ms"] = dispatch_ms(case.timed or case.kernel)
        r["library_dispatch_ms"] = dispatch_ms(case.library)
    return r


def line(case: Case, r: dict) -> str:
    """One printed line of a variant's numbers."""
    s = (f"{case.probe} [{case.variant}]: {r['ms']:.4f} ms, bound "
         f"{r['bound_ms']:.4f} ms ({r['bound_by']}, "
         f"{case.nbytes / 1e6:.2f} MB)")
    if case.rows:
        s += (f", {r['ms'] * 1e6 / case.rows:.3f} ns/row, "
              f"{case.rows * case.row_bytes / r['ms'] / 1e6:.1f} GB/s "
              f"useful")
    if r["library_ms"] is not None:
        s += f"; library {case.library_name} {r['library_ms']:.4f} ms"
    if "graph_ms" in r:
        s += (f"; from a CUDA graph {r['graph_ms']:.4f} ms, library "
              f"{r['library_graph_ms']:.4f} ms")
        if r.get("floor_ms") is not None:
            s += f", floor {r['floor_ms']:.4f} ms"
        s += (f"; host dispatch {r['dispatch_ms']:.4f} ms, library "
              f"{r['library_dispatch_ms']:.4f} ms")
    if r["plain_ms"] is not None:
        s += f"; plain {r['plain_ms']:.3f} ms"
    return s + (f"; max_abs_err {r['max_abs_err']:.3e} (max |plain| "
                f"{r['max_abs_plain']:.3e}, {case.tol})")


def parse_args(argv, doc: str):
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain versions only)")
    ap.add_argument("--iters", type=int, default=10,
                    help="timed runs per variant (median)")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    a.device = resolve_device(a.device)
    return a


def gpu_label() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def run(cases, device, iters: int) -> list:
    """Print one line per case. On the card: each kernel checked against
    its plain version, then timed beside its bound and library call (and
    the launch floor, measured once); returns [(case, numbers)]. On the
    CPU: the plain versions only, timed on the host clock."""
    if device.type == "cuda":
        print(f"device: {gpu_label()}", flush=True)
        floor = floor_ms()
        out = []
        for c in cases:
            r = measure(c, iters, floor=floor)
            print(line(c, r), flush=True)
            out.append((c, r))
        return out
    for c in cases:
        ms = time_ms(c.plain, 1, device)
        print(f"{c.probe} [{c.variant}]: plain version on the CPU "
              f"{ms:.1f} ms (host clock; no kernel runs on the CPU)",
              flush=True)
    return []
