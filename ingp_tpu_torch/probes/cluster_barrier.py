"""The flat cluster gather's last barrier: what keeping a block's part of
the table alive costs.

`take_flat(..., "cluster")` (kernels/csrc/probe_gather.cu,
flat_cluster_kernel) ends on `cluster.sync()`, so that no block exits
while another still reads its part through distributed shared memory.
That barrier's arrive has release semantics. This probe builds
probe_gather.cu again with the barrier in other forms, each its own
library beside the kernels' own under kernels/_build/, and times op 2
from CUDA graphs in alternating rounds, beside flat indexing:

  sync           the shipped `cluster.sync()`;
  relaxed        `barrier.cluster.arrive.relaxed` + wait: no release, so
                 the remote reads are kept ahead of the arrive only by
                 in-order execution and their values' use in earlier
                 stores, not by the PTX memory model;
  split          a release arrive right after the last reads, then the
                 last stores, then the wait;
  relaxed, ex    relaxed, with the cluster size given at launch
                 (`cudaLaunchKernelEx`) instead of `__cluster_dims__`.

Each build is first held bitwise to `take_flat_plain` at the probe's
shape, a ragged one, one whose ids take two passes of the grid, and the
largest table. Run on the card:
python -m ingp_tpu_torch.probes.cluster_barrier
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ..kernels import build
from . import common
from .gather_layouts import OPS, flat_limit, take_flat_plain

_LOOP = """  while (g < G) {
    reinterpret_cast<int4*>(out)[g] =
        make_int4(flat_at(cluster, slice, part, T, v.x),
                  flat_at(cluster, slice, part, T, v.y),
                  flat_at(cluster, slice, part, T, v.z),
                  flat_at(cluster, slice, part, T, v.w));
    g += stride;
    if (g < G) v = idx4[g];
  }
  if (blockIdx.x == 0)
    for (int64_t j = 4 * G + threadIdx.x; j < M; j += kFlatThreads)
      out[j] = flat_at(cluster, slice, part, T, idx[j]);
"""
_SYNC = ("  cluster.sync();  // keep this part alive while the other "
         "blocks read it\n")
_RELAXED = """  asm volatile("barrier.cluster.arrive.relaxed.aligned;"
               ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
"""
_SPLIT = """  int4* out4 = reinterpret_cast<int4*>(out);
  int4 r = make_int4(0, 0, 0, 0);
  int64_t last = -1;
  while (g < G) {
    r = make_int4(flat_at(cluster, slice, part, T, v.x),
                  flat_at(cluster, slice, part, T, v.y),
                  flat_at(cluster, slice, part, T, v.z),
                  flat_at(cluster, slice, part, T, v.w));
    last = g;
    g += stride;
    if (g < G) {
      out4[last] = r;
      last = -1;
      v = idx4[g];
    }
  }
  const int64_t j = 4 * G + threadIdx.x;
  const bool tail = blockIdx.x == 0 && j < M;
  const int x = tail ? flat_at(cluster, slice, part, T, idx[j]) : 0;
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  if (last >= 0) out4[last] = r;
  if (tail) out[j] = x;
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
"""
_DIMS = ("__global__ void __cluster_dims__(8, 1, 1) "
         "__launch_bounds__(kFlatThreads)")
_LAUNCH = """      if (e == cudaSuccess)
        flat_cluster_kernel<<<grid, p.threads, p.smem, s>>>(
            tb, (int)T, (int)p.part, ix, o, M);
"""
_LAUNCH_EX = """      if (e == cudaSuccess) {
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = grid;
        cfg.blockDim = dim3(p.threads);
        cfg.dynamicSmemBytes = (size_t)p.smem;
        cfg.stream = s;
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = (unsigned)p.cluster;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        e = cudaLaunchKernelEx(&cfg, flat_cluster_kernel, tb, (int)T,
                               (int)p.part, ix, o, M);
      }
"""
# each variant: (old, new) replacements in probe_gather.cu
VARIANTS = {
    "sync": [],
    "relaxed": [(_SYNC, _RELAXED)],
    "split": [(_LOOP + _SYNC, _SPLIT)],
    "relaxed, ex": [(_SYNC, _RELAXED),
                    (_DIMS, "__global__ void __launch_bounds__(kFlatThreads)"),
                    (_LAUNCH, _LAUNCH_EX)],
}
CHECK_SHAPES = ((65_536, (256, 128)), (65_537, (37, 3)),
                (100_003, (4096, 129)), (flat_limit("cluster"), (256, 128)))


def source(variant: str) -> str:
    """probe_gather.cu with the flat cluster's last barrier as `variant`;
    raises if the kernel no longer holds the text a variant replaces."""
    text = (build.CSRC / "probe_gather.cu").read_text()
    for old, new in VARIANTS[variant]:
        if text.count(old) != 1:
            raise ValueError(f"{variant}: probe_gather.cu no longer holds "
                             f"{old.splitlines()[0].strip()!r} once")
        text = text.replace(old, new)
    return text


def _library(variant: str):
    """The launcher of `variant`'s build (one nvcc call)."""
    name = variant.replace(", ", "_")
    src = build.BUILD_DIR / f"cluster_barrier_{name}.cu"
    lib = src.with_suffix(".so")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(source(variant))
    res = subprocess.run(
        [build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         f"-I{build.CSRC}", "-o", str(lib), str(src)],
        capture_output=True, text=True, timeout=build.NVCC_TIMEOUT_S)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {variant}:\n{res.stderr}")
    fn = ctypes.CDLL(str(lib)).ingp_probe_gather
    fn.argtypes = build.SIGNATURES["probes"]["ingp_probe_gather"]
    fn.restype = ctypes.c_int
    return fn


def _take(fn, flat, idx):
    out = torch.empty_like(idx)
    rc = fn(OPS["cluster"], build.ptr(flat), 1, flat.numel(),
            build.ptr(idx), build.ptr(out), idx.shape[0], idx.shape[1],
            build.stream_of(flat.device))
    if rc:
        raise RuntimeError(f"ingp_probe_gather: CUDA error {rc} at launch")
    return out


def main(argv=None):
    a = common.parse_args(sys.argv[1:] if argv is None else argv, __doc__)
    if a.device.type != "cuda":
        raise SystemExit("cluster_barrier: the card only (it builds CUDA)")
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        fns = dict(zip(VARIANTS, ex.map(_library, VARIANTS)))
    gen = torch.Generator(device=a.device).manual_seed(a.seed)

    def ids(T, shape, lo=0, hi=0):
        return torch.randint(lo, T + hi, shape, generator=gen,
                             device=a.device, dtype=torch.int32)

    for v, fn in fns.items():
        for T, shape in CHECK_SHAPES:
            flat = torch.arange(1, T + 1, dtype=torch.int32, device=a.device)
            i = ids(T, shape, -3, 3)
            if not torch.equal(_take(fn, flat, i), take_flat_plain(flat, i)):
                raise AssertionError(f"{v} at {T} entries, ids {shape}: "
                                     f"not bitwise equal to take_flat_plain")
    print(f"device: {common.gpu_label()}", flush=True)
    print(f"every build bitwise equal to take_flat_plain at "
          f"{CHECK_SHAPES}; launch floor {common.floor_ms():.5f} ms",
          flush=True)
    flat = torch.arange(65_536, dtype=torch.int32, device=a.device)
    i = ids(65_536, (256, 128))
    i64 = i.long()
    ms = {v: [] for v in VARIANTS}
    ms["flat indexing"] = []
    for rnd in range(7):
        for v in (list(VARIANTS) if rnd % 2 == 0
                  else list(reversed(VARIANTS))):
            ms[v].append(common.graph_ms(lambda f=fns[v]: _take(f, flat, i)))
        ms["flat indexing"].append(common.graph_ms(lambda: flat[i64]))
    for v, t in ms.items():
        print(f"cluster_barrier [{v}, 65536 -> (256, 128)]: graph ms median "
              f"{statistics.median(t):.5f} of {len(t)} rounds ("
              + " ".join(f"{x:.5f}" for x in t) + ")", flush=True)


if __name__ == "__main__":
    main()
