"""Build and load the port's CUDA kernels.

All `csrc/*.cu` sources are compiled by ONE `nvcc` call into a shared
library with a plain C interface, loaded with `ctypes`. No PyTorch
header is included, so the build takes seconds (a source that includes
`torch/extension.h` takes minutes to compile). The library lands in
`kernels/_build/` (git-ignored) under a name keyed by a hash of the
sources, so an edited source is rebuilt and an unchanged one is reused.

Nothing is built or loaded at import time: `load_library()` does it on
the first kernel launch.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_TIMEOUT_S = 600

_P, _I, _I64, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_float)
# every pointer and the stream are c_void_p: an undeclared argument is
# passed as a 32-bit int and the pointer is cut
_SIGNATURES = {
    "ingp_ray_reduce_fwd": [_P, _I, _I64, _P, _P, _P, _P, _P, _I64, _I, _I,
                            _I, _I, _I, _I, _I, _P],
    "ingp_brick_reduce_fwd": [_P, _I, _I64, _P, _P, _P, _P, _I, _I64, _I,
                              _I, _I, _I, _I, _P],
    "ingp_composite_fwd": [_P, _P, _P, _P, _P, _P, _I, _F, _I, _I, _P, _P,
                           _P, _P, _P, _P, _P, _P],
    "ingp_ray_reduce_bwd": [_P, _I64, _P, _P, _P, _P, _P, _I64, _I, _I, _I,
                            _I, _I, _I, _I, _I, _P],
    "ingp_brick_reduce_bwd": [_P, _I64, _P, _P, _P, _I64, _P, _I64, _I64,
                              _I, _I64, _I, _I, _I, _I, _I, _I, _I, _P],
    "ingp_composite_bwd": [_P, _P, _P, _P, _P, _P, _I, _F, _I, _I, _P, _P,
                           _P, _P, _P, _P, _P, _P, _P],
    "ingp_brick_reduce_bwd_pos": [_P, _I, _I64, _P, _P, _P, _I64, _P, _I64,
                                  _I64, _P, _I, _I64, _I, _I, _I, _I, _I,
                                  _P],
    # the probes' kernels (ingp_tpu_torch/probes)
    "ingp_probe_split_fwd": [_I, _I, _P, _I64, _P, _P, _P, _P, _P, _I64,
                             _I, _I, _P],
    "ingp_probe_split_bwd": [_I, _I, _P, _P, _I64, _P, _P, _P, _P, _P,
                             _I64, _I, _I, _P],
    "ingp_probe_split_k2": [_I, _I, _P, _I64, _P, _P, _P, _P, _I, _I64,
                            _P],
    "ingp_probe_split_k2b": [_I, _I, _I, _P, _P, _I64, _P, _P, _P, _P, _I,
                             _I64, _P],
    "ingp_probe_split_k3b": [_P, _P, _P, _P, _P, _P, _I, _F, _I, _I, _P,
                             _P, _P, _P, _P, _P, _P, _P, _P],
    "ingp_probe_split_k3f": [_P, _P, _P, _P, _P, _P, _I, _F, _I, _I, _P,
                             _P, _P, _P, _P, _P, _P, _P],
    "ingp_probe_row_gather": [_P, _I64, _I, _P, _P, _I64, _P],
    "ingp_probe_onchip_gather": [_I, _P, _I, _I, _P, _P, _I64, _P],
    "ingp_probe_gather": [_I, _P, _I64, _I, _P, _P, _I64, _I, _P],
    # not a launcher: the launch ingp_probe_gather plans for its shapes
    "ingp_probe_gather_shape": [_I, _I64, _I, _I64, _I, _P],
}

# kernel launches so far, by launcher symbol; `launch` counts each one
LAUNCHES: collections.Counter = collections.Counter()


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libingp_kernels-{source_hash()}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build_library() -> str:
    """Compile csrc/*.cu with one nvcc call (`--threads 0`: its steps
    run on as many threads as the host has CPUs); returns nvcc's resource
    report (-Xptxas -v: registers, spills, shared memory per kernel).
    Raises RuntimeError with nvcc's stderr if the build fails."""
    out = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "--threads", "0", "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", str(tmp)] + [str(p) for p in sources()]
    try:
        res = subprocess.run(cmd, check=True, capture_output=True,
                             text=True, timeout=NVCC_TIMEOUT_S)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"nvcc failed (exit {e.returncode}):\n"
                           f"{e.stderr}") from e
    os.replace(tmp, out)
    report = res.stderr
    out.with_suffix(".log").write_text(report)
    return report


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernel library, built first if this source hash has no
    library yet."""
    path = library_path()
    if not path.exists():
        build_library()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, *args) -> None:
    """Call launcher `name` and count the launch in LAUNCHES; raise if it
    reports a CUDA error."""
    rc = getattr(load_library(), name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    LAUNCHES[name] += 1


def check_cuda_tensor(name, t, dtypes, ndim, device, align=4):
    """Validate a tensor handed to a kernel: device, dtype, rank,
    contiguity and alignment of its data pointer (16 bytes for the brick
    rows, which the kernels read with vector loads)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: rank {t.ndim}, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data pointer not {align}-byte aligned")


def stream_of(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)
