"""Build and load the port's CUDA kernels.

The `csrc/*.cu` sources make two shared libraries with a plain C
interface, loaded with `ctypes`, each compiled by ONE `nvcc` call:
"kernels" (K1-K3 and their backward kernels, the library the training
path loads) and "probes" (`csrc/probe_*.cu`, the Hopper forms of the TPU
layout probes, which only `ingp_tpu_torch/probes` launches). No PyTorch
header is included, so a build takes seconds (a source that includes
`torch/extension.h` takes minutes to compile). A library lands in
`kernels/_build/` (git-ignored) under a name keyed by a hash of its
sources and the headers they include, so an edited source is rebuilt
and an unchanged one is reused.

Nothing is built or loaded at import time: `load_library()` (the
kernels) and `load_probe_library()` do it on the first launch that
needs them; `build_libraries()` builds both at once, two `nvcc`
processes side by side.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import re
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
    "ingp_brick_reduce_bwd_and_pos": [_P, _P, _I64, _P, _P, _P, _I64, _P,
                                      _I64, _I64, _P, _I, _I64, _I, _I, _I,
                                      _I, _I, _I, _I, _P],
}
# the probes' kernels (ingp_tpu_torch/probes), csrc/probe_*.cu
_PROBE_SIGNATURES = {
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

# library -> its launchers' signatures
SIGNATURES = {"kernels": _SIGNATURES, "probes": _PROBE_SIGNATURES}
PROBE_PREFIX = "probe_"   # a source of the probes' library
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)

# kernel launches so far, by launcher symbol; `launch` counts each one
LAUNCHES: collections.Counter = collections.Counter()


def sources(lib: str = "kernels") -> list[Path]:
    """The .cu sources of library `lib` ("kernels" or "probes")."""
    if lib not in SIGNATURES:
        raise ValueError(f"no kernel library {lib!r}")
    return sorted(p for p in CSRC.glob("*.cu")
                  if p.name.startswith(PROBE_PREFIX) == (lib == "probes"))


def headers(lib: str = "kernels") -> list[Path]:
    """The csrc headers that library `lib`'s sources include, directly
    or through another header: an edit to a header that only the other
    library includes leaves this one's hash as it was."""
    found, todo = set(), list(sources(lib))
    while todo:
        for name in _INCLUDE.findall(todo.pop().read_text()):
            p = CSRC / name
            if p.exists() and p not in found:
                found.add(p)
                todo.append(p)
    return sorted(found)


def source_hash(lib: str = "kernels") -> str:
    h = hashlib.sha256()
    for p in sources(lib) + headers(lib):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(lib: str = "kernels") -> Path:
    return BUILD_DIR / f"libingp_{lib}-{source_hash(lib)}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _nvcc_cmd(lib: str, out: Path) -> list[str]:
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "--threads", "0", "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(out)] + [str(p) for p in sources(lib)]


def build_libraries(libs=("kernels", "probes")) -> dict:
    """Compile each library of `libs` with one nvcc call (`--threads 0`:
    its steps run on as many threads as the host has CPUs), all calls
    started together; returns {library: nvcc's resource report} (-Xptxas
    -v: registers, spills, shared memory per kernel). Each call writes
    its library and its report to files of this process's own, which
    replace the final `.so` and `.log` only once it succeeded, so two
    processes building the same hash do not touch each other's files.
    Raises RuntimeError with nvcc's stderr if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs = {lib: library_path(lib) for lib in libs}
    tmps = {lib: out.with_name(f"{out.name}.{os.getpid()}.tmp")
            for lib, out in outs.items()}
    # each report to a file: a pipe that nobody reads would stall nvcc
    logs = {lib: open(tmp.with_suffix(".log"), "w+")
            for lib, tmp in tmps.items()}
    procs = {lib: subprocess.Popen(_nvcc_cmd(lib, tmps[lib]),
                                   stdout=subprocess.DEVNULL,
                                   stderr=logs[lib])
             for lib in libs}
    reports, failed = {}, []
    for lib, proc in procs.items():
        try:
            proc.wait(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log = logs[lib]
        log.seek(0)
        reports[lib] = log.read()
        log.close()
        if proc.returncode:
            failed.append(f"{lib}: nvcc failed (exit {proc.returncode}):\n"
                          f"{reports[lib]}")
            for p in (tmps[lib], Path(log.name)):
                p.unlink(missing_ok=True)
        else:
            os.replace(tmps[lib], outs[lib])
            os.replace(log.name, outs[lib].with_suffix(".log"))
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def build_library(lib: str = "kernels") -> str:
    """Compile library `lib` with one nvcc call; returns nvcc's resource
    report."""
    return build_libraries((lib,))[lib]


@functools.lru_cache(maxsize=None)
def _load(lib: str) -> ctypes.CDLL:
    path = library_path(lib)
    if not path.exists():
        build_library(lib)
    dll = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES[lib].items():
        fn = getattr(dll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return dll


def load_library() -> ctypes.CDLL:
    """The kernels' library (K1-K3), built first if this source hash has
    no library yet."""
    return _load("kernels")


def load_probe_library() -> ctypes.CDLL:
    """The probes' library (csrc/probe_*.cu), built first if this source
    hash has no library yet."""
    return _load("probes")


def launch(name: str, *args) -> None:
    """Call launcher `name` (of either library) and count the launch in
    LAUNCHES; raise if it reports a CUDA error."""
    dll = load_probe_library() if name in _PROBE_SIGNATURES \
        else load_library()
    rc = getattr(dll, name)(*args)
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
