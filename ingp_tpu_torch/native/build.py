"""g++ builds of the port's host C++ helpers: the native batch sampler's
library (csrc/dataloader.cpp), and through `build_shared` the PNG and
JPEG helpers of data/image_io.py and the line segment detector of
utility/vanishing_point.py. Each library goes to its package's _build/
directory, named by a hash of its source, at first use. A build
raises RuntimeError naming the cause when g++ is missing or fails: there
is no fallback once a build was asked for."""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC = Path(__file__).resolve().parent / "csrc" / "dataloader.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
GXX_TIMEOUT_S = 120


def build_shared(src: Path, build_dir: Path, stem: str, what: str,
                 flags=("-O3",), force: bool = False) -> Path:
    """The path of src's shared library in build_dir, compiled by g++
    with flags first when it is missing (or when force is set); `what`
    names the helper in the error."""
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = Path(build_dir) / f"{stem}-{digest}.so"
    if out.exists() and not force:
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: {what} ({src.parent.parent.name}"
                           f"/csrc/{src.name}) needs it")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [gxx, *flags, "-shared", "-fPIC", str(src), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=GXX_TIMEOUT_S)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"g++ failed (exit {e.returncode}) on "
                           f"{src}:\n{e.stderr}") from e
    os.replace(tmp, out)
    return out


def build_library(force: bool = False) -> Path:
    """The native batch sampler's library, compiled first when it is
    missing (or when force is set)."""
    return build_shared(SRC, BUILD_DIR, "libingp_dataloader",
                        "the native batch sampler",
                        ("-O3", "-std=c++17", "-pthread"), force)
