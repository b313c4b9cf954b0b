"""Build the native batch sampler's library (csrc/dataloader.cpp) with g++
into native/_build/, named by a hash of its source, at first use.
Raises RuntimeError naming the cause when g++ is missing or fails: there
is no fallback to another sampler once a build was asked for."""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC = Path(__file__).resolve().parent / "csrc" / "dataloader.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
GXX_TIMEOUT_S = 120


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libingp_dataloader-{digest}.so"


def build_library(force: bool = False) -> Path:
    """The library's path, compiled first when it is missing (or when
    force is set)."""
    out = library_path()
    if out.exists() and not force:
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: the native batch sampler "
                           f"(native/csrc/{SRC.name}) needs it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [gxx, "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           str(SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=GXX_TIMEOUT_S)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"g++ failed (exit {e.returncode}) on "
                           f"{SRC}:\n{e.stderr}") from e
    os.replace(tmp, out)
    return out
