"""Offline rendering and export (counterpart of ingp_tpu/render/): the
test-split / camera-path render with its PNGs and videos, panoramas,
the auxiliary semantic and up-normal passes, and mesh extraction."""
from .offline import render_for_test, render_chunks
from .panorama import render_panorama, sample_panorama
from .mesh import extract_mesh, marching_cubes

__all__ = ["render_for_test", "render_chunks", "render_panorama",
           "sample_panorama", "extract_mesh", "marching_cubes"]
