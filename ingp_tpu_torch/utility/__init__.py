"""Preprocessing tools (counterpart of ingp_tpu/utility/): plane fitting
(RANSAC + LSE), Poisson image blending, video frame IO (Motion-JPEG
AVI), vanishing-point up-vector estimation and the ocean-wave spectrum
playground."""
from .fit_plane import Plane, plane_lse, plane_ransac
from .poisson_blend import poisson_blending
from .video import extract_frames, assemble_video
from .vanishing_point import estimate_up_vector
from .ocean_wave import (init_spectrum, seed_field, evolve_phase,
                         synthesize, animate_gif)
