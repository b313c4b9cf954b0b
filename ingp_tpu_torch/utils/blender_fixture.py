"""On-disk scenes traced from the procedural sphere scene
(data/synthetic.py `trace_scene`), written with the port's own codec, so
that the loaders' file formats run without a downloaded dataset:

  write_blender_scene  NeRF-synthetic (Blender transforms_*.json), the
                       `nerf` loader's format (counterpart of
                       ingp_tpu/utils/blender_fixture.py: the same files)
  write_nsvf_scene     NSVF's Synthetic-NeRF layout (intrinsics.txt,
                       bbox.txt, pose/ and rgb/ with 0_ train and 2_ test
                       prefixes), the `nsvf` loader's, as lego's
                       configs/lego.txt reads it: opaque RGBA frames at
                       800 px
  write_tnt_scene      TanksAndTemples' layout (intrinsics.txt, pose/, rgb/
                       with 0_ train and 1_ test prefixes, semantic/ .pgm
                       labels, depth/ .npy, camera_path/pose/), the `tnt`
                       loader's, as configs/Playground.txt reads it

Each camera sits on a shell around the scene, on the upper side as the
Blender rigs do, looking at the origin.
"""
from __future__ import annotations

import json
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from ..core.rays import get_ray_directions
from ..data.image_io import write_pgm, write_png
from ..data.synthetic import look_at_pose, trace_scene


def _shell_poses(rng, n, radius):
    """n cameras on a sphere of `radius`, y <= 0: (eye (3,) float64,
    [right down front] c2w (3, 4) float32)."""
    poses = []
    for _ in range(n):
        v = rng.normal(size=3)
        v[1] = -abs(v[1])
        eye = radius * v / np.linalg.norm(v)
        poses.append((eye, look_at_pose(eye)))
    return poses


def _trace(eye, c2w, dirs, chunk=32768):
    """trace_scene of the rays of one view: (rgb, depth, hit, seg),
    traced chunk rays at a time (each ray on its own, so the same values;
    the chunk's arrays stay in the cache)."""
    rd = dirs @ c2w[:, :3].T
    ro = np.broadcast_to(eye, rd.shape)
    with np.errstate(invalid="ignore"):  # inf - inf where a ray misses
        parts = [trace_scene(ro[i:i + chunk], rd[i:i + chunk])
                 for i in range(0, len(rd), chunk)]
    rgb, depth, hit, _, seg = (np.concatenate(p) for p in zip(*parts))
    return rgb, depth, hit, seg


def _to_u8(x):
    return (np.clip(x, 0, 1) * 255).astype(np.uint8)


def write_blender_scene(root, img_size=64, n_train=30, n_test=4, seed=0):
    """transforms_train/test.json and img_size PNG frames under root,
    cameras on the radius-1.5 shell (the `nerf` loader normalises to
    1.5). Returns the downsample that maps the loader's 800 px
    intrinsics to img_size."""
    downsample = img_size / 800.0
    fov_x = 0.8  # rad; fx = 0.5 * 800 / tan(0.4) at full resolution
    fx = 0.5 * img_size / np.tan(0.5 * fov_x)
    K = np.float32([[fx, 0, img_size / 2], [0, fx, img_size / 2],
                    [0, 0, 1]])
    dirs = get_ray_directions(img_size, img_size, K)
    os.makedirs(root, exist_ok=True)
    for split, n, s in (("train", n_train, seed),
                        ("test", n_test, seed + 1)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i, (eye, c2w) in enumerate(_shell_poses(
                np.random.default_rng(s), n, 1.5)):
            rgb = _trace(eye, c2w, dirs)[0]
            name = f"{split}/r_{i}"
            write_png(os.path.join(root, f"{name}.png"),
                      _to_u8(rgb.reshape(img_size, img_size, 3)))
            # OpenCV -> Blender convention: negate the down/front columns
            mat = np.eye(4)
            mat[:3, :3] = c2w[:, :3] * np.array([1.0, -1.0, -1.0])
            mat[:3, 3] = c2w[:, 3]
            frames.append({"file_path": name,
                           "transform_matrix": mat.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": fov_x, "frames": frames}, f)
    return downsample


# Synthetic-NeRF's focal length at 800 px (Lego's camera_angle_x 0.6911)
NSVF_FOCAL = 1111.111


# frames of this size and up are traced by one spawned process per CPU
POOL_MIN_SIZE = 256


def write_nsvf_scene(root, img_size=800, n_train=100, n_test=4, seed=0):
    """An NSVF Synthetic-NeRF scene under root (which must contain
    "Synthetic", as the loader's intrinsics branch asks): RGBA frames of
    img_size px, Paeth-filtered, cameras at distance 1.6 in the loader's
    normalised space, each holding the whole scene (the spheres, within
    0.44 of the origin, span 15.9 of the 19.8 degrees from the frame's
    centre to its edge, as Lego fills its own frames), the frames
    traced by one spawned process per CPU from POOL_MIN_SIZE px up.
    The frames are opaque
    on black: the renderer composites synthetic scenes on black, as the
    JAX package does, so a transparent background, which the loader
    blends to white, could not be learned where rays leave the scene's
    box (PERF.md §7). bbox.txt spans [-1, 1]^3, so the loader's shift is
    0 and its scale 1.05 (x 1.1 where root contains "Lego", x 1.2 for
    "Mic"); the pose files hold the normalised poses scaled back by it.
    Returns the downsample that maps the loader's 800 px to img_size."""
    if "Synthetic" not in str(root):
        raise ValueError(f"{root}: an NSVF Synthetic scene's path must "
                         f"contain 'Synthetic'")
    scale = 1.05 * (1.2 if "Mic" in str(root) else
                    1.1 if "Lego" in str(root) else 1.0)
    for sub in ("rgb", "pose"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    with open(os.path.join(root, "intrinsics.txt"), "w") as f:
        f.write(f"{NSVF_FOCAL} 400. 400. 0.\n0. 0. 0.\n0.\n1.\n800 800\n")
    with open(os.path.join(root, "bbox.txt"), "w") as f:
        f.write("-1.0 -1.0 -1.0 1.0 1.0 1.0 0.01\n")
    fx = NSVF_FOCAL * img_size / 800.0
    K = np.float32([[fx, 0, img_size / 2], [0, fx, img_size / 2],
                    [0, 0, 1]])
    views = [(str(root), f"{prefix}{i:04d}", eye, c2w, K, img_size, scale)
             for prefix, n, s in (("0_", n_train, seed), ("2_", n_test,
                                                           seed + 1))
             for i, (eye, c2w) in enumerate(_shell_poses(
                 np.random.default_rng(s), n, 1.6))]
    if img_size >= POOL_MIN_SIZE:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(min(os.cpu_count(), len(views)),
                                 mp_context=ctx) as pool:
            # reading every result raises a worker's error here
            list(pool.map(_write_nsvf_view, *zip(*views)))
    else:
        for view in views:
            _write_nsvf_view(*view)
    return img_size / 800.0


def _write_nsvf_view(root, name, eye, c2w, K, img_size, scale):
    """One view of write_nsvf_scene: rgb/<name>.png and pose/<name>.txt."""
    rgb = _trace(eye, c2w, get_ray_directions(img_size, img_size, K))[0]
    rgba = np.concatenate([_to_u8(rgb), np.full((len(rgb), 1), 255,
                                                np.uint8)],
                          1).reshape(img_size, img_size, 4)
    write_png(os.path.join(root, "rgb", f"{name}.png"), rgba)
    world = np.eye(4)
    world[:3] = c2w
    world[:3, 3] *= 2 * scale
    np.savetxt(os.path.join(root, "pose", f"{name}.txt"), world)


def write_tnt_scene(root, img_wh=(64, 36), n_train=8, n_test=2,
                    n_path=3, seed=0):
    """A TanksAndTemples scene under root: img_wh RGB frames, the frames'
    sphere labels as 8-bit .pgm and their depth as .npy, and n_path poses
    under camera_path/pose. The cameras sit at distance 0.8 in the
    loader's normalised space; the loader divides by the largest norm of
    a pose file's last column, its homogeneous 1 included, so the files
    hold them scaled by 1 / 0.6 (norm sqrt(0.8^2 / 0.36 + 1) = 1 / 0.6)."""
    w, h = img_wh
    f = 0.9 * w
    K = np.float32([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    dirs = get_ray_directions(h, w, K)
    for sub in ("rgb", "pose", "semantic", "depth", "camera_path/pose"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    k4 = np.eye(4)
    k4[:3, :3] = K
    np.savetxt(os.path.join(root, "intrinsics.txt"), k4)
    rng = np.random.default_rng(seed)

    def world(c2w):
        m = np.eye(4)
        m[:3] = c2w
        m[:3, 3] /= 0.6
        return m
    for prefix, n in (("0_", n_train), ("1_", n_test)):
        for i, (eye, c2w) in enumerate(_shell_poses(rng, n, 0.8)):
            rgb, depth, _, seg = _trace(eye, c2w, dirs)
            name = f"{prefix}{i:05d}"
            write_png(os.path.join(root, "rgb", f"{name}.png"),
                      _to_u8(rgb.reshape(h, w, 3)))
            np.savetxt(os.path.join(root, "pose", f"{name}.txt"), world(c2w))
            write_pgm(os.path.join(root, "semantic", f"{name}.pgm"),
                      seg.reshape(h, w).astype(np.uint8))
            np.save(os.path.join(root, "depth", f"{name}.npy"),
                    depth.reshape(h, w))
    for i, (_, c2w) in enumerate(_shell_poses(rng, n_path, 0.8)):
        np.savetxt(os.path.join(root, "camera_path", "pose", f"{i:05d}.txt"),
                   world(c2w))
