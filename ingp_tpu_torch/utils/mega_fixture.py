"""A Mega-NeRF scene on disk, written by the port itself (no Mega-NeRF,
UrbanScene3D or Mill19 data is in the repository): `write_mega_scene`.

The scene is a drone's pass over textured ground with a few boxes on it,
traced analytically: the cameras fly at one altitude along x, looking
down and a little forward, and everything they see lies inside the unit
box [-0.5, 0.5]^3 of the loader's poses (after its axis remap and
centring, which `scene_poses` gives). The tree is Mega-NeRF's:

  coordinates.pt                 {"origin_drb", "pose_scale_factor"}
  {train,val}/metadata/NNNNNN.pt {"W", "H", "c2w", "intrinsics",
                                  "distortion"}, c2w (3, 4) with camera
                                 columns right, up, back (OpenGL)
  {train,val}/rgbs/NNNNNN.jpg    baseline JPEG (image_io.write_jpeg)
  masks/{train,val}/NNNNNN.pt    with masks: a zip holding NNNNNN.pt, a
                                 torch-saved (H, W) bool keep mask

Train frames are 000000 up, val frames follow them (the names differ,
as in the released scenes). From POOL_MIN_PIXELS up, one spawned process
per frame (at most one per CPU) traces and encodes the frames.
"""
from __future__ import annotations

import io
import multiprocessing
import os
import zipfile
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from ..data.image_io import write_jpeg

MILL19_WH = (4608, 3456)       # Mill19's image size
POOL_MIN_PIXELS = 1 << 20
ALTITUDE = 0.0                 # the cameras' y (y points down)
GROUND_Y = 0.4
FOCAL = 0.9                    # fx = fy = FOCAL * W
PITCH_DEG = 10.0               # forward tilt from straight down
# boxes standing on the ground: (x0, x1, z0, z1, top y, RGB)
BOXES = ((-0.28, -0.18, -0.04, 0.06, 0.30, (0.85, 0.35, 0.25)),
         (-0.04, 0.06, 0.06, 0.14, 0.27, (0.25, 0.55, 0.85)),
         (0.16, 0.26, -0.06, 0.02, 0.32, (0.90, 0.80, 0.30)))
# the loader's remap of Mega-NeRF's axes (ingp_tpu_torch/data/mega)
_ROT = np.array([[0, 1, 0], [1, 0, 0], [0, 0, -1]], np.float64)


def scene_poses(n: int) -> np.ndarray:
    """(n, 3, 4) camera-to-world poses in the loader's frame (OpenCV
    camera axes: x right, y down, z forward; world y down): a pass along
    x at ALTITUDE, x centred on 0, each camera pitched PITCH_DEG from
    straight down toward +z."""
    t = np.radians(PITCH_DEG)
    fwd = np.array([0.0, np.cos(t), np.sin(t)])
    right = np.array([1.0, 0.0, 0.0])
    down = np.cross(fwd, right)
    xs = np.linspace(-0.24, 0.24, n) if n > 1 else np.zeros(1)
    poses = np.zeros((n, 3, 4))
    poses[:, :, 0], poses[:, :, 1], poses[:, :, 2] = right, down, fwd
    poses[:, 0, 3], poses[:, 1, 3] = xs, ALTITUDE
    return poses


def to_mega_c2w(pose: np.ndarray) -> np.ndarray:
    """The Mega-NeRF c2w whose remap by the loader (the column swap, then
    _ROT @ R @ _ROT^-1 and _ROT @ t) is pose: camera columns right, up,
    back."""
    m = _ROT @ pose[:, :3] @ _ROT
    c2w = np.empty((3, 4))
    c2w[:, 0], c2w[:, 1], c2w[:, 2] = m[:, 1], -m[:, 0], m[:, 2]
    c2w[:, 3] = _ROT @ pose[:, 3]
    return c2w


def _ground_rgb(x, z):
    """The ground's texture at (x, z): smooth stripes and blobs."""
    a = 0.5 + 0.18 * np.sin(23.0 * x) * np.cos(17.0 * z) \
        + 0.12 * np.sin(71.0 * x) * np.sin(83.0 * z)
    b = 0.5 + 0.2 * np.sin(9.0 * x + 13.0 * z)
    return np.stack([0.35 + 0.4 * a * b, 0.45 + 0.35 * a, 0.25 + 0.3 * b],
                    -1)


def _box_rect(pose, box, f, wh):
    """(u0, u1, v0, v1): the pixel rectangle that holds box's image (its
    8 corners projected; they lie in front of every camera)."""
    x0, x1, z0, z1, top, _ = box
    corners = np.array([[x, y, z] for x in (x0, x1) for y in (top, GROUND_Y)
                        for z in (z0, z1)])
    cam = (corners - pose[:, 3]) @ pose[:, :3]
    u = f * cam[:, 0] / cam[:, 2] + wh[0] / 2
    v = f * cam[:, 1] / cam[:, 2] + wh[1] / 2
    return (max(int(np.floor(u.min())), 0), min(int(np.ceil(u.max())) + 1,
                                                 wh[0]),
            max(int(np.floor(v.min())), 0), min(int(np.ceil(v.max())) + 1,
                                                 wh[1]))


def trace(pose, wh, rows=None) -> np.ndarray:
    """(h, w, 3) uint8: the scene seen from pose (loader frame) through a
    pinhole of focal FOCAL * w at the image centre; rows (r0, r1) traces
    only those rows. Each box is traced only inside its image's
    rectangle."""
    w, h = wh
    r0, r1 = rows or (0, h)
    f = FOCAL * w
    v, u = np.mgrid[r0:r1, 0:w].astype(np.float32)
    d_cam = np.stack([(u + 0.5 - w / 2) / f, (v + 0.5 - h / 2) / f,
                      np.ones_like(u)], -1)
    d = d_cam @ pose[:, :3].T.astype(np.float32)
    o = pose[:, 3].astype(np.float32)
    t_best = np.where(d[..., 1] > 0, (GROUND_Y - o[1]) / d[..., 1], np.inf)
    hit = o + t_best[..., None] * d
    rgb = _ground_rgb(hit[..., 0], hit[..., 2])
    for box in BOXES:
        u0, u1, v0, v1 = _box_rect(pose, box, f, wh)
        v0, v1 = max(v0, r0) - r0, min(v1, r1) - r0
        if v0 >= v1 or u0 >= u1:
            continue
        x0, x1, z0, z1, top, col = box
        dd, tb = d[v0:v1, u0:u1], t_best[v0:v1, u0:u1]
        lo = np.array([x0, top, z0], np.float32)
        hi = np.array([x1, GROUND_Y, z1], np.float32)
        with np.errstate(divide="ignore", invalid="ignore"):
            ta, tc = (lo - o) / dd, (hi - o) / dd
            tmin = np.minimum(ta, tc)
            tn = tmin.max(-1)
            tf = np.maximum(ta, tc).min(-1)
            inside = (tn <= tf) & (tn > 0) & (tn < tb)
            p = o + tn[..., None] * dd
        shade = np.choose(tmin.argmax(-1), [0.75, 1.0, 0.6])
        stripe = 0.9 + 0.1 * np.sin(60.0 * (p[..., 0] + p[..., 2]))
        box_rgb = np.asarray(col, np.float32) * (shade * stripe)[..., None]
        rgb[v0:v1, u0:u1] = np.where(inside[..., None], box_rgb,
                                     rgb[v0:v1, u0:u1])
        t_best[v0:v1, u0:u1] = np.where(inside, tn, tb)
    rgb = np.where(np.isfinite(t_best)[..., None], rgb, 0.0)
    return np.clip(np.rint(rgb * 255), 0, 255).astype(np.uint8)


def frame(pose, wh) -> np.ndarray:
    """trace over the whole frame, 256 rows at a time."""
    w, h = wh
    return np.concatenate([trace(pose, wh, (r, min(r + 256, h)))
                           for r in range(0, h, 256)])


def _write_frame(path, pose, wh, quality, subsampling):
    write_jpeg(path, frame(pose, wh), quality, subsampling)


def write_mega_scene(root, n_train=4, n_val=1, img_wh=MILL19_WH, quality=95,
                     subsampling="4:2:0", masks=False,
                     pose_scale_factor=50.0):
    """Write a Mega-NeRF scene of n_train + n_val frames of img_wh (w, h)
    under root (see the module docstring). With masks, a keep mask per
    frame (everything but a corner) under masks/. Returns {"poses": the
    (n_train + n_val, 3, 4) loader-frame poses, "names": {split: [stem,
    ...]}}."""
    import torch
    w, h = img_wh
    # the val frames fly beside the train pass, between its cameras
    val = scene_poses(n_val) * np.array([1, 1, 1, 0.5])
    val[:, 2, 3] = 0.05
    poses = np.concatenate([scene_poses(n_train), val])
    os.makedirs(root, exist_ok=True)
    torch.save({"origin_drb": torch.zeros(3),
                "pose_scale_factor": float(pose_scale_factor)},
               os.path.join(root, "coordinates.pt"))
    names = {"train": [f"{i:06d}" for i in range(n_train)],
             "val": [f"{i:06d}" for i in range(n_train, n_train + n_val)]}
    jobs = []
    intr = torch.tensor([FOCAL * w, FOCAL * w, w / 2, h / 2],
                        dtype=torch.float64)
    for split, stems in names.items():
        for sub in ("metadata", "rgbs"):
            os.makedirs(os.path.join(root, split, sub), exist_ok=True)
        for stem in stems:
            pose = poses[int(stem)]
            torch.save({"W": w, "H": h,
                        "c2w": torch.tensor(to_mega_c2w(pose),
                                            dtype=torch.float32),
                        "intrinsics": intr.clone(),
                        "distortion": torch.zeros(4, dtype=torch.float64)},
                       os.path.join(root, split, "metadata", f"{stem}.pt"))
            jobs.append((os.path.join(root, split, "rgbs", f"{stem}.jpg"),
                         pose, img_wh, quality, subsampling))
            if masks:
                _write_mask(os.path.join(root, "masks", split), stem, w, h)
    if w * h >= POOL_MIN_PIXELS and len(jobs) > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(min(os.cpu_count() or 1, len(jobs)),
                                 mp_context=ctx) as pool:
            # reading every result raises a worker's error here
            list(pool.map(_write_frame, *zip(*jobs)))
    else:
        for job in jobs:
            _write_frame(*job)
    return {"poses": poses.astype(np.float32), "names": names}


def _write_mask(folder, stem, w, h):
    """masks/<split>/<stem>.pt: a zip whose member <stem>.pt is a
    torch-saved (h, w) bool mask, False in the top-left quarter."""
    import torch
    os.makedirs(folder, exist_ok=True)
    keep = torch.ones((h, w), dtype=torch.bool)
    keep[:h // 4, :w // 4] = False
    buf = io.BytesIO()
    torch.save(keep, buf)
    with zipfile.ZipFile(os.path.join(folder, f"{stem}.pt"), "w") as zf:
        zf.writestr(f"{stem}.pt", buf.getvalue())
