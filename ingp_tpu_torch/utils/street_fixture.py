"""On-disk street scenes for the KITTI-360 and highbay loaders, written
with the port's own codec, so that their file formats run without a
downloaded dataset:

  write_kitti_scene    KITTI-360's layout for one sequence: calibration
                       (perspective.txt with P_rect_00, S_rect_00,
                       R_rect_01; calib_cam_to_pose.txt), data_poses
                       (cam0_to_world.txt, poses.txt, oxts/ timestamps
                       and per-frame GPS), both rectified cameras' PNG
                       frames and (3, H, W) .npy mono normals under
                       data_2d_raw, semantic id PNGs under
                       data_2d_semantics; the real image size by default
  write_highbay_scene  the highbay rig's layout: transforms.json,
                       gps.csv (ROS field names), img_time.npy,
                       valid.txt, left/ and right/ rgb PNGs, semantic
                       PGMs (8-bit on the left, 16-bit on the right) and
                       _normal.npy normals

Both scenes are one procedural street, traced in closed form: a
checkered ground plane, a wall of striped facades on either side, sky
above them; each pixel's semantic id and surface normal come from what its
ray hits.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..core.rays import get_ray_directions
from ..data.image_io import write_pgm, write_png

# KITTI-360's rectified camera 0 (P_rect_00 and S_rect_00 of the
# dataset's perspective.txt)
KITTI_WH = (1408, 376)
KITTI_FOCAL, KITTI_CX, KITTI_CY = 552.554261, 682.049453, 238.769549
# ids of the KITTI-360 label set: road, building, vegetation, sky
ROAD, BUILDING, VEGETATION, SKY = 7, 11, 21, 23
SKY_RGB = np.array([0.55, 0.7, 0.9])


def trace_street(ro, rd, ground_z, wall_y, tile):
    """Colour (N, 3) in [0, 1], KITTI-360 semantic id (N,) uint8 and
    world normal (N, 3) float64 of rays (N, 3) in a street along x: the
    ground plane z = ground_z (checkers of `tile`), walls y = +-wall_y
    up to 5 tiles high (facade stripes of `tile`, every third one
    vegetation), sky where a ray hits neither."""
    ro = np.asarray(ro, np.float64)
    rd = np.asarray(rd, np.float64)
    n = len(rd)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_g = np.where(rd[:, 2] < 0, (ground_z - ro[:, 2]) / rd[:, 2],
                       np.inf)
        side = np.sign(rd[:, 1])
        t_w = np.where(rd[:, 1] != 0, (side * wall_y - ro[:, 1]) / rd[:, 1],
                       np.inf)
    z_w = ro[:, 2] + np.where(np.isfinite(t_w), t_w, 0.0) * rd[:, 2]
    t_w = np.where((t_w > 0) & (z_w < ground_z + 5 * tile), t_w, np.inf)
    t_g = np.where(t_g > 0, t_g, np.inf)
    rgb = np.broadcast_to(SKY_RGB, (n, 3)).copy()
    label = np.full(n, SKY, np.uint8)
    normal = -rd / np.linalg.norm(rd, axis=1, keepdims=True)
    ground = np.isfinite(t_g) & (t_g <= t_w)
    wall = np.isfinite(t_w) & ~ground
    p = ro + np.where(ground, t_g, np.where(wall, t_w, 0.0))[:, None] * rd
    check = (np.floor(p[:, 0] / tile) + np.floor(p[:, 1] / tile)) % 2
    rgb[ground] = (0.25 + 0.2 * check[ground])[:, None] \
        * np.array([1.0, 0.95, 0.9])
    label[ground] = ROAD
    normal[ground] = (0.0, 0.0, 1.0)
    stripe = np.floor(p[:, 0] / tile).astype(np.int64)
    height = np.clip((p[:, 2] - ground_z) / (4 * tile), 0, 1)
    green = wall & (stripe % 3 == 0)
    brick = wall & ~green
    rgb[brick] = np.stack([0.6 + 0.3 * height[brick],
                           0.35 + 0.1 * (stripe[brick] % 2),
                           0.3 + 0.2 * height[brick]], 1)
    rgb[green] = np.stack([0.15 + 0.1 * height[green],
                           0.45 + 0.3 * height[green],
                           0.15 + 0.05 * height[green]], 1)
    label[brick] = BUILDING
    label[green] = VEGETATION
    normal[wall] = np.stack([np.zeros(int(wall.sum())),
                             -np.sign(rd[wall, 1]),
                             np.zeros(int(wall.sum()))], 1)
    return np.clip(rgb, 0, 1), label, normal


def _to_u8(x):
    return (np.clip(x, 0, 1) * 255).astype(np.uint8)


def _write_view(c2w, dirs, wh, ground_z, wall_y, tile, rgb_path,
                normal_path, write_label):
    """Trace one camera c2w (3, 4) and write its frame, its normals in
    the camera frame as (3, H, W) float32 in [0, 1], and its labels
    through write_label(label (H, W) uint8)."""
    w, h = wh
    rd = dirs @ c2w[:, :3].T
    ro = np.broadcast_to(c2w[:, 3], rd.shape)
    rgb, label, normal = trace_street(ro, rd, ground_z, wall_y, tile)
    write_png(rgb_path, _to_u8(rgb).reshape(h, w, 3))
    if normal_path is not None:
        n_cam = normal @ c2w[:, :3]
        np.save(normal_path, ((n_cam + 1) / 2).astype(np.float32)
                .T.reshape(3, h, w))
    if write_label is not None:
        write_label(label.reshape(h, w))


def _rz(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


def _rx(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _line(key, values):
    return key + ": " + " ".join(f"{v:.9e}" for v in np.ravel(values))


def write_kitti_scene(root, frames=range(1538, 1554), img_wh=KITTI_WH,
                      seq_id=0, oxts=True, seed=0):
    """A KITTI-360 sequence under root: the car drives ~0.8 m a frame
    along a gently curving street, camera 0 1.7 m above the road and
    camera 1 0.6 m to its right (calib_cam_to_pose), frames `frames` of
    img_wh (P_rect_00 scaled from the real 1408 px width) for both
    cameras with semantic PNGs and .npy normals; with oxts, timestamps
    and GPS records for frames 0..max(frames) (the loader indexes them
    by frame number). Returns the rectified camera-0 poses (n, 4, 4)."""
    rng = np.random.default_rng(seed)
    frames = np.asarray(list(frames), np.int64)
    w, h = img_wh
    f = KITTI_FOCAL * w / KITTI_WH[0]
    cx, cy = KITTI_CX * w / KITTI_WH[0], KITTI_CY * h / KITTI_WH[1]
    seq = "2013_05_28_drive_{:0>4d}_sync".format(seq_id)
    calib = os.path.join(root, "calibration")
    poses_dir = os.path.join(root, "data_poses", seq)
    for d in (calib, poses_dir):
        os.makedirs(d, exist_ok=True)

    R_rect_01 = _rx(0.002) @ _rz(-0.001)
    with open(os.path.join(calib, "perspective.txt"), "w") as fh:
        fh.write("\n".join([
            _line("P_rect_00", [[f, 0, cx, 0], [0, f, cy, 0], [0, 0, 1, 0]]),
            _line("S_rect_00", [w, h]),
            _line("R_rect_00", np.eye(3)),
            _line("P_rect_01", [[f, 0, cx, -0.6 * f], [0, f, cy, 0],
                                [0, 0, 1, 0]]),
            _line("R_rect_01", R_rect_01)]) + "\n")
    # camera [right down front] -> pose frame [front left up]
    cam_axes = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0.0]])
    cam2sys = []
    for i, (dy, tilt) in enumerate(((0.0, 0.0), (-0.6, 0.003))):
        m = np.eye(4)
        m[:3, :3] = cam_axes @ _rx(tilt)
        m[:3, 3] = (1.5, dy, 1.3)
        cam2sys.append(m)
    with open(os.path.join(calib, "calib_cam_to_pose.txt"), "w") as fh:
        fh.write("\n".join(_line(f"image_{i:02d}", m[:3])
                           for i, m in enumerate(cam2sys)) + "\n")

    k = np.arange(frames.max() + 1)
    yaw = 0.02 * np.sin(k / 7.0)
    heading = np.stack([np.cos(yaw), np.sin(yaw)], 1)
    xy = np.cumsum(0.8 * heading, 0) + rng.normal(0, 0.01, (len(k), 2))
    sys2world = np.tile(np.eye(4), (len(k), 1, 1))
    sys2world[:, :3, :3] = np.stack([_rz(a) for a in yaw])
    sys2world[:, :2, 3] = xy
    sys2world[:, 2, 3] = 0.4
    cam0 = sys2world[frames] @ cam2sys[0]
    np.savetxt(os.path.join(poses_dir, "cam0_to_world.txt"),
               np.concatenate([frames[:, None],
                               cam0.reshape(len(frames), 16)], 1),
               fmt=["%d"] + ["%.9f"] * 16)
    np.savetxt(os.path.join(poses_dir, "poses.txt"),
               np.concatenate([frames[:, None],
                               sys2world[frames, :3].reshape(-1, 12)], 1),
               fmt=["%d"] + ["%.9f"] * 12)
    if oxts:
        data = os.path.join(poses_dir, "oxts", "data")
        os.makedirs(data, exist_ok=True)
        with open(os.path.join(poses_dir, "oxts", "timestamps.txt"),
                  "w") as fh:
            for i in k:
                s = 2.903348 + 0.1 * i
                fh.write(f"2013-05-28 08:{46 + int(s // 60):02d}:"
                         f"{s % 60:012.9f}\n")
        for i in k:
            rec = np.zeros(30)
            rec[:6] = (48.98 + xy[i, 1] * 9e-6, 8.39 + xy[i, 0] * 1.37e-5,
                       116.0, 0.01, -0.02, yaw[i] + np.pi / 2)
            np.savetxt(os.path.join(data, f"{i:010d}.txt"), rec[None],
                       fmt="%.12f")

    # both cameras' rectified views: camera 1's pose as the loader
    # builds it, sys2world @ cam2sys_1 @ inv(R_rect_01)
    R_rect = np.eye(4)
    R_rect[:3, :3] = np.linalg.inv(R_rect_01)
    cam1 = sys2world[frames] @ cam2sys[1] @ R_rect
    K = np.float32([[f, 0, cx], [0, f, cy], [0, 0, 1]])
    dirs = get_ray_directions(h, w, K)
    for c, c2ws in enumerate((cam0, cam1)):
        sub = f"image_{c:02d}"
        rgb_dir = os.path.join(root, "data_2d_raw", seq, sub, "data_rect")
        nrm_dir = os.path.join(root, "data_2d_raw", seq, sub, "normal")
        sem_dir = os.path.join(root, "data_2d_semantics", "train", seq, sub,
                               "semantic")
        for d in (rgb_dir, nrm_dir, sem_dir):
            os.makedirs(d, exist_ok=True)
        for fid, c2w in zip(frames, c2ws):
            name = f"{fid:010d}"
            _write_view(c2w[:3], dirs, (w, h), 0.0, 7.0, 2.0,
                        os.path.join(rgb_dir, name + ".png"),
                        os.path.join(nrm_dir, name + ".npy"),
                        lambda lab, p=os.path.join(sem_dir, name + ".png"):
                        write_png(p, lab))
    return cam0


def write_highbay_scene(root, img_wh=(96, 60), n_images=12, valid=(1, 10),
                        seed=0):
    """A highbay recording under root: n_images stereo frames at 10 Hz
    (img_time.npy, integer nanoseconds), a 20 Hz GPS/IMU log around them
    (gps.csv, with the reference's ROS column names), valid.txt with one
    window over images valid[0]..valid[1], transforms.json of img_wh,
    and per image both sides' PNG frames, semantic PGMs (left 8-bit,
    right 16-bit with the id in the high byte) and _normal.npy normals.
    The frames are traced at the poses the port's loader computes from
    these files (its normalised frame: ground at z = -0.6, walls at
    y = +-1.5). Returns those poses (2 * valid images, 3, 4)."""
    from ..data.highbay import HighbayDataset, read_csv_columns
    rng = np.random.default_rng(seed)
    w, h = img_wh
    f = 0.8 * w
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "transforms.json"), "w") as fh:
        json.dump({"fl_x": f, "fl_y": f, "cx": w / 2, "cy": h / 2, "w": w,
                   "h": h}, fh)
    t0 = 1_650_000_000_000_000_000
    img_time = t0 + 50_000_000 + 100_000_000 * np.arange(n_images)
    np.save(os.path.join(root, "img_time.npy"), img_time.astype(np.int64))
    with open(os.path.join(root, "valid.txt"), "w") as fh:
        fh.write("# start,end (ns)\n"
                 f"{img_time[valid[0]]},{img_time[valid[1]]}\n")
    n_gps = 2 * n_images + 2
    gt = t0 + 50_000_000 * np.arange(n_gps)
    s = np.arange(n_gps) / 20.0
    cols = {"field.header.stamp": gt,
            "field.latitude": 40.4433 + 1.2e-6 * s,
            "field.longitude": -79.9436 + 1.6e-6 * s
            + rng.normal(0, 1e-8, n_gps),
            "field.height": 250.0 + 0.01 * np.sin(s),
            "field.roll": 0.5 * np.sin(s),
            "field.pitch": 0.3 * np.cos(s),
            "field.azimuth": 40.0 + 3.0 * s}
    names = list(cols)
    with open(os.path.join(root, "gps.csv"), "w") as fh:
        fh.write(",".join(names) + "\n")
        for i in range(n_gps):
            fh.write(",".join(str(int(cols[k][i])) if k == names[0]
                              else f"{cols[k][i]:.10f}" for k in names)
                     + "\n")

    probe = HighbayDataset.__new__(HighbayDataset)
    probe.split = "train"
    ids, times = probe.get_valid_time(img_time,
                                      os.path.join(root, "valid.txt"))
    probe.setup_poses(read_csv_columns(os.path.join(root, "gps.csv")),
                      times)
    K = np.float32([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    dirs = get_ray_directions(h, w, K)
    n = len(ids)
    for side, half in (("left", 0), ("right", 1)):
        for sub in ("rgb", "semantic", "normal"):
            os.makedirs(os.path.join(root, side, sub), exist_ok=True)
        for j in range(n_images):
            # frames outside the windows are written too: the loader
            # skips them
            c2w = probe.poses[half * n + list(ids).index(j)] \
                if j in ids else probe.poses[half * n]
            name = f"{j:05d}"

            def label(lab, side=side, name=name):
                path = os.path.join(root, side, "semantic", name + ".pgm")
                ids8 = (lab % 7).astype(np.uint8)
                if side == "left":
                    write_pgm(path, ids8)
                else:
                    low = rng.integers(0, 256, lab.shape)
                    write_pgm(path, (ids8.astype(np.uint16) << 8
                                     | low).astype(np.uint16))
            _write_view(c2w.astype(np.float64), dirs, (w, h), -0.6, 1.5,
                        0.25,
                        os.path.join(root, side, "rgb", name + ".png"),
                        os.path.join(root, side, "normal",
                                     name + "_normal.npy"), label)
    return probe.poses
