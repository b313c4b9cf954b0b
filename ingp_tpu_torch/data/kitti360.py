"""KITTI-360 novel-view-synthesis loader (counterpart of
ingp_tpu/data/kitti360.py): the rectified stereo pair of a frame window,
the NVS benchmark's test frames held out of the train split, the scene
normalised to half the largest pairwise camera distance and shifted
back along the direction of travel, the semantic ids mapped to 10
classes, the mono normals rotated to world, and the mean sun and up
directions from the OXTS GPS and the NOAA solar position.

Frames, semantics and normals are read with the port's own codec
(`image_io.read_u8`, `np.load`); a frame of another size is resized as
cv2.resize does it on uint8 (`resize_linear_u8`, labels
`resize_nearest`). The test split's trajectory rays are built per entry
when read (`core.rays.PathRays`).
"""
from __future__ import annotations

import datetime as _dt
import math
import os

import numpy as np

from ..core.rays import PathRays, generate_interpolated_path, \
    get_ray_directions
from .base import BaseDataset
from .image_io import read_u8, resize_linear_u8, resize_nearest

# KITTI-360 semantic ids of the 10 coarse classes (ids not listed: 9,
# void)
LABEL_GROUPS = (
    ([6, 7, 8, 9, 10], 0),                                  # flat
    ([11, 12, 13, 14, 15, 16, 34, 35, 36, 42], 1),          # construction
    ([39, 40, 41, 44], 2),                                  # object
    ([21, 22], 3),                                          # nature
    ([23], 4),                                              # sky
    ([24, 25], 5),                                          # human
    ([19, 20, 26, 27, 28, 29, 30, 31, 32, 33, 43, 255], 6),  # vehicle
    ([38], 7),                                              # light source
    ([17, 18, 37], 8),                                      # pole
)
SEQ_DIR = "2013_05_28_drive_{:0>4d}_sync"


def parse_calib_file(path, key):
    """The numbers after `key` on the first line of path that holds it,
    or None."""
    with open(path) as f:
        for line in f:
            if key in line:
                return np.array([float(t)
                                 for t in line.strip().split(" ")[1:]])
    return None


def solar_position(lat_deg, lon_deg, when_utc):
    """(zenith, azimuth) of the sun in degrees at a WGS84 position and a
    UTC datetime, by the NOAA approximation (~0.1 degree)."""
    d = when_utc - _dt.datetime(2000, 1, 1, 12, tzinfo=when_utc.tzinfo)
    jd = 2451545.0 + d.days + d.seconds / 86400.0
    n = jd - 2451545.0
    L = (280.460 + 0.9856474 * n) % 360              # mean longitude
    g = math.radians((357.528 + 0.9856003 * n) % 360)  # mean anomaly
    lam = math.radians(L + 1.915 * math.sin(g)
                       + 0.020 * math.sin(2 * g))    # ecliptic longitude
    eps = math.radians(23.439 - 0.0000004 * n)
    ra = math.atan2(math.cos(eps) * math.sin(lam), math.cos(lam))
    dec = math.asin(math.sin(eps) * math.sin(lam))
    # Greenwich mean sidereal time, hours
    ut_h = when_utc.hour + when_utc.minute / 60 + when_utc.second / 3600
    gmst = (6.697375 + 0.0657098242 * n + ut_h * 1.0027379) % 24
    lst = (gmst * 15 + lon_deg) % 360
    ha = math.radians(lst) - ra                      # hour angle
    lat = math.radians(lat_deg)
    elev = math.asin(math.sin(lat) * math.sin(dec)
                     + math.cos(lat) * math.cos(dec) * math.cos(ha))
    az = math.atan2(-math.sin(ha),
                    math.tan(dec) * math.cos(lat)
                    - math.sin(lat) * math.cos(ha))
    return 90.0 - math.degrees(elev), math.degrees(az) % 360


def _euler_xyz(rx, ry, rz):
    """The rotation of extrinsic x, y, z angles (scipy's
    Rotation.from_euler("xyz", ...)), as a (3, 3) matrix."""
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def label_mapping(label):
    """KITTI-360 semantic ids -> the 10 coarse classes (int32)."""
    new = np.full_like(label, 9, dtype=np.int32)
    for ids, cls in LABEL_GROUPS:
        new[np.isin(label, ids)] = cls
    return new


class KittiDataset(BaseDataset):
    """One KITTI-360 sequence's frames frame_start..frame_end (kwargs
    seq_id, frame_start, frame_end, test_id, anti_aliasing_factor), both
    rectified cameras: the train split every frame of the window (with
    nvs, all but test_id's), the test split test_id's frames and the
    400-pose trajectory through them. Poses, rays, labels and normals
    hold camera 0's frames, then camera 1's."""

    def __init__(self, root_dir, split="train", nvs=False, downsample=1.0,
                 **kwargs):
        super().__init__(root_dir, split, downsample)
        self.nvs = nvs
        seq = SEQ_DIR.format(kwargs.get("seq_id", 0))
        raw = os.path.join(root_dir, "data_2d_raw", seq)
        dir_rgb = [os.path.join(raw, f"image_{c:02d}", "data_rect")
                   for c in (0, 1)]
        dir_sem = [os.path.join(root_dir, "data_2d_semantics", "train", seq,
                                f"image_{c:02d}", "semantic")
                   for c in (0, 1)]
        dir_normal = [os.path.join(raw, f"image_{c:02d}", "normal")
                      for c in (0, 1)]
        dir_calib = os.path.join(root_dir, "calibration")
        dir_poses = os.path.join(root_dir, "data_poses", seq)

        # intrinsics of the rectified camera 0
        intrinsic_path = os.path.join(dir_calib, "perspective.txt")
        K_00 = parse_calib_file(intrinsic_path, "P_rect_00").reshape(3, 4)
        K_00[:2] *= downsample
        self.K = K_00[:, :-1].astype(np.float32)
        img_size = parse_calib_file(intrinsic_path, "S_rect_00")
        w, h = int(img_size[0] * downsample), int(img_size[1] * downsample)
        self.img_wh = (w, h)
        self.directions = get_ray_directions(
            h, w, self.K,
            anti_aliasing_factor=kwargs.get("anti_aliasing_factor", 1.0))

        # extrinsics of the window's frames
        frame_start = kwargs.get("frame_start", 0)
        frame_end = kwargs.get("frame_end", 100)
        pose_cam_0 = np.genfromtxt(os.path.join(dir_poses,
                                                "cam0_to_world.txt"))
        frame_id = pose_cam_0[:, 0]
        sample = (frame_id >= frame_start) & (frame_id <= frame_end)
        frame_id = frame_id[sample].astype(np.int32)
        cam2world_0 = pose_cam_0[sample, 1:].reshape(-1, 4, 4)[:, :3]
        # poses.txt's rows are selected by cam0_to_world.txt's window mask,
        # as the reference does: the fixtures write the same frames to both
        sys2world = np.genfromtxt(os.path.join(dir_poses, "poses.txt"))
        sys2world = sys2world[sample, 1:].reshape(-1, 3, 4)
        cam2sys_1 = parse_calib_file(
            os.path.join(dir_calib, "calib_cam_to_pose.txt"), "image_01")
        cam2sys_1 = np.concatenate([cam2sys_1.reshape(3, 4),
                                    [[0, 0, 0, 1]]], 0)
        R_rect_01 = parse_calib_file(intrinsic_path,
                                     "R_rect_01").reshape(3, 3)
        R_rect = np.eye(4)
        R_rect[:3, :3] = np.linalg.inv(R_rect_01)
        cam2world_1 = sys2world @ cam2sys_1 @ R_rect

        test_id = np.array(kwargs.get("test_id", []), np.int32)
        test_norm = np.array([i for i in range(len(frame_id))
                              if (test_id == frame_id[i]).any()], np.int64)
        self.setup_poses(cam2world_0, cam2world_1, test_norm)
        dir_oxts = os.path.join(dir_poses, "oxts")
        if os.path.isdir(dir_oxts):
            self.estimate_sunlight(dir_oxts, dir_calib, frame_id,
                                   cam2world_0)
        else:
            print(f"sunlight estimation skipped: no OXTS directory "
                  f"{dir_oxts}", flush=True)

        if self.split != "train":
            frame_id = test_id
        elif self.nvs:
            keep = np.ones(len(frame_id), bool)
            keep[test_norm] = False
            frame_id = frame_id[keep]

        self.rays = np.concatenate([self.read_rgb(d, frame_id)
                                    for d in dir_rgb], 0).astype(np.float32)
        if self.split == "train":
            if os.path.isdir(dir_sem[0]):
                self.labels = np.concatenate(
                    [self.read_semantics(d, frame_id) for d in dir_sem], 0)
            if os.path.isdir(dir_normal[0]):
                self.normals = np.concatenate(
                    [self.read_normal(d, frame_id, half)
                     for d, half in zip(dir_normal, (0, 1))],
                    0).astype(np.float32)

    # ------------------------------------------------------------------
    def setup_poses(self, cam2world_0, cam2world_1, test_norm):
        """Centre the cameras, scale by half their largest pairwise
        distance, shift back half a unit along the direction of travel;
        keep the split's poses (camera 0's, then camera 1's) and, for the
        test split, the interpolated trajectory through them."""
        pos_0 = cam2world_0[:, :, -1]
        pos_1 = cam2world_1[:, :, -1]
        pos = np.concatenate([pos_0, pos_1], 0)
        center = pos.mean(0)
        forward = pos_0[-1] - pos_0[0]
        forward = forward / np.linalg.norm(forward)
        diff = pos[:, None] - pos[None]
        scale = np.sqrt((diff ** 2).sum(-1)).max() / 2
        self.scale = scale

        pos = (pos - center) / scale - forward * 0.5
        cam2world = np.concatenate([cam2world_0, cam2world_1], 0)
        cam2world[:, :, -1] = pos
        n_step = cam2world_0.shape[0]
        held = np.concatenate([test_norm, test_norm + n_step])
        if self.split != "train":
            cam2world = cam2world[held]
        elif self.nvs:
            keep = np.ones(n_step * 2, bool)
            keep[held] = False
            cam2world = cam2world[keep]

        self.poses = cam2world.astype(np.float32)
        if self.split != "train":
            render_c2w = generate_interpolated_path(cam2world, 120)[:400]
            self.render_c2w = render_c2w.astype(np.float32)
            self.render_traj_rays = PathRays(self.directions, render_c2w)

    # ------------------------------------------------------------------
    def read_rgb(self, dir_rgb, frame_id):
        out = []
        for i in frame_id:
            img = read_u8(os.path.join(dir_rgb, "{:0>10d}.png".format(i)))
            if (img.shape[1], img.shape[0]) != self.img_wh:
                img = resize_linear_u8(img, self.img_wh)
            out.append((img / 255.0).astype(np.float32).reshape(-1, 3))
        return np.stack(out)

    def read_semantics(self, dir_sem, frame_id):
        out = []
        for i in frame_id:
            label = read_u8(os.path.join(dir_sem, "{:0>10d}.png".format(i)),
                            gray=True)
            if (label.shape[1], label.shape[0]) != self.img_wh:
                label = resize_nearest(label, self.img_wh)
            out.append(label_mapping(label.flatten()))
        return np.stack(out)

    def read_normal(self, dir_normal, frame_id, half):
        """Mono normals in [0, 1] (3, H, W) -> [-1, 1], rotated to world
        by the matching camera's pose."""
        n = len(frame_id)
        poses = self.poses[half * n:(half + 1) * n]
        out = []
        for c2w, i in zip(poses, frame_id):
            img = np.load(os.path.join(dir_normal, "{:0>10d}.npy".format(i))
                          ).transpose(1, 2, 0)
            normal = ((img - 0.5) * 2).reshape(-1, 3)
            out.append(normal @ c2w[:, :3].T)
        return np.stack(out)

    # ------------------------------------------------------------------
    def estimate_sunlight(self, dir_oxts, dir_calib, frame_id, cam2world):
        """Mean sun and up directions in the world frame over the
        window's frames. The timestamps are local (Etc/GMT+2) and become
        UTC for the solar position."""
        with open(os.path.join(dir_oxts, "timestamps.txt")) as f:
            stamps = np.array([ln.strip() for ln in f])[frame_id]
        dir_data = os.path.join(dir_oxts, "data")
        files = np.array(sorted(os.path.join(dir_data, p)
                                for p in os.listdir(dir_data)))[frame_id]
        cam2sys_0 = parse_calib_file(
            os.path.join(dir_calib, "calib_cam_to_pose.txt"), "image_00")
        R_sys2cam_0 = cam2sys_0.reshape(3, 4)[:3, :3].T

        sun_dirs, up_dirs = [], []
        for i in range(len(frame_id)):
            when = _dt.datetime.strptime(stamps[i].split(".")[0],
                                         "%Y-%m-%d %H:%M:%S")
            when = when.replace(tzinfo=_dt.timezone.utc) \
                + _dt.timedelta(hours=2)
            data = np.genfromtxt(files[i])
            zen, azi = solar_position(data[0], data[1], when)
            theta, phi = math.radians(zen), math.radians(azi)
            sun = np.array([math.sin(theta) * math.sin(phi),
                            math.sin(theta) * math.cos(phi),
                            math.cos(theta)])     # x east, y north, z up
            roll, pitch, yaw = data[3], data[4], data[5]
            world2car = _euler_xyz(-pitch, roll, yaw - np.pi / 2).T
            R_cam2world = cam2world[i][:3, :3]

            def to_world(v):
                v_car = world2car @ v             # x right, y forward, z up
                v_gps = np.array([v_car[1], v_car[0], -v_car[2]])
                return R_cam2world @ (R_sys2cam_0 @ v_gps)

            sun_dirs.append(to_world(sun))
            up_dirs.append(to_world(np.array([0, 0, 1.0])))
        self.sun_dir = np.mean(sun_dirs, 0).astype(np.float32)
        self.up_dir = np.mean(up_dirs, 0).astype(np.float32)
