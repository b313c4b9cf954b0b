"""Highbay stereo-rig loader (counterpart of ingp_tpu/data/highbay.py):
the GPS/IMU log (gps.csv) Slerp'd and interpolated to the image times
of the valid windows, positions projected to UTM and normalised, the
right camera 0.12 m along the left camera's x axis, and the semantic
(.pgm) and mono-normal (.npy) channels.

gps.csv is read by column name with the standard library's csv module,
each column typed as pandas types it (int64 where every entry is an
integer, else float64); frames through the port's own codec, 16-bit
PGM labels keeping their high byte as cv2.IMREAD_GRAYSCALE does.
"""
from __future__ import annotations

import csv
import json
import os

import numpy as np

from ..core.rays import PathRays, generate_interpolated_path, \
    get_ray_directions
from .base import BaseDataset
from .image_io import read_u8, resize_linear_u8, resize_nearest

BASELINE_M = 0.12    # the rig's stereo baseline along camera x


def latlon_to_utm(latitude, longitude):
    """(east, north) in metres of WGS84 lat/lon in their UTM zone (the
    transverse-Mercator series; mm-level at a site's scale)."""
    lat = np.radians(np.asarray(latitude, np.float64))
    lon = np.radians(np.asarray(longitude, np.float64))
    a = 6378137.0
    f = 1 / 298.257223563
    e2 = f * (2 - f)
    ep2 = e2 / (1 - e2)
    k0 = 0.9996

    zone = np.floor((np.degrees(lon) + 180) / 6) + 1
    lon0 = np.radians((zone - 1) * 6 - 180 + 3)

    N = a / np.sqrt(1 - e2 * np.sin(lat) ** 2)
    T = np.tan(lat) ** 2
    C = ep2 * np.cos(lat) ** 2
    A = np.cos(lat) * (lon - lon0)

    M = a * ((1 - e2 / 4 - 3 * e2 ** 2 / 64 - 5 * e2 ** 3 / 256) * lat
             - (3 * e2 / 8 + 3 * e2 ** 2 / 32 + 45 * e2 ** 3 / 1024)
             * np.sin(2 * lat)
             + (15 * e2 ** 2 / 256 + 45 * e2 ** 3 / 1024)
             * np.sin(4 * lat)
             - (35 * e2 ** 3 / 3072) * np.sin(6 * lat))

    east = k0 * N * (A + (1 - T + C) * A ** 3 / 6
                     + (5 - 18 * T + T ** 2 + 72 * C - 58 * ep2)
                     * A ** 5 / 120) + 500000.0
    north = k0 * (M + N * np.tan(lat)
                  * (A ** 2 / 2 + (5 - T + 9 * C + 4 * C ** 2)
                     * A ** 4 / 24
                     + (61 - 58 * T + T ** 2 + 600 * C - 330 * ep2)
                     * A ** 6 / 720))
    north = np.where(lat < 0, north + 10000000.0, north)
    return east, north


def _column(values):
    """A csv column as pandas.read_csv types it: int64 where every entry
    is an integer literal, else float64."""
    try:
        return np.array([int(v) for v in values], np.int64)
    except ValueError:
        return np.array([float(v) for v in values], np.float64)


def read_csv_columns(path) -> dict:
    """{column name: numpy column} of a csv file with a header row."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], [r for r in rows[1:] if r]
    return {name: _column([r[i] for r in body])
            for i, name in enumerate(header)}


class HighbayDataset(BaseDataset):
    """The rig's left then right frames at the image times inside the
    valid windows (kwargs valid_id, the windows' file, default
    valid.txt; anti_aliasing_factor). Train and test splits hold the
    same frames; the train split adds labels and normals, the test split
    the interpolated trajectory."""

    def __init__(self, root_dir, split="train", nvs=False, downsample=1.0,
                 **kwargs):
        super().__init__(root_dir, split, downsample)
        self.nvs = nvs
        sides = ("left", "right")
        dir_rgb = [os.path.join(root_dir, s, "rgb") for s in sides]
        dir_sem = [os.path.join(root_dir, s, "semantic") for s in sides]
        dir_normal = [os.path.join(root_dir, s, "normal") for s in sides]
        sensor_data = read_csv_columns(os.path.join(root_dir, "gps.csv"))

        with open(os.path.join(root_dir, "transforms.json")) as f:
            intrinsic = json.load(f)
        K = np.array([[intrinsic["fl_x"], 0, intrinsic["cx"]],
                      [0, intrinsic["fl_y"], intrinsic["cy"]],
                      [0, 0, 1.0]])
        K[:2] *= downsample
        self.K = K.astype(np.float32)
        w, h = int(intrinsic["w"] * downsample), \
            int(intrinsic["h"] * downsample)
        self.img_wh = (w, h)
        self.directions = get_ray_directions(
            h, w, self.K,
            anti_aliasing_factor=kwargs.get("anti_aliasing_factor", 1.0))

        img_time = np.load(os.path.join(root_dir, "img_time.npy"))
        valid_ids, valid_time = self.get_valid_time(
            img_time, os.path.join(root_dir, kwargs.get("valid_id",
                                                        "valid.txt")))
        self.setup_poses(sensor_data, valid_time)

        self.rays = np.concatenate([self.read_rgb(d, valid_ids)
                                    for d in dir_rgb], 0).astype(np.float32)
        if self.split == "train":
            if os.path.isdir(dir_sem[0]):
                self.labels = np.concatenate(
                    [self.read_semantics(d, valid_ids) for d in dir_sem], 0)
            if os.path.isdir(dir_normal[0]):
                self.normals = np.concatenate(
                    [self.read_normal(d, valid_ids, half)
                     for d, half in zip(dir_normal, (0, 1))],
                    0).astype(np.float32)

    def get_valid_time(self, img_time, valid_path):
        """(ids, times) of the images whose time lies in one of the
        "start,end" windows of valid_path (# lines are comments)."""
        windows = []
        with open(valid_path) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                windows.append([int(i) for i in line.strip().split(",")])
        valid = img_time < 0
        for start, end in windows:
            valid |= (img_time >= start) & (img_time <= end)
        return np.arange(len(img_time))[valid], img_time[valid]

    def setup_poses(self, sensor_data, valid_time):
        """GPS/IMU -> left and right c2w at valid_time: rotations Slerp'd
        from the roll/pitch/azimuth log, positions linearly interpolated
        in UTM, centred on the path's box and scaled by half its largest
        side."""
        from scipy.interpolate import interp1d
        from scipy.spatial.transform import Rotation as R, Slerp

        t = sensor_data["field.header.stamp"]
        euler = np.stack([sensor_data["field.pitch"],
                          sensor_data["field.roll"],
                          -sensor_data["field.azimuth"]]).T
        rot = R.from_euler("xyz", euler, degrees=True).as_matrix()
        to_cv = np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0.0]])
        rot_sample = Slerp(t, R.from_matrix(rot @ to_cv))(
            valid_time).as_matrix()

        east, north = latlon_to_utm(sensor_data["field.latitude"],
                                    sensor_data["field.longitude"])
        pos = np.stack([east, north, sensor_data["field.height"]])
        pos_sample = interp1d(t, pos)(valid_time).T
        pt_min, pt_max = pos_sample.min(0), pos_sample.max(0)
        center = (pt_min + pt_max) / 2
        scale = np.max(pt_max - pt_min) / 2
        pos_sample = (pos_sample - center[None]) / scale

        n = len(pos_sample)
        c2w_l = np.zeros((n, 3, 4))
        c2w_l[:, :3, :3] = rot_sample
        c2w_l[:, :3, -1] = pos_sample
        c2w_r = c2w_l.copy()
        c2w_r[:, :3, -1] = pos_sample \
            + rot_sample[:, :, 0] * BASELINE_M / scale
        c2w = np.concatenate([c2w_l, c2w_r], 0).astype(np.float32)
        self.poses = c2w
        if self.split != "train":
            render_c2w = generate_interpolated_path(c2w, 5)[:400]
            self.render_c2w = render_c2w.astype(np.float32)
            self.render_traj_rays = PathRays(self.directions, render_c2w)

    def read_rgb(self, dir_rgb, valid_ids):
        out = []
        for i in valid_ids:
            img = read_u8(os.path.join(dir_rgb, f"{i:0>5d}.png"))
            if (img.shape[1], img.shape[0]) != self.img_wh:
                img = resize_linear_u8(img, self.img_wh)
            out.append((img / 255.0).astype(np.float32).reshape(-1, 3))
        return np.stack(out)

    def read_semantics(self, dir_sem, valid_ids):
        out = []
        for i in valid_ids:
            label = read_u8(os.path.join(dir_sem, f"{i:0>5d}.pgm"),
                            gray=True)
            if (label.shape[1], label.shape[0]) != self.img_wh:
                label = resize_nearest(label, self.img_wh)
            out.append(label.flatten().astype(np.int64))
        return np.stack(out)

    def read_normal(self, dir_normal, valid_ids, half):
        n = len(valid_ids)
        poses = self.poses[half * n:(half + 1) * n]
        out = []
        for c2w, i in zip(poses, valid_ids):
            img = np.load(os.path.join(dir_normal, f"{i:0>5d}_normal.npy")
                          ).transpose(1, 2, 0)
            normal = ((img - 0.5) * 2).reshape(-1, 3)
            out.append(normal @ c2w[:, :3].T)
        return np.stack(out)
