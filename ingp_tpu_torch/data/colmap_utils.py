"""COLMAP binary model readers, cameras.bin, images.bin and points3D.bin
(counterpart of ingp_tpu/data/colmap_utils.py), and qvec2rotmat."""
from __future__ import annotations

import collections
import struct

import numpy as np

Camera = collections.namedtuple(
    "Camera", ["id", "model", "width", "height", "params"])
Image = collections.namedtuple(
    "Image", ["id", "qvec", "tvec", "camera_id", "name", "xys",
              "point3D_ids"])
Point3D = collections.namedtuple(
    "Point3D", ["id", "xyz", "rgb", "error", "image_ids", "point2D_idxs"])

# COLMAP camera model id -> (name, number of params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


def qvec2rotmat(qvec):
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y ** 2 - 2 * z ** 2, 2 * x * y - 2 * z * w,
         2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x ** 2 - 2 * z ** 2,
         2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w,
         1 - 2 * x ** 2 - 2 * y ** 2]])


def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_binary(path):
    cameras = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, "<" + "d" * n_params))
            cameras[cam_id] = Camera(cam_id, name, width, height, params)
    return cameras


def read_images_binary(path):
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            (im_id,) = _read(f, "<i")
            qvec = np.array(_read(f, "<dddd"))
            tvec = np.array(_read(f, "<ddd"))
            (cam_id,) = _read(f, "<i")
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (n_pts,) = _read(f, "<Q")
            data = np.frombuffer(f.read(24 * n_pts),
                                 dtype=[("xy", "<f8", 2), ("id", "<i8")])
            images[im_id] = Image(im_id, qvec, tvec, cam_id,
                                  name.decode("utf-8"), data["xy"].copy(),
                                  data["id"].copy())
    return images


def read_points3d_binary(path):
    points = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            (pt_id,) = _read(f, "<Q")
            xyz = np.array(_read(f, "<ddd"))
            rgb = np.array(_read(f, "<BBB"))
            (error,) = _read(f, "<d")
            (track_len,) = _read(f, "<Q")
            track = np.frombuffer(f.read(8 * track_len),
                                  dtype=[("im", "<i4"), ("p2d", "<i4")])
            points[pt_id] = Point3D(pt_id, xyz, rgb, error,
                                    track["im"].copy(), track["p2d"].copy())
    return points
