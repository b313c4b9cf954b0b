"""The port's on-disk loaders (ingp_tpu_torch/data: nerf, nsvf, nerfpp,
tnt, colmap) against the JAX package's on fixtures written here, split
by split, with and without a resize: rays equal without one (uint8 / 255
is exact) and within 5e-7 with one (cv2.resize's float sums against the
port's), poses, K, directions, labels, depths, exposures and the test
trajectories' poses equal, render_traj_rays within 1e-6 (JAX builds them
with jnp), dtypes equal; the ray directions' options and the host pose
helpers equal. And the fixtures themselves: the port's Blender writer
writes JAX's files, and the NSVF and TNT writers' cameras come back
through the loaders."""
import json
import os
import struct

import numpy as np
import pytest
from PIL import Image

from ingp_tpu.data import dataset_dict as jax_datasets
from ingp_tpu.utils.blender_fixture import \
    write_blender_scene as jax_write_blender
from ingp_tpu_torch.data import dataset_dict
from ingp_tpu_torch.data.image_io import read_png
from ingp_tpu_torch.data.synthetic import trace_scene
from ingp_tpu_torch.utils import blender_fixture as fx
from tests._torch_threads import one_torch_thread  # noqa: F401

RESIZE_TOL = 5e-7
TRAJ_TOL = 1e-6
ATTRS = ("rays", "poses", "K", "directions", "labels", "depths_2d",
         "pts3d", "up", "c2w", "unit_exposure_rgb", "shift", "scale")


def _same(name, root, split, resized=False, **kw):
    """Load `split` of root with both packages' `name` loader and hold
    every array the JAX one has to the port's."""
    ref = jax_datasets[name](root_dir=str(root), split=split, **kw)
    got = dataset_dict[name](root_dir=str(root), split=split, **kw)
    assert got.img_wh == ref.img_wh
    for attr in ATTRS:
        if not hasattr(ref, attr):
            assert not hasattr(got, attr), attr
            continue
        a, b = np.asarray(getattr(ref, attr)), np.asarray(getattr(got, attr))
        assert a.dtype == b.dtype and a.shape == b.shape, attr
        if attr == "rays" and resized:
            assert np.abs(a - b).max() <= RESIZE_TOL
        else:
            np.testing.assert_array_equal(b, a, err_msg=attr)
    assert hasattr(got, "render_traj_rays") == hasattr(ref,
                                                       "render_traj_rays")
    if hasattr(ref, "render_traj_rays"):
        assert sorted(got.render_traj_rays) == sorted(ref.render_traj_rays)
        for k, v in ref.render_traj_rays.items():
            w = got.render_traj_rays[k]
            assert w.dtype == np.float32 and w.shape == v.shape
            assert np.abs(w - np.asarray(v)).max() <= TRAJ_TOL
    return ref, got


def _retraces(ds):
    """The loader's poses and directions are the writer's cameras: the
    scene traced along its rays gives its stored pixels (to 8 bits), the
    background black."""
    for pose, rays in zip(ds.poses, ds.rays):
        rd = ds.directions @ pose[:, :3].T
        ro = np.broadcast_to(pose[:, 3].astype(np.float64), rd.shape)
        rgb, _, hit, _, _ = trace_scene(ro, rd)
        assert 0.05 < hit.mean() < 0.95
        np.testing.assert_allclose(rays[hit], rgb[hit], atol=1.5 / 255)
        np.testing.assert_array_equal(rays[~hit], 0.0)


def _rgb_png(path, hw, rng):
    Image.fromarray(rng.integers(0, 256, hw + (3,), dtype=np.uint8)).save(
        path)


def _pose(rng):
    """A random c2w (4, 4): a rotation and a position ~ 3 from the
    origin."""
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    m = np.eye(4)
    m[:3, :3] = q
    m[:3, 3] = 3 * rng.normal(size=3)
    return m


def test_blender_writer_writes_jax_files_and_nerf_loads_them(tmp_path):
    jax_write_blender(str(tmp_path / "jax"), img_size=32, n_train=3,
                      n_test=2)
    ds = fx.write_blender_scene(str(tmp_path / "port"), img_size=32,
                                n_train=3, n_test=2)
    assert ds == 32 / 800
    for split, n in (("train", 3), ("test", 2)):
        for r in ("jax", "port"):
            with open(tmp_path / r / f"transforms_{split}.json") as f:
                meta = json.load(f)
            if r == "jax":
                first = meta
        assert meta == first
        for i in range(n):
            np.testing.assert_array_equal(
                read_png(tmp_path / "port" / split / f"r_{i}.png"),
                np.asarray(Image.open(tmp_path / "jax" / split
                                      / f"r_{i}.png")))
        _same("nerf", tmp_path / "port", split, downsample=ds)
        _same("nerf", tmp_path / "port", split, resized=True,
              downsample=16 / 800)


def test_nsvf_synthetic_lego(tmp_path):
    root = tmp_path / "Synthetic_NeRF" / "Lego"
    ds = fx.write_nsvf_scene(str(root), img_size=32, n_train=3, n_test=2)
    ref, got = _same("nsvf", root, "train", downsample=ds)
    assert got.scale == pytest.approx(1.05 * 1.1)
    assert got.rays.shape == (3, 32 * 32, 3)
    _retraces(got)
    _same("nsvf", root, "test", downsample=ds)
    _same("nsvf", root, "train", resized=True, downsample=16 / 800)
    traj = np.stack([_pose(np.random.default_rng(i)) for i in range(3)])
    np.savetxt(root / "test_traj.txt", traj.reshape(-1, 4))
    _same("nsvf", root, "test_traj", downsample=ds)


def test_nsvf_writer_pool_frames_retrace(tmp_path):
    """From POOL_MIN_SIZE px the writer's frames come from spawned
    processes: the scene traced along the loaded rays gives them."""
    root = tmp_path / "Synthetic_NeRF" / "Lego"
    size = fx.POOL_MIN_SIZE
    ds = fx.write_nsvf_scene(str(root), img_size=size, n_train=2, n_test=1)
    got = dataset_dict["nsvf"](root_dir=str(root), split="train",
                               downsample=ds)
    assert got.rays.shape == (2, size * size, 3)
    _retraces(got)


def test_nsvf_blendedmvs_rgba_intrinsics_and_black_background(tmp_path):
    root = tmp_path / "BlendedMVS" / "Jade"
    rng = np.random.default_rng(1)
    for sub in ("rgb", "pose"):
        os.makedirs(root / sub)
    np.savetxt(root / "intrinsics.txt",
               np.array([[20.0, 0, 12, 0], [0, 20, 9, 0], [0, 0, 1, 0],
                         [0, 0, 0, 1]]))
    np.savetxt(root / "bbox.txt", [[-1.0, -2, -1, 1, 1, 2, 0.1]])
    for prefix, n in (("0_", 3), ("1_", 2)):
        for i in range(n):
            img = rng.integers(0, 256, (18, 24, 4), dtype=np.uint8)
            img[:4] = (10, 10, 10, 255)  # dark: the loader makes them white
            img[4:6, :, 3] = 0  # transparent: blended to white
            Image.fromarray(img).save(root / "rgb" / f"{prefix}{i:04d}.png")
            np.savetxt(root / "pose" / f"{prefix}{i:04d}.txt", _pose(rng))
    for split in ("train", "test", "trainval"):
        # 768 x 576 at 1/32: 24 x 18, no resize; at 1/64: 12 x 9
        _same("nsvf", root, split, downsample=1 / 32)
        _same("nsvf", root, split, resized=True, downsample=1 / 64)


def test_nerfpp(tmp_path):
    rng = np.random.default_rng(2)
    for split, n in (("train", 3), ("val", 2), ("test", 2)):
        for sub in ("rgb", "pose", "intrinsics"):
            os.makedirs(tmp_path / split / sub)
        for i in range(n):
            _rgb_png(tmp_path / split / "rgb" / f"{i:06d}.png", (14, 20), rng)
            np.savetxt(tmp_path / split / "pose" / f"{i:06d}.txt",
                       _pose(rng).reshape(1, 16))
            np.savetxt(tmp_path / split / "intrinsics" / f"{i:06d}.txt",
                       np.array([[18.0, 0, 10, 0, 0, 18, 7, 0, 0, 0, 1, 0,
                                  0, 0, 0, 1]]))
    os.makedirs(tmp_path / "camera_path" / "pose")
    for i in range(3):
        np.savetxt(tmp_path / "camera_path" / "pose" / f"{i:06d}.txt",
                   _pose(rng).reshape(1, 16))
    for split in ("train", "test", "trainval", "test_traj"):
        _same("nerfpp", tmp_path, split)
    _same("nerfpp", tmp_path, "train", resized=True, downsample=0.5)


def test_tnt_with_semantics_depth_and_trajectories(tmp_path):
    root = tmp_path / "TanksAndTempleBG" / "Playground"
    fx.write_tnt_scene(str(root), img_wh=(32, 18), n_train=4, n_test=2)
    kw = dict(use_sem=True, depth_mono=True)
    ref, got = _same("tnt", root, "train", **kw)
    assert got.labels.dtype == np.int64 and got.labels.max() > 0
    assert got.rays.shape == (4, 32 * 18, 3)
    _retraces(got)
    _same("tnt", root, "test", **kw)  # camera_path: render_traj_rays
    _same("tnt", root, "test", render_train=True)
    _same("tnt", root, "train", resized=True, downsample=0.5, use_sem=True)
    # the same batch from the same draws
    a = ref.sample_batch(np.random.default_rng(5), 64)
    b = got.sample_batch(np.random.default_rng(5), 64)
    assert sorted(a) == sorted(b) == ["depth", "img_idxs", "label",
                                      "pix_idxs", "rgb", "uv"]
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def _write_colmap(root, names, rng, model=1, hw=(12, 16)):
    """sparse/0/{cameras,images,points3D}.bin (tests/test_data.py's
    writer, at n images and camera model `model`: 1 PINHOLE, 2
    SIMPLE_RADIAL)."""
    os.makedirs(root / "sparse" / "0")
    h, w = hw
    with open(root / "sparse/0/cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, model, w, h))
        f.write(struct.pack("<dddd", *((15.0, 15.0, 8.0, 6.0) if model == 1
                                       else (15.0, 8.0, 6.0, 0.01))))
    with open(root / "sparse/0/images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(names)))
        for i, name in enumerate(names):
            q = rng.normal(size=4)
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<dddd", *(q / np.linalg.norm(q))))
            f.write(struct.pack("<ddd", *(2 * rng.normal(size=3))))
            f.write(struct.pack("<i", 1))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<ddq", 1.0, 2.0, 7))
    with open(root / "sparse/0/points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", 3))
        for i in range(3):
            f.write(struct.pack("<Q", i))
            f.write(struct.pack("<ddd", *rng.normal(size=3)))
            f.write(struct.pack("<BBB", 10, 20, 30))
            f.write(struct.pack("<d", 0.5))
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<ii", 1, 0))


def test_colmap_splits_trajectories_and_semantics(tmp_path):
    rng = np.random.default_rng(3)
    # 40 images: 5 test views, so render_traj's spline has 480 poses and
    # its [400:800] slice 80
    names = [f"img_{i:03d}.png" for i in range(40)][::-1]
    _write_colmap(tmp_path, names, rng)
    os.makedirs(tmp_path / "images")
    os.makedirs(tmp_path / "semantic")
    for name in names:
        _rgb_png(tmp_path / "images" / name, (12, 16), rng)
        Image.fromarray(rng.integers(0, 7, (12, 16), dtype=np.uint8)).save(
            tmp_path / "semantic" / (name[:-4] + ".pgm"))
    _same("colmap", tmp_path, "train", use_sem=True)
    ref, got = _same("colmap", tmp_path, "test", render_traj=True)
    assert len(got.render_traj_rays) == 80
    _same("colmap", tmp_path, "test")
    _same("colmap", tmp_path, "test_traj")
    _same("colmap", tmp_path, "train", resized=True, downsample=0.5,
          use_sem=True)
    radial = tmp_path / "radial"
    _write_colmap(radial, ["a.png", "b.png"], rng, model=2)
    got = dataset_dict["colmap"](root_dir=str(radial), split="train",
                                 read_meta=False)
    ref = jax_datasets["colmap"](root_dir=str(radial), split="train",
                                 read_meta=False)
    np.testing.assert_array_equal(got.K, ref.K)
    np.testing.assert_array_equal(got.directions, ref.directions)


def test_colmap_hdr_exposures_and_real_jpeg(tmp_path):
    rng = np.random.default_rng(4)
    root = tmp_path / "HDR-NeRF" / "syndata" / "bathroom"
    _write_colmap(root, [f"{i:03d}.png" for i in range(20)], rng, hw=(6, 8))
    for split, views in (("train", range(2, 20)), ("test", range(17))):
        os.makedirs(root / split)
        for v in views:
            for e in range(5):
                _rgb_png(root / split / f"{v:03d}_{e}.png", (6, 8), rng)
    ref, got = _same("colmap", root, "train")
    assert got.rays.shape == (54, 48, 4)
    assert sorted(set(got.rays[:, 0, 3])) == pytest.approx([1 / 8, 2, 32])
    _same("colmap", root, "test")
    a = ref.sample_batch(np.random.default_rng(6), 32)
    b = got.sample_batch(np.random.default_rng(6), 32)
    assert "exposure" in b and sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    real = tmp_path / "HDR-NeRF" / "real" / "flower"
    _write_colmap(real, [f"{i:03d}.jpg" for i in range(4)], rng, hw=(6, 8))
    os.makedirs(real / "input_images")
    for v in range(4):
        for e in range(5):
            Image.fromarray(rng.integers(0, 256, (6, 8, 3), dtype=np.uint8)
                            ).save(real / "input_images" / f"{v:03d}_{e}.jpg")
    # the real scenes' JPEGs (PIL's 4:2:0) decode equal to JAX's imageio
    for split, n in (("train", 6), ("test", 4)):
        _, got = _same("colmap", real, split)
        assert got.rays.shape == (n, 48, 4)
        assert got.unit_exposure_rgb == 0.5


def test_ray_directions_and_pose_helpers_match_jax():
    from ingp_tpu.core import rays as jr
    from ingp_tpu_torch.core import rays as tr
    K = np.float32([[20.0, 0, 9.5], [0, 21, 7], [0, 0, 1]])
    for kw in ({}, {"flatten": False}, {"return_uv": True},
               {"anti_aliasing_factor": 2.0}):
        a = jr.get_ray_directions(14, 19, K, **kw)
        b = tr.get_ray_directions(14, 19, K, **kw)
        pairs = zip(a, b) if kw.get("return_uv") else [(a, b)]
        for x, y in pairs:
            assert y.dtype == x.dtype and y.shape == x.shape
            np.testing.assert_array_equal(y, x)
    a = jr.get_ray_directions(6, 5, K, random=True,
                              rng=np.random.default_rng(3))
    b = tr.get_ray_directions(6, 5, K, random=True,
                              rng=np.random.default_rng(3))
    np.testing.assert_array_equal(b, a)
    rng = np.random.default_rng(7)
    poses = np.stack([_pose(rng)[:3] for _ in range(6)])
    pts = rng.normal(size=(9, 3))
    np.testing.assert_array_equal(tr.average_poses(poses, pts),
                                  jr.average_poses(poses, pts))
    for got, ref in ((tr.center_poses(poses), jr.center_poses(poses)),
                     (tr.center_poses(poses, pts)[1],
                      jr.center_poses(poses, pts)[1])):
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        tr.viewmatrix(poses[0, :, 2], poses[0, :, 1], poses[0, :, 3]),
        jr.viewmatrix(poses[0, :, 2], poses[0, :, 1], poses[0, :, 3]))
    np.testing.assert_array_equal(tr.create_spheric_poses(1.2, 0.3, 12),
                                  jr.create_spheric_poses(1.2, 0.3, 12))
    np.testing.assert_array_equal(tr.generate_interpolated_path(poses, 10),
                                  jr.generate_interpolated_path(poses, 10))
