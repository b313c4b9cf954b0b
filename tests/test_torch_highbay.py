"""The port's highbay loader (ingp_tpu_torch/data/highbay.py) against the
JAX package's on a fixture written here (utils/street_fixture.py: left
labels as 8-bit PGMs, right as 16-bit), split by split at downsamples 1,
0.5 and 0.3: rays, labels and img_wh equal; poses, normals and
render_c2w within 1e-6 of their largest |value|, and the trajectory's
rays 0, 1 and its last. The readers beside it: `read_u8` against
cv2.imread on 8- and 16-bit PGMs and on PNGs, gps.csv's columns against
pandas (values and dtypes), the UTM projection against JAX's; and a
highbay scene trained for two steps through `train.main`."""
import os

import cv2
import numpy as np
import pandas as pd
import pytest

from ingp_tpu.data import dataset_dict as jax_datasets
from ingp_tpu.data import highbay as jh
from ingp_tpu_torch import train as train_cli
from ingp_tpu_torch.data import dataset_dict
from ingp_tpu_torch.data import highbay as th
from ingp_tpu_torch.data.image_io import read_u8, write_pgm, write_png
from ingp_tpu_torch.utils.street_fixture import write_highbay_scene
from tests._torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-6


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = tmp_path_factory.mktemp("rig") / "highbay"
    write_highbay_scene(str(path))
    return str(path)


def _close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, what
    assert np.abs(a.astype(np.float64) - b).max() <= TOL * np.abs(b).max(), \
        what


@pytest.mark.parametrize("downsample", [1.0, 0.5, 0.3])
@pytest.mark.parametrize("split", ["train", "test"])
def test_loader_matches_jax(root, split, downsample):
    kw = dict(root_dir=root, split=split, downsample=downsample)
    ref, got = jax_datasets["highbay"](**kw), dataset_dict["highbay"](**kw)
    assert got.img_wh == ref.img_wh
    for attr in ("rays", "labels", "K", "directions"):
        assert hasattr(got, attr) == hasattr(ref, attr), attr
        if hasattr(ref, attr):
            a, b = getattr(ref, attr), getattr(got, attr)
            assert a.dtype == b.dtype, attr
            np.testing.assert_array_equal(b, a, err_msg=attr)
    for attr in ("poses", "normals", "render_c2w"):
        assert hasattr(got, attr) == hasattr(ref, attr), attr
        if hasattr(ref, attr):
            _close(getattr(got, attr), getattr(ref, attr), attr)
    assert len(got.poses) == 20
    if split == "train":
        # both label depths came through: ids 0-6 from either side
        assert got.labels.max() <= 6 and len(np.unique(got.labels)) > 1
    else:
        traj, traj_ref = got.render_traj_rays, ref.render_traj_rays
        assert len(traj) == len(traj_ref) == 95
        for i in (0, 1, len(traj_ref) - 1):
            _close(traj[i], np.asarray(traj_ref[i]), f"traj {i}")


def test_read_u8_equals_cv2(tmp_path):
    rng = np.random.default_rng(1)
    gray8 = rng.integers(0, 256, (9, 13), dtype=np.uint8)
    gray16 = rng.integers(0, 65536, (9, 13)).astype(np.uint16)
    gray16[0, :4] = (0, 255, 256, 65535)
    rgb = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    write_pgm(tmp_path / "a8.pgm", gray8)
    write_pgm(tmp_path / "a16.pgm", gray16)
    write_png(tmp_path / "g.png", gray8)
    write_png(tmp_path / "c.png", rgb)
    write_png(tmp_path / "ca.png", np.concatenate(
        [rgb, np.full((9, 13, 1), 7, np.uint8)], 2))
    for name in ("a8.pgm", "a16.pgm", "g.png"):
        path = str(tmp_path / name)
        ref = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        got = read_u8(path, gray=True)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref, err_msg=name)
    for name in ("c.png", "ca.png", "g.png"):
        path = str(tmp_path / name)
        ref = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(read_u8(path), ref, err_msg=name)
    with pytest.raises(ValueError, match="as gray"):
        read_u8(str(tmp_path / "c.png"), gray=True)


def test_gps_columns_and_utm_match(root):
    path = os.path.join(root, "gps.csv")
    ref = pd.read_csv(path)
    got = th.read_csv_columns(path)
    assert list(got) == list(ref.columns)
    for name in ref.columns:
        col = np.array(ref[name])
        assert got[name].dtype == col.dtype, name
        np.testing.assert_array_equal(got[name], col, err_msg=name)
    assert got["field.header.stamp"].dtype == np.int64
    lat = np.linspace(-60, 70, 11)
    lon = np.linspace(-179, 179, 11)
    for a, b in zip(th.latlon_to_utm(lat, lon), jh.latlon_to_utm(lat, lon)):
        np.testing.assert_array_equal(a, b)


def test_highbay_trains_through_train_main(tmp_path, monkeypatch):
    root = str(tmp_path / "rig")
    write_highbay_scene(root, img_wh=(24, 16), n_images=4, valid=(1, 2))
    monkeypatch.chdir(tmp_path)
    metrics = train_cli.main([
        "--dataset_name", "highbay", "--root_dir", root, "--exp_name", "hb",
        "--scale", "2.0", "--num_epochs", "1", "--steps_per_epoch", "2",
        "--batch_size", "256", "--density_L", "2", "--rgb_L", "2",
        "--density_log2T", "10", "--rgb_log2T", "10", "--grid_size", "16",
        "--march_iters", "64", "--capacity", "16", "--samples_per_ray", "8",
        "--no_save_test"], device="cpu")
    assert np.isfinite(metrics["psnr"]) and 0 < metrics["ssim"] <= 1
    assert (tmp_path / "ckpts" / "highbay" / "hb" / "last").exists()
