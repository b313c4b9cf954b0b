"""The port's KITTI-360 loader (ingp_tpu_torch/data/kitti360.py) against
the JAX package's on a fixture written here (utils/street_fixture.py),
split by split with nvs on and off and at downsamples 1, 0.5, 0.25 and
0.3: rays, labels and img_wh equal (the port resizes uint8 frames as
cv2.resize does, bit for bit); poses, normals, sun_dir, up_dir,
render_c2w and the trajectory's rays 0, 1 and its last (399 of a 400-pose
path) within 1e-6 of their largest |value|. The uint8 resize against cv2 itself, the calib,
solar and label helpers, the OXTS-less fixture, and
configs/kitti360_nvs_1538.txt: its depth_mono, which neither loader
gives a depth for, fails JAX's step and is refused by the port; without
it the config trains through `train.main` on the fixture."""
import os
import shutil

import cv2
import numpy as np
import pytest

from ingp_tpu.data import dataset_dict as jax_datasets
from ingp_tpu.data import kitti360 as jk
from ingp_tpu_torch import train as train_cli
from ingp_tpu_torch.data import dataset_dict
from ingp_tpu_torch.data import kitti360 as tk
from ingp_tpu_torch.data.image_io import resize_linear_u8
from ingp_tpu_torch.utils.street_fixture import write_kitti_scene
from tests._torch_threads import one_torch_thread  # noqa: F401

FRAMES = range(4, 12)
TOL = 1e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KITTI_CONFIG = os.path.join(ROOT, "configs", "kitti360_nvs_1538.txt")
SMALL = ["--kitti_start", str(FRAMES[0]), "--kitti_end", str(FRAMES[-1]),
         "--kitti_test_id", "7", "--num_epochs", "1", "--steps_per_epoch",
         "2", "--batch_size", "256", "--density_L", "2", "--rgb_L", "2",
         "--density_log2T", "10", "--rgb_log2T", "10", "--grid_size", "16",
         "--march_iters", "64", "--capacity", "16", "--samples_per_ray",
         "8", "--chunk_size", "4096"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = tmp_path_factory.mktemp("street") / "kitti"
    write_kitti_scene(str(path), frames=FRAMES, img_wh=(88, 24))
    return str(path)


def _kw(root, **kw):
    return dict(root_dir=root, frame_start=FRAMES[0], frame_end=FRAMES[-1],
                test_id=[7], **kw)


def _close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, what
    assert np.abs(a.astype(np.float64) - b).max() <= TOL * np.abs(b).max(), \
        what


@pytest.mark.parametrize("downsample", [1.0, 0.5, 0.25, 0.3])
@pytest.mark.parametrize("nvs", [False, True])
@pytest.mark.parametrize("split", ["train", "test"])
def test_loader_matches_jax(root, split, nvs, downsample):
    kw = _kw(root, split=split, nvs=nvs, downsample=downsample)
    ref, got = jax_datasets["kitti"](**kw), dataset_dict["kitti"](**kw)
    assert got.img_wh == ref.img_wh
    for attr in ("rays", "labels", "K", "directions"):
        assert hasattr(got, attr) == hasattr(ref, attr), attr
        if hasattr(ref, attr):
            a, b = getattr(ref, attr), getattr(got, attr)
            assert a.dtype == b.dtype, attr
            np.testing.assert_array_equal(b, a, err_msg=attr)
    for attr in ("poses", "normals", "sun_dir", "up_dir", "render_c2w"):
        assert hasattr(got, attr) == hasattr(ref, attr), attr
        if hasattr(ref, attr):
            _close(getattr(got, attr), getattr(ref, attr), attr)
    assert got.scale == ref.scale
    n_train = 2 * len(FRAMES) - (2 if nvs else 0)
    assert len(got.poses) == (n_train if split == "train" else 2)
    if split == "test":
        traj, traj_ref = got.render_traj_rays, ref.render_traj_rays
        assert len(traj) == len(traj_ref) == 120
        for i in (0, 1, len(traj_ref) - 1):
            assert traj[i].dtype == np.float32
            _close(traj[i], np.asarray(traj_ref[i]), f"traj {i}")


def test_trajectory_is_built_per_entry(root):
    """Three test frames: 6 poses, a 600-pose path cut to its first 400,
    each entry built when read and equal to JAX's (0, 1 and 399)."""
    kw = dict(root_dir=root, frame_start=FRAMES[0], frame_end=FRAMES[-1],
              test_id=[5, 7, 9], split="test", downsample=0.5)
    ref, got = jax_datasets["kitti"](**kw), dataset_dict["kitti"](**kw)
    _close(got.render_c2w, ref.render_c2w, "render_c2w")
    assert len(got.render_traj_rays) == len(ref.render_traj_rays) == 400
    for i in (0, 1, 399):
        _close(got.render_traj_rays[i], np.asarray(ref.render_traj_rays[i]),
               f"traj {i}")
    with pytest.raises(KeyError):
        got.render_traj_rays[400]


@pytest.mark.parametrize("factor", [0.5, 0.25, 0.3, 1.5])
def test_resize_u8_equals_cv2(factor):
    rng = np.random.default_rng(3)
    for shape in ((47, 163, 3), (47, 163), (376, 1408, 3)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        wh = (int(shape[1] * factor), int(shape[0] * factor))
        np.testing.assert_array_equal(resize_linear_u8(img, wh),
                                      cv2.resize(img, wh))


def test_helpers_match_jax(root):
    import datetime
    path = os.path.join(root, "calibration", "perspective.txt")
    for key in ("P_rect_00", "S_rect_00", "R_rect_01", "missing"):
        a, b = tk.parse_calib_file(path, key), jk.parse_calib_file(path, key)
        assert (a is None and b is None) or np.array_equal(a, b)
    rng = np.random.default_rng(0)
    for _ in range(5):
        when = datetime.datetime(2013, 5, 28, int(rng.integers(0, 24)),
                                 int(rng.integers(0, 60)),
                                 tzinfo=datetime.timezone.utc)
        lat, lon = rng.uniform(-60, 60), rng.uniform(-180, 180)
        assert tk.solar_position(lat, lon, when) == \
            jk.solar_position(lat, lon, when)
        ang = rng.uniform(-3, 3, 3)
        np.testing.assert_array_equal(tk._euler_xyz(*ang),
                                      jk._euler_xyz(*ang))
    ids = np.arange(-1, 260).astype(np.uint8)
    np.testing.assert_array_equal(tk.label_mapping(ids),
                                  jk.KittiDataset.label_mapping(ids))


def test_without_oxts_the_sun_is_skipped(root, tmp_path, capsys):
    bare = str(tmp_path / "bare")
    shutil.copytree(root, bare)
    shutil.rmtree(os.path.join(bare, "data_poses",
                               "2013_05_28_drive_0000_sync", "oxts"))
    ref = jax_datasets["kitti"](**_kw(bare, split="train"))
    got = dataset_dict["kitti"](**_kw(bare, split="train"))
    assert not hasattr(ref, "sun_dir") and not hasattr(got, "sun_dir")
    assert "no OXTS directory" in capsys.readouterr().out
    # any other fault of the OXTS files propagates (JAX prints and skips)
    seq = os.path.join("data_poses", "2013_05_28_drive_0000_sync", "oxts")
    shutil.copytree(os.path.join(root, seq), os.path.join(bare, seq))
    with open(os.path.join(bare, seq, "timestamps.txt"), "w") as f:
        f.write("not a time\n" * 20)
    assert not hasattr(jax_datasets["kitti"](**_kw(bare, split="train")),
                       "sun_dir")
    with pytest.raises(ValueError):
        dataset_dict["kitti"](**_kw(bare, split="train"))


def _no_depth_config(tmp_path):
    with open(KITTI_CONFIG) as f:
        lines = [ln for ln in f if not ln.startswith("depth_mono")]
    path = tmp_path / "kitti_no_depth.txt"
    path.write_text("".join(lines))
    return str(path)


def test_kitti_config_depth_mono(root, tmp_path, monkeypatch):
    """JAX's step fails on the config's depth_mono (the batch has no
    "depth"); the port refuses it when the system is built; without the
    line the config trains and renders through `train.main`."""
    import jax
    import jax.numpy as jnp
    from ingp_tpu.training import config as jc
    from ingp_tpu.training import trainer as jt
    h = jc.get_opts(["--config", KITTI_CONFIG, "--root_dir", root] + SMALL)
    assert h.depth_mono
    kw = _kw(root, nvs=True)
    tr = jax_datasets["kitti"](split="train", **kw)
    jsys = jt.NeRFSystem(h, tr, jax_datasets["kitti"](split="test", **kw))
    b = tr.sample_batch(np.random.default_rng(0), 64)
    assert "depth" not in b
    with pytest.raises(KeyError, match="depth"):
        jsys.train_step(jsys.params, jsys.opt_state, jsys.grid["bitfield"],
                        jsys.grid["block_table"], jsys.directions,
                        jsys.poses, {k: jnp.asarray(v) for k, v in b.items()
                                     if k in jsys.BATCH_KEYS},
                        jnp.int32(0), jax.random.PRNGKey(1))
    monkeypatch.chdir(tmp_path)
    argv = ["--root_dir", root] + SMALL
    with pytest.raises(ValueError, match="depth_mono"):
        train_cli.main(["--config", KITTI_CONFIG] + argv, device="cpu")
    metrics = train_cli.main(["--config", _no_depth_config(tmp_path)]
                             + argv, device="cpu")
    assert np.isfinite(metrics["psnr"])
    out = tmp_path / "results" / "kitti" / "kitti360_nvs_1538"
    assert (out / "00000_rgb.png").exists()
    assert (tmp_path / "ckpts" / "kitti" / "kitti360_nvs_1538" /
            "last").exists()
