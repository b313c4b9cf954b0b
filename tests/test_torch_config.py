"""The port's flags (ingp_tpu_torch/training/config.py) against the JAX
package's (ingp_tpu/training/config.py): `get_opts` gives the same
namespace, field by field, on every configs/*.txt, on no config, and
with command-line flags overriding a config's values; and the port's
dataset registry (kitti, highbay and mega build on fixtures)."""
import glob
import os

import pytest

from ingp_tpu.training import config as jc
from ingp_tpu_torch.data import (HighbayDataset, KittiDataset,
                                 MegaDataset, SyntheticDataset, dataset_dict)
from ingp_tpu_torch.training import config as tc
from ingp_tpu_torch.utils.mega_fixture import write_mega_scene
from ingp_tpu_torch.utils.street_fixture import (write_highbay_scene,
                                                 write_kitti_scene)
from tests._torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.txt")))


def _same(argv):
    a, b = vars(tc.get_opts(argv)), vars(jc.get_opts(argv))
    assert set(a) == set(b)
    for k in b:
        assert a[k] == b[k], (k, a[k], b[k])
    return a


def test_there_are_configs():
    assert len(CONFIGS) >= 4
    assert any(p.endswith("synthetic_smoke.txt") for p in CONFIGS)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_get_opts_matches_on_config(path):
    _same(["--config", path])
    # a command-line flag wins over the file's value, in both
    a = _same(["--config", path, "--batch_size", "123", "--encoder",
               "brick"])
    assert a["batch_size"] == 123 and a["encoder"] == "brick"


def test_get_opts_matches_without_config():
    _same([])
    _same(["--dataset_name", "synthetic", "--no_stream_sort",
           "--kitti_test_id", "3", "4", "--sparsity_loss", "0.01"])
    assert tc.parse_config_file(CONFIGS[0]) == jc.parse_config_file(
        CONFIGS[0])


def test_dataset_registry(tmp_path):
    assert set(dataset_dict) == {"nerf", "nsvf", "colmap", "nerfpp", "tnt",
                                 "kitti", "mega", "highbay", "synthetic"}
    ds = dataset_dict["synthetic"](split="test", root_dir=None,
                                   downsample=0.125)
    assert isinstance(ds, SyntheticDataset) and ds.img_wh == (16, 16)
    # kitti, highbay and mega build on fixtures
    write_kitti_scene(str(tmp_path / "k"), frames=range(2, 6),
                      img_wh=(22, 6))
    ds = dataset_dict["kitti"](split="train", root_dir=str(tmp_path / "k"),
                               downsample=1.0, frame_start=2, frame_end=5)
    assert isinstance(ds, KittiDataset) and ds.rays.shape == (8, 132, 3)
    write_highbay_scene(str(tmp_path / "h"), img_wh=(12, 8), n_images=4,
                        valid=(0, 3))
    ds = dataset_dict["highbay"](split="train", root_dir=str(tmp_path / "h"),
                                 downsample=1.0)
    assert isinstance(ds, HighbayDataset) and ds.rays.shape == (8, 96, 3)
    write_mega_scene(str(tmp_path / "m"), n_train=3, n_val=1,
                     img_wh=(24, 16))
    ds = dataset_dict["mega"](split="train", root_dir=str(tmp_path / "m"),
                              downsample=0.5)
    assert isinstance(ds, MegaDataset) and ds.rays.shape == (3, 96, 3)
