"""The port's flags (ingp_tpu_torch/training/config.py) against the JAX
package's (ingp_tpu/training/config.py): `get_opts` gives the same
namespace, field by field, on every configs/*.txt, on no config, and
with command-line flags overriding a config's values; and the port's
dataset registry."""
import glob
import os

import pytest

from ingp_tpu.training import config as jc
from ingp_tpu_torch.data import SyntheticDataset, dataset_dict
from ingp_tpu_torch.training import config as tc

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


def test_dataset_registry():
    assert set(dataset_dict) == {"nerf", "nsvf", "colmap", "nerfpp", "tnt",
                                 "kitti", "mega", "highbay", "synthetic"}
    ds = dataset_dict["synthetic"](split="test", root_dir=None,
                                   downsample=0.125)
    assert isinstance(ds, SyntheticDataset) and ds.img_wh == (16, 16)
    for name in sorted(set(dataset_dict) - {"synthetic"}):
        with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
            dataset_dict[name](split="train", root_dir="x", downsample=1.0)
