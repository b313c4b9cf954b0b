"""Dataset registry (counterpart of ingp_tpu/data/__init__.py).

`synthetic`, the procedural scene that needs no files, is the one
loader ported; every other name raises NotImplementedError."""
from .base import BaseDataset
from .synthetic import SyntheticDataset, sphere_density_grid

DATASET_NAMES = ("nerf", "nsvf", "colmap", "nerfpp", "tnt", "kitti", "mega",
                 "highbay", "synthetic")


def _not_ported(name):
    def ctor(*a, **k):
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet (ROADMAP.md Queue 1 item "
            f"7: the data layer); only 'synthetic' is")
    return ctor


dataset_dict = {name: _not_ported(name) for name in DATASET_NAMES}
dataset_dict["synthetic"] = SyntheticDataset
