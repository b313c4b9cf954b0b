"""Dataset registry (counterpart of ingp_tpu/data/__init__.py).

The on-disk loaders nerf, nsvf, nerfpp, tnt, colmap, kitti and highbay
and the procedural `synthetic` scene are ported; mega raises
NotImplementedError."""
from .base import BaseDataset
from .colmap import ColmapDataset
from .highbay import HighbayDataset
from .kitti360 import KittiDataset
from .nerf import NeRFDataset
from .nerfpp import NeRFPPDataset
from .nsvf import NSVFDataset
from .synthetic import SyntheticDataset, sphere_density_grid
from .tnt import TNTDataset

DATASET_NAMES = ("nerf", "nsvf", "colmap", "nerfpp", "tnt", "kitti", "mega",
                 "highbay", "synthetic")


def _not_ported(name):
    def ctor(*a, **k):
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet (ROADMAP.md Queue 1 item "
            f"1: JPEG and the mega loader)")
    return ctor


dataset_dict = {name: _not_ported(name) for name in DATASET_NAMES}
dataset_dict.update(nerf=NeRFDataset, nsvf=NSVFDataset, colmap=ColmapDataset,
                    nerfpp=NeRFPPDataset, tnt=TNTDataset, kitti=KittiDataset,
                    highbay=HighbayDataset, synthetic=SyntheticDataset)
