"""Dataset registry (counterpart of ingp_tpu/data/__init__.py): the
on-disk loaders nerf, nsvf, nerfpp, tnt, colmap, kitti, mega and highbay
and the procedural `synthetic` scene. The Block-NeRF extractor
(block.py) and the snow sampler (snow.py) stay outside it, as in JAX."""
from .base import BaseDataset
from .colmap import ColmapDataset
from .highbay import HighbayDataset
from .kitti360 import KittiDataset
from .mega import MegaDataset
from .nerf import NeRFDataset
from .nerfpp import NeRFPPDataset
from .nsvf import NSVFDataset
from .synthetic import SyntheticDataset, sphere_density_grid
from .tnt import TNTDataset

dataset_dict = {"nerf": NeRFDataset, "nsvf": NSVFDataset,
                "colmap": ColmapDataset, "nerfpp": NeRFPPDataset,
                "tnt": TNTDataset, "kitti": KittiDataset, "mega": MegaDataset,
                "highbay": HighbayDataset, "synthetic": SyntheticDataset}
