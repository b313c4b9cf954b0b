from .base import BaseDataset
from .synthetic import SyntheticDataset, sphere_density_grid
