"""The Mega-NeRF loaders (counterpart of ingp_tpu/data/mega/)."""
from .dataset import (MegaDataset, get_image_metadata,
                      get_image_metadata_partial, load_filesystem_dataset)
from .filesystem_dataset import FilesystemDataset
from .image_metadata import ImageMetadata
from .memory_dataset import MemoryDataset
