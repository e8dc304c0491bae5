"""Dataset layer: the VPRDataset protocol, the per-dataset loaders behind
the registry, transforms and fixed-shape batch iteration (a copy of
``anyloc_tpu/data``'s framework-free modules)."""

from anyloc_tpu_torch.data.base import VPRDataset, natsorted
from anyloc_tpu_torch.data.registry import dataset_names, get_dataset

__all__ = ["VPRDataset", "dataset_names", "get_dataset", "natsorted"]
