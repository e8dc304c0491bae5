"""Per-dataset loaders reproducing the reference's ground-truth logic (a
copy of ``anyloc_tpu/data/loaders``, which cannot be imported without JAX)."""

from anyloc_tpu_torch.data.loaders.simple_gt import Eiffel, Gardens, VPAir, VPAirDistractor
from anyloc_tpu_torch.data.loaders.pose_gt import Baidu, Hawkins, Laurel, NaverLabs
from anyloc_tpu_torch.data.loaders.oxford import Oxford
from anyloc_tpu_torch.data.loaders.aerial import Aerial
from anyloc_tpu_torch.data.loaders.base_dataset import BaseDataset
from anyloc_tpu_torch.data.loaders.global_vocab import GlobalVocabDataset

__all__ = [
    "Eiffel",
    "Gardens",
    "VPAir",
    "VPAirDistractor",
    "Baidu",
    "Hawkins",
    "Laurel",
    "NaverLabs",
    "Oxford",
    "Aerial",
    "BaseDataset",
    "GlobalVocabDataset",
]
