"""Concatenated multi-dataset database for domain-vocabulary building —
the reference's ``GlobalVLADVocabularyDataset``
(dino_v2_global_vocab_vlad.py:215-301): database images of each named dataset,
each sub-sampled at its own frequency. A copy of
``anyloc_tpu/data/loaders/global_vocab.py``."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

from anyloc_tpu_torch.data.base import VPRDataset


class GlobalVocabDataset(VPRDataset):
    def __init__(
        self,
        ds_names: List[str],
        datasets_folder: str,
        split: str = "test",
        ss_list: Union[int, List[int], Dict[str, int]] = 1,
        img_size: Optional[Tuple[int, int]] = (320, 320),
    ) -> None:
        from anyloc_tpu_torch.data.registry import get_dataset

        if isinstance(ss_list, int):
            ss = {n: ss_list for n in ds_names}
        elif isinstance(ss_list, dict):
            ss = ss_list
        else:
            ss = dict(zip(ds_names, ss_list))
        db_paths: List[str] = []
        self.db_stat: Dict[str, int] = {}
        for name in ds_names:
            ds = get_dataset(name, datasets_folder, split, img_size)
            paths = ds.get_image_paths()[: ds.database_num : ss.get(name, 1)]
            db_paths.extend(paths)
            self.db_stat[name] = len(paths)
        super().__init__(db_paths, [], None, img_size)

    @classmethod
    def from_domain(cls, domain: str, datasets_folder: str, split: str = "test",
                    img_size=(320, 320)) -> "GlobalVocabDataset":
        from anyloc_tpu_torch.data.registry import DOMAIN_RECIPES

        recipe = DOMAIN_RECIPES[domain]
        return cls(
            list(recipe), datasets_folder, split, dict(recipe), img_size
        )
