"""Nardo-Air / Tartan GNSS aerial datasets (ref aerial_dataloader.py:62-162):
dataset-name remap, reference_images / query_images dirs, GT from
``gt_matches.csv`` columns top_1..top_5 ref indices per query. A copy of
``anyloc_tpu/data/loaders/aerial.py``."""

from __future__ import annotations

import csv
import os
from typing import Optional, Tuple

import numpy as np

from anyloc_tpu_torch.data.base import VPRDataset, listdir_abs

_NAME_MAP = {
    "Tartan_GNSS_rotated": "gnss_train_rotated",
    "Tartan_GNSS_notrotated": "gnss_train_notrotated",
    "Tartan_GNSS_test_notrotated": "test_40_midref_rot0",
    "Tartan_GNSS_test_rotated": "test_40_midref_rot90",
}


class Aerial(VPRDataset):
    _imgs_level = 3  # ref aerial_dataloader.py:120-135

    def __init__(self, datasets_folder: str, dataset_name: str,
                 img_size: Optional[Tuple[int, int]] = (320, 320)) -> None:
        if dataset_name not in _NAME_MAP:
            raise NotImplementedError(f"Dataset: {dataset_name}")
        folder = _NAME_MAP[dataset_name]
        root = os.path.join(datasets_folder, folder)

        db = listdir_abs(root, "reference_images")
        qu = listdir_abs(root, "query_images")
        pos = []
        with open(os.path.join(root, "gt_matches.csv")) as f:
            for row in csv.DictReader(f):
                pos.append(
                    np.asarray(
                        [int(row[f"top_{k}_ref_ind"]) for k in range(1, 6)]
                    )
                )
        super().__init__(db, qu, pos, img_size)
