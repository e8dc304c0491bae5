"""Loaders whose ground truth is a precomputed .npy index-list file.

Each GT file is an object array where entry i is (query_something,
positive_db_indices) — the loaders take column 1 (reference:
gardens.py:96-103, vpair_dataloader.py:91-98, eiffel_dataloader.py:119-126).
A copy of ``anyloc_tpu/data/loaders/simple_gt.py``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from anyloc_tpu_torch.data.base import VPRDataset
from anyloc_tpu_torch.data.base import listdir_abs as _listdir_abs


def _npy_positives(path: str, skip: int = 0):
    gt = np.load(path, allow_pickle=True)
    if skip:
        gt = gt[skip:]
    return [np.asarray(row[1]) for row in gt]


class Gardens(VPRDataset):
    """Gardens Point: db = day_right, queries = day_left (viewpoint shift) or
    night_right (day-night); GT from gardens_gt.npy (ref gardens.py:66-116)."""

    def __init__(self, datasets_folder: str, dataset_name: str = "gardens",
                 query_split: str = "day_left",
                 img_size: Optional[Tuple[int, int]] = (320, 320)) -> None:
        root = os.path.join(datasets_folder, dataset_name)
        db = _listdir_abs(root, "day_right")
        qu = _listdir_abs(root, query_split)
        pos = _npy_positives(os.path.join(root, "gardens_gt.npy"))
        super().__init__(db, qu, pos, img_size)


class VPAir(VPRDataset):
    """VP-Air aerial: reference_views / queries + vpair_gt.npy
    (ref vpair_dataloader.py:61-111)."""

    def __init__(self, datasets_folder: str, dataset_name: str = "VPAir",
                 img_size: Optional[Tuple[int, int]] = (320, 320)) -> None:
        root = os.path.join(datasets_folder, dataset_name)
        db = _listdir_abs(root, "reference_views")
        qu = _listdir_abs(root, "queries")
        pos = _npy_positives(os.path.join(root, "vpair_gt.npy"))
        super().__init__(db, qu, pos, img_size)


class VPAirDistractor(VPRDataset):
    """10k aerial distractors appended to the database only — no queries, no
    GT (ref vpair_distractor_dataloader.py:61-98)."""

    def __init__(self, datasets_folder: str, dataset_name: str = "VPAir",
                 img_size: Optional[Tuple[int, int]] = (320, 320)) -> None:
        root = os.path.join(datasets_folder, dataset_name)
        db = _listdir_abs(root, "distractors")
        super().__init__(db, [], None, img_size)


class Eiffel(VPRDataset):
    """Mid-Atlantic Ridge (underwater): db_images / q_images + eiffel_gt.npy
    with the first 101 entries skipped (ref eiffel_dataloader.py:119)."""

    def __init__(self, datasets_folder: str, dataset_name: str = "eiffel",
                 img_size: Optional[Tuple[int, int]] = (320, 320)) -> None:
        root = os.path.join(datasets_folder, dataset_name)
        db = _listdir_abs(root, "db_images")
        qu = _listdir_abs(root, "q_images")
        pos = _npy_positives(os.path.join(root, "eiffel_gt.npy"), skip=101)
        super().__init__(db, qu, pos, img_size)
