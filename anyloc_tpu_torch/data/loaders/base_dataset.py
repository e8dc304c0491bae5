"""Generic benchmark dataset with auto-detected layout
(ref dvgl_benchmark/datasets_ws.py:74-269):

  * **vpr_bench** layout: ``<root>/<name>/ref`` + ``query`` +
    ``ground_truth_new.npy`` (object array; column 1 = positive db indices) —
    used for 17places;
  * **vg_bench** layout: ``<root>/<name>/images/<split>/database|queries``
    with UTM-in-filename ``@easting@northing@...@.jpg``; positives = radius
    kNN over UTM at ``val_positive_dist_threshold`` (default 25 m) — used for
    pitts30k, st_lucia, nordland, tokyo247, ...

Query test methods (hard_resize / single_query / central_crop / five_crops /
nearest_crop / maj_voting — datasets_ws.py:241-260) are implemented as
host-side numpy transforms in ``query_transform``.

A copy of ``anyloc_tpu/data/loaders/base_dataset.py``.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import List, Optional, Tuple

import numpy as np
from anyloc_tpu_torch.data.base import VPRDataset, natsorted, radius_positives
from anyloc_tpu_torch.data.transforms import (
    base_transform,
    load_image,
    load_pil,
    normalize,
    resize_tensor_bilinear,
)

TEST_METHODS = (
    "hard_resize",
    "single_query",
    "central_crop",
    "five_crops",
    "nearest_crop",
    "maj_voting",
)


def parse_utm(paths: List[str]) -> np.ndarray:
    """``@easting@northing@`` filename convention -> [N, 2] float."""
    return np.array(
        [(p.split("@")[1], p.split("@")[2]) for p in paths], dtype=float
    )


def load_vprbench_gt(gt_path: str, query_paths=None, db_paths=None):
    """vpr_bench ground_truth_new.npy with optional query/db filtering
    (datasets_ws.py:168-186 semantics)."""
    pos = np.load(gt_path, allow_pickle=True)[:, 1]
    if query_paths is not None:
        qs = [int(os.path.basename(p).split(".")[0]) for p in query_paths]
        pos = pos[qs]
    if db_paths is not None:
        dbs = [int(os.path.basename(p).split(".")[0]) for p in db_paths]
        db_map = dict(zip(dbs, range(len(dbs))))
        pos = np.array(
            [
                np.array([db_map[v] for v in np.array(q)[np.isin(q, dbs)]])
                for q in pos
            ],
            dtype=object,
        )
    return list(pos)


class BaseDataset(VPRDataset):
    def __init__(
        self,
        datasets_folder: str,
        dataset_name: str,
        split: str = "test",
        dist_thresh: float = 25.0,
        img_size: Optional[Tuple[int, int]] = (320, 320),
        test_method: str = "hard_resize",
    ) -> None:
        if test_method not in TEST_METHODS:
            raise ValueError(f"test_method must be one of {TEST_METHODS}, got {test_method!r}")
        self.dataset_name = dataset_name
        root = os.path.join(datasets_folder, dataset_name)
        self.vprbench = "ref" in os.listdir(root)
        if self.vprbench:
            db_dir, qu_dir = os.path.join(root, "ref"), os.path.join(root, "query")
        else:
            root = os.path.join(root, "images", split)
            db_dir = os.path.join(root, "database")
            qu_dir = os.path.join(root, "queries")
        for d in (db_dir, qu_dir):
            if not os.path.exists(d):
                raise FileNotFoundError(f"Folder {d} does not exist")
        db = natsorted(
            _glob.glob(os.path.join(db_dir, "**", "*.jpg"), recursive=True)
        )
        qu = natsorted(
            _glob.glob(os.path.join(qu_dir, "**", "*.jpg"), recursive=True)
        )
        if self.vprbench:
            pos = load_vprbench_gt(os.path.join(root, "ground_truth_new.npy"))
            self.database_utms = self.queries_utms = None
        else:
            self.database_utms = parse_utm(db)
            self.queries_utms = parse_utm(qu)
            pos = radius_positives(self.database_utms, self.queries_utms, dist_thresh)
        super().__init__(db, qu, pos, img_size)
        self._imgs_level = 2 if self.vprbench else 4
        self.test_method = test_method

    def _standard_items(self) -> bool:
        # hard_resize items are load_image of their path, so they may come
        # from the native pipe or as raw uint8 (the JAX package's BaseDataset
        # refuses both for every test method, F13)
        return self.test_method == "hard_resize"

    def query_transform(self, path: str) -> np.ndarray:
        """Apply the configured test method to a query image. Returns
        [H, W, 3] (or [5, H, W, 3] for the crop ensembles)."""
        img = load_pil(path)
        h, w = self.img_size
        m = self.test_method
        if m == "hard_resize":
            return base_transform(img, (h, w))
        if m == "single_query":
            # resize shorter side to min(resize), keep aspect
            short = min(h, w)
            iw, ih = img.size
            scale = short / min(iw, ih)
            return base_transform(
                img, (int(round(ih * scale)), int(round(iw * scale)))
            )
        if m == "central_crop":
            iw, ih = img.size
            scale = max(h / ih, w / iw)
            arr = normalize(np.asarray(img, np.float32) / 255.0)
            arr = resize_tensor_bilinear(
                arr, (int(round(ih * scale)), int(round(iw * scale)))
            )
            top = (arr.shape[0] - h) // 2
            left = (arr.shape[1] - w) // 2
            return arr[top : top + h, left : left + w]
        # five_crops / nearest_crop / maj_voting: 5 square crops at the
        # shorter side (corners + center)
        short = min(h, w)
        iw, ih = img.size
        scale = short / min(iw, ih)
        arr = normalize(np.asarray(img, np.float32) / 255.0)
        arr = resize_tensor_bilinear(
            arr, (int(round(ih * scale)), int(round(iw * scale)))
        )
        hh, ww = arr.shape[:2]
        s = short
        crops = [
            arr[:s, :s],            # top-left
            arr[:s, ww - s :],      # top-right
            arr[hh - s :, :s],      # bottom-left
            arr[hh - s :, ww - s :],  # bottom-right
            arr[(hh - s) // 2 : (hh - s) // 2 + s,
                (ww - s) // 2 : (ww - s) // 2 + s],  # center
        ]
        return np.stack(crops)

    def __getitem__(self, index: int):
        if index >= self.database_num and self.test_method != "hard_resize":
            return self.query_transform(self.images_paths[index]), index
        return load_image(self.images_paths[index], self.img_size), index
