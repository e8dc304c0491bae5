"""Loaders whose ground truth comes from camera poses + a metric radius.

  * Baidu Mall   — per-image ``.camera`` files; xyz from the second-to-last
    line, rotation rows 5-7 -> zyx Euler; radius 10 m, optional angular filter
    (ref baidu_dataloader.py:55-73, 157-211);
  * Hawkins / Laurel Caverns — a single ``pose_topic_list.npy`` with
    hard-coded db/query index splits; radius 8 m over the first two pose
    coordinates (ref hawkins_dataloader.py:97-113, laurel_dataloader.py:94-113);
  * NaverLabs    — db/q ``*_trajectories.txt`` CSVs (quaternion + xyz),
    radius (+ optional angle) kNN (ref naverlabs_dataloader.py:28-48, 96-110).

A copy of ``anyloc_tpu/data/loaders/pose_gt.py``.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from anyloc_tpu_torch.data.base import VPRDataset, radius_positives
from anyloc_tpu_torch.data.base import listdir_abs as _listdir_abs


def parse_camera_file(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Baidu ``.camera`` format -> (xyz [3], zyx Euler degrees [3])."""
    from scipy.spatial.transform import Rotation

    with open(path) as f:
        lines = f.readlines()
    xyz = np.fromstring(lines[-2], dtype=float, sep=" ")
    r = np.stack([np.fromstring(lines[i], dtype=float, sep=" ") for i in (4, 5, 6)])
    euler = Rotation.from_matrix(r).as_euler("zyx", degrees=True)
    return xyz, euler


def _angle_filter(pos_lists, qu_euler, db_euler, ang_thresh: float):
    out = []
    for i, cand in enumerate(pos_lists):
        keep = [
            j
            for j in cand
            if np.mean(np.abs(qu_euler[i] - db_euler[j])) < ang_thresh
        ]
        out.append(np.asarray(keep, dtype=np.int64))
    return out


class Baidu(VPRDataset):
    """Baidu Mall (indoor). db = training_images_undistort,
    queries = query_images_undistort; poses from training_gt / query_gt."""

    def __init__(
        self,
        datasets_folder: str,
        dataset_name: str = "baidu_datasets",
        dist_thresh: float = 10.0,
        use_ang_positives: bool = False,
        ang_thresh: float = 20.0,
        img_size: Optional[Tuple[int, int]] = (320, 320),
    ) -> None:
        root = os.path.join(datasets_folder, dataset_name)
        db = _listdir_abs(root, "training_images_undistort")
        qu = _listdir_abs(root, "query_images_undistort")

        def poses(sub):
            files = _listdir_abs(root, sub)
            xyz = np.zeros((len(files), 3))
            eul = np.zeros((len(files), 3))
            for i, f in enumerate(files):
                xyz[i], eul[i] = parse_camera_file(f)
            return xyz, eul

        db_xyz, db_eul = poses("training_gt")
        qu_xyz, qu_eul = poses("query_gt")
        pos = radius_positives(db_xyz, qu_xyz, dist_thresh)
        if use_ang_positives:
            pos = _angle_filter(pos, qu_eul, db_eul, ang_thresh)
        super().__init__(db, qu, pos, img_size)
        # db-db positives for the contrastive-MLP training variant
        self.soft_positives_per_db = radius_positives(db_xyz, db_xyz, dist_thresh)


class _PoseSplitDataset(VPRDataset):
    """Shared Hawkins/Laurel pattern: one pose npy, index-range splits."""

    def __init__(self, datasets_folder, dataset_name, db_slice, qu_slice,
                 dist_thresh, img_size):
        root = os.path.join(datasets_folder, dataset_name)
        db = _listdir_abs(root, "db_images")
        qu = _listdir_abs(root, "q_images")
        poses = np.load(
            os.path.join(root, "pose_topic_list.npy"), allow_pickle=True
        )
        db_xy = np.asarray(poses[db_slice, :2], float)
        qu_xy = np.asarray(poses[qu_slice, :2], float)
        pos = radius_positives(db_xy, qu_xy, dist_thresh)
        super().__init__(db, qu, pos, img_size)


class Hawkins(_PoseSplitDataset):
    """Hawkins long corridor: db poses [0:127], query poses [127:245],
    radius 8 m (ref hawkins_dataloader.py:97-113). The short 'hawkins'
    variant splits 76/75."""

    def __init__(self, datasets_folder: str,
                 dataset_name: str = "hawkins_long_corridor",
                 dist_thresh: float = 8.0,
                 img_size: Optional[Tuple[int, int]] = (320, 320)) -> None:
        if dataset_name == "hawkins":
            db_s, qu_s = slice(0, 76), slice(76, 151)
        else:
            db_s, qu_s = slice(0, 127), slice(127, 245)
        super().__init__(datasets_folder, dataset_name, db_s, qu_s,
                         dist_thresh, img_size)


class Laurel(_PoseSplitDataset):
    """Laurel Caverns: db [0:94], queries [94:], radius 8 m
    (ref laurel_dataloader.py:94-113)."""

    def __init__(self, datasets_folder: str,
                 dataset_name: str = "laurel_caverns",
                 dist_thresh: float = 8.0,
                 img_size: Optional[Tuple[int, int]] = (320, 320)) -> None:
        root = os.path.join(datasets_folder, dataset_name)
        n_db = len(os.listdir(os.path.join(root, "db_images")))
        n_qu = len(os.listdir(os.path.join(root, "q_images")))
        super().__init__(datasets_folder, dataset_name,
                         slice(0, n_db), slice(n_db, n_db + n_qu),
                         dist_thresh, img_size)


def parse_trajectory_file(path: str):
    """NaverLabs ``*_trajectories.txt`` -> (img names, xyz [N,3], euler [N,3])."""
    from scipy.spatial.transform import Rotation

    names: List[str] = []
    locs, eulers = [], []
    with open(path) as f:
        for line in f.readlines()[2:]:
            c = line.split(",")
            names.append(c[1].split("_")[0] + "_" + c[0])
            locs.append([float(c[6]), float(c[7]), float(c[8])])
            quat = [float(c[3]), float(c[4]), float(c[5]), float(c[2])]
            eulers.append(Rotation.from_quat(quat).as_euler("zyx", degrees=True))
    return names, np.asarray(locs), np.asarray(eulers)


class NaverLabs(VPRDataset):
    def __init__(
        self,
        datasets_folder: str,
        dataset_name: str = "NVL_datasets",
        dist_thresh: float = 20.0,
        use_ang_positives: bool = False,
        ang_thresh: float = 10.0,
        img_size: Optional[Tuple[int, int]] = (320, 320),
    ) -> None:
        root = os.path.join(datasets_folder, dataset_name)
        db = _listdir_abs(root, "database_images")
        qu = _listdir_abs(root, "query_images")
        _, db_xyz, db_eul = parse_trajectory_file(
            os.path.join(root, "db_trajectories.txt")
        )
        _, qu_xyz, qu_eul = parse_trajectory_file(
            os.path.join(root, "q_trajectories.txt")
        )
        pos = radius_positives(db_xyz, qu_xyz, dist_thresh)
        if use_ang_positives:
            pos = _angle_filter(pos, qu_eul, db_eul, ang_thresh)
        super().__init__(db, qu, pos, img_size)
