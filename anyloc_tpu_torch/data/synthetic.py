"""Synthetic dataset fabrication — writes miniature datasets in each of the
reference's on-disk layouts so loaders, pipelines, and benchmarks run without
the real (multi-GB, download-only) data. Used by tests and e2e smoke runs.

Images are colored-noise JPEGs; each query is a brightness/noise-perturbed
copy of one database image so retrieval has a planted correct answer.
A copy of ``anyloc_tpu/data/synthetic.py``: the same seed writes the same
bytes.
"""

from __future__ import annotations

import csv
import os
from typing import Tuple

import numpy as np
from PIL import Image


def _write_img(path: str, arr: np.ndarray):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path, quality=92)


def make_image_pairs(
    rng: np.random.Generator, n_db: int, n_q: int, size: Tuple[int, int] = (64, 64)
):
    """Returns (db_arrays, q_arrays, gt) with q_i a perturbed copy of db_{gt_i}."""
    h, w = size
    base = rng.integers(0, 255, (n_db, h, w, 3), dtype=np.uint8)
    # smooth the noise so JPEG + resize keep structure
    for i in range(n_db):
        img = base[i].astype(np.float32)
        for _ in range(2):
            img = 0.25 * (
                np.roll(img, 1, 0) + np.roll(img, -1, 0)
                + np.roll(img, 1, 1) + np.roll(img, -1, 1)
            )
        base[i] = np.clip(img, 0, 255).astype(np.uint8)
    gt = rng.choice(n_db, size=n_q, replace=False if n_q <= n_db else True)
    qs = []
    for g in gt:
        noisy = base[g].astype(np.int16) + rng.integers(-12, 12, (h, w, 3))
        qs.append(np.clip(noisy, 0, 255).astype(np.uint8))
    return base, qs, gt


def build_gardens(root: str, n_db=8, n_q=4, seed=0, size=(64, 64)) -> str:
    """Gardens layout: day_right/ day_left/ night_right/ + gardens_gt.npy."""
    rng = np.random.default_rng(seed)
    db, qs, gt = make_image_pairs(rng, n_db, n_q, size)
    ds = os.path.join(root, "gardens")
    for i, a in enumerate(db):
        _write_img(os.path.join(ds, "day_right", f"img_{i:03d}.jpg"), a)
    for sub in ("day_left", "night_right"):
        for i, a in enumerate(qs):
            _write_img(os.path.join(ds, sub, f"img_{i:03d}.jpg"), a)
    gt_arr = np.array(
        [(i, np.array([g])) for i, g in enumerate(gt)], dtype=object
    )
    np.save(os.path.join(ds, "gardens_gt.npy"), gt_arr, allow_pickle=True)
    return root


def build_pose_split(root: str, name="hawkins_long_corridor", n_db=127, n_q=118,
                     seed=0, size=(64, 64)) -> str:
    """Hawkins/Laurel layout: db_images/ q_images/ + pose_topic_list.npy.
    Poses are a 1-D corridor so radius-8 GT is predictable."""
    rng = np.random.default_rng(seed)
    db, qs, gt = make_image_pairs(rng, n_db, n_q, size)
    ds = os.path.join(root, name)
    for i, a in enumerate(db):
        _write_img(os.path.join(ds, "db_images", f"img_{i:04d}.jpg"), a)
    for i, a in enumerate(qs):
        _write_img(os.path.join(ds, "q_images", f"img_{i:04d}.jpg"), a)
    # db poses along a line at 2m spacing; query i sits at its gt db pose
    poses = np.zeros((n_db + n_q, 3))
    poses[:n_db, 0] = np.arange(n_db) * 2.0
    poses[n_db:, 0] = gt * 2.0 + 0.5
    np.save(os.path.join(ds, "pose_topic_list.npy"), poses, allow_pickle=True)
    return root


def build_vg_bench(root: str, name="pitts30k", split="test", n_db=10, n_q=5,
                   seed=0, size=(64, 64)) -> str:
    """vg_bench layout: images/<split>/database|queries with @utm@ names."""
    rng = np.random.default_rng(seed)
    db, qs, gt = make_image_pairs(rng, n_db, n_q, size)
    base = os.path.join(root, name, "images", split)
    for i, a in enumerate(db):
        east, north = 1000.0 + 100.0 * i, 5000.0
        _write_img(
            os.path.join(base, "database", f"@{east:.1f}@{north:.1f}@db{i:03d}@.jpg"),
            a,
        )
    for i, (a, g) in enumerate(zip(qs, gt)):
        east, north = 1000.0 + 100.0 * g + 3.0, 5000.0 + 4.0
        _write_img(
            os.path.join(base, "queries", f"@{east:.1f}@{north:.1f}@q{i:03d}@.jpg"),
            a,
        )
    return root


def build_vpr_bench(root: str, name="17places", n_db=10, n_q=5, seed=0,
                    size=(64, 64)) -> str:
    """vpr_bench layout: ref/ query/ + ground_truth_new.npy."""
    rng = np.random.default_rng(seed)
    db, qs, gt = make_image_pairs(rng, n_db, n_q, size)
    ds = os.path.join(root, name)
    for i, a in enumerate(db):
        _write_img(os.path.join(ds, "ref", f"{i}.jpg"), a)
    for i, a in enumerate(qs):
        _write_img(os.path.join(ds, "query", f"{i}.jpg"), a)
    gt_arr = np.array(
        [(i, np.array([g])) for i, g in enumerate(gt)], dtype=object
    )
    np.save(os.path.join(ds, "ground_truth_new.npy"), gt_arr, allow_pickle=True)
    return root


def build_aerial(root: str, name="Tartan_GNSS_test_rotated", n_db=10, n_q=4,
                 seed=0, size=(64, 64)) -> str:
    """Aerial layout: reference_images/ query_images/ + gt_matches.csv."""
    from anyloc_tpu_torch.data.loaders.aerial import _NAME_MAP

    rng = np.random.default_rng(seed)
    db, qs, gt = make_image_pairs(rng, n_db, n_q, size)
    ds = os.path.join(root, _NAME_MAP[name])
    for i, a in enumerate(db):
        _write_img(os.path.join(ds, "reference_images", f"ref_{i:03d}.jpg"), a)
    for i, a in enumerate(qs):
        _write_img(os.path.join(ds, "query_images", f"q_{i:03d}.jpg"), a)
    with open(os.path.join(ds, "gt_matches.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["query_ind"] + [f"top_{k}_ref_ind" for k in range(1, 6)])
        for i, g in enumerate(gt):
            tops = [int(g)] + [int((g + j) % n_db) for j in range(1, 5)]
            w.writerow([i] + tops)
    return root


def build_eiffel(root: str, n_db=6, n_q=3, seed=0, size=(64, 64)) -> str:
    """Eiffel layout: db_images/ q_images/ + eiffel_gt.npy whose first 101
    entries are skipped by the loader (eiffel_dataloader.py:119)."""
    rng = np.random.default_rng(seed)
    db, qs, gt = make_image_pairs(rng, n_db, n_q, size)
    ds = os.path.join(root, "eiffel")
    for i, a in enumerate(db):
        _write_img(os.path.join(ds, "db_images", f"img_{i:03d}.jpg"), a)
    for i, a in enumerate(qs):
        _write_img(os.path.join(ds, "q_images", f"img_{i:03d}.jpg"), a)
    pad = [(i, np.array([0])) for i in range(101)]  # skipped region
    rows = pad + [(101 + i, np.array([g])) for i, g in enumerate(gt)]
    np.save(os.path.join(ds, "eiffel_gt.npy"),
            np.array(rows, dtype=object), allow_pickle=True)
    return root


def build_oxford(root: str, n_db=6, n_q=3, seed=0, size=(64, 64)) -> str:
    """Oxford layout: Oxford_Robotcar/oxdatapart.mat dbStruct + oxDataPart/
    image tree (paths 2 levels below oxDataPart -> _imgs_level=3).
    db locations 30 m apart; query i at its gt location + 1 m."""
    from scipy.io import savemat

    rng = np.random.default_rng(seed)
    db, qs, gt = make_image_pairs(rng, n_db, n_q, size)
    base = os.path.join(root, "Oxford_Robotcar")
    db_rel = [f"run1/im{i:03d}.png" for i in range(n_db)]
    q_rel = [f"run2/im{i:03d}.png" for i in range(n_q)]
    for rel, arr in zip(db_rel + q_rel, list(db) + qs):
        _write_img(os.path.join(base, "oxDataPart", rel), arr)
    loc_db = np.stack([np.arange(n_db) * 30.0, np.zeros(n_db)])  # [2, N]
    loc_q = np.stack([gt * 30.0 + 1.0, np.zeros(n_q)])
    savemat(
        os.path.join(base, "oxdatapart.mat"),
        {"dbStruct": np.array([[
            np.array(db_rel, object), loc_db,
            np.array(q_rel, object), loc_q,
            np.array([[n_db]]), np.array([[n_q]]),
            np.array([[25.0]]), np.array([[625.0]]),
        ]], dtype=object)},
    )
    return root


def build_naverlabs(root: str, n_db=6, n_q=3, seed=0, size=(64, 64)) -> str:
    """NaverLabs layout: database_images/ query_images/ + *_trajectories.txt
    (CSV: name, cam_time, qw, qx, qy, qz... positions at cols 6-8)."""
    rng = np.random.default_rng(seed)
    db, qs, gt = make_image_pairs(rng, n_db, n_q, size)
    ds = os.path.join(root, "NVL_datasets")
    for i, a in enumerate(db):
        _write_img(os.path.join(ds, "database_images", f"cam_{i:04d}.jpg"), a)
    for i, a in enumerate(qs):
        _write_img(os.path.join(ds, "query_images", f"cam_{i:04d}.jpg"), a)

    def write_traj(path, xs):
        with open(path, "w") as f:
            f.write("header\nheader2\n")
            for i, x in enumerate(xs):
                f.write(
                    f"{i},cam_{i:04d},1.0,0.0,0.0,0.0,{x},0.0,0.0\n"
                )

    write_traj(os.path.join(ds, "db_trajectories.txt"), np.arange(n_db) * 50.0)
    write_traj(os.path.join(ds, "q_trajectories.txt"), gt * 50.0 + 2.0)
    return root


def build_baidu(root: str, n_db=8, n_q=4, seed=0, size=(64, 64)) -> str:
    """Baidu layout: training_images_undistort/ query_images_undistort/ +
    .camera pose files in training_gt/ query_gt/."""
    rng = np.random.default_rng(seed)
    db, qs, gt = make_image_pairs(rng, n_db, n_q, size)
    ds = os.path.join(root, "baidu_datasets")

    def write_camera(path, xyz):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        lines = ["0 0 0", "0", "0 0 0", "intrinsics",
                 "1 0 0", "0 1 0", "0 0 1",  # rotation rows (lines 5-7)
                 f"{xyz[0]} {xyz[1]} {xyz[2]}",  # second-to-last: xyz
                 "9 9"]
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")

    for i, a in enumerate(db):
        _write_img(os.path.join(ds, "training_images_undistort", f"db_{i:03d}.jpg"), a)
        write_camera(
            os.path.join(ds, "training_gt", f"db_{i:03d}.camera"),
            (i * 30.0, 0.0, 0.0),
        )
    for i, (a, g) in enumerate(zip(qs, gt)):
        _write_img(os.path.join(ds, "query_images_undistort", f"q_{i:03d}.jpg"), a)
        write_camera(
            os.path.join(ds, "query_gt", f"q_{i:03d}.camera"),
            (g * 30.0 + 1.0, 2.0, 0.0),
        )
    return root
