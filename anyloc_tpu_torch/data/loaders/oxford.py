"""Oxford RobotCar (day/night) via the MATLAB ``oxdatapart.mat`` dbStruct
(ref oxford_dataloader.py:58-166): db/query image lists + 2-D locations +
positive-distance threshold; 'Oxford_25m' overrides the radius to 25 m.
A copy of ``anyloc_tpu/data/loaders/oxford.py``."""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from anyloc_tpu_torch.data.base import VPRDataset, radius_positives


def parse_dbstruct(mat_path: str):
    """-> (db_images, db_locs [N,2], q_images, q_locs [M,2], pos_dist_thr)."""
    from scipy.io import loadmat

    m = loadmat(mat_path)["dbStruct"][0]
    db_image = [str(x[0]) if np.ndim(x) else str(x) for x in np.ravel(m[0])]
    loc_db = np.asarray(m[1], float)
    q_image = [str(x[0]) if np.ndim(x) else str(x) for x in np.ravel(m[2])]
    loc_q = np.asarray(m[3], float)
    pos_dist_thr = float(np.ravel(m[6])[0])
    # locations are stored [2, N] in the struct
    if loc_db.shape[0] == 2 and loc_db.shape[1] != 2:
        loc_db = loc_db.T
    if loc_q.shape[0] == 2 and loc_q.shape[1] != 2:
        loc_q = loc_q.T
    return db_image, loc_db, q_image, loc_q, pos_dist_thr


class Oxford(VPRDataset):
    _imgs_level = 3  # ref oxford_dataloader.py:121

    def __init__(
        self,
        datasets_folder: str,
        override_dist: Optional[float] = None,
        img_size: Optional[Tuple[int, int]] = (320, 320),
    ) -> None:
        struct = os.path.join(datasets_folder, "Oxford_Robotcar", "oxdatapart.mat")
        root = os.path.join(datasets_folder, "Oxford_Robotcar", "oxDataPart")
        db_im, db_loc, q_im, q_loc, thr = parse_dbstruct(struct)
        self.loc_rad = override_dist if override_dist is not None else thr
        db = [os.path.join(root, p.replace(" ", "")) for p in db_im]
        qu = [os.path.join(root, p.replace(" ", "")) for p in q_im]
        pos = radius_positives(db_loc, q_loc, self.loc_rad)
        super().__init__(db, qu, pos, img_size)
        self.db_utms = db_loc
        self.qu_utms = q_loc
