"""Exact top-k retrieval and Recall@K (counterpart of
``anyloc_tpu/ops/retrieval.py``, exact engine only).

FAISS conventions: cosine returns inner-product scores, descending
(IndexFlatIP); l2 returns squared L2 distances, ascending (IndexFlatL2).
Ties go to the lower database index, as ``jax.lax.top_k`` orders them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from anyloc_tpu_torch.ops.common import l2_normalize, score_dot


def _topk_stable(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest k per row, equal scores in ascending index order."""
    top, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return top[:, :k], idx[:, :k]


def top_k_search(db: torch.Tensor, qu: torch.Tensor, k: int, method: str = "cosine",
                 score_dtype: str = "float32") -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k. db [Ndb, D], qu [Q, D] -> (scores [Q, k], indices [Q, k])."""
    dot = score_dot(score_dtype)
    if method == "cosine":
        return _topk_stable(dot(qu, db.T), k)
    if method == "l2":
        qu32, db32 = qu.float(), db.float()
        d2 = ((qu32 * qu32).sum(-1, keepdim=True) - 2.0 * dot(qu, db.T)
              + (db32 * db32).sum(-1)[None, :])
        top_neg, idx = _topk_stable(-d2, k)
        return -top_neg, idx
    raise ValueError(f"Unknown method: {method}")


def compute_recalls(
    indices: np.ndarray,
    gt_pos: Sequence[np.ndarray],
    top_k: Sequence[int],
    use_percentage: bool = True,
    sub_sample_db: int = 1,
    sub_sample_qu: int = 1,
) -> Dict[int, float]:
    """Recall@K as the reference accumulates it, with the sub-sample
    correction: query row i reads gt_pos[i * sub_sample_qu], and a
    retrieved db index j counts as db image j * sub_sample_db."""
    indices = np.asarray(indices)
    n_qu, max_k = indices.shape
    gt_lists = [np.asarray(gt_pos[i * sub_sample_qu], np.int64).ravel()
                for i in range(n_qu)]
    scaled = indices.astype(np.int64) * sub_sample_db
    # composite (query, db) keys, collision-free
    stride = np.int64(max(int(scaled.max(initial=0)),
                          max((int(g.max()) for g in gt_lists if g.size), default=0)) + 1)
    gt_keys = (np.concatenate([np.int64(i) * stride + g for i, g in enumerate(gt_lists)])
               if any(g.size for g in gt_lists) else np.empty(0, np.int64))
    retr_keys = np.arange(n_qu, dtype=np.int64)[:, None] * stride + scaled
    any_hit = np.cumsum(np.isin(retr_keys, gt_keys), axis=1) > 0
    recalls = {k: int(any_hit[:, min(k, max_k) - 1].sum()) for k in top_k}
    if use_percentage:
        recalls = {k: v / n_qu for k, v in recalls.items()}
    return recalls


def get_top_k_recall(
    top_k: List[int],
    db,
    qu,
    gt_pos,
    method: str = "cosine",
    norm_descs: bool = True,
    use_gpu: bool = False,
    use_percentage: bool = True,
    sub_sample_db: int = 1,
    sub_sample_qu: int = 1,
    engine: str = "device",
    score_dtype: str = "float32",
) -> Tuple[np.ndarray, np.ndarray, Dict[int, float]]:
    """The reference's ``get_top_k_recall``: (distances [Q, max k],
    indices [Q, max k], {k: recall}). The search runs on the device the
    database tensor lies on (numpy inputs: the CPU). Only the exact
    "device" engine is ported; "blocked", "native", "ivf", "pq" and
    "ivf_pq" are later items of the port (ROADMAP.md)."""
    del use_gpu  # placement follows the inputs
    if engine != "device":
        raise NotImplementedError(
            f"engine={engine!r} is not ported yet (ROADMAP.md, port queue "
            "item 5: ANN engines); use engine='device'")
    dev = db.device if isinstance(db, torch.Tensor) else torch.device("cpu")
    db = torch.as_tensor(np.asarray(db) if not isinstance(db, torch.Tensor) else db,
                         dtype=torch.float32).to(dev)
    qu = torch.as_tensor(np.asarray(qu) if not isinstance(qu, torch.Tensor) else qu,
                         dtype=torch.float32).to(dev)
    if qu.dim() == 1:
        qu = qu[None]
    if norm_descs:
        db, qu = l2_normalize(db), l2_normalize(qu)
    max_k = min(int(max(top_k)), db.shape[0])
    dists, indices = top_k_search(db, qu, max_k, method, score_dtype=score_dtype)
    dists, indices = dists.cpu().numpy(), indices.cpu().numpy()
    recalls = compute_recalls(indices, gt_pos, top_k, use_percentage,
                              sub_sample_db, sub_sample_qu)
    return dists, indices, recalls
