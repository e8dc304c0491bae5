"""dvgl-style evaluation (counterpart of ``anyloc_tpu/training/evaluate.py``;
``dvgl_benchmark/test.py:122-294``): database and query descriptors through
a trained model, exact L2 top-k on the device, the five-crops /
nearest-crop / majority-voting query test methods, optional PCA and
distractor concatenation.

Descriptors are gathered on the host as float32 numpy, as the JAX package
gathers them; the search runs on ``device`` (None: the card, F11) through
``top_k_search``, or streams the database there through
``top_k_search_blocked`` with ``efficient_ram``.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple, Union

import numpy as np
import torch

from anyloc_tpu_torch.ops.common import resolve_device
from anyloc_tpu_torch.ops.retrieval import top_k_search, top_k_search_blocked


def _host(f) -> np.ndarray:
    if isinstance(f, torch.Tensor):
        return f.detach().float().cpu().numpy()
    return np.asarray(f, np.float32)


def extract_features(
    descriptor_fn: Callable,
    dataset,
    test_method: str = "hard_resize",
    batch_size: int = 16,
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (database_features [Ndb, D], query_features [Nq(*5), D]) float32
    numpy. The crop ensembles give 5 rows per query (nearest_crop /
    maj_voting) or their mean (five_crops), as test.py:159-174."""
    db_feats = []
    for imgs, bidx in dataset.batches(batch_size, which="db"):
        db_feats.append(_host(descriptor_fn(imgs))[bidx >= 0])
    db = np.concatenate(db_feats) if db_feats else np.empty((0, 0), np.float32)

    qu_feats = []
    prev_method = getattr(dataset, "test_method", "hard_resize")
    dataset.test_method = test_method
    try:
        if test_method == "single_query":
            # varying query sizes: batch 1, as the reference (test.py:30,153)
            for qi in range(dataset.database_num, len(dataset)):
                qu_feats.append(_host(descriptor_fn(dataset[qi][0][None])))
        elif test_method in ("hard_resize", "central_crop"):
            for imgs, bidx in dataset.batches(batch_size, which="queries"):
                qu_feats.append(_host(descriptor_fn(imgs))[bidx >= 0])
        else:
            # crop ensembles: whole queries (5 same-shape crops each) per
            # forward, the tail chunk padded to the full batch shape
            q_per_batch = max(1, batch_size // 5)
            q_indices = list(range(dataset.database_num, len(dataset)))
            for s in range(0, len(q_indices), q_per_batch):
                chunk = q_indices[s:s + q_per_batch]
                padded = chunk + [chunk[-1]] * (q_per_batch - len(chunk))
                crops = np.concatenate([dataset[qi][0] for qi in padded])
                f = _host(descriptor_fn(crops)).reshape(q_per_batch, 5, -1)[:len(chunk)]
                qu_feats.append(f.mean(axis=1) if test_method == "five_crops"
                                else f.reshape(len(chunk) * 5, -1))
    finally:
        dataset.test_method = prev_method
    return db, np.concatenate(qu_feats)


def top_n_voting(topn: str, predictions, distances, maj_weight: float):
    """In-place distance discounting for repeated crop votes (test.py:277-294)."""
    n, selected = {"top1": (1, 0), "top5": (5, slice(0, 5)), "top10": (10, slice(0, 10))}[topn]
    vals, counts = np.unique(predictions[:, selected], return_counts=True)
    for val, count in zip(vals[counts > 1], counts[counts > 1]):
        mask = predictions[:, selected] == val
        distances[:, selected][mask] -= maj_weight * count / n


def _dedup_keep_closest(preds: np.ndarray, dists: np.ndarray, k: int) -> np.ndarray:
    preds = preds[np.argsort(dists)]
    _, unique_idx = np.unique(preds, return_index=True)
    return preds[np.sort(unique_idx)][:k]


def evaluate(
    descriptor_fn,
    dataset,
    test_method: str = "hard_resize",
    recall_values: Sequence[int] = (1, 5, 10, 20),
    batch_size: int = 16,
    pca=None,
    distractor_dataset=None,
    majority_weight: float = 0.01,
    efficient_ram: bool = False,
    stream_dtype: str = "float32",
    save_descs: str = None,
    *,
    device: Union[None, str, torch.device] = None,
) -> Tuple[np.ndarray, str]:
    """Recall@N (percent) of ``descriptor_fn`` on ``dataset`` and its line.
    ``pca`` is ``ops.pca.pca_fit``'s (mean, components, scale);
    ``efficient_ram`` streams the database through ``device`` in shards
    (``stream_dtype`` "float32" / "bfloat16" / "int8"); ``save_descs``
    writes every descriptor, database rows first, to ``<path>.npy``."""
    dev = resolve_device(device)
    db, qu = extract_features(descriptor_fn, dataset, test_method, batch_size)
    if save_descs:
        np.save(f"{save_descs}.npy", np.concatenate([db, qu]))

    def project(x):
        if pca is None:
            return x
        from anyloc_tpu_torch.ops.pca import pca_transform

        mean, comps, scale = (torch.as_tensor(t).to(dev) for t in pca)
        return pca_transform(torch.from_numpy(x).to(dev), mean, comps, scale).cpu().numpy()

    db, qu = project(db), project(qu)
    if distractor_dataset is not None:   # VPAir concat (test.py:187-215)
        dis, _ = extract_features(descriptor_fn, distractor_dataset, "hard_resize", batch_size)
        db = np.concatenate([db, project(dis)])

    max_k = min(max(recall_values), db.shape[0])
    if efficient_ram:
        distances, predictions = top_k_search_blocked(db, qu, max_k, method="l2",
                                                      stream_dtype=stream_dtype, device=dev)
    else:
        d, p = top_k_search(torch.from_numpy(db).to(dev), torch.from_numpy(qu).to(dev), max_k,
                            method="l2")
        distances, predictions = d.cpu().numpy(), p.cpu().numpy()
    distances, predictions = np.array(distances), np.array(predictions)

    nq = dataset.queries_num
    if test_method == "nearest_crop":
        distances = distances.reshape(nq, 5 * max_k)
        predictions = predictions.reshape(nq, 5 * max_k)
        out = np.empty((nq, max_k), np.int64)
        for q in range(nq):
            out[q] = _dedup_keep_closest(predictions[q], distances[q], max_k)
        predictions = out
    elif test_method == "maj_voting":
        distances = distances.reshape(nq, 5, max_k)
        predictions = predictions.reshape(nq, 5, max_k)
        out = np.empty((nq, max_k), np.int64)
        for q in range(nq):
            for topn in ("top1", "top5", "top10"):
                top_n_voting(topn, predictions[q], distances[q], majority_weight)
            out[q] = _dedup_keep_closest(predictions[q].flatten(), distances[q].flatten(), max_k)
        predictions = out

    positives = dataset.get_positives()
    recalls = np.zeros(len(recall_values))
    for qi, pred in enumerate(predictions):
        for i, n in enumerate(recall_values):
            if np.any(np.isin(pred[:n], positives[qi])):
                recalls[i:] += 1
                break
    recalls = recalls / nq * 100
    return recalls, ", ".join(f"R@{v}: {r:.1f}" for v, r in zip(recall_values, recalls))
