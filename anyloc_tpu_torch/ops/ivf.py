"""IVF (inverted-file) approximate search (counterpart of
``anyloc_tpu/ops/ivf.py``, the FAISS ``IndexIVFFlat`` counterpart).

* fit: k-means the rows into ``n_cells`` coarse cells on the device, then
  bucket them on the host into a dense padded store [n_cells, cap, D]
  (``cap = ceil(N / n_cells * bucket_factor)``, ids -1 at the padding);
  rows past a full cell go to an exact overflow pool that every query
  scans, so no row is ever unsearchable. Cosine cells are unit-norm.
* search: queries score the cells, take the top ``n_probe``, gather those
  buckets ([qb, n_probe·cap, D]), score them with one batched product,
  merge with the overflow pool and take the top k. Scores are the exact
  engine's: the raw inner product for "cosine" (pre-normalize rows for
  true cosine), positive squared distances for "l2". Probing every cell
  equals exact search.

Plain torch on the device, as the JAX package's engine is plain XLA.
Indexes are ``.npz`` files with the JAX package's keys and dtypes, so an
index saved by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from anyloc_tpu_torch.ops.common import l2_normalize, resolve_device
from anyloc_tpu_torch.ops.kmeans import draw_rows, kmeans_fit
from anyloc_tpu_torch.ops.retrieval import _topk_stable


def as_device_tensor(x, device: torch.device) -> torch.Tensor:
    return x.to(device) if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x)).to(device)


def index_device(t) -> torch.device:
    """Where an index searches: its tensors' device; the card for an index
    whose stores are host numpy (``as_numpy=True``)."""
    return t.device if isinstance(t, torch.Tensor) else resolve_device(None)


@dataclasses.dataclass
class IVFIndex:
    """Fitted IVF index: tensors on the device it was fitted or loaded on,
    or numpy with ``as_numpy``."""

    cells: torch.Tensor        # [n_cells, D] coarse centroids (unit-norm for cosine)
    buckets: torch.Tensor      # [n_cells, cap, D] padded row store
    bucket_ids: torch.Tensor   # [n_cells, cap] int32 row ids (-1 pad)
    overflow: torch.Tensor     # [n_over, D] exact side pool
    overflow_ids: torch.Tensor  # [n_over] int32
    n_rows: int = 0
    method: str = "cosine"

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    def search(self, qu, k: int, n_probe: int = 8, query_block: int = 64,
               max_workset_mb: int = 1024):
        """(scores [Q, k], indices [Q, k] int64) over the original row ids.

        ``query_block`` bounds the gathered shortlist [qb, n_probe·cap, D];
        it is clamped further so that the gather stays under
        ``max_workset_mb`` (a skewed database makes ``cap`` large: at
        49152-wide rows one query's shortlist is n_probe·cap·D·4 bytes).
        ``k`` is clamped to the database size and to the shortlist."""
        dev = index_device(self.cells)
        n_probe = min(n_probe, self.n_cells)
        qu = as_device_tensor(qu, dev).float()
        cap, d = self.buckets.shape[1], self.buckets.shape[2]
        shortlist = n_probe * cap + int(self.overflow.shape[0])
        k = max(1, min(k, self.n_rows or shortlist, shortlist))
        if qu.shape[0] == 0:
            return (torch.zeros((0, k), dtype=torch.float32, device=dev),
                    torch.zeros((0, k), dtype=torch.int64, device=dev))
        row_bytes = n_probe * cap * d * 4
        qb = min(query_block, qu.shape[0], max(1, (max_workset_mb << 20) // max(1, row_bytes)))
        stores = [as_device_tensor(t, dev) for t in (self.cells, self.buckets, self.bucket_ids,
                                                     self.overflow, self.overflow_ids)]
        return _ivf_search(*stores, qu, k=k, n_probe=n_probe, method=self.method, qb=qb)


def _ivf_search(cells, buckets, bucket_ids, overflow, overflow_ids, qu, *, k: int,
                n_probe: int, method: str, qb: int, local_lo: Optional[int] = None,
                overflow_gate: Optional[bool] = None):
    """``local_lo`` / ``overflow_gate``: the cell-sharded hooks
    (``parallel/distributed.py::ivf_search_sharded``). With ``local_lo``,
    ``buckets`` / ``bucket_ids`` hold only the cell window [local_lo,
    local_lo + buckets.shape[0]) while the probe stays global over the
    replicated ``cells``: probed cells outside the window take id -1 (their
    scores -inf). ``overflow_gate`` False masks the shared overflow pool
    the same way, so that one shard alone scores it. None / None is the
    unsharded search."""
    nq, d = qu.shape
    n_local, cap = buckets.shape[0], buckets.shape[1]
    tops, ids = [], []
    for q0 in range(0, nq, qb):
        q = qu[q0:q0 + qb]
        b = q.shape[0]
        if method == "cosine":
            # probe with the normalized query (the assignment geometry);
            # the scores stay raw inner products
            cell_scores = l2_normalize(q) @ cells.T
        else:
            cell_scores = -((q * q).sum(-1, keepdim=True) - 2.0 * (q @ cells.T)
                            + (cells * cells).sum(-1))
        _, probe = _topk_stable(cell_scores, n_probe)                 # [b, n_probe]
        if local_lo is None:
            cand = buckets[probe].reshape(b, n_probe * cap, d)         # the IVF working set
            cand_ids = bucket_ids[probe].reshape(b, n_probe * cap).long()
        else:
            # the window's cells; another shard's probed cells mask to id -1
            lp = (probe - local_lo).clamp(0, n_local - 1)
            own = ((probe >= local_lo) & (probe < local_lo + n_local))[:, :, None]
            cand = buckets[lp].reshape(b, n_probe * cap, d)
            cand_ids = torch.where(own, bucket_ids[lp].long(), -1).reshape(b, n_probe * cap)
        dots = torch.bmm(cand, q[:, :, None])[..., 0]
        q_sq = (q * q).sum(-1, keepdim=True)
        s = dots if method == "cosine" else -((cand * cand).sum(-1) - 2.0 * dots + q_sq)
        s = torch.where(cand_ids >= 0, s, float("-inf"))               # bucket padding
        if overflow.shape[0]:
            so = q @ overflow.T
            if method != "cosine":
                so = -((overflow * overflow).sum(-1) - 2.0 * so + q_sq)
            o_ids = overflow_ids.long()[None].expand(b, -1)
            if overflow_gate is not None and not overflow_gate:
                so, o_ids = torch.full_like(so, float("-inf")), torch.full_like(o_ids, -1)
            s = torch.cat([s, so], dim=1)
            cand_ids = torch.cat([cand_ids, o_ids], dim=1)
        top, pos = _topk_stable(s, k)
        tops.append(top if method == "cosine" else -top)   # l2: positive squared distances
        ids.append(torch.gather(cand_ids, 1, pos))
    return torch.cat(tops), torch.cat(ids)


def bucket_rows(labels: np.ndarray, n_cells: int, cap: int):
    """The dense bucketing of ``labels`` [N] (one stable sort, as the JAX
    package does it): (cell, slot, row) of the rows that fit, and the
    overflow rows in cell order."""
    n = labels.shape[0]
    order = np.argsort(labels, kind="stable")
    sl = labels[order]
    starts = np.searchsorted(sl, np.arange(n_cells))
    rank = np.arange(n) - starts[sl]
    in_cap = rank < cap
    return sl[in_cap], rank[in_cap], order[in_cap], order[~in_cap]


def ivf_fit(
    db,
    n_cells: Optional[int] = None,
    *,
    method: str = "cosine",
    bucket_factor: float = 2.0,
    max_iters: int = 25,
    seed: int = 0,
    as_numpy: bool = False,
    init_rows=None,
    device: Union[None, str, torch.device] = None,
) -> IVFIndex:
    """Build an IVF index over ``db`` [N, D] on ``device`` (None: the card).

    ``n_cells`` defaults to ~sqrt(N). The k-means starts from the rows
    ``init_rows`` [n_cells] of ``db``; by default they are drawn with a
    ``torch.Generator`` seeded with ``seed`` (F2: the JAX package's
    ``jax.random`` draw cannot be reproduced in torch, so a test passes the
    JAX draw here). ``as_numpy`` keeps the stores on the host."""
    if method not in ("cosine", "l2"):
        raise ValueError(f"method must be 'cosine' or 'l2', got {method!r}")
    dev = resolve_device(device)
    db = np.asarray(db, np.float32)
    n, d = db.shape
    if n_cells is None:
        n_cells = max(1, int(np.sqrt(n)))
    n_cells = min(n_cells, n)
    dev_db = torch.from_numpy(db).to(dev)
    if method == "cosine":
        dev_db = l2_normalize(dev_db)
    if init_rows is None:
        init_rows = draw_rows(n, n_cells, torch.Generator().manual_seed(seed))
    init = dev_db[torch.as_tensor(np.array(init_rows), dtype=torch.int64).to(dev)]
    centers, labels = kmeans_fit(dev_db, n_cells, "cosine" if method == "cosine" else "euclidean",
                                 max_iters, init_centers=init)
    del dev_db
    if method == "cosine":
        # unit-norm centroids: probing ranks cells by q^·c, which then
        # matches the assignment geometry
        centers = l2_normalize(centers)
    labels = labels.cpu().numpy()
    cap = max(1, int(np.ceil(n / n_cells * bucket_factor)))
    buckets = np.zeros((n_cells, cap, d), np.float32)
    ids = np.full((n_cells, cap), -1, np.int32)
    cell, slot, rows, over = bucket_rows(labels, n_cells, cap)
    buckets[cell, slot] = db[rows]
    ids[cell, slot] = rows
    overflow = db[over] if over.size else np.zeros((0, d), np.float32)

    def put(a):
        return a if as_numpy else torch.from_numpy(a).to(dev)

    return IVFIndex(cells=centers.cpu().numpy() if as_numpy else centers, buckets=put(buckets),
                    bucket_ids=put(ids), overflow=put(overflow),
                    overflow_ids=put(over.astype(np.int32)), method=method, n_rows=n)


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def to_numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def save_ivf(index: IVFIndex, path: str) -> None:
    """One ``.npz`` with the JAX package's keys (no pickles); the suffix
    is added if missing."""
    np.savez(_npz_path(path), cells=to_numpy(index.cells), buckets=to_numpy(index.buckets),
             bucket_ids=to_numpy(index.bucket_ids), overflow=to_numpy(index.overflow),
             overflow_ids=to_numpy(index.overflow_ids), method=np.asarray(index.method),
             n_rows=np.asarray(index.n_rows))


def load_ivf(path: str, device: Union[None, str, torch.device] = None) -> IVFIndex:
    """An index saved by either package, on ``device`` (None: the card)."""
    dev = resolve_device(device)
    z = np.load(_npz_path(path), allow_pickle=False)
    return IVFIndex(**{key: torch.from_numpy(z[key]).to(dev) for key in
                       ("cells", "buckets", "bucket_ids", "overflow", "overflow_ids")},
                    method=str(z["method"]), n_rows=int(z["n_rows"]))
