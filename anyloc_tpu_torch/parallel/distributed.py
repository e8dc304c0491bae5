"""Sharded k-means, retrieval and extraction over a mesh (counterpart of
``anyloc_tpu/parallel/distributed.py``).

Every rank calls each function with the same host inputs and gets the
same result (the SPMD contract of ``parallel/mesh.py``). The descriptor
set, the database or the images shard over the mesh's ``data`` axis and
the collectives are explicit:

  * k-means: each rank's Lloyd statistics (``ops/kmeans.py``'s
    ``_shard_stats``) over its rows, one ``all_reduce`` of the sums and
    counts, the mean update; equal to ``kmeans_fit`` on the whole set up
    to the order of the float sums;
  * retrieval: each rank's top-k over its rows (or cells, or codes), the
    [Q, k] partials all-gathered and merged with the single-device
    engines' tie order (shard-major, then local order: the lower global
    id first);
  * extraction: each rank runs its images, the outputs are all-gathered.
"""

from __future__ import annotations

import weakref
from typing import Optional, Tuple, Union

import numpy as np
import torch

from anyloc_tpu_torch.ops.common import cdiv, resolve_device, score_dot
from anyloc_tpu_torch.ops.ivf import as_device_tensor
from anyloc_tpu_torch.ops.kmeans import _shard_stats, _update_centers, draw_rows
from anyloc_tpu_torch.ops.retrieval import _topk_stable
from anyloc_tpu_torch.parallel.mesh import (
    all_gather,
    all_reduce,
    axis_index,
    axis_size,
    pad_to_multiple,
    shard_rows,
)

Device = Union[None, str, torch.device]


def _data(mesh) -> Tuple[int, int]:
    return axis_size(mesh, "data"), axis_index(mesh, "data")


# ---------------------------------------------------------------------------
# Sharded k-means
# ---------------------------------------------------------------------------

def kmeans_fit_sharded(
    descs,
    n_clusters: int,
    mesh,
    mode: str = "cosine",
    max_iters: int = 100,
    *,
    init_rows=None,
    generator: Optional[torch.Generator] = None,
    device: Device = None,
) -> torch.Tensor:
    """Distributed Lloyd k-means of the host rows ``descs`` [N, D], sharded
    over the mesh's ``data`` axis; returns the replicated centers [C, D] on
    ``device`` (None: the card). The start is the rows ``init_rows`` of
    ``descs`` (F2: the JAX package draws them with ``jax.random``), by
    default drawn with ``generator`` as ``kmeans_fit`` draws them. The pad
    rows of the last shard carry weight 0: they are left out."""
    dev = resolve_device(device)
    x = np.asarray(descs, np.float32)
    n = x.shape[0]
    n_dev, r = _data(mesh)
    local_n = cdiv(n, n_dev)
    rows = torch.from_numpy(np.ascontiguousarray(x[r * local_n:(r + 1) * local_n])).to(dev)
    if init_rows is None:
        init_rows = draw_rows(n, n_clusters, generator)
    centers = torch.from_numpy(x[np.asarray(init_rows)]).to(dev)
    for _ in range(max_iters):
        sums, counts = _shard_stats(rows, centers, mode)
        # the collective: one all_reduce of [C, D + 1] (sums | counts)
        both = all_reduce(torch.cat([sums, counts[:, None]], dim=1), mesh, "data")
        centers = _update_centers(both[:, :-1], both[:, -1], centers)
    return centers


# ---------------------------------------------------------------------------
# Sharded exact top-k retrieval
# ---------------------------------------------------------------------------

def _merge_partials(metric: torch.Tensor, ids: torch.Tensor, mesh, k: int):
    """All-gather every data shard's [Q, cols] top-k partial and merge to
    the global top k. ``metric`` is higher-is-better with invalid slots at
    -inf (ids -1); the partials concatenate shard-major, so equal metrics
    keep the single-device engines' order. The one merge of the exact,
    pq, ivf and ivf_pq sharded engines."""
    n = axis_size(mesh, "data")
    nq, cols = metric.shape
    m_cat = all_gather(metric.contiguous(), mesh, "data").view(n, nq, cols)
    i_cat = all_gather(ids.contiguous(), mesh, "data").view(n, nq, cols)
    m_cat = m_cat.transpose(0, 1).reshape(nq, n * cols)
    i_cat = i_cat.transpose(0, 1).reshape(nq, n * cols)
    best, pos = _topk_stable(m_cat, k)
    return best, torch.gather(i_cat, 1, pos)


def top_k_search_sharded(
    db,
    qu,
    k: int,
    mesh,
    method: str = "cosine",
    score_dtype: str = "float32",
    n_valid: Optional[int] = None,
    *,
    device: Device = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Database-sharded exact top-k: each rank scores the replicated
    queries against its rows of ``db``, the [Q, k] partials all-gather and
    merge. Equal to ``top_k_search`` on the whole database (ties to the
    lower index). Returns numpy (scores, ids).

    ``db`` is the host database [N, D], or this rank's RESIDENT shard (a
    tensor: rows of the database padded to the mesh, ``shard_rows``); pass
    ``n_valid``, the unpadded row count, then. The pad rows score -inf
    before the local top-k: a zero row scores 0 and would outrank true
    matches that all score below 0. ``device`` (None: the card) is where a
    host database goes; a resident shard stays where it is."""
    dot = score_dot(score_dtype)
    if method not in ("cosine", "l2"):
        raise ValueError(f"Unknown method: {method!r}")
    n_dev, r = _data(mesh)
    if isinstance(db, torch.Tensor):
        local, dev = db, db.device
        if n_valid is None:
            n_valid = local.shape[0] * n_dev
    else:
        dev = resolve_device(device)
        db_pad, pad_valid = pad_to_multiple(np.asarray(db, np.float32), n_dev)
        if n_valid is None:
            n_valid = pad_valid   # a caller's count of a pre-padded database stays
        local = torch.from_numpy(np.ascontiguousarray(shard_rows(db_pad, mesh))).to(dev)
    k = max(1, min(k, n_valid))
    local_n = local.shape[0]
    q = as_device_tensor(qu, dev).float()
    if q.dim() == 1:
        q = q[None]
    offset = r * local_n
    if method == "cosine":
        scores = dot(q, local.T)
    else:
        loc32 = local.float()
        scores = -((q * q).sum(-1, keepdim=True) - 2.0 * dot(q, local.T)
                   + (loc32 * loc32).sum(-1)[None, :])
    col = torch.arange(local_n, device=dev) + offset
    scores = torch.where(col[None] < n_valid, scores, float("-inf"))
    s, i = _topk_stable(scores, min(k, local_n))
    best, ids = _merge_partials(s, i + offset, mesh, k)
    sign = 1.0 if method == "cosine" else -1.0
    return (sign * best).cpu().numpy(), ids.cpu().numpy()


def get_top_k_recall_sharded(
    top_k, db, qu, gt_pos, mesh, method="cosine", norm_descs=True,
    use_percentage=True, sub_sample_db=1, sub_sample_qu=1,
    score_dtype="float32", engine="device", pq_m=64, n_probe=8,
    opq_iters=0, index=None, *, device: Device = None,
):
    """Sharded-database ``get_top_k_recall``: (distances, indices,
    {k: recall}). ``engine`` "device" (exact rows sharded), "pq" (codes
    sharded), "ivf" (f32 cell buckets sharded) or "ivf_pq" (residual-code
    cell buckets sharded). A prebuilt ``index`` (PQIndex / IVFIndex /
    IVFPQIndex) is used as it is and the database is not read; otherwise
    one is fit here on ``device`` (None: the card) and kept on the host,
    each rank taking its shard."""
    from anyloc_tpu_torch.ops.retrieval import compute_recalls

    dev = resolve_device(device)
    qu = np.asarray(qu, np.float32)
    if qu.ndim == 1:
        qu = qu[None]
    if norm_descs:
        qu = qu / np.maximum(np.linalg.norm(qu, axis=-1, keepdims=True), 1e-12)
    if engine != "device" and index is not None:
        db_rows = index.n_rows
    else:
        db = np.asarray(db, np.float32)
        if norm_descs:
            db = db / np.maximum(np.linalg.norm(db, axis=-1, keepdims=True), 1e-12)
        db_rows = db.shape[0]
    max_k = min(int(max(top_k)), db_rows)
    if engine == "pq":
        if index is None:
            from anyloc_tpu_torch.ops.pq import pq_fit

            index = pq_fit(db, pq_m, method=method, opq_iters=opq_iters, as_numpy=True,
                           device=dev)
        dists, indices = pq_search_sharded(index, qu, max_k, mesh, score_dtype=score_dtype,
                                           device=dev)
        if method == "l2":
            # PQIndex.search scores -|q - x̂|^2 + |q|^2; the recall API
            # returns positive squared distances, as the single-device one
            dists = np.sum(qu * qu, axis=1, keepdims=True) - dists
    elif engine == "ivf":
        if score_dtype != "float32":
            raise ValueError("score_dtype is only supported by the 'device'/'pq'/'ivf_pq' "
                             "sharded engines; ivf scores in float32")
        if index is None:
            from anyloc_tpu_torch.ops.ivf import ivf_fit

            index = ivf_fit(db, method=method, as_numpy=True, device=dev)
        dists, indices = ivf_search_sharded(index, qu, max_k, mesh, n_probe=n_probe, device=dev)
    elif engine == "ivf_pq":
        if index is None:
            from anyloc_tpu_torch.ops.ivf_pq import ivf_pq_fit

            index = ivf_pq_fit(db, m=pq_m, method=method, opq_iters=opq_iters, as_numpy=True,
                               device=dev)
        dists, indices = ivf_pq_search_sharded(index, qu, max_k, mesh, n_probe=n_probe,
                                               score_dtype=score_dtype, device=dev)
    elif engine == "device":
        dists, indices = top_k_search_sharded(db, qu, max_k, mesh, method,
                                              score_dtype=score_dtype, device=dev)
    else:
        raise ValueError(f"unknown sharded engine {engine!r}")
    recalls = compute_recalls(indices, gt_pos, top_k, use_percentage, sub_sample_db,
                              sub_sample_qu)
    return dists, indices, recalls


# ---------------------------------------------------------------------------
# Sharded compressed (PQ / IVF / IVF-PQ) top-k retrieval
# ---------------------------------------------------------------------------

_SHARDED_STATE_CACHE: dict = {}


def _sharded_index_state(index, mesh, device: torch.device, build):
    """Per-(index, mesh, device) cache of this rank's resident shards, so
    that repeated searches do not cut and upload the stores again. Keyed
    by object identity with a weakref guard: a dead or recycled id never
    serves stale state."""
    key = (id(index), mesh, str(device))
    hit = _SHARDED_STATE_CACHE.get(key)
    if hit is not None:
        ref, state = hit
        if ref() is index:
            return state
    state = build()
    try:
        ref = weakref.ref(index, lambda _: _SHARDED_STATE_CACHE.pop(key, None))
    except TypeError:   # an index type without weak references: no cache
        return state
    _SHARDED_STATE_CACHE[key] = (ref, state)
    return state


def _window(a, lo: int, hi: int, fill, device: torch.device) -> torch.Tensor:
    """Rows [lo, hi) of ``a`` (numpy or tensor) on ``device``, rows past
    its end filled with ``fill`` (the pad of the last shard)."""
    part = a[lo:min(hi, a.shape[0])]
    part = (part if isinstance(part, torch.Tensor) else torch.from_numpy(np.asarray(part)))
    part = part.to(device)
    if part.shape[0] < hi - lo:
        pad = torch.full((hi - lo - part.shape[0],) + tuple(part.shape[1:]), fill,
                         dtype=part.dtype, device=device)
        part = torch.cat([part, pad])
    return part


def _queries(qu, dim: int, rotation, device: torch.device) -> torch.Tensor:
    """The replicated queries [Q, D] on ``device``, into the OPQ-rotated
    code space where the index has a rotation."""
    q = as_device_tensor(qu, device).float()
    if q.dim() != 2 or q.shape[1] != dim:
        raise ValueError(f"queries must be [Q, {dim}], got {tuple(q.shape)}")
    if rotation is not None:
        q = q @ as_device_tensor(rotation, device)
    return q


def _empty(k: int):
    return np.zeros((0, k), np.float32), np.zeros((0, k), np.int64)


def pq_search_sharded(
    index,
    qu,
    k: int,
    mesh,
    *,
    score_dtype: str = "float32",
    scan: str = "auto",
    db_block: int = 8192,
    device: Device = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """PQ (ADC) search with the CODE matrix sharded over ``data``: each rank
    scans its rows (``ops/pq.py::_pq_search_block``, the pad rows masked
    by its ``n_valid`` hook) and the partials merge. Scores and (tie-free)
    ids equal ``index.search``; the query block and scan follow it.
    Returns numpy (scores [Q, k], ids [Q, k]), higher is better."""
    from anyloc_tpu_torch.ops.pq import _pq_search_block

    dev = resolve_device(device)
    q = _queries(qu, index.dim, index.rotation, dev)
    n = index.n_rows
    n_dev, r = _data(mesh)
    local_n = cdiv(n, n_dev)
    k = max(1, min(k, n))
    nq = q.shape[0]
    if nq == 0:
        return _empty(k)
    qb = min(256, nq)
    if scan == "auto":
        scan = "decode" if qb > index.dim // index.m else "tables"
    offset = r * local_n
    cb, codes = _sharded_index_state(index, mesh, dev, lambda: (
        as_device_tensor(index.codebooks, dev).float(),
        _window(index.codes, offset, offset + local_n, 0, dev)))
    parts = [_pq_search_block(cb, codes, q[q0:q0 + qb], k=min(k, local_n),
                              nb=int(min(db_block, local_n)), method=index.method,
                              score_dtype=score_dtype, scan=scan, n_valid=max(n - offset, 0))
             for q0 in range(0, nq, qb)]
    s = torch.cat([p[0] for p in parts])
    gi = torch.where(s > float("-inf"), torch.cat([p[1] for p in parts]) + offset, -1)
    best, ids = _merge_partials(s, gi, mesh, k)
    return best.cpu().numpy(), ids.cpu().numpy()


def _cell_window(index, stores, cap_fill, mesh, dev):
    """(local_lo, the rank's window of each cell-major store) of a
    cell-sharded index: ``local_c`` = ceil(n_cells / n_dev) cells a rank,
    the last window padded with ``cap_fill``'s values (ids -1)."""
    n_dev, r = _data(mesh)
    local_c = cdiv(index.n_cells, n_dev)
    lo = r * local_c
    return lo, [_window(getattr(index, name), lo, lo + local_c, cap_fill[name], dev)
                for name in stores]


def ivf_search_sharded(
    index,
    qu,
    k: int,
    mesh,
    *,
    n_probe: int = 8,
    query_block: int = 64,
    max_workset_mb: int = 1024,
    device: Device = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """IVF-flat search with the CELL buckets sharded over ``data``: the
    replicated coarse cells give every rank the same global probe; only
    the cells a rank owns give candidates (``_ivf_search``'s ``local_lo``
    hook), rank 0 alone scores the overflow pool (``overflow_gate``), and
    the partials merge. Equal to ``index.search`` (tie-free ids), full
    probe equal to exact search. Sharding buys memory (each rank holds
    ~1/n of the [n_cells, cap, D] store), not scan work."""
    from anyloc_tpu_torch.ops.ivf import _ivf_search

    dev = resolve_device(device)
    d = index.buckets.shape[2]
    q = _queries(qu, d, None, dev)
    n_probe = min(n_probe, index.n_cells)
    cap = index.buckets.shape[1]
    shortlist = n_probe * cap + int(index.overflow.shape[0])
    k = max(1, min(k, index.n_rows or shortlist, shortlist))
    nq = q.shape[0]
    if nq == 0:
        return _empty(k)
    qb = min(query_block, nq, max(1, (max_workset_mb << 20) // max(1, n_probe * cap * d * 4)))

    def build():
        lo, (buckets, ids) = _cell_window(index, ("buckets", "bucket_ids"),
                                          {"buckets": 0.0, "bucket_ids": -1}, mesh, dev)
        return lo, (as_device_tensor(index.cells, dev), buckets, ids,
                    as_device_tensor(index.overflow, dev),
                    as_device_tensor(index.overflow_ids, dev))

    lo, stores = _sharded_index_state(index, mesh, dev, build)
    top, ids = _ivf_search(*stores, q, k=k, n_probe=n_probe, method=index.method, qb=qb,
                           local_lo=lo, overflow_gate=_data(mesh)[1] == 0)
    l2 = index.method == "l2"
    metric = torch.where(ids >= 0, -top if l2 else top, float("-inf"))   # higher is better
    best, mi = _merge_partials(metric, ids, mesh, k)
    return (-best if l2 else best).cpu().numpy(), mi.cpu().numpy()


def ivf_pq_search_sharded(
    index,
    qu,
    k: int,
    mesh,
    *,
    n_probe: int = 8,
    score_dtype: str = "float32",
    query_block: int = 16,
    max_workset_mb: int = 256,
    device: Device = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """IVF-PQ search with the CELL buckets sharded over ``data``, built as
    ``ivf_search_sharded``: global probe on the replicated cells, each
    bucket scored on the rank that owns it, rank 0 scoring the overflow
    pool, partials merged. Scores and (tie-free) ids equal
    ``index.search`` (l2: positive distances, ascending). Sharding buys
    memory (the code store splits ~1/n a rank), not scan work."""
    from anyloc_tpu_torch.ops.ivf_pq import _STORES, _ivf_pq_search

    dev = resolve_device(device)
    q = _queries(qu, index.dim, index.rotation, dev)
    n_probe = min(n_probe, index.n_cells)
    cap = index.codes.shape[1]
    shortlist = n_probe * cap + int(index.overflow_codes.shape[0])
    k = max(1, min(k, index.n_rows or shortlist, shortlist))
    nq = q.shape[0]
    if nq == 0:
        return _empty(k)
    if score_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"Unknown score_dtype: {score_dtype!r}")
    qb = min(query_block, nq)
    rows = max(128, (max_workset_mb << 20) // max(1, qb * index.m * 8))
    windowed = ("codes", "bucket_ids", "recon_sq")

    def build():
        lo, parts = _cell_window(index, windowed,
                                 {"codes": 0, "bucket_ids": -1, "recon_sq": 0.0}, mesh, dev)
        stores = {name: as_device_tensor(getattr(index, name), dev) for name in _STORES
                  if name not in windowed}
        return lo, {**stores, **dict(zip(windowed, parts))}

    lo, stores = _sharded_index_state(index, mesh, dev, build)
    top, ids = _ivf_pq_search(**stores, qu=q, k=k, n_probe=n_probe, method=index.method, qb=qb,
                              cand_chunk=int(rows), score_dtype=score_dtype, local_lo=lo,
                              overflow_gate=_data(mesh)[1] == 0)
    l2 = index.method == "l2"
    metric = torch.where(ids >= 0, -top if l2 else top, float("-inf"))   # higher is better
    best, mi = _merge_partials(metric, ids, mesh, k)
    return (-best if l2 else best).cpu().numpy(), mi.cpu().numpy()


# ---------------------------------------------------------------------------
# Data-parallel extraction
# ---------------------------------------------------------------------------

def sharded_extract_fn(apply_fn, mesh, as_numpy: bool = True):
    """Wrap ``apply_fn(params, images) -> [B, ...]`` for data-parallel
    execution: the host images [B, ...] pad to the ``data`` axis, each
    rank runs its block, the outputs all-gather. ``run(params, images)``
    returns numpy [B, ...]; with ``as_numpy`` False, (the gathered tensor
    on the device with the padded tail still attached, the valid count),
    for callers that feed it into more device work. Where ``apply_fn``
    aggregates (VLAD), only its [B, C·D] output crosses between ranks."""

    def run(params, images):
        padded, n_valid = pad_to_multiple(np.asarray(images), axis_size(mesh, "data"))
        out = all_gather(apply_fn(params, shard_rows(padded, mesh)), mesh, "data")
        if as_numpy:
            return out[:n_valid].cpu().numpy()
        return out, n_valid

    return run
