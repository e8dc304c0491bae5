"""Exact top-k retrieval, the retrieval engines and Recall@K (counterpart
of ``anyloc_tpu/ops/retrieval.py``).

FAISS conventions: cosine returns inner-product scores, descending
(IndexFlatIP); l2 returns squared L2 distances, ascending (IndexFlatL2).
Ties go to the lower database index, as ``jax.lax.top_k`` orders them: the
port sorts with a stable full sort (``torch.topk`` on the card promises no
order among equal scores).

Engines (``get_top_k_recall(engine=...)``): "device" (the database on the
device, one product), "blocked" (the database stays on the host and
streams through the device shard by shard, ``top_k_search_blocked``),
"native" (the host C++ library, ``anyloc_tpu_torch.native``), "ivf",
"pq" and "ivf_pq" (``ops/ivf.py``, ``ops/pq.py``, ``ops/ivf_pq.py``).
Every engine but "native" runs on ``device``: None means the card, and it
raises without one.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from anyloc_tpu_torch.ops.common import bf16_dot, l2_normalize, resolve_device, score_dot


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


def host_rows(a) -> torch.Tensor:
    """A CPU tensor of host rows (numpy, ``np.memmap`` slice or tensor);
    read-only arrays (a memmap opened "r") are copied first."""
    if isinstance(a, torch.Tensor):
        return a.cpu()
    a = np.asarray(a)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a)
    return torch.from_numpy(a)


def stream_to_device(shards: Iterable[Sequence[Optional[torch.Tensor]]],
                     device: torch.device) -> Iterator[List[Optional[torch.Tensor]]]:
    """Each host shard's tensors on ``device``, in order (None stays None).

    On the card the copy of shard i + 1 is issued before shard i is handed
    over: the host tensors are pinned (``_prepare_shard(pin=True)`` writes
    them there), copied with ``non_blocking=True`` on a side stream, and
    the current stream waits on the copy's event before it uses a shard, so
    the PCIe copy of the next shard overlaps the caller's work on this one
    (the JAX package's double buffer). At most two shards are on the card
    at once; ``record_stream`` keeps a shard's memory until the current
    stream's work on it is done. Elsewhere the tensors are moved as they
    come."""
    if device.type != "cuda":
        for arrs in shards:
            yield [None if a is None else a.to(device) for a in arrs]
        return
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)

    def upload(arrs):
        with torch.cuda.stream(side):
            dev = [None if a is None else
                   (a if a.is_pinned() else a.pin_memory()).to(device, non_blocking=True)
                   for a in arrs]
            done = torch.cuda.Event()
            done.record(side)
        return dev, done

    it = iter(shards)
    first = next(it, None)
    pending = None if first is None else upload(first)
    while pending is not None:
        nxt = next(it, None)
        following = None if nxt is None else upload(nxt)
        dev, done = pending
        main.wait_event(done)
        for t in dev:
            if t is not None:
                t.record_stream(main)
        yield dev
        pending = following


def stream_rows(x, block: int, device: torch.device) -> Iterator[Tuple[int, torch.Tensor]]:
    """(start, rows [start, start + block) of host ``x`` as f32 on
    ``device``), streamed as the blocked engine streams its shards."""
    starts = range(0, x.shape[0], block)
    shards = ((host_rows(x[s:s + block]).float(),) for s in starts)   # pinned on the way
    for s, (rows,) in zip(starts, stream_to_device(shards, device)):
        yield s, rows


def _prepare_shard(db, d0: int, d1: int, stream_dtype: str, normalize_rows: bool = False,
                   pin: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Host-side packing of rows [d0, d1) for the streaming engine: (rows,
    int8 row scales or None) as CPU tensors, pinned with ``pin``.
    ``normalize_rows`` L2-normalizes the shard here, in the rows' own float
    type, as the JAX package does: O(shard) memory instead of a normalized
    copy of a database that may barely fit RAM. "float32" and "bfloat16"
    ship the rows; "int8" ships per-row absmax codes and their f32 scales
    (4x fewer bytes than f32)."""
    blk = host_rows(db[d0:d1])
    if not blk.is_floating_point():
        blk = blk.float()
    if normalize_rows:
        blk = blk / torch.clamp_min(torch.linalg.vector_norm(blk, dim=-1, keepdim=True), 1e-12)
    if stream_dtype == "float32":
        out, scale = blk.float(), None
    elif stream_dtype == "bfloat16":
        out, scale = blk.to(torch.bfloat16), None
    elif stream_dtype == "int8":
        s = torch.clamp_min(blk.abs().amax(dim=1, keepdim=True), 1e-12) / 127.0
        out = torch.clamp(torch.round(blk / s), -127, 127).to(torch.int8)
        scale = s.float()
    else:
        raise ValueError(f"Unknown stream_dtype: {stream_dtype}")
    if pin:
        out = out.pin_memory()
        scale = None if scale is None else scale.pin_memory()
    return out.contiguous(), scale


def _blocked_merge(best_s, best_i, blk, scales, qb, offset: int, k: int, method: str,
                   sign: float):
    """Merge one database shard into the running top-k. ``blk`` is f32,
    bf16, or int8 with ``scales`` [Nb, 1]; narrow types score through a
    bf16 product with f32 sums (the int8 codes dequantized in bf16, as the
    JAX package does)."""
    kk = min(k, blk.shape[0])
    if blk.dtype == torch.float32 and scales is None:
        s, i = top_k_search(blk, qb, kk, method)
    else:
        x = blk if scales is None else blk.to(torch.bfloat16) * scales.to(torch.bfloat16)
        qx = bf16_dot(qb, x.T)
        if method == "cosine":
            s, i = _topk_stable(qx, kk)
        elif method == "l2":
            x32 = x.float()
            d2 = (qb * qb).sum(-1, keepdim=True) - 2.0 * qx + (x32 * x32).sum(-1)[None, :]
            top_neg, i = _topk_stable(-d2, kk)
            s = -top_neg
        else:
            raise ValueError(f"Unknown method: {method}")
    top, pos = _topk_stable(torch.cat([best_s, sign * s], dim=1), k)
    return top, torch.gather(torch.cat([best_i, i + offset], dim=1), 1, pos)


def top_k_search_blocked(
    db,
    qu,
    k: int,
    method: str = "cosine",
    query_block: int = 1024,
    db_block: int = 131072,
    stream_dtype: str = "float32",
    normalize_rows: bool = False,
    *,
    device: Union[None, str, torch.device] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-streaming exact top-k for databases too large for the device:
    db [Ndb, D] stays on the host (numpy, ``np.memmap`` or a CPU tensor)
    and streams through ``device`` once, ``db_block`` rows a shard, the
    copy of shard i + 1 overlapping the product and merge of shard i
    (``stream_to_device``). The queries stay on the device; ``query_block``
    bounds the [qb, db_block] score block. ``stream_dtype`` trades score
    precision for link bytes: "bfloat16" halves them, "int8" (per-row
    absmax codes, dequantized on the device) quarters them. Returns numpy
    (scores [Q, k], indices [Q, k] int64)."""
    dev = resolve_device(device)
    n_db, n_qu = db.shape[0], qu.shape[0]
    k = min(k, n_db)
    if n_db == 0 or n_qu == 0:
        return np.empty((n_qu, k), np.float32), np.empty((n_qu, k), np.int64)
    if method not in ("cosine", "l2"):
        raise ValueError(f"Unknown method: {method}")
    sign = 1.0 if method == "cosine" else -1.0
    qu_dev = (qu if isinstance(qu, torch.Tensor)
              else torch.from_numpy(np.asarray(qu, np.float32))).float().to(dev)
    q_starts = list(range(0, n_qu, query_block))
    best = [(torch.full((min(query_block, n_qu - q0), k), float("-inf"), device=dev),
             torch.zeros((min(query_block, n_qu - q0), k), dtype=torch.int64, device=dev))
            for q0 in q_starts]
    d_starts = list(range(0, n_db, db_block))
    pin = dev.type == "cuda"
    shards = (_prepare_shard(db, d0, d0 + db_block, stream_dtype, normalize_rows, pin)
              for d0 in d_starts)
    for d0, (blk, scales) in zip(d_starts, stream_to_device(shards, dev)):
        for qi, q0 in enumerate(q_starts):
            qb = qu_dev[q0:q0 + best[qi][0].shape[0]]
            best[qi] = _blocked_merge(*best[qi], blk, scales, qb, d0, k, method, sign)
    scores = torch.cat([sign * s for s, _ in best]).cpu().numpy()
    return scores, torch.cat([i for _, i in best]).cpu().numpy()


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


def _host_f32(x, normalize: bool) -> np.ndarray:
    """[Q, D] (or [D]) float32 numpy, L2-normalized with ``normalize``."""
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
    x = np.asarray(x, np.float32)
    if x.ndim == 1:
        x = x[None, :]
    if normalize:
        x = x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
    return x


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
    ivf_index=None,
    n_probe: int = 8,
    pq_index=None,
    pq_m: int = 64,
    ivf_pq_index=None,
    opq_iters: int = 0,
    device: Union[None, str, torch.device] = None,
) -> Tuple[np.ndarray, np.ndarray, Dict[int, float]]:
    """The reference's ``get_top_k_recall``: (distances [Q, max k],
    indices [Q, max k], {k: recall}), with the JAX package's engines and
    arguments (see the module docstring; ``ivf_index`` / ``pq_index`` /
    ``ivf_pq_index`` pass a fitted index, ``n_probe``, ``pq_m`` and
    ``opq_iters`` tune a fit made here). Every engine but "native" runs on
    ``device``, numpy and tensor inputs alike: None means the card (it
    raises without one), "cpu" only when the caller asks. "pq" returns
    positive squared distances for l2, like the exact engines."""
    del use_gpu  # the device is named by ``device``
    if engine == "ivf_pq":
        from anyloc_tpu_torch.ops.ivf_pq import ivf_pq_fit

        dev = resolve_device(device)
        qu = _host_f32(qu, norm_descs)
        if ivf_pq_index is None:
            ivf_pq_index = ivf_pq_fit(_host_f32(db, norm_descs), m=pq_m, method=method,
                                      opq_iters=opq_iters, device=dev)
        dists, indices = ivf_pq_index.search(qu, int(max(top_k)), n_probe=n_probe,
                                             score_dtype=score_dtype)
        dists, indices = dists.cpu().numpy(), indices.cpu().numpy()
        return dists, indices, compute_recalls(indices, gt_pos, top_k, use_percentage,
                                               sub_sample_db, sub_sample_qu)
    if score_dtype != "float32" and engine == "ivf":
        raise ValueError("score_dtype is only supported by the 'device' engine; the ivf "
                         "engine scores in float32")
    if engine == "pq":
        from anyloc_tpu_torch.ops.pq import pq_fit

        dev = resolve_device(device)
        qu = _host_f32(qu, norm_descs)
        if pq_index is None:
            pq_index = pq_fit(_host_f32(db, norm_descs), pq_m, method=method,
                              opq_iters=opq_iters, device=dev)
        dists, indices = pq_index.search(qu, int(max(top_k)), score_dtype=score_dtype)
        dists, indices = dists.cpu().numpy(), indices.cpu().numpy()
        if method == "l2":
            # PQIndex.search scores -|q - x̂|^2 + |q|^2 (higher is better);
            # the exact engines return positive squared distances
            dists = np.sum(qu * qu, axis=1, keepdims=True) - dists
        return dists, indices, compute_recalls(indices, gt_pos, top_k, use_percentage,
                                               sub_sample_db, sub_sample_qu)
    if engine == "ivf":
        from anyloc_tpu_torch.ops.ivf import ivf_fit

        dev = resolve_device(device)
        qu = _host_f32(qu, norm_descs)
        if ivf_index is None:
            ivf_index = ivf_fit(_host_f32(db, norm_descs), method=method, device=dev)
        dists, indices = ivf_index.search(qu, int(max(top_k)), n_probe=n_probe)
        dists, indices = dists.cpu().numpy(), indices.cpu().numpy()
        return dists, indices, compute_recalls(indices, gt_pos, top_k, use_percentage,
                                               sub_sample_db, sub_sample_qu)
    if score_dtype != "float32" and engine != "device":
        # blocked has its own stream_dtype knob; native is host f32
        raise ValueError(f"score_dtype={score_dtype!r} is only supported by the 'device' "
                         f"engine (got engine={engine!r})")
    if engine == "blocked":
        # db stays where it is (it may barely fit RAM): _prepare_shard
        # converts and normalizes each streamed shard
        db = db if isinstance(db, torch.Tensor) else np.asarray(db)
        qu = _host_f32(qu, norm_descs)
        max_k = min(int(max(top_k)), db.shape[0])
        dists, indices = top_k_search_blocked(db, qu, max_k, method, normalize_rows=norm_descs,
                                              device=device)
        return dists, indices, compute_recalls(indices, gt_pos, top_k, use_percentage,
                                               sub_sample_db, sub_sample_qu)
    if engine == "native":
        from anyloc_tpu_torch import native

        db, qu = _host_f32(db, norm_descs), _host_f32(qu, norm_descs)
        max_k = min(int(max(top_k)), db.shape[0])
        dists, indices = native.nn_search(db, qu, max_k, method)
        return dists, indices, compute_recalls(indices, gt_pos, top_k, use_percentage,
                                               sub_sample_db, sub_sample_qu)
    if engine != "device":
        raise ValueError(f"Unknown engine: {engine!r}")
    dev = resolve_device(device)
    db = torch.as_tensor(db, dtype=torch.float32, device=dev)
    qu = torch.as_tensor(qu, dtype=torch.float32, device=dev)
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
