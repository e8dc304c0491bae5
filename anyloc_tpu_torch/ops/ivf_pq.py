"""IVF-PQ: probed cells plus residual PQ codes (counterpart of
``anyloc_tpu/ops/ivf_pq.py``, the FAISS ``IndexIVFPQ`` counterpart).

The composition of ``ops/ivf.py`` (dense padded cell buckets and an
overflow pool, so no row is ever unsearchable) and ``ops/pq.py`` (ADC on
uint8 codes). Rows are encoded as residuals against their assigned cell
with codebooks shared across cells, so with x̂ = c_p + decode(code):

    <q, x̂> = <q, c_p> + sum_m <q_m, cb[m, code_m]>

The per-query tables t[m, c] = <q_m, cb[m, c]> do not depend on the cell,
and the cell term is a row of the probe's own q @ cellsᵀ. l2 needs one
more number per row, |x̂|^2 (``recon_sq``), computed at fit:
-|q - x̂|^2 = -(|q|^2 - 2 <q, x̂> + |x̂|^2). Scores follow ``ops/ivf.py``:
the raw inner product for "cosine", positive squared distances for "l2".
Probing every cell is exact search over the reconstructions.

As in ``ops/pq.py`` the ADC sum is a gather of the tables (the JAX
package's one-hot product computes the same sums), chunked along the
candidates so that the gathered block stays under ``max_workset_mb``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from anyloc_tpu_torch.ops.common import l2_normalize, resolve_device
from anyloc_tpu_torch.ops.ivf import (
    _npz_path,
    as_device_tensor,
    bucket_rows,
    index_device,
    to_numpy,
)
from anyloc_tpu_torch.ops.kmeans import draw_rows, kmeans_fit
from anyloc_tpu_torch.ops.pq import (
    _code_offsets,
    _sample,
    adc_sums,
    code_rows,
    fit_subspaces,
    opq_train,
)
from anyloc_tpu_torch.ops.retrieval import _topk_stable, stream_rows

_STORES = ("cells", "codebooks", "codes", "bucket_ids", "recon_sq", "overflow_codes",
           "overflow_cell", "overflow_ids", "overflow_recon_sq")


@dataclasses.dataclass
class IVFPQIndex:
    """Fitted IVF-PQ index: cells, codebooks and uint8 codes (plus one f32
    per row for l2); the rows themselves are not kept."""

    cells: torch.Tensor            # [n_cells, D] coarse centroids
    codebooks: torch.Tensor        # [M, C, ds] residual codebooks (shared)
    codes: torch.Tensor            # [n_cells, cap, M] uint8 bucketed codes
    bucket_ids: torch.Tensor       # [n_cells, cap] int32 row ids (-1 pad)
    recon_sq: torch.Tensor         # [n_cells, cap] f32 |x̂|^2 (0 at pads)
    overflow_codes: torch.Tensor   # [n_over, M] uint8
    overflow_cell: torch.Tensor    # [n_over] int32 assigned cell
    overflow_ids: torch.Tensor     # [n_over] int32
    overflow_recon_sq: torch.Tensor  # [n_over] f32
    n_rows: int = 0
    method: str = "cosine"
    rotation: Optional[torch.Tensor] = None   # OPQ [D, D]: cells and codes live in x @ R

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def m(self) -> int:
        return self.codebooks.shape[0]

    @property
    def n_codes(self) -> int:
        return self.codebooks.shape[1]

    @property
    def dim(self) -> int:
        return self.cells.shape[1]

    def search(self, qu, k: int, n_probe: int = 8, query_block: int = 16,
               max_workset_mb: int = 256, score_dtype: str = "float32"):
        """ADC top-k over the probed cells: qu [Q, D] -> (scores [Q, k],
        indices [Q, k] int64). ``score_dtype`` "bfloat16" gathers bf16
        tables and sums in f32. ``max_workset_mb`` bounds the gathered
        block (qb x candidates x M entries); the candidates chunk to fit."""
        dev = index_device(self.cells)
        n_probe = min(n_probe, self.n_cells)
        qu = as_device_tensor(qu, dev).float()
        d = self.dim
        if qu.dim() != 2 or qu.shape[1] != d:
            raise ValueError(f"queries must be [Q, {d}], got {tuple(qu.shape)}")
        if self.rotation is not None:
            qu = qu @ as_device_tensor(self.rotation, dev)
        cap = self.codes.shape[1]
        shortlist = n_probe * cap + int(self.overflow_codes.shape[0])
        k = max(1, min(k, self.n_rows or shortlist, shortlist))
        if qu.shape[0] == 0:
            return (torch.zeros((0, k), dtype=torch.float32, device=dev),
                    torch.zeros((0, k), dtype=torch.int64, device=dev))
        if score_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"Unknown score_dtype: {score_dtype!r}")
        qb = min(query_block, qu.shape[0])
        # candidate rows per gathered chunk (floor 128): the chunk's int64
        # table indices [qb, rows, M] are its largest block
        rows = max(128, (max_workset_mb << 20) // max(1, qb * self.m * 8))
        stores = {name: as_device_tensor(getattr(self, name), dev) for name in _STORES}
        return _ivf_pq_search(**stores, qu=qu, k=k, n_probe=n_probe, method=self.method, qb=qb,
                              cand_chunk=int(rows), score_dtype=score_dtype)

    def decode(self, rows: Optional[np.ndarray] = None) -> np.ndarray:
        """Reconstructions x̂ = c_cell + decode(code) [*, D] for ``rows``
        (default: all, in row order), in the original space."""
        cells, cb = to_numpy(self.cells), to_numpy(self.codebooks)
        m = cb.shape[0]
        out = np.zeros((self.n_rows, cells.shape[1]), np.float32)
        ids, codes = to_numpy(self.bucket_ids), to_numpy(self.codes)
        valid = ids >= 0
        cell_of = np.broadcast_to(np.arange(ids.shape[0])[:, None], ids.shape)[valid]
        res = cb[np.arange(m)[None], codes[valid].astype(np.int64)]
        out[ids[valid]] = cells[cell_of] + res.reshape(res.shape[0], -1)
        o_ids = to_numpy(self.overflow_ids)
        if o_ids.size:
            o_res = cb[np.arange(m)[None], to_numpy(self.overflow_codes).astype(np.int64)]
            out[o_ids] = cells[to_numpy(self.overflow_cell)] + o_res.reshape(o_ids.size, -1)
        if rows is not None:
            out = out[np.asarray(rows)]
        if self.rotation is not None:
            out = out @ to_numpy(self.rotation).T
        return out


def _ivf_pq_search(cells, codebooks, codes, bucket_ids, recon_sq, overflow_codes,
                   overflow_cell, overflow_ids, overflow_recon_sq, qu, *, k: int, n_probe: int,
                   method: str, qb: int, cand_chunk: int, score_dtype: str,
                   local_lo: Optional[int] = None, overflow_gate: Optional[bool] = None):
    """``local_lo`` / ``overflow_gate``: the cell-sharded hooks of
    ``ops/ivf.py::_ivf_search`` (``parallel/distributed.py::
    ivf_pq_search_sharded``): ``codes`` / ``bucket_ids`` / ``recon_sq``
    hold the cell window [local_lo, local_lo + codes.shape[0]), the probe
    stays global, foreign cells and a gated-off overflow pool mask to id
    -1. None / None is the unsharded search."""
    if method not in ("cosine", "l2"):
        raise ValueError(f"Unknown method: {method}")
    nq, d = qu.shape
    n_cells, cap, m = codes.shape
    c = codebooks.shape[1]
    n_over = overflow_codes.shape[0]
    dev = qu.device
    offs = _code_offsets(m, c, dev)
    tdt = torch.bfloat16 if score_dtype == "bfloat16" else torch.float32
    L = n_probe * cap
    probes_per_chunk = max(1, cand_chunk // cap)   # the probed cells gathered at once
    tops, idx = [], []
    for q0 in range(0, nq, qb):
        q = qu[q0:q0 + qb]
        b = q.shape[0]
        # one product serves the probe and the rows' cell term <q, c_p>
        cell_dot = q @ cells.T
        probe_score = (2.0 * cell_dot - (cells * cells).sum(-1)[None] if method == "l2"
                       else cell_dot)   # cosine cells are unit-norm
        _, probe = _topk_stable(probe_score, n_probe)
        # cell-independent ADC tables t[q, m, c] = <q_m, cb[m, c]>
        t = torch.einsum("qmd,mcd->qmc", q.reshape(b, m, d // m), codebooks)
        t = t.reshape(b, m * c).to(tdt)
        if local_lo is None:
            lp = probe
            cand_ids = bucket_ids[probe].reshape(b, L).long()
        else:
            # the window's cells; another shard's probed cells mask to id -1
            lp = (probe - local_lo).clamp(0, n_cells - 1)
            own = ((probe >= local_lo) & (probe < local_lo + n_cells))[:, :, None]
            cand_ids = torch.where(own, bucket_ids[lp].long(), -1).reshape(b, L)
        cand_rsq = recon_sq[lp].reshape(b, L)
        bias = torch.gather(cell_dot, 1, probe)[:, :, None].expand(b, n_probe, cap).reshape(b, L)
        adc = [adc_sums(t, codes[lp[:, p0:p0 + probes_per_chunk]].reshape(b, -1, m).long()
                        + offs, m) for p0 in range(0, n_probe, probes_per_chunk)]
        core = torch.cat(adc, dim=1) + bias                                  # <q, x̂>
        q2 = (q * q).sum(-1, keepdim=True)
        s = -(q2 - 2.0 * core + cand_rsq) if method == "l2" else core
        s = torch.where(cand_ids >= 0, s, float("-inf"))
        if n_over:
            so = torch.cat([adc_sums(t, overflow_codes[r0:r0 + cand_chunk].long() + offs, m)
                            for r0 in range(0, n_over, cand_chunk)], dim=1)
            so = so + cell_dot[:, overflow_cell.long()]
            if method == "l2":
                so = -(q2 - 2.0 * so + overflow_recon_sq[None])
            o_ids = overflow_ids.long()[None].expand(b, -1)
            if overflow_gate is not None and not overflow_gate:
                so, o_ids = torch.full_like(so, float("-inf")), torch.full_like(o_ids, -1)
            s = torch.cat([s, so], dim=1)
            cand_ids = torch.cat([cand_ids, o_ids], dim=1)
        top, pos = _topk_stable(s, k)
        tops.append(-top if method == "l2" else top)   # l2: positive squared distances
        idx.append(torch.gather(cand_ids, 1, pos))
    return torch.cat(tops), torch.cat(idx)


def _assign_cells(cells: torch.Tensor, x: torch.Tensor, method: str) -> torch.Tensor:
    """Coarse cell per row: cosine by inner product against unit-norm cells
    (scale-invariant in x), l2 by squared distance."""
    dot = x @ cells.T
    if method == "l2":
        return torch.argmax(2.0 * dot - (cells * cells).sum(-1)[None], dim=-1)
    return torch.argmax(dot, dim=-1)


def _encode_block(cells, codebooks, chunk, *, method: str):
    """(labels, residual codes, |x̂|^2) of one streamed chunk."""
    m, _, ds = codebooks.shape
    lab = _assign_cells(cells, chunk, method)
    res = chunk - cells[lab]
    xc = torch.einsum("bmd,mcd->bmc", res.reshape(res.shape[0], m, ds), codebooks)
    cod = torch.argmax(2.0 * xc - (codebooks * codebooks).sum(-1)[None], dim=-1)
    res_hat = codebooks[torch.arange(m, device=chunk.device)[None, :], cod]
    xhat = cells[lab] + res_hat.reshape(res.shape[0], -1)
    return lab.to(torch.int32), cod.to(torch.uint8), (xhat * xhat).sum(-1)


def ivf_pq_fit(
    db,
    n_cells: Optional[int] = None,
    *,
    m: int = 64,
    n_codes: int = 256,
    method: str = "cosine",
    bucket_factor: float = 2.0,
    coarse_iters: int = 25,
    pq_iters: int = 25,
    seed: int = 0,
    train_rows: int = 1 << 18,
    encode_block: int = 1 << 16,
    opq_iters: int = 0,
    as_numpy: bool = False,
    init_cell_rows=None,
    init_code_rows=None,
    init_opq_rows=None,
    device: Union[None, str, torch.device] = None,
) -> IVFPQIndex:
    """Build an IVF-PQ index over ``db`` [N, D] (numpy or memmap) on
    ``device`` (None: the card).

    The coarse k-means and the M residual k-means train on a uniform
    sample of at most ``train_rows`` rows (drawn with
    ``np.random.default_rng(seed)`` as the JAX package does); the database
    then streams through the device ``encode_block`` rows at a time. The
    k-means starts are rows of the sample (F2: the JAX package draws them
    with ``jax.random``): ``init_cell_rows`` [n_cells] (default drawn with
    a ``torch.Generator`` seeded with ``seed``), ``init_code_rows`` [M, C]
    (default ``code_rows(m, S, C, seed + 1)``) and, with ``opq_iters``,
    ``init_opq_rows`` [M, C] for ``opq_train`` (default seed ``seed``)."""
    if method not in ("cosine", "l2"):
        raise ValueError(f"method must be 'cosine' or 'l2', got {method!r}")
    if not 2 <= n_codes <= 256:
        raise ValueError(f"n_codes must be in [2, 256], got {n_codes}")
    n, d = db.shape
    if d % m:
        raise ValueError(f"dim {d} not divisible into m={m} subspaces")
    if n < n_codes:
        raise ValueError(f"need >= n_codes={n_codes} rows, got {n}")
    dev = resolve_device(device)
    if n_cells is None:
        n_cells = max(1, int(np.sqrt(n)))
    n_cells = min(n_cells, n, train_rows)   # the coarse centers come from the sample
    ds = d // m
    sample = _sample(db, train_rows, seed)
    s_rows = sample.shape[0]
    rotation = None
    if opq_iters:
        rotation = opq_train(sample, m, n_codes=n_codes, opq_iters=opq_iters, seed=seed,
                             init_rows=init_opq_rows, device=dev)
        sample = sample @ rotation
    raw = torch.from_numpy(np.ascontiguousarray(sample)).to(dev)
    dev_sample = l2_normalize(raw) if method == "cosine" else raw
    if init_cell_rows is None:
        init_cell_rows = draw_rows(s_rows, n_cells, torch.Generator().manual_seed(seed))
    init = dev_sample[torch.as_tensor(np.array(init_cell_rows), dtype=torch.int64).to(dev)]
    cells, _ = kmeans_fit(dev_sample, n_cells, "cosine" if method == "cosine" else "euclidean",
                          coarse_iters, init_centers=init)
    if method == "cosine":
        cells = l2_normalize(cells)   # probe ranking then matches the assignment geometry
    res = raw - cells[_assign_cells(cells, raw, method)]
    del raw, dev_sample
    if init_code_rows is None:
        init_code_rows = code_rows(m, s_rows, n_codes, seed + 1)
    codebooks = fit_subspaces(res.reshape(-1, m, ds).permute(1, 0, 2), n_codes, pq_iters,
                              init_code_rows)
    del res
    labels = np.empty(n, np.int32)
    all_codes = np.empty((n, m), np.uint8)
    rsq = np.empty(n, np.float32)
    rot_dev = None if rotation is None else torch.from_numpy(rotation).to(dev)
    for i0, chunk in stream_rows(db, encode_block, dev):
        lab, cod, r2 = _encode_block(cells, codebooks,
                                     chunk if rot_dev is None else chunk @ rot_dev, method=method)
        sl = slice(i0, i0 + lab.shape[0])
        labels[sl], all_codes[sl], rsq[sl] = lab.cpu().numpy(), cod.cpu().numpy(), r2.cpu().numpy()
    cap = max(1, int(np.ceil(n / n_cells * bucket_factor)))
    b_codes = np.zeros((n_cells, cap, m), np.uint8)
    ids = np.full((n_cells, cap), -1, np.int32)
    b_rsq = np.zeros((n_cells, cap), np.float32)
    cell, slot, rows, over = bucket_rows(labels, n_cells, cap)
    b_codes[cell, slot] = all_codes[rows]
    ids[cell, slot] = rows
    b_rsq[cell, slot] = rsq[rows]
    over = over.astype(np.int32)
    host = dict(cells=cells.cpu().numpy(), codebooks=codebooks.cpu().numpy(), codes=b_codes,
                bucket_ids=ids, recon_sq=b_rsq,
                overflow_codes=all_codes[over] if over.size else np.zeros((0, m), np.uint8),
                overflow_cell=labels[over].astype(np.int32), overflow_ids=over,
                overflow_recon_sq=rsq[over])
    stores = host if as_numpy else {k_: torch.from_numpy(v).to(dev) for k_, v in host.items()}
    rot = rotation if as_numpy or rotation is None else rot_dev
    return IVFPQIndex(**stores, n_rows=n, method=method, rotation=rot)


def save_ivf_pq(index: IVFPQIndex, path: str) -> None:
    extra = {} if index.rotation is None else {"rotation": to_numpy(index.rotation)}
    np.savez_compressed(_npz_path(path), **{name: to_numpy(getattr(index, name))
                                            for name in _STORES},
                        n_rows=np.asarray(index.n_rows), method=np.asarray(index.method), **extra)


def load_ivf_pq(path: str, device: Union[None, str, torch.device] = None) -> IVFPQIndex:
    """An index saved by either package, on ``device`` (None: the card)."""
    dev = resolve_device(device)
    z = np.load(_npz_path(path), allow_pickle=False)
    return IVFPQIndex(**{name: torch.from_numpy(z[name]).to(dev) for name in _STORES},
                      n_rows=int(z["n_rows"]), method=str(z["method"]),
                      rotation=torch.from_numpy(z["rotation"]).to(dev)
                      if "rotation" in z.files else None)
