"""Product quantization (PQ) compressed search (counterpart of
``anyloc_tpu/ops/pq.py``, the FAISS ``IndexPQ`` counterpart).

D splits into M subspaces of ds = D / M; each is k-means'd to C <= 256
codewords, and a row is stored as M uint8 codes. Queries score codes by
asymmetric distance (ADC), in one of two forms (``search(scan=...)``):

  * "tables": per-query tables t[m, c] = <q_m, cb[m, c]> (l2: 2t - |cb|^2);
    a row's score is the sum of the M entries its codes select;
  * "decode": the codes rebuild the chunk's rows x̂ (query-independent) and
    x̂ dots the queries (l2: 2 q·x̂ - |x̂|^2); cheaper once the query block
    passes ds.

The JAX package expands the codes into a one-hot and multiplies (the MXU
dislikes gathers); on the card a gather of the tables (or of the
codewords) is the natural form, and it computes the same sums: a one-hot
row selects exactly the entries the gather reads. The gathered block is
chunked so that it stays near ``_GATHER_BYTES``. ``score_dtype="bfloat16"``
takes bf16 tables / codewords and queries with f32 sums; on the CPU the
same values are rounded to bf16 and multiplied in f32, as the JAX package
emulates it off the TPU. Chunks merge through a running top-k (ties to the
lower id). Indexes are ``.npz`` files with the JAX package's keys.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from anyloc_tpu_torch.ops.common import bf16_dot, resolve_device
from anyloc_tpu_torch.ops.ivf import _npz_path, as_device_tensor, index_device, to_numpy
from anyloc_tpu_torch.ops.kmeans import draw_rows, kmeans_fit
from anyloc_tpu_torch.ops.retrieval import _topk_stable, stream_rows

# the largest gathered block a scan materializes at once
_GATHER_BYTES = 256 << 20


@dataclasses.dataclass
class PQIndex:
    """Fitted PQ index: codebooks and uint8 codes only (the rows are not
    kept), on the device it was fitted or loaded on, or numpy."""

    codebooks: torch.Tensor   # [M, C, ds] f32 per-subspace codewords
    codes: torch.Tensor       # [N, M] uint8
    # "cosine" scores the raw <q, x̂>; "l2" scores -|q - x̂|^2 + |q|^2
    # (the same ranking, shifted by a per-query constant)
    method: str = "l2"
    rotation: Optional[torch.Tensor] = None   # OPQ [D, D]: codes live in x @ R

    @property
    def n_rows(self) -> int:
        return self.codes.shape[0]

    @property
    def m(self) -> int:
        return self.codebooks.shape[0]

    @property
    def n_codes(self) -> int:
        return self.codebooks.shape[1]

    @property
    def dim(self) -> int:
        return self.codebooks.shape[0] * self.codebooks.shape[2]

    def search(self, qu, k: int, query_block: int = 256, db_block: int = 8192,
               score_dtype: str = "float32", scan: str = "auto"):
        """ADC top-k: qu [Q, D] -> (scores [Q, k], indices [Q, k] int64),
        higher is better. ``scan`` "auto" decodes once the query block
        exceeds ds."""
        dev = index_device(self.codebooks)
        qu = as_device_tensor(qu, dev).float()
        n, d = self.n_rows, self.dim
        if qu.dim() != 2 or qu.shape[1] != d:
            raise ValueError(f"queries must be [Q, {d}], got {tuple(qu.shape)}")
        if score_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"Unknown score_dtype: {score_dtype}")
        if self.rotation is not None:
            qu = qu @ as_device_tensor(self.rotation, dev)   # into the OPQ-rotated code space
        k = max(1, min(k, n))
        if qu.shape[0] == 0:
            return (torch.zeros((0, k), dtype=torch.float32, device=dev),
                    torch.zeros((0, k), dtype=torch.int64, device=dev))
        nb = int(min(db_block, max(1, n)))
        qb = int(min(query_block, qu.shape[0]))
        if scan == "auto":
            scan = "decode" if qb > d // self.m else "tables"
        if scan not in ("tables", "decode"):
            raise ValueError(f"Unknown scan: {scan!r}")
        cb = as_device_tensor(self.codebooks, dev)
        codes = as_device_tensor(self.codes, dev)
        outs = [_pq_search_block(cb, codes, qu[q0:q0 + qb], k=k, nb=nb, method=self.method,
                                 score_dtype=score_dtype, scan=scan)
                for q0 in range(0, qu.shape[0], qb)]
        return torch.cat([s for s, _ in outs]), torch.cat([i for _, i in outs])

    def decode(self, rows: Optional[np.ndarray] = None) -> np.ndarray:
        """The reconstructions x̂ [*, D] PQ scores against (all rows by
        default), in the original space."""
        codes = to_numpy(self.codes)
        if rows is not None:
            codes = codes[np.asarray(rows)]
        cb = to_numpy(self.codebooks)
        out = cb[np.arange(self.m)[None, :], codes.astype(np.int64)].reshape(codes.shape[0], -1)
        if self.rotation is not None:
            out = out @ to_numpy(self.rotation).T
        return out


def _code_offsets(m: int, c: int, device) -> torch.Tensor:
    return torch.arange(m, device=device) * c


def adc_sums(tables: torch.Tensor, flat_codes: torch.Tensor, m: int) -> torch.Tensor:
    """sum_m tables[q, flat_codes[.., m]] in f32: tables [qb, M·C] (f32 or
    bf16), flat_codes [R, M] or [qb, R, M] int64 indices into M·C ->
    [qb, R]. The ADC sum, what a one-hot row times the tables computes."""
    qb = tables.shape[0]
    if flat_codes.dim() == 2:
        g = tables[:, flat_codes.reshape(-1)]
    else:
        g = torch.gather(tables, 1, flat_codes.reshape(qb, -1))
    return g.reshape(qb, -1, m).sum(-1, dtype=torch.float32)


def _pq_search_block(codebooks, codes, qu, *, k: int, nb: int, method: str, score_dtype: str,
                     scan: str, n_valid: Optional[int] = None):
    """``n_valid`` (the sharded hook, ``parallel/distributed.py::
    pq_search_sharded``): rows at or past it are the padding of a sharded
    code matrix and score -inf before the running top-k. A zero code
    decodes to codeword 0's reconstruction, a real vector that could
    otherwise evict a true top-k row from the shard's partial."""
    m, c, ds = codebooks.shape
    n, qb, dev = codes.shape[0], qu.shape[0], qu.device
    if method not in ("l2", "cosine"):
        raise ValueError(f"Unknown method: {method}")
    bf16 = score_dtype == "bfloat16"
    offs = _code_offsets(m, c, dev)
    if scan == "tables":
        t = torch.einsum("qmd,mcd->qmc", qu.reshape(qb, m, ds), codebooks)
        if method == "l2":
            t = 2.0 * t - (codebooks * codebooks).sum(-1)[None]
        tables = t.reshape(qb, m * c).to(torch.bfloat16 if bf16 else torch.float32)
        # one gathered block [qb, rows, M] stays near _GATHER_BYTES
        nb = max(1, min(nb, _GATHER_BYTES // (qb * m * tables.element_size())))
    else:
        cb = codebooks.to(torch.bfloat16).float() if bf16 else codebooks
        quT = qu.T.contiguous()
    best_s = torch.full((qb, k), float("-inf"), device=dev)
    best_i = torch.zeros((qb, k), dtype=torch.int64, device=dev)
    for start in range(0, n, nb):
        cc = codes[start:start + nb].long()
        if scan == "tables":
            s = adc_sums(tables, cc + offs, m)                        # [qb, rows]
        else:
            xhat = cb[torch.arange(m, device=dev)[None, :], cc].reshape(cc.shape[0], m * ds)
            s = bf16_dot(xhat, quT) if bf16 else xhat @ quT          # [rows, qb]
            if method == "l2":
                # disjoint subspaces: |x̂|^2 is the codeword norms' sum
                s = 2.0 * s - (xhat * xhat).sum(-1)[:, None]
            s = s.T
        ids = torch.arange(start, start + cc.shape[0], device=dev)
        if n_valid is not None:
            s = torch.where(ids[None] < n_valid, s, float("-inf"))
        best_s, sel = _topk_stable(torch.cat([best_s, s], dim=1), k)
        best_i = torch.gather(torch.cat([best_i, ids[None].expand(qb, -1)], dim=1), 1, sel)
    return best_s, best_i


def _pq_assign(codebooks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Nearest codeword per subspace: x [B, D] -> codes [B, M] uint8."""
    mm, _, ds = codebooks.shape
    xc = torch.einsum("bmd,mcd->bmc", x.reshape(x.shape[0], mm, ds), codebooks)
    c2 = (codebooks * codebooks).sum(-1)
    return torch.argmax(2.0 * xc - c2[None], dim=-1).to(torch.uint8)


def pq_encode(codebooks, x) -> torch.Tensor:
    """Public encoder (adding rows): [B, D] -> [B, M] uint8, on the
    codebooks' device."""
    dev = index_device(codebooks)
    return _pq_assign(as_device_tensor(codebooks, dev), as_device_tensor(x, dev).float())


def code_rows(m: int, s: int, n_codes: int, seed: int) -> np.ndarray:
    """Default k-means starts of M subspace fits: [M, n_codes] rows of the
    S training rows, one ``torch.Generator`` seeded with ``seed`` drawing
    subspace after subspace (F2: the JAX package draws with
    ``jax.random``, which torch cannot reproduce)."""
    gen = torch.Generator().manual_seed(seed)
    return np.stack([draw_rows(s, n_codes, gen) for _ in range(m)])


def fit_subspaces(sub: torch.Tensor, n_codes: int, iters: int, init_rows) -> torch.Tensor:
    """Euclidean k-means of each subspace: sub [M, S, ds] -> codebooks
    [M, C, ds], subspace j starting from its rows ``init_rows[j]``."""
    rows = torch.as_tensor(np.array(init_rows), dtype=torch.int64).to(sub.device)
    return torch.stack([
        kmeans_fit(sub[j], n_codes, "euclidean", iters, init_centers=sub[j][rows[j]])[0]
        for j in range(sub.shape[0])])


def _sample(db, train_rows: int, seed: int) -> np.ndarray:
    """At most ``train_rows`` rows, drawn as the JAX package draws them."""
    n = db.shape[0]
    if n > train_rows:
        rng = np.random.default_rng(seed)
        return np.asarray(db[np.sort(rng.choice(n, train_rows, replace=False))], np.float32)
    return np.asarray(db, np.float32)


def opq_train(
    sample: np.ndarray,
    m: int,
    *,
    n_codes: int = 256,
    opq_iters: int = 10,
    inner_iters: int = 6,
    seed: int = 0,
    init_rows=None,
    device: Union[None, str, torch.device] = None,
) -> np.ndarray:
    """An orthogonal OPQ rotation R [D, D] (numpy) that lowers the PQ
    reconstruction error of ``sample`` @ R (Ge et al. 2013, alg. 2; FAISS
    ``OPQMatrix``). Starts from the QR of a Gaussian drawn with
    ``np.random.default_rng(seed)`` as the JAX package does; each
    alternation fits the codebooks (``inner_iters`` Lloyd steps from the
    rows ``init_rows`` [M, C], default ``code_rows(m, S, n_codes, seed)``),
    encodes, and takes the Procrustes update R = U Vᵀ from the SVD of
    Xᵀ X̂ on the host. The products run on ``device`` (None: the card)."""
    dev = resolve_device(device)
    n, d = sample.shape
    ds = d // m
    rng = np.random.default_rng(seed)
    q_mat, r_mat = np.linalg.qr(rng.standard_normal((d, d)).astype(np.float64))
    rot = (q_mat * np.sign(np.diag(r_mat))[None]).astype(np.float32)
    if init_rows is None:
        init_rows = code_rows(m, n, n_codes, seed)
    x = torch.from_numpy(np.asarray(sample, np.float32)).to(dev)
    for _ in range(opq_iters):
        xr = x @ torch.from_numpy(rot).to(dev)
        codebooks = fit_subspaces(xr.reshape(n, m, ds).permute(1, 0, 2), n_codes, inner_iters,
                                  init_rows)
        cod = _pq_assign(codebooks, xr).long()
        xhat = codebooks[torch.arange(m, device=dev)[None, :], cod].reshape(n, d)
        gram = x.T @ xhat
        u, _, vt = np.linalg.svd(gram.cpu().numpy().astype(np.float64), full_matrices=False)
        rot = (u @ vt).astype(np.float32)
    return rot


def pq_fit(
    db,
    m: int,
    *,
    n_codes: int = 256,
    method: str = "l2",
    max_iters: int = 25,
    seed: int = 0,
    train_rows: int = 1 << 18,
    encode_block: int = 1 << 16,
    opq_iters: int = 0,
    as_numpy: bool = False,
    init_rows=None,
    device: Union[None, str, torch.device] = None,
) -> PQIndex:
    """Train per-subspace codebooks and encode ``db`` [N, D] (numpy or
    memmap; D divisible by ``m``) on ``device`` (None: the card).

    The codebooks train on a uniform sample of at most ``train_rows`` rows
    (``np.random.default_rng(seed)``, as the JAX package draws it), each
    subspace from the sample rows ``init_rows[j]`` (default
    ``code_rows(m, S, n_codes, seed)``; F2). The database then streams
    through the device ``encode_block`` rows at a time; the index keeps
    only codebooks and codes. ``opq_iters > 0`` first learns an OPQ
    rotation on the sample (with the same start rows). ``as_numpy`` keeps
    the results on the host."""
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
    ds = d // m
    sample = _sample(db, train_rows, seed)
    if init_rows is None:
        init_rows = code_rows(m, sample.shape[0], n_codes, seed)
    rotation = None
    if opq_iters:
        rotation = opq_train(sample, m, n_codes=n_codes, opq_iters=opq_iters, seed=seed,
                             init_rows=init_rows, device=dev)
        sample = sample @ rotation
    sub = torch.from_numpy(np.ascontiguousarray(sample)).to(dev).reshape(-1, m, ds).permute(1, 0, 2)
    codebooks = fit_subspaces(sub, n_codes, max_iters, init_rows)
    del sub
    rot_dev = None if rotation is None else torch.from_numpy(rotation).to(dev)
    codes = np.empty((n, m), np.uint8)
    for i0, chunk in stream_rows(db, encode_block, dev):
        cod = _pq_assign(codebooks, chunk if rot_dev is None else chunk @ rot_dev)
        codes[i0:i0 + cod.shape[0]] = cod.cpu().numpy()
    if as_numpy:
        return PQIndex(codebooks=codebooks.cpu().numpy(), codes=codes, method=method,
                       rotation=rotation)
    return PQIndex(codebooks=codebooks, codes=torch.from_numpy(codes).to(dev), method=method,
                   rotation=rot_dev)


def save_pq(index: PQIndex, path: str) -> None:
    extra = {} if index.rotation is None else {"rotation": to_numpy(index.rotation)}
    np.savez_compressed(_npz_path(path), codebooks=to_numpy(index.codebooks),
                        codes=to_numpy(index.codes), method=np.asarray(index.method), **extra)


def load_pq(path: str, device: Union[None, str, torch.device] = None) -> PQIndex:
    """An index saved by either package, on ``device`` (None: the card)."""
    dev = resolve_device(device)
    z = np.load(_npz_path(path), allow_pickle=False)
    return PQIndex(codebooks=torch.from_numpy(z["codebooks"]).to(dev),
                   codes=torch.from_numpy(z["codes"]).to(dev), method=str(z["method"]),
                   rotation=torch.from_numpy(z["rotation"]).to(dev)
                   if "rotation" in z.files else None)
