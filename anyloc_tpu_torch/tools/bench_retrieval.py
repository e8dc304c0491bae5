"""Retrieval engines on one synthetic database: queries/s, recall against
exact search and the index's bytes, one JSON line per engine (the
counterpart of the root ``bench_retrieval.py``, which imports JAX).

    python -m anyloc_tpu_torch.tools.bench_retrieval [--n-db N] [--dim D]
        [--engines device blocked native ivf pq ivf_pq] [--db-dist clustered] ...

Engines: "device" (the database on the card, one product), "blocked" (it
streams from the host, ``--stream-dtype``), "native" (the host C++
library), "ivf", "pq" and "ivf_pq" (fitted here; ``--n-cells``,
``--n-probe``, ``--pq-m``, ``--opq-iters``). The database is drawn on the
card from ``--seed`` with the root script's distributions: "uniform",
"clustered" (a Gaussian mixture of 256 components with Zipf sizes, sigma
0.35 around means of 2.0) and "pca_spectrum" (independent dims with
variance (i+1)^-0.5, what PCA output looks like); rows are unit vectors,
and the queries are database rows plus ``--query-noise``. Device engines
are timed with CUDA events (best of 3 after a warm-up), "native" with the
host clock; every line names the card and its power limit. Recall is the
mean top-k overlap with exact search over up to 256 queries, in every
line; ``--recall-vs-exact`` also prints the root script's recall line for
the ivf, pq and ivf_pq engines (that overlap and the top-1 agreement). It
needs a card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

ENGINES = ("device", "blocked", "native", "ivf", "pq", "ivf_pq")


def make_db(n_db: int, dim: int, dist: str = "uniform", seed: int = 0,
            device=None) -> torch.Tensor:
    """[n_db, dim] unit rows drawn on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    if dist == "clustered":
        n_comp = 256
        w = 1.0 / torch.arange(1, n_comp + 1, dtype=torch.float64) ** 0.8
        comp = torch.multinomial(w.to(device), n_db, replacement=True, generator=gen)
        db = 2.0 * normal(n_comp, dim)[comp]
        db += 0.35 * normal(n_db, dim)
    elif dist == "pca_spectrum":
        lam = (1.0 + torch.arange(dim, dtype=torch.float32, device=device)) ** -0.5
        db = normal(n_db, dim) * lam[None]
    elif dist == "uniform":
        db = normal(n_db, dim)
    else:
        raise ValueError(f"Unknown db_dist: {dist}")
    return db / torch.linalg.vector_norm(db, dim=1, keepdim=True)


def index_bytes(index) -> int:
    """Bytes of an index's stores (tensors and arrays)."""
    import dataclasses

    total = 0
    for f in dataclasses.fields(index):
        v = getattr(index, f.name)
        if isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
        elif isinstance(v, np.ndarray):
            total += v.nbytes
    return total


def overlap(ids: np.ndarray, exact: np.ndarray) -> float:
    """Mean top-k overlap of ``ids`` with ``exact`` over exact's rows."""
    n, k = exact.shape
    return float(np.mean([len(set(ids[q].tolist()) & set(exact[q].tolist())) / k
                          for q in range(n)]))


def run(n_db: int = 100_000, n_qu: int = 1_000, dim: int = 4096, k: int = 20,
        engines: Sequence[str] = ("device", "blocked"), n_cells: Optional[int] = None,
        n_probe: int = 16, stream_dtype: str = "float32", pq_m: int = 64,
        pq_db_block: int = 8192, pq_score_dtype: str = "bfloat16", pq_scan: str = "auto",
        query_batch: Optional[int] = None, db_dist: str = "uniform", opq_iters: int = 0,
        query_noise: float = 0.0, seed: int = 0, recall_vs_exact: bool = False,
        emit=print) -> Dict[str, dict]:
    """Fit and time each engine; ``emit`` gets one JSON line per engine
    (and with ``recall_vs_exact`` the root script's recall line after each
    ivf / pq / ivf_pq line). Returns {engine tag: its line}."""
    from anyloc_tpu_torch import native
    from anyloc_tpu_torch.ops import ivf, ivf_pq, pq
    from anyloc_tpu_torch.ops.retrieval import top_k_search, top_k_search_blocked
    from anyloc_tpu_torch.tools._timing import card_line, time_ms

    if not torch.cuda.is_available():
        raise RuntimeError("bench_retrieval needs a CUDA card")
    unknown = set(engines) - set(ENGINES)
    if unknown:
        raise ValueError(f"unknown engines {sorted(unknown)} (have {ENGINES})")
    card = card_line()
    dev = torch.device("cuda")
    db_dev = make_db(n_db, dim, db_dist, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    rows = torch.randperm(n_db, generator=gen, device=dev)[:n_qu]
    qu_dev = db_dev[rows]
    if query_noise:
        qu_dev = qu_dev + query_noise * torch.randn(qu_dev.shape, generator=gen, device=dev)
    db, qu = db_dev.cpu().numpy(), qu_dev.cpu().numpy()
    qbatch = query_batch or min(256, n_qu)
    n_chk = min(256, n_qu)
    exact = top_k_search_blocked(db, qu[:n_chk], k, db_block=65536, device=dev)[1]
    results = {}

    def line(tag, qps, ids, nbytes, fit_s=None, recall_tag=None, **extra):
        ov = overlap(ids[:n_chk], exact)
        out = dict(engine=tag, qps=qps, recall_vs_exact=ov,
                   index_bytes=int(nbytes), fit_s=fit_s, n_db=n_db, dim=dim, k=k,
                   n_qu=n_qu, query_batch=qbatch, db_dist=db_dist, card=card, **extra)
        results[tag] = out
        emit(json.dumps(out))
        if recall_vs_exact and recall_tag is not None:
            top1 = float(np.mean(np.asarray(ids)[:n_chk, 0] == np.asarray(exact)[:, 0]))
            emit(json.dumps({
                "metric": f"{recall_tag}_recall_at_{k}_vs_exact", "value": round(ov, 4),
                "unit": f"mean top-{k} overlap with the exact engine over {n_chk} queries "
                        f"(top-1 agreement: {top1:.4f}; db {db_dist}, query noise "
                        f"{query_noise})", "vs_baseline": None}))

    def timed(search):
        ms = time_ms(search, iters=1, reps=3, warmup=1)
        return n_qu / (ms * 1e-3)

    def fit_timed(fit):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = fit()
        torch.cuda.synchronize()
        return index, time.perf_counter() - t0

    if "device" in engines:
        def search():
            return [top_k_search(db_dev, qu_dev[q0:q0 + qbatch], k)
                    for q0 in range(0, n_qu, qbatch)]
        qps = timed(search)
        ids = torch.cat([i for _, i in search()]).cpu().numpy()
        line("device", qps, ids, db_dev.numel() * 4)
    if "blocked" in engines:
        def search():
            return top_k_search_blocked(db, qu, k, query_block=qbatch, db_block=65536,
                                        stream_dtype=stream_dtype, device=dev)
        qps = timed(search)
        line(f"blocked_{stream_dtype}", qps, search()[1], 0)
    if "native" in engines:
        t0 = time.perf_counter()
        _, ids = native.nn_search(db, qu, k)
        line("native", n_qu / (time.perf_counter() - t0), ids, 0)
    if "ivf" in engines:
        index, fit_s = fit_timed(lambda: ivf.ivf_fit(db, n_cells, device=dev))
        qps = timed(lambda: index.search(qu, k, n_probe=n_probe, query_block=qbatch))
        line(f"ivf_p{n_probe}", qps, index.search(qu, k, n_probe=n_probe)[1].cpu().numpy(),
             index_bytes(index), fit_s, recall_tag=f"ivf_p{n_probe}")
    opq = f"_opq{opq_iters}" if opq_iters else ""
    if "pq" in engines:
        index, fit_s = fit_timed(lambda: pq.pq_fit(db, pq_m, method="cosine",
                                                   opq_iters=opq_iters, device=dev))

        def search():
            return index.search(qu, k, query_block=qbatch, db_block=pq_db_block,
                                score_dtype=pq_score_dtype, scan=pq_scan)
        qps = timed(search)
        line(f"pq{pq_m}{opq}_{pq_scan}", qps, search()[1].cpu().numpy(), index_bytes(index),
             fit_s, recall_tag=f"pq{pq_m}{opq}", score_dtype=pq_score_dtype)
    if "ivf_pq" in engines:
        index, fit_s = fit_timed(lambda: ivf_pq.ivf_pq_fit(db, n_cells, m=pq_m, method="cosine",
                                                           opq_iters=opq_iters, device=dev))

        def search():
            return index.search(qu, k, n_probe=n_probe, query_block=min(16, qbatch),
                                score_dtype=pq_score_dtype)
        qps = timed(search)
        line(f"ivf_pq{pq_m}{opq}_p{n_probe}", qps, search()[1].cpu().numpy(),
             index_bytes(index), fit_s, recall_tag=f"ivf_pq{pq_m}{opq}_p{n_probe}",
             score_dtype=pq_score_dtype)
    return results


def parser() -> argparse.ArgumentParser:
    """The root script's flags (and ``--seed``)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n-db", type=int, default=100_000)
    p.add_argument("--n-qu", type=int, default=1_000)
    p.add_argument("--dim", type=int, default=4096)
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--engines", nargs="*", default=["device", "blocked"], choices=ENGINES)
    p.add_argument("--n-cells", type=int, default=None)
    p.add_argument("--n-probe", type=int, default=16)
    p.add_argument("--stream-dtype", default="float32", choices=["float32", "bfloat16", "int8"])
    p.add_argument("--pq-m", type=int, default=64)
    p.add_argument("--pq-db-block", type=int, default=8192)
    p.add_argument("--pq-score-dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--pq-scan", default="auto", choices=["auto", "tables", "decode"])
    p.add_argument("--query-batch", type=int, default=None)
    p.add_argument("--db-dist", default="uniform",
                   choices=["uniform", "clustered", "pca_spectrum"])
    p.add_argument("--opq-iters", type=int, default=0)
    p.add_argument("--query-noise", type=float, default=0.0)
    p.add_argument("--recall-vs-exact", action="store_true",
                   help="also print the root script's recall line (mean top-k overlap with "
                        "exact search and top-1 agreement) for ivf / pq / ivf_pq")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None) -> None:
    a = parser().parse_args(argv)
    run(a.n_db, a.n_qu, a.dim, a.k, a.engines, a.n_cells, a.n_probe, a.stream_dtype, a.pq_m,
        a.pq_db_block, a.pq_score_dtype, a.pq_scan, a.query_batch, a.db_dist, a.opq_iters,
        a.query_noise, a.seed, a.recall_vs_exact)


if __name__ == "__main__":
    main()
