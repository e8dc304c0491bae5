"""IVF against exact retrieval on one card: queries/s, recall and the
n_probe sweep (port of tools/bench_ivf.py).

    python -m anyloc_tpu_torch.tools.bench_ivf --n-db 1000000 --dim 512 --sweep
    python -m anyloc_tpu_torch.tools.bench_ivf --n-db 1000000 --dim 512 --n-probe 16
    python -m anyloc_tpu_torch.tools.bench_ivf --qbatch-sweep

The database is clustered by default: a 256-component Gaussian mixture with
Zipf-sized components (``tools/bench_retrieval.py::make_db``, drawn on the
card from a seed), the skewed geometry of real VLAD / PCA descriptor sets,
where posting lists are imbalanced; ``--uniform`` draws unit Gaussian rows
instead (IVF's best case). Queries are every (n_db / n_queries)-th row plus
0.05 noise, renormalized. The index is ``ops/ivf.py``'s, fitted on the
card with ``--n-cells`` cells and bucket factor 2; exact search is
``ops/retrieval.py::top_k_search`` with the database on the card. Times
are CUDA-event means over ``--iters`` searches, best of 3
(``tools/_timing.py``); queries/s is the batch over that time. Recall@k is
the mean share of the exact top-k an ivf top-k keeps; R1 the share of
queries whose top-1 agrees. Every line names the card and its power
limit. It needs a card and raises without one.
"""

from __future__ import annotations

import argparse
import time

PROBES = (1, 2, 4, 8, 16, 32, 64)
QBATCHES = (1, 4, 16, 64, 256)


def parser() -> argparse.ArgumentParser:
    """The JAX tool's flags."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n-db", type=int, default=1_000_000)
    p.add_argument("--dim", type=int, default=512)
    p.add_argument("--n-queries", type=int, default=256)
    p.add_argument("--n-cells", type=int, default=1024)
    p.add_argument("--n-probe", type=int, default=16)
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--sweep", action="store_true",
                   help="sweep n_probe in {1,2,4,8,16,32,64}: recall + qps")
    p.add_argument("--qbatch-sweep", action="store_true",
                   help="sweep the query batch {1,4,16,64,256} at fixed --n-probe: exact vs "
                        "ivf qps per regime")
    p.add_argument("--uniform", action="store_true",
                   help="uniform random db instead of the clustered default")
    return p


def run(n_db: int = 1_000_000, dim: int = 512, n_queries: int = 256, n_cells: int = 1024,
        n_probe: int = 16, k: int = 20, iters: int = 20, sweep: bool = False,
        qbatch_sweep: bool = False, uniform: bool = False, seed: int = 0, emit=print) -> dict:
    """The JAX tool's measurements; ``emit`` gets each printed line.
    Returns {"card", "fit_s", "cap", "overflow", "exact_qps", "probes":
    {n_probe: {"qps", "r1", "recall"}}, "qbatch": {qb: {"exact", "ivf"}}}."""
    import numpy as np
    import torch

    from anyloc_tpu_torch.ops.ivf import ivf_fit
    from anyloc_tpu_torch.ops.retrieval import top_k_search
    from anyloc_tpu_torch.tools._timing import card_line, require_card, time_ms
    from anyloc_tpu_torch.tools.bench_retrieval import make_db

    dev = require_card("bench_ivf")
    card = card_line()
    db = make_db(n_db, dim, "uniform" if uniform else "clustered", seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    qu = db[:: max(1, n_db // n_queries)][:n_queries].clone()
    qu += 0.05 * torch.randn(qu.shape, generator=gen, device=dev)
    qu /= torch.linalg.vector_norm(qu, dim=-1, keepdim=True)
    out = {"card": card, "probes": {}, "qbatch": {}}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = ivf_fit(db.cpu().numpy(), n_cells, bucket_factor=2.0, seed=seed, device=dev)
    torch.cuda.synchronize()
    out.update(fit_s=time.perf_counter() - t0, cap=int(index.buckets.shape[1]),
               overflow=int(index.overflow.shape[0]))
    emit(f"[{card}] fit: {out['fit_s']:.1f}s (cap {out['cap']}, overflow {out['overflow']}, "
         f"{'uniform' if uniform else 'clustered'} db)")

    def qps(fn, q, reps_iters=iters):
        return q.shape[0] / (time_ms(lambda: fn(q), iters=reps_iters, reps=3) * 1e-3)

    def exact(q):
        return top_k_search(db, q, k)

    if qbatch_sweep:
        emit(f"{'q_batch':>8} {'exact qps':>10} {'ivf qps':>10} (n_probe={n_probe})")
        for qb in QBATCHES:
            if qb > n_queries:
                continue
            q = qu[:qb]
            e = qps(exact, q, max(iters, 256 // qb))
            v = qps(lambda x: index.search(x, k, n_probe=n_probe, query_block=qb), q,
                    max(iters, 256 // qb))
            out["qbatch"][qb] = {"exact": e, "ivf": v}
            emit(f"{qb:>8} {e:>10,.0f} {v:>10,.0f}")
        return out

    ie = exact(qu)[1].cpu().numpy()
    out["exact_qps"] = qps(exact, qu)
    emit(f"exact: {out['exact_qps']:,.0f} qps")
    emit(f"{'n_probe':>8} {'qps':>10} {'vs exact':>9} {'R1':>6} {'R@' + str(k):>7}")
    for p_ in (PROBES if sweep else (n_probe,)):
        if p_ > n_cells:
            continue
        q_rate = qps(lambda x, p_=p_: index.search(x, k, n_probe=p_, query_block=n_queries), qu)
        ii = index.search(qu, k, n_probe=p_)[1].cpu().numpy()
        r1 = float((ii[:, 0] == ie[:, 0]).mean())
        rk = float(np.mean([len(set(ii[q].tolist()) & set(ie[q].tolist())) / k
                            for q in range(ii.shape[0])]))
        out["probes"][p_] = {"qps": q_rate, "r1": r1, "recall": rk}
        emit(f"{p_:>8} {q_rate:>10,.0f} {q_rate / out['exact_qps']:>8.1f}x {r1:>6.3f} "
             f"{rk:>7.3f}")
    return out


def main(argv=None) -> int:
    a = parser().parse_args(argv)
    run(a.n_db, a.dim, a.n_queries, a.n_cells, a.n_probe, a.k, a.iters, a.sweep, a.qbatch_sweep,
        a.uniform)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
