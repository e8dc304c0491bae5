"""The PQ / IVF / IVF-PQ regime grid on one card, in one process (port of
tools/bench_pq_matrix.py, which drives the root ``bench_retrieval.py``).

    python -m anyloc_tpu_torch.tools.bench_pq_matrix [TAG ...] [--out FILE]

Runs ``tools/bench_retrieval.py`` once per entry of ``RUNS`` (``BASE``
first, so that a run's own flags override it): 512-d rows at 250k, 1M and
4M, and 10M rows for the compressed engines; the exact, ivf, pq and
ivf_pq engines; query batches 8 (serving) and 256 (bulk); the ADC scan
and score-type crossovers at 1M; the probe dial at 4M; recall against
exact search on the clustered and PCA-spectrum databases, with and without
OPQ. The grid is the JAX tool's, tags and all: its engine exclusions (no
ivf at 4M, only the compressed engines at 10M) were set for a 16 GB chip,
and are kept. Positional tags select runs. Each run prints a ``{"run":
tag, "argv": ...}`` line, bench_retrieval's lines, then ``{"run": tag,
"wall_s": ...}``; every line is flushed, and appended to ``--out`` as soon
as it is measured, so a run cut short keeps what it did. It needs a card
and raises without one.
"""

from __future__ import annotations

import argparse
import json
import time

BASE = ["--dim", "512", "--n-qu", "256", "--k", "20", "--pq-m", "64"]

RUNS = [
    # bulk regime (qb 256): exact vs pruned vs compressed across scale
    ("250k_qb256", ["--n-db", "250000", "--query-batch", "256",
                    "--engines", "device", "ivf", "pq", "ivf_pq",
                    "--n-probe", "16"]),
    ("1M_qb256", ["--n-db", "1000000", "--query-batch", "256",
                  "--engines", "device", "ivf", "pq", "ivf_pq",
                  "--n-probe", "16"]),
    ("4M_qb256", ["--n-db", "4000000", "--query-batch", "256",
                  "--engines", "device", "pq", "ivf_pq",
                  "--n-probe", "16"]),  # ivf-flat buckets: 16 GB, a 16 GB chip's memory
    # serving regime (qb 8): where pruning beats the shared scan
    ("250k_qb8", ["--n-db", "250000", "--query-batch", "8",
                  "--engines", "device", "ivf", "pq", "ivf_pq",
                  "--n-probe", "16"]),
    ("1M_qb8", ["--n-db", "1000000", "--query-batch", "8",
                "--engines", "device", "ivf", "pq", "ivf_pq",
                "--n-probe", "16"]),
    ("4M_qb8", ["--n-db", "4000000", "--query-batch", "8",
                "--engines", "device", "pq", "ivf_pq",
                "--n-probe", "16"]),
    # ADC formulation + dtype crossovers at 1M
    ("1M_pq_tables_f32", ["--n-db", "1000000", "--query-batch", "256",
                          "--engines", "pq", "--pq-scan", "tables",
                          "--pq-score-dtype", "float32"]),
    ("1M_pq_tables_bf16", ["--n-db", "1000000", "--query-batch", "256",
                           "--engines", "pq", "--pq-scan", "tables",
                           "--pq-score-dtype", "bfloat16"]),
    ("1M_pq_decode_f32", ["--n-db", "1000000", "--query-batch", "256",
                          "--engines", "pq", "--pq-scan", "decode",
                          "--pq-score-dtype", "float32"]),
    ("1M_ivfpq_f32", ["--n-db", "1000000", "--query-batch", "8",
                      "--engines", "ivf_pq", "--n-probe", "16",
                      "--pq-score-dtype", "float32"]),
    # probe dial at 4M (recall/qps trade)
    ("4M_ivfpq_p8", ["--n-db", "4000000", "--query-batch", "8",
                     "--engines", "ivf_pq", "--n-probe", "8"]),
    ("4M_ivfpq_p32", ["--n-db", "4000000", "--query-batch", "8",
                      "--engines", "ivf_pq", "--n-probe", "32"]),
    # clustered-db recall (the honest case for the pruned and compressed
    # engines: perturbed queries, graded against exact search)
    ("250k_clustered_recall",
     ["--n-db", "250000", "--query-batch", "256",
      "--engines", "device", "ivf", "pq", "ivf_pq", "--n-probe", "16",
      "--db-dist", "clustered", "--query-noise", "0.05",
      "--recall-vs-exact"]),
    # the bytes/row dial on the clustered hard case: 128 B/row (4 dims per
    # subspace) against the 64 B/row of the rest of the grid
    ("250k_clustered_recall_m128",
     ["--n-db", "250000", "--query-batch", "256",
      "--engines", "pq", "ivf_pq", "--n-probe", "16",
      "--db-dist", "clustered", "--query-noise", "0.05",
      "--recall-vs-exact", "--pq-m", "128"]),
    # OPQ rotation on the PCA-spectrum geometry, the same budget
    ("250k_pca_recall",
     ["--n-db", "250000", "--query-batch", "256",
      "--engines", "pq", "ivf_pq", "--n-probe", "16",
      "--db-dist", "pca_spectrum", "--query-noise", "0.05",
      "--recall-vs-exact"]),
    ("250k_pca_recall_opq",
     ["--n-db", "250000", "--query-batch", "256",
      "--engines", "pq", "ivf_pq", "--n-probe", "16",
      "--db-dist", "pca_spectrum", "--query-noise", "0.05",
      "--recall-vs-exact", "--opq-iters", "10"]),
    # 10M x 512 f32 = 20.5 GB, past a 16 GB chip: the compressed engines only
    ("10M_qb8", ["--n-db", "10000000", "--query-batch", "8",
                 "--engines", "pq", "ivf_pq", "--n-probe", "16"]),
    ("10M_qb256", ["--n-db", "10000000", "--query-batch", "256",
                   "--engines", "pq", "ivf_pq", "--n-probe", "16"]),
]


def run(tag: str, argv, out=None) -> list:
    """One grid point: bench_retrieval over ``argv``; every line printed
    and appended to ``out`` (a path) as it comes. Returns the lines."""
    from anyloc_tpu_torch.tools import bench_retrieval

    lines = []

    def emit(text: str) -> None:
        lines.append(text)
        print(text, flush=True)
        if out is not None:
            with open(out, "a") as f:
                f.write(text + "\n")

    emit(json.dumps({"run": tag, "argv": argv}))
    a = bench_retrieval.parser().parse_args(argv)
    t0 = time.perf_counter()
    bench_retrieval.run(a.n_db, a.n_qu, a.dim, a.k, a.engines, a.n_cells, a.n_probe,
                        a.stream_dtype, a.pq_m, a.pq_db_block, a.pq_score_dtype, a.pq_scan,
                        a.query_batch, a.db_dist, a.opq_iters, a.query_noise, a.seed,
                        a.recall_vs_exact, emit=emit)
    emit(json.dumps({"run": tag, "wall_s": round(time.perf_counter() - t0, 1)}))
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("tags", nargs="*", help="runs to make (default: every run of RUNS)")
    p.add_argument("--out", default=None, help="append every line to this file as it comes")
    a = p.parse_args(argv)
    unknown = set(a.tags) - {tag for tag, _ in RUNS}
    if unknown:
        raise ValueError(f"unknown runs {sorted(unknown)}")
    from anyloc_tpu_torch.tools._timing import require_card

    require_card("bench_pq_matrix")
    for tag, run_argv in RUNS:
        if not a.tags or tag in a.tags:
            run(tag, BASE + run_argv, a.out)   # BASE first: per-run flags override it
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
