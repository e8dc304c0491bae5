"""The serving daemon under concurrent HTTP clients: coalesced batches
against batch 1 (port of tools/bench_serving.py).

    python -m anyloc_tpu_torch.tools.bench_serving --model dinov2_vits14 --layer 5
    python -m anyloc_tpu_torch.tools.bench_serving --model dinov2_vitg14 --layer 31 \\
        --img-size 224 --quant int8_full --requests 64 --clients 16

For each of ``--max-batch 1`` and ``--max-batch N`` a process of its own
runs the daemon (``pipelines/serve_http.py``, on the card) and
``--clients`` client processes of their own post the ``--requests``
JPEGs to ``/search?k=5``, each its share in turn, all started together
after one warm request: the load generator shares no process, and no GIL,
with the daemon. Printed per config: requests/s over the burst, the
clients' p50 / p99 latency, the mean realized batch and the daemon's
per-stage times (``/stats``); then the speedup. Every coalesced reply is
held to the batch-1 reply of the same image: the scores within
``SCORE_TOL`` and the ids equal at every rank whose batch-1 score lies
more than ``SCORE_TOL`` from its neighbours'; a reply that differs
raises. Weights are random (serving
math is weight-agnostic); the vocabulary (VLAD-32 fitted on random
descriptors), the database (``--db-rows`` random unit rows) and the
random-pixel JPEGs come from seed 0. Needs a card, and raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# a coalesced reply's scores against its batch-1 reply's: unit VLADs of
# 32·D against random unit rows score ~1e-2 with ~1e-3 between neighbouring
# ranks, and coalescing moves a score by ~1e-8 on the H100 (PERF.md), so a
# reply that went to another image's slot moves by far more than this
SCORE_TOL = 1e-5

# a client: stdlib only, started before the burst; it reads its images,
# says "ready", waits for "go" on stdin, posts them in turn and writes
# [reply, seconds] per request to its file
_CLIENT = r"""
import json, sys, time, urllib.request
port, work, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
idx = [int(i) for i in sys.argv[4].split(",") if i]
imgs = [open(f"{work}/img_{i:05d}.jpg", "rb").read() for i in idx]
print("ready", flush=True)
sys.stdin.readline()
res = []
for i, data in zip(idx, imgs):
    t0 = time.perf_counter()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/search?k=5", data=data,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        rep = json.loads(r.read())
    res.append([i, rep, time.perf_counter() - t0])
json.dump(res, open(out, "w"))
"""


def parser() -> argparse.ArgumentParser:
    """The JAX tool's flags (and, hidden, the per-config run's own)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="dinov2_vits14")
    p.add_argument("--layer", type=int, default=5)
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--quant", default=None)
    p.add_argument("--requests", type=int, default=64)
    p.add_argument("--clients", type=int, default=16)
    p.add_argument("--max-batch", type=int, default=16)
    p.add_argument("--db-rows", type=int, default=10000)
    p.add_argument("--transfer-dtype", default="uint8", choices=["float32", "uint8"])
    p.add_argument("--batch-window-ms", type=float, default=5.0,
                   help="coalescing window: how long the dispatcher waits to fill a batch")
    p.add_argument("--single", type=int, default=None,
                   help="internal: run ONE config (this max_batch) and print a JSON result line")
    p.add_argument("--work", default=None, help=argparse.SUPPRESS)
    p.add_argument("--device", default=None, help=argparse.SUPPRESS)
    return p


def synthesize(args, work: Path) -> None:
    """The vocabulary, the database and the JPEGs, from seed 0, in ``work``
    (on the host)."""
    import io

    import numpy as np
    from PIL import Image

    from anyloc_tpu_torch.models import registry
    from anyloc_tpu_torch.ops.vlad import VLAD

    dim = registry.get(args.model).config().embed_dim
    rng = np.random.default_rng(0)
    VLAD(32, cache_dir=str(work / "vocab")).fit(
        rng.standard_normal((2000, dim)).astype(np.float32))
    db = rng.standard_normal((args.db_rows, 32 * dim)).astype(np.float32)
    db /= np.linalg.norm(db, axis=-1, keepdims=True)
    np.save(work / "db.npy", db)
    del db
    for i in range(args.requests):
        buf = io.BytesIO()
        Image.fromarray((rng.random((args.img_size, args.img_size, 3)) * 255).astype(np.uint8)
                        ).save(buf, format="JPEG")
        (work / f"img_{i:05d}.jpg").write_bytes(buf.getvalue())


def serve_args(args, work: Path, max_batch: int) -> argparse.Namespace:
    return argparse.Namespace(
        model=args.model, layer=args.layer, facet="value", num_clusters=32,
        vocab_dir=str(work / "vocab"), checkpoint=None, quant=args.quant,
        max_img_size=args.img_size, img_size=args.img_size, max_batch=max_batch,
        batch_window_ms=args.batch_window_ms, db=str(work / "db.npy"), ivf=False, pq=False,
        pq_m=64, n_probe=8, mesh=0, host="127.0.0.1", port=0, warm=True,
        transfer_dtype=args.transfer_dtype)


def single(args) -> dict:
    """One config: the daemon in this process, the clients in theirs.
    Returns {"max_batch", "qps", "p50_ms", "p99_ms", "mean_batch",
    "batches", "stages", "replies": {image: reply}}."""
    import threading
    import urllib.request

    import numpy as np

    from anyloc_tpu_torch.pipelines import serve_http

    work = Path(args.work)
    server = serve_http.build_server(serve_args(args, work, args.single), device=args.device)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    clients = []
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{port}/search?k=5", method="POST",
                                     data=(work / "img_00000.jpg").read_bytes())
        urllib.request.urlopen(req, timeout=600).read()   # warm, outside the timed burst
        for c in range(args.clients):
            idx = ",".join(str(i) for i in range(c, args.requests, args.clients))
            clients.append(subprocess.Popen(
                [sys.executable, "-c", _CLIENT, str(port), str(work),
                 str(work / f"client{args.single}_{c}.json"), idx],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True))
        for proc in clients:
            if proc.stdout.readline().strip() != "ready":
                raise RuntimeError("a client process failed to start")
        t0 = time.perf_counter()
        for proc in clients:
            proc.stdin.write("go\n")
            proc.stdin.flush()
        for proc in clients:
            if proc.wait(timeout=3600) != 0:
                raise RuntimeError(f"a client process exited with {proc.returncode}")
        dt = time.perf_counter() - t0
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        for proc in clients:
            if proc.poll() is None:
                proc.kill()
        server.shutdown()
        server.server_close()
    replies, lat = {}, []
    for c in range(args.clients):
        for i, rep, sec in json.loads((work / f"client{args.single}_{c}.json").read_text()):
            replies[i] = rep
            lat.append(sec)
    if len(replies) != args.requests or any(len(r["ids"]) != 5 for r in replies.values()):
        raise RuntimeError("missing or short replies")
    return {"max_batch": args.single, "qps": args.requests / dt,
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3),
            "mean_batch": stats["mean_batch"], "batches": stats["batches"],
            "stages": stats.get("stages", {}), "replies": replies}


def compare(got: dict, want: dict, tol: float = SCORE_TOL) -> dict:
    """The coalesced replies ``got`` held to the batch-1 replies ``want``
    ({image: {"ids", "scores"}}): the largest score difference (sorted
    scores, rank by rank) and the ranks whose ids were compared; raises if
    a score moves by more than ``tol`` or an id differs at a rank whose
    batch-1 score lies more than ``tol`` from its neighbours'."""
    import numpy as np

    worst, compared, total = 0.0, 0, 0
    for i, w in want.items():
        g = got[i]
        ws, gs = np.asarray(w["scores"], np.float64), np.asarray(g["scores"], np.float64)
        worst = max(worst, float(np.abs(ws - gs).max()))
        gaps = np.abs(np.diff(ws))
        for j in range(len(ws)):
            total += 1
            left = gaps[j - 1] if j > 0 else np.inf
            right = gaps[j] if j < len(gaps) else np.inf
            if min(left, right) > tol:
                compared += 1
                if g["ids"][j] != w["ids"][j]:
                    raise RuntimeError(f"image {i}: coalesced ids {g['ids']} vs batch-1 "
                                       f"{w['ids']} (scores {g['scores']} vs {w['scores']})")
    if worst > tol:
        raise RuntimeError(f"a coalesced reply's scores move by {worst:.3e} > {tol} from "
                           "its batch-1 reply's")
    return {"max_score_diff": worst, "ids_compared": compared, "ranks": total}


def run(args, device=None, emit=print) -> dict:
    """Both configs, each in a process of its own; ``device`` (None: the
    card) is for callers such as tests. Returns {"card", "configs":
    {max_batch: summary}, "speedup", "equal": compare(), "replies":
    {max_batch: {image: reply}}}."""
    if device is None:
        from anyloc_tpu_torch.tools._timing import card_line, require_card

        require_card("bench_serving")
        card = card_line()
    else:
        card = str(device)
    out = {"card": card, "configs": {}}
    with tempfile.TemporaryDirectory(prefix="bench_serving_") as tmp:
        work = Path(tmp)
        synthesize(args, work)
        replies = {}
        for mb in (1, args.max_batch):
            cmd = [sys.executable, "-m", "anyloc_tpu_torch.tools.bench_serving",
                   "--single", str(mb), "--work", str(work)]
            for flag in ("model", "layer", "img_size", "quant", "requests", "clients",
                         "max_batch", "db_rows", "transfer_dtype", "batch_window_ms", "device"):
                v = device if flag == "device" else getattr(args, flag)
                if v is not None:
                    cmd += [f"--{flag.replace('_', '-')}", str(v)]
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join(
                [str(Path(__file__).resolve().parents[2])] + sys.path)
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=3600, env=env)
            last = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
            if proc.returncode != 0 or not last:
                raise RuntimeError(f"single run max_batch={mb} failed:\n{proc.stdout}\n"
                                   f"{proc.stderr[-4000:]}")
            r = json.loads(last[-1])
            replies[mb] = {int(i): rep for i, rep in r.pop("replies").items()}
            out["configs"][mb] = r
            emit(f"[{card}] max_batch={mb:>3}: {r['qps']:7.1f} qps, p50 {r['p50_ms']:.1f} ms, "
                 f"p99 {r['p99_ms']:.1f} ms (mean realized batch {r['mean_batch']:.1f} over "
                 f"{r['batches']} batches; {args.clients} client processes)")
            n_req = max(1, r["batches"] * r["mean_batch"])
            for name, st in sorted(r["stages"].items()):
                emit(f"    {name:<12} mean {st['mean_ms']:8.2f} ms x{st['count']:<5} = "
                     f"{st['total_ms'] / n_req:8.2f} ms/request")
    out["replies"] = replies
    out["equal"] = compare(replies[args.max_batch], replies[1])
    out["speedup"] = out["configs"][args.max_batch]["qps"] / out["configs"][1]["qps"]
    emit(f"speedup: {out['speedup']:.2f}x; replies equal to batch 1: scores within "
         f"{out['equal']['max_score_diff']:.2e} (bound {SCORE_TOL}), ids on "
         f"{out['equal']['ids_compared']}/{out['equal']['ranks']} ranks apart by more")
    return out


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.single is not None:
        r = single(args)
        print(json.dumps(r))
        return 0
    run(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
