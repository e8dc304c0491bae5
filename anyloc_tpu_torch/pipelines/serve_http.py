"""HTTP serving daemon (counterpart of ``anyloc_tpu/pipelines/serve_http.py``):
one long-lived process keeps the trunk, the vocabulary and the database
index resident on the card, on the standard library only:

  GET  /health            -> {"status": "ok", ...config...}
  GET  /stats             -> {"requests", "batches", "mean_batch", "stages"}
  POST /describe  (image bytes: jpg/png)  -> {"descriptor": [C*D floats]}
  POST /search?k=5  (image bytes)         -> {"ids": [...], "scores": [...]}

Run:
  python -m anyloc_tpu_torch serve --model dinov2_vitg14 --layer 31 \\
      --vocab-dir cache/vocabulary/dinov2_vitg14/l31_value_c32/indoor \\
      --db db_vlads.npy --quant int8_full --transfer-dtype uint8 \\
      --img-size 308 --port 8080

Concurrent requests coalesce into one device batch: handler threads
decode and resize (the native image pipe when it builds, else PIL) and
park the request; one dispatcher thread does all device work. It takes
the requests of one preprocessed shape (up to ``--max-batch``) and runs
one trunk forward + VLAD (+ search) for the group. ``GET /stats`` reports
the mean group size and the wall time of each stage.

The dispatcher is a depth-1 pipeline: group N is stacked, copied to the
card from pinned memory and queued before group N-1's results are read.
Each group queues the copies of its results to pinned host buffers
(``non_blocking``) and records a CUDA event behind them; the fetch of
group N-1 waits on that event alone, so it never waits for group N
(``device_sync`` in ``/stats`` is that wait).

Unlike the JAX package, groups are not padded to a power-of-two batch
and ``k`` is not rounded up to a power of two: those buckets bounded
XLA's compiles, and torch compiles nothing per shape. Each group runs at
its own size and its largest ``k``, each request keeps its own first
``k``. What must be warm is the CUDA kernels' library, which ``nvcc``
builds at the first launch: the service launches the trunk, VLAD and the
search once before it accepts traffic (at ``--img-size``, else at 224 px);
``--no-warm`` only builds the library.

``--mesh N`` shards the DATABASE over N ranks, for every engine (exact,
``--pq``, ``--ivf``), through the sharded engines of ``parallel/``: each
rank's card holds ~1/N of it and the replies equal the unsharded daemon's.
The engine name gains ``+meshN``. The exact engine's ranks each read
their own rows of ``--db``; an index is fit on rank 0 and reaches the
other ranks as a file in a temporary directory (the ranks share a host),
so no whole store crosses the group. A failed sharded search stops the
daemon: the ranks are out of step after it, so rank 0 answers the
requests in flight with the error, shuts the server down and raises. ``--mesh 1`` runs in a plain process; a
larger mesh needs a world of N ranks, one per card:
``torchrun --nproc-per-node N -m anyloc_tpu_torch serve ... --mesh N``.
Rank 0 serves HTTP and runs the trunk and the dispatcher; for each group
with searches it broadcasts the query descriptors and ``k``, and the other
ranks, which only hold their database shards, run a follow loop that
joins the sharded search.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch


class _Request:
    """One in-flight request parked on the batch queue."""

    __slots__ = ("arr", "kind", "k", "event", "result", "error", "t_submit")

    def __init__(self, arr, kind: str, k: int = 0) -> None:
        self.arr = arr          # preprocessed [H, W, 3] f32, or uint8
        self.kind = kind        # "describe" | "search"
        self.k = k
        self.event = threading.Event()
        self.result = None
        self.error: Optional[Exception] = None
        self.t_submit = 0.0


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; to the card through pinned memory, so
    the copy queues behind earlier work instead of waiting for it."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """Queue ``t``'s copy to a pinned host buffer (the card), or return it
    (the CPU, where the work is already done)."""
    if t.device.type != "cuda":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


class _Batcher:
    """Coalesces concurrent requests into device batches.

    One dispatcher thread owns all device work (trunk + VLAD + search). It
    drains the queue and groups requests by preprocessed shape; when the
    device is idle, ``window_s`` lets it linger for followers of the first
    request. Per-stage wall time accumulates into ``stages`` (``GET
    /stats``): preprocess / queue_wait / respond per request, stack /
    enqueue / device_sync per group. ``n_pipelined`` counts fetches made
    while the next group was already queued, ``n_overlapped`` those of them
    that returned while the next group's device work was still running.
    """

    def __init__(self, svc: "_Service", max_batch: int, window_s: float) -> None:
        self.svc = svc
        self.max_batch = max(1, max_batch)
        self.window_s = max(0.0, window_s)
        self.cv = threading.Condition()
        self.queue: list = []
        self.n_requests = 0
        self.n_batches = 0
        self.n_pipelined = 0
        self.n_overlapped = 0
        self.stages: dict = {}
        self.closed = False
        self.failed: Optional[Exception] = None   # a sharded search's error: stopped
        self.on_fatal = None   # called once ``failed`` is set (the server's shutdown)
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def close(self) -> None:
        """Stop the dispatcher once the queued requests are answered."""
        with self.cv:
            self.closed = True
            self.cv.notify_all()
        self.thread.join()

    def acc(self, stage: str, seconds: float, n: int = 1) -> None:
        """Add ``seconds`` of wall time to one stage."""
        with self.cv:
            tot, cnt = self.stages.get(stage, (0.0, 0))
            self.stages[stage] = (tot + seconds, cnt + n)

    def submit(self, req: _Request) -> _Request:
        req.t_submit = time.monotonic()
        with self.cv:
            if self.failed is not None:
                raise RuntimeError("the daemon stopped after a sharded search failed") \
                    from self.failed
            self.queue.append(req)
            self.cv.notify_all()
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req

    def _take_group(self, blocking: bool = True) -> list:
        with self.cv:
            while not self.queue:
                if not blocking or self.closed:
                    return []
                self.cv.wait()
            shape = self.queue[0].arr.shape
            same = lambda: [r for r in self.queue if r.arr.shape == shape]  # noqa: E731
            # the linger window applies to an idle dispatcher only: behind
            # in-flight device work, arrivals have accumulated already
            if blocking and self.window_s > 0 and len(same()) < self.max_batch:
                deadline = time.monotonic() + self.window_s
                while len(same()) < self.max_batch:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self.cv.wait(timeout=left)
            group = same()[:self.max_batch]
            for r in group:
                self.queue.remove(r)
            self.n_requests += len(group)
            self.n_batches += 1
        now = time.monotonic()
        for r in group:
            self.acc("queue_wait", now - r.t_submit)
        return group

    def _run(self) -> None:
        pending = None   # (group, state) awaiting its fetch
        while True:
            group = self._take_group(blocking=pending is None)
            if not group and pending is None:   # closed and drained
                return
            state = None
            if group:
                try:
                    state = (group, self._dispatch(group))
                except Exception as e:   # surface per request, keep serving
                    for r in group:
                        r.error = e
                        r.event.set()
            if pending is not None:
                pgroup, pstate = pending
                try:
                    self._finish(pgroup, pstate)
                except Exception as e:
                    for r in pgroup:
                        r.error = e
                    if self.svc.mesh is not None:
                        # the sharded search's collectives failed part-way:
                        # the other ranks are out of step, so nothing more
                        # may run on the group
                        self._fail(e, group)
                        return
                finally:
                    for r in pgroup:
                        r.event.set()
                if state is not None and state[1].get("event") is not None:
                    self.n_pipelined += 1
                    self.n_overlapped += int(not state[1]["event"].query())
            pending = state

    def _fail(self, error: Exception, group: list) -> None:
        """Stop: answer ``group`` and the queued requests with ``error``,
        refuse new ones, and call ``on_fatal``."""
        with self.cv:
            self.failed = error
            for r in group + self.queue:
                r.error = error
                r.event.set()
            self.queue.clear()
        if self.on_fatal is not None:
            self.on_fatal()

    def _rows(self, t: torch.Tensor, rows: list) -> torch.Tensor:
        """The rows ``rows`` of ``t``, selected on its device."""
        if rows == list(range(len(rows))):
            return t[:len(rows)]
        return t.index_select(0, _to_device(np.asarray(rows, np.int64), t.device))

    def _dispatch(self, group: list) -> dict:
        """Stack the group, queue its device work and the copies of its
        results; returns without waiting for the device."""
        svc = self.svc
        t0 = time.monotonic()
        batch = np.stack([r.arr for r in group])
        t1 = time.monotonic()
        self.acc("stack", t1 - t0)
        descs = svc.extractor(_to_device(batch, svc.device))
        vlads = svc.vlad.aggregate(descs)
        state = {}
        describes = [(i, r) for i, r in enumerate(group) if r.kind == "describe"]
        if describes:
            # only the describe rows come home: a search-only group copies
            # no [n, C·D] descriptors back
            state.update(describes=describes,
                         vlads=_to_host(self._rows(vlads, [i for i, _ in describes])))
        searches = [(i, r) for i, r in enumerate(group) if r.kind == "search"]
        if searches:
            kmax = min(max(r.k for _, r in searches), svc.db_rows)
            qu = self._rows(vlads, [i for i, _ in searches])
            state.update(searches=searches, kmax=kmax)
            if svc.mesh is not None:
                # the sharded search waits for its collectives: it runs in
                # _finish, so this dispatch stays asynchronous
                state["search_thunk"] = lambda: svc.mesh_search(qu, kmax)
            else:
                s, idx = svc.search_fn(qu, kmax)
                state.update(s=_to_host(s), idx=_to_host(idx))
        if svc.device.type == "cuda":
            state["event"] = torch.cuda.Event()
            state["event"].record()
        self.acc("enqueue", time.monotonic() - t1)
        return state

    def _finish(self, group: list, state: dict) -> None:
        """Wait for the group's results (its own event) and hand them to
        their requests."""
        t0 = time.monotonic()
        if state.get("event") is not None:
            state["event"].synchronize()
        if "search_thunk" in state:
            state["s"], state["idx"] = state.pop("search_thunk")()
        if "searches" in state:
            s, idx = np.asarray(state["s"]), np.asarray(state["idx"])
            for row, (_, r) in enumerate(state["searches"]):
                kk = min(r.k, state["kmax"])
                r.result = (s[row, :kk], idx[row, :kk])
        if "describes" in state:
            vlads = state["vlads"].numpy()
            for row, (_, r) in enumerate(state["describes"]):
                r.result = vlads[row]
        self.acc("device_sync", time.monotonic() - t0)


class _Service:
    """Extractor + vocabulary (+ database index) on ``device`` (None: the
    card), shared by the handler threads. Under ``--mesh`` a rank other
    than 0 holds its database shards only (``follow``)."""

    def __init__(self, args, device=None) -> None:
        from anyloc_tpu_torch.models.extractor import DinoV2ExtractFeatures
        from anyloc_tpu_torch.ops.common import resolve_device
        from anyloc_tpu_torch.ops.vlad import VLAD

        self.args = args
        self.mesh = None
        self.follower = False
        self.n_mesh = int(getattr(args, "mesh", 0) or 0)
        if self.n_mesh >= 1:
            import torch.distributed as dist

            from anyloc_tpu_torch.parallel.mesh import local_mesh

            host = device is not None and torch.device(device).type == "cpu"
            self.mesh = local_mesh(self.n_mesh, backend="gloo" if host else "nccl")
        self.device = resolve_device(device)
        if self.mesh is not None:
            if dist.get_rank() != 0:
                self.follower = True
                self.db_rows = 0
                if args.db:
                    self._load_db(args.db)
                return
        self.extractor = DinoV2ExtractFeatures(
            args.model, args.layer, args.facet, checkpoint=args.checkpoint,
            quant=args.quant, device=self.device)
        self.vlad = VLAD(args.num_clusters, cache_dir=args.vocab_dir)
        self.vlad.fit(None)   # load only
        self.vlad.c_centers = self.vlad.c_centers.to(self.device)
        self.index = None
        self.search_fn = None
        self.engine = "device"
        self.db_rows = 0
        self.decoded = {"native": 0, "PIL": 0}   # decoders of the served images
        self._decoded_lock = threading.Lock()
        if args.db:
            self._load_db(args.db)
        if self.mesh is not None and args.db:
            self.engine += f"+mesh{self.n_mesh}"
        self.batcher = _Batcher(self, max_batch=getattr(args, "max_batch", 16),
                                window_s=getattr(args, "batch_window_ms", 5.0) / 1e3)
        self._warm(full=getattr(args, "warm", True))

    def _load_db(self, path: str) -> None:
        """The database's index and ``search_fn(qu, k)`` from the ``.npy``
        at ``path``. Under the mesh ``search_fn`` is the sharded engine, a
        collective of every rank: the exact engine's ranks each read their
        own rows of the file; an index is fit on rank 0 on the host (the
        whole store must not go to one card) and reaches the other ranks as
        a file (``fit``); each rank's card then holds its window alone."""
        from anyloc_tpu_torch.parallel import distributed as sharded

        args = self.args
        db = np.load(path, mmap_mode="r")   # rows are read where they are used
        self.db_rows = int(db.shape[0])
        ivf, pq = getattr(args, "ivf", False), getattr(args, "pq", False)
        if ivf and pq:
            raise ValueError("--ivf and --pq are mutually exclusive")
        mesh, dev = self.mesh, self.device

        def whole():
            return np.array(db, dtype=np.float32)

        def fit(make, save, load):
            """``make(host)``'s index. Under the mesh rank 0 fits it on the
            host and saves it to a temporary directory whose path it
            broadcasts; every other rank loads it from there on the host."""
            if mesh is None:
                return make(False)
            import shutil
            import tempfile

            import torch.distributed as dist

            from anyloc_tpu_torch.parallel.mesh import barrier, broadcast_object

            rank0 = dist.get_rank() == 0
            where = tempfile.mkdtemp(prefix="anyloc_mesh_index_") if rank0 else None
            try:
                if rank0:
                    index = make(True)
                    save(index, os.path.join(where, "index.npz"))
                where = broadcast_object(where)   # a path: after rank 0 has saved
                if not rank0:
                    index = load(os.path.join(where, "index.npz"), device="cpu")
                barrier()   # every rank has read the file
            finally:
                if rank0:
                    shutil.rmtree(where, ignore_errors=True)
            return index

        if ivf:
            from anyloc_tpu_torch.ops.ivf import ivf_fit, load_ivf, save_ivf

            self.index = fit(lambda host: ivf_fit(whole(), method="cosine", as_numpy=host,
                                                  device=dev), save_ivf, load_ivf)
            if mesh is None:
                self.search_fn = lambda qu, k: self.index.search(qu, k, n_probe=args.n_probe)
            else:
                self.search_fn = lambda qu, k: sharded.ivf_search_sharded(
                    self.index, qu, k, mesh, n_probe=args.n_probe, device=dev)
            self.engine = "ivf"
        elif pq and self.db_rows >= 2:
            # compressed database: pq_m bytes a row on the card instead of
            # 4·dim. A codebook of n_codes words needs as many rows, so a
            # small database takes n_codes = its row count (its codes then
            # reconstruct every row exactly)
            from anyloc_tpu_torch.ops.pq import load_pq, pq_fit, save_pq

            self.index = fit(lambda host: pq_fit(
                whole(), getattr(args, "pq_m", 64), n_codes=min(256, self.db_rows),
                method="cosine", as_numpy=host, device=dev), save_pq, load_pq)
            if mesh is None:
                self.search_fn = lambda qu, k: self.index.search(qu, k)
            else:
                self.search_fn = lambda qu, k: sharded.pq_search_sharded(
                    self.index, qu, k, mesh, device=dev)
            self.engine = "pq"
        elif mesh is None:
            # exact (and a --pq database of one row, which no codebook of
            # two words can encode): the database stays resident
            from anyloc_tpu_torch.ops.retrieval import top_k_search

            db_dev = torch.from_numpy(whole()).to(dev)
            self.search_fn = lambda qu, k: top_k_search(db_dev, qu, k)
        else:
            # exact over the mesh: this rank's rows (the last rank's padded
            # with zero rows, which the n_valid mask keeps out) stay resident
            from anyloc_tpu_torch.ops.common import cdiv
            from anyloc_tpu_torch.parallel.mesh import axis_index

            local_n = cdiv(self.db_rows, self.n_mesh)
            lo = axis_index(mesh, "data") * local_n
            local = torch.zeros((local_n,) + db.shape[1:], dtype=torch.float32)
            rows = np.array(db[lo:lo + local_n], dtype=np.float32)
            local[:rows.shape[0]] = torch.from_numpy(rows)
            local = local.to(dev)
            self.search_fn = lambda qu, k: sharded.top_k_search_sharded(
                local, qu, k, mesh, n_valid=self.db_rows)

    def mesh_search(self, qu: torch.Tensor, k: int):
        """Rank 0's sharded search: the header (1, Q, k, D) and the queries
        go to every rank, then all join ``search_fn``."""
        from anyloc_tpu_torch.parallel.mesh import broadcast

        hdr = torch.tensor([1, qu.shape[0], k, qu.shape[1]], dtype=torch.int64,
                           device=self.device)
        broadcast(hdr, self.mesh, None)
        return self.search_fn(broadcast(qu.float().contiguous(), self.mesh, None), k)

    def follow(self) -> None:
        """The loop of a rank other than 0: join each search rank 0
        broadcasts, until the header says stop (0)."""
        from anyloc_tpu_torch.parallel.mesh import broadcast

        while True:
            hdr = broadcast(torch.zeros(4, dtype=torch.int64, device=self.device), self.mesh, None)
            op, nq, k, d = (int(v) for v in hdr.tolist())
            if op == 0:
                return
            qu = broadcast(torch.empty((nq, d), dtype=torch.float32, device=self.device),
                           self.mesh, None)
            self.search_fn(qu, k)

    def stop_followers(self) -> None:
        """The stop header to the follower ranks (none after a failed
        search: the group is out of step, and the ranks' exit ends it)."""
        from anyloc_tpu_torch.parallel.mesh import broadcast

        if self.mesh is not None and self.batcher.failed is None:
            broadcast(torch.zeros(4, dtype=torch.int64, device=self.device), self.mesh, None)

    def _warm(self, full: bool) -> None:
        """Build the kernels' library before the server accepts traffic:
        with ``full``, one request's trunk, VLAD and search at the serving
        shape; else the library alone (the card only)."""
        if not full:
            if self.device.type == "cuda":
                from anyloc_tpu_torch import _build

                _build.load_library()
            return
        size = getattr(self.args, "img_size", 0) or 224
        size -= size % 14
        dt = np.uint8 if getattr(self.args, "transfer_dtype", "float32") == "uint8" else np.float32
        vlads = self.vlad.aggregate(self.extractor(_to_device(
            np.zeros((1, size, size, 3), dt), self.device)))
        if self.search_fn is not None:
            search = self.search_fn if self.mesh is None else self.mesh_search
            vlads = search(vlads, min(8, self.db_rows))[0]
        np.asarray(vlads.cpu() if isinstance(vlads, torch.Tensor) else vlads)

    def _count(self, decoder: str) -> None:
        with self._decoded_lock:
            self.decoded[decoder] += 1

    def _decode_u8(self, image_bytes: bytes) -> np.ndarray:
        """Decode + resize to uint8: the native pipe (in-memory decode and
        tensor-mode resize), else PIL."""
        from PIL import Image

        from anyloc_tpu_torch import native
        from anyloc_tpu_torch.data.transforms import resize_round_u8

        if getattr(self.args, "img_size", 0):
            nat_kw = dict(size_hw=(self.args.img_size, self.args.img_size))
        else:
            nat_kw = dict(max_edge=self.args.max_img_size)
        arr8 = native.decode_bytes_u8(image_bytes, **nat_kw)
        if arr8 is not None:
            self._count("native")
            return arr8
        self._count("PIL")
        arr = np.asarray(Image.open(io.BytesIO(image_bytes)).convert("RGB"), np.float32)
        if getattr(self.args, "img_size", 0):
            size = (self.args.img_size, self.args.img_size)
        else:
            me = self.args.max_img_size
            h, w = arr.shape[:2]
            sc = min(1.0, me / max(h, w))
            size = (int(h * sc), int(w * sc))
        return resize_round_u8(arr, size)

    def _preprocess(self, image_bytes: bytes) -> np.ndarray:
        """Host work of one request, on its handler thread: decode, resize,
        center-crop to the patch grid. uint8 transfer sends the resized
        bytes and normalizes on the device (1/4 the copy)."""
        from PIL import Image

        from anyloc_tpu_torch.data.transforms import center_crop_multiple, preprocess_image

        if getattr(self.args, "transfer_dtype", "float32") == "uint8":
            return center_crop_multiple(self._decode_u8(image_bytes), 14)
        self._count("PIL")
        img = Image.open(io.BytesIO(image_bytes)).convert("RGB")
        if getattr(self.args, "img_size", 0):
            # a fixed serving resolution: every request in one shape, so
            # any concurrent pair can share a device batch
            return preprocess_image(img, size_hw=(self.args.img_size, self.args.img_size),
                                    crop_multiple=14)
        return preprocess_image(img, max_edge=self.args.max_img_size, crop_multiple=14)

    def _timed_preprocess(self, image_bytes: bytes) -> np.ndarray:
        t0 = time.monotonic()
        arr = self._preprocess(image_bytes)
        if arr.shape[0] < 14 or arr.shape[1] < 14:
            # an extreme aspect ratio scales or crops below one patch: a
            # clear 400 instead of a failure in the trunk
            raise ValueError(
                f"image too small after preprocessing ({arr.shape[0]}x{arr.shape[1]} px; "
                f"need >= 14x14 — extreme aspect ratio or tiny source)")
        self.batcher.acc("preprocess", time.monotonic() - t0)
        return arr

    def describe(self, image_bytes: bytes) -> np.ndarray:
        req = _Request(self._timed_preprocess(image_bytes), "describe")
        return self.batcher.submit(req).result

    def search(self, image_bytes: bytes, k: int):
        if not self.db_rows:   # before paying a trunk forward
            raise ValueError("no database loaded (--db)")
        req = _Request(self._timed_preprocess(image_bytes), "search", k=k)
        return self.batcher.submit(req).result


def make_handler(svc: _Service):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):   # quiet by default
            pass

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/health":
                self._reply(200, {
                    "status": "ok", "model": svc.args.model, "layer": svc.args.layer,
                    "facet": svc.args.facet, "clusters": svc.args.num_clusters,
                    "quant": svc.args.quant, "db_rows": svc.db_rows, "engine": svc.engine,
                    "max_batch": svc.batcher.max_batch,
                })
            elif path == "/stats":
                b = svc.batcher
                with b.cv:
                    n_req, n_bat = b.n_requests, b.n_batches
                    stages = dict(b.stages)
                self._reply(200, {
                    "requests": n_req,
                    "batches": n_bat,
                    "mean_batch": (n_req / n_bat) if n_bat else 0.0,
                    # preprocess / queue_wait / respond count per request,
                    # stack / enqueue / device_sync per group
                    "stages": {k: {"total_ms": round(tot * 1e3, 3), "count": cnt,
                                   "mean_ms": round(tot * 1e3 / cnt, 3)}
                               for k, (tot, cnt) in sorted(stages.items())},
                })
            else:
                self._reply(404, {"error": "unknown path"})

        MAX_BODY = 64 * 1024 * 1024   # one image; a daemon must not run out of memory
        MAX_K = 1024                  # bounds one request's search and reply
        timeout = 120                 # a stalled client must not hold a thread

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n < 0 or n > self.MAX_BODY:
                    self._reply(413, {"error": f"bad body size ({n} bytes)"})
                    return
                data = self.rfile.read(n)
                if len(data) != n:   # the client hung up mid-body
                    self._reply(400, {"error": "truncated body"})
                    return
                path, _, query = self.path.partition("?")
                if path == "/describe":
                    gd = svc.describe(data)
                    t0 = time.monotonic()
                    self._reply(200, {"descriptor": gd.tolist()})
                    svc.batcher.acc("respond", time.monotonic() - t0)
                elif path == "/search":
                    k = 5
                    for part in query.split("&"):
                        if part.startswith("k="):
                            k = max(1, min(int(part[2:]), self.MAX_K))
                    s, i = svc.search(data, k)
                    t0 = time.monotonic()
                    self._reply(200, {"ids": i.tolist(), "scores": s.tolist()})
                    svc.batcher.acc("respond", time.monotonic() - t0)
                else:
                    self._reply(404, {"error": "unknown path"})
            except Exception as e:   # errors as JSON; the server keeps running
                # a bad image (PIL raises an OSError) or bad parameters are
                # the client's (400); anything else is a 500
                code = 400 if isinstance(e, (ValueError, OSError)) else 500
                try:
                    self._reply(code, {"error": f"{type(e).__name__}: {e}"})
                except Exception:
                    pass   # the client is gone

    return Handler


class _Server(ThreadingHTTPServer):
    """The HTTP server of one ``_Service`` (``server.service``);
    ``server_close`` also stops its dispatcher."""

    # the listen backlog: socketserver's default of 5 is less than one
    # coalesced batch, so a burst of concurrent clients overflows the
    # accept queue while the handler threads hold the GIL, and the kernel
    # drops (a 1-s SYN retry) or resets the connections past it
    request_queue_size = 1024

    def __init__(self, svc: _Service) -> None:
        super().__init__((svc.args.host, svc.args.port), make_handler(svc))
        self.service = svc
        # a failed sharded search stops serve_forever (from another thread:
        # shutdown waits for the loop, which runs on the caller's)
        svc.batcher.on_fatal = lambda: threading.Thread(target=self.shutdown,
                                                        daemon=True).start()

    def server_close(self) -> None:
        super().server_close()
        self.service.batcher.close()
        self.service.stop_followers()


class _Follower:
    """What a rank other than 0 of a ``--mesh`` daemon runs:
    ``serve_forever`` joins rank 0's sharded searches until it closes."""

    def __init__(self, svc: _Service) -> None:
        self.service = svc

    def serve_forever(self) -> None:
        self.service.follow()

    def server_close(self) -> None:
        pass


def build_server(args, device=None):
    """The daemon's server, its service warm; ``device`` None means the
    card. Under ``--mesh`` a rank other than 0 gets its ``_Follower``."""
    svc = _Service(args, device=device)
    if svc.follower:
        return _Follower(svc)
    return _Server(svc)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="dinov2_vitg14")
    p.add_argument("--layer", type=int, default=31)
    p.add_argument("--facet", default="value")
    p.add_argument("--num-clusters", type=int, default=32)
    p.add_argument("--vocab-dir", required=True,
                   help="directory holding c_centers.npz (demo cache layout)")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--quant", default=None, choices=["int8", "int8_fused", "int8_full"])
    p.add_argument("--max-img-size", type=int, default=640)
    p.add_argument("--img-size", type=int, default=0,
                   help="fixed square serving resolution (0 = variable, demo-style max-edge); "
                        "fixed puts every request in one shape, so any concurrent pair batches")
    p.add_argument("--max-batch", type=int, default=16,
                   help="max concurrent requests coalesced per device batch")
    p.add_argument("--transfer-dtype", default="float32", choices=["float32", "uint8"],
                   help="host->device batch format; uint8 sends 1/4 the bytes and "
                        "normalizes on the device")
    p.add_argument("--no-warm", dest="warm", action="store_false",
                   help="skip the warm-up request at startup (the kernels' library is "
                        "still built before the server accepts traffic)")
    p.add_argument("--batch-window-ms", type=float, default=5.0,
                   help="an idle dispatcher lingers this long for followers of the first "
                        "queued request")
    p.add_argument("--db", default=None, help=".npy of database descriptors enabling /search")
    p.add_argument("--ivf", action="store_true",
                   help="serve /search through the IVF index (large databases)")
    p.add_argument("--n-probe", type=int, default=8)
    p.add_argument("--pq", action="store_true",
                   help="serve /search through a PQ-compressed database (ops/pq.py)")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard the DATABASE over this many ranks (0 = one device): /search "
                        "routes through the sharded engines (parallel/), equal replies with "
                        "1/n of the database a rank; N > 1 needs torchrun --nproc-per-node N")
    p.add_argument("--pq-m", type=int, default=64,
                   help="PQ subquantizers = bytes per database row")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    return p


def main(argv=None, device=None) -> int:
    """``device`` places the service (None: the card); it is for callers
    such as tests, not a flag."""
    args = _parser().parse_args(argv)
    server = build_server(args, device=device)
    if isinstance(server, _Server):
        print(f"serving on http://{args.host}:{args.port} (/health /stats /describe /search)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if server.service.mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()
    failed = getattr(server.service, "batcher", None) and server.service.batcher.failed
    if failed:   # a nonzero exit, which ends the other ranks' launch too
        raise RuntimeError("the daemon stopped after a sharded search failed") from failed
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
