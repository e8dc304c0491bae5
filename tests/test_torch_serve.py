"""The port's HTTP daemon (``pipelines/serve_http.py``) on the CPU: the
JAX package's serving cases that need no mesh, the port against the JAX
daemon on one checkpoint, vocabulary and database, and F3's 1-row ``--pq``
database.

Servers run on ``device="cpu"`` with a ViT-S/14 truncated at layer 2 and
a 4-word vocabulary. Bounds: a coalesced group's replies equal the batch-1
server's ids, scores and descriptors within 2e-3 (the JAX package's bound:
another batch size sums in another order); port against JAX in float32
within 1e-4 relative.
"""

import argparse
import functools
import io
import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from anyloc_tpu.models import extractor as jax_extractor
from anyloc_tpu.pipelines import serve_http as jax_serve

from anyloc_tpu_torch import VLAD, cli
from anyloc_tpu_torch.models import extractor as port_extractor
from anyloc_tpu_torch.models.dinov2 import dinov2_config, init_params
from anyloc_tpu_torch.pipelines import serve_http

torch.set_num_threads(2)


def _vocab(tmp_path, seed):
    vdir = tmp_path / "vocab"
    VLAD(4, cache_dir=str(vdir)).fit(
        np.random.default_rng(seed).standard_normal((120, 384)).astype(np.float32))
    return str(vdir)


def _db(tmp_path, rows, seed=1):
    db = np.random.default_rng(seed).standard_normal((rows, 4 * 384)).astype(np.float32)
    np.save(tmp_path / "db.npy", db)
    return str(tmp_path / "db.npy")


def _args(vdir, **kw):
    a = dict(model="dinov2_vits14", layer=2, facet="value", num_clusters=4, vocab_dir=vdir,
             checkpoint=None, quant=None, max_img_size=84, db=None, ivf=False, n_probe=4,
             host="127.0.0.1", port=0)
    a.update(kw)
    return argparse.Namespace(**a)


def _image(rng, h=70, w=84, fmt="PNG"):
    buf = io.BytesIO()
    Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(buf, format=fmt)
    return buf.getvalue()


def _serve(module, args, fn, **kw):
    server = module.build_server(args, **kw)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        return fn(port)
    finally:
        server.shutdown()
        server.server_close()


def _post(port, path, data):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return json.loads(r.read())


def test_serve_e2e(tmp_path):
    """/health, /describe, /search end to end; errors are JSON 400s and
    404s, and the server keeps running."""
    rng = np.random.default_rng(7)
    args = _args(_vocab(tmp_path, 7), db=_db(tmp_path, 20))
    img = _image(rng, fmt="JPEG")

    def run(port):
        h = _get(port, "/health")
        assert h["status"] == "ok" and h["db_rows"] == 20 and h["engine"] == "device"
        assert h["max_batch"] == 16 and h["clusters"] == 4
        gd = _post(port, "/describe", img)["descriptor"]
        assert len(gd) == 4 * 384
        np.testing.assert_allclose(np.linalg.norm(gd), 1.0, atol=1e-4)
        out = _post(port, "/search?k=3", img)
        assert len(out["ids"]) == 3 and len(out["scores"]) == 3
        assert out["scores"] == sorted(out["scores"], reverse=True)
        for path, data, code in (("/describe", b"not an image", 400), ("/nowhere", img, 404)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(port, path, data)
            assert e.value.code == code and "error" in json.loads(e.value.read())
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(port, "/nowhere")
        assert e.value.code == 404
        st = _get(port, "/stats")
        assert st["requests"] == 2 and st["mean_batch"] == 1.0
        assert {"preprocess", "queue_wait", "stack", "enqueue", "device_sync",
                "respond"} <= set(st["stages"])

    _serve(serve_http, args, run, device="cpu")


def test_serve_refuses_oversized_bodies_and_searches_without_a_database(tmp_path):
    rng = np.random.default_rng(3)

    def run(port):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/describe", data=b"x",
                                     method="POST",
                                     headers={"Content-Length": str(64 * 1024 * 1024 + 1)})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 413
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, "/search", _image(rng))
        assert e.value.code == 400 and "no database" in json.loads(e.value.read())["error"]

    _serve(serve_http, _args(_vocab(tmp_path, 3)), run, device="cpu")


def test_serve_pq_engine(tmp_path):
    rng = np.random.default_rng(9)
    args = _args(_vocab(tmp_path, 9), db=_db(tmp_path, 48), pq=True, pq_m=16)

    def run(port):
        h = _get(port, "/health")
        assert h["engine"] == "pq" and h["db_rows"] == 48
        out = _post(port, "/search?k=3", _image(rng, fmt="JPEG"))
        assert len(out["ids"]) == 3 and len(set(out["ids"])) == 3
        assert all(0 <= i < 48 for i in out["ids"])

    _serve(serve_http, args, run, device="cpu")
    args.ivf = True
    with pytest.raises(ValueError, match="mutually exclusive"):
        serve_http.build_server(args, device="cpu")


def test_serve_ivf_engine_at_full_probe_is_exact(tmp_path):
    rng = np.random.default_rng(10)
    vdir, db = _vocab(tmp_path, 10), _db(tmp_path, 30)
    img = _image(rng)
    exact = _serve(serve_http, _args(vdir, db=db), lambda p: _post(p, "/search?k=4", img),
                   device="cpu")

    def run(port):
        assert _get(port, "/health")["engine"] == "ivf"
        return _post(port, "/search?k=4", img)

    ivf = _serve(serve_http, _args(vdir, db=db, ivf=True, n_probe=64), run, device="cpu")
    assert ivf["ids"] == exact["ids"]
    np.testing.assert_allclose(ivf["scores"], exact["scores"], atol=1e-5)


def _burst(port, plan):
    """The first request alone, then the plan from one thread each."""
    _post(port, *plan[0])
    with ThreadPoolExecutor(len(plan)) as ex:
        outs = list(ex.map(lambda pd: _post(port, *pd), plan))
    return outs, _get(port, "/stats"), _get(port, "/health")


@pytest.mark.parametrize("mixed", [False, True])
def test_serve_coalesces_groups_that_answer_as_batch_1(tmp_path, mixed):
    """Concurrent requests under a long batch window share device batches
    (/stats: fewer batches than requests) and each reply equals the batch-1
    server's; a mixed group routes each describe and search row to its own
    request."""
    rng = np.random.default_rng(11)
    vdir, db = _vocab(tmp_path, 11), _db(tmp_path, 20)
    imgs = [_image(rng, 90, 77) for _ in range(6)]
    plan = [("/describe" if mixed and i % 2 == 0 else "/search?k=4", d)
            for i, d in enumerate(imgs)]
    ref = _serve(serve_http, _args(vdir, db=db, img_size=84, max_batch=1, batch_window_ms=0.0),
                 lambda p: [_post(p, *pd) for pd in plan], device="cpu")
    outs, stats, health = _serve(
        serve_http, _args(vdir, db=db, img_size=84, max_batch=8, batch_window_ms=500.0),
        lambda p: _burst(p, plan), device="cpu")
    assert health["max_batch"] == 8
    for (path, _), got, want in zip(plan, outs, ref):
        if path == "/describe":
            np.testing.assert_allclose(got["descriptor"], want["descriptor"], rtol=2e-3, atol=2e-3)
        else:
            assert got["ids"] == want["ids"]
            np.testing.assert_allclose(got["scores"], want["scores"], rtol=2e-3, atol=2e-3)
    assert stats["requests"] == 7
    assert stats["batches"] < 7 and stats["mean_batch"] > 1, stats


def test_serve_uint8_transfer_matches_float32(tmp_path):
    """--transfer-dtype uint8 sends the resized bytes and normalizes on the
    device: ids equal the float32 server's."""
    rng = np.random.default_rng(12)
    vdir, db = _vocab(tmp_path, 12), _db(tmp_path, 20)
    imgs = [_image(rng, 84, 84) for _ in range(3)]

    def run(port):
        return [_post(port, "/search?k=3", d) for d in imgs]

    outs = {t: _serve(serve_http, _args(vdir, db=db, img_size=84, max_batch=2,
                                        batch_window_ms=0.0, transfer_dtype=t, warm=True),
                      run, device="cpu")
            for t in ("float32", "uint8")}
    for a, b in zip(outs["float32"], outs["uint8"]):
        assert a["ids"] == b["ids"], (a, b)
        np.testing.assert_allclose(a["scores"], b["scores"], atol=5e-3)


def test_serve_rejects_extreme_aspect_images(tmp_path):
    rng = np.random.default_rng(11)
    args = _args(_vocab(tmp_path, 11), max_img_size=64, transfer_dtype="uint8")

    def run(port):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, "/describe", _image(rng, 8, 2000, fmt="JPEG"))
        body = json.loads(e.value.read())
        assert e.value.code == 400 and "too small" in body["error"]

    _serve(serve_http, args, run, device="cpu")


def test_serve_warms_before_it_accepts_traffic(tmp_path, monkeypatch):
    """The trunk, VLAD and search run once in ``build_server`` (where the
    kernels' library builds on a card), at --img-size or 224 px;
    ``--no-warm`` runs no forward."""
    calls = []
    real = port_extractor.DinoV2ExtractFeatures.__call__

    def spy(self, imgs):
        calls.append(tuple(imgs.shape))
        return real(self, imgs)

    monkeypatch.setattr(port_extractor.DinoV2ExtractFeatures, "__call__", spy)
    vdir, db = _vocab(tmp_path, 4), _db(tmp_path, 5)
    for kw, want in (({"img_size": 100}, [(1, 98, 98, 3)]), ({}, [(1, 224, 224, 3)]),
                     ({"warm": False}, [])):
        calls.clear()
        server = serve_http.build_server(_args(vdir, db=db, **kw), device="cpu")
        server.server_close()
        assert calls == want, kw


def test_serve_queues_a_burst_of_connections_before_it_accepts(tmp_path):
    """64 clients connect while the accept loop is not yet running: each
    handshake completes into the listen backlog at once (socketserver's
    default backlog of 5 drops the rest into a 1-s SYN retry, or resets
    them), and each is answered once the loop starts."""
    import socket

    server = serve_http.build_server(_args(_vocab(tmp_path, 5), warm=False), device="cpu")
    port = server.server_address[1]
    socks, loop = [], threading.Thread(target=server.serve_forever, daemon=True)
    try:
        for _ in range(64):
            s = socket.create_connection(("127.0.0.1", port), timeout=0.5)
            s.settimeout(60)
            s.sendall(b"GET /health HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n")
            socks.append(s)
        loop.start()
        for s in socks:
            with s.makefile("rb") as f:
                assert f.readline().split()[1] == b"200"
    finally:
        for s in socks:
            s.close()
        if loop.is_alive():   # shutdown() waits for a loop that runs
            server.shutdown()
        server.server_close()


def test_serve_mesh_raises_naming_its_queue_item(tmp_path):
    """``--mesh`` is ported (the queue item "parallel/ on torch.distributed"):
    in a plain process, with no world of 2 ranks, ``--mesh 2`` raises
    naming the launch it needs (tests/test_torch_parallel.py runs it on 2
    and 4 ranks)."""
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        cli.main(["serve", "--vocab-dir", str(tmp_path), "--mesh", "2"], device="cpu")


@pytest.mark.parametrize("rows", [1, 2])
def test_pq_database_of_one_or_two_rows_serves_f3(tmp_path, rows):
    """F3: the JAX daemon clamps PQ's codebook to ``max(2, rows)`` words,
    more than a 1-row database can train, and fails at startup. The port
    serves a 1-row ``--pq`` database through the exact engine and a 2-row
    one through PQ with one word a row; both return id 0 with the exact
    engine's score within 1e-5."""
    rng = np.random.default_rng(13)
    vdir = _vocab(tmp_path, 13)
    img = _image(rng)
    d0 = _serve(serve_http, _args(vdir), lambda p: _post(p, "/describe", img),
                device="cpu")["descriptor"]
    db = np.stack([np.asarray(d0, np.float32)]
                  + [rng.standard_normal(4 * 384).astype(np.float32) * 0.01] * (rows - 1))
    np.save(tmp_path / "db.npy", db)

    def run(port):
        return _get(port, "/health"), _post(port, "/search?k=5", img)

    h, out = _serve(serve_http, _args(vdir, db=str(tmp_path / "db.npy"), pq=True, pq_m=16), run,
                    device="cpu")
    _, exact = _serve(serve_http, _args(vdir, db=str(tmp_path / "db.npy")), run, device="cpu")
    assert h["db_rows"] == rows and h["engine"] == ("pq" if rows == 2 else "device")
    assert out["ids"][0] == 0 == exact["ids"][0] and len(out["ids"]) == rows
    np.testing.assert_allclose(out["scores"], exact["scores"], atol=1e-5)
    if rows == 1:
        with pytest.raises(ValueError, match="n_codes"):
            jax_serve.build_server(_args(vdir, db=str(tmp_path / "db.npy"), pq=True, pq_m=16))


@pytest.fixture
def vits14(tmp_path):
    shapes = {k: tuple(v.shape) for k, v in init_params(
        dinov2_config("dinov2_vits14", dtype=torch.float32), n_blocks=12).items()}
    shapes.update({"norm.weight": (384,), "norm.bias": (384,)})
    rng = np.random.default_rng(0)
    sd = {k: torch.from_numpy((rng.standard_normal(s) * (np.prod(s[1:]) ** -0.5 if len(s) > 1
                                                         else 0.1)).astype(np.float32))
          for k, s in sorted(shapes.items())}
    torch.save(sd, tmp_path / "vits14.pth")
    return str(tmp_path / "vits14.pth")


def test_serve_matches_the_jax_daemon(tmp_path, vits14, monkeypatch):
    """One checkpoint, vocabulary and database, float32 trunks (the JAX
    daemon has no dtype flag): /describe within 1e-4 relative, /search the
    same ids where the k-th and (k+1)-th scores lie apart."""
    monkeypatch.setattr(jax_extractor, "DinoV2ExtractFeatures", functools.partial(
        jax_extractor.DinoV2ExtractFeatures, dtype=jnp.float32))
    monkeypatch.setattr(port_extractor, "DinoV2ExtractFeatures", functools.partial(
        port_extractor.DinoV2ExtractFeatures, dtype="float32"))
    rng = np.random.default_rng(14)
    args = _args(_vocab(tmp_path, 14), db=_db(tmp_path, 40), checkpoint=vits14, img_size=84)
    imgs = [_image(rng, 80, 96) for _ in range(3)]

    def run(port):
        return ([_post(port, "/describe", d)["descriptor"] for d in imgs],
                [_post(port, "/search?k=5", d) for d in imgs])

    got_d, got_s = _serve(serve_http, args, run, device="cpu")
    want_d, want_s = _serve(jax_serve, args, run)
    for g, w in zip(got_d, want_d):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max())
    for g, w in zip(got_s, want_s):
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-4)
        gaps = np.diff(w["scores"])
        keep = len(w["ids"]) if np.all(-gaps > 1e-4) else int(np.argmax(-gaps <= 1e-4))
        assert g["ids"][:keep] == w["ids"][:keep]
