"""The port's sharded retrieval and serving (``anyloc_tpu_torch/parallel/``)
on 2 and 4 Gloo ranks on the CPU against the JAX package's sharded
engines on the virtual 8-device mesh, a mesh of the same shape.

One group of ranks per world size runs every case of this file
(``anyloc_tpu_torch/tools/mesh_checks.py``, ``spawn`` processes, a
``file://`` store under the test's temporary directory, its own timeout);
the checks are parametrized over its results. Inputs come from numpy
seeds (``mesh_checks.inputs``); k-means starts, queries and the fitted
indexes come from the JAX side (``given/``). Bounds, as the JAX package's
own sharding tests use them: search ids equal and scores within 1e-5
(1e-4 for l2 and bf16-free k-means centers), bf16 scores within 2^-8 of
their size.
"""

import argparse
import json

import jax
import numpy as np
import pytest
import torch

from anyloc_tpu.ops import ivf as jax_ivf
from anyloc_tpu.ops import ivf_pq as jax_ivf_pq
from anyloc_tpu.ops import pq as jax_pq
from anyloc_tpu.ops.retrieval import top_k_search as jax_top_k_search
from anyloc_tpu.parallel import distributed as jax_dist
from anyloc_tpu.parallel import get_mesh as jax_get_mesh

from anyloc_tpu_torch import cli as port_cli
from anyloc_tpu_torch.tools import mesh_checks

torch.set_num_threads(2)
WORLDS = (2, 4)


def _norm(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _kmeans_refs(given, mesh):
    refs = {}
    for tag, x in mesh_checks.inputs("kmeans", "small").items():
        c, mode, iters, seed = {"cos": (8, "cosine", 20, 3), "euc": (4, "euclidean", 15, 0)}[tag]
        key = jax.random.PRNGKey(seed)
        np.save(given / f"kmeans_{tag}_init.npy",
                np.asarray(jax.random.choice(key, x.shape[0], shape=(c,), replace=False)))
        refs[f"{tag}_sharded"] = np.asarray(
            jax_dist.kmeans_fit_sharded(key, x, c, mesh, mode=mode, max_iters=iters))
    return refs


def _search_refs(mesh):
    inp = mesh_checks.inputs("search", "small")
    refs = {}
    runs = [(f"db{n}_{m}", inp[f"db{n}"], inp["qu"], 7, m, "float32")
            for n in (509, 512) for m in ("cosine", "l2")]
    small = _norm(inp["db512"][:10])
    runs += [("sep_bf16", inp["sep_db"], inp["sep_qu"], 3, "cosine", "bfloat16"),
             ("sep_f32", inp["sep_db"], inp["sep_qu"], 3, "cosine", "float32"),
             ("clamp", small, small[:2], 14, "cosine", "float32")]
    for name, db, qu, k, method, sd in runs:
        refs[f"{name}_s"], refs[f"{name}_i"] = jax_dist.top_k_search_sharded(
            db, qu, k, mesh, method, score_dtype=sd)
    refs["resident_s"], refs["resident_i"] = refs["db509_cosine_s"], refs["db509_cosine_i"]
    return refs


def _compressed_cases():
    """The JAX indexes of the JAX package's sharded-engine tests (fit once):
    [(name, kind, index, queries, search kwargs)]."""
    rng = np.random.default_rng(11)
    cases = []
    db = _norm(rng.standard_normal((1003, 32)).astype(np.float32))
    pqi = jax_pq.pq_fit(db, 8, method="cosine")
    cases.append(("pq", "pq", pqi, db[rng.choice(1003, 16, replace=False)], dict(k=5)))
    for scan in ("tables", "decode"):
        cases.append((f"pq_{scan}", "pq", pqi, db[:4], dict(k=5, scan=scan)))
    lam = (1.0 + np.arange(32, dtype=np.float32)) ** -0.75
    odb = _norm(rng.standard_normal((600, 32)).astype(np.float32) * lam)
    cases.append(("pq_opq", "pq", jax_pq.pq_fit(odb, 8, method="cosine", opq_iters=3),
                  odb[:8], dict(k=5)))
    # the pad rows of the last shard decode to codeword 0, which would win
    cb = np.zeros((1, 4, 8), np.float32)
    cb[0, 0, 0], cb[0, 1, 0], cb[0, 2, 0] = 10.0, 5.0, 1.0
    codes = np.full((17, 1), 2, np.uint8)
    codes[16, 0] = 1
    qu = np.zeros((1, 8), np.float32)
    qu[0, 0] = 1.0
    cases.append(("pq_pad", "pq", jax_pq.PQIndex(jax.numpy.asarray(cb),
                                                 jax.numpy.asarray(codes), method="cosine"),
                  qu, dict(k=1)))
    for method in ("cosine", "l2"):
        x = rng.standard_normal((1500, 32)).astype(np.float32)
        x = _norm(x) if method == "cosine" else x
        index = jax_ivf.ivf_fit(x, 13, method=method, bucket_factor=0.9)
        for n_probe in ((4, 13) if method == "cosine" else (6,)):
            cases.append((f"ivf_{method}_{n_probe}", "ivf", index,
                          x[rng.choice(1500, 12, replace=False)], dict(k=5, n_probe=n_probe)))
    x = _norm(rng.standard_normal((800, 32)).astype(np.float32))
    qu = x[:10] + 0.01 * rng.standard_normal((10, 32)).astype(np.float32)
    cases.append(("ivf_full", "ivf", jax_ivf.ivf_fit(x, 8, method="cosine", bucket_factor=0.9),
                  qu, dict(k=5, n_probe=8, exact=np.asarray(jax_top_k_search(x, qu, 5)[1]))))
    x = _norm(rng.standard_normal((2000, 32)).astype(np.float32))
    index = jax_ivf_pq.ivf_pq_fit(x, 16, m=8, method="cosine", bucket_factor=0.8)
    assert index.overflow_codes.shape[0] > 0
    for n_probe in (4, 16):
        cases.append((f"ivfpq_{n_probe}", "ivf_pq", index, x[rng.choice(2000, 12, replace=False)],
                      dict(k=5, n_probe=n_probe)))
    x = rng.standard_normal((1500, 32)).astype(np.float32)
    cases.append(("ivfpq_l2", "ivf_pq", jax_ivf_pq.ivf_pq_fit(x, 13, m=8, method="l2"), x[:10],
                  dict(k=5, n_probe=6)))
    cases.append(("ivfpq_opq", "ivf_pq", jax_ivf_pq.ivf_pq_fit(odb, 8, m=8, method="cosine",
                                                               opq_iters=3),
                  odb[:6], dict(k=5, n_probe=8)))
    # corners: k at the shortlist clamp, n_probe past the cells, few rows
    for trial in range(4):
        n = int(rng.integers(9, 400))
        x = _norm(rng.standard_normal((n, 16)).astype(np.float32))
        qu = x[rng.choice(n, min(5, n), replace=False)]
        k = int(rng.integers(1, 8))
        cells = int(rng.integers(1, max(2, n // 8)))
        n_probe = int(rng.integers(1, cells + 3))
        bf = float(rng.choice([0.8, 2.0]))
        cases += [
            (f"sweep{trial}_pq", "pq", jax_pq.pq_fit(x, 4, n_codes=min(64, n), method="cosine"),
             qu, dict(k=k)),
            (f"sweep{trial}_ivf", "ivf", jax_ivf.ivf_fit(x, cells, method="cosine",
                                                         bucket_factor=bf),
             qu, dict(k=k, n_probe=n_probe)),
            (f"sweep{trial}_ivfpq", "ivf_pq",
             jax_ivf_pq.ivf_pq_fit(x, cells, m=4, n_codes=min(64, n), method="cosine",
                                   bucket_factor=bf), qu, dict(k=k, n_probe=n_probe))]
    # the recall wrapper, every engine, a prebuilt index for the compressed ones
    x = rng.standard_normal((600, 32)).astype(np.float32)
    qu = x[:10] + 0.01 * rng.standard_normal((10, 32)).astype(np.float32)
    xn = _norm(x)
    for engine, index in (("device", None), ("pq", jax_pq.pq_fit(xn, 8, method="cosine")),
                          ("ivf", jax_ivf.ivf_fit(xn, method="cosine")),
                          ("ivf_pq", jax_ivf_pq.ivf_pq_fit(xn, m=8, method="cosine"))):
        cases.append((f"recall_{engine}", f"recall_{engine}", index, qu, dict(db=x)))
    return cases


_SAVE = {"pq": jax_pq.save_pq, "ivf": jax_ivf.save_ivf, "ivf_pq": jax_ivf_pq.save_ivf_pq}


def _compressed_refs(cases, given, mesh):
    """The cases saved for the ranks (``given/compressed.json``) and the
    JAX sharded engines' results on them."""
    entries, refs = [], {}
    for name, kind, index, qu, kw in cases:
        np.save(given / f"{name}_qu.npy", qu)
        if kind.startswith("recall_"):
            engine = kind[len("recall_"):]
            if index is not None:
                _SAVE[engine](index, str(given / f"{name}.npz"))
            np.save(given / f"{name}_db.npy", kw["db"])
            np.save(given / f"{name}_gt.npy", np.arange(len(qu)))
            gt = [np.array([i]) for i in range(len(qu))]
            d, i, rec = jax_dist.get_top_k_recall_sharded([1, 5], kw["db"], qu, gt, mesh,
                                                          engine=engine, index=index)
            refs[f"{name}_s"], refs[f"{name}_i"] = d, i
            refs[f"{name}_recall"] = np.array([rec[1], rec[5]])
            entries.append(dict(name=name, kind=kind, n_probe=8))
            continue
        _SAVE[kind](index, str(given / f"{name}.npz"))
        search = {"pq": jax_dist.pq_search_sharded, "ivf": jax_dist.ivf_search_sharded,
                  "ivf_pq": jax_dist.ivf_pq_search_sharded}[kind]
        opts = {o: kw[o] for o in ("n_probe", "scan") if o in kw}
        refs[f"{name}_s"], refs[f"{name}_i"] = search(index, qu, kw["k"], mesh, **opts)
        if "exact" in kw:
            refs[f"{name}_exact_i"] = kw["exact"]
        entries.append(dict(name=name, kind=kind, k=kw["k"], **opts))
    (given / "compressed.json").write_text(json.dumps(entries))
    return refs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: (port results {case: {name: array}}, JAX results)}."""
    out, cases = {}, _compressed_cases()
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"mesh{world}")
        given = d / "given"
        given.mkdir()
        mesh = jax_get_mesh(n_data=world, n_model=1)
        refs = {"kmeans": _kmeans_refs(given, mesh), "search": _search_refs(mesh),
                "compressed": _compressed_refs(cases, given, mesh)}
        mesh_checks.launch(d, world, "gloo", "cpu", "small",
                           ["kmeans", "search", "compressed", "serve"], timeout=240)
        out[world] = ({c: mesh_checks.results(d, c) for c in refs.keys() | {"serve"}}, refs)
    return out


def _names(case):
    return {"kmeans": ["cos_sharded", "euc_sharded"],
            "search": ["db509_cosine", "db509_l2", "db512_cosine", "db512_l2", "sep_f32",
                       "clamp", "resident"]}[case]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("tag", _names("kmeans"))
def test_kmeans_fit_sharded_matches_jax(runs, world, tag):
    """Sharded Lloyd k-means from the JAX draw's rows: centers within
    1e-4 (even and uneven shards), and within 1e-4 of ``kmeans_fit``."""
    got, refs = runs[world]
    np.testing.assert_allclose(got["kmeans"][tag], refs["kmeans"][tag], atol=1e-4)
    single = got["kmeans"][tag.replace("sharded", "single")]
    np.testing.assert_allclose(got["kmeans"][tag], single, atol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", _names("search"))
def test_top_k_search_sharded_matches_jax(runs, world, name):
    """Exact sharded search, cosine and l2, even and uneven shards, a
    resident pre-padded shard, k past the rows: ids equal, scores within
    1e-5 (l2 1e-4), and equal to the port's single-device search."""
    got, refs = runs[world]
    g, r = got["search"], refs["search"]
    np.testing.assert_array_equal(g[f"{name}_i"], r[f"{name}_i"])
    # the separated rows score ~700: float32 rounding there is ~1e-4
    np.testing.assert_allclose(g[f"{name}_s"], r[f"{name}_s"], rtol=1e-6,
                               atol=1e-4 if "l2" in name else 1e-5)
    if name == "clamp":
        assert g["clamp_i"].shape == (2, 10) and (g["clamp_i"] < 10).all()
    if f"{name}_single_i" in g:   # products of other shapes: float32 rounding apart
        np.testing.assert_array_equal(g[f"{name}_i"], g[f"{name}_single_i"])
        np.testing.assert_allclose(g[f"{name}_s"], g[f"{name}_single_s"], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_top_k_search_sharded_bf16_scores(runs, world):
    """bf16 scoring: the separated rows' ids equal JAX's and the f32
    ranking's top 1; scores within 2^-8 of their size."""
    got, refs = runs[world]
    g, r = got["search"], refs["search"]
    np.testing.assert_array_equal(g["sep_bf16_i"], r["sep_bf16_i"])
    np.testing.assert_array_equal(g["sep_bf16_i"][:, 0], g["sep_f32_i"][:, 0])
    np.testing.assert_allclose(g["sep_bf16_s"], r["sep_bf16_s"],
                               atol=2 ** -8 * np.abs(r["sep_bf16_s"]).max())


def _compressed_names():
    names = (["pq", "pq_tables", "pq_decode", "pq_opq", "pq_pad", "ivf_cosine_4",
              "ivf_cosine_13", "ivf_l2_6", "ivf_full", "ivfpq_4", "ivfpq_16", "ivfpq_l2",
              "ivfpq_opq"]
             + [f"sweep{t}_{k}" for t in range(4) for k in ("pq", "ivf", "ivfpq")]
             + [f"recall_{e}" for e in ("device", "pq", "ivf", "ivf_pq")])
    return names


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", _compressed_names())
def test_compressed_sharded_engines_match_jax(runs, world, name):
    """pq / ivf / ivf_pq sharded searches on the JAX package's indexes
    (OPQ, both PQ scans, pad rows that must not evict, partial and full
    probe, l2, a corner sweep) and the recall wrapper of every engine:
    ids equal, scores within 1e-5 (l2 1e-4), recalls equal."""
    got, refs = runs[world]
    g, r = got["compressed"], refs["compressed"]
    np.testing.assert_array_equal(g[f"{name}_i"], np.asarray(r[f"{name}_i"]))
    np.testing.assert_allclose(g[f"{name}_s"], np.asarray(r[f"{name}_s"]),
                               atol=1e-4 if "l2" in name else 1e-5)
    if name == "pq_pad":
        assert g["pq_pad_i"][0, 0] == 16 and g["pq_pad_s"][0, 0] == 5.0
    if name == "ivf_full":
        np.testing.assert_array_equal(g["ivf_full_i"], r["ivf_full_exact_i"])
    if name.startswith("recall_"):
        np.testing.assert_allclose(g[f"{name}_recall"], r[f"{name}_recall"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("engine", ["device", "pq", "ivf"])
def test_serve_mesh_replies_equal_the_single_process_daemon(runs, world, engine):
    """``serve --mesh N`` on N ranks (rank 0 serves, the others follow):
    each /search reply equals the daemon's in one process, and the engine
    name gains ``+meshN``."""
    got, _ = runs[world]
    g = got["serve"]
    np.testing.assert_array_equal(g[f"{engine}_ids"], g[f"{engine}_single_ids"])
    np.testing.assert_array_equal(g[f"{engine}_scores"], g[f"{engine}_single_scores"])
    assert str(g[f"{engine}_engine"]) == f"{engine}+mesh{world}"


def test_serve_mesh_without_a_world_raises_with_the_launch_line():
    """``--mesh 2`` in a plain process: no world of 2 ranks, so the daemon
    raises naming the launch it needs, before it builds anything."""
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        port_cli.main(["serve", "--vocab-dir", ".", "--mesh", "2"])


def test_serve_mesh_one_runs_in_a_plain_process(tmp_path):
    """``--mesh 1`` makes a group of this process alone: the daemon serves
    as the unsharded one does, its engine named ``device+mesh1``."""
    import threading
    import urllib.request

    import torch.distributed as dist

    from anyloc_tpu_torch.ops.vlad import VLAD
    from anyloc_tpu_torch.pipelines import serve_http

    rng = np.random.default_rng(12)
    VLAD(4, cache_dir=str(tmp_path / "vocab")).fit(
        rng.standard_normal((120, 384)).astype(np.float32))
    np.save(tmp_path / "db.npy", rng.standard_normal((30, 4 * 384)).astype(np.float32))
    from PIL import Image
    import io

    buf = io.BytesIO()
    Image.fromarray((rng.random((70, 84, 3)) * 255).astype(np.uint8)).save(buf, "PNG")
    args = dict(model="dinov2_vits14", layer=1, facet="value", num_clusters=4,
                vocab_dir=str(tmp_path / "vocab"), checkpoint=None, quant=None,
                max_img_size=84, db=str(tmp_path / "db.npy"), ivf=False, n_probe=4,
                host="127.0.0.1", port=0)

    def reply(**kw):
        server = serve_http.build_server(argparse.Namespace(**args, **kw), device="cpu")
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            req = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}"
                                         "/search?k=4", data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=60) as f:
                return json.loads(f.read()), server.service.engine
        finally:
            server.shutdown()
            server.server_close()

    try:
        got, engine = reply(mesh=1)
        assert dist.is_initialized() and dist.get_world_size() == 1
        want, _ = reply(mesh=0)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert engine == "device+mesh1"
    assert got == want


def test_serve_mesh_stops_when_a_collective_fails(tmp_path, monkeypatch):
    """A sharded search whose collectives fail part-way (planted: the
    query broadcast after the header raises) stops the ``--mesh`` daemon
    rather than serve on a group whose ranks are out of step: the request
    gets the error, the server's loop ends, no stop header goes out, and
    ``main`` raises (a nonzero exit) with the group destroyed."""
    import socket
    import threading
    import time
    import urllib.error
    import urllib.request

    import torch.distributed as dist

    from anyloc_tpu_torch.ops.vlad import VLAD
    from anyloc_tpu_torch.parallel import mesh as port_mesh
    from anyloc_tpu_torch.pipelines import serve_http

    rng = np.random.default_rng(13)
    VLAD(4, cache_dir=str(tmp_path / "vocab")).fit(
        rng.standard_normal((120, 384)).astype(np.float32))
    np.save(tmp_path / "db.npy", rng.standard_normal((30, 4 * 384)).astype(np.float32))
    from PIL import Image
    import io

    buf = io.BytesIO()
    Image.fromarray((rng.random((70, 84, 3)) * 255).astype(np.uint8)).save(buf, "PNG")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    argv = ["--model", "dinov2_vits14", "--layer", "1", "--num-clusters", "4",
            "--vocab-dir", str(tmp_path / "vocab"), "--max-img-size", "84",
            "--db", str(tmp_path / "db.npy"), "--mesh", "1", "--port", str(port)]
    armed, sent = threading.Event(), []
    real = port_mesh.broadcast

    def planted(t, mesh, axis, src=0):
        if armed.is_set():
            sent.append(tuple(t.shape))
            if len(sent) == 2:
                raise RuntimeError("planted: the query broadcast failed")
        return real(t, mesh, axis, src)

    monkeypatch.setattr(port_mesh, "broadcast", planted)
    ended = {}

    def run():
        try:
            serve_http.main(argv, device="cpu")
        except BaseException as e:   # noqa: BLE001 - the test reads it
            ended["error"] = e

    daemon = threading.Thread(target=run, daemon=True)
    daemon.start()
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                with urllib.request.urlopen(f"{url}/health", timeout=5) as f:
                    assert json.loads(f.read())["engine"] == "device+mesh1"
                break
            except urllib.error.URLError:
                assert daemon.is_alive() and time.monotonic() < deadline, ended
                time.sleep(0.2)
        armed.set()
        req = urllib.request.Request(f"{url}/search?k=4", data=buf.getvalue(), method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=60)
        assert err.value.code == 500 and "planted" in err.value.read().decode()
        daemon.join(60)
        assert not daemon.is_alive(), "the daemon kept serving after the failed search"
        assert isinstance(ended.get("error"), RuntimeError)
        assert "planted" in str(ended["error"].__cause__)
        # the header and the failed query broadcast: no stop header after them
        assert len(sent) == 2
        assert not dist.is_initialized()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
