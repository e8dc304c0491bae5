"""The port's retrieval engines against the JAX package's, on the CPU.

Inputs come from numpy seeds and go to both packages. The k-means starts
of every fit are shared: the JAX package draws them with ``jax.random``,
which torch cannot reproduce (ROADMAP F2), so each test computes the JAX
draw and hands the same rows to the port. Indexes cross both ways through
their ``.npz`` files. Tolerances are stated per test; rankings are
compared wherever neighbouring scores are further apart than the
tolerance (ties that are exact in both packages go to the lower id in
both, and are compared too).
"""

import numpy as np
import pytest
import torch

import jax

from anyloc_tpu import native as jax_native
from anyloc_tpu.ops import ivf as jax_ivf
from anyloc_tpu.ops import ivf_pq as jax_ivf_pq
from anyloc_tpu.ops import kmeans as jax_kmeans
from anyloc_tpu.ops import pq as jax_pq
from anyloc_tpu.ops import retrieval as jax_retrieval

from anyloc_tpu_torch import native as port_native
from anyloc_tpu_torch.ops import ivf as port_ivf
from anyloc_tpu_torch.ops import ivf_pq as port_ivf_pq
from anyloc_tpu_torch.ops import kmeans as port_kmeans
from anyloc_tpu_torch.ops import pq as port_pq
from anyloc_tpu_torch.ops import retrieval as port_retrieval

torch.set_num_threads(2)

N, D, Q = 1200, 32, 24
M, C = 8, 16                      # PQ: 8 subspaces of 4, 16 codewords


def _clustered(n, d, seed, centers=24, spread=0.35):
    """Rows around a few random centers (the ``clustered`` distribution of
    bench_retrieval.py): k-means labels have margins, so both packages'
    fits take the same steps."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d)) * 2.0
    return (c[rng.integers(0, centers, n)] + spread * rng.standard_normal((n, d))).astype(
        np.float32)


@pytest.fixture(scope="module")
def data():
    db = _clustered(N, D, 0)
    qu = _clustered(Q, D, 1)
    # planted ties: rows 7, 400 and 1100 equal, and query 0 is that row
    db[400] = db[1100] = db[7]
    qu[0] = db[7]
    return db, qu


def _assert_same_ranking(ps, pi, js, ji, tol):
    """Scores within ``tol``, and the same ids: position by position where
    a score is more than ``tol`` from its neighbours, as a set within a
    group of scores that close (their order may differ by the sums'
    rounding), and not at all in a group that reaches past the port's k
    columns (the jax side holds one more column, to see that margin)."""
    ps, pi, js, ji = (np.asarray(a) for a in (ps, pi, js, ji))
    k = ps.shape[1]
    np.testing.assert_allclose(ps, js[:, :k], atol=tol, rtol=0)
    for r in range(ps.shape[0]):
        start = 0
        for j in range(1, js.shape[1] + 1):
            if j < js.shape[1] and abs(js[r, j] - js[r, j - 1]) <= tol:
                continue
            if j <= k or js.shape[1] == k:       # the group [start, j) lies within k
                end = min(j, k)
                assert sorted(pi[r, start:end]) == sorted(ji[r, start:end]), (r, start, end)
            start = j


# ---------------------------------------------------------------- blocked


@pytest.mark.parametrize("method", ["cosine", "l2"])
@pytest.mark.parametrize("stream_dtype", ["float32", "bfloat16", "int8"])
def test_blocked_matches_jax(data, stream_dtype, method):
    """Five shards (db_block 250) and two query blocks, unit rows and
    queries (as get_top_k_recall passes them). float32: 1e-4. The narrow
    streams round the queries and the dequantized int8 rows to bf16 in the
    port, as on the TPU; the JAX package run on the CPU keeps those values
    in f32 (XLA drops the bf16 round trips), so they are held to 2^-8, one
    bf16 step at 1."""
    db, qu = data
    qu = qu / np.linalg.norm(qu, axis=1, keepdims=True)
    k = 10
    kw = dict(query_block=16, db_block=250, stream_dtype=stream_dtype, normalize_rows=True)
    js, ji = jax_retrieval.top_k_search_blocked(db, qu, k + 1, method, **kw)
    ps, pi = port_retrieval.top_k_search_blocked(db, qu, k, method, device="cpu", **kw)
    assert ps.dtype == np.float32 and pi.dtype == np.int64 and ps.shape == (Q, k)
    _assert_same_ranking(ps, pi, js, ji, 1e-4 if stream_dtype == "float32" else 2 ** -8)
    assert pi[0, :3].tolist() == [7, 400, 1100]      # the planted tie, lower id first


def test_blocked_reads_a_read_only_memmap(data, tmp_path):
    db, qu = data
    path = tmp_path / "db.f32"
    db.tofile(path)
    mm = np.memmap(path, np.float32, "r", shape=db.shape)
    ps, pi = port_retrieval.top_k_search_blocked(mm, qu, 5, db_block=300, device="cpu")
    ws, wi = port_retrieval.top_k_search_blocked(db, qu, 5, db_block=N, device="cpu")
    np.testing.assert_array_equal(pi, wi)
    np.testing.assert_allclose(ps, ws, atol=1e-6)


def test_stream_to_device_keeps_order_and_none():
    shards = [(torch.full((2,), float(i)), None) for i in range(5)]
    got = list(port_retrieval.stream_to_device(iter(shards), torch.device("cpu")))
    assert [g[0][0].item() for g in got] == [0, 1, 2, 3, 4]
    assert all(g[1] is None for g in got)


# ---------------------------------------------------------------- native


def test_native_library_lands_in_the_port_build_dir():
    lib = port_native.nnsearch_library_path()
    assert port_native.available()
    assert lib.exists() and lib.parent.name == "native" and lib.parent.parent.name == "build"
    assert lib.parent != port_native.NN_SRC.parent          # never native/


@pytest.mark.parametrize("method", ["cosine", "l2"])
def test_native_nn_search_matches_jax(data, method):
    db, qu = data
    ps, pi = port_native.nn_search(db, qu, 10, method)
    js, ji = jax_native.nn_search(db, qu, 10, method)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(ps, js)


@pytest.mark.parametrize("method", ["cosine", "l2"])
def test_native_ivf_build_and_search_match_jax(data, method):
    """The host build is the same numpy on both sides: equal bit for bit;
    the search is the same library source."""
    db, qu = data
    pc, (pptr, prows) = port_native.ivf_build(db, 20, n_iters=5, seed=3, method=method)
    jc, (jptr, jrows) = jax_native.ivf_build(db, 20, n_iters=5, seed=3, method=method)
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(pptr, jptr)
    np.testing.assert_array_equal(prows, jrows)
    ps, pi = port_native.ivf_search(db, qu, 7, pc, (pptr, prows), n_probe=4, method=method)
    js, ji = jax_native.ivf_search(db, qu, 7, jc, (jptr, jrows), n_probe=4, method=method)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(ps, js)
    # full probe is exact search
    fs, fi = port_native.ivf_search(db, qu, 7, pc, (pptr, prows), n_probe=20, method=method)
    es, ei = port_native.nn_search(db, qu, 7, method)
    np.testing.assert_array_equal(fi, ei)


def test_native_recall_at_k_matches_jax(data):
    db, qu = data
    _, idx = port_native.nn_search(db, qu, 10)
    gt = [np.array([i, 7]) if i % 2 else np.array([], np.int64) for i in range(Q)]
    for sub in (1, 2):
        got = port_native.recall_at_k(idx, gt, [1, 5, 10], sub_sample_db=sub)
        assert got == jax_native.recall_at_k(idx, gt, [1, 5, 10], sub_sample_db=sub)


# ---------------------------------------------------------------- the indexes


def _choice(key, n, k):
    return np.asarray(jax.random.choice(key, n, shape=(k,), replace=False))


def _code_rows(seed, s):
    keys = jax.random.split(jax.random.PRNGKey(seed), M)
    return np.asarray(jax.vmap(lambda kk: jax.random.choice(kk, s, (C,), replace=False))(keys))


def _jax_index(kind, method, db, opq=0):
    if kind == "ivf":
        return jax_ivf.ivf_fit(db, 16, method=method, max_iters=6, seed=1)
    if kind == "pq":
        return jax_pq.pq_fit(db, M, n_codes=C, method=method, max_iters=6, seed=1,
                             opq_iters=opq)
    return jax_ivf_pq.ivf_pq_fit(db, 12, m=M, n_codes=C, method=method, coarse_iters=6,
                                 pq_iters=6, seed=1, opq_iters=opq, bucket_factor=1.2)


def _port_index(kind, method, db, opq=0):
    """The port's fit from the JAX fit's starts."""
    if kind == "ivf":
        return port_ivf.ivf_fit(db, 16, method=method, max_iters=6, seed=1, device="cpu",
                                init_rows=_choice(jax.random.PRNGKey(1), N, 16))
    if kind == "pq":
        return port_pq.pq_fit(db, M, n_codes=C, method=method, max_iters=6, seed=1,
                              opq_iters=opq, init_rows=_code_rows(1, N), device="cpu")
    return port_ivf_pq.ivf_pq_fit(
        db, 12, m=M, n_codes=C, method=method, coarse_iters=6, pq_iters=6, seed=1,
        opq_iters=opq, bucket_factor=1.2, init_cell_rows=_choice(jax.random.PRNGKey(1), N, 12),
        init_code_rows=_code_rows(2, N), init_opq_rows=_code_rows(1, N), device="cpu")


SAVE = {"ivf": (jax_ivf.save_ivf, port_ivf.load_ivf, port_ivf.save_ivf, jax_ivf.load_ivf),
        "pq": (jax_pq.save_pq, port_pq.load_pq, port_pq.save_pq, jax_pq.load_pq),
        "ivf_pq": (jax_ivf_pq.save_ivf_pq, port_ivf_pq.load_ivf_pq, port_ivf_pq.save_ivf_pq,
                   jax_ivf_pq.load_ivf_pq)}


def _searches(kind):
    """(search kwargs, tolerance) of each way an index is searched: PQ in
    both scans, bf16 scores emulated on both sides (1e-3: bf16 operands
    summed in f32 in other orders)."""
    if kind == "ivf":
        return [(dict(n_probe=4), 1e-4), (dict(n_probe=16), 1e-4)]
    if kind == "pq":
        return [(dict(scan=s, score_dtype=t), 1e-4 if t == "float32" else 1e-3)
                for s in ("tables", "decode") for t in ("float32", "bfloat16")]
    return [(dict(n_probe=n, score_dtype=t), 1e-4 if t == "float32" else 1e-3)
            for n in (3, 12) for t in ("float32", "bfloat16")]


@pytest.mark.parametrize("method", ["cosine", "l2"])
@pytest.mark.parametrize("kind,opq", [("ivf", 0), ("pq", 0), ("pq", 2), ("ivf_pq", 0),
                                      ("ivf_pq", 2)])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_index_crosses_packages_and_searches_alike(data, tmp_path, direction, kind, opq, method):
    """An index saved by one package loads in the other (same keys, same
    dtypes, no pickles) and both search it to the same results (OPQ
    rotations included)."""
    db, qu = data
    jax_save, port_load, port_save, jax_load = SAVE[kind]
    path = str(tmp_path / "index")
    if direction == "jax_to_port":
        jidx = _jax_index(kind, method, db, opq)
        jax_save(jidx, path)
        pidx = port_load(path, device="cpu")
    else:
        pidx = _port_index(kind, method, db, opq)
        port_save(pidx, path)
        jidx = jax_load(path)
    z = np.load(path + ".npz")
    for key in z.files:
        if key not in ("method", "n_rows"):
            np.testing.assert_array_equal(np.asarray(getattr(pidx, key).cpu()),
                                          np.asarray(getattr(jidx, key)), err_msg=key)
    for kw, tol in _searches(kind):
        js, ji = jidx.search(qu, 9, **kw)
        ps, pi = pidx.search(qu, 8, **kw)
        _assert_same_ranking(ps.numpy(), pi.numpy(), js, ji, tol)


@pytest.mark.parametrize("method", ["cosine", "l2"])
@pytest.mark.parametrize("kind", ["ivf", "pq", "ivf_pq"])
def test_fit_from_shared_starts_matches_jax(data, kind, method):
    """Clustered rows and the JAX fit's starts: the port's fit takes the
    same Lloyd steps, so the centroids / codebooks agree within 1e-4 and
    the bucketing (or the codes) equals the JAX package's."""
    db, _ = data
    jidx = _jax_index(kind, method, db)
    pidx = _port_index(kind, method, db)
    if kind == "ivf":
        np.testing.assert_allclose(pidx.cells.numpy(), np.asarray(jidx.cells), atol=1e-4)
        np.testing.assert_array_equal(pidx.bucket_ids.numpy(), np.asarray(jidx.bucket_ids))
        np.testing.assert_array_equal(pidx.overflow_ids.numpy(), np.asarray(jidx.overflow_ids))
        return
    np.testing.assert_allclose(pidx.codebooks.numpy(), np.asarray(jidx.codebooks), atol=1e-4)
    if kind == "pq":
        agree = (pidx.codes.numpy() == np.asarray(jidx.codes)).mean()
    else:
        np.testing.assert_allclose(pidx.cells.numpy(), np.asarray(jidx.cells), atol=1e-4)
        np.testing.assert_array_equal(pidx.bucket_ids.numpy(), np.asarray(jidx.bucket_ids))
        agree = (pidx.codes.numpy() == np.asarray(jidx.codes)).mean()
    assert agree >= 0.999, agree   # a code may flip where two codewords tie within f32


def test_opq_rotation_from_a_shared_start_matches_jax():
    """Three alternations from the JAX start: the rotations agree within
    1e-4 (measured 2e-5). The rows are the clustered draw without the
    planted ties; on that draw with them one k-means label lands on an f32
    near tie in one package and not the other, and the rotation moves by
    1.5e-3 (a flip, not drift)."""
    db = _clustered(N, D, 0)
    rows = _code_rows(5, N)
    want = jax_pq.opq_train(db, M, n_codes=C, opq_iters=3, inner_iters=4, seed=5)
    got = port_pq.opq_train(db, M, n_codes=C, opq_iters=3, inner_iters=4, seed=5,
                            init_rows=rows, device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got @ got.T, np.eye(D), atol=1e-5)


@pytest.mark.parametrize("method", ["cosine", "l2"])
@pytest.mark.parametrize("kind", ["ivf", "pq", "ivf_pq"])
def test_full_probe_is_exact_search(data, kind, method):
    """IVF at full probe is exact search over the rows; PQ with f32 scores
    is exact search over its decode(); IVF-PQ at full probe is exact
    search over its reconstructions (the exact engine: 1e-4)."""
    db, qu = data
    idx = _port_index(kind, method, db)
    if kind == "ivf":
        got_s, got_i = idx.search(qu, 10, n_probe=idx.n_cells)
        rows = db
    elif kind == "pq":
        got_s, got_i = idx.search(qu, 10)
        rows = idx.decode()
    else:
        got_s, got_i = idx.search(qu, 10, n_probe=idx.n_cells)
        rows = idx.decode()
    want_s, want_i = port_retrieval.top_k_search(torch.from_numpy(rows), torch.from_numpy(qu),
                                                 11, method)
    if kind == "pq" and method == "l2":      # PQ scores -|q - x̂|^2 + |q|^2
        got_s = (qu * qu).sum(1, keepdims=True) - got_s.numpy()
    _assert_same_ranking(np.asarray(got_s), got_i.numpy(), want_s.numpy(), want_i.numpy(), 1e-4)


# ---------------------------------------------------------------- get_top_k_recall


@pytest.mark.parametrize("method", ["cosine", "l2"])
@pytest.mark.parametrize("engine", ["device", "blocked", "native", "ivf", "pq", "ivf_pq"])
def test_get_top_k_recall_every_engine_matches_jax(data, tmp_path, engine, method):
    """Every engine with the JAX package's arguments. The compressed
    engines search one index, fitted by the JAX package and loaded by the
    port; PQ's l2 distances come back positive in both."""
    db, qu = data
    gt = [np.array([i % 5, 7]) for i in range(Q)]
    kw = dict(engine=engine, method=method, n_probe=5)
    port_kw = dict(kw)
    if engine in ("ivf", "pq", "ivf_pq"):
        kind = engine
        dbn = db / np.linalg.norm(db, axis=1, keepdims=True)
        jidx = _jax_index(kind, method, dbn)
        SAVE[kind][0](jidx, str(tmp_path / "i"))
        name = {"ivf": "ivf_index", "pq": "pq_index", "ivf_pq": "ivf_pq_index"}[kind]
        kw[name] = jidx
        port_kw[name] = SAVE[kind][1](str(tmp_path / "i"), device="cpu")
    jd, ji, jr = jax_retrieval.get_top_k_recall([1, 5, 10], db, qu, gt, **kw)
    pd, pi, pr = port_retrieval.get_top_k_recall([1, 5, 10], db, qu, gt, device="cpu", **port_kw)
    assert pd.shape == (Q, 10) and pi.shape == (Q, 10)
    if engine == "pq" and method == "l2":
        assert (pd >= -1e-4).all()
    _assert_same_ranking(pd, pi, jd, ji, 1e-4)
    assert pr == jr


@pytest.mark.parametrize("engine", ["ivf", "blocked", "native"])
def test_score_dtype_is_refused_where_the_jax_package_refuses_it(data, engine):
    db, qu = data
    with pytest.raises(ValueError, match="score_dtype"):
        port_retrieval.get_top_k_recall([1], db, qu, [np.array([0])] * Q, engine=engine,
                                        score_dtype="bfloat16", device="cpu")


def test_compressed_engines_fit_when_given_no_index(data):
    """No prebuilt index: the port fits one (its own draw of the starts)
    and answers; recall against the exact engine's top-1 is high on
    clustered rows."""
    db, qu = data
    _, exact, _ = port_retrieval.get_top_k_recall([1], db, qu, [np.array([0])] * Q,
                                                  device="cpu")
    gt = [exact[i, :1] for i in range(Q)]
    for engine, kw in (("ivf", {}), ("pq", dict(pq_m=8)), ("ivf_pq", dict(pq_m=8))):
        _, idx, rec = port_retrieval.get_top_k_recall([1, 10], db, qu, gt, engine=engine,
                                                      n_probe=8, device="cpu", **kw)
        assert idx.shape == (Q, 10) and rec[10] >= 0.5, (engine, rec)


def test_the_engines_run_on_the_card_unless_asked(data):
    if torch.cuda.is_available():
        pytest.skip("a card is present: None means it")
    db, qu = data
    for engine in ("device", "blocked", "ivf", "pq", "ivf_pq"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_retrieval.get_top_k_recall([1], db, qu, [np.array([0])] * Q, engine=engine,
                                            pq_m=8)


# ---------------------------------------------------------------- kmeans_fit_streamed


@pytest.mark.parametrize("mode", ["cosine", "euclidean"])
def test_kmeans_fit_streamed_matches_jax_from_shared_init(data, tmp_path, mode):
    """Host rows (a memmap) streamed in 300-row shards against the JAX
    streamed fit from the same start rows: centers within 1e-4, labels
    equal."""
    db, _ = data
    path = tmp_path / "descs.f32"
    db.tofile(path)
    mm = np.memmap(path, np.float32, "r", shape=db.shape)
    key = jax.random.PRNGKey(4)
    jc, jl = jax_kmeans.kmeans_fit_streamed(key, db, 10, mode, max_iters=8, shard_rows=300)
    init = db[_choice(key, N, 10)]
    pc, pl = port_kmeans.kmeans_fit_streamed(mm, 10, mode, max_iters=8, shard_rows=300,
                                             init_centers=init, device="cpu")
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=1e-4)
    np.testing.assert_array_equal(pl, np.asarray(jl))
    # and the in-memory fit from the same start agrees with the streamed one
    fc, fl = port_kmeans.kmeans_fit(torch.from_numpy(db), 10, mode, 8,
                                    init_centers=torch.from_numpy(init))
    np.testing.assert_allclose(fc.numpy(), pc.numpy(), atol=1e-4)
    np.testing.assert_array_equal(fl.numpy(), pl)


# ---------------------------------------------------------------- tools/bench_retrieval


def test_bench_retrieval_needs_a_card(monkeypatch):
    from anyloc_tpu_torch.tools import bench_retrieval

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench_retrieval.run(n_db=100, n_qu=4, dim=8)
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench_retrieval.main(["--n-db", "100", "--dim", "8"])


def test_bench_retrieval_takes_the_root_scripts_flags(monkeypatch):
    from anyloc_tpu_torch.tools import bench_retrieval

    seen = []
    monkeypatch.setattr(bench_retrieval, "run", lambda *a: seen.append(a))
    bench_retrieval.main(["--n-db", "5000", "--dim", "512", "--engines", "pq", "ivf_pq",
                          "--pq-m", "32", "--n-probe", "4", "--db-dist", "pca_spectrum",
                          "--opq-iters", "2", "--pq-scan", "decode", "--stream-dtype", "int8",
                          "--query-batch", "8", "--query-noise", "0.1"])
    (a,) = seen
    assert a[:4] == (5000, 1000, 512, 20) and list(a[4]) == ["pq", "ivf_pq"]
    assert a[6:9] == (4, "int8", 32) and a[11:16] == ("decode", 8, "pca_spectrum", 2, 0.1)


@pytest.mark.parametrize("dist", ["uniform", "clustered", "pca_spectrum"])
def test_bench_retrieval_databases(dist):
    """Unit rows from a seed, reproducible; clustered rows sit near their
    component (a row's nearest other row is far closer than at random),
    pca_spectrum's variance decays along the dims."""
    from anyloc_tpu_torch.tools.bench_retrieval import make_db

    db = make_db(2000, 64, dist, seed=3, device="cpu")
    assert tuple(db.shape) == (2000, 64)
    torch.testing.assert_close(db.norm(dim=1), torch.ones(2000))
    torch.testing.assert_close(make_db(2000, 64, dist, seed=3, device="cpu"), db, atol=0, rtol=0)
    sims = db[:200] @ db.T
    sims[torch.arange(200), torch.arange(200)] = -1
    nearest = sims.max(1).values.mean().item()
    if dist == "clustered":
        assert nearest > 0.9, nearest
    else:
        assert nearest < 0.8, nearest
    var = db.var(0)
    if dist == "pca_spectrum":
        assert var[:8].mean() > 3 * var[-8:].mean()
