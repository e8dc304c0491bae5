"""The port's other pipelines against the JAX package's, on the CPU in
float32: ``gem``, ``gp`` and ``global-vpr`` through both command lines,
the demo, ``extras.py`` and ``sweeps.py``.

Weights: one ViT-S/14 state dict written with ``torch.save`` from a numpy
seed, loaded natively by the port and through ``convert_dinov2`` by the
JAX package. The JAX demo has no dtype flag and builds a bf16 trunk, whose
bf16 round trips the JAX package on the CPU keeps in float32; both demos
are given float32 trunks here (``_float32_demos``), so the comparisons sit
at the plain path's float32 bound: 1e-4 relative. Every k-means starts
from the JAX package's ``jax.random`` draw, passed as ``init_centers``
(F2).
"""

import csv
import functools
import glob
import json
import pathlib
import re

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from anyloc_tpu import cli as jax_cli
from anyloc_tpu import sweeps as jax_sweeps
from anyloc_tpu.config import parse_args as jax_parse_args
from anyloc_tpu.data import synthetic as jax_synthetic
from anyloc_tpu.data.base import VPRDataset as JaxVPRDataset
from anyloc_tpu.data.registry import get_dataset as jax_get_dataset
from anyloc_tpu.models import extractor as jax_extractor
from anyloc_tpu.pipelines import demo as jax_demo
from anyloc_tpu.pipelines import extras as jax_extras
from anyloc_tpu.pipelines.engine import DescriptorEngine as JaxEngine
from anyloc_tpu.pipelines.global_vpr import ClsEngine as JaxClsEngine
from anyloc_tpu.ops.gem import gem_pool as jax_gem_pool
from anyloc_tpu.ops.pooling import global_max_pool as jax_max_pool

import anyloc_tpu_torch as port
from anyloc_tpu_torch import cli, sweeps
from anyloc_tpu_torch.models import extractor as port_extractor
from anyloc_tpu_torch.models.dinov2 import dinov2_config, init_params
from anyloc_tpu_torch.ops.gem import gem_pool
from anyloc_tpu_torch.ops.pooling import global_max_pool
from anyloc_tpu_torch.pipelines import demo, extras
from anyloc_tpu_torch.pipelines.global_vpr import ClsEngine

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A 17places (vpr_bench) tree and a ViT-S/14 checkpoint."""
    root = tmp_path_factory.mktemp("pipes")
    jax_synthetic.build_vpr_bench(str(root), n_db=10, n_q=5, seed=3, size=(60, 80))
    shapes = {k: tuple(v.shape) for k, v in init_params(
        dinov2_config("dinov2_vits14", dtype=torch.float32), n_blocks=12).items()}
    shapes.update({"norm.weight": (384,), "norm.bias": (384,)})
    rng = np.random.default_rng(0)
    sd = {}
    for k, s in sorted(shapes.items()):
        scale = np.prod(s[1:]) ** -0.5 if len(s) > 1 else 0.1
        sd[k] = torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32))
    torch.save(sd, root / "vits14.pth")
    return root


@pytest.fixture
def pil_decode(monkeypatch):
    """PIL on both sides (the native pipe rounds floats apart by 2e-5)."""
    monkeypatch.setattr(port.VPRDataset, "use_native_loader", False)
    monkeypatch.setattr(JaxVPRDataset, "use_native_loader", False)


def _args(root, out, exp, layer="1"):
    return ["--prog.data-vg-dir", str(root), "--prog.vg-dataset-name", "17places",
            "--prog.cache-dir", str(root / out), "--exp-id", exp,
            "--extractor.model-type", "dinov2_vits14", "--extractor.desc-layer", layer,
            "--extractor.dtype", "float32", "--extractor.checkpoint", str(root / "vits14.pth"),
            "--extractor.batch-size", "4", "--bd-args.resize", "56", "56",
            "--top-k-vals", "1", "3", "5"]


def _saved(root, out, exp):
    (path,) = glob.glob(str(root / out / "experiments" / exp / "results_*.json"))
    res = json.loads(pathlib.Path(path).read_text())
    res.pop("Timestamp")
    return res


@pytest.mark.parametrize("cmd,agg", [("gem", "GeM"), ("gp", "GP-max"), ("global-vpr", "CLS")])
def test_cli_matches_jax(root, pil_decode, cmd, agg):
    """The saved results JSONs equal but ``Timestamp``: recalls exactly."""
    assert cli.main([cmd, *_args(root, "port", cmd)], device="cpu") == 0
    assert jax_cli.main([cmd, *_args(root, "jax", cmd)]) == 0
    got, want = _saved(root, "port", cmd), _saved(root, "jax", cmd)
    assert got == want
    assert got["Agg-Method"] == agg and got["Num-DB"] == "10" and got["Num-QU"] == "5"
    assert got["VLAD-Dim"] == "384"


@pytest.mark.parametrize("pool", ["gem", "gp"])
def test_pooled_descriptors_match_jax(root, pil_decode, pool):
    """Below the JSON: GeM and max-pooled descriptors pooled on the device
    inside each batch, under the JAX package's cache keys' aggregation."""
    ds = port.get_dataset("17places", str(root), img_size=(56, 56))
    jds = jax_get_dataset("17places", str(root), img_size=(56, 56))
    eng = port.DescriptorEngine("dinov2_vits14", 1, "value", str(root / "vits14.pth"),
                                "float32", 4, device="cpu")
    jeng = JaxEngine("dinov2_vits14", 1, "value", str(root / "vits14.pth"), "float32", 4)
    fn, jfn = ((gem_pool, jax_gem_pool) if pool == "gem" else (global_max_pool, jax_max_pool))
    got = eng.extract_aggregated_dataset(ds, fn, pool, "all", verbose=False)
    want = np.asarray(jeng.extract_aggregated_dataset(jds, jfn, pool, "all", verbose=False))
    assert got.shape == (15, 384)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_cls_engine_matches_jax(root, pil_decode):
    """The whole trunk's post-norm CLS, the checkpoint loaded natively."""
    ds = port.get_dataset("17places", str(root), img_size=(56, 56))
    jds = jax_get_dataset("17places", str(root), img_size=(56, 56))
    got = ClsEngine("dinov2_vits14", str(root / "vits14.pth"), "float32", 4,
                    device="cpu").extract_dataset(ds, "all", verbose=False)
    want = JaxClsEngine("dinov2_vits14", str(root / "vits14.pth"), "float32",
                        4).extract_dataset(jds, "all", verbose=False)
    assert got.shape == (15, 384)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_global_vpr_refuses_the_serving_flags(root):
    with pytest.raises(ValueError, match="not supported"):
        cli.main(["global-vpr", *_args(root, "x", "x"), "--extractor.quant", "int8_full"],
                 device="cpu")


def test_pipelines_run_top_k_on_the_engines_device(root, monkeypatch):
    """F11 for the new pipelines: the search runs where the engine runs."""
    from anyloc_tpu_torch.ops import retrieval

    seen = []
    search = retrieval.top_k_search

    def spy(db, qu, k, *a, **kw):
        seen.append((db.device.type, qu.device.type))
        return search(db, qu, k, *a, **kw)

    monkeypatch.setattr(retrieval, "top_k_search", spy)
    for cmd in ("gem", "gp", "global-vpr"):
        assert cli.main([cmd, *_args(root, "dev", cmd)], device="cpu") == 0
    assert seen == [("cpu", "cpu")] * 3


# ------------------------------------------------------------------ demo

@pytest.fixture
def _float32_demos(monkeypatch):
    """Both demos build float32 trunks (neither has a dtype flag)."""
    monkeypatch.setattr(jax_extractor, "DinoV2ExtractFeatures", functools.partial(
        jax_extractor.DinoV2ExtractFeatures, dtype=jnp.float32))
    monkeypatch.setattr(port_extractor, "DinoV2ExtractFeatures", functools.partial(
        port_extractor.DinoV2ExtractFeatures, dtype="float32"))


@pytest.fixture(scope="module")
def demo_tree(root):
    """Images of two shapes (PNG, lossless) and an indoor and an urban
    vocabulary under the demo's cache layout."""
    tree = root / "demo"
    rng = np.random.default_rng(7)
    (tree / "imgs").mkdir(parents=True)
    for i, (h, w) in enumerate([(70, 84), (70, 84), (70, 84), (56, 70), (56, 70)]):
        Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(
            tree / "imgs" / f"p{i}.png")
    for dom in ("indoor", "urban"):
        vdir = pathlib.Path(demo.vocab_dir(str(tree / "cache"), "dinov2_vits14", 1, "value", 4,
                                           dom))
        vdir.mkdir(parents=True)
        np.savez(vdir / "c_centers.npz", centers=rng.standard_normal((4, 384)).astype(np.float32))
    return tree


def _demo_args(root, tree, out, *extra):
    return ["--in-dir", str(tree / "imgs"), "--out-dir", str(tree / out),
            "--cache-dir", str(tree / "cache"), "--model", "dinov2_vits14", "--layer", "1",
            "--facet", "value", "--num-clusters", "4", "--max-img-size", "84",
            "--checkpoint", str(root / "vits14.pth"), *extra]


def test_demo_matches_jax(root, demo_tree, _float32_demos):
    assert demo.main(_demo_args(root, demo_tree, "port"), device="cpu") == 0
    assert jax_demo.main(_demo_args(root, demo_tree, "jax")) == 0
    names = sorted(p.name for p in (demo_tree / "port").glob("*.npy"))
    assert names == [f"p{i}.npy" for i in range(5)]
    for n in names:
        got, want = np.load(demo_tree / "port" / n), np.load(demo_tree / "jax" / n)
        assert got.shape == (4 * 384,)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_demo_npy_is_the_extractor_and_aggregate(root, demo_tree, _float32_demos):
    """Each .npy is the extractor + ``VLAD.aggregate`` of its preprocessed
    image on the same device."""
    assert demo.main(_demo_args(root, demo_tree, "own", "--first-n", "2"), device="cpu") == 0
    ext = port_extractor.DinoV2ExtractFeatures("dinov2_vits14", 1, "value", device="cpu",
                                               checkpoint=str(root / "vits14.pth"))
    vlad = port.VLAD(4, cache_dir=demo.vocab_dir(str(demo_tree / "cache"), "dinov2_vits14", 1,
                                                 "value", 4, "indoor"))
    vlad.fit(None)
    from anyloc_tpu_torch.data.transforms import preprocess_image

    for i in range(2):
        arr = preprocess_image(Image.open(demo_tree / "imgs" / f"p{i}.png").convert("RGB"),
                               max_edge=84, crop_multiple=14)
        want = vlad.aggregate(ext(arr[None]))[0].numpy()
        np.testing.assert_allclose(np.load(demo_tree / "own" / f"p{i}.npy"), want, atol=1e-6)


def test_demo_batched_buckets_match_batch1(root, demo_tree, _float32_demos):
    """Same-shape images batch (predicted from the header); batch 4 and the
    token-count auto rule equal batch 1 within float32 sums' order."""
    assert demo.processed_shape(84, 70, max_edge=84) == (70, 84)
    assert demo.processed_shape(200, 100, max_edge=84) == (42, 84)
    assert demo.processed_shape(100, 200, max_edge=84) == (84, 42)
    srng = np.random.default_rng(11)
    for _ in range(25):
        w, h, me = int(srng.integers(15, 400)), int(srng.integers(15, 400)), int(srng.integers(28, 300))
        assert demo.processed_shape(w, h, me) == jax_demo.processed_shape(w, h, me)
    for out, extra in (("b4", ["--batch", "4"]), ("b1", ["--batch", "1"]), ("auto", [])):
        assert demo.main(_demo_args(root, demo_tree, out, *extra), device="cpu") == 0
    for i in range(5):
        b1 = np.load(demo_tree / "b1" / f"p{i}.npy")
        for out in ("b4", "auto"):
            np.testing.assert_allclose(np.load(demo_tree / out / f"p{i}.npy"), b1, atol=1e-5)


def _routes(text):
    return dict(re.findall(r"^(p\d+)\.png -> .*\[(\w+)\]$", text, re.M))


def test_demo_auto_domain_routes_as_jax(root, demo_tree, _float32_demos, capsys):
    """--domain auto: a missing gem_centroids.npz raises in both demos;
    centroids built by each package's ``build_gem_centroids`` agree; the
    demos route every image to the same domain and write equal .npy."""
    args = lambda out: _demo_args(root, demo_tree, out, "--domain", "auto")  # noqa: E731
    with pytest.raises(FileNotFoundError, match="gem_centroids.npz"):
        demo.main(args("auto_port"), device="cpu")
    with pytest.raises(FileNotFoundError, match="gem_centroids.npz"):
        jax_demo.main(args("auto_jax"))
    vroot = pathlib.Path(demo.vocab_dir(str(demo_tree / "cache"), "dinov2_vits14", 1, "value",
                                        4, "x")).parent
    imgs = {"indoor": [str(demo_tree / "imgs" / "p0.png")],
            "urban": [str(demo_tree / "imgs" / "p3.png")]}
    ext = port_extractor.DinoV2ExtractFeatures("dinov2_vits14", 1, "value", device="cpu",
                                               checkpoint=str(root / "vits14.pth"))
    jext = jax_extractor.DinoV2ExtractFeatures("dinov2_vits14", 1, "value",
                                               checkpoint=str(root / "vits14.pth"))
    cents = demo.build_gem_centroids(ext, imgs, str(vroot / "gem_centroids.npz"), max_edge=84)
    jcents = jax_demo.build_gem_centroids(jext, imgs, str(vroot / "jax_centroids.npz"),
                                          max_edge=84)
    for d in imgs:
        np.testing.assert_allclose(cents[d], jcents[d], rtol=1e-4, atol=1e-6)
    capsys.readouterr()
    assert demo.main(args("auto_port"), device="cpu") == 0
    got = _routes(capsys.readouterr().out)
    assert jax_demo.main(args("auto_jax")) == 0
    want = _routes(capsys.readouterr().out)
    assert got == want and len(got) == 5
    assert got["p0"] == "indoor" and got["p3"] == "urban"
    for i in range(5):
        np.testing.assert_allclose(np.load(demo_tree / "auto_port" / f"p{i}.npy"),
                                   np.load(demo_tree / "auto_jax" / f"p{i}.npy"),
                                   rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------------ extras

def _draw(seed, n, k):
    """The JAX package's k-means start: ``jax.random.choice`` without
    replacement (kmeans_fit), which torch cannot reproduce (F2)."""
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, shape=(k,), replace=False))


def _unit(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def _blobs(seed, n_img, n_tok, d, c):
    """Descriptors near c well-separated centers: no label sits on a near
    tie, so 100 Lloyd steps agree across packages."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((c, d)) * 3
    lab = rng.integers(0, c, (n_img, n_tok))
    return (centers[lab] + 0.3 * rng.standard_normal((n_img, n_tok, d))).astype(np.float32)


def test_multilayer_vlad_matches_jax():
    layers = [_blobs(1, 6, 20, 16, 4), _blobs(2, 6, 20, 16, 4)]
    init = [_unit(x.reshape(-1, 16))[_draw(42 + li, 120, 4)] for li, x in enumerate(layers)]
    got = extras.multilayer_vlad(layers, 4, init_centers=init, device="cpu")
    want = jax_extras.multilayer_vlad(layers, 4)
    assert got.shape == (6, 2 * 4 * 16)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_sliding_window_vlad_and_scores_match_jax():
    rng = np.random.default_rng(3)
    db, qu = rng.standard_normal((3, 20, 8)).astype(np.float32), rng.standard_normal(
        (2, 20, 8)).astype(np.float32)
    centers = rng.standard_normal((4, 8)).astype(np.float32)
    dw = extras.sliding_window_vlad(db, (4, 5), centers, 3, 1, device="cpu")
    qw = extras.sliding_window_vlad(qu, (4, 5), centers, 3, 1, device="cpu")
    jdw = jax_extras.sliding_window_vlad(db, (4, 5), centers, 3, 1)
    jqw = jax_extras.sliding_window_vlad(qu, (4, 5), centers, 3, 1)
    assert dw.shape == (3, 6, 32)
    np.testing.assert_allclose(dw, jdw, atol=1e-6)
    np.testing.assert_allclose(qw, jqw, atol=1e-6)
    np.testing.assert_allclose(extras.sliding_window_scores(dw, qw),
                               jax_extras.sliding_window_scores(jdw, jqw), atol=1e-6)


def test_joint_pca_project_matches_jax():
    spectrum = np.linspace(3, 0.2, 24).astype(np.float32)
    rng = np.random.default_rng(4)
    sets = {"a": rng.standard_normal((30, 24)).astype(np.float32) * spectrum,
            "b": rng.standard_normal((20, 24)).astype(np.float32) * spectrum}
    got = extras.joint_pca_project(sets, 6, device="cpu")
    want = jax_extras.joint_pca_project(sets, 6)
    for k in sets:
        g, w = got[k], np.asarray(want[k])
        assert g.shape == (len(sets[k]), 6)
        np.testing.assert_allclose(np.abs(g), np.abs(w), rtol=1e-4, atol=1e-4)


def test_pca_downsample_experiment_matches_jax():
    rng = np.random.default_rng(5)
    db = (rng.standard_normal((40, 32)) * np.linspace(3, 0.2, 32)).astype(np.float32)
    qu = db[:10] + 0.05 * rng.standard_normal((10, 32)).astype(np.float32)
    gt = [np.array([i]) for i in range(10)]
    got = extras.pca_downsample_experiment(db, qu, gt, [4, 8, 16], top_k=(1, 5), device="cpu")
    want = jax_extras.pca_downsample_experiment(db, qu, gt, [4, 8, 16], top_k=(1, 5))
    assert got == want


def test_lseg_vlad_matches_jax(tmp_path):
    """Precomputed [H, W, D] pixel descriptors; file and pixel
    sub-sampling; the vocabulary from the JAX draw over the normalized
    database pixels."""
    rng = np.random.default_rng(6)
    blobs = rng.standard_normal((4, 8)) * 3
    for name, n in (("db", 8), ("qu", 4)):
        (tmp_path / name).mkdir()
        for i in range(n):
            lab = rng.integers(0, 4, (6, 6))
            x = blobs[lab] + 0.3 * rng.standard_normal((6, 6, 8))
            np.save(tmp_path / name / f"img{i}.npy", x.astype(np.float32))
    gt = [np.array([2 * i]) for i in range(4)]
    kw = dict(num_clusters=4, top_k_vals=(1, 2), sub_sample_db=2, sub_sample_pixels=2,
              sub_sample_db_vlad=3)
    files = sorted(glob.glob(str(tmp_path / "db" / "*.npy")))[::2]
    pix = np.stack([np.load(f)[::2, ::2] for f in files]).reshape(-1, 8)[::3]
    init = _unit(pix)[_draw(42, len(pix), 4)]
    gd, gi, gr = extras.lseg_vlad(str(tmp_path / "db"), str(tmp_path / "qu"), gt,
                                  init_centers=init, device="cpu", **kw)
    jd, ji, jr = jax_extras.lseg_vlad(str(tmp_path / "db"), str(tmp_path / "qu"), gt, **kw)
    np.testing.assert_array_equal(gi, np.asarray(ji))
    np.testing.assert_allclose(gd, np.asarray(jd), atol=1e-5)
    assert gr == jr


@pytest.mark.parametrize("use_pca", [False, True])
def test_sequence_clusters_match_jax(use_pca):
    from anyloc_tpu_torch.ops.pca import pca_fit, pca_transform

    x = _blobs(7, 1, 40, 24, 3)[0] * np.linspace(3, 0.5, 24).astype(np.float32)
    space = x
    if use_pca:   # the start rows in the port's own projection (signs are the solver's)
        xt = torch.from_numpy(x)
        space = pca_transform(xt, *pca_fit(xt, 8)).numpy()
    init = space[_draw(0, 40, 3)]
    got = extras.sequence_clusters(x, 3, use_pca=use_pca, n_components=8, init_centers=init,
                                   device="cpu")
    want = jax_extras.sequence_clusters(x, 3, use_pca=use_pca, n_components=8)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_group_images_by_cluster_matches_jax(tmp_path):
    files = []
    for i in range(5):
        f = tmp_path / f"img_{i}.jpg"
        f.write_bytes(bytes([i]) * 10)
        files.append(str(f))
    labels = np.array([1, 0, 1, 2, 0])
    got = extras.group_images_by_cluster(files, labels, str(tmp_path / "port"))
    want = jax_extras.group_images_by_cluster(files, labels, str(tmp_path / "jax"))
    rel = lambda d, base: {k: [pathlib.Path(p).relative_to(base).as_posix() for p in v]  # noqa: E731
                           for k, v in d.items()}
    assert rel(got, tmp_path / "port") == rel(want, tmp_path / "jax")
    assert (tmp_path / "port" / "2" / "img_3.jpg").read_bytes() == bytes([3]) * 10
    with pytest.raises(ValueError, match="labels"):
        extras.group_images_by_cluster(files, labels[:2], str(tmp_path / "bad"))


def test_residual_vpr_matches_jax():
    rng = np.random.default_rng(8)
    db = _blobs(9, 1, 30, 16, 4)[0]
    qu = db[:8] + 0.1 * rng.standard_normal((8, 16)).astype(np.float32)
    gt = [np.array([i]) for i in range(8)]
    sizes = (2, 4)
    init = {c: _unit(db)[_draw(0, 30, c)] for c in sizes}
    got = extras.residual_vpr(db, qu, gt, cluster_sizes=sizes, top_k=(1, 3), init_centers=init,
                              device="cpu")
    want = jax_extras.residual_vpr(db, qu, gt, cluster_sizes=sizes, top_k=(1, 3))
    assert got == want


# ------------------------------------------------------------------ sweeps

def test_run_sweep_writes_the_jax_columns(root, pil_decode, tmp_path, monkeypatch):
    """A 2-point vlad grid: one engine for both points, no row with
    ``error``, the CSV's columns those of the JAX package's sweep."""
    built = []
    init = port.DescriptorEngine.__init__

    def spy(self, *a, **kw):
        built.append(kw.get("device"))
        init(self, *a, **kw)

    monkeypatch.setattr(port.DescriptorEngine, "__init__", spy)
    argv = _args(root, "sweep", "sweep")
    grid = {"num_clusters": [4, 8]}
    rows = sweeps.run_sweep("vlad", grid, port.config.parse_args(argv=argv),
                            str(tmp_path / "port.csv"), verbose=False, device="cpu")
    jrows = jax_sweeps.run_sweep("vlad", grid, jax_parse_args(argv=argv),
                                 str(tmp_path / "jax.csv"), verbose=False)
    assert built == ["cpu"]
    assert not any("error" in r for r in rows + jrows)
    assert [r["Num-Clusters"] for r in rows] == ["4", "8"]
    with open(tmp_path / "port.csv") as f, open(tmp_path / "jax.csv") as g:
        assert next(csv.reader(f)) == next(csv.reader(g))
    assert rows[0]["run_name"] == jrows[0]["run_name"] == \
        "DINO_V2_VLAD/l1_value_c4/17places/dinov2_vits14"


def test_sweep_cli_records_failing_points(root, tmp_path):
    """``python -m anyloc_tpu_torch sweep``: a grid point that fails (an
    unknown dataset) is a row with ``error``; the other point runs."""
    out = tmp_path / "s.csv"
    assert cli.main(["sweep", "--pipeline", "gem", "--out", str(out),
                     "--grid.dataset", "17places", "no_such_dataset",
                     *_args(root, "sweep_cli", "sweep_cli")], device="cpu") == 0
    rows = list(csv.DictReader(open(out)))
    assert [r.get("error") for r in rows] == ["", "True"]
    assert rows[0]["Agg-Method"] == "GeM"
