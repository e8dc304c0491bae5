"""The port's tooling against the JAX package on the CPU: ``viz.py``
(figures read back as arrays, cluster maps, similarity maps, t-SNE and PCA
projections), ``pipelines/report_html.py``, ``utils/images.py``,
``data/transforms.py::resize_pil``, ``utils/profiling.py``, and the four
``viz`` subcommands and ``sweep --plot`` end to end against the JAX CLI.

The CLIs run ViT-S/14 at 56 px in float32 from one checkpoint drawn from a
seed: both extractor classes are monkeypatched in the test (``checkpoint``
and ``dtype`` bound with ``functools.partial``), and both read one
vocabulary file. PNGs compare pixel for pixel (both packages draw with the
same matplotlib), maps and labels exactly, t-SNE within 1e-5 on equal
inputs.
"""

import functools
import glob
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from anyloc_tpu import sweeps as jax_sweeps
from anyloc_tpu import viz as jviz
from anyloc_tpu.data import synthetic as jax_synthetic
from anyloc_tpu.data.transforms import resize_pil as jax_resize_pil
from anyloc_tpu.models import extractor as jax_extractor
from anyloc_tpu.pipelines import report_html as jreport
from anyloc_tpu.pipelines import viz_cli as jviz_cli
from anyloc_tpu.utils import images as jimages
from anyloc_tpu.utils import profiling as jprofiling

from anyloc_tpu_torch import cli, viz
from anyloc_tpu_torch.data.transforms import resize_pil
from anyloc_tpu_torch.models import extractor as port_extractor
from anyloc_tpu_torch.models.dinov2 import dinov2_config, init_params
from anyloc_tpu_torch.pipelines import report_html
from anyloc_tpu_torch.pipelines.demo import vocab_dir
from anyloc_tpu_torch.utils import images, profiling

torch.set_num_threads(2)
pytest.importorskip("matplotlib")


def _png(path):
    return np.asarray(Image.open(path).convert("RGBA"))


# ------------------------------------------------------------------ viz.py


@pytest.mark.parametrize("fig", ["radar", "radar_custom", "recall", "ablation"])
def test_figures_match_jax_pixel_for_pixel(fig, tmp_path):
    """radar_chart (the published aggregates and a custom set),
    recall_curve and ablation_plot (a numeric and a categorical axis): the
    PNGs read back as equal arrays."""
    outs = []
    for pkg, name in ((viz, "port"), (jviz, "jax")):
        out = str(tmp_path / f"{fig}_{name}.png")
        if fig == "radar":
            pkg.radar_chart(output_path=out)
        elif fig == "radar_custom":
            pkg.radar_chart({"a": [1, 2, 3], "b": [3, 2, 1]}, ["x", "y", "z"], output_path=out)
        elif fig == "recall":
            pkg.recall_curve({1: 0.5, 5: 0.75, 10: 0.9}, out, title="t")
        else:
            for kind, rows in (("num", [("32", "0.5"), ("8", "0.25"), ("16", "")]),
                               ("cat", [("value", "0.4"), ("key", "0.6")])):
                path = tmp_path / f"{kind}.csv"
                path.write_text("x,R@1\n" + "".join(f"{a},{b}\n" for a, b in rows))
            pkg.ablation_plot({"num": str(tmp_path / "num.csv"), "cat": str(tmp_path / "cat.csv")},
                              "x", output_path=out, title="abl")
        outs.append(_png(out))
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("overlay", [False, True])
def test_cluster_assignment_map_matches_jax(overlay):
    """The per-patch labels (assign_labels, cosine) and the upsampled
    overlay equal the JAX map, on a 5 x 7 grid over a 37 x 50 image."""
    rng = np.random.default_rng(0)
    descs = rng.standard_normal((35, 16)).astype(np.float32)
    centers = rng.standard_normal((24, 16)).astype(np.float32)
    image = (rng.random((37, 50, 3)) * 255).astype(np.uint8) if overlay else None
    got = viz.cluster_assignment_map(descs, centers, (5, 7), image, 0.4, device="cpu")
    want = jviz.cluster_assignment_map(descs, centers, (5, 7), image, 0.4)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_similarity_map_matches_jax():
    rng = np.random.default_rng(1)
    q, t = rng.standard_normal(16), rng.standard_normal((12, 16))
    np.testing.assert_allclose(viz.similarity_map(q, t, (3, 4)),
                               jviz.similarity_map(q, t, (3, 4)), atol=1e-12)


def test_tsne_projection_matches_jax():
    """The joint t-SNE (scikit-learn, seeded) of three sets, within 1e-5."""
    pytest.importorskip("sklearn")
    rng = np.random.default_rng(2)
    sets = {k: rng.standard_normal((n, 8)).astype(np.float32)
            for k, n in (("a", 9), ("b", 7), ("user", 4))}
    got, want = viz.tsne_projection(sets), jviz.tsne_projection(sets)
    assert list(got) == list(want)
    for k in sets:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5)


def test_pca_projection_matches_jax_up_to_a_sign():
    """The joint 2-D PCA: each component equal up to its sign."""
    rng = np.random.default_rng(3)
    sets = {k: rng.standard_normal((n, 6)).astype(np.float32) * [5, 3, 1, 1, 1, 1]
            for k, n in (("a", 20), ("b", 12))}
    got, want = viz.pca_projection(sets, device="cpu"), jviz.pca_projection(sets)
    for k in sets:
        g, w = got[k], np.asarray(want[k])
        sign = np.sign((g * w).sum(0))
        np.testing.assert_allclose(g * sign, w, atol=1e-4)


def test_paper_radar_data_is_the_jax_copy():
    assert viz.PAPER_RADAR_R1 == jviz.PAPER_RADAR_R1
    assert viz.PAPER_RADAR_AXES == jviz.PAPER_RADAR_AXES
    np.testing.assert_array_equal(viz._CLUSTER_COLORS, jviz._CLUSTER_COLORS)


# ------------------------------------------------------------------ report, images, transforms


@pytest.mark.parametrize("domain", [False, True])
def test_build_report_returns_the_jax_string(domain):
    rng = np.random.default_rng(4)
    imgs = [{"name": f"i{j}.png", "rgb": (rng.random((28, 42, 3)) * 255).astype(np.uint8),
             "grid": (2, 3), "labels": rng.integers(0, 5, 6)} for j in range(2)]
    pal = viz._CLUSTER_COLORS[np.arange(5)]
    points = ([{"name": "x", "domain": "indoor", "x": 0.5, "y": -1.0},
               {"name": "i0.png", "domain": "user", "x": 1.5, "y": 2.0, "user": True}]
              if domain else None)
    assert report_html.build_report(imgs, pal, points, config_line="c") == \
        jreport.build_report(imgs, pal, points, config_line="c")


def test_images_helpers_match_jax():
    """to_np, to_pil_list (batch and single, channels first and last),
    pad_img on uint8 and float images."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 3, 6, 5)).astype(np.float32))
    np.testing.assert_array_equal(images.to_np(x), jimages.to_np(x))
    for arr in (x, x[0], x.permute(0, 2, 3, 1).numpy()):
        got, want = images.to_pil_list(arr), jimages.to_pil_list(arr)
        assert [np.asarray(a).tolist() for a in got] == [np.asarray(b).tolist() for b in want]
    for img in ((rng.random((4, 5, 3)) * 255).astype(np.uint8),
                rng.random((4, 5, 3)).astype(np.float32)):
        np.testing.assert_array_equal(images.pad_img(img, 2, (9, 8, 7)),
                                      jimages.pad_img(img, 2, (9, 8, 7)))


@pytest.mark.parametrize("size", [(20, 30), (90, 41)])
def test_resize_pil_matches_jax(size):
    img = Image.fromarray((np.random.default_rng(6).random((57, 64, 3)) * 255).astype(np.uint8))
    np.testing.assert_array_equal(np.asarray(resize_pil(img, size)),
                                  np.asarray(jax_resize_pil(img, size)))


def test_stage_timer_and_trace(tmp_path):
    """StageTimer on a CPU tensor (no fence needed) and the report; trace()
    writes a Chrome trace."""
    t = profiling.StageTimer()
    x = torch.randn(64, 64)
    with t.stage("matmul", fence_on=x):
        x @ x
    with t.stage("matmul"):
        x @ x
    assert set(t.times) == {"matmul"} and "matmul" in t.report()
    with profiling.trace(str(tmp_path / "tr")) as d:
        x @ x
    assert json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert d == str(tmp_path / "tr")


def test_flops_of_counts_a_gemm_as_the_jax_one():
    """A [64 x 48] @ [48 x 32] product: 2·M·N·K in both packages; a function
    that cannot run gives None in both."""
    a, b = np.ones((64, 48), np.float32), np.ones((48, 32), np.float32)
    got = profiling.flops_of(lambda x, y: x @ y, torch.from_numpy(a), torch.from_numpy(b))
    want = jprofiling.flops_of(lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b))
    assert got == want == 2 * 64 * 48 * 32
    assert profiling.flops_of(lambda x: x.no_such_method(), torch.ones(2)) is None
    assert jprofiling.flops_of(lambda x: x.no_such_method(), jnp.ones(2)) is None


def test_flops_of_counts_a_module_on_the_plain_path():
    """A ViT block (K5 on the card) counts through its plain versions, on
    shape-only copies: twice the block's products plus its attention."""
    import dataclasses

    from anyloc_tpu_torch.models.dinov2 import build_vit
    from anyloc_tpu_torch.tools import mesh_checks

    cfg = dataclasses.replace(mesh_checks.vit_config("small"), depth=1)
    blk = build_vit(cfg, mesh_checks.vit_params(cfg, 0), device="cpu").blocks[0]
    b, n, d, h = 2, 17, cfg.embed_dim, cfg.mlp_hidden
    f = profiling.flops_of(blk, torch.randn(b, n, d))
    products = 2 * b * n * (d * 3 * d + d * d + d * 2 * h + h * d) + 2 * 2 * b * n * n * d
    assert f == products, (f, products)


# ------------------------------------------------------------------ the CLIs


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """Images, a ViT-S/14 checkpoint, one vocabulary in both packages'
    vocab_dir, a GeM cache."""
    root = tmp_path_factory.mktemp("viz")
    jax_synthetic.build_vpr_bench(str(root / "tree"), n_db=10, n_q=5, seed=3, size=(60, 80))
    imgs = root / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(7)
    for j in range(3):
        Image.fromarray((rng.random((70 + 7 * j, 84, 3)) * 255).astype(np.uint8)).save(
            imgs / f"p{j}.jpg")
    shapes = {k: tuple(v.shape) for k, v in init_params(
        dinov2_config("dinov2_vits14", dtype=torch.float32), n_blocks=12).items()}
    shapes.update({"norm.weight": (384,), "norm.bias": (384,)})
    sd = {}
    for k, s in sorted(shapes.items()):
        scale = np.prod(s[1:]) ** -0.5 if len(s) > 1 else 0.1
        sd[k] = torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32))
    torch.save(sd, root / "vits14.pth")
    vdir = vocab_dir(str(root / "cache"), "dinov2_vits14", 1, "value", 6, "indoor")
    os.makedirs(vdir)
    np.savez(os.path.join(vdir, "c_centers.npz"),
             centers=rng.standard_normal((6, 384)).astype(np.float32))
    np.savez(root / "gem.npz", **{name: rng.standard_normal((5, 384)).astype(np.float32)
                                  for name in ("gardens", "pitts30k", "nardo-air")})
    return root


@pytest.fixture
def seeded_extractors(work, monkeypatch):
    """Both packages' DinoV2ExtractFeatures load the one checkpoint, in
    float32."""
    ck = str(work / "vits14.pth")
    monkeypatch.setattr(jax_extractor, "DinoV2ExtractFeatures", functools.partial(
        jax_extractor.DinoV2ExtractFeatures, checkpoint=ck, dtype=jnp.float32))
    monkeypatch.setattr(port_extractor, "DinoV2ExtractFeatures", functools.partial(
        port_extractor.DinoV2ExtractFeatures, checkpoint=ck, dtype=torch.float32))


@pytest.fixture
def projector(monkeypatch):
    """t-SNE in both packages replaced by the first two coordinates of its
    inputs, which it records: t-SNE's PCA start can flip on the float32
    noise between two trunks and land elsewhere, so the CLIs are held to
    equal projector inputs (``tsne_projection`` itself is held to the JAX
    one on equal inputs above)."""
    seen = {}

    def stub(name):
        def tsne(desc_sets, perplexity=10.0, seed=42):
            seen[name] = {k: np.asarray(v, np.float32) for k, v in desc_sets.items()}
            return {k: v[:, :2].astype(np.float64) for k, v in seen[name].items()}
        return tsne

    monkeypatch.setattr(viz, "tsne_projection", stub("port"))
    monkeypatch.setattr(jviz, "tsne_projection", stub("jax"))
    return seen


def _same_inputs(seen):
    assert list(seen["port"]) == list(seen["jax"])
    for k, v in seen["jax"].items():
        np.testing.assert_allclose(seen["port"][k], v, atol=1e-4 * np.abs(v).max())


_COMMON = ["--model", "dinov2_vits14", "--layer", "1", "--facet", "value"]


def _vocab(work):
    return ["--cache-dir", str(work / "cache"), "--domain", "indoor", "--num-clusters", "6",
            "--max-img-size", "56"]


def test_viz_clusters_matches_the_jax_cli(work, seeded_extractors, tmp_path):
    """``viz clusters``: one overlay PNG per image, equal to the JAX CLI's."""
    args = ["clusters", "--in-dir", str(work / "imgs"), *_COMMON, *_vocab(work), "--alpha", "0.3"]
    assert cli.main(["viz", *args, "--out-dir", str(tmp_path / "p")], device="cpu") == 0
    assert jviz_cli.main([*args, "--out-dir", str(tmp_path / "j")]) == 0
    names = sorted(os.listdir(tmp_path / "p"))
    assert names == sorted(os.listdir(tmp_path / "j")) == [f"p{j}_clusters.png" for j in range(3)]
    for name in names:
        np.testing.assert_array_equal(_png(tmp_path / "p" / name), _png(tmp_path / "j" / name))


@pytest.mark.parametrize("gem", [False, True])
def test_viz_report_matches_the_jax_cli(work, seeded_extractors, projector, tmp_path, gem):
    """``viz report`` (with ``--gem-cache`` its domain projection): the HTML
    equals the JAX CLI's, labels included; with the projection the GeM
    descriptors it projects within 1e-4, the scatter's coordinates within
    0.05 px and the rest of the page equal."""
    args = ["report", "--in-dir", str(work / "imgs"), *_COMMON, *_vocab(work), "--first-n", "2"]
    if gem:
        args += ["--gem-cache", str(work / "gem.npz")]
    assert cli.main(["viz", *args, "--out", str(tmp_path / "p.html")], device="cpu") == 0
    assert jviz_cli.main([*args, "--out", str(tmp_path / "j.html")]) == 0
    got, want = (tmp_path / "p.html").read_text(), (tmp_path / "j.html").read_text()
    if not gem:
        assert got == want
        return
    _same_inputs(projector)
    # the scatter's coordinates apart, the two pages are one text
    num = re.compile(r"-?\d+\.\d+(?:e-?\d+)?")
    assert num.split(got) == num.split(want)
    np.testing.assert_allclose([float(x) for x in num.findall(got)],
                               [float(x) for x in num.findall(want)], atol=0.05)


def test_viz_domain_matches_the_jax_cli(work, seeded_extractors, projector, tmp_path):
    """``viz domain``: the same sets projected (the users' GeM descriptors
    within 1e-4 of the JAX CLI's), the JSON points within 1e-4."""
    args = ["domain", "--in-dir", str(work / "imgs"), "--gem-cache", str(work / "gem.npz"),
            *_COMMON]
    assert cli.main(["viz", *args, "--out", str(tmp_path / "p.json")], device="cpu") == 0
    assert jviz_cli.main([*args, "--out", str(tmp_path / "j.json")]) == 0
    got, want = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("p", "j"))
    assert list(got) == list(want) == ["gardens", "pitts30k", "nardo-air", "user"]
    _same_inputs(projector)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4)


def test_viz_radar_matches_the_jax_cli(tmp_path):
    extra = tmp_path / "mine.json"
    extra.write_text(json.dumps({"mine": [50.0] * 8}))
    for name, run in (("p", lambda a: cli.main(["viz", *a], device="cpu")),
                      ("j", jviz_cli.main)):
        assert run(["radar", "--out", str(tmp_path / f"{name}.png"), "--extra", str(extra)]) == 0
    np.testing.assert_array_equal(_png(tmp_path / "p.png"), _png(tmp_path / "j.png"))


def test_sweep_plot_matches_the_jax_cli(work, tmp_path, monkeypatch):
    """``sweep --pipeline gem --grid.desc-layer 0 1 --plot`` through both
    CLIs on one tree and checkpoint: equal CSV recalls, and the figure
    (R@1 against the layer, the grid's only axis) pixel for pixel."""
    from anyloc_tpu.data.base import VPRDataset as JaxVPRDataset

    import anyloc_tpu_torch as port

    monkeypatch.setattr(port.VPRDataset, "use_native_loader", False)
    monkeypatch.setattr(JaxVPRDataset, "use_native_loader", False)
    base = ["--prog.data-vg-dir", str(work / "tree"), "--prog.vg-dataset-name", "17places",
            "--extractor.model-type", "dinov2_vits14", "--extractor.dtype", "float32",
            "--extractor.checkpoint", str(work / "vits14.pth"), "--extractor.batch-size", "4",
            "--bd-args.resize", "56", "56", "--top-k-vals", "1", "3", "5"]
    grid = ["--pipeline", "gem", "--grid.desc-layer", "0", "1", "--plot"]
    assert cli.main(["sweep", *grid, "--out", str(tmp_path / "p.csv"), *base,
                     "--prog.cache-dir", str(tmp_path / "pc")], device="cpu") == 0
    assert jax_sweeps.main([*grid, "--out", str(tmp_path / "j.csv"), *base,
                            "--prog.cache-dir", str(tmp_path / "jc")]) == 0
    import csv

    rows = [list(csv.DictReader(open(tmp_path / f"{n}.csv"))) for n in ("p", "j")]
    assert [r["R@1"] for r in rows[0]] == [r["R@1"] for r in rows[1]]
    np.testing.assert_array_equal(_png(tmp_path / "p.png"), _png(tmp_path / "j.png"))
    assert len(glob.glob(str(tmp_path / "*.png"))) == 2
