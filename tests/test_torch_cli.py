"""The port's command line (``python -m anyloc_tpu_torch``) against the JAX
package's (``anyloc_tpu.cli``) on one synthetic dataset root, on the CPU.

Both CLIs load one ``--extractor.checkpoint``: a ViT-S/14 state dict
written with ``torch.save`` from a numpy seed, run at layer 1 in float32
at 56 px. The vocabulary comes from one ``c_centers.npz`` in
``--vlad.cache-dir`` (the port cannot draw the JAX package's k-means
start, ROADMAP F2), so the saved results JSONs must agree on every key but
``Timestamp``, recalls exactly.
"""

import glob
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from anyloc_tpu import cli as jax_cli
from anyloc_tpu import pipelines as jax_pipelines
from anyloc_tpu.config import parse_args as jax_parse_args
from anyloc_tpu.data.base import VPRDataset as JaxVPRDataset
from anyloc_tpu.data import synthetic as jax_synthetic

import anyloc_tpu_torch as port
from anyloc_tpu_torch import cli
from anyloc_tpu_torch.models.dinov2 import dinov2_config, init_params
from anyloc_tpu_torch.ops import retrieval

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    """17places (vpr_bench) and gardens trees, a ViT-S/14 checkpoint and a
    shared 8-word vocabulary of the checkpoint's width."""
    root = tmp_path_factory.mktemp("cli")
    jax_synthetic.build_vpr_bench(str(root), n_db=12, n_q=6, seed=1, size=(60, 80))
    jax_synthetic.build_gardens(str(root), n_db=6, n_q=3, seed=2, size=(60, 80))
    shapes = {k: tuple(v.shape) for k, v in init_params(
        dinov2_config("dinov2_vits14", dtype=torch.float32), n_blocks=12).items()}
    shapes.update({"norm.weight": (384,), "norm.bias": (384,)})
    rng = np.random.default_rng(0)
    sd = {}
    for k, s in sorted(shapes.items()):
        scale = np.prod(s[1:]) ** -0.5 if len(s) > 1 else 0.1
        sd[k] = torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32))
    torch.save(sd, root / "vits14.pth")
    (root / "vocab").mkdir()
    np.savez(root / "vocab" / "c_centers.npz",
             centers=rng.standard_normal((8, 384)).astype(np.float32))
    return root


def _args(root, out, exp, vocab=True):
    args = ["--prog.data-vg-dir", str(root), "--prog.vg-dataset-name", "17places",
            "--prog.cache-dir", str(root / out), "--exp-id", exp,
            "--db-samples", "17places=1", "gardens=2",
            "--extractor.model-type", "dinov2_vits14", "--extractor.desc-layer", "1",
            "--extractor.dtype", "float32", "--extractor.checkpoint", str(root / "vits14.pth"),
            "--extractor.batch-size", "4", "--bd-args.resize", "56", "56",
            "--vlad.num-clusters", "8", "--top-k-vals", "1", "3", "5"]
    return args + (["--vlad.cache-dir", str(root / "vocab")] if vocab else [])


def _saved(root, out, exp):
    (path,) = glob.glob(str(root / out / "experiments" / exp / "results_*.json"))
    return json.loads(pathlib.Path(path).read_text())


@pytest.fixture
def pil_decode(monkeypatch):
    """PIL on both sides, so the comparison does not hang on the native
    pipe's float rounding (2e-5, tests/test_imagepipe.py)."""
    monkeypatch.setattr(port.VPRDataset, "use_native_loader", False)
    monkeypatch.setattr(JaxVPRDataset, "use_native_loader", False)


@pytest.mark.parametrize("cmd", ["global-vocab-vlad", "vlad"])
def test_cli_matches_jax(dataset_root, pil_decode, cmd):
    assert cli.main([cmd, *_args(dataset_root, "port", cmd)], device="cpu") == 0
    assert jax_cli.main([cmd, *_args(dataset_root, "jax", cmd)]) == 0
    got, want = _saved(dataset_root, "port", cmd), _saved(dataset_root, "jax", cmd)
    got.pop("Timestamp")
    want.pop("Timestamp")
    assert got == want
    assert got["VLAD-Dim"] == str(8 * 384) and got["Num-DB"] == "12" and got["Num-QU"] == "6"
    assert {"R@1", "R@3", "R@5"} <= set(got)
    assert ("Global-Vocab" in got) == (cmd == "global-vocab-vlad")


def test_cli_fits_the_vocabulary_on_the_recipe(dataset_root, monkeypatch):
    """Without a cached vocabulary the port fits k-means on the recipe's
    database images (12 + 6 / 2) on the engine's device, and the search
    runs there too (F11)."""
    seen = {}
    fit = port.VLAD.fit

    def spy_fit(self, descs=None):
        seen["vocab"] = tuple(descs.shape)
        return fit(self, descs)

    def spy_search(db, qu, k, *a, **kw):
        seen["search"] = (db.device.type, qu.device.type)
        return search(db, qu, k, *a, **kw)

    search = retrieval.top_k_search
    monkeypatch.setattr(port.VLAD, "fit", spy_fit)
    monkeypatch.setattr(retrieval, "top_k_search", spy_search)
    args = _args(dataset_root, "port", "fit", vocab=False)
    assert cli.main(["global-vocab-vlad", *args], device="cpu") == 0
    assert seen == {"vocab": (15 * 16, 384), "search": ("cpu", "cpu")}
    res = _saved(dataset_root, "port", "fit")
    assert res["Global-Vocab"] == "['17places', 'gardens']"
    assert all(0.0 <= res[f"R@{k}"] <= 1.0 for k in (1, 3, 5))


def test_unknown_subcommand_returns_2(capsys):
    assert cli.main(["no-such-pipeline"]) == 2
    assert "Unknown pipeline" in capsys.readouterr().err


def test_module_help_exits_0():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "anyloc_tpu_torch", "--help"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "global-vocab-vlad" in proc.stdout and proc.stdout.startswith("Command line")


def test_cli_without_a_card_raises_unless_given_a_device(dataset_root):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["vlad", *_args(dataset_root, "none", "none")])


@pytest.mark.parametrize("pipeline", ["run_vlad_pipeline", "run_global_vocab_vlad"])
def test_pipelines_rank_like_jax(dataset_root, pil_decode, pipeline):
    """Below the JSON: the same retrieved indices per query, distances
    within 1e-5, from the pipelines the two CLIs call."""
    args = _args(dataset_root, "unused", "unused")
    got = getattr(port, pipeline)(port.config.parse_args(argv=args), verbose=False, device="cpu")
    want = getattr(jax_pipelines, pipeline)(jax_parse_args(argv=args), verbose=False)
    np.testing.assert_array_equal(got["Qual-Indices"], np.asarray(want["Qual-Indices"]))
    np.testing.assert_allclose(got["Qual-Dists"], np.asarray(want["Qual-Dists"]), atol=1e-5)
    assert got["Qual-Indices"].shape == (6, 5)
