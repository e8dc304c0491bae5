"""The port's counterparts of the repository's JAX programs: the tools
(``bench_serving``, ``bench_ivf``, ``bench_pq_matrix``,
``bench_mlp_xla_int8``, ``bench_retrieval --recall-vs-exact``), the
examples (quickstart, serving, multi-device, the notebook) and
``__graft_entry__``'s ``entry`` / ``dryrun_multichip``
(``anyloc_tpu_torch/tools/dryrun.py``), on the CPU.

The tools' flags and defaults equal the JAX tools' (each JAX parser is
caught as its ``main`` builds it); each tool raises without a card. The
library MLP half equals the JAX tool's XLA MLP half on the same inputs
(bfloat16 outputs within one bfloat16 step where a per-row int8 code may
flip: 1e-3 of the elements). The examples run at small sizes with
``--cpu``, their printed results held to the JAX examples' where both are
deterministic (the quickstart's recalls on one checkpoint and one
vocabulary, F2). ``dryrun_multichip(2 | 4, device="cpu")`` prints every
"... ok" line of the JAX dryrun.
"""

import argparse
import contextlib
import importlib.util
import inspect
import io
import json
import pathlib
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
torch.set_num_threads(2)


def _load(rel: str):
    """A JAX program by file path (tools/ and examples/ are no packages)."""
    sys.path.insert(0, str(ROOT))
    name = "jax_prog_" + rel.replace("/", "_").replace(".py", "")
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Caught(Exception):
    pass


def _jax_parser(rel: str, monkeypatch) -> argparse.ArgumentParser:
    """The parser the JAX program's ``main`` builds, caught at its
    ``parse_args``."""
    mod = _load(rel)

    def catch(self, *a, **kw):
        raise _Caught(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(_Caught) as e:
            mod.main()
    return e.value.args[0]


def _flags(p: argparse.ArgumentParser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs,
                     tuple(a.choices) if a.choices else None, type(a).__name__)
            for a in p._actions if a.dest != "help"}


@pytest.mark.parametrize("rel,port", [
    ("tools/bench_serving.py", "bench_serving"),
    ("tools/bench_ivf.py", "bench_ivf"),
    ("bench_retrieval.py", "bench_retrieval"),
])
def test_tool_flags_and_defaults_equal_the_jax_tools(rel, port, monkeypatch):
    """Every flag of the JAX tool, with its default, type, nargs and
    choices, is the port tool's (the port may add its own after them:
    bench_retrieval's ``--seed``, bench_serving's hidden ``--work`` /
    ``--device`` of the per-config run; bench_retrieval's ``--engines``
    names its choices, which the JAX flag leaves open)."""
    want = _flags(_jax_parser(rel, monkeypatch))
    got = _flags(importlib.import_module(f"anyloc_tpu_torch.tools.{port}").parser())
    for dest, w in want.items():
        g = got[dest]
        if dest == "engines":
            assert g[:4] == w[:4] and set(g[4]) >= {"device", "blocked", "native", "ivf", "pq",
                                                  "ivf_pq"}
            continue
        assert g == w, (dest, g, w)
    assert set(got) - set(want) <= {"seed", "work", "device"}


def test_bench_mlp_xla_int8_takes_the_jax_token_counts(monkeypatch):
    """The JAX tool's positional N_tokens (default 257 485), its only flag,
    and its 100 timed iterations."""
    from anyloc_tpu_torch.tools import bench_mlp_xla_int8 as tool

    assert inspect.signature(tool.run).parameters["iters"].default == 100
    seen = []
    monkeypatch.setattr(tool, "run", lambda ns: seen.append(list(ns)) or
                        {"card": "", "shapes": {}})
    tool.main([])
    tool.main(["100", "3000"])
    assert seen == [[257, 485], [100, 3000]]
    src = (ROOT / "tools" / "bench_mlp_xla_int8.py").read_text()
    assert "or [257, 485]" in src and "iters=100" in src


def test_bench_pq_matrix_is_the_jax_grid(monkeypatch):
    """BASE and RUNS, tags and argv, equal the JAX tool's; every run's argv
    parses with the port's bench_retrieval (four need --recall-vs-exact)."""
    from anyloc_tpu_torch.tools import bench_pq_matrix, bench_retrieval

    jax_tool = _load("tools/bench_pq_matrix.py")
    assert bench_pq_matrix.BASE == jax_tool.BASE
    assert bench_pq_matrix.RUNS == jax_tool.RUNS
    n_recall = 0
    for tag, argv in bench_pq_matrix.RUNS:
        a = bench_retrieval.parser().parse_args(bench_pq_matrix.BASE + argv)
        n_recall += a.recall_vs_exact
        assert a.dim == 512 and a.n_qu == 256, tag
    assert n_recall == 4


def test_bench_pq_matrix_writes_each_line_as_it_comes(monkeypatch, tmp_path):
    """A run's lines go to stdout and to --out at once, framed by the run's
    argv and wall time; the flags reach bench_retrieval; an unknown tag
    raises."""
    from anyloc_tpu_torch.tools import bench_pq_matrix, bench_retrieval

    out = tmp_path / "grid.jsonl"
    seen = []

    def fake_run(*a, emit=print):
        seen.append(a)
        emit(json.dumps({"engine": "pq64_tables"}))
        assert out.read_text().count("\n") == 2    # already on disk
        return {}

    monkeypatch.setattr(bench_retrieval, "run", fake_run)
    tag, argv = bench_pq_matrix.RUNS[6]
    with contextlib.redirect_stdout(io.StringIO()):
        bench_pq_matrix.run(tag, bench_pq_matrix.BASE + argv, str(out))
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert lines[0] == {"run": tag, "argv": bench_pq_matrix.BASE + argv}
    assert lines[1] == {"engine": "pq64_tables"} and lines[2]["run"] == tag
    assert seen[0][:4] == (1_000_000, 256, 512, 20) and seen[0][11] == "tables"
    with pytest.raises(ValueError, match="unknown runs"):
        bench_pq_matrix.main(["no_such_run"])


def test_bench_retrieval_passes_recall_vs_exact(monkeypatch):
    """``--recall-vs-exact`` reaches ``run`` (after the root script's
    flags); without it the run prints no recall line."""
    from anyloc_tpu_torch.tools import bench_retrieval

    seen = []
    monkeypatch.setattr(bench_retrieval, "run", lambda *a: seen.append(a))
    bench_retrieval.main(["--n-db", "5000", "--recall-vs-exact"])
    bench_retrieval.main(["--n-db", "5000"])
    assert seen[0][17] is True and seen[1][17] is False


@pytest.mark.parametrize("tool,call", [
    ("bench_mlp_xla_int8", lambda m: m.run()),
    ("bench_mlp_xla_int8", lambda m: m.main([])),
    ("bench_ivf", lambda m: m.run()),
    ("bench_ivf", lambda m: m.main([])),
    ("bench_serving", lambda m: m.run(m.parser().parse_args([]))),
    ("bench_serving", lambda m: m.main([])),
    ("bench_pq_matrix", lambda m: m.main(["250k_qb8"])),
])
def test_tools_raise_without_a_card(tool, call, monkeypatch):
    mod = importlib.import_module(f"anyloc_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        call(mod)


@pytest.mark.parametrize("call", [
    lambda: importlib.import_module("anyloc_tpu_torch.tools.dryrun").entry(),
    lambda: importlib.import_module("anyloc_tpu_torch.tools.dryrun").dryrun_multichip(2),
    lambda: importlib.import_module("anyloc_tpu_torch.examples.quickstart").main([]),
    lambda: importlib.import_module("anyloc_tpu_torch.examples.serving").main(["--n-images",
                                                                               "2"]),
    lambda: importlib.import_module("anyloc_tpu_torch.examples.multichip_retrieval").main(
        ["--devices", "2"]),
])
def test_entry_points_raise_without_a_card_unless_asked(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with contextlib.redirect_stdout(io.StringIO()):
            call()


# ---------------------------------------------------------------- the library MLP half


def _mlp_inputs(d=128, hid=4096, n=9, seed=0):
    """The JAX tool's weight draw at width ``d`` (its hidden width 4096)."""
    from anyloc_tpu_torch.tools import bench_mlp_xla_int8 as tool

    w = tool.weights(seed, d=d, hid=hid)
    x = w.pop("rng").standard_normal((2, n, d)).astype(np.float32)
    return x, w


def test_library_mlp_half_equals_the_jax_tools_xla_half():
    """LN, per-row quantize, ``torch._int_mm``, SwiGLU, requantize,
    ``torch._int_mm``, LayerScale + residual on the CPU against the JAX
    tool's ``xla_mlp_int8`` on the same bfloat16 inputs: the int8 codes
    are the same but where a rounding lands on .5 (then one step), so the
    outputs agree within one bfloat16 step (2^-8 relative) on all but
    1e-3 of the elements, and their cosine is >= 0.99999."""
    from anyloc_tpu_torch.tools.bench_mlp_xla_int8 import library_mlp_int8

    jax_tool = _load("tools/bench_mlp_xla_int8.py")
    x, w = _mlp_inputs()
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = library_mlp_int8(xb, torch.from_numpy(w["w12_q"]), torch.from_numpy(w["w12_s"]),
                           torch.from_numpy(w["w3_q"]), torch.from_numpy(w["w3_s"]),
                           torch.from_numpy(w["lns"]), torch.from_numpy(w["lnb"]),
                           torch.from_numpy(w["gamma"])).float().numpy()
    want = np.asarray(jax_tool.xla_mlp_int8(
        jnp.asarray(x, jnp.bfloat16), *(jnp.asarray(w[k]) for k in
                                        ("w12_q", "w12_s", "w3_q", "w3_s", "lns", "lnb",
                                         "gamma"))).astype(jnp.float32))
    far = np.abs(got - want) > 2 ** -8 * np.abs(want) + 1e-6
    assert far.mean() <= 1e-3, far.mean()
    cos = (got * want).sum() / np.linalg.norm(got) / np.linalg.norm(want)
    assert cos >= 0.99999, cos


def test_library_mlp_half_tracks_k3s_plain_version():
    """K3 requantizes the hidden layer per (row, 512 chunk), the library
    route per row (F1): on the CPU (K3's plain version) the outputs' cosine
    is >= 0.999, what the tool prints on the card."""
    from anyloc_tpu_torch.ops.kernels import fused_mlp_int8
    from anyloc_tpu_torch.tools.bench_mlp_xla_int8 import library_mlp_int8

    x, w = _mlp_inputs(n=17, seed=1)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    lib = library_mlp_int8(xb, t["w12_q"], t["w12_s"], t["w3_q"], t["w3_s"], t["lns"], t["lnb"],
                           t["gamma"]).float().flatten()
    k3 = fused_mlp_int8(xb, t["w12_q"], t["w12_s"], None, t["w3_q"], t["w3_s"], None,
                        mlp_type="swiglu_fused", ln_params=(t["lns"], t["lnb"]),
                        layerscale=t["gamma"], residual=True).float().flatten()
    assert float(lib @ k3 / (lib.norm() * k3.norm())) >= 0.999


# ---------------------------------------------------------------- bench_serving


def test_bench_serving_runs_on_the_cpu_with_clients_in_their_own_processes():
    """The whole tool at a tiny size on the CPU (ViT-S/14 block 1, 28 px, 6
    requests from 2 client processes, a 20-row database): both configs
    answer every request; the coalesced replies equal the batch-1 replies
    (scores within ``SCORE_TOL``, ids at the separated ranks), and the
    replies of two images swapped fail that check."""
    from anyloc_tpu_torch.tools import bench_serving

    args = bench_serving.parser().parse_args(
        ["--model", "dinov2_vits14", "--layer", "1", "--img-size", "28", "--requests", "6",
         "--clients", "2", "--db-rows", "20", "--max-batch", "4"])
    lines = []
    res = bench_serving.run(args, device="cpu", emit=lines.append)
    assert set(res["configs"]) == {1, 4}
    assert res["equal"]["max_score_diff"] <= bench_serving.SCORE_TOL
    assert res["equal"]["ranks"] == 30
    assert any("speedup" in ln for ln in lines)
    assert all(c["qps"] > 0 and c["p99_ms"] >= c["p50_ms"] for c in res["configs"].values())
    swapped = dict(res["replies"][4])
    swapped[0], swapped[1] = swapped[1], swapped[0]
    with pytest.raises(RuntimeError):
        bench_serving.compare(swapped, res["replies"][1])


def test_bench_serving_compare_raises_on_a_different_reply():
    """Scores past the bound, or an id that differs at a rank whose scores
    are apart, raise; a swap inside a tie does not."""
    from anyloc_tpu_torch.tools.bench_serving import compare

    want = {0: {"ids": [4, 7, 1], "scores": [0.0171, 0.0165, 0.016495]}}
    tie = {0: {"ids": [4, 1, 7], "scores": [0.0171, 0.0165, 0.016495]}}
    assert compare(tie, want)["ids_compared"] == 1
    with pytest.raises(RuntimeError, match="ids"):
        compare({0: {"ids": [7, 4, 1], "scores": [0.0171, 0.0165, 0.016495]}}, want)
    with pytest.raises(RuntimeError, match="scores move"):
        compare({0: {"ids": [4, 7, 1], "scores": [0.0171, 0.01652, 0.016495]}}, want)
    # another image's reply: its top-5 ~1e-3 away, as this tool's scores lie
    other = {0: {"ids": [9, 2, 5], "scores": [0.0168, 0.0161, 0.0156]}}
    with pytest.raises(RuntimeError):
        compare(other, want)


# ---------------------------------------------------------------- the examples


def _vits14_checkpoint(path):
    """A ViT-S/14 state dict from a numpy seed (test_torch_cli's draw)."""
    from anyloc_tpu_torch.models.dinov2 import dinov2_config, init_params

    shapes = {k: tuple(v.shape) for k, v in init_params(
        dinov2_config("dinov2_vits14", dtype=torch.float32), n_blocks=12).items()}
    shapes.update({"norm.weight": (384,), "norm.bias": (384,)})
    rng = np.random.default_rng(0)
    sd = {}
    for k, s in sorted(shapes.items()):
        scale = np.prod(s[1:]) ** -0.5 if len(s) > 1 else 0.1
        sd[k] = torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32))
    torch.save(sd, path)
    return rng


def test_quickstart_matches_the_jax_example(tmp_path, monkeypatch, capsys):
    """Both quickstarts on their synthetic gardens tree (the same bytes),
    with one ViT-S/14 checkpoint in float32 and one 8-word vocabulary
    (F2) patched into their ``PipelineArgs``: the printed recalls equal."""
    import anyloc_tpu.config as jax_config
    from anyloc_tpu.data.base import VPRDataset as JaxVPRDataset

    import anyloc_tpu_torch.config as port_config
    from anyloc_tpu_torch.data.base import VPRDataset
    from anyloc_tpu_torch.examples import quickstart

    rng = _vits14_checkpoint(tmp_path / "vits14.pth")
    (tmp_path / "vocab").mkdir()
    np.savez(tmp_path / "vocab" / "c_centers.npz",
             centers=rng.standard_normal((8, 384)).astype(np.float32))
    for mod, ds in ((jax_config, JaxVPRDataset), (port_config, VPRDataset)):
        base = mod.PipelineArgs

        def make(base=base):
            a = base()
            a.extractor.checkpoint = str(tmp_path / "vits14.pth")
            a.extractor.dtype = "float32"
            a.vlad.cache_dir = str(tmp_path / "vocab")
            return a

        monkeypatch.setattr(mod, "PipelineArgs", make)
        monkeypatch.setattr(ds, "use_native_loader", False)
    got = quickstart.main(["--cpu"])
    port_line = capsys.readouterr().out.strip().splitlines()[-1]
    monkeypatch.setattr(sys, "argv", ["quickstart.py"])
    _load("examples/quickstart.py").main()
    jax_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert {k: v for k, v in got.items() if k.startswith("R@")} == eval(jax_line)
    assert port_line == jax_line


def test_serving_example_matches_the_jax_example(monkeypatch, capsys):
    """Both serving walkthroughs at 8 images of 56 px, ViT-S/14 block 1,
    VLAD-4, int8_full with uint8 transfer: the deterministic parts of the
    printed stages equal (the vocabulary's image count, the descriptors'
    count and width, self-retrieval R@1 = 1.00)."""
    from anyloc_tpu_torch.examples import serving

    flags = ["--n-images", "8", "--layer", "1", "--img-size", "56", "--batch", "4",
             "--clusters", "4"]
    res = serving.main(flags + ["--cpu"])
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serving.py"] + flags)
    _load("examples/serving.py").main()
    jax_out = capsys.readouterr().out

    def facts(text):
        return (re.search(r"\[vocab\] fit VLAD-\d+ on \d+ images", text).group(0),
                re.search(r"\[serve\] \d+ images disk->VLAD descriptors \(dim \d+\)",
                          text).group(0),
                re.search(r"self-retrieval R@1=\S+", text).group(0),
                re.search(r"int8_full trunk, uint8 transfer", text).group(0))

    assert facts(port_out) == facts(jax_out)
    assert res["recalls"][1] == 1.0


def test_multichip_example_prints_the_jax_examples_equalities(capsys):
    """Two Gloo ranks on the CPU at the JAX example's sizes: the vocabulary's shape,
    exact self-match 1.00, the routed VLADs' shape with every image kept,
    and the sequence-parallel facets' shape, as the JAX example prints them
    for the same devices."""
    from anyloc_tpu_torch.examples import multichip_retrieval

    multichip_retrieval.main(["--devices", "2", "--cpu"])
    out = capsys.readouterr().out
    assert "vocabulary: (32, 256)" in out
    assert "exact self-match rate 1.00" in out
    assert "expert-parallel VLAD: (4, 8192)" in out and "kept=4)" in out
    assert "sequence-parallel facets: (2, 16, 96)" in out
    assert re.search(r"self top-1 pq \d\.\d\d / ivf_pq \d\.\d\d", out)


def test_quickstart_notebook_runs_on_the_cpu(monkeypatch):
    """The notebook's five code cells, in order, from its own directory:
    the descriptors written one .npy per image, recalls in [0, 1]."""
    nb_dir = ROOT / "anyloc_tpu_torch" / "examples"
    nb = json.loads((nb_dir / "quickstart.ipynb").read_text())
    code = [c for c in nb["cells"] if c["cell_type"] == "code"]
    assert len(code) == 5
    assert "DEVICE" in "".join(code[0]["source"])
    monkeypatch.chdir(nb_dir)
    ns = {}
    with contextlib.redirect_stdout(io.StringIO()):
        for c in code:
            exec("".join(c["source"]), ns)
    assert ns["db_vlads"].shape == (len(ns["paths"]), 8 * 384)
    assert len(list(ns["out_dir"].glob("*.npy"))) == len(ns["paths"])
    assert all(0.0 <= v <= 1.0 for v in ns["recalls"].values())


# ---------------------------------------------------------------- the dryrun


def _jax_ok_lines():
    """The "... ok" prefixes the JAX dryrun prints, in order."""
    src = (ROOT / "__graft_entry__.py").read_text()
    return re.findall(r'print\(f?"([A-Za-z0-9 \-_x]+? ok)\b', src)


MODEL_AXIS = ("tp_split ok", "pipeline parallel ok", "sequence parallel ok",
              "expert parallel ok", "dp x pp training ok", "dp x sp ok", "dp x ep ok")


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_prints_every_ok_line(n):
    """``dryrun_multichip(n, device="cpu")`` on n Gloo ranks prints the JAX
    dryrun's "... ok" lines in its order: all of them at n = 4; at n = 2,
    as the JAX dryrun, all but the model-axis sections."""
    from anyloc_tpu_torch.tools.dryrun import dryrun_multichip

    jax_lines = _jax_ok_lines()
    assert len(jax_lines) == 16 and set(MODEL_AXIS) <= set(jax_lines)
    lines = []
    with contextlib.redirect_stdout(io.StringIO()):
        dryrun_multichip(n, device="cpu", emit=lines.append)
    got = [ln.split(":")[0].split(" (")[0] for ln in lines if " ok" in ln]
    want = [p for p in jax_lines if n >= 4 or p not in MODEL_AXIS]
    assert [g[:len(w)] for g, w in zip(got, want)] == want and len(got) == len(want)
    assert lines[0].startswith("mesh: {'data': %d, 'model': %d}" % ((n, 1) if n == 2 else (2, 2)))


def test_entry_is_the_flagship_step(monkeypatch):
    """``entry(device="cpu")`` with the trunk cut to 2 blocks at width 64 (the
    G/14 config monkeypatched small, layer 1): the step equals the trunk's
    value facet of the layer, CLS dropped, L2-normalized, through
    ``vlad_aggregate``, [4, 32 · 64] on zero images and zero centers."""
    import dataclasses

    from anyloc_tpu_torch.models import dinov2
    from anyloc_tpu_torch.ops.common import l2_normalize
    from anyloc_tpu_torch.ops.vlad import vlad_aggregate
    from anyloc_tpu_torch.tools import dryrun

    real = dinov2.dinov2_config

    def small(name, **kw):
        return dataclasses.replace(real("dinov2_vits14", **kw), embed_dim=64, num_heads=2,
                                   depth=32)

    monkeypatch.setattr(dinov2, "dinov2_config", small)
    fn, (params, centers, images) = dryrun.entry(device="cpu")
    assert images.shape == (4, 224, 224, 3) and centers.shape == (32, 64)
    assert params["blocks.31.attn.qkv.weight"].dtype == torch.bfloat16
    images = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 28, 28, 3)).astype(np.float32))
    centers = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (32, 64)).astype(np.float32))
    got = fn(params, centers, images)
    trunk = dinov2.build_vit(small("dinov2_vitg14", dtype=torch.bfloat16), params, 32,
                             device="cpu")
    with torch.no_grad():
        facet = trunk(images, capture_layer=31, capture_facet="value")
    want = vlad_aggregate(l2_normalize(facet[:, 1:].float()), centers)
    assert got.shape == (2, 32 * 64) and torch.equal(got, want)
