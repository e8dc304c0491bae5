"""The PyTorch port's main path against the JAX package, module by module
and as a whole, in float32 on the CPU.

Weights and inputs come from numpy seeds and go to both packages: the
JAX side receives the weights through ``convert_dinov2``, the port loads
the same DINOv2-named state dict natively. Tolerances are stated per test.
"""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from oracles import TorchMiniDino

from anyloc_tpu.data.base import VPRDataset as JaxVPRDataset
from anyloc_tpu.models.dinov2 import convert_dinov2
from anyloc_tpu.models.extractor import ViTFacetExtractor as JaxExtractor
from anyloc_tpu.models.vit import ViTConfig as JaxViTConfig
from anyloc_tpu.ops.kmeans import KMeans as JaxKMeans
from anyloc_tpu.ops.retrieval import get_top_k_recall as jax_get_top_k_recall
from anyloc_tpu.ops.retrieval import top_k_search as jax_top_k_search
from anyloc_tpu.ops.vlad import VLAD as JaxVLAD
from anyloc_tpu.ops.vlad import vlad_aggregate as jax_vlad_aggregate
from anyloc_tpu.pipelines.engine import DescriptorEngine as JaxEngine

import anyloc_tpu_torch as port
from anyloc_tpu_torch import cli as port_cli
from anyloc_tpu_torch.ops import retrieval as port_retrieval
from anyloc_tpu_torch.models.dinov2 import from_jax_params, native_state_dict

torch.set_num_threads(2)

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "e2e"
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _mini_state_dict(seed, d=64, depth=4, heads=4, img=56, swiglu=False, regs=0):
    """A DINOv2-named state dict with numpy-seeded values (LayerScale and
    pos-embed scaled up so every block and the interpolation matter)."""
    layout = TorchMiniDino(img_size=img, d=d, depth=depth, heads=heads,
                           swiglu=swiglu).state_dict()
    if regs:
        layout["register_tokens"] = torch.zeros(1, regs, d)
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in layout.items():
        shape = tuple(v.shape)
        if k.endswith("gamma"):
            a = 0.5 + 0.1 * rng.standard_normal(shape)
        elif k.endswith(("norm1.weight", "norm2.weight", "norm.weight")):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif k.endswith("bias"):
            a = 0.05 * rng.standard_normal(shape)
        elif k in ("cls_token", "pos_embed", "register_tokens"):
            a = 0.5 * rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) * np.prod(shape[1:]) ** -0.5
        sd[k] = torch.from_numpy(a.astype(np.float32))
    return sd


def _configs(d, depth, heads, img, swiglu=False, regs=0):
    kw = dict(img_size=img, patch_size=14, embed_dim=d, depth=depth,
              num_heads=heads, mlp_type="swiglu_fused" if swiglu else "mlp",
              layerscale_init=1e-5, ln_eps=1e-6, num_register_tokens=regs)
    return JaxViTConfig(dtype=jnp.float32, **kw), port.ViTConfig(dtype=torch.float32, **kw)


def _cos_rows(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12)


def test_from_jax_params_round_trip():
    """state dict -> convert_dinov2 -> from_jax_params gives back every
    tensor exactly (GELU and SwiGLU blocks)."""
    for swiglu in (False, True):
        sd = _mini_state_dict(1, swiglu=swiglu)
        jcfg, _ = _configs(64, 4, 4, 56, swiglu)
        back = from_jax_params(convert_dinov2(sd, jcfg))
        assert set(back) == set(sd)
        for k in sd:
            torch.testing.assert_close(back[k], sd[k], atol=0, rtol=0, msg=k)


def test_native_state_dict_chunked_keys_and_truncation():
    sd = _mini_state_dict(2)
    chunked = {}
    for k, v in sd.items():
        if k.startswith("blocks."):
            i = int(k.split(".")[1])
            k = f"blocks.{i // 2}.{k[len('blocks.'):]}"   # block_chunks=2 layout
        chunked[k] = v
    chunked["mask_token"] = torch.zeros(1, 64)
    out = native_state_dict(chunked, n_blocks=3)
    want = {k for k in sd if not k.startswith(("blocks.3.", "norm."))}
    assert set(out) == want
    for k in want:
        assert out[k] is sd[k]


# facet parity: d=64 / 4 heads / depth 4 at 56 px (native 4x4 grid) and
# 160 px (pos-embed interpolation, K5 route); d=128 / hd=64 / depth 2 at
# 504 px (1297 tokens: the long-N route through K2); the SwiGLU MLP of
# ViT-G with register tokens and CLS kept. Facets are unit vectors; both
# sides run float32 with different summation orders (the measured gap is
# ~3e-7), so 1e-5 absolute bounds the drift over the blocks.
@pytest.mark.parametrize("d,depth,heads,px,layer,facet,swiglu,regs,use_cls", [
    (64, 4, 4, 56, 2, "value", False, 0, False),
    (64, 4, 4, 160, 2, "value", False, 0, False),
    (64, 4, 4, 160, 3, "token", False, 0, False),
    (128, 2, 2, 504, 1, "value", False, 0, False),
    (64, 2, 4, 160, 1, "key", True, 4, True),
    (64, 2, 4, 112, 1, "query", True, 0, False),
])
def test_facet_parity_with_jax_extractor(d, depth, heads, px, layer, facet, swiglu,
                                         regs, use_cls):
    sd = _mini_state_dict(3, d=d, depth=depth, heads=heads, swiglu=swiglu, regs=regs)
    jcfg, pcfg = _configs(d, depth, heads, 56, swiglu, regs)
    imgs = np.random.default_rng(4).standard_normal((2, px, px, 3)).astype(np.float32)
    jext = JaxExtractor(jcfg, convert_dinov2(sd, jcfg), layer, facet, use_cls=use_cls)
    want = np.asarray(jext(jnp.asarray(imgs)))
    got = port.ViTFacetExtractor(pcfg, sd, layer, facet, use_cls=use_cls,
                                 device="cpu")(imgs).numpy()
    assert got.shape == want.shape == (2, (px // 14) ** 2 + use_cls, d)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_random_init_dinov2_extractor_shapes():
    ext = port.DinoV2ExtractFeatures("dinov2_vits14", 0, "value", dtype="float32",
                                      device="cpu")
    assert len(ext.model.blocks) == 1           # truncated trunk
    out = ext(np.zeros((1, 56, 56, 3), np.uint8))  # uint8: normalized in-model
    assert tuple(out.shape) == (1, 16, 384)
    torch.testing.assert_close(out.norm(dim=-1), torch.ones(1, 16))


def test_kmeans_matches_jax_from_shared_init():
    """The port cannot reproduce jax.random.choice (ROADMAP F2), so it
    starts from the same rows. Well-separated blobs: no label near-ties,
    so 100 Lloyd steps agree to float32 rounding (1e-5)."""
    rng = np.random.default_rng(5)
    blobs = rng.standard_normal((8, 32)) * 3
    x = (blobs[rng.integers(0, 8, 400)] + 0.3 * rng.standard_normal((400, 32))).astype(np.float32)
    jk = JaxKMeans(8, seed=3).fit(jnp.asarray(x))
    init_idx = np.asarray(jax.random.choice(jax.random.PRNGKey(3), 400, shape=(8,), replace=False))
    pk = port.KMeans(8).fit(torch.from_numpy(x), init_centers=torch.from_numpy(x[init_idx]))
    np.testing.assert_allclose(pk.centroids.numpy(), np.asarray(jk.centroids), atol=1e-5)
    np.testing.assert_array_equal(pk.predict(torch.from_numpy(x)).numpy(),
                                  np.asarray(jk.predict(jnp.asarray(x))))


@pytest.mark.parametrize("method", ["cosine", "l2"])
def test_top_k_search_matches_jax(method):
    rng = np.random.default_rng(6)
    db = rng.standard_normal((50, 32)).astype(np.float32)
    qu = rng.standard_normal((7, 32)).astype(np.float32)
    js, ji = jax_top_k_search(jnp.asarray(db), jnp.asarray(qu), 5, method)
    ps, pi = port.top_k_search(torch.from_numpy(db), torch.from_numpy(qu), 5, method)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-5)


def test_get_top_k_recall_with_sub_sampling_matches_jax():
    rng = np.random.default_rng(7)
    db = rng.standard_normal((40, 16)).astype(np.float32)
    qu = rng.standard_normal((30, 16)).astype(np.float32)
    gt = [rng.choice(40, size=rng.integers(0, 4), replace=False) for _ in range(30)]
    args = ([1, 3, 5], db[::2], qu[::3], gt)
    kw = dict(sub_sample_db=2, sub_sample_qu=3)
    jd, ji, jr = jax_get_top_k_recall(*args, **kw)
    pd, pi, pr = port.get_top_k_recall(*args, **kw, device="cpu")
    np.testing.assert_array_equal(pi, np.asarray(ji))
    np.testing.assert_allclose(pd, np.asarray(jd), atol=1e-5)
    assert pr == jr


def test_get_top_k_recall_runs_on_the_card_unless_asked():
    """F11: the search runs on ``device``, for numpy and tensor inputs
    alike; None means the card, so without one it raises instead of
    searching on the host."""
    db = np.eye(4, dtype=np.float32)
    args = ([1], db, db[:2], [np.array([0]), np.array([1])])
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_gpu.py holds the card's search")
    for a in (args, ([1], torch.from_numpy(db), torch.from_numpy(db[:2]), args[3])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.get_top_k_recall(*a)
        _, idx, rec = port.get_top_k_recall(*a, device="cpu")
        assert idx[:, 0].tolist() == [0, 1] and rec == {1: 1.0}


def test_pipelines_search_on_the_engines_device(monkeypatch):
    """F11: both pipelines hand retrieval the engine's device (here the
    CPU, as the caller asked), not the host by default."""
    db, qu, gt = _fixture()
    _, pcfg = _configs(64, 2, 4, 56)
    eng = port.DescriptorEngine(batch_size=8, extractor=port.ViTFacetExtractor(
        pcfg, _mini_state_dict(14, depth=2), 1, "value", device="cpu"))
    ds = port.VPRDataset(db, qu, soft_positives_per_query=gt, img_size=(56, 56))
    largs = port.PipelineArgs()
    largs.vlad.num_clusters, largs.top_k_vals = 4, [1, 2]
    seen = []
    real = port_retrieval.get_top_k_recall

    def spy(*a, **kw):
        seen.append(kw.get("device"))
        return real(*a, **kw)

    from anyloc_tpu_torch.pipelines import global_vocab_vlad, vlad_pipeline

    monkeypatch.setattr(global_vocab_vlad, "get_top_k_recall", spy)
    monkeypatch.setattr(vlad_pipeline, "get_top_k_recall", spy)
    port.run_global_vocab_vlad(largs, dataset=ds, vocab_dataset=ds, engine=eng, verbose=False)
    port.run_vlad_pipeline(largs, dataset=ds, engine=eng, verbose=False)
    assert seen == [torch.device("cpu")] * 2


def test_masked_vlad_matches_jax():
    rng = np.random.default_rng(8)
    descs = rng.standard_normal((3, 20, 16)).astype(np.float32)
    centers = rng.standard_normal((4, 16)).astype(np.float32)
    mask = (rng.random((3, 20)) > 0.3).astype(np.float32)
    for mode in ("hard", "soft"):
        want = jax_vlad_aggregate(jnp.asarray(descs), jnp.asarray(centers),
                                  vlad_mode=mode, mask=jnp.asarray(mask), impl="xla")
        got = port.vlad_aggregate(torch.from_numpy(descs), torch.from_numpy(centers),
                                  vlad_mode=mode, mask=torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_vocabulary_cache_is_shared_with_jax(tmp_path):
    """A c_centers.npz written by either package loads in the other."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((200, 16)).astype(np.float32)
    jv = JaxVLAD(4, cache_dir=str(tmp_path / "j"))
    jv.fit(jnp.asarray(x))
    pv = port.VLAD(4, cache_dir=str(tmp_path / "j"))
    assert pv.can_use_cache_vlad()
    pv.fit(None)
    np.testing.assert_array_equal(pv.c_centers.numpy(), np.asarray(jv.c_centers))
    pw = port.VLAD(4, cache_dir=str(tmp_path / "p"))
    pw.fit(torch.from_numpy(x))
    jw = JaxVLAD(4, cache_dir=str(tmp_path / "p"))
    jw.fit(None)
    np.testing.assert_array_equal(np.asarray(jw.c_centers), pw.c_centers.numpy())


def _fixture():
    db = port.listdir_abs(str(FIXTURE), "db")
    qu = port.listdir_abs(str(FIXTURE), "queries")
    return db, qu, list(np.load(FIXTURE / "gt.npy", allow_pickle=True))


@pytest.mark.parametrize("transfer_dtype", ["float32", "uint8"])
def test_slice_matches_jax_pipeline_on_fixture(tmp_path, transfer_dtype):
    """The whole slice on the committed JPEG fixture: dataset -> engine ->
    fused VLAD (centers from one shared c_centers.npz) -> recall, built as
    tests/test_e2e_oracle.py builds the JAX pipeline, with PIL decode on
    both sides; "uint8" ships raw bytes and normalizes in the extractor.
    Per-image VLAD cosine >= 0.9999, identical top-1 ids and recalls."""
    db, qu, gt = _fixture()
    resize, layer, facet, nc, top_k = (160, 160), 2, "value", 8, [1, 5]
    sd = _mini_state_dict(10)
    jcfg, pcfg = _configs(64, 4, 4, 56)

    jds = JaxVPRDataset(db, qu, soft_positives_per_query=gt, img_size=resize)
    jds.use_native_loader = False
    jeng = JaxEngine(model_type="mini", desc_layer=layer, desc_facet=facet, batch_size=8,
                     extractor=JaxExtractor(jcfg, convert_dinov2(sd, jcfg), layer, facet),
                     transfer_dtype=transfer_dtype)
    descs = jeng.extract_dataset(jds, "db", verbose=False)
    vdir = tmp_path / "vocab"
    vdir.mkdir()
    np.savez(vdir / "c_centers.npz", centers=np.ascontiguousarray(descs[::2, 7, :][:nc]))

    jvlad = JaxVLAD(nc, desc_dim=64, cache_dir=str(vdir))
    jvlad.fit(None)
    jall = np.asarray(jeng.extract_vlads_dataset(jds, jvlad, which="all", verbose=False))
    _, jidx, jrec = jax_get_top_k_recall(top_k, jall[:len(db)], jall[len(db):], gt)

    pds = port.VPRDataset(db, qu, soft_positives_per_query=gt, img_size=resize)
    pds.use_native_loader = False
    peng = port.DescriptorEngine(batch_size=8, extractor=port.ViTFacetExtractor(pcfg, sd, layer, facet,
                                                                                 device="cpu"),
                                 transfer_dtype=transfer_dtype)
    pvlad = port.VLAD(nc, desc_dim=64, cache_dir=str(vdir))
    pvlad.fit(None)
    pall = peng.extract_vlads_dataset(pds, pvlad, which="all", verbose=False)
    _, pidx, prec = port.get_top_k_recall(top_k, pall[:len(db)], pall[len(db):], gt, device="cpu")

    assert pall.shape == jall.shape == (24, nc * 64)
    assert _cos_rows(pall, jall).min() >= 0.9999
    np.testing.assert_array_equal(pidx[:, 0], np.asarray(jidx)[:, 0])
    assert prec == jrec


def test_run_global_vocab_vlad_on_fixture():
    db, qu, gt = _fixture()
    sd = _mini_state_dict(11)
    _, pcfg = _configs(64, 4, 4, 56)
    largs = port.PipelineArgs()
    largs.vlad.num_clusters = 8
    largs.top_k_vals = [1, 5]
    largs.extractor.desc_layer = 2
    ds = port.VPRDataset(db, qu, soft_positives_per_query=gt, img_size=(112, 112))
    eng = port.DescriptorEngine(batch_size=8, extractor=port.ViTFacetExtractor(pcfg, sd, 2, "value",
                                                                                        device="cpu"))
    res = port.run_global_vocab_vlad(largs, dataset=ds, vocab_dataset=ds, engine=eng, verbose=False)
    assert res["VLAD-Dim"] == str(8 * 64) and res["Num-QU"] == "8"
    assert res["Qual-Indices"].shape == (8, 5)
    assert 0.0 <= res["R@1"] <= res["R@5"] <= 1.0
    # datasets come from the registry under largs.prog.data_vg_dir now
    largs.prog.data_vg_dir = str(FIXTURE / "no-such-root")
    with pytest.raises(FileNotFoundError):
        port.run_global_vocab_vlad(largs, engine=eng, verbose=False)


def test_empty_selection_keeps_three_dims():
    db, _, _ = _fixture()
    _, pcfg = _configs(64, 4, 4, 56)
    eng = port.DescriptorEngine(extractor=port.ViTFacetExtractor(pcfg, None, 1, "value", device="cpu"))
    ds = port.VPRDataset(db[:2], [], img_size=(112, 112))
    out = eng.extract_dataset(ds, "queries", verbose=False)
    assert out.shape == (0, 64, 64)


def _port_queue_titles():
    """The item titles of ROADMAP.md's port queue ("N. **Title.**"), without
    backticks and the closing period or colon."""
    text = (ROOT / "ROADMAP.md").read_text()
    queue = text[text.index("### 1. Port queue"):text.index("### 2.")]
    return {t.replace("`", "").rstrip(".:")
            for t in re.findall(r"^\d+\. \*\*(.+?)\*\*", queue, re.M)}


def _geo(**kw):
    from anyloc_tpu_torch.training.network import GeoLocalizationNet

    return GeoLocalizationNet(**kw)


def _training_call(module, name, *args):
    import importlib

    return getattr(importlib.import_module(f"anyloc_tpu_torch.{module}"), name)(*args)


NOT_PORTED = {
    "cli viz": lambda: port_cli.main(["viz", "--help"]),
    "sweep --plot": lambda: port_cli.main(["sweep", "--plot"]),
    "GeoLocalizationNet(sync_axis=...)": lambda: _geo(sync_axis="data"),
    "load_checkpoint(target=...)": lambda: _training_call("utils.checkpoint", "load_checkpoint",
                                                          ".", object()),
}


@pytest.mark.parametrize("what", sorted(NOT_PORTED))
def test_not_ported_messages_name_a_port_queue_item(what):
    """F9: each "not ported yet" message names its ROADMAP.md port-queue
    item by title, which does not go stale when the queue is renumbered."""
    with pytest.raises(NotImplementedError) as info:
        NOT_PORTED[what]()
    named = re.search(r'port queue: "([^"]+)"', str(info.value))
    assert named, str(info.value)
    assert named.group(1) in _port_queue_titles(), (named.group(1), _port_queue_titles())


def test_import_pulls_in_no_jax():
    """Importing the port and every submodule leaves jax, flax, the JAX
    package and ``regex`` out (the port runs where none of them is
    installed)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import anyloc_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'anyloc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'anyloc_tpu', 'regex')]\n"
        "print(len(list(pkgutil.walk_packages(p.__path__))), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_refuses_without_a_card():
    """Without a CUDA device chip_smoke.py exits non-zero and prints no
    result on stdout."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
