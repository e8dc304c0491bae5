"""The port's sharded extraction and trunk parallelism
(``anyloc_tpu_torch/parallel/``: ``sharded_extract_fn``,
``DescriptorEngine(mesh=...)``, tensor, pipeline, sequence and expert
parallelism) on 2 and 4 Gloo ranks on the CPU against the JAX package on
the virtual 8-device mesh, a mesh of the same shape; and the
``tp_split`` layout on one process.

One group of ranks per world size runs the trunk cases
(``anyloc_tpu_torch/tools/mesh_checks.py``); the checks are parametrized
over its results. The trunk is a float32 ViT of width 128, 4 heads, SwiGLU,
LayerScale 0.5, 6 blocks, one state dict drawn from a seed
(``mesh_checks.vit_params``) that the JAX side gets through
``convert_dinov2``. Bounds, as the JAX package's sharding tests use them:
facets within 2e-5, VLADs and EP VLADs within 1e-5 (``kept`` equal), ring
attention within 1e-5 of dense attention.
"""

import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyloc_tpu.data.base import VPRDataset as JaxVPRDataset
from anyloc_tpu.models.dinov2 import convert_dinov2
from anyloc_tpu.models.extractor import ViTFacetExtractor as JaxExtractor
from anyloc_tpu.models.vit import ViTConfig as JaxViTConfig
from anyloc_tpu.ops.vlad import VLAD as JaxVLAD
from anyloc_tpu.parallel import distributed as jax_dist
from anyloc_tpu.parallel import ep as jax_ep
from anyloc_tpu.parallel import get_mesh as jax_get_mesh
from anyloc_tpu.parallel import pp as jax_pp
from anyloc_tpu.parallel import sp as jax_sp
from anyloc_tpu.parallel import tp as jax_tp
from anyloc_tpu.pipelines.engine import DescriptorEngine as JaxEngine

from anyloc_tpu_torch.models.convert import from_jax_params
from anyloc_tpu_torch.tools import mesh_checks

sys.path.insert(0, str(pathlib.Path(__file__).parent))
torch.set_num_threads(2)
WORLDS = (2, 4)
FACETS = ("5_value", "3_token", "2_query")
EP_RUNS = ("ample", "tight", "oor")


def _jcfg(**kw):
    c = mesh_checks.vit_config("small")
    return JaxViTConfig(img_size=c.img_size, patch_size=c.patch_size, embed_dim=c.embed_dim,
                        depth=c.depth, num_heads=c.num_heads, mlp_type=c.mlp_type,
                        layerscale_init=c.layerscale_init, dtype=jnp.float32, **kw)


def _model_mesh(world):
    return jax_get_mesh(n_data=2, n_model=world // 2) if world >= 4 else \
        jax_get_mesh(n_data=1, n_model=world)


def _jax_refs(world, out, sd):
    """The JAX package's sharded results on a mesh of the port's shape."""
    jcfg = _jcfg()
    jp = convert_dinov2(sd, jcfg)
    refs = {}
    # sharded_extract_fn and the mesh engine
    rng = np.random.default_rng(5)
    w = rng.standard_normal((12, 6)).astype(np.float32)
    data_mesh = jax_get_mesh(n_data=world, n_model=1)
    refs["toy"] = jax_dist.sharded_extract_fn(lambda p, x: jnp.tanh(x @ p), data_mesh)(
        jnp.asarray(w), rng.standard_normal((21, 12)).astype(np.float32))
    paths = [str(out / "extract_images" / f"i{j}.png") for j in range(10)]
    ds = JaxVPRDataset(paths, [], img_size=(56, 56))
    eng = JaxEngine(extractor=JaxExtractor(jcfg, jp, 5, "value"), batch_size=4,
                    dtype="float32", mesh=data_mesh)
    vlad = JaxVLAD(4)
    vlad.c_centers = jnp.asarray(np.load(out / "given" / "extract_centers.npy"))
    refs["float32_vlads"] = eng.extract_vlads_dataset(ds, vlad, "db", verbose=False)
    refs["float32_descs"] = eng.extract_dataset(ds, "db", verbose=False)
    from PIL import Image

    batch = np.stack([np.asarray(Image.open(p), np.float32) / 255.0 for p in paths[:3]])
    refs["float32_batch"] = eng.extract_batch(batch)
    # tensor parallelism over model = world
    tp_mesh = jax_get_mesh(n_data=1, n_model=world)
    ps = jax_tp.split_fused_params(jp)
    ps = jax.device_put(ps, jax_tp.vit_tp_shardings(ps, tp_mesh))
    refs["tp"] = JaxExtractor(_jcfg(tp_split=True), ps, 1, "value")(
        mesh_checks.images("small", 56, 2))
    # pipeline and sequence parallelism
    mesh = _model_mesh(world)
    img = mesh_checks.images("small", 56, 4)
    # jitted: the JAX package's pipeline, ring and expert paths take seconds
    # each when dispatched eagerly, the same programs a fraction compiled
    for name in FACETS:
        layer, facet = int(name.split("_")[0]), name.split("_")[1]
        for kind, fn in (("pp", jax_pp.pipeline_facet_extract), ("sp", jax_sp.sp_facet_extract)):
            refs[f"{kind}_{name}"] = jax.jit(
                lambda p, x, fn=fn, layer=layer, facet=facet: fn(jcfg, p, x, mesh, layer, facet))(
                jp, img)
    spx = jax_sp.SPFacetExtractor(jcfg, jp, 3, "value", mesh)
    refs["sp_extractor"] = spx(jnp.asarray(img))
    refs["sp_extractor_u8"] = spx(jnp.asarray(
        (np.random.default_rng(8).random(img.shape) * 255).astype(np.uint8)))
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    ring_mesh = jax_get_mesh(n_data=1, n_model=world)
    q, k, v = (mesh_checks.inputs("sp", "small")[n] for n in "qkv")
    refs["ring"] = shard_map(
        lambda ql, kl, vl, ml: jax_sp.ring_attention(ql, kl, vl, ml, axis_name="model",
                                                     n_shards=world, vary_axes=("model",)),
        mesh=ring_mesh, in_specs=(P(None, None, "model"),) * 3 + (P("model"),),
        out_specs=P(None, None, "model"))(q, k, v, jnp.asarray(np.arange(16) < 11))
    # expert parallelism
    inp = mesh_checks.inputs("ep", "small")
    for name, route, cap in (("ample", "route", 8.0), ("tight", "route", 0.7),
                             ("oor", "route_oor", 8.0)):
        refs[f"ep_{name}_vlads"], refs[f"ep_{name}_kept"] = jax.jit(
            lambda d, r, e, cap=cap: jax_ep.ep_vlad_aggregate(d, r, e, mesh, capacity_factor=cap))(
            jnp.asarray(inp["descs"]), jnp.asarray(inp[route]), jnp.asarray(inp["experts"]))
    return {k: np.asarray(v) for k, v in refs.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: (port results {case: {name: array}}, JAX results)}."""
    sd = mesh_checks.vit_params(mesh_checks.vit_config("small"), 0)
    out = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"trunk{world}")
        (d / "given").mkdir()
        np.save(d / "given" / "extract_centers.npy",
                np.random.default_rng(13).standard_normal((4, 128)).astype(np.float32))
        cases = ["extract", "tp", "pp", "sp", "ep"]
        mesh_checks.launch(d, world, "gloo", "cpu", "small", cases, timeout=240)
        out[world] = ({c: mesh_checks.results(d, c) for c in cases}, _jax_refs(world, d, sd))
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name,bound", [("float32_vlads", 1e-5), ("float32_descs", 2e-5),
                                        ("float32_batch", 2e-5), ("toy", 1e-5)])
def test_sharded_extraction_matches_jax(runs, world, name, bound):
    """``DescriptorEngine(mesh=...)``: fused VLAD (each rank aggregates its
    images, only the VLADs gather), the patches, ``extract_batch``, and
    ``sharded_extract_fn`` on 21 rows (uneven): within the bound of the
    JAX mesh engine, and equal to the port's engine on one rank."""
    got, refs = runs[world]
    g = got["extract"]
    np.testing.assert_allclose(g[name], refs[name], atol=bound)
    if name != "toy":
        np.testing.assert_array_equal(g[name], g[name.replace("float32_", "float32_single_")])


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_engine_cache_is_written_once_and_read_by_every_rank(runs, world):
    """The second VLAD extraction reads the cache rank 0 wrote: equal to
    the first."""
    g = runs[world][0]["extract"]
    np.testing.assert_array_equal(g["float32_cached"], g["float32_vlads"])


@pytest.mark.parametrize("world", WORLDS)
def test_tensor_parallel_trunk_matches_jax(runs, world):
    """A ``tp_split`` trunk sharded over ``model`` = world (heads and MLP
    columns per rank, row-parallel products all-reduced): facets within
    2e-5 of the JAX TP trunk and of the fused trunk on one rank; a rank
    holds its shards only (4-way: < 0.55 of the replicated bytes, as the
    JAX test bounds it; 2-way: exactly half of every sharded matrix)."""
    got, refs = runs[world]
    g = got["tp"]
    np.testing.assert_allclose(g["tp"], refs["tp"], atol=2e-5)
    np.testing.assert_allclose(g["tp"], g["single"], atol=2e-5)
    rank, rep = float(g["rank_bytes"]), float(g["replicated_bytes"])
    if world == 4:
        assert rank < 0.55 * rep, (rank, rep)
    else:
        cfg = mesh_checks.vit_config("small")
        d, h = cfg.embed_dim, cfg.mlp_hidden
        per_block = 3 * (d * d + d) + d * d + 2 * (d * h + h) + h * d
        assert rep - rank == 2 * per_block * 4 / 2, (rep, rank)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", FACETS)
def test_pipeline_parallel_facets_match_jax(runs, world, name):
    """GPipe over ``model``: q/k/v and token facets within 2e-5 of the JAX
    pipeline and equal to the blocks run in sequence on one rank."""
    got, refs = runs[world]
    g = got["pp"]
    np.testing.assert_allclose(g[name], refs[f"pp_{name}"], atol=2e-5, rtol=1e-5)
    np.testing.assert_array_equal(g[name], g[f"{name}_single"])


@pytest.mark.parametrize("world", WORLDS)
def test_get_mesh_lays_ranks_out_as_the_jax_mesh_lays_devices(runs, world):
    """``get_mesh(n_data, n_model)`` over a world of n_data · n_model ranks:
    rank i sits at (i // n_model, i % n_model), where the JAX mesh of the
    same shape puts device i."""
    coords = runs[world][0]["pp"]["coords"]
    jmesh = _model_mesh(world)
    ids = np.vectorize(lambda dv: dv.id)(jmesh.devices)
    want = [tuple(int(a) for a in np.argwhere(ids == i)[0]) for i in range(world)]
    assert [tuple(c) for c in coords.tolist()] == want
    assert dict(jmesh.shape) == {"data": int(coords[:, 0].max()) + 1,
                                 "model": int(coords[:, 1].max()) + 1}


@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_stage_holds_only_its_blocks(runs, world):
    """A pre-staged run (``stage_params``: this rank's rows) equals the
    unstaged one, and its bytes are 1/S of the stacked blocks'."""
    g = runs[world][0]["pp"]
    np.testing.assert_array_equal(g["staged"], g["5_value"])
    stages = world // 2 if world >= 4 else world
    assert float(g["stage_bytes"]) * stages == float(g["stacked_bytes"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", FACETS)
def test_sequence_parallel_facets_match_jax(runs, world, name):
    """Tokens sharded over ``model`` (17 tokens padded to the axis), ring
    attention across the shards: facets within 2e-5 of the JAX
    sequence-parallel trunk."""
    got, refs = runs[world]
    np.testing.assert_allclose(got["sp"][name], refs[f"sp_{name}"], atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["extractor", "extractor_u8"])
def test_sp_extractor_matches_jax_and_one_rank(runs, world, name):
    """``SPFacetExtractor`` on float32 and uint8 images: within 2e-5 of the
    JAX one and of ``ViTFacetExtractor`` on one rank."""
    got, refs = runs[world]
    g = got["sp"]
    np.testing.assert_allclose(g[name], refs[f"sp_{name}"], atol=2e-5)
    np.testing.assert_allclose(g[name], g[f"{name}_single"], atol=2e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_ring_attention_matches_dense_and_jax(runs, world):
    """Ring attention with 11 real keys of 16 over the axis (an all-padded
    shard at 4 ranks): within 1e-5 of dense softmax attention over the
    real keys and of the JAX ring."""
    got, refs = runs[world]
    q, k, v = (mesh_checks.inputs("sp", "small")[n] for n in "qkv")
    t = 11
    s = np.einsum("bhqd,bhkd->bhqk", q[:, :, :t] * 4 ** -0.5, k[:, :, :t])
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.einsum("bhqk,bhkd->bhqd", p, v[:, :, :t])
    ring = got["sp"]["ring"][:, :, :t]
    np.testing.assert_allclose(ring, want, atol=1e-5)
    np.testing.assert_allclose(ring, refs["ring"][:, :, :t], atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", EP_RUNS)
def test_expert_parallel_vlad_matches_jax(runs, world, name):
    """Routed VLAD, experts sharded over ``model``: ample capacity (nothing
    dropped), tight capacity (some images dropped), out-of-range routes:
    ``kept`` equal to JAX's, kept VLADs within 1e-5 of JAX's and of the
    direct per-image VLAD, dropped ones zero."""
    got, refs = runs[world]
    g = got["ep"]
    kept = g[f"{name}_kept"]
    np.testing.assert_array_equal(kept, refs[f"ep_{name}_kept"])
    np.testing.assert_allclose(g[f"{name}_vlads"], refs[f"ep_{name}_vlads"], atol=1e-5)
    np.testing.assert_allclose(g[f"{name}_vlads"][kept], g["single"][kept], atol=1e-5)
    assert not (~kept).any() or np.abs(g[f"{name}_vlads"][~kept]).max() == 0.0
    if name == "ample":
        assert kept.all()
    if name == "tight":
        assert kept.sum() < kept.size
    if name == "oor":
        assert not kept[3] and not kept[7] and kept.sum() == 14


@pytest.mark.parametrize("world", WORLDS)
def test_expert_parallel_refuses_shapes_the_mesh_cannot_split(runs, world):
    """Experts that do not divide the expert axis and a batch that does not
    divide the mesh raise ValueError, as in the JAX package."""
    assert runs[world][0]["ep"]["errors"].all()


# ---------------------------------------------------------------- one process


def _mini(seed, depth=2, swiglu=True):
    from oracles import TorchMiniDino

    torch.manual_seed(seed)
    return TorchMiniDino(img_size=56, d=64, depth=depth, heads=4, swiglu=swiglu).eval()


def test_split_fused_params_matches_jax_and_loads_a_jax_tp_split_tree():
    """``split_fused_params`` on the port's state dict equals the JAX
    split of the same weights (through ``from_jax_params``), which loads a
    JAX ``tp_split`` tree as it is."""
    from anyloc_tpu_torch.parallel.tp import split_fused_params

    sd = mesh_checks.vit_params(mesh_checks.vit_config("small"), 1)
    got = split_fused_params(sd)
    want = from_jax_params(jax_tp.split_fused_params(convert_dinov2(sd, _jcfg())))
    assert set(got) == set(want)
    assert "blocks.0.attn.wq.weight" in got and "blocks.0.mlp.w2.bias" in got
    for key in got:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=0, err_msg=key)
    assert split_fused_params(got).keys() == got.keys()


@pytest.mark.parametrize("swiglu", [True, False])
def test_tp_split_trunk_equals_the_fused_trunk_and_jax(swiglu):
    """``ViT(ViTConfig(tp_split=True))`` from a DINOv2 checkpoint (split on
    load, as the JAX converter splits it): tokens within 1e-5 of the fused
    trunk and of the JAX ``tp_split`` trunk."""
    from anyloc_tpu.models.vit import ViT as JaxViT

    from anyloc_tpu_torch.models.dinov2 import build_vit, dinov2_config

    tm = _mini(2, swiglu=swiglu)
    kw = dict(img_size=56, embed_dim=64, depth=2, num_heads=4,
              mlp_type="swiglu_fused" if swiglu else "mlp")
    cfg = dataclasses.replace(dinov2_config("dinov2_vits14", dtype=torch.float32), **kw)
    img = np.random.default_rng(3).standard_normal((1, 56, 56, 3)).astype(np.float32)
    with torch.inference_mode():
        fused = build_vit(cfg, tm.state_dict())(torch.from_numpy(img))["tokens"].numpy()
        split = build_vit(dataclasses.replace(cfg, tp_split=True), tm.state_dict())
        assert hasattr(split.blocks[0].attn, "wq") and not hasattr(split.blocks[0].attn, "qkv")
        got = split(torch.from_numpy(img))["tokens"].numpy()
    from anyloc_tpu.models.dinov2 import dinov2_config as jax_dinov2_config

    jcfg = dataclasses.replace(jax_dinov2_config("dinov2_vits14", dtype=jnp.float32), **kw,
                               tp_split=True)
    want = np.asarray(JaxViT(jcfg).apply(convert_dinov2(tm.state_dict(), jcfg), img)["tokens"])
    np.testing.assert_allclose(got, fused, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_tp_split_honoured_by_convert_dino_v1():
    """``convert_dino_v1`` with ``tp_split`` emits wq / wk / wv
    (``maybe_tp_split``), and the split trunk's tokens equal the JAX
    converter's split trunk's."""
    from oracles import TorchMiniDino

    from anyloc_tpu.models import dino_v1 as jdino
    from anyloc_tpu.models.vit import ViT as JaxViT

    from anyloc_tpu_torch.models import dino_v1 as pdino
    from anyloc_tpu_torch.models.convert import materialize
    from anyloc_tpu_torch.models.vit import ViT

    torch.manual_seed(5)
    tm = TorchMiniDino(img_size=32, patch=16, d=32, depth=2, heads=4).eval()
    jcfg = dataclasses.replace(jdino.dino_v1_config("dino_vits16", img_size=32,
                                                    dtype=jnp.float32),
                               embed_dim=32, depth=2, num_heads=4, tp_split=True)
    pcfg = dataclasses.replace(pdino.dino_v1_config("dino_vits16", img_size=32,
                                                    dtype=torch.float32),
                               embed_dim=32, depth=2, num_heads=4, tp_split=True)
    ckpt = {k: v for k, v in tm.state_dict().items() if ".ls" not in k}   # v1 has no LayerScale
    sd = pdino.convert_dino_v1(ckpt, pcfg)
    assert "blocks.0.attn.wq.weight" in sd and "blocks.0.attn.qkv.weight" not in sd
    img = np.random.default_rng(7).standard_normal((1, 32, 32, 3)).astype(np.float32)
    with torch.inference_mode():
        got = materialize(lambda: ViT(pcfg), sd, "cpu")(torch.from_numpy(img))["tokens"]
    want = JaxViT(jcfg).apply(jdino.convert_dino_v1(ckpt, jcfg), img)["tokens"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_tp_split_with_int8_full_runs_the_jax_trunks_route():
    """Under ``tp_split`` the int8_full trunk runs per-row ``qdense`` for
    every tower and its attention unfused (the K4 / K3 halves need the
    fused layouts), as the JAX trunk does: facets within 1e-4 of the JAX
    ``tp_split`` int8_full trunk on the same quantized weights."""
    from anyloc_tpu.ops.quant import quantize_vit_params as jax_quantize

    from anyloc_tpu_torch.models.extractor import ViTFacetExtractor
    from anyloc_tpu_torch.ops.quant import quantize_vit_params
    from anyloc_tpu_torch.parallel.tp import split_fused_params

    cfg = mesh_checks.vit_config("small", tp_split=True, quant="int8_full")
    fused = mesh_checks.vit_params(mesh_checks.vit_config("small"), 2)
    q = quantize_vit_params(split_fused_params(fused), "int8_full", min_size=1)
    img = mesh_checks.images("small", 56, 2)
    got = ViTFacetExtractor(cfg, q, 3, "value", device="cpu")(img).numpy()
    jp = jax_quantize(jax_tp.split_fused_params(convert_dinov2(fused, _jcfg())), "int8_full",
                      min_size=1)
    want = np.asarray(JaxExtractor(_jcfg(tp_split=True, quant="int8_full"), jp, 3, "value")(img))
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("mlp_type", ["swiglu_fused", "mlp"])
def test_tp_split_refuses_int8_fused_f23(mlp_type):
    """F23: the JAX ``tp_split`` trunk under ``int8_fused`` builds float MLP
    layers while ``quantize_vit_params`` quantizes them, so it cannot apply
    its own tree (Flax finds no ``kernel``); the port's config refuses the
    pair with a ValueError that names the modes that work."""
    from flax.errors import ScopeParamNotFoundError

    from anyloc_tpu.models.vit import ViT as JaxViT
    from anyloc_tpu.ops.quant import quantize_vit_params as jax_quantize

    jcfg = dataclasses.replace(_jcfg(), mlp_type=mlp_type, depth=2)
    jp = jax_quantize(jax_tp.split_fused_params(convert_dinov2(mesh_checks.vit_params(
        dataclasses.replace(mesh_checks.vit_config("small"), mlp_type=mlp_type, depth=2)),
        jcfg)), "int8_fused", min_size=1)
    with pytest.raises(ScopeParamNotFoundError):   # block 0 runs its MLP
        JaxViT(dataclasses.replace(jcfg, tp_split=True, quant="int8_fused")).apply(
            jp, jnp.zeros((1, 56, 56, 3)), capture_layer=1, capture_facet="value")
    with pytest.raises(ValueError, match="int8_fused"):
        mesh_checks.vit_config("small", mlp_type=mlp_type, tp_split=True, quant="int8_fused")


def test_sp_refuses_quant_a_missing_mesh_and_other_facets():
    """As in the JAX package: ``SPFacetExtractor`` needs a mesh, sequence
    parallelism refuses an int8 trunk, and the facet must be q/k/v/token."""
    from anyloc_tpu_torch.parallel import SPFacetExtractor, sp_facet_extract

    cfg = mesh_checks.vit_config("small")
    with pytest.raises(ValueError, match="requires a mesh"):
        SPFacetExtractor(cfg, None, 3, "value", None, device="cpu")
    with pytest.raises(ValueError, match="quant"):
        SPFacetExtractor(dataclasses.replace(cfg, quant="int8"), None, 3, "value", object(),
                         device="cpu")
    with pytest.raises(ValueError, match="q/k/v/token"):
        sp_facet_extract(cfg, {}, np.zeros((1, 56, 56, 3), np.float32), object(), 3, "cls",
                         device="cpu")


def test_tensor_parallelism_needs_the_split_layout():
    """``shard_vit_tp`` refuses a fused-layout trunk (the fused qkv / w12
    cannot shard head- and gate-aligned)."""
    from anyloc_tpu_torch.models.extractor import ViTFacetExtractor
    from anyloc_tpu_torch.parallel.tp import shard_vit_tp

    ext = ViTFacetExtractor(mesh_checks.vit_config("small"), None, 1, "value", device="cpu")
    with pytest.raises(ValueError, match="tp_split"):
        shard_vit_tp(ext.model, object())


def test_mesh_engine_refuses_an_extractor_without_the_forward_hook():
    """Where the JAX engine warns and runs on one device, the port's
    raises: an extractor without ``_forward`` cannot be sharded."""
    from anyloc_tpu_torch.pipelines.engine import DescriptorEngine

    class Plain:
        cfg = mesh_checks.vit_config("small")

        def __call__(self, imgs):
            return imgs

    with pytest.raises(ValueError, match="_forward"):
        DescriptorEngine(extractor=Plain(), mesh=object(), device="cpu")
