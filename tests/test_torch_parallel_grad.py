"""Training through the port's pipeline, ring attention and expert
exchange (F25) on 2 and 4 Gloo ranks on the CPU, against one process and
the JAX package (``jax.grad`` through ``lax.scan`` + ``ppermute`` +
``all_to_all``) on the virtual 8-device mesh, a mesh of the same shape.

One group of ranks per world size runs the cases
(``anyloc_tpu_torch/tools/mesh_checks.py``: ``pptrain``, ``sptrain``,
``eptrain``; ``pp``, ``sp`` and ``ep`` without a gradient; and
``test_torch_parallel_before.case_before``, the same inputs through the forwards
as they were before they carried gradients). Bounds: the dp x pp step's
loss within 1e-5 (relative) and its updated parameters within 2e-5 of the
JAX step's and of one process's (the JAX dryrun's own); gradients within
1e-5 of each tensor's largest |value| (plus 1e-6 of the model's largest,
for gradients that vanish in exact arithmetic); outputs without a gradient
bit-equal to the earlier forwards'.
"""

import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from anyloc_tpu.models.dinov2 import convert_dinov2
from anyloc_tpu.models.dinov2 import dinov2_config as jax_dinov2_config
from anyloc_tpu.models.vit import ViTConfig as JaxViTConfig
from anyloc_tpu.parallel import ep as jax_ep
from anyloc_tpu.parallel import get_mesh as jax_get_mesh
from anyloc_tpu.parallel import pp as jax_pp
from anyloc_tpu.parallel import sp as jax_sp
from anyloc_tpu.training import NetVLAD as JaxNetVLAD
from anyloc_tpu.training import make_triplet_train_step as jax_make_triplet_train_step

from anyloc_tpu_torch.models.convert import from_jax_params
from anyloc_tpu_torch.models.dinov2 import dinov2_config
from anyloc_tpu_torch.parallel import mesh as pmesh
from anyloc_tpu_torch.tools import mesh_checks

sys.path.insert(0, str(pathlib.Path(__file__).parent))
torch.set_num_threads(2)
WORLDS = (2, 4)
SP_FACETS = ("5_value", "3_token")
BEFORE = "test_torch_parallel_before:case_before"


def _close(got, want, rtol=1e-5, floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    bound = rtol * np.abs(want).max() + floor if want.size else 0.0
    assert err <= bound, (err, bound)


def _model_mesh(world):
    return jax_get_mesh(n_data=2, n_model=world // 2) if world >= 4 else \
        jax_get_mesh(n_data=1, n_model=world)


def _port_names(jax_grads):
    """A JAX variables tree of the trunk in the port's naming."""
    return {k: np.asarray(v) for k, v in from_jax_params(jax.device_get(jax_grads)).items()}


def _jax_pptrain(world):
    """The JAX dryrun's dp x pp step on a mesh of the ranks' shape, from the
    weights the ranks draw: (loss, the parameters after it in the port's
    naming)."""
    cfg = dataclasses.replace(dinov2_config("dinov2_vits14", dtype=torch.float32), depth=4)
    sd = mesh_checks.vit_params(cfg, 0)
    jcfg = dataclasses.replace(jax_dinov2_config("dinov2_vits14", dtype=jnp.float32), depth=4)
    inp = mesh_checks.train_inputs("dptrain", "small")
    head = JaxNetVLAD(num_clusters=4, dim=384)
    params = {"trunk": convert_dinov2({k: v.numpy() for k, v in sd.items()}, jcfg),
              "head": {"params": {"assign": {"kernel": jnp.asarray(inp["assign"].T)},
                                  "centroids": jnp.asarray(inp["centroids"])}}}
    mesh = _model_mesh(world)

    def pp_desc(p, images):
        feats = jax_pp.pipeline_facet_extract(jcfg, p["trunk"], images, mesh, 3, "value")
        return head.apply(p["head"], feats[:, 1:])

    from jax.sharding import NamedSharding, PartitionSpec as P

    step = jax_make_triplet_train_step(pp_desc, optax.sgd(1e-2), neg_num=2)
    tuples = mesh_checks.pptrain_tuples("small", mesh.shape["data"])
    tuples = jax.device_put(tuples, NamedSharding(mesh, P("data", None, None, None, None)))
    state, loss = step(step.init_state(params), tuples)
    after = {f"trunk.{k}": v for k, v in _port_names(state.params["trunk"]).items()}
    after["head.assign.weight"] = np.asarray(state.params["head"]["params"]["assign"]["kernel"]).T
    after["head.centroids"] = np.asarray(state.params["head"]["params"]["centroids"])
    return float(loss), after


def _jcfg():
    c = mesh_checks.vit_config("small")
    return JaxViTConfig(img_size=c.img_size, patch_size=c.patch_size, embed_dim=c.embed_dim,
                        depth=c.depth, num_heads=c.num_heads, mlp_type=c.mlp_type,
                        layerscale_init=c.layerscale_init, dtype=jnp.float32)


def _jax_sp_grads(world):
    """jax.grad of sum(facets * w) through the JAX ``sp_facet_extract`` and
    of sum(out * wo) through its ``ring_attention`` (the case's draws)."""
    jcfg = _jcfg()
    sd = mesh_checks.vit_params(mesh_checks.vit_config("small"), 0)
    jp = convert_dinov2({k: v.numpy() for k, v in sd.items()}, jcfg)
    mesh = _model_mesh(world)
    st = mesh_checks.SPTRAIN["small"]
    img = jnp.asarray(mesh_checks.images("small", st["px"], st["batch"]))
    rng = np.random.default_rng(15)
    w = jnp.asarray(rng.standard_normal((st["batch"], 17, 128)).astype(np.float32))
    refs = {}
    for layer, facet in st["facets"]:
        def loss(p, layer=layer, facet=facet):
            return (jax_sp.sp_facet_extract(jcfg, p, img, mesh, layer, facet) * w).sum()

        refs[f"{layer}_{facet}"] = _port_names(jax.jit(jax.grad(loss))(jp))
    wo = rng.standard_normal((2, 3, 16, 4)).astype(np.float32)
    wo[:, :, 11:] = 0.0
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    ring_mesh = jax_get_mesh(n_data=1, n_model=world)
    ring = shard_map(
        lambda ql, kl, vl, ml: jax_sp.ring_attention(ql, kl, vl, ml, axis_name="model",
                                                     n_shards=world, vary_axes=("model",)),
        mesh=ring_mesh, in_specs=(P(None, None, "model"),) * 3 + (P("model"),),
        out_specs=P(None, None, "model"))
    mask = jnp.asarray(np.arange(16) < 11)
    q, k, v = (jnp.asarray(mesh_checks.inputs("sp", "small")[n]) for n in "qkv")
    gq, gk, gv = jax.jit(jax.grad(lambda q, k, v: (ring(q, k, v, mask) * wo).sum(),
                                  argnums=(0, 1, 2)))(q, k, v)
    refs["ring"] = {"q": np.asarray(gq), "k": np.asarray(gk), "v": np.asarray(gv)}
    return refs


def _jax_ep_grads(world):
    """jax.grad of sum(vlads * w), soft VLAD (hard labels have no
    gradient, and a hard residual of an empty cluster is a zero vector),
    for ample and tight capacity: {run: (d descs, d experts, the JAX
    exchange's own d descs)}. The reference is the direct computation
    (each kept image's VLAD against its expert, ``kept`` from the JAX
    exchange), as the JAX dryrun's forward check holds it: jax.grad through
    the JAX exchange itself is NaN (F26), since an empty capacity slot's
    zero descriptors go through the L2 norm, whose gradient at zero is
    0/0."""
    from anyloc_tpu.ops.vlad import vlad_aggregate

    inp = mesh_checks.inputs("ep", "small")
    e, c, d = inp["experts"].shape
    w = jnp.asarray(np.random.default_rng(16).standard_normal(
        (inp["descs"].shape[0], c * d)).astype(np.float32))
    route = jnp.asarray(inp["route"])
    mesh = _model_mesh(world)
    refs = {}
    for name, cap in (("ample", 8.0), ("tight", 0.7)):
        def exchange(descs, experts, cap=cap):
            return jax_ep.ep_vlad_aggregate(descs, route, experts, mesh, capacity_factor=cap,
                                            vlad_mode="soft")

        args = (jnp.asarray(inp["descs"]), jnp.asarray(inp["experts"]))
        kept = jax.jit(exchange)(*args)[1]

        def direct(descs, experts, kept=kept):
            v = jnp.stack([vlad_aggregate(descs[i][None], experts[int(inp["route"][i])],
                                          vlad_mode="soft")[0]
                           for i in range(descs.shape[0])])
            return (v * kept[:, None] * w).sum()

        gd, ge = jax.jit(jax.grad(direct, argnums=(0, 1)))(*args)
        own = jax.jit(jax.grad(lambda a, b: (exchange(a, b)[0] * w).sum()))(*args)
        refs[name] = (np.asarray(gd), np.asarray(ge), np.asarray(own))
    return refs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: ({case: {name: array}}, JAX references)}."""
    out = {}
    cases = ["pptrain", "ppfreeze", "sptrain", "eptrain", "pp", "sp", "ep", BEFORE]
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"grad{world}")
        mesh_checks.launch(d, world, "gloo", "cpu", "small", cases, timeout=300)
        refs = {"pptrain": _jax_pptrain(world), "sp": _jax_sp_grads(world),
                "ep": _jax_ep_grads(world)}
        out[world] = ({c: mesh_checks.results(d, c) for c in cases}, refs)
    return out


# ------------------------------------------------------------------ one rank


def test_pipeline_step_on_one_rank_gives_every_trunk_tensor_its_gradient_f25():
    """F25: a 4-block ViT-S/14 in float32, every trunk tensor requiring a
    gradient, a linear head after the pipeline's value facet of block 3 on
    ``local_mesh(1)``: the output carries a gradient, and every tensor the
    plain trunk's backward reaches gets its gradient, equal within 1e-6 of
    its largest |value| (1e-7 of the trunk's largest where it vanishes);
    the others none, as in the plain trunk."""
    from torch.func import functional_call

    from anyloc_tpu_torch.models.dinov2 import native_state_dict
    from anyloc_tpu_torch.models.vit import ViT
    from anyloc_tpu_torch.parallel import pipeline_facet_extract

    assert not torch.distributed.is_initialized()
    mesh = pmesh.local_mesh(1, backend="gloo")
    try:
        cfg = dataclasses.replace(dinov2_config("dinov2_vits14", dtype=torch.float32), depth=4)
        sd = mesh_checks.vit_params(cfg, 0)
        imgs = np.random.default_rng(0).standard_normal((4, 28, 28, 3)).astype(np.float32)
        head = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (384, 8)).astype(np.float32))
        got = {k: v.clone().requires_grad_(True) for k, v in sd.items()}
        out = pipeline_facet_extract(cfg, got, imgs, mesh, 3, "value", device="cpu")
        assert out.requires_grad and out.grad_fn is not None
        (out @ head).square().sum().backward()
        want = {k: v.clone().requires_grad_(True) for k, v in sd.items()}
        with torch.device("meta"):
            trunk = ViT(cfg, 4)
        ref = functional_call(trunk, native_state_dict(want, 4), (torch.from_numpy(imgs),),
                              {"capture_layer": 3, "capture_facet": "value"})
        (ref @ head).square().sum().backward()
    finally:
        torch.distributed.destroy_process_group()
    reached = sorted(k for k, v in want.items() if v.grad is not None)
    assert len(reached) >= 45
    assert sorted(k for k, v in got.items() if v.grad is not None) == reached
    top = max(float(want[k].grad.abs().max()) for k in reached)
    for k in reached:
        _close(got[k].grad, want[k].grad, 1e-6, 1e-7 * top)


def test_pipeline_refuses_a_prestacked_tree_under_grad():
    """Under autograd the stages read the caller's tensors: a stacked tree
    (copies) is refused."""
    from anyloc_tpu_torch.parallel import pipeline_facet_extract, stack_stage_params

    cfg = dataclasses.replace(mesh_checks.vit_config("small"), depth=2)
    sd = {k: v.requires_grad_(True) for k, v in mesh_checks.vit_params(cfg, 0).items()}
    with pytest.raises(ValueError, match="stacked=None"):
        pipeline_facet_extract(cfg, sd, np.zeros((2, 56, 56, 3), np.float32), None, 1,
                               stacked=stack_stage_params(sd, 1, 1), device="cpu")


class _One:
    """A mesh of one rank with the JAX axis names."""
    mesh_dim_names = ("data", "model")

    def size(self, i=None):
        return 1

    def get_local_rank(self, name=None):
        return 0


@pytest.mark.parametrize("name", ["shift_grad", "broadcast_grad", "all_to_all_grad", "sum_grads"])
def test_gradient_collectives_pass_the_gradient_on_one_rank(name):
    """On an axis of one rank each new collective returns its input (a
    wrapless shift: zeros, as the JAX ``ppermute`` fills) and the gradient
    passes through."""
    t = torch.arange(6.0).reshape(3, 2).requires_grad_(True)
    fn = getattr(pmesh, name)
    out = fn([t], _One())[0] if name == "sum_grads" else fn(t, _One(), "model")
    assert torch.equal(out, t)
    (out * 2).sum().backward()
    assert torch.equal(t.grad, torch.full((3, 2), 2.0))
    if name == "shift_grad":
        assert torch.equal(pmesh.shift_grad(t, _One(), "model", wrap=False), torch.zeros(3, 2))


# ------------------------------------------------------------------ dp x pp


@pytest.mark.parametrize("world", WORLDS)
def test_dp_pp_step_matches_jax_and_one_process(runs, world):
    """The JAX dryrun's dp x pp step (ViT-S/14 4 blocks + NetVLAD-4, one
    tuple of 4 at 28 px per data coordinate, SGD 1e-2; the blocks over
    model 2, the tuples over data 1 or 2): the loss within 1e-5 and every
    parameter after the step within 2e-5 of the JAX step's on a mesh of the
    same shape and of the plain step in one process; every rank holds the
    same parameters."""
    got = runs[world][0]["pptrain"]
    jloss, jparams = runs[world][1]["pptrain"]
    assert abs(float(got["loss"]) - jloss) <= 1e-5 * abs(jloss), (got["loss"], jloss)
    assert abs(float(got["loss"]) - float(got["single_loss"])) <= 1e-5 * abs(jloss)
    names = [k[len("param."):] for k in got if k.startswith("param.")]
    assert len(names) > 50 and set(names) <= set(jparams), set(names) - set(jparams)
    for k in names:
        np.testing.assert_allclose(got[f"param.{k}"], jparams[k], atol=2e-5, err_msg=k)
        np.testing.assert_allclose(got[f"param.{k}"], got[f"single_param.{k}"], atol=2e-5,
                                   err_msg=k)
    assert float(got["rank_spread"]) == 0.0


@pytest.mark.parametrize("world", WORLDS)
def test_dp_pp_gradients_sum_each_stage_and_data_row_once(runs, world):
    """The dp x pp step's gradients (every trunk tensor, the head) within
    1e-5 of the plain step's in one process: a stage's blocks, the
    embedding on the first stage and the capture block on the last each
    count once, summed over the data rows (a missing sum or a double count
    lies a factor off)."""
    got = runs[world][0]["pptrain"]
    names = [k[len("grad."):] for k in got if k.startswith("grad.")]
    assert sorted(names) == sorted(k[len("single_grad."):] for k in got
                                   if k.startswith("single_grad."))
    assert any(k.startswith("trunk.patch_embed") for k in names)
    assert any(k.startswith("trunk.blocks.3.attn.qkv") for k in names)
    top = max(np.abs(got[f"single_grad.{k}"]).max() for k in names)
    for k in names:
        _close(got[f"grad.{k}"], got[f"single_grad.{k}"], 1e-5, 1e-6 * top)


@pytest.mark.parametrize("world", WORLDS)
def test_dp_pp_step_with_stage_0_frozen_matches_one_process(runs, world):
    """dvgl's ``--freeze_te 1`` over the dp x pp step: the embedding and
    stage 0's blocks frozen, so stage 0's ranks read nothing that trains.
    The step ends (every rank runs every collective of the backward that
    the others run), its loss within 1e-5 and each trainable tensor's
    gradient within 1e-5 and value after the step within 2e-5 of the plain
    step's in one process with the same mask; no frozen tensor gets a
    gradient."""
    got = runs[world][0]["ppfreeze"]
    assert abs(float(got["loss"]) - float(got["single_loss"])) <= 1e-5 * abs(got["single_loss"])
    names = [k[len("grad."):] for k in got if k.startswith("grad.")]
    assert sorted(names) == sorted(k[len("single_grad."):] for k in got
                                   if k.startswith("single_grad."))
    trunk = [k for k in names if k.startswith("trunk.")]
    assert trunk and all(k.startswith(("trunk.blocks.2.", "trunk.blocks.3.")) for k in trunk)
    assert any(k.startswith("head.") for k in names)
    top = max(np.abs(got[f"single_grad.{k}"]).max() for k in names)
    for k in names:
        _close(got[f"grad.{k}"], got[f"single_grad.{k}"], 1e-5, 1e-6 * top)
        np.testing.assert_allclose(got[f"param.{k}"], got[f"single_param.{k}"], atol=2e-5,
                                   err_msg=k)
    assert float(got["rank_spread"]) == 0.0


# ------------------------------------------------------------------ sequence parallelism


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("tag", SP_FACETS)
def test_sp_facet_extract_gradients_match_jax_grad(runs, world, tag):
    """sum(facets * w) through ``sp_facet_extract`` (17 tokens padded over
    the model axis, images over data): every trunk tensor's gradient within
    1e-5 of jax.grad through the JAX ``sp_facet_extract`` and of the plain
    trunk's in one process; the facets equal the plain trunk's."""
    got = runs[world][0]["sptrain"]
    jgrads = runs[world][1]["sp"][tag]
    names = [k[len(f"{tag}_grad."):] for k in got if k.startswith(f"{tag}_grad.")]
    assert len(names) > 30 and set(names) <= set(jgrads), set(names) - set(jgrads)
    assert sorted(names) == sorted(k[len(f"{tag}_single_grad."):] for k in got
                                   if k.startswith(f"{tag}_single_grad."))
    top = max(np.abs(jgrads[k]).max() for k in names)
    for k in names:
        _close(got[f"{tag}_grad.{k}"], jgrads[k], 1e-5, 1e-6 * top)
        _close(got[f"{tag}_grad.{k}"], got[f"{tag}_single_grad.{k}"], 1e-5, 1e-6 * top)
    _close(got[f"{tag}_out"], got[f"{tag}_single_out"], 2e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_ring_attention_gradients_match_jax_grad(runs, world):
    """sum(out * w) over the real query rows through ``ring_attention``
    (16 tokens, the last 5 padded keys): the q, k and v gradients (summed
    over the ranks) within 1e-5 of jax.grad through the JAX ring, finite,
    and zero at the padded keys."""
    got = runs[world][0]["sptrain"]
    want = runs[world][1]["sp"]["ring"]
    for n in "qkv":
        g = got[f"ring_grad.{n}"]
        assert np.isfinite(g).all()
        _close(g, want[n])
    assert not got["ring_grad.k"][:, :, 11:].any() and not got["ring_grad.v"][:, :, 11:].any()


# ------------------------------------------------------------------ expert parallelism


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("run", ["ample", "tight"])
def test_ep_vlad_aggregate_gradients_match_jax_grad(runs, world, run):
    """sum(vlads * w) through ``ep_vlad_aggregate``: the gradients of the
    descriptors and of the experts within 1e-5 of jax.grad of the direct
    computation on the kept images (jax.grad through the JAX exchange is
    NaN, F26); a dropped image (tight capacity) gets zero gradient."""
    got = runs[world][0]["eptrain"]
    gd, ge, own = runs[world][1]["ep"][run]
    _close(got[f"{run}_grad_descs"], gd)
    _close(got[f"{run}_grad_experts"], ge)
    assert np.isfinite(got[f"{run}_grad_descs"]).all()
    assert np.isnan(own).any()    # F26: the JAX exchange's own gradient
    dropped = ~got[f"{run}_kept"].astype(bool)
    assert dropped.any() == (run == "tight")
    assert not got[f"{run}_grad_descs"][dropped].any()


# ------------------------------------------------------------------ no gradient: as before


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("what", ["pp", "sp", "ring", "ep"])
def test_outputs_without_a_gradient_are_bit_equal_to_the_earlier_forwards(runs, world, what):
    """Without a gradient the pipeline's facets, the sequence-parallel
    facets, ring attention and the routed VLADs (ample, tight, out-of-range
    routes) are bit-equal to the forwards as they were before gradients, on
    the same ranks and inputs; the training cases' outputs without a
    gradient equal their outputs under autograd."""
    res = runs[world][0]
    before = res[BEFORE]
    if what in ("pp", "sp"):
        names = [k for k in before if k.startswith(f"{what}_")]
        assert len(names) == 3
        for k in names:
            assert np.array_equal(res[what][k[len(what) + 1:]], before[k]), k
    elif what == "ring":
        assert np.array_equal(res["sp"]["ring"], before["ring"])
        assert np.array_equal(res["sptrain"]["ring_nograd"], res["sp"]["ring"])
        _close(res["sptrain"]["ring_out"], res["sp"]["ring"], 0.0)
        for tag in SP_FACETS:
            _close(res["sptrain"][f"{tag}_out"], res["sptrain"][f"{tag}_nograd"], 0.0)
    else:
        for run in ("ample", "tight", "oor"):
            assert np.array_equal(res["ep"][f"{run}_vlads"], before[f"ep_{run}_vlads"])
            assert np.array_equal(res["ep"][f"{run}_kept"], before[f"ep_{run}_kept"])
        for run in ("ample", "tight"):
            _close(res["eptrain"][f"{run}_vlads"], res["eptrain"][f"{run}_nograd"], 0.0)


def test_vlad_gradient_at_an_empty_cluster_f26():
    """F26 (reference): jax.grad of the JAX hard VLAD is NaN for an image
    with an empty cluster (its residual is the zero vector, and the L2
    norm's gradient there is 0/0, ``anyloc_tpu/ops/common.py:29-30``); the
    port's is finite (torch's norm backward gives 0 at a zero vector) and
    equals jax.grad on an image whose clusters are all used, within 1e-5."""
    from anyloc_tpu.ops.vlad import vlad_aggregate as jax_vlad

    from anyloc_tpu_torch.ops.vlad import vlad_aggregate

    inp = mesh_checks.inputs("ep", "small")
    d, e, r = inp["descs"], inp["experts"], inp["route"]
    for i, empty in ((2, True), (0, False)):    # image 2 leaves a cluster empty, 0 none
        jg = np.asarray(jax.grad(lambda x: jax_vlad(x, jnp.asarray(e[r[i]]), impl="xla").sum())(
            jnp.asarray(d[i][None])))
        x = torch.from_numpy(d[i][None]).requires_grad_(True)
        vlad_aggregate(x, torch.from_numpy(e[r[i]])).sum().backward()
        assert bool(torch.isfinite(x.grad).all())
        assert np.isnan(jg).any() == empty
        if not empty:
            _close(x.grad, jg)
