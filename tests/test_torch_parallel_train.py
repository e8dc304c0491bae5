"""The training half of the port's ``parallel/`` (F24's collectives under
autograd, FSDP optimizer state, cross-device BatchNorm, the sharded
restore, tensor-parallel training) on 2 and 4 Gloo ranks on the CPU,
against one process and the JAX package (the FSDP toy on the virtual
8-device mesh, a mesh of the same shape; the other references on one
device, which the JAX package's sharded programs equal).

One group of ranks per world size runs every training case
(``anyloc_tpu_torch/tools/mesh_checks.py``, ``CASES_TRAIN``); the checks
are parametrized over its results. Weights the JAX side initialises reach
the ranks through ``out/given`` (``from_jax_params``). Bounds: FSDP losses
rtol 1e-4 and parameters atol 1e-5 of the JAX ``TestFSDP`` run (the JAX
test's own), the save -> restore -> step round trip bit-equal, outputs,
statistics and gradients within 1e-5 of the largest |value| of each
tensor (plus 1e-6 of the model's largest gradient, for gradients that
vanish in exact arithmetic, such as a key bias's).
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
from anyloc_tpu.models.vit import ViT as JaxViT
from anyloc_tpu.parallel import get_mesh as jax_get_mesh
from anyloc_tpu.parallel.fsdp import fsdp_shardings as jax_fsdp_shardings
from anyloc_tpu.parallel.fsdp import fsdp_train_step as jax_fsdp_train_step
from anyloc_tpu.training import NetVLAD as JaxNetVLAD
from anyloc_tpu.training import make_triplet_train_step as jax_make_triplet_train_step
from anyloc_tpu.training import network as jnetwork
from anyloc_tpu.training.triplet import TripletTrainState as JaxState

from anyloc_tpu_torch.models.convert import from_jax_params
from anyloc_tpu_torch.parallel import fsdp as pfsdp
from anyloc_tpu_torch.parallel import mesh as pmesh
from anyloc_tpu_torch.parallel.tp import split_fused_params
from anyloc_tpu_torch.tools import mesh_checks

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from test_torch_models import _init, _perturb  # noqa: E402

torch.set_num_threads(2)
WORLDS = (2, 4)


def _close(got, want, rtol=1e-5, floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    bound = rtol * np.abs(want).max() + floor if want.size else 0.0
    assert err <= bound, (err, bound)


def _jax_vit(px):
    return jnetwork.GeoLocalizationNet(backbone="vit", aggregation="netvlad", netvlad_clusters=4,
                                       trunc_te=2)


def _jax_syncbn():
    return jnetwork.GeoLocalizationNet(backbone="resnet18conv4", aggregation="netvlad",
                                       netvlad_clusters=mesh_checks.SYNCBN["small"]["clusters"])


def _given(d):
    """Weights the JAX side draws, in the port's naming, for the ranks."""
    g = d / "given"
    g.mkdir()
    px = mesh_checks.DVGL["small"]["px"]
    vit_vars = jax.device_get(_perturb(_init(_jax_vit(px), jax.random.PRNGKey(0),
                                             jnp.zeros((1, px, px, 3))), 5))
    torch.save({k: torch.as_tensor(np.asarray(v)) for k, v in from_jax_params(vit_vars).items()},
               g / "dvgl_vit.pt")
    hw = mesh_checks.SYNCBN["small"]["hw"]
    bn_vars = jax.device_get(_perturb(_init(_jax_syncbn(), jax.random.PRNGKey(1),
                                            jnp.zeros((1, *hw, 3))), 6))
    torch.save({k: torch.as_tensor(np.asarray(v)) for k, v in from_jax_params(bn_vars).items()},
               g / "syncbn.pt")
    return vit_vars, bn_vars


def _jax_fsdp(world):
    """The JAX ``TestFSDP`` run on a data mesh of ``world`` devices: 12
    losses and the final projection."""
    inp = mesh_checks.train_inputs("fsdp", "small")
    w = {"params": {"proj": {"kernel": jnp.asarray(inp["w"])}}}

    def descriptor_fn(variables, images):
        d = images.reshape(images.shape[0], -1) @ variables["params"]["proj"]["kernel"]
        return d / (jnp.linalg.norm(d, axis=-1, keepdims=True) + 1e-9)

    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = jax_get_mesh(n_data=world, n_model=1)
    step = jax_make_triplet_train_step(descriptor_fn, optax.adam(1e-3), neg_num=2)
    state = step.init_state(w)
    p_sh = jax.tree_util.tree_map(lambda _: NamedSharding(mesh, P()), state.params)
    o_sh = jax_fsdp_shardings(state.opt_state, mesh, min_size=512)
    state = JaxState(jax.device_put(state.params, p_sh), jax.device_put(state.opt_state, o_sh),
                     jax.device_put(state.step, NamedSharding(mesh, P())))
    fstep = jax_fsdp_train_step(step, JaxState(p_sh, o_sh, NamedSharding(mesh, P())))
    batch = jax.device_put(jnp.asarray(inp["tuples"]),
                           NamedSharding(mesh, P("data", None, None, None, None)))
    losses = []
    for _ in range(12):
        state, loss = fstep(state, batch)
        losses.append(float(loss))
    return np.array(losses), np.asarray(state.params["params"]["proj"]["kernel"])


def _jax_dryrun():
    """jax.grad of the dryrun's loss (ViT-S/14 4 blocks + NetVLAD-4, the
    weights the ranks draw) over both tuples on one device: the loss and
    the gradients in the port's split naming."""
    from anyloc_tpu.models.dinov2 import dinov2_config as jax_dinov2_config

    from anyloc_tpu_torch.models.dinov2 import dinov2_config

    sd = mesh_checks.vit_params(dinov2_config("dinov2_vits14", dtype=torch.float32), 0)
    jcfg = jax_dinov2_config("dinov2_vits14", dtype=jnp.float32)
    trunk = convert_dinov2({k: v.numpy() for k, v in sd.items()}, jcfg)
    inp = mesh_checks.train_inputs("dptrain", "small")
    head_vars = {"params": {"assign": {"kernel": jnp.asarray(inp["assign"].T)},
                            "centroids": jnp.asarray(inp["centroids"])}}
    model, head = JaxViT(jcfg), JaxNetVLAD(num_clusters=4, dim=384)
    tuples = np.random.default_rng(0).standard_normal((2, 4, 28, 28, 3)).astype(np.float32)
    from anyloc_tpu.training.triplet import triplet_margin_loss

    def loss(params):
        b, t = tuples.shape[:2]
        feats = model.apply(params["trunk"], jnp.asarray(tuples).reshape(b * t, 28, 28, 3),
                            capture_layer=3, capture_facet="token")
        d = head.apply(params["head"], feats[:, 1:]).reshape(b, t, -1)
        return triplet_margin_loss(d[:, 0], d[:, 1], d[:, 2:], 0.1)

    lv, g = jax.jit(jax.value_and_grad(loss))({"trunk": trunk, "head": head_vars})
    grads = {f"trunk.{k}": v for k, v in split_fused_params(
        {k: torch.as_tensor(np.asarray(v)) for k, v in
         from_jax_params(jax.device_get(g["trunk"])).items()}).items()}
    grads["head.assign.weight"] = np.asarray(g["head"]["params"]["assign"]["kernel"]).T
    grads["head.centroids"] = np.asarray(g["head"]["params"]["centroids"])
    return float(lv), {k: np.asarray(v) for k, v in grads.items()}


def _jax_syncbn_refs(bn_vars):
    """The JAX network with ``train=True`` over the whole batch: outputs,
    new statistics, and the gradients of sum(out * w)."""
    inp = mesh_checks.train_inputs("syncbn", "small")
    net = _jax_syncbn()
    params, stats = bn_vars["params"], bn_vars["batch_stats"]

    def loss(p):
        out, upd = net.apply({"params": p, "batch_stats": stats}, jnp.asarray(inp["x"]),
                             train=True, mutable=["batch_stats"])
        return (out * jnp.asarray(inp["w"])).sum(), (out, upd)

    (_, (out, upd)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    both = from_jax_params(jax.device_get({"params": g, "batch_stats": upd["batch_stats"]}))
    stats = {k: v for k, v in both.items() if k.endswith(("running_mean", "running_var"))}
    return np.asarray(out), stats, {k: v for k, v in both.items() if k not in stats}


def _jax_tptrain_grads(vit_vars):
    """The JAX dvgl vit's gradients of sum(out * w) over the batch, in the
    port's split naming."""
    inp = mesh_checks.train_inputs("tptrain", "small")
    net = _jax_vit(mesh_checks.DVGL["small"]["px"])

    def loss(p):
        return (net.apply({**vit_vars, "params": p}, jnp.asarray(inp["x"]))
                * jnp.asarray(inp["w"])).sum()

    g = jax.jit(jax.grad(loss))(vit_vars["params"])
    return {k: np.asarray(v) for k, v in split_fused_params(
        {k: torch.as_tensor(np.asarray(v)) for k, v in
         from_jax_params(jax.device_get({"params": g})).items()}).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: {case: {name: array}}} and the JAX references."""
    out, refs = {}, {}
    d0 = tmp_path_factory.mktemp("given")
    vit_vars, bn_vars = _given(d0)
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"train{world}")
        (d / "given").symlink_to(d0 / "given")
        mesh_checks.launch(d, world, "gloo", "cpu", "small", mesh_checks.CASES_TRAIN,
                           timeout=300)
        out[world] = {c: mesh_checks.results(d, c) for c in mesh_checks.CASES_TRAIN}
        refs[("fsdp", world)] = _jax_fsdp(world)
    refs["dryrun"] = _jax_dryrun()
    refs["syncbn"] = _jax_syncbn_refs(bn_vars)
    refs["tptrain"] = _jax_tptrain_grads(vit_vars)
    return out, refs


# ------------------------------------------------------------------ F24


@pytest.mark.parametrize("world", WORLDS)
def test_column_row_product_gradients_equal_one_process_f24(runs, world):
    """F24: ``x @ W[:, shard] @ V[shard]`` over ``model`` through
    ``tp_copy`` / ``tp_reduce`` with a squared-sum loss: y and the gradients
    of x (the same on every rank), W and V equal one process's within
    1e-5; the gathered rows' gradient is each rank's slice of the
    replicated cotangent; ``sync_reduce`` sums the cotangents of every
    rank's loss."""
    g = runs[0][world]["collectives"]
    rng = np.random.default_rng(21)
    x0, w0, v0 = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((5, 8), (8, 16), (16, 3)))
    x, w, v = (t.clone().requires_grad_(True) for t in (x0, w0, v0))
    y = x @ w @ v
    (y ** 2).sum().backward()
    _close(g["tp_y"], y.detach())
    _close(g["tp_grad_x"], x.grad)
    _close(g["tp_grad_w"], w.grad)
    _close(g["tp_grad_v"], v.grad)
    rows = x0[:4].clone().requires_grad_(True)
    (rows.sum(0) ** 2).sum().backward()
    _close(g["gather_grad_rows"], rows.grad)
    want = sum(x0[j % 5] for j in range(world)).expand(5, 8)
    _close(g["sync_grad"], np.broadcast_to(want.numpy(), (world, 5, 8)))


@pytest.mark.parametrize("world", WORLDS)
def test_collectives_without_a_backward_raise_under_grad_f24(runs, world):
    """``all_reduce``, ``all_gather``, ``all_to_all``, ``broadcast`` and
    ``shift`` given an input that requires a gradient raise; with grad off
    ``tp_copy`` is its input (no collective) and ``tp_reduce`` equals
    ``all_reduce``."""
    g = runs[0][world]["collectives"]
    assert g["raised"].all(), g["raised"]
    assert g["grad_off"].all(), g["grad_off"]


def test_collectives_need_no_group_at_grad_off_and_one_rank():
    """On an axis of one rank every collective returns its input, with or
    without a gradient, and a gradient passes through."""
    class One:
        mesh_dim_names = ("data", "model")

        def size(self, i=None):
            return 1

    t = torch.ones(3, requires_grad=True)
    for fn in (pmesh.tp_reduce, pmesh.tp_copy, pmesh.tp_gather, pmesh.sync_reduce):
        out = fn(t, One(), "model")
        out.sum().backward()
        assert torch.equal(t.grad, torch.ones(3))
        t.grad = None


# ------------------------------------------------------------------ FSDP


def test_fsdp_shardings_make_the_jax_decisions():
    """The shapes of the JAX package's ``test_fsdp_shardings_pick_divisible_dim``
    on a data axis of 8: each leaf's spec equals the JAX ``PartitionSpec``."""
    class Eight:
        mesh_dim_names = ("data", "model")

        def size(self, i=None):
            return 8 if i in (None, 0) else 1

    shapes = {"big": (64, 48), "odd": (17, 129), "tall": (6, 4096), "tiny": (8,), "count": ()}
    tree = {k: torch.zeros(s) for k, s in shapes.items()}
    got = pfsdp.fsdp_shardings(tree, Eight(), min_size=512)
    jmesh = jax_get_mesh(n_data=8, n_model=1)
    want = jax_fsdp_shardings({k: jnp.zeros(s) for k, s in shapes.items()}, jmesh, min_size=512)
    for k in shapes:
        assert tuple(got[k].spec) == tuple(want[k].spec), (k, got[k].spec, want[k].spec)
    assert got["big"].dim == 0 and got["tall"].dim == 1 and got["odd"].dim is None


def test_fsdp_step_takes_only_the_state_of_its_init_state():
    """The step shards nothing itself: a state with a plain ``torch.optim``
    optimizer is refused, ``step.init_state`` builds the sharded one."""
    from anyloc_tpu_torch.training.triplet import make_triplet_train_step

    step = make_triplet_train_step(lambda p, x: x.reshape(x.shape[0], -1) @ p["proj"],
                                   mesh_checks._adam(1e-3), neg_num=2)
    params = {"proj": torch.zeros(48, 64)}
    fstep = pfsdp.fsdp_train_step(step, pfsdp.fsdp_shardings(params, _OneRank()))
    assert isinstance(fstep.init_state(params).opt_state, pfsdp.FsdpOptimizer)
    with pytest.raises(TypeError, match="init_state"):
        fstep(step.init_state(params), torch.zeros(4, 4, 4, 4, 3))


def test_fsdp_step_averages_over_the_axis_its_moments_are_sharded_over():
    """The step reads its axis from ``state_shardings``: moments sharded
    over two axes are refused."""
    mesh = _OneRank()
    specs = {"a": pfsdp.Sharding(mesh, ("data", None)), "b": pfsdp.Sharding(mesh, (None, "model"))}
    with pytest.raises(ValueError, match="more than one axis"):
        pfsdp.fsdp_train_step(lambda state, tuples: None, specs)


@pytest.mark.parametrize("world", WORLDS)
def test_fsdp_steps_match_jax(runs, world):
    """12 steps with the moments sharded over ``data`` = world: losses within
    rtol 1e-4 and the final projection within 1e-5 of the JAX FSDP run on a
    mesh of the same shape, and of 12 steps on one rank; the moment is a
    slice (48 x 64 / world along its largest dim)."""
    got = runs[0][world]["fsdp"]
    jl, jw = runs[1][("fsdp", world)]
    assert got["losses"][-1] < got["losses"][0]
    np.testing.assert_allclose(got["losses"], jl, rtol=1e-4)
    np.testing.assert_allclose(got["proj"], jw, atol=1e-5)
    np.testing.assert_allclose(got["losses"], got["single_losses"], rtol=1e-5)
    np.testing.assert_allclose(got["proj"], got["single_proj"], atol=1e-6)
    assert list(got["spec"]) == ["None", "data"]
    assert tuple(got["moment_shape"]) == (48, 64 // world)


@pytest.mark.parametrize("world", WORLDS)
def test_fsdp_state_bytes_below_the_replicated_state(runs, world):
    """``state_bytes_per_device``: a rank holds its parameters, a slice of
    each moment and of the parameter it updates, below the replicated
    state's parameters + two moments."""
    got = runs[0][world]["fsdp"]
    fsdp, rep = float(got["fsdp_bytes"]), float(got["replicated_bytes"])
    param = 48 * 64 * 4
    assert fsdp < rep
    assert fsdp == param + 3 * param / world + 4, (fsdp, rep)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["fsdp", "dptrain", "restore"])
def test_fsdp_save_restore_step_is_bit_equal(runs, world, case):
    """save (rank 0 writes the whole moments) -> ``load_checkpoint(target=)``
    (each rank its slices) -> step: the loss, the parameters and the
    moments bit-equal to the uninterrupted step's, the layout unchanged on
    every rank."""
    got = runs[0][world][case]
    assert int(got[f"{case}_layout_mismatches"]) == 0
    lc, lr = got[f"{case}_resume_losses"]
    assert lc == lr
    assert (got[f"{case}_resume_diff"] == 0).all(), got[f"{case}_resume_diff"]
    if case == "restore":
        assert float(got["spread"]) == 0.0


def test_load_checkpoint_without_target_reads_the_whole_moments(tmp_path):
    """A one-rank FSDP state saves in the one-file format: without
    ``target`` the file gives the whole moments as a plain dict."""
    assert not torch.distributed.is_initialized()
    mesh = pmesh.local_mesh(1, backend="gloo")
    try:
        _one_rank_save(mesh, tmp_path)
    finally:
        torch.distributed.destroy_process_group()


def _one_rank_save(mesh, tmp_path):
    from anyloc_tpu_torch.training.triplet import make_triplet_train_step
    from anyloc_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    inp = mesh_checks.train_inputs("fsdp", "small")

    def fn(params, images):
        return images.reshape(images.shape[0], -1) @ params["proj"]

    step = make_triplet_train_step(fn, mesh_checks._adam(1e-3), neg_num=2)
    fstep = pfsdp.fsdp_train_step(step, pfsdp.fsdp_shardings({"proj": torch.zeros(48, 64)},
                                                             mesh, min_size=512))
    state, _ = fstep(fstep.init_state({"proj": torch.from_numpy(inp["w"])}),
                     torch.from_numpy(inp["tuples"]))
    save_checkpoint(str(tmp_path), {**state._asdict(), "epoch": 3}, is_best=True)
    back = load_checkpoint(str(tmp_path / "best_checkpoint"))
    assert back["epoch"] == 3 and back["step"] == 1
    moments = back["opt_state"]["state"]["proj"]
    assert moments["exp_avg"].shape == (48, 64)
    local = state.opt_state.local["proj"]
    assert torch.equal(moments["exp_avg"], state.opt_state.state[local]["exp_avg"])


@pytest.mark.parametrize("world", WORLDS)
def test_dryrun_step_matches_jax_grad(runs, world):
    """The JAX dryrun's data x model step (ViT-S/14 4 blocks + NetVLAD-4,
    28 px, 2 tuples; 2 x world/2 ranks, the trunk sharded over ``model``,
    the moments over ``data``): the first loss within 1e-5 and every
    gradient (the shards put back together) within 1e-5 of jax.grad on
    one device; the loss falls over 12 steps; every trainable moment
    above min_size is a slice; a rank holds less than the replicated
    state."""
    got = runs[0][world]["dptrain"]
    loss, grads = runs[1]["dryrun"]
    np.testing.assert_allclose(got["losses"][0], loss, rtol=1e-5)
    top = max(np.abs(v).max() for v in grads.values())
    names = [k[5:] for k in got if k.startswith("grad.")]
    assert len(names) > 60 and set(names) <= set(grads), set(names) - set(grads)
    for k in names:
        _close(got[f"grad.{k}"], grads[k], 1e-5, 1e-6 * top)
    assert got["losses"][-1] < got["losses"][0]
    assert int(got["sharded_moments"]) > 0
    assert float(got["fsdp_bytes"]) < float(got["replicated_bytes"])


# ------------------------------------------------------------------ sync BatchNorm


@pytest.mark.parametrize("world", WORLDS)
def test_sync_batchnorm_matches_jax_over_the_whole_batch(runs, world):
    """``GeoLocalizationNet("resnet18conv4", sync_axis="data")``,
    ``train=True``, each rank its block of 8 images: the outputs, the new
    statistics (equal on every rank) and the gradients summed over
    ``data`` within 1e-5 of the JAX ``train=True`` pass over the whole
    batch and of the port's local BatchNorm on the whole batch."""
    got = runs[0][world]["syncbn"]
    out, stats, grads = runs[1]["syncbn"]
    _close(got["out"], out)
    _close(got["out"], got["single_out"])
    assert float(got["stat_spread"]) == 0.0
    for k, v in stats.items():
        _close(got[f"stat.{k}"], v)
        _close(got[f"stat.{k}"], got[f"single_stat.{k}"])
    top = max(np.abs(v).max() for v in grads.values())
    for k, v in grads.items():
        _close(got[f"grad.{k}"], v, 1e-5, 1e-6 * top)
        _close(got[f"grad.{k}"], got[f"single_grad.{k}"], 1e-5, 1e-6 * top)


@pytest.mark.parametrize("world", WORLDS)
def test_sync_batchnorm_float64_trunk_matches_one_rank(runs, world):
    """The resnet18conv4 trunk in float64 (BatchNorm's statistics in
    float64, as Flax keeps them), ``sync_axis="data"``: outputs, statistics
    and gradients summed over ``data`` within 1e-12 of each tensor's
    largest |value| of the trunk without ``sync_axis`` on the whole batch,
    the bound the smoke's 480 x 640 check relies on."""
    got = runs[0][world]["syncbn"]
    names = [k[len("f64_single_"):] for k in got if k.startswith("f64_single_")]
    assert any(k.startswith("grad.") for k in names) and any(k.startswith("stat.") for k in names)
    for k in names:
        assert got["f64_" + k].dtype == np.float64
        _close(got["f64_" + k], got["f64_single_" + k], 1e-12)


def test_sync_batchnorm_raises_without_a_mesh_or_its_axis():
    """Flax binds the axis name through shard_map: with no mesh bound by
    ``use_mesh`` (also after its block ends), or a bound mesh without the
    axis, ``train=True`` raises; inference reads the running statistics and
    needs neither."""
    from anyloc_tpu_torch.models.convert import materialize
    from anyloc_tpu_torch.training.network import GeoLocalizationNet

    net = materialize(lambda: GeoLocalizationNet("resnet18conv4", "gem", sync_axis="data"),
                      None, "cpu", seed=0)
    x = torch.randn(2, 32, 32, 3)
    net(x)
    with pytest.raises(RuntimeError, match="needs a mesh"):
        net(x, train=True)

    class NoData:
        mesh_dim_names = ("model",)

    with pmesh.use_mesh(NoData()):
        with pytest.raises(ValueError, match="not an axis"):
            net(x, train=True)
    with pytest.raises(RuntimeError, match="needs a mesh"):
        net(x, train=True)


class _OneRank:
    """A mesh of one rank with the JAX axis names, for what needs no group."""
    mesh_dim_names = ("data", "model")

    def size(self, i=None):
        return 1

    def get_local_rank(self, name=None):
        return 0


def test_use_mesh_blocks_nest_and_restore_the_binding():
    assert pmesh.bound_mesh() is None
    outer, inner = _OneRank(), _OneRank()
    with pmesh.use_mesh(outer) as m:
        assert m is outer and pmesh.bound_mesh() is outer
        with pytest.raises(KeyError):
            with pmesh.use_mesh(inner):
                assert pmesh.bound_mesh() is inner
                raise KeyError("leaves the block")
        assert pmesh.bound_mesh() is outer
    assert pmesh.bound_mesh() is None


def test_sync_batchnorm_over_one_rank_is_local_batchnorm_bit_for_bit():
    """An axis of one rank gives the local computation: outputs, statistics
    and gradients bit-equal to the network without ``sync_axis``."""
    from anyloc_tpu_torch.models.convert import materialize
    from anyloc_tpu_torch.training.network import GeoLocalizationNet

    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    outs = []
    for sync in ("data", None):
        net = materialize(lambda: GeoLocalizationNet("resnet18conv4", "netvlad", 4,
                                                     sync_axis=sync), None, "cpu",
                          seed=0).requires_grad_(True)
        with pmesh.use_mesh(_OneRank()):
            out = net(x, train=True)
        out.sum().backward()
        outs.append((out, dict(net.named_buffers()),
                     {k: p.grad for k, p in net.named_parameters()}))
    (a, sa, ga), (b, sb, gb) = outs
    assert torch.equal(a, b)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert all(torch.equal(ga[k], gb[k]) for k in ga)


# ------------------------------------------------------------------ tensor-parallel training


@pytest.mark.parametrize("world", WORLDS)
def test_tensor_parallel_training_gradients(runs, world):
    """dvgl's vit (2 blocks, 32 px) with ``tp_split`` sharded over ``model``
    = world: every parameter's gradient (patch embedding, norms, NetVLAD,
    each shard put back together) within 1e-5 of the trunk unsharded on
    one rank and of the JAX network's jax.grad; the replicated parameters'
    gradients equal on every rank."""
    got = runs[0][world]["tptrain"]
    jgrads = runs[1]["tptrain"]
    _close(got["out"], got["single_out"])
    assert float(got["replicated_spread"]) == 0.0
    names = [k[5:] for k in got if k.startswith("grad.")]
    assert len(names) == len([k for k in got if k.startswith("single_grad.")])
    top = max(np.abs(got[f"single_grad.{k}"]).max() for k in names)
    for k in names:
        _close(got[f"grad.{k}"], got[f"single_grad.{k}"], 1e-5, 1e-6 * top)
        _close(got[f"grad.{k}"], jgrads[k], 1e-4, 1e-6 * top)


def test_flash_attention_function_gives_the_plain_gradient():
    """K2's ``FlashAttentionGrad`` with the kernel slot filled by the plain
    version: the output and the q, k, v gradients equal the plain
    version's autograd; only the inputs that need one get a gradient."""
    from anyloc_tpu_torch.ops.kernels.flash_attention import (FlashAttentionGrad,
                                                              flash_attention_ref)

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 3, 17, 16, generator=g) for _ in range(3))
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    qb, kb = (t.clone().requires_grad_(True) for t in (q, k))
    out = FlashAttentionGrad.apply(flash_attention_ref, 0.25, qa, ka, va)
    want = flash_attention_ref(qb, kb, v, scale=0.25)
    assert torch.equal(out, want)
    gout = torch.randn(out.shape, generator=g)
    out.backward(gout)
    want.backward(gout)
    assert torch.allclose(qa.grad, qb.grad, atol=1e-6) and torch.allclose(ka.grad, kb.grad,
                                                                          atol=1e-6)
    assert va.grad is not None
    out2 = FlashAttentionGrad.apply(flash_attention_ref, 0.25, q.clone().requires_grad_(True),
                                    k, v)
    out2.sum().backward()


def test_vit_tp_shardings_name_the_shards():
    """``vit_tp_shardings``: column-parallel weights and biases over dim 0,
    row-parallel weights over dim 1, the rest replicated (any prefix)."""
    from anyloc_tpu_torch.parallel.tp import vit_tp_shardings

    class Two:
        mesh_dim_names = ("data", "model")

    params = {"backbone.blocks.0.attn.wq.weight": torch.zeros(4, 8),
              "backbone.blocks.0.attn.wq.bias": torch.zeros(4),
              "backbone.blocks.0.mlp.fc1.bias": torch.zeros(4),
              "backbone.blocks.0.attn.proj.weight": torch.zeros(8, 4),
              "backbone.blocks.0.attn.proj.bias": torch.zeros(8),
              "backbone.blocks.0.mlp.w3.weight": torch.zeros(8, 4),
              "backbone.blocks.0.norm1.weight": torch.zeros(8),
              "aggregation.centroids": torch.zeros(4, 8)}
    got = {k: s.spec for k, s in vit_tp_shardings(params, Two()).items()}
    assert got == {"backbone.blocks.0.attn.wq.weight": ("model", None),
                   "backbone.blocks.0.attn.wq.bias": ("model",),
                   "backbone.blocks.0.mlp.fc1.bias": ("model",),
                   "backbone.blocks.0.attn.proj.weight": (None, "model"),
                   "backbone.blocks.0.attn.proj.bias": (),
                   "backbone.blocks.0.mlp.w3.weight": (None, "model"),
                   "backbone.blocks.0.norm1.weight": (),
                   "aggregation.centroids": ()}


def test_shard_vit_tp_keeps_each_parameters_requires_grad():
    """A shard keeps its parameter's ``requires_grad``: the extractor's
    frozen trunk stays frozen, a training trunk trains."""
    from anyloc_tpu_torch.models.dinov2 import build_vit
    from anyloc_tpu_torch.parallel.tp import shard_vit_tp

    class Two:
        mesh_dim_names = ("data", "model")

        def size(self, i=None):
            return 2 if i in (None, 1) else 1

        def get_local_rank(self, name):
            return 1

    cfg = dataclasses.replace(mesh_checks.vit_config("small", tp_split=True), depth=1)
    trunk = build_vit(cfg, split_fused_params(mesh_checks.vit_params(
        dataclasses.replace(cfg, tp_split=False), 0)), device="cpu")
    frozen = shard_vit_tp(trunk, Two())
    assert not any(p.requires_grad for p in frozen.parameters())
    trunk = build_vit(cfg, split_fused_params(mesh_checks.vit_params(
        dataclasses.replace(cfg, tp_split=False), 0)), device="cpu").requires_grad_(True)
    assert all(p.requires_grad for p in shard_vit_tp(trunk, Two()).parameters())
    assert trunk.blocks[0].attn.wq.weight.shape[0] == cfg.embed_dim // 2
