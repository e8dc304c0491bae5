"""The port's triplet training step against the JAX package's, in float32
on the CPU: the three losses, then one step of GeoLocalizationNet
(resnet18conv4 + NetVLAD-8, alexnet + NetVLAD, CCT-14/7x2 truncated to 1
block at 384 px, a 2-block ViT-B/16 on the XLA attention route at 64 px)
on the same numpy-seeded weights (``from_jax_params``) and tuples: the
loss, every gradient, the parameters after SGD and after Adam, and the
frozen BatchNorm statistics.

Bounds, and why:
  * losses: 1e-6 relative (one float32 reduction order apart);
  * gradients: 1e-4 of the tensor's largest |g| (a backward through a
    whole trunk, summed in another order); for CCT 1e-2: at 384 px its
    gradients cancel so heavily that a float32 run of either package lies
    well beyond 1e-4 of the largest |g| from a float64 run of the port,
    where the other cases stay inside it;
  * SGD: parameters within lr · that gradient bound of JAX's (the update
    is lr · g);
  * Adam: the first step moves each weight by lr · m̂ / (√v̂ + eps) =
    lr · sign(g) wherever |g| >> eps, so a gradient near zero whose sign
    differs between the frameworks moves by up to 2 · lr. The parameters
    are held within 2 · lr, the first moment (m = 0.1 g) within 0.1 · the
    gradient bound and the second (v = 0.001 g²) within 0.001 · (2 |g|
    bound + bound²); the step counts are equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from test_torch_models import _init, _perturb

from anyloc_tpu.training import network as jnetwork
from anyloc_tpu.training import triplet as jtriplet

from anyloc_tpu_torch.models.convert import from_jax_params, materialize
from anyloc_tpu_torch.training import network as pnetwork
from anyloc_tpu_torch.training import triplet as ptriplet

torch.set_num_threads(2)

LR = 1e-3
NEG = 2


def _rel(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert abs(got - want) <= rtol * abs(want), (got, want)


@pytest.mark.parametrize("criterion", ["triplet", "sare_ind", "sare_joint"])
def test_losses_match_jax(criterion):
    rng = np.random.default_rng(0)
    q, p = (rng.standard_normal((3, 16)).astype(np.float32) for _ in range(2))
    n = rng.standard_normal((3, 5, 16)).astype(np.float32)
    want = jtriplet._LOSSES[criterion](jnp.asarray(q), jnp.asarray(p), jnp.asarray(n), 0.3)
    got = ptriplet._LOSSES[criterion](*map(torch.from_numpy, (q, p, n)), 0.3)
    _rel(got.item(), float(want), 1e-6)


def test_sare_joint_carries_the_extra_one_over_neg():
    """sare_joint = the per-query joint softmax term / NEG (the reference
    loop divides the batch sum by B * NEG)."""
    rng = np.random.default_rng(1)
    q, p = (torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32)) for _ in range(2))
    n = torch.from_numpy(rng.standard_normal((2, 4, 8)).astype(np.float32))
    d_qp, d_qn = ((q - p) ** 2).sum(-1), ((q[:, None] - n) ** 2).sum(-1)
    joint = -torch.log_softmax(torch.cat([-d_qp[:, None], -d_qn], 1), 1)[:, 0]
    _rel(ptriplet.sare_joint_loss(q, p, n).item(), (joint.mean() / 4).item(), 1e-6)


# ------------------------------------------------------------------ the step

CASES = {
    "resnet18conv4-netvlad8": (dict(backbone="resnet18conv4", aggregation="netvlad",
                                    netvlad_clusters=8), 64),
    "alexnet-netvlad": (dict(backbone="alexnet", aggregation="netvlad", netvlad_clusters=4), 96),
    "cct384-netvlad": (dict(backbone="cct384", aggregation="netvlad", netvlad_clusters=4,
                            trunc_te=1), 384),
    "vit2-netvlad": (dict(backbone="vit", aggregation="netvlad", netvlad_clusters=4,
                          trunc_te=2), 64),
}


def _tuples(seed, px, b=1):
    return np.random.default_rng(seed).standard_normal(
        (b, 2 + NEG, px, px, 3)).astype(np.float32)


def _setup(case):
    kw, px = CASES[case]
    jmodel = jnetwork.GeoLocalizationNet(**kw)
    x = _tuples(3, px)
    variables = jax.device_get(_perturb(
        _init(jmodel, jax.random.PRNGKey(0), jnp.zeros((1, px, px, 3))), 5))
    pkw = dict(kw, img_size=px) if kw["backbone"] == "vit" else kw
    model = materialize(lambda: pnetwork.GeoLocalizationNet(**pkw), from_jax_params(variables),
                        "cpu")
    params = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    return jmodel, variables, model, params, x


def _jax_loss_and_grads(jmodel, variables, x):
    trainable, frozen = jtriplet._split_trainable(variables)

    def loss(tr):
        b, t = x.shape[:2]
        d = jmodel.apply(jtriplet._merge(tr, frozen), jnp.asarray(x).reshape(b * t, *x.shape[2:]))
        d = d.reshape(b, t, -1)
        return jtriplet.triplet_margin_loss(d[:, 0], d[:, 1], d[:, 2:], 0.1)

    l, g = jax.jit(jax.value_and_grad(loss))(trainable)
    return float(l), from_jax_params(jax.device_get(g))


def _descriptor_fn(model):
    def fn(params, images):
        return torch.func.functional_call(model, params, (images,))

    return fn


def _jax_step(jmodel, variables, x, opt):
    step = jtriplet.make_triplet_train_step(lambda v, im: jmodel.apply(v, im), opt,
                                            neg_num=NEG)
    state = step.init_state(variables)
    state, loss = step(state, jnp.asarray(x))
    return state, float(loss)


@pytest.fixture(scope="module", params=sorted(CASES))
def sgd_run(request):
    case = request.param
    jmodel, variables, model, params, x = _setup(case)
    want_loss, want_grads = _jax_loss_and_grads(jmodel, variables, x)
    jstate, jloss = _jax_step(jmodel, variables, x, optax.sgd(LR))
    step = ptriplet.make_triplet_train_step(
        _descriptor_fn(model), lambda ps: torch.optim.SGD(ps, lr=LR), neg_num=NEG)
    state = step.init_state(params)
    before = {k: v.detach().clone() for k, v in state.params.items()}
    state, loss = step(state, torch.from_numpy(x))
    return dict(case=case, want_loss=want_loss, want_grads=want_grads, jstate=jstate,
                jloss=jloss, state=state, loss=loss.item(), before=before)


def _grad_bound(g, case="resnet"):
    return (1e-2 if case.startswith("cct") else 1e-4) * max(np.abs(g).max(), 1e-30)


def test_step_loss_matches_jax(sgd_run):
    r = sgd_run
    _rel(r["loss"], r["want_loss"], 1e-5)
    _rel(r["loss"], r["jloss"], 1e-5)
    assert r["want_loss"] > 0   # margin active: a real gradient


def test_step_gradients_match_jax(sgd_run):
    """Every trainable tensor's gradient within its bound; the statistics
    have none."""
    r = sgd_run
    grads = {k: v.grad for k, v in r["state"].params.items() if v.requires_grad}
    assert set(grads) == set(r["want_grads"]), set(grads) ^ set(r["want_grads"])
    assert not any(ptriplet.is_statistic(k) for k in grads)
    for name, g in grads.items():
        want = r["want_grads"][name].numpy()
        err = np.abs(g.numpy() - want).max()
        assert err <= _grad_bound(want, r["case"]), (name, err, np.abs(want).max())


def test_sgd_update_matches_jax(sgd_run):
    r = sgd_run
    jparams = from_jax_params(jax.device_get(r["jstate"].params))
    assert r["state"].step == int(r["jstate"].step) == 1
    for name, t in r["state"].params.items():
        want = jparams[name].numpy()
        bound = (LR * _grad_bound(r["want_grads"][name].numpy(), r["case"])
                 if name in r["want_grads"] else 0.0)
        err = np.abs(t.detach().numpy() - want).max()
        assert err <= bound + 1e-7, (name, err, bound)


def test_frozen_batchnorm_statistics_unchanged(sgd_run):
    """The frozen-BN regime: the running statistics are bit-equal after the
    step (and JAX's too); BatchNorm's weight and bias did train."""
    r = sgd_run
    stats = [k for k in r["state"].params if ptriplet.is_statistic(k)]
    if r["case"].startswith("resnet"):
        assert stats and any(k.endswith("bn.weight") and r["state"].params[k].requires_grad
                             for k in r["state"].params)
    jparams = from_jax_params(jax.device_get(r["jstate"].params))
    for k in stats:
        assert torch.equal(r["state"].params[k], r["before"][k]), k
        np.testing.assert_array_equal(r["state"].params[k].numpy(), jparams[k].numpy())
    moved = [k for k in r["want_grads"]
             if not torch.equal(r["state"].params[k].detach(), r["before"][k])]
    assert moved, "no parameter moved"


def test_adam_step_matches_jax():
    """One Adam step (optax adam(lr) against torch.optim.Adam with optax's
    betas and eps) on resnet18conv4 + NetVLAD-8: the moments and the
    parameters within the bounds of the module docstring."""
    jmodel, variables, model, params, x = _setup("resnet18conv4-netvlad8")
    _, want_grads = _jax_loss_and_grads(jmodel, variables, x)
    jstate, _ = _jax_step(jmodel, variables, x, optax.adam(LR))
    step = ptriplet.make_triplet_train_step(
        _descriptor_fn(model),
        lambda ps: torch.optim.Adam(ps, lr=LR, betas=(0.9, 0.999), eps=1e-8), neg_num=NEG)
    state, _ = step(step.init_state(params), torch.from_numpy(x))
    adam = jstate.opt_state[0]
    mu, nu = from_jax_params(jax.device_get(adam.mu)), from_jax_params(jax.device_get(adam.nu))
    jparams = from_jax_params(jax.device_get(jstate.params))
    opt = state.opt_state
    assert int(adam.count) == 1
    for name, t in state.params.items():
        if not t.requires_grad:
            np.testing.assert_array_equal(t.numpy(), jparams[name].numpy())
            continue
        g = want_grads[name].numpy()
        gb = _grad_bound(g)
        st = opt.state[t]
        assert int(st["step"]) == 1
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu[name].numpy(), rtol=0,
                                   atol=0.1 * gb + 1e-12)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu[name].numpy(), rtol=0,
                                   atol=1e-3 * (2 * np.abs(g).max() * gb + gb * gb) + 1e-20)
        np.testing.assert_allclose(t.detach().numpy(), jparams[name].numpy(), rtol=0,
                                   atol=2 * LR)


def test_built_optimizer_is_taken_as_is():
    """A built optimizer must hold the trainable tensors of params: the
    step then updates them in place."""
    _, _, model, params, x = _setup("alexnet-netvlad")
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    opt = torch.optim.SGD(list(leaves.values()), lr=LR)
    step = ptriplet.make_triplet_train_step(_descriptor_fn(model), opt, neg_num=NEG)
    state = step.init_state(leaves)
    assert state.params["aggregation.centroids"] is leaves["aggregation.centroids"]
    before = leaves["aggregation.centroids"].detach().clone()
    step(state, torch.from_numpy(x))
    assert not torch.equal(before, leaves["aggregation.centroids"].detach())
    with pytest.raises(ValueError, match="optimizer must be built"):
        step.init_state({k: v.detach().clone() for k, v in params.items()})
