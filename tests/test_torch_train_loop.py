"""Training around the step, the port against the JAX package on the CPU:
``TripletMiner`` (bit-equal triplets in its four modes), the augmentations
(each applied with the JAX draw's parameters, atol 1e-5; the
perspective's homography within 1e-4, the JAX one is a float32 solve),
``train_triplet`` end to end on a synthetic vg_bench tree (random
mining, SGD, the smooth SARE-ind loss, so that no triplet sits on a
hinge's corner in one framework and off it in the other: the history's losses within 1e-5 absolute (each is a
margin plus a difference of distances between unit descriptors, at most
2, so float32 sums put ~1e-6 there), recalls equal, final parameters
within 1e-3 of the tensor's largest total update (four SGD steps, each
gradient within 1e-4 of its largest |g| as test_torch_train.py holds
it, the later ones taken at weights already that far apart)), its patience stop, checkpoint and resume,
CosPlace's classes (exact), head, loss (1e-6 relative) and step, the
contrastive head, loss and step, ``train_cli``'s cross-flag errors
(equal messages) and a small run of ``python -m anyloc_tpu_torch train``
on the CPU, seeding and logging.
"""

import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from test_torch_models import _init, _perturb

from anyloc_tpu.data import augment as jaug
from anyloc_tpu.data.loaders.base_dataset import BaseDataset as JaxBaseDataset
from anyloc_tpu.data.synthetic import build_vg_bench
from anyloc_tpu.pipelines import extras as jextras
from anyloc_tpu.training import cosplace as jcos
from anyloc_tpu.training import mining as jmining
from anyloc_tpu.training import network as jnetwork
from anyloc_tpu.training import train_cli as jtrain_cli
from anyloc_tpu.training import train_loop as jloop

from anyloc_tpu_torch import cli as port_cli
from anyloc_tpu_torch.data import augment as paug
from anyloc_tpu_torch.data.loaders.base_dataset import BaseDataset
from anyloc_tpu_torch.models.convert import from_jax_params, materialize
from anyloc_tpu_torch.pipelines import extras as pextras
from anyloc_tpu_torch.training import cosplace as pcos
from anyloc_tpu_torch.training import mining as pmining
from anyloc_tpu_torch.training import network as pnetwork
from anyloc_tpu_torch.training import train_cli as ptrain_cli
from anyloc_tpu_torch.training import train_loop as ploop
from anyloc_tpu_torch.training import triplet as ptriplet
from anyloc_tpu_torch.utils import checkpoint as pcheckpoint
from anyloc_tpu_torch.utils import logging_utils as plog
from anyloc_tpu_torch.utils import seeding as pseeding

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def vg_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("vg")
    build_vg_bench(str(root), n_db=12, n_q=6, size=(64, 64))
    return str(root)


def _datasets(root):
    return (JaxBaseDataset(root, "pitts30k", "test", img_size=(64, 64)),
            BaseDataset(root, "pitts30k", "test", img_size=(64, 64)))


def _desc_fn():
    """A cheap deterministic descriptor: mean-pooled random projection."""
    w = np.random.default_rng(0).standard_normal((3, 32)).astype(np.float32)

    def fn(imgs):
        imgs = np.asarray(imgs, np.float32)
        feats = (imgs.reshape(imgs.shape[0], -1, 3) @ w).mean(axis=1)
        return feats / np.maximum(np.linalg.norm(feats, axis=-1, keepdims=True), 1e-9)

    return fn


# ------------------------------------------------------------------ mining

@pytest.mark.parametrize("mining", ["random", "partial", "full", "msls_weighted"])
def test_miner_triplets_bit_equal_to_jax(vg_root, mining):
    jds, pds = _datasets(vg_root)
    if mining == "msls_weighted":
        for ds in (jds, pds):
            ds.night_indexes, ds.sideways_indexes = [0, 3], [1]
    kw = dict(neg_num=3, mining=mining, neg_samples_num=8, seed=5)
    jm = jmining.TripletMiner(jds, **kw)
    pm = pmining.TripletMiner(pds, **kw, device="cpu")
    for _ in range(2):   # a second refresh continues each RNG
        want = jm.compute_triplets(_desc_fn(), n_queries=4, batch_size=3)
        got = pm.compute_triplets(_desc_fn(), n_queries=4, batch_size=3)
        assert len(got) == len(want) == 4
        for (q, p, n), (wq, wp, wn) in zip(got, want):
            assert (q, p) == (wq, wp)
            np.testing.assert_array_equal(n, wn)
    np.testing.assert_array_equal(pm.tuples_as_batch(got, [0, 2]),
                                  jm.tuples_as_batch(want, [0, 2]))


def test_miner_needs_msls_indexes_and_a_card(vg_root):
    _, pds = _datasets(vg_root)
    with pytest.raises(RuntimeError, match="msls_weighted"):
        pmining.TripletMiner(pds, mining="msls_weighted", device="cpu")
    if not torch.cuda.is_available():
        for mining in ("random", "partial"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                pmining.TripletMiner(pds, mining=mining)


# ------------------------------------------------------------------ augmentations

def _imgs(seed=0, b=3, h=24, w=20):
    return np.random.default_rng(seed).uniform(0, 1, (b, h, w, 3)).astype(np.float32)


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def test_color_jitter_given_the_jax_draws():
    x = _imgs()
    key = jax.random.PRNGKey(3)
    f = dict(brightness=0.4, contrast=0.3, saturation=0.5, hue=0.1)
    want = jaug.color_jitter(key, jnp.asarray(x), **f)
    kb, kc, ks, kh = jax.random.split(key, 4)
    draws = {name: torch.from_numpy(np.asarray(jax.random.uniform(
        k, (3,), minval=max(0, 1 - f[name]), maxval=1 + f[name])))
        for name, k in (("brightness", kb), ("contrast", kc), ("saturation", ks))}
    draws["hue"] = torch.from_numpy(np.asarray(jax.random.uniform(
        kh, (3, 1, 1), minval=-0.1 * 2 * np.pi, maxval=0.1 * 2 * np.pi)).reshape(3))
    _close(paug.apply_color_jitter(torch.from_numpy(x), **draws), want)
    # the port's own draw: in range and reproducible
    g = paug.draw_color_jitter(torch.Generator().manual_seed(0), 64, **f)
    assert 0.6 <= g["brightness"].min() and g["brightness"].max() <= 1.4
    assert torch.equal(paug.color_jitter(torch.Generator().manual_seed(1), torch.from_numpy(x)),
                       paug.color_jitter(torch.Generator().manual_seed(1), torch.from_numpy(x)))


def test_resized_crop_given_the_jax_draws():
    x = _imgs(1)
    key = jax.random.PRNGKey(4)
    want = jaug.random_resized_crop(key, jnp.asarray(x), out_hw=(24, 20), scale=(0.4, 1.0))
    ks, ky, kx = jax.random.split(key, 3)
    s = jax.random.uniform(ks, (3,), minval=0.4, maxval=1.0)
    ch = jnp.floor(24 * jnp.sqrt(s)).astype(jnp.int32)
    cw = jnp.floor(20 * jnp.sqrt(s)).astype(jnp.int32)
    y0 = (jax.random.uniform(ky, (3,)) * (24 - ch)).astype(jnp.int32)
    x0 = (jax.random.uniform(kx, (3,)) * (20 - cw)).astype(jnp.int32)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    _close(paug.resized_crop_batch(torch.from_numpy(x), t(y0), t(x0), t(ch), t(cw), (24, 20)),
           want)
    got = paug.random_resized_crop(torch.Generator().manual_seed(0), torch.from_numpy(x),
                                   (12, 10))
    assert got.shape == (3, 12, 10, 3)


def test_rotation_given_the_jax_angles():
    x = _imgs(2)
    fill = np.asarray([0.1, -0.2, 0.3], np.float32)
    key = jax.random.PRNGKey(5)
    want = jaug.random_rotation(key, jnp.asarray(x), 30.0, jnp.asarray(fill))
    angles = np.asarray(jax.random.uniform(key, (3,), minval=-30.0, maxval=30.0))
    got = paug.rotate_batch(torch.from_numpy(x), torch.from_numpy(angles), torch.from_numpy(fill))
    _close(got, want)
    _close(got, jaug.rotate_batch(jnp.asarray(x), jnp.asarray(angles), jnp.asarray(fill)))


def test_perspective_given_the_jax_draws():
    x = _imgs(3)
    fill = np.asarray([0.5, 0.0, -0.5], np.float32)
    key = jax.random.PRNGKey(6)
    want = jaug.random_perspective(key, jnp.asarray(x), 0.5, jnp.asarray(fill), p=0.7)
    kd, kp = jax.random.split(key)
    d = torch.from_numpy(np.asarray(jax.random.uniform(kd, (3, 4, 2))))
    apply = torch.from_numpy(np.asarray(jax.random.bernoulli(kp, 0.7, (3, 1, 1, 1))))
    ends = paug.perspective_endpoints(d, 24, 20, 0.5)
    warped = paug.perspective_batch(torch.from_numpy(x), ends, torch.from_numpy(fill))
    _close(torch.where(apply, warped, torch.from_numpy(x)), want, atol=1e-4)
    _close(warped, jaug.perspective_batch(jnp.asarray(x), jnp.asarray(ends.numpy()),
                                          jnp.asarray(fill)), atol=1e-4)


def test_augment_fn_composes_in_the_reference_order():
    """jitter -> perspective -> flip -> resized crop -> rotation, each
    drawing from the one generator in turn; ImageNet-normalized in and out,
    the jitter in [0, 1] space, the fill normalized black."""
    flags = dict(brightness=0.3, contrast=0.2, saturation=0.2, hue=0.05, horizontal_flip=True,
                 random_resized_crop=0.3, rand_perspective=0.4, random_rotation=10.0)
    x = torch.from_numpy(_imgs(4))
    got = paug.make_augment_fn(**flags)(torch.Generator().manual_seed(9), x)
    g = torch.Generator().manual_seed(9)
    mean = torch.as_tensor(paug.IMAGENET_MEAN)
    std = torch.as_tensor(paug.IMAGENET_STD)
    fill = -mean / std
    y = (paug.color_jitter(g, x * std + mean, 0.3, 0.2, 0.2, 0.05) - mean) / std
    y = paug.random_perspective(g, y, 0.4, fill)
    flip = torch.rand((3, 1, 1, 1), generator=g) < 0.5
    y = torch.where(flip, y.flip(2), y)
    y = paug.random_resized_crop(g, y, (24, 20), (0.7, 1.0))
    y = paug.random_rotation(g, y, 10.0, fill)
    assert torch.equal(got, y)
    assert torch.equal(paug.make_augment_fn()(torch.Generator(), x), x)


# ------------------------------------------------------------------ train_triplet

TINY = dict(backbone="resnet18conv4", aggregation="netvlad", netvlad_clusters=4)


@pytest.fixture(scope="module")
def tiny_model():
    jmodel = jnetwork.GeoLocalizationNet(**TINY)
    variables = jax.device_get(_perturb(
        _init(jmodel, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))), 3))
    port = materialize(lambda: pnetwork.GeoLocalizationNet(**TINY), from_jax_params(variables),
                       "cpu")
    return jmodel, variables, port


def _port_descriptor_fn(model):
    def fn(params, images):
        return torch.func.functional_call(model, params, (images,))

    return fn


LOOP = dict(epochs=2, queries_per_epoch=4, cache_refresh_every=2, batch_size=2, neg_num=2,
            mining="random", criterion="sare_ind", optim="sgd", lr=1e-2, recall_values=(1, 5),
            eval_batch_size=4, seed=3)


@pytest.fixture(scope="module")
def loop_runs(vg_root, tiny_model, tmp_path_factory):
    jmodel, variables, port = tiny_model
    jds, pds = _datasets(vg_root)
    out = tmp_path_factory.mktemp("loop")
    jstate, jbest, jhist = jloop.train_triplet(lambda v, x: jmodel.apply(v, x), variables,
                                               jds, jds, **LOOP)
    params = {**dict(port.named_parameters()), **dict(port.named_buffers())}
    state, best, hist = ploop.train_triplet(_port_descriptor_fn(port), params, pds, pds,
                                            output_dir=str(out), device="cpu", **LOOP)
    return dict(jstate=jstate, jbest=jbest, jhist=jhist, state=state, best=best, hist=hist,
                out=str(out), params=params)


def test_train_triplet_matches_jax(loop_runs):
    r = loop_runs
    assert len(r["hist"]) == len(r["jhist"])
    for got, want in zip(r["hist"], r["jhist"]):
        assert got["epoch"] == want["epoch"] and got["recalls"] == want["recalls"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=1e-5)
    assert r["best"] == r["jbest"]
    jparams = from_jax_params(jax.device_get(r["jstate"].params))
    for k, t in r["state"].params.items():
        moved = np.abs(jparams[k].numpy() - r["params"][k].numpy()).max()
        np.testing.assert_allclose(t.detach().numpy(), jparams[k].numpy(), rtol=0,
                                   atol=1e-3 * moved + 2.4e-7, err_msg=k)   # + 1 ulp at |w| < 2
    assert r["state"].step == int(r["jstate"].step) == 4   # 2 epochs x 2 whole batches
    # the caller's parameters are untouched
    assert not torch.equal(r["params"]["aggregation.centroids"],
                           r["state"].params["aggregation.centroids"].detach())


def test_checkpoint_and_resume(loop_runs):
    r = loop_runs
    assert os.path.isfile(os.path.join(r["out"], "best_checkpoint"))
    state, epoch, best = pcheckpoint.resume_train(r["out"])
    assert epoch == len(r["hist"]) and best == r["best"]
    for k, t in r["state"].params.items():
        assert torch.equal(state["params"][k], t.detach()), k


def test_patience_stops_the_loop(vg_root, tiny_model, monkeypatch):
    """R@5 never improves after the first epoch: patience 1 stops after
    the second, as the JAX loop does with the same recalls."""
    jmodel, variables, port = tiny_model
    jds, pds = _datasets(vg_root)
    flat = (np.asarray([10.0, 10.0]), "flat")
    monkeypatch.setattr(jloop, "evaluate", lambda *a, **k: flat)
    monkeypatch.setattr(ploop, "evaluate", lambda *a, **k: flat)
    kw = dict(LOOP, epochs=4, queries_per_epoch=2, cache_refresh_every=2, patience=1)
    _, _, jhist = jloop.train_triplet(lambda v, x: jmodel.apply(v, x), variables, jds, jds, **kw)
    params = {**dict(port.named_parameters()), **dict(port.named_buffers())}
    _, best, hist = ploop.train_triplet(_port_descriptor_fn(port), params, pds, pds,
                                        device="cpu", **kw)
    assert len(hist) == len(jhist) == 2 and best == 10.0


def test_augment_touches_the_query_only(vg_root, tiny_model, monkeypatch):
    """augment_fn sees each batch's query slot, on the step's device."""
    _, _, port = tiny_model
    _, pds = _datasets(vg_root)
    seen = []

    def aug(gen, q):
        seen.append(tuple(q.shape))
        return q * 0

    monkeypatch.setattr(ploop, "evaluate", lambda *a, **k: (np.asarray([0.0, 0.0]), ""))
    params = {**dict(port.named_parameters()), **dict(port.named_buffers())}
    ploop.train_triplet(_port_descriptor_fn(port), params, pds, pds, augment_fn=aug,
                        device="cpu", **dict(LOOP, epochs=1))
    assert seen == [(2, 64, 64, 3)] * 2


# ------------------------------------------------------------------ CosPlace

def test_assign_classes_exact():
    rng = np.random.default_rng(0)
    east, north = rng.uniform(0, 200, 300), rng.uniform(0, 200, 300)
    heading = rng.uniform(0, 360, 300)
    for h in (heading, None):
        want = jcos.assign_classes(east, north, h)
        got = pcos.assign_classes(east, north, h)
        assert len(got[0]) == len(want[0]) == 50
        for a, b in zip(got[0], want[0]):
            np.testing.assert_array_equal(a, b)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[2], want[2])


def _cos_setup():
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((6, 16)).astype(np.float32)
    labels = np.asarray([0, 2, 1, 4, 2, 3])
    jhead = jcos.MarginCosineProduct(5)
    hvars = jax.device_get(_init(jhead, jax.random.PRNGKey(2), jnp.asarray(feats),
                                 jnp.asarray(labels)))
    return feats, labels, jhead, hvars


def test_cosface_head_and_loss_match_jax():
    feats, labels, jhead, hvars = _cos_setup()
    phead = materialize(lambda: pcos.MarginCosineProduct(5, in_dim=16), from_jax_params(hvars),
                        "cpu")
    want = jhead.apply(hvars, jnp.asarray(feats), jnp.asarray(labels))
    with torch.no_grad():
        got = phead(torch.from_numpy(feats), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    _want = float(jcos.cosface_loss_fn(want, jnp.asarray(labels)))
    got_l = pcos.cosface_loss_fn(got, torch.from_numpy(labels)).item()
    assert abs(got_l - _want) <= 1e-6 * abs(_want)
    # the port's own init: xavier-uniform [C, D]
    w = pcos.MarginCosineProduct(300, in_dim=100, generator=torch.Generator().manual_seed(0))
    bound = (6 / 400) ** 0.5
    assert w.weight.shape == (300, 100) and w.weight.abs().max() <= bound
    assert w.weight.abs().max() > 0.95 * bound


def test_cosplace_step_matches_jax():
    """One step of CosPlace's model (ResNet-18 + GeM + fc 16 at 64 px) and
    a group head under two SGD optimizers: loss 1e-5 relative, both
    parameter sets within lr · 1e-4 of the largest |g| (+ one ulp). The
    BatchNorm statistics stay out of the port's optimizer, as in its
    triplet step; the JAX step differentiates its whole model tree, so its
    statistics move by SGD (F21, ROADMAP.md §3)."""
    from anyloc_tpu.training import mixvpr as jmixvpr

    from anyloc_tpu_torch.training import mixvpr as pmixvpr

    kw = dict(backbone="resnet18", agg_arch="cosplace", agg_config={"in_dim": 512, "out_dim": 16},
              layers_to_crop=())
    jmodel = jmixvpr.VPRModel(**kw)
    x = np.random.default_rng(4).standard_normal((6, 64, 64, 3)).astype(np.float32)
    mvars = jax.device_get(_perturb(_init(jmodel, jax.random.PRNGKey(0), jnp.asarray(x[:1])), 2))
    feats, labels, jhead, hvars = _cos_setup()
    lr = 1e-2
    jstep = jcos.make_cosplace_train_step(lambda v, im: jmodel.apply(v, im), jhead,
                                          optax.sgd(lr), optax.sgd(lr))
    js, jl = jstep(jstep.init_state(mvars, hvars), jnp.asarray(x), jnp.asarray(labels))
    port = materialize(lambda: pmixvpr.VPRModel(**kw, input_hw=(64, 64)),
                       from_jax_params(mvars), "cpu")
    phead = materialize(lambda: pcos.MarginCosineProduct(5, in_dim=16), None, "cpu")
    step = pcos.make_cosplace_train_step(
        _port_descriptor_fn(port), phead, lambda ps: torch.optim.SGD(ps, lr=lr),
        lambda ps: torch.optim.SGD(ps, lr=lr))
    state = step.init_state({**dict(port.named_parameters()), **dict(port.named_buffers())},
                            from_jax_params(hvars))
    state, loss = step(state, torch.from_numpy(x), torch.from_numpy(labels))
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl)) and state.step == 1
    for got, want in ((state.model_params, from_jax_params(jax.device_get(js.model_params))),
                      (state.classifier_params,
                       from_jax_params(jax.device_get(js.classifier_params)))):
        for k, t in got.items():
            if ptriplet.is_statistic(k):
                assert not t.requires_grad and not np.array_equal(t.numpy(), want[k].numpy())
                continue
            bound = 1e-7 if t.grad is None else lr * 1e-4 * t.grad.abs().max().item() + 1e-7
            np.testing.assert_allclose(t.detach().numpy(), want[k].numpy(), rtol=0, atol=bound)


# ------------------------------------------------------------------ contrastive head

def test_contrastive_head_loss_and_step_match_jax():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((3, 24)).astype(np.float32)
    pos = rng.standard_normal((3, 2, 24)).astype(np.float32)
    neg = rng.standard_normal((3, 4, 24)).astype(np.float32)
    jmlp = jextras.ContrastiveMLP(8, hidden_dim=12)
    jp = jax.device_get(_perturb(_init(jmlp, jax.random.PRNGKey(0), jnp.asarray(a)), 1))
    mlp = materialize(lambda: pextras.ContrastiveMLP(8, 12, in_dim=24), from_jax_params(jp),
                      "cpu")
    with torch.no_grad():
        np.testing.assert_allclose(mlp(torch.from_numpy(a)).numpy(),
                                   np.asarray(jmlp.apply(jp, jnp.asarray(a))), rtol=0, atol=1e-5)
    want_l = float(jextras.contrastive_loss(*map(jnp.asarray, (a, pos, neg)), 0.5))
    got_l = pextras.contrastive_loss(*map(torch.from_numpy, (a, pos, neg)), 0.5).item()
    assert abs(got_l - want_l) <= 1e-6 * abs(want_l)
    lr = 0.1
    opt = optax.sgd(lr)
    jstep = jextras.make_contrastive_train_step(jmlp, opt, 0.5)
    jparams, _, jl = jstep(jp, opt.init(jp), *map(jnp.asarray, (a, pos, neg)))
    step = pextras.make_contrastive_train_step(mlp, lambda ps: torch.optim.SGD(ps, lr=lr), 0.5)
    params, opt_state = step.init_state(dict(mlp.named_parameters()))
    params, opt_state, loss = step(params, opt_state, *map(torch.from_numpy, (a, pos, neg)))
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    want = from_jax_params(jax.device_get(jparams))
    for k, t in params.items():
        np.testing.assert_allclose(t.detach().numpy(), want[k].numpy(), rtol=0, atol=1e-6)


# ------------------------------------------------------------------ the train CLI

BAD_ARGV = [
    ["--queries-per-epoch", "10", "--cache-refresh-every", "3"],
    ["--mining", "msls_weighted"],
    ["--backbone", "vit"],
    ["--backbone", "cct384"],
    ["--aggregation", "cls"],
    ["--backbone", "cct384", "--resize", "384", "384", "--aggregation", "crn"],
    ["--backbone", "vit", "--resize", "224", "224", "--aggregation", "rmac"],
    ["--trunc-te", "3"],
    ["--freeze-te", "3"],
    ["--remat"],
    ["--trunc-te", "20"],
]


@pytest.mark.parametrize("argv", BAD_ARGV, ids=[" ".join(a) for a in BAD_ARGV])
def test_train_cli_errors_match_jax(argv, capsys):
    base = ["--dataset", "pitts30k", "--datasets-folder", "/nonexistent"]
    with pytest.raises(SystemExit) as want:
        jtrain_cli.main(base + argv)
    want_err = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit) as got:
        ptrain_cli.main(base + argv, device="cpu")
    got_err = capsys.readouterr().err.strip().splitlines()[-1]
    assert got.value.code == want.value.code == 2
    assert got_err == want_err


@pytest.fixture
def restore_logging(monkeypatch):
    """setup_logging replaces the root logger's handlers and level and sets
    sys.excepthook: each is put back after the test."""
    import sys

    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    monkeypatch.setattr(sys, "excepthook", sys.excepthook)
    yield
    for h in root.handlers:
        h.close()
    root.handlers[:] = handlers
    root.setLevel(level)


def test_train_cli_runs_and_resumes_on_the_cpu(vg_root, tmp_path, monkeypatch, restore_logging):
    """python -m anyloc_tpu_torch train through cli.main on the CPU:
    dvgl's model with NetVLAD's k-means init, partial mining, one epoch;
    the checkpoint it writes; then --resume from it (the resumed run's
    starting parameters are the saved ones; without --netvlad-init-samples,
    which would k-means NetVLAD again over the restored backbone, as the
    JAX CLI does, F20)."""
    out = tmp_path / "run"
    argv = ["train", "--dataset", "pitts30k", "--datasets-folder", vg_root,
            "--resize", "64", "64", "--netvlad-clusters", "4", "--neg-num", "2",
            "--neg-samples-num", "8", "--epochs", "1", "--queries-per-epoch", "2",
            "--cache-refresh-every", "2", "--train-batch-size", "1", "--infer-batch-size", "4",
            "--netvlad-init-samples", "64", "--recall-values", "1", "5",
            "--output-dir", str(out), "--horizontal-flip"]
    assert port_cli.main(argv, device="cpu") == 0
    first, epoch, _ = pcheckpoint.resume_train(str(out))
    assert epoch == 1 and os.path.isfile(out / "best_checkpoint")
    assert (out / "info.log").read_text().count("epoch 0: loss=") == 1
    seen = {}
    real = ploop.train_triplet

    def spy(descriptor_fn, init_params, *a, **kw):
        seen.update({k: v.clone() for k, v in init_params.items()})
        return real(descriptor_fn, init_params, *a, **kw)

    monkeypatch.setattr(ploop, "train_triplet", spy)
    i = argv.index("--netvlad-init-samples")
    resume = argv[:i] + argv[i + 2:]
    assert port_cli.main(resume + ["--resume"], device="cpu") == 0
    assert seen.keys() == first["params"].keys()
    for k, v in first["params"].items():
        assert torch.equal(seen[k], v), k


def test_netvlad_init_refuses_a_token_backbone():
    with pytest.raises(SystemExit):
        ptrain_cli.parse(["--dataset", "x", "--datasets-folder", ".", "--backbone", "vit",
                          "--resize", "224", "224", "--netvlad-init-samples", "64"])


# ------------------------------------------------------------------ seeding and logging

def test_seeding_and_key_stream():
    pseeding.seed_everything(11)
    a = (np.random.rand(), torch.rand(1).item())
    pseeding.make_deterministic(11)
    assert (np.random.rand(), torch.rand(1).item()) == a
    assert os.environ["PYTHONHASHSEED"] == "11"
    s1, s2 = pseeding.key_stream(4), pseeding.key_stream(4)
    g = [next(s1) for _ in range(3)]
    assert all(isinstance(x, torch.Generator) for x in g)
    draws = [torch.rand(2, generator=x) for x in g]
    assert torch.equal(draws[0], torch.rand(2, generator=next(s2)))
    assert not torch.equal(draws[0], draws[1])


def test_setup_logging_writes_both_files(tmp_path, restore_logging):
    plog.setup_logging(str(tmp_path), console="")
    logging.info("hello info")
    logging.debug("hello debug")
    for h in logging.getLogger().handlers:
        h.flush()
    assert "hello info" in (tmp_path / "info.log").read_text()
    debug = (tmp_path / "debug.log").read_text()
    assert "hello info" in debug and "hello debug" in debug
