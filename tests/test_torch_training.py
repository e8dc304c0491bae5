"""The trained baselines' eval path against the JAX package's, in float32
on the CPU: the aggregators through GeoLocalizationNet (every aggregation,
CNN and token backbones) and VPRModel (every head), the MixVPR / CosPlace
release converters, ``evaluate`` (every test method, resident and
streamed search), the ``eval`` CLI of both packages on one synthetic tree
and one set of weights, and the port's checkpoint file. Tolerance: atol
1e-5 unless a test states another bound and its reason.
"""

import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_models import _apply, _close, _imgs, _init, _perturb

from anyloc_tpu.data.loaders.base_dataset import BaseDataset as JaxBaseDataset
from anyloc_tpu.data.synthetic import build_vg_bench
from anyloc_tpu.training import eval_cli as jeval_cli
from anyloc_tpu.training import evaluate as jevaluate
from anyloc_tpu.training import mixvpr as jmixvpr
from anyloc_tpu.training import network as jnetwork
from anyloc_tpu.utils import checkpoint as jcheckpoint

from anyloc_tpu_torch import cli as port_cli
from anyloc_tpu_torch.data.loaders.base_dataset import BaseDataset
from anyloc_tpu_torch.models.convert import from_jax_params, materialize
from anyloc_tpu_torch.training import evaluate as pevaluate
from anyloc_tpu_torch.training import mixvpr as pmixvpr
from anyloc_tpu_torch.training import network as pnetwork
from anyloc_tpu_torch.utils import checkpoint as pcheckpoint

torch.set_num_threads(2)


def _pair(jmodel, pmake, x, seed=1):
    variables = _perturb(_init(jmodel, jax.random.PRNGKey(0), jnp.asarray(x[:1])), seed)
    return variables, materialize(pmake, from_jax_params(variables), "cpu")


def _fwd(port, x):
    with torch.no_grad():
        return port(torch.from_numpy(x))


# ------------------------------------------------------------------ GeoLocalizationNet

CNN_AGGS = ["netvlad", "crn", "rrm", "gem", "mac", "spoc", "rmac"]


@pytest.mark.parametrize("fc", [None, 16], ids=["no-fc", "fc16"])
@pytest.mark.parametrize("agg", CNN_AGGS)
def test_geolocalization_net_cnn_matches_jax(agg, fc):
    """resnet18conv4 with each aggregation (netvlad / crn with 4 clusters),
    with and without the fc head."""
    x = _imgs(1, 2, 64, 64)
    kw = dict(backbone="resnet18conv4", aggregation=agg, netvlad_clusters=4, fc_output_dim=fc)
    jmodel = jnetwork.GeoLocalizationNet(**kw)
    variables, port = _pair(jmodel, lambda: pnetwork.GeoLocalizationNet(**kw), x)
    want = _apply(jmodel, variables, jnp.asarray(x))
    got = _fwd(port, x)
    _close(got, want)
    _close(got.norm(dim=-1), np.ones(2), atol=1e-5)


TOKEN_CASES = [("cct384", "netvlad", 384), ("cct384", "gem", 384), ("cct384", "cls", 384),
               ("cct384", "seqpool", 384), ("vit", "netvlad", 32), ("vit", "gem", 32),
               ("vit", "cls", 32)]


@pytest.mark.parametrize("backbone,agg,px", TOKEN_CASES)
def test_geolocalization_net_token_backbones_match_jax(backbone, agg, px):
    """The token route (tokens for netvlad / gem, CLS or seq-pool
    otherwise) over a 2-block CCT-14/7x2 at 384 px and a 2-block ViT-B/16
    (the port's trunk: K5's plain version here)."""
    x = _imgs(2, 2, px, px)
    kw = dict(backbone=backbone, aggregation=agg, netvlad_clusters=4, trunc_te=2)
    jmodel = jnetwork.GeoLocalizationNet(**kw)
    variables, port = _pair(jmodel, lambda: pnetwork.GeoLocalizationNet(**kw, img_size=px), x)
    _close(_fwd(port, x), _apply(jmodel, variables, jnp.asarray(x)))


@pytest.mark.parametrize("backbone", ["vgg16", "alexnet"])
def test_geolocalization_net_other_cnns_match_jax(backbone):
    x = _imgs(3, 2, 96, 96)
    kw = dict(backbone=backbone, aggregation="netvlad", netvlad_clusters=4)
    jmodel = jnetwork.GeoLocalizationNet(**kw)
    variables, port = _pair(jmodel, lambda: pnetwork.GeoLocalizationNet(**kw), x)
    _close(_fwd(port, x), _apply(jmodel, variables, jnp.asarray(x)))


def test_geolocalization_net_refusals_match_jax():
    """Spatial aggregations on a token backbone and unknown names raise
    ValueError in both packages."""
    x = jnp.zeros((1, 32, 32, 3))
    for kw in (dict(backbone="vit", aggregation="crn"), dict(backbone="vit", aggregation="seqpool"),
               dict(backbone="resnet34conv4"), dict(aggregation="nope")):
        with pytest.raises(ValueError):
            jnetwork.GeoLocalizationNet(**kw).init(jax.random.PRNGKey(0), x)
        with pytest.raises(ValueError):
            pnetwork.GeoLocalizationNet(**kw)


# ------------------------------------------------------------------ VPRModel

VPR_CASES = {
    "mixvpr": ("resnet18", "mixvpr", {"out_channels": 8, "out_rows": 2, "mix_depth": 2}, (4,)),
    "convap": ("resnet18", "convap", {"in_channels": 256, "out_channels": 8}, (4,)),
    "gem": ("resnet18", "gem", {"p": 3}, (4,)),
    "cosplace": ("resnet18", "cosplace", {"in_dim": 512, "out_dim": 16}, ()),
    "efficientnet-gem": ("efficientnet_b0", "gem", {"p": 3}, ()),
}


@pytest.mark.parametrize("name", sorted(VPR_CASES))
def test_vprmodel_matches_jax(name):
    """VPRModel over each head (MixVPR sized for the 4x5 map of a 64x80
    input, ConvAP's uneven adaptive cells, GeM, CosPlace's GeM + fc)."""
    bb, agg, cfg, crop = VPR_CASES[name]
    x = _imgs(4, 2, 64, 80)
    jmodel = jmixvpr.VPRModel(backbone=bb, agg_arch=agg, agg_config=cfg, layers_to_crop=crop)
    variables, port = _pair(jmodel, lambda: pmixvpr.VPRModel(
        backbone=bb, agg_arch=agg, agg_config=cfg, layers_to_crop=crop, input_hw=(64, 80)), x)
    _close(_fwd(port, x), _apply(jmodel, variables, jnp.asarray(x)))


def test_registry_dispatch_and_validation_match_jax():
    with torch.device("meta"):
        for args in (("resnet50", (4,)), ("resnet50", (3, 4)), ("efficientnet_b2", ()),
                     ("efficientnet", ()), ("swin", ()), ("vgg16", ())):
            assert pmixvpr.get_backbone(*args)[1] == jmixvpr.get_backbone(*args)[1], args
        for args in (("resnet34", ()), ("resnet50", (3,))):
            with pytest.raises(ValueError):
                pmixvpr.get_backbone(*args)
        for agg, cfg in (("cosplace", {"in_dim": 8}), ("convap", {}), ("nope", {}),
                         ("mixvpr", {"in_channels": 8})):
            with pytest.raises(ValueError):
                pmixvpr.get_aggregator(agg, cfg)


class _Mixer(torch.nn.Module):
    def __init__(self, hw):
        super().__init__()
        self.mix = torch.nn.Sequential(torch.nn.LayerNorm(hw), torch.nn.Linear(hw, hw),
                                       torch.nn.ReLU(), torch.nn.Linear(hw, hw))


def _mixvpr_release(rng, n_tokens=16, out_channels=8, depth=2, out_rows=2):
    """A MixVPR release-layout state dict: ``backbone.model.*`` (torchvision
    resnet50 cut at layer4) + ``aggregator.mix.{i}.mix.{0,1,3}`` +
    ``channel_proj`` + ``row_proj``."""
    from test_torch_backbones import _torchvision_resnet_sd

    torch.manual_seed(3)
    agg = torch.nn.Module()
    agg.mix = torch.nn.Sequential(*[_Mixer(n_tokens) for _ in range(depth)])
    agg.channel_proj = torch.nn.Linear(1024, out_channels)
    agg.row_proj = torch.nn.Linear(n_tokens, out_rows)
    sd = {f"backbone.model.{k}": v
          for k, v in _torchvision_resnet_sd(rng, (3, 4, 6), True, 3).items()}
    sd.update({f"aggregator.{k}": v.detach().numpy() for k, v in agg.state_dict().items()})
    return sd


def _cosplace_release(rng, out_dim=16, p=2.7):
    """A CosPlace release-layout state dict over resnet18: ``backbone.{i}.*``
    (the Sequential renumbering) + ``aggregation.1.p`` + ``aggregation.3``."""
    from test_torch_backbones import _torchvision_resnet_sd

    idx = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5", "layer3": "6", "layer4": "7"}
    sd = {}
    for k, v in _torchvision_resnet_sd(rng, (2, 2, 2, 2), False, 4).items():
        head, rest = k.split(".", 1)
        sd[f"backbone.{idx[head]}.{rest}"] = v
    sd["aggregation.1.p"] = np.full((1,), p, np.float32)
    sd["aggregation.3.weight"] = (rng.standard_normal((out_dim, 512)) * 0.05).astype(np.float32)
    sd["aggregation.3.bias"] = (rng.standard_normal(out_dim) * 0.1).astype(np.float32)
    return sd


@pytest.mark.parametrize("family", ["mixvpr", "cosplace"])
def test_release_converters_give_the_jax_model(family):
    """One release-layout state dict through both packages' converters:
    the port's state dict is ``from_jax_params`` of the JAX variables, key
    for key, and the two VPRModels agree end to end."""
    rng = np.random.default_rng(6)
    x = _imgs(5, 2, 64, 64)
    if family == "mixvpr":
        sd = _mixvpr_release(rng)
        jvars, psd = jmixvpr.convert_mixvpr_checkpoint(sd), pmixvpr.convert_mixvpr_checkpoint(sd)
        kw = dict(backbone="resnet50", agg_arch="mixvpr",
                  agg_config={"out_channels": 8, "out_rows": 2, "mix_depth": 2})
    else:
        sd = _cosplace_release(rng)
        jvars = jmixvpr.convert_cosplace_checkpoint(sd, backbone="resnet18")
        psd = pmixvpr.convert_cosplace_checkpoint(sd, backbone="resnet18")
        kw = dict(backbone="resnet18", layers_to_crop=(), agg_arch="cosplace",
                  agg_config={"in_dim": 512, "out_dim": 16})
    want_sd = from_jax_params(jvars)
    assert set(psd) == set(want_sd)
    for k in psd:
        _close(psd[k], want_sd[k], atol=0)
    port = materialize(lambda: pmixvpr.VPRModel(**kw, input_hw=(64, 64)), psd, "cpu")
    _close(_fwd(port, x), _apply(jmixvpr.VPRModel(**kw), jvars, jnp.asarray(x)))


# ------------------------------------------------------------------ evaluate

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


METHODS = ["hard_resize", "central_crop", "single_query", "five_crops", "nearest_crop",
           "maj_voting"]


@pytest.mark.parametrize("efficient_ram", [False, True], ids=["resident", "streamed"])
@pytest.mark.parametrize("method", METHODS)
def test_evaluate_matches_jax(vg_root, tmp_path, method, efficient_ram):
    """Every query test method, the search resident on the device or
    streamed (``efficient_ram``): the recalls equal JAX's, and so do the
    saved descriptors (``save_descs``)."""
    jds, pds = _datasets(vg_root)
    kw = dict(test_method=method, recall_values=(1, 5, 10), batch_size=4,
              efficient_ram=efficient_ram)
    want, want_s = jevaluate.evaluate(_desc_fn(), jds, save_descs=str(tmp_path / "j"), **kw)
    got, got_s = pevaluate.evaluate(_desc_fn(), pds, save_descs=str(tmp_path / "p"), device="cpu",
                                    **kw)
    np.testing.assert_array_equal(got, want)
    assert got_s == want_s
    _close(np.load(tmp_path / "p.npy"), np.load(tmp_path / "j.npy"))


@pytest.mark.parametrize("method", ["hard_resize", "five_crops"])
def test_evaluate_with_a_model_matches_jax(vg_root, tmp_path, method):
    """A GeoLocalizationNet (resnet18conv4 + GeM) on the same weights as the
    descriptor function of both packages: descriptors within atol 1e-5,
    recalls equal."""
    jds, pds = _datasets(vg_root)
    x = np.zeros((1, 64, 64, 3), np.float32)
    kw = dict(backbone="resnet18conv4", aggregation="gem")
    jmodel = jnetwork.GeoLocalizationNet(**kw)
    variables, port = _pair(jmodel, lambda: pnetwork.GeoLocalizationNet(**kw), x)
    infer = jax.jit(lambda im: jmodel.apply(variables, im))
    ekw = dict(test_method=method, recall_values=(1, 5), batch_size=5)
    want, _ = jevaluate.evaluate(lambda im: infer(jnp.asarray(im)), jds,
                                 save_descs=str(tmp_path / "j"), **ekw)
    got, _ = pevaluate.evaluate(lambda im: _fwd(port, np.asarray(im, np.float32)), pds,
                                save_descs=str(tmp_path / "p"), device="cpu", **ekw)
    np.testing.assert_array_equal(got, want)
    _close(np.load(tmp_path / "p.npy"), np.load(tmp_path / "j.npy"))


def test_top_n_voting_matches_jax():
    preds = np.array([[3, 1, 9, 9, 2], [3, 2, 9, 1, 1], [3, 4, 2, 2, 0], [5, 6, 7, 8, 9],
                      [3, 7, 1, 0, 0]])
    for topn in ("top1", "top5"):
        d_j = np.linspace(0, 1, 25, dtype=np.float32).reshape(5, 5)
        d_p = d_j.copy()
        jevaluate.top_n_voting(topn, preds, d_j, 0.1)
        pevaluate.top_n_voting(topn, preds, d_p, 0.1)
        np.testing.assert_array_equal(d_p, d_j)
    dists = np.random.default_rng(0).random(25).astype(np.float32)
    np.testing.assert_array_equal(pevaluate._dedup_keep_closest(preds.ravel(), dists, 4),
                                  jevaluate._dedup_keep_closest(preds.ravel(), dists, 4))


# ------------------------------------------------------------------ the eval CLI

def _main(fn, argv, **kw):
    with redirect_stdout(io.StringIO()) as out:
        assert fn(argv, **kw) == 0
    lines = out.getvalue().strip().splitlines()
    return lines[-2], json.loads(lines[-1])


@pytest.fixture(scope="module")
def weights(tmp_path_factory, vg_root):
    """One set of weights per family, as each package reads it: dvgl a JAX
    orbax checkpoint and the port's file of the same variables (through
    ``from_jax_params``); mixvpr and cosplace one release-layout file."""
    d = tmp_path_factory.mktemp("weights")
    jmodel = jnetwork.GeoLocalizationNet(backbone="resnet18conv4", aggregation="netvlad",
                                         netvlad_clusters=4)
    variables = _perturb(_init(jmodel, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))), 2)
    jcheckpoint.save_checkpoint(str(d), {"params": variables}, False, "dvgl_jax")
    pcheckpoint.save_checkpoint(str(d), {"params": from_jax_params(variables)}, False,
                                "dvgl_port")
    rng = np.random.default_rng(7)
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v))
                               for k, v in _mixvpr_release(rng).items()}}, d / "mixvpr.ckpt")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in _cosplace_release(rng).items()},
               d / "cosplace.pth")
    return d


FAMILY_ARGV = {
    "dvgl": ["--backbone", "resnet18conv4", "--aggregation", "netvlad", "--netvlad-clusters", "4"],
    "mixvpr": ["--model-family", "mixvpr", "--mix-out-channels", "8", "--mix-out-rows", "2",
               "--mix-depth", "2"],
    "cosplace": ["--model-family", "cosplace", "--backbone", "resnet18", "--fc-output-dim", "16"],
}


@pytest.mark.parametrize("extra", [[], ["--pca-dim", "4", "--save-descs", "DESCS"]],
                         ids=["plain", "pca-save-descs"])
@pytest.mark.parametrize("family", sorted(FAMILY_ARGV))
def test_eval_cli_matches_jax(vg_root, weights, tmp_path, family, extra):
    """``eval`` through ``python -m anyloc_tpu_torch``'s ``cli.main`` on the
    CPU against the JAX CLI: the same recalls on the same weights; with
    ``--pca-dim`` (fit on the database folder; components agree up to a
    sign, which L2 search does not see) and ``--save-descs`` the same
    descriptors."""
    ckpt = {"dvgl": ("dvgl_jax", "dvgl_port"), "mixvpr": ("mixvpr.ckpt",) * 2,
            "cosplace": ("cosplace.pth",) * 2}[family]
    base = FAMILY_ARGV[family] + ["--dataset", "pitts30k", "--datasets-folder", vg_root,
                                  "--resize", "64", "64", "--batch-size", "4",
                                  "--recall-values", "1", "5", "10"]
    pca_dir = os.path.join(vg_root, "pitts30k", "images", "test", "database")
    rest = [a.replace("DESCS", str(tmp_path / "{}")) for a in extra]
    if extra:
        rest += ["--pca-dataset-folder", pca_dir]
    jline, want = _main(jeval_cli.main, base + ["--checkpoint", str(weights / ckpt[0])]
                        + [a.format("j") for a in rest])
    pline, got = _main(port_cli.main, ["eval"] + base + ["--checkpoint", str(weights / ckpt[1])]
                       + [a.format("p") for a in rest], device="cpu")
    assert got == want and pline == jline
    if extra:
        _close(np.load(tmp_path / "p.npy"), np.load(tmp_path / "j.npy"))


def test_eval_cli_dvgl_pth_grafts_a_torchvision_backbone(vg_root, tmp_path):
    """A dvgl ``.pth`` (torchvision ResNet naming under ``module.``) replaces
    the backbone of the random init; the aggregation stays the init's."""
    from test_torch_backbones import _torchvision_resnet_sd

    sd = _torchvision_resnet_sd(np.random.default_rng(8), (2, 2, 2, 2), False, 3)
    torch.save({f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "bb.pth")
    base = ["eval", "--dataset", "pitts30k", "--datasets-folder", vg_root, "--resize", "64", "64",
            "--netvlad-clusters", "4", "--save-descs"]
    _main(port_cli.main, base + [str(tmp_path / "rand")], device="cpu")
    _main(port_cli.main, base + [str(tmp_path / "pth"), "--checkpoint", str(tmp_path / "bb.pth")],
          device="cpu")
    assert not np.allclose(np.load(tmp_path / "rand.npy"), np.load(tmp_path / "pth.npy"))
    from anyloc_tpu_torch.training.eval_cli import SEED
    rand = materialize(lambda: pnetwork.GeoLocalizationNet(netvlad_clusters=4, img_size=64),
                       None, "cpu", seed=SEED)
    from anyloc_tpu_torch.models.resnet import convert_torchvision_resnet, resnet18_config
    bb = convert_torchvision_resnet(sd, resnet18_config(truncate="conv4"))
    for k, v in bb.items():
        rand.state_dict()[f"backbone.{k}"].copy_(v)
    pds = BaseDataset(vg_root, "pitts30k", "test", img_size=(64, 64))
    pevaluate.evaluate(lambda im: _fwd(rand, np.asarray(im, np.float32)), pds, batch_size=16,
                       save_descs=str(tmp_path / "want"), device="cpu")
    _close(np.load(tmp_path / "pth.npy"), np.load(tmp_path / "want.npy"))


def test_eval_cli_runs_on_the_card_by_default(vg_root):
    """With no device named the CLI runs on the card: without one it raises
    before building anything (F5)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(["eval", "--dataset", "pitts30k", "--datasets-folder", vg_root])


# ------------------------------------------------------------------ checkpoints

def test_checkpoint_round_trip(tmp_path):
    sd = {"w": torch.arange(6.0).reshape(2, 3)}
    pcheckpoint.save_checkpoint(str(tmp_path), {"params": sd, "epoch": 3, "best_r5": 81.5}, True)
    for name in ("last_checkpoint", "best_checkpoint"):
        state = pcheckpoint.load_checkpoint(str(tmp_path / name))
        assert state["epoch"] == 3 and state["best_r5"] == 81.5
        assert torch.equal(state["params"]["w"], sd["w"])


def test_orbax_checkpoint_raises_naming_the_way_across(tmp_path):
    """A directory written by the JAX package's orbax checkpointer is
    refused, with a message naming the format and ``from_jax_params``."""
    jcheckpoint.save_checkpoint(str(tmp_path), {"params": {"w": np.ones(3, np.float32)}}, False)
    with pytest.raises(ValueError, match="orbax") as info:
        pcheckpoint.load_checkpoint(str(tmp_path / "last_checkpoint"))
    assert "from_jax_params" in str(info.value)
