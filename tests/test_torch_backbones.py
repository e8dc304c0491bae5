"""The trained baselines' backbones (ResNet, VGG-16, AlexNet, EfficientNet,
SwinV2, CCT) against the JAX package's, in float32 on the CPU. Weights
cross two ways: the JAX modules' perturbed random variables (BatchNorm
statistics included) through ``from_jax_params``, and one synthetic
release-layout state dict (torchvision, ``transformers``) through both
packages' converters. Tolerance: atol 1e-5 unless a test states another
bound and its reason. F17: every convolution of the port runs through
``ops.common.Conv2d`` in full float32.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_models import _apply, _close, _imgs, _init, _perturb

from anyloc_tpu.models import cct as jcct
from anyloc_tpu.models import efficientnet as jeff
from anyloc_tpu.models import resnet as jres
from anyloc_tpu.models import swin as jswin

from anyloc_tpu_torch.models import cct as pcct
from anyloc_tpu_torch.models import efficientnet as peff
from anyloc_tpu_torch.models import resnet as pres
from anyloc_tpu_torch.models import swin as pswin
from anyloc_tpu_torch.models.convert import from_jax_params, materialize
from anyloc_tpu_torch.ops import common

transformers = pytest.importorskip("transformers")

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def _pair(jmodule, pmake, hw, seed=1):
    """(JAX module, its perturbed variables, the port's module on the same
    weights)."""
    variables = _perturb(_init(jmodule, jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3))), seed)
    return variables, materialize(pmake, from_jax_params(variables), "cpu")


def _rel_close(got, want, rel):
    """max |got - want| <= rel * max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, (err, scale)


def _run(port, x, **kw):
    with torch.no_grad():
        return port(torch.from_numpy(x), **kw)


# ------------------------------------------------------------------ ResNet / VGG / AlexNet

RESNETS = {
    "resnet18-conv4": (jres.resnet18_config, pres.resnet18_config, "conv4", (64, 80)),
    "resnet50-conv5": (jres.resnet50_config, pres.resnet50_config, "conv5", (64, 80)),
    "resnet18-conv3": (jres.resnet18_config, pres.resnet18_config, "conv3", (64, 64)),
}


@pytest.mark.parametrize("name", sorted(RESNETS))
def test_resnet_matches_jax(name):
    """BasicBlock / BottleneckBlock stacks with BN statistics carried across.
    Bound: 1e-5 of the largest |value| (a 50-layer float32 stack of
    perturbed weights reaches values of order 10-100)."""
    jfac, pfac, trunc, hw = RESNETS[name]
    jmodel = jres.ResNet(jfac(truncate=trunc))
    variables, port = _pair(jmodel, lambda: pres.ResNet(pfac(truncate=trunc)), hw)
    x = _imgs(2, 2, *hw)
    want = _apply(jmodel, variables, jnp.asarray(x))
    got = _run(port, x)
    assert tuple(got.shape) == want.shape
    assert port.fmap_hw(*hw) == tuple(want.shape[1:3])
    assert port.out_channels == jmodel.out_channels == want.shape[-1]
    _rel_close(got, want, 1e-5)


@pytest.mark.parametrize("which", ["VGG16", "AlexNet"])
def test_vgg_and_alexnet_match_jax(which):
    hw = (64, 64) if which == "VGG16" else (96, 96)
    jmodel = getattr(jres, which)()
    variables, port = _pair(jmodel, getattr(pres, which), hw)
    x = _imgs(3, 2, *hw)
    want = _apply(jmodel, variables, jnp.asarray(x))
    got = _run(port, x)
    assert port.fmap_hw(*hw) == tuple(want.shape[1:3])
    _rel_close(got, want, 1e-5)   # 13 float32 convs of perturbed weights: values of order 10


def _torchvision_resnet_sd(rng, stage_sizes, bottleneck, n_stages, scale=0.05):
    """A shape-true state dict in torchvision resnet naming."""
    sd = {}

    def add_bn(name, c):
        sd[f"{name}.weight"] = rng.standard_normal(c).astype(np.float32)
        sd[f"{name}.bias"] = rng.standard_normal(c).astype(np.float32) * 0.1
        sd[f"{name}.running_mean"] = rng.standard_normal(c).astype(np.float32) * 0.1
        sd[f"{name}.running_var"] = 1 + rng.random(c).astype(np.float32)

    def w(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    sd["conv1.weight"] = w(64, 3, 7, 7)
    add_bn("bn1", 64)
    mult, cin = (4 if bottleneck else 1), 64
    for stage in range(n_stages):
        f = 64 * 2 ** stage
        for i in range(stage_sizes[stage]):
            pre = f"layer{stage + 1}.{i}"
            c0 = cin if i == 0 else f * mult
            shapes = ([(f, c0, 1, 1), (f, f, 3, 3), (f * 4, f, 1, 1)] if bottleneck
                      else [(f, c0, 3, 3), (f, f, 3, 3)])
            for j, shape in enumerate(shapes, start=1):
                sd[f"{pre}.conv{j}.weight"] = w(*shape)
                add_bn(f"{pre}.bn{j}", shape[0])
            if i == 0 and (c0 != f * mult or stage > 0):
                sd[f"{pre}.downsample.0.weight"] = w(f * mult, c0, 1, 1)
                add_bn(f"{pre}.downsample.1", f * mult)
        cin = f * mult
    return sd


@pytest.mark.parametrize("bottleneck", [False, True], ids=["resnet18", "resnet50"])
def test_convert_torchvision_resnet_gives_the_jax_model(bottleneck):
    """One torchvision-layout state dict through both converters: the
    port's is ``from_jax_params`` of the JAX package's, key for key, and
    the two models agree."""
    rng = np.random.default_rng(4)
    sizes = (3, 4, 6, 3) if bottleneck else (2, 2, 2, 2)
    sd = _torchvision_resnet_sd(rng, sizes, bottleneck, 3)
    jcfg = (jres.resnet50_config if bottleneck else jres.resnet18_config)(truncate="conv4")
    pcfg = (pres.resnet50_config if bottleneck else pres.resnet18_config)(truncate="conv4")
    jvars = jres.convert_torchvision_resnet(sd, jcfg)
    psd = pres.convert_torchvision_resnet(sd, pcfg)
    want_sd = from_jax_params(jvars)
    assert set(psd) == set(want_sd)
    for k in psd:
        _close(psd[k], want_sd[k], atol=0)
    x = _imgs(5, 1, 64, 64)
    port = materialize(lambda: pres.ResNet(pcfg), psd, "cpu")
    _rel_close(_run(port, x), _apply(jres.ResNet(jcfg), jvars, jnp.asarray(x)), 1e-5)


def test_convert_torchvision_alexnet_gives_the_jax_model():
    rng = np.random.default_rng(5)
    shapes = {0: (64, 3, 11, 11), 3: (192, 64, 5, 5), 6: (384, 192, 3, 3), 8: (256, 384, 3, 3),
              10: (256, 256, 3, 3)}
    sd = {}
    for idx, shape in shapes.items():
        sd[f"features.{idx}.weight"] = (rng.standard_normal(shape) * 0.05).astype(np.float32)
        sd[f"features.{idx}.bias"] = rng.standard_normal(shape[0]).astype(np.float32) * 0.1
    jvars = jres.convert_torchvision_alexnet(sd)
    psd = pres.convert_torchvision_alexnet(sd)
    assert set(psd) == set(from_jax_params(jvars))
    x = _imgs(6, 2, 96, 96)
    port = materialize(pres.AlexNet, psd, "cpu")
    _rel_close(_run(port, x), _apply(jres.AlexNet(), jvars, jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("what", ["sync_axis"])
def test_resnet_refuses_sync_bn_and_training(what):
    """Cross-device BatchNorm raises (training mode is ported:
    tests/test_torch_train_models.py holds it to Flax's)."""
    cfg = pres.resnet18_config(truncate="conv4")
    with pytest.raises(NotImplementedError, match="parallel/ on torch.distributed"):
        pres.ResNet(dataclasses.replace(cfg, sync_axis="data"))


# ------------------------------------------------------------------ EfficientNet

_EN_STAGES = dict(in_channels=(32, 16, 24), out_channels=(16, 24, 40), kernel_sizes=(3, 3, 5),
                  strides=(1, 2, 2), expand_ratios=(1, 6, 6), num_block_repeats=(1, 2, 2))


@pytest.mark.parametrize("width,depth,hw", [(1.0, 1.0, (64, 64)), (1.1, 1.2, (64, 64)),
                                            (1.0, 1.0, (57, 45))],
                         ids=["b0-coeffs", "b2-coeffs", "odd-input"])
def test_efficientnet_matches_jax(width, depth, hw):
    """Channel / repeat rounding, TF 'same' pads (odd sizes take the
    asymmetric stride-2 pads), squeeze-excite, depthwise groups carried
    across by ``from_jax_params``."""
    jcfg = jeff.EfficientNetConfig(width_coefficient=width, depth_coefficient=depth,
                                   **_EN_STAGES)
    pcfg = peff.EfficientNetConfig(width_coefficient=width, depth_coefficient=depth,
                                   **_EN_STAGES)
    jmodel = jeff.EfficientNet(jcfg)
    variables, port = _pair(jmodel, lambda: peff.EfficientNet(pcfg), hw)
    x = _imgs(7, 2, *hw)
    want = _apply(jmodel, variables, jnp.asarray(x))
    got = _run(port, x)
    assert port.fmap_hw(*hw) == tuple(want.shape[1:3])
    _rel_close(got, want, 1e-5)   # 5-11 MBConv blocks in float32: values of order 10


def test_convert_hf_efficientnet_gives_the_jax_model():
    torch.manual_seed(0)
    cfg = dict(width_coefficient=1.0, depth_coefficient=1.0, **_EN_STAGES)
    hcfg = transformers.EfficientNetConfig(
        hidden_dim=1280, **{k: list(v) if isinstance(v, tuple) else v for k, v in cfg.items()})
    sd = transformers.EfficientNetModel(hcfg).eval().state_dict()
    jcfg, pcfg = jeff.EfficientNetConfig(**cfg), peff.EfficientNetConfig(**cfg)
    jvars = jeff.convert_hf_efficientnet(sd, jcfg)
    psd = peff.convert_hf_efficientnet({f"efficientnet.{k}": v for k, v in sd.items()}, pcfg)
    want_sd = from_jax_params(jvars)
    assert set(psd) == set(want_sd)
    for k in psd:
        _close(psd[k], want_sd[k], atol=0)
    x = _imgs(8, 1, 57, 45)
    port = materialize(lambda: peff.EfficientNet(pcfg), psd, "cpu")
    _rel_close(_run(port, x), _apply(jeff.EfficientNet(jcfg), jvars, jnp.asarray(x)), 1e-5)


def test_efficientnet_config_table_matches_jax():
    for v in ("b0", "b1", "b2", "b3", "b4", "b5", "b6", "b7"):
        assert peff.efficientnet_config(v).block_plan() == jeff.efficientnet_config(v).block_plan()
        assert peff.efficientnet_config(v).hidden_dim == jeff.efficientnet_config(v).hidden_dim


# ------------------------------------------------------------------ SwinV2

SMALL_SWIN = dict(img_size=32, patch_size=4, embed_dim=32, depths=(2, 2), num_heads=(2, 4),
                  window_size=4)


@pytest.mark.parametrize("hw", [(32, 32), (16, 16), (24, 40)],
                         ids=["square", "off-size", "non-square"])
@pytest.mark.parametrize("pretrained", [0, 3])
def test_swinv2_matches_jax(hw, pretrained):
    """Cosine attention, the clamped logit scale, the CPB MLP (own or
    pretrained window), shifted windows, padding to whole windows at an
    off-size or non-square input, odd patch merging, the final norm."""
    kw = dict(SMALL_SWIN, pretrained_window_sizes=(pretrained, pretrained))
    jmodel = jswin.SwinV2(jswin.SwinConfig(**kw))
    variables, port = _pair(jmodel, lambda: pswin.SwinV2(pswin.SwinConfig(**kw)), (32, 32))
    x = _imgs(9, 2, *hw)
    want = _apply(jmodel, variables, jnp.asarray(x))
    got = _run(port, x)
    _close(got["tokens"], want["tokens"])
    _close(got["fmap"], want["fmap"])
    assert port.fmap_hw(*hw) == tuple(want["fmap"].shape[1:3])


def test_convert_hf_swinv2_gives_the_jax_model():
    torch.manual_seed(1)
    hcfg = transformers.Swinv2Config(image_size=32, patch_size=4, embed_dim=32, depths=[2, 2],
                                     num_heads=[2, 4], window_size=4)
    sd = transformers.Swinv2Model(hcfg, add_pooling_layer=False).eval().state_dict()
    jcfg, pcfg = jswin.SwinConfig(**SMALL_SWIN), pswin.SwinConfig(**SMALL_SWIN)
    jvars = jswin.convert_hf_swinv2(sd, jcfg)
    psd = pswin.convert_hf_swinv2(sd, pcfg)
    want_sd = from_jax_params(jvars)
    assert set(psd) == set(want_sd)
    for k in psd:
        _close(psd[k], want_sd[k], atol=0)
    x = _imgs(10, 2, 24, 40)
    port = materialize(lambda: pswin.SwinV2(pcfg), psd, "cpu")
    _close(_run(port, x)["tokens"], _apply(jswin.SwinV2(jcfg), jvars, jnp.asarray(x))["tokens"])


def test_swin_static_tables_match_jax():
    for ws, pre in (((4, 4), 0), ((4, 4), 3), ((16, 16), 12)):
        _close(pswin._log_coords_table(ws, pre), jswin._log_coords_table(ws, pre), atol=0)
        assert (pswin._relative_position_index(ws) == jswin._relative_position_index(ws)).all()
    _close(pswin._shift_mask(8, 12, 4, 2), jswin._shift_mask(8, 12, 4, 2), atol=0)


# ------------------------------------------------------------------ CCT

SMALL_CCT = dict(img_size=64, embed_dim=64, n_conv_layers=2, kernel_size=7, depth=4,
                 num_heads=2, truncate_at=2)


@pytest.mark.parametrize("return_tokens", [False, True], ids=["seqpool", "tokens"])
def test_cct_matches_jax(return_tokens):
    """CCT truncated to 2 blocks: the conv tokenizer, the flat-named blocks
    through ``from_jax_params``, sequence pooling or the tokens."""
    jmodel = jcct.CCT(jcct.CCTConfig(**SMALL_CCT))
    variables, port = _pair(jmodel, lambda: pcct.CCT(pcct.CCTConfig(**SMALL_CCT)), (64, 64))
    assert port.cfg.n_tokens == variables["params"]["pos_embed"].shape[1]
    x = _imgs(11, 2, 64, 64)
    want = _apply(jmodel, variables, jnp.asarray(x), return_tokens=return_tokens)
    _close(_run(port, x, return_tokens=return_tokens), want)


def test_cct_14_7x2_384_token_count():
    assert pcct.cct_14_7x2_384().n_tokens == 576


# ------------------------------------------------------------------ F17: full float32 convs

_CONV_CALL = re.compile(r"\bnn\.Conv2d\(|\bF\.conv2d\(|torch\.conv2d\(|functional\.conv2d\(")


def test_no_conv_bypasses_the_full_float32_helper():
    """F17: outside ``ops/common.py`` the port builds no bare ``nn.Conv2d``
    and calls no ``F.conv2d``: every convolution goes through
    ``ops.common.Conv2d``."""
    hits = [f"{p.relative_to(ROOT)}:{i}" for p in (ROOT / "anyloc_tpu_torch").rglob("*.py")
            if p.name != "common.py" or p.parent.name != "ops"
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if _CONV_CALL.search(line.split("#")[0])]
    assert not hits, hits


def _conv_models():
    """A small build of every model family that has a convolution."""
    from anyloc_tpu_torch.models import imagebind, lseg, sam
    from anyloc_tpu_torch.models.cosplace_vit import hf_vit_config
    from anyloc_tpu_torch.models.vit import ViT
    from anyloc_tpu_torch.tools.family_checks import _SAM
    from anyloc_tpu_torch.training.network import GeoLocalizationNet

    vit = dataclasses.replace(hf_vit_config(img_size=32), embed_dim=32, depth=1, num_heads=2)
    return {
        "resnet18": (lambda: pres.ResNet(pres.resnet18_config(truncate="conv4")), 64),
        "vgg16": (pres.VGG16, 32),
        "alexnet": (pres.AlexNet, 96),
        "efficientnet": (lambda: peff.EfficientNet(peff.EfficientNetConfig(**_EN_STAGES)), 32),
        "swinv2": (lambda: pswin.SwinV2(pswin.SwinConfig(**SMALL_SWIN)), 32),
        "cct": (lambda: pcct.CCT(pcct.CCTConfig(**SMALL_CCT)), 64),
        "crn": (lambda: GeoLocalizationNet("resnet18conv4", "crn", 4), 64),
        "vit": (lambda: ViT(vit), 32),
        "sam": (lambda: sam.SAMImageEncoder(_SAM), 256),
        "lseg": (lambda: lseg.LSegEncoder(lseg.LSegConfig(
            backbone=dataclasses.replace(lseg.lseg_backbone_config(torch.float32), embed_dim=32,
                                         depth=2, num_heads=2, img_size=64),
            hooks=(0, 1, 1, 1), reassemble_dims=(8, 8, 16, 16), features=8, out_dim=16)), 64),
        "imagebind-depth": (lambda: imagebind._PatchTrunk(32, 1, 2, out_dim=8, kernel=16,
                                                          in_hw=(32, 32)), 32),
    }


@pytest.mark.parametrize("name", sorted(_conv_models()))
def test_every_conv_runs_in_full_float32(name, monkeypatch):
    """F17: each model's convolution modules are ``ops.common.Conv2d``, and
    every float32 convolution of its forward runs with cuDNN's convolution
    precision "ieee" (no TF32), which is put back afterwards, while the
    process's flags stay at PyTorch's defaults."""
    make, px = _conv_models()[name]
    model = materialize(make, None, "cpu", seed=0)
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    assert convs and all(isinstance(m, common.Conv2d) for m in convs)
    seen = []
    real = torch.nn.functional.conv2d

    def spy(x, *a, **kw):
        seen.append((x.dtype, torch.backends.cudnn.conv.fp32_precision))
        return real(x, *a, **kw)

    before = torch.backends.cudnn.conv.fp32_precision
    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    x = torch.randn(1, px, px, 3) if name != "imagebind-depth" else torch.randn(1, px, px)
    with torch.no_grad():
        model(x)
    assert seen and all(p == "ieee" for d, p in seen if d == torch.float32), seen
    assert torch.backends.cudnn.conv.fp32_precision == before
    assert torch.backends.cudnn.allow_tf32   # PyTorch's default, untouched
