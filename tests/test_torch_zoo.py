"""``make_extractor`` of every model family against the JAX package's,
through a checkpoint: one synthetic state dict in the family's published
layout (timm, HuggingFace, OpenAI, facebookresearch/mae, Meta SAM,
ImageBind, lang-seg), made from a numpy seed, saved as a ``.pth`` and
read by both packages' loaders and ``convert_*``. Each family's factory
config is shrunk in both packages (monkeypatched) to a small width.
Float32 on the CPU; tolerance atol 1e-5 unless a case states another.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from anyloc_tpu.models import clip as jclip
from anyloc_tpu.models import cosplace_vit as jcos
from anyloc_tpu.models import dino_v1 as jdino
from anyloc_tpu.models import factory as jfactory
from anyloc_tpu.models import imagebind as jib
from anyloc_tpu.models import lseg as jlseg
from anyloc_tpu.models import mae as jmae
from anyloc_tpu.models import sam as jsam

import anyloc_tpu_torch as port
from anyloc_tpu_torch.models import clip as pclip
from anyloc_tpu_torch.models import cosplace_vit as pcos
from anyloc_tpu_torch.models import dino_v1 as pdino
from anyloc_tpu_torch.models import imagebind as pib
from anyloc_tpu_torch.models import lseg as plseg
from anyloc_tpu_torch.models import mae as pmae
from anyloc_tpu_torch.models import sam as psam
from anyloc_tpu_torch.models import vit as pvit
from anyloc_tpu_torch.models.convert import materialize

torch.set_num_threads(2)


def _random(layout, seed):
    """Numpy-seeded values for a {name: shape} layout: LayerNorm / BN
    weights near 1, BN variances in [0.5, 1.5], matrices normal at
    1/sqrt(fan in), vectors and embeddings normal(0, 0.3)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in layout.items():
        if k.endswith("running_var"):
            a = 0.5 + rng.random(shape)
        elif k.endswith("weight") and len(shape) == 1:
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif len(shape) >= 2 and "embed" not in k and "token" not in k and "rel_pos" not in k:
            a = rng.standard_normal(shape) * np.prod(shape[1:]) ** -0.5
        else:
            a = 0.3 * rng.standard_normal(shape)
        out[k] = torch.from_numpy(a.astype(np.float32))
    return out


def _shapes(module):
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def _port_vit(cfg):
    return _shapes(materialize(lambda: pvit.ViT(cfg), None, "cpu"))


# ------------------------------------------------------------------ layouts

def _dino_v1_ckpt(monkeypatch):
    for mod in (jdino, pdino):
        monkeypatch.setitem(mod._DIMS, "dino_vits8", (8, 48, 12, 6))
    cfg = pdino.dino_v1_config("dino_vits8", stride=4)
    # timm's names are the trunk's; the classifier head drops
    return {**_random(_port_vit(cfg), 1), "head.weight": torch.zeros(10, 48)}


def _hf_vit_ckpt(monkeypatch):
    def small(pkg):
        real = pkg.hf_vit_config
        return lambda dtype=None, img_size=224: dataclasses.replace(
            real(dtype=dtype, img_size=32), embed_dim=64, depth=2, num_heads=4)

    for mod in (jcos, pcos):
        monkeypatch.setattr(mod, "hf_vit_config", small(mod))
    d, sd = 64, {}
    sd["vit.embeddings.patch_embeddings.projection.weight"] = (d, 3, 16, 16)
    sd["vit.embeddings.patch_embeddings.projection.bias"] = (d,)
    sd["vit.embeddings.cls_token"] = (1, 1, d)
    sd["vit.embeddings.position_embeddings"] = (1, 5, d)
    sd["vit.layernorm.weight"] = sd["vit.layernorm.bias"] = (d,)
    for i in range(2):
        h = f"vit.encoder.layer.{i}"
        for n in ("attention.attention.query", "attention.attention.key",
                  "attention.attention.value", "attention.output.dense"):
            sd[f"{h}.{n}.weight"], sd[f"{h}.{n}.bias"] = (d, d), (d,)
        for n in ("layernorm_before", "layernorm_after"):
            sd[f"{h}.{n}.weight"] = sd[f"{h}.{n}.bias"] = (d,)
        sd[f"{h}.intermediate.dense.weight"], sd[f"{h}.intermediate.dense.bias"] = (4 * d, d), (4 * d,)
        sd[f"{h}.output.dense.weight"], sd[f"{h}.output.dense.bias"] = (d, 4 * d), (d,)
    return _random(sd, 2)


def _clip_ckpt(monkeypatch):
    # ViT-T/16: patch 16, width 128, 2 layers, 2 heads (hd 64), embed 24, 32 px;
    # text: context 77, vocab 300, width 32, 4 heads, 2 layers
    for mod in (jclip, pclip):
        monkeypatch.setitem(mod._VISION, "ViT-T/16", (16, 128, 2, 2, 24, 32))
        monkeypatch.setitem(mod._TEXT, "ViT-T/16", (77, 300, 32, 4, 2))
    d, w, sd = 128, 32, {}
    v = "visual."
    sd[v + "conv1.weight"] = (d, 3, 16, 16)
    sd[v + "class_embedding"] = (d,)
    sd[v + "positional_embedding"] = (5, d)
    sd[v + "proj"] = (d, 24)
    for n in ("ln_pre", "ln_post"):
        sd[f"{v}{n}.weight"] = sd[f"{v}{n}.bias"] = (d,)

    def blocks(pre, width):
        for i in range(2):
            b = f"{pre}transformer.resblocks.{i}"
            sd[f"{b}.attn.in_proj_weight"], sd[f"{b}.attn.in_proj_bias"] = (3 * width, width), (3 * width,)
            sd[f"{b}.attn.out_proj.weight"], sd[f"{b}.attn.out_proj.bias"] = (width, width), (width,)
            for n in ("ln_1", "ln_2"):
                sd[f"{b}.{n}.weight"] = sd[f"{b}.{n}.bias"] = (width,)
            sd[f"{b}.mlp.c_fc.weight"], sd[f"{b}.mlp.c_fc.bias"] = (4 * width, width), (4 * width,)
            sd[f"{b}.mlp.c_proj.weight"], sd[f"{b}.mlp.c_proj.bias"] = (width, 4 * width), (width,)

    blocks(v, d)
    blocks("", w)
    sd["token_embedding.weight"] = (300, w)
    sd["positional_embedding"] = (77, w)
    sd["ln_final.weight"] = sd["ln_final.bias"] = (w,)
    sd["text_projection"] = (w, 24)
    out = _random(sd, 3)
    out["logit_scale"] = torch.tensor(np.log(50.0), dtype=torch.float32)
    return out


SMALL_MAE = dict(img_size=32, patch_size=8, embed_dim=160, depth=2, num_heads=2,
                 decoder_embed_dim=64, decoder_depth=1, decoder_num_heads=4)


def _mae_ckpt(monkeypatch):
    for mod in (jmae, pmae):
        monkeypatch.setitem(mod.MAE_FACTORIES, "mae_tiny",
                            lambda mod=mod, **kw: mod.MAEConfig(**SMALL_MAE, **kw))
    layout = _shapes(materialize(lambda: pmae.MaskedAutoencoderViT(pmae.MAEConfig(**SMALL_MAE)),
                                 None, "cpu"))
    # the reference's checkpoints hold the fixed sin-cos tables; both drop them
    layout.update(pos_embed=(1, 17, 160), decoder_pos_embed=(1, 17, 64))
    return _random(layout, 4)


SMALL_SAM = dict(img_size=64, patch_size=16, embed_dim=32, depth=2, num_heads=4,
                 window_size=3, global_attn_indexes=(1,), out_chans=8)


def _sam_ckpt(monkeypatch):
    for mod in (jsam, psam):
        monkeypatch.setitem(mod.SAM_FACTORIES, "tiny", lambda mod=mod: mod.SAMConfig(**SMALL_SAM))
    layout = _shapes(materialize(lambda: psam.SAMImageEncoder(psam.SAMConfig(**SMALL_SAM)),
                                 None, "cpu"))
    return {f"image_encoder.{k}": v for k, v in _random(layout, 5).items()}


def _imagebind_ckpt(monkeypatch):
    def small(pkg):
        real = pkg.imagebind_vision_config
        return lambda dtype=None, img_size=224: dataclasses.replace(
            real(dtype=dtype, img_size=28), embed_dim=160, depth=2, num_heads=2)

    for mod in (jib, pib):
        monkeypatch.setattr(mod, "imagebind_vision_config", small(mod))
    d, vp, vt, sd = 160, "modality_preprocessors.vision.", "modality_trunks.vision.", {}
    sd[f"{vp}rgbt_stem.proj.1.weight"] = (d, 3, 2, 14, 14)
    sd[f"{vp}cls_token"] = (1, 1, d)
    sd[f"{vp}pos_embedding_helper.pos_embed"] = (1, 5, d)
    sd[f"{vt}pre_transformer_layer.0.weight"] = sd[f"{vt}pre_transformer_layer.0.bias"] = (d,)
    for i in range(2):
        b = f"{vt}blocks.{i}"
        sd[f"{b}.attn.in_proj_weight"], sd[f"{b}.attn.in_proj_bias"] = (3 * d, d), (3 * d,)
        sd[f"{b}.attn.out_proj.weight"], sd[f"{b}.attn.out_proj.bias"] = (d, d), (d,)
        for n in ("norm_1", "norm_2"):
            sd[f"{b}.{n}.weight"] = sd[f"{b}.{n}.bias"] = (d,)
        sd[f"{b}.mlp.fc1.weight"], sd[f"{b}.mlp.fc1.bias"] = (4 * d, d), (4 * d,)
        sd[f"{b}.mlp.fc2.weight"], sd[f"{b}.mlp.fc2.bias"] = (d, 4 * d), (d,)
    sd["modality_heads.vision.0.weight"] = sd["modality_heads.vision.0.bias"] = (d,)
    sd["modality_heads.vision.2.weight"] = (1024, d)
    return _random(sd, 6)


def _port_lseg_cfg(jcfg, dtype=None):
    bc = jcfg.backbone
    pbc = pvit.ViTConfig(dtype=dtype or torch.float32, **{
        f.name: getattr(bc, f.name) for f in dataclasses.fields(pvit.ViTConfig) if f.name != "dtype"})
    return plseg.LSegConfig(backbone=pbc, hooks=jcfg.hooks, reassemble_dims=jcfg.reassemble_dims,
                            features=jcfg.features, out_dim=jcfg.out_dim, use_bn=jcfg.use_bn)


def _lseg_ckpt(monkeypatch):
    from test_lseg import TorchLSeg, _mini_cfg

    monkeypatch.setattr(jlseg, "lseg_config", lambda dtype=None, img_size=384, **kw: _mini_cfg())
    monkeypatch.setattr(plseg, "lseg_config",
                        lambda dtype=None, img_size=384, **kw: _port_lseg_cfg(_mini_cfg(), dtype))
    torch.manual_seed(0)
    model = TorchLSeg(use_bn=True)
    layout = {k: v for k, v in _shapes(model).items() if not k.endswith("num_batches_tracked")}
    return {"net." + k: v for k, v in _random(layout, 7).items()}


# family: (model_type, checkpoint maker, image [H, W], make_extractor kwargs, atol)
FAMILIES = {
    # stride 4 at 48 x 32: an 11 x 7 grid; layer 9's key facet
    "dino_v1": ("dino_vits8", _dino_v1_ckpt, (48, 32), dict(layer=9, facet="key"), 1e-5),
    "hf_vit": ("hf_vit_base", _hf_vit_ckpt, (48, 32), dict(layer=1, facet="value"), 1e-5),
    "clip": ("clip_ViT-T/16", _clip_ckpt, (48, 32), {}, 1e-5),
    "mae": ("mae_tiny", _mae_ckpt, (32, 32), {}, 1e-5),
    "sam": ("sam_tiny", _sam_ckpt, (64, 64), {}, 1e-5),
    "imagebind": ("imagebind_huge", _imagebind_ckpt, (42, 28), {}, 1e-5),
    "lseg": ("lseg", _lseg_ckpt, (64, 64), {}, 1e-5),
}


def _zero_patch_bias_in_jax(monkeypatch):
    """F15: the JAX package's ImageBind config keeps a patch bias that
    ImageBind's Conv3d stem (and so its checkpoint) lacks; its converted
    tree gets that bias as zeros here so that it loads at all."""
    real = jib.convert_imagebind_vision

    def convert(sd, cfg):
        params = real(sd, cfg)
        k = params["params"]["patch_embed"]["kernel"]
        params["params"]["patch_embed"]["bias"] = np.zeros(k.shape[-1], np.float32)
        return params

    monkeypatch.setattr(jib, "convert_imagebind_vision", convert)


def test_an_imagebind_checkpoint_loads_without_a_patch_bias_f15(monkeypatch, tmp_path):
    """F15: the JAX factory raises on an ImageBind checkpoint (its config
    wants a patch bias); the port's config has none, as the reference."""
    path = tmp_path / "imagebind.pth"
    torch.save(_imagebind_ckpt(monkeypatch), path)
    x = np.zeros((1, 28, 28, 3), np.float32)
    jext = jfactory.make_extractor("imagebind_huge", checkpoint=str(path), dtype=jnp.float32)
    with pytest.raises(Exception, match="bias"):
        jext(jnp.asarray(x))
    ext = port.make_extractor("imagebind_huge", checkpoint=str(path), dtype=torch.float32,
                              device="cpu")
    assert not ext.cfg.patch_bias and tuple(ext(x).shape) == (1, 4, 160)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_make_extractor_from_a_checkpoint_matches_jax(family, monkeypatch, tmp_path):
    """The checkpoint through both packages' loaders and ``convert_*``,
    then both ``make_extractor`` calls on the same images."""
    name, ckpt, (h, w), kw, atol = FAMILIES[family]
    path = tmp_path / f"{family}.pth"
    torch.save(ckpt(monkeypatch), path)
    if family == "imagebind":
        _zero_patch_bias_in_jax(monkeypatch)
    x = np.random.default_rng(8).standard_normal((2, h, w, 3)).astype(np.float32)
    want = np.asarray(jfactory.make_extractor(name, checkpoint=str(path), dtype=jnp.float32,
                                              seed=0, **kw)(jnp.asarray(x)))
    ext = port.make_extractor(name, checkpoint=str(path), dtype=torch.float32, device="cpu", **kw)
    got = ext(x)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    assert tuple(got.shape) == want.shape, (tuple(got.shape), want.shape)
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_make_extractor_of_random_weights_gives_unit_descriptors(family, monkeypatch):
    name, ckpt, (h, w), kw, _ = FAMILIES[family]
    ckpt(monkeypatch)   # the small config
    x = np.random.default_rng(9).standard_normal((1, h, w, 3)).astype(np.float32)
    got = port.make_extractor(name, dtype=torch.float32, device="cpu", seed=1, **kw)(x)
    assert got.dim() == 3 and got.shape[0] == 1 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, atol=1e-5)


def test_an_unknown_family_raises_key_error_as_in_jax():
    with pytest.raises(KeyError):
        jfactory.make_extractor("dinov1_vitb8")
    with pytest.raises(KeyError):
        port.make_extractor("dinov1_vitb8", device="cpu")


def test_make_extractor_takes_stride_in_the_jax_position(monkeypatch):
    """F14: the eighth positional argument is ``stride`` (DINO v1's patch
    stride; DINOv2 ignores it)."""
    _dino_v1_ckpt(monkeypatch)
    ext = port.make_extractor("dino_vits8", 9, "key", None, torch.float32, False, True, 8, 0,
                              device="cpu")
    assert ext.cfg.patch_stride == 8
    x = np.zeros((1, 32, 32, 3), np.float32)
    assert tuple(ext(x).shape) == (1, 16, 48)


@pytest.mark.parametrize("name", ["dino_vits8", "hf_vit_base", "clip_ViT-B/32", "mae_vit_base_patch16",
                                  "sam_vit_b", "imagebind_huge", "lseg"])
def test_every_family_runs_on_the_card_unless_asked(name, monkeypatch):
    """No device named means the card: without one, every family's
    ``make_extractor`` raises before it builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.make_extractor(name)
