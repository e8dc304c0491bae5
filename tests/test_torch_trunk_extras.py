"""The trunk and VLAD leftovers of the port against the JAX package, in
float32 on the CPU: multi-layer capture, ``extract_multilayer``,
``embed_only``, the attention-probability facet, the full forward with the
final norm, HuggingFace naming, the VLAD residual API (F3) and a
reference ``c_centers.pt``.

Weights and inputs come from numpy seeds and go to both packages (the JAX
side through ``convert_dinov2``). Facets and tokens are held to 1e-5
absolute (float32 sums in other orders over a few blocks; the measured
gap is ~1e-6), attention probabilities to 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from oracles import TorchMiniDino

from anyloc_tpu.models import hf_convert as jax_hf
from anyloc_tpu.models.dinov2 import convert_dinov2
from anyloc_tpu.models.extractor import ViTFacetExtractor as JaxExtractor
from anyloc_tpu.models.vit import ViT as JaxViT
from anyloc_tpu.models.vit import ViTConfig as JaxViTConfig
from anyloc_tpu.ops.vlad import VLAD as JaxVLAD
from anyloc_tpu.ops.vlad import vlad_residuals as jax_vlad_residuals

import anyloc_tpu_torch as port
from anyloc_tpu_torch.models import hf_convert as port_hf
from anyloc_tpu_torch.models.dinov2 import build_vit, native_state_dict
from anyloc_tpu_torch.ops.vlad import vlad_residuals as port_vlad_residuals

torch.set_num_threads(2)


def _state_dict(seed, d=64, depth=4, heads=4, swiglu=False, regs=0):
    """A DINOv2-named state dict (final norm included) with numpy-seeded
    values; LayerScale and pos-embed scaled up so that every block and the
    interpolation matter."""
    layout = TorchMiniDino(img_size=56, d=d, depth=depth, heads=heads, swiglu=swiglu).state_dict()
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


def _configs(d=64, depth=4, heads=4, swiglu=False, regs=0):
    kw = dict(img_size=56, patch_size=14, embed_dim=d, depth=depth, num_heads=heads,
              mlp_type="swiglu_fused" if swiglu else "mlp", layerscale_init=1e-5, ln_eps=1e-6,
              num_register_tokens=regs)
    return JaxViTConfig(dtype=jnp.float32, **kw), port.ViTConfig(dtype=torch.float32, **kw)


def _imgs(px, seed=4, b=2):
    return np.random.default_rng(seed).standard_normal((b, px, px, 3)).astype(np.float32)


CASES = [  # swiglu, regs, px
    (False, 0, 56),
    (False, 0, 112),
    (True, 4, 98),
]


@pytest.mark.parametrize("facet", ["query", "key", "value", "token"])
@pytest.mark.parametrize("swiglu,regs,px", CASES)
def test_capture_layers_matches_jax(facet, swiglu, regs, px):
    """One pass capturing layers 0, 1 and 3 (the last one norm1 + qkv only
    for q/k/v) against the JAX trunk's ``capture_layers``, prefix tokens
    included."""
    sd = _state_dict(3, swiglu=swiglu, regs=regs)
    jcfg, pcfg = _configs(swiglu=swiglu, regs=regs)
    imgs = _imgs(px)
    want = JaxViT(jcfg).apply(convert_dinov2(sd, jcfg), jnp.asarray(imgs),
                              capture_layers=(3, 0, 1), capture_facet=facet)
    model = build_vit(pcfg, sd, 4, device="cpu")
    with torch.inference_mode():
        got = model(torch.from_numpy(imgs), capture_layers=(3, 0, 1), capture_facet=facet)
    assert sorted(got) == sorted(want) == [0, 1, 3]
    for layer in got:
        np.testing.assert_allclose(got[layer].numpy(), np.asarray(want[layer]), atol=1e-5)
        # one pass gives what the single-layer capture gives
        with torch.inference_mode():
            single = model(torch.from_numpy(imgs), capture_layer=layer, capture_facet=facet)
        torch.testing.assert_close(got[layer], single, atol=0, rtol=0)


@pytest.mark.parametrize("facet,use_cls", [("value", False), ("key", True), ("token", False)])
def test_extract_multilayer_matches_jax(facet, use_cls):
    sd = _state_dict(5, regs=4)
    jcfg, pcfg = _configs(regs=4)
    imgs = _imgs(70)
    want = JaxExtractor(jcfg, convert_dinov2(sd, jcfg), 3, facet,
                        use_cls=use_cls).extract_multilayer(jnp.asarray(imgs), [1, 3])
    got = port.ViTFacetExtractor(pcfg, sd, 3, facet, use_cls=use_cls,
                                 device="cpu").extract_multilayer(imgs, [1, 3])
    assert sorted(got) == [1, 3]
    for layer in got:
        assert tuple(got[layer].shape) == (2, 25 + use_cls, 64)
        np.testing.assert_allclose(got[layer].numpy(), np.asarray(want[layer]), atol=1e-5)


def test_extract_multilayer_refuses_layers_past_its_trunk():
    sd = _state_dict(5)
    _, pcfg = _configs()
    ext = port.ViTFacetExtractor(pcfg, sd, 1, "value", device="cpu")
    with pytest.raises(ValueError, match="outside"):
        ext.extract_multilayer(_imgs(56), [0, 3])


@pytest.mark.parametrize("swiglu,regs,px", CASES)
def test_embed_only_matches_jax(swiglu, regs, px):
    sd = _state_dict(6, swiglu=swiglu, regs=regs)
    jcfg, pcfg = _configs(swiglu=swiglu, regs=regs)
    imgs = _imgs(px)
    want = JaxViT(jcfg).apply(convert_dinov2(sd, jcfg), jnp.asarray(imgs), embed_only=True)
    with torch.inference_mode():
        got = build_vit(pcfg, sd, 1, device="cpu")(torch.from_numpy(imgs), embed_only=True)
    assert tuple(got.shape) == (2, 1 + regs + (px // 14) ** 2, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("layer", [0, 2])
@pytest.mark.parametrize("swiglu,regs,px", CASES)
def test_attention_probabilities_match_jax(layer, swiglu, regs, px):
    """The "attn" facet (``return_attn_probs``): plain softmax attention of
    block ``layer``, [B, H, N, N] float32, rows summing to 1."""
    sd = _state_dict(7, swiglu=swiglu, regs=regs)
    jcfg, pcfg = _configs(swiglu=swiglu, regs=regs)
    imgs = _imgs(px)
    want = JaxViT(jcfg).apply(convert_dinov2(sd, jcfg), jnp.asarray(imgs), capture_layer=layer,
                              capture_facet="attn")
    with torch.inference_mode():
        got = build_vit(pcfg, sd, layer + 1, device="cpu")(
            torch.from_numpy(imgs), capture_layer=layer, capture_facet="attn")
    n = 1 + regs + (px // 14) ** 2
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 4, n, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    torch.testing.assert_close(got.sum(-1), torch.ones(2, 4, n))


@pytest.mark.parametrize("swiglu,regs,px", CASES)
def test_full_forward_with_the_final_norm_matches_jax(swiglu, regs, px):
    """``capture_layer=None``: every block, then the trunk-final norm; the
    dict's four entries against the JAX trunk's."""
    sd = _state_dict(8, swiglu=swiglu, regs=regs)
    jcfg, pcfg = _configs(swiglu=swiglu, regs=regs)
    imgs = _imgs(px)
    want = JaxViT(jcfg).apply(convert_dinov2(sd, jcfg), jnp.asarray(imgs))
    model = build_vit(pcfg, sd, device="cpu")
    assert len(model.blocks) == 4 and hasattr(model, "norm")
    with torch.inference_mode():
        got = model(torch.from_numpy(imgs))
    assert set(got) == {"tokens", "cls", "prefix", "pre_norm_tokens"}
    for key in got:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5, err_msg=key)


def test_truncated_trunks_build_no_final_norm():
    sd = _state_dict(8)
    _, pcfg = _configs()
    model = build_vit(pcfg, sd, 4, device="cpu")   # n_blocks given: an extractor's trunk
    assert not hasattr(model, "norm")
    with pytest.raises(ValueError, match="whole trunk"):
        model(torch.from_numpy(_imgs(56)))
    with pytest.raises(ValueError, match="either"):
        model(torch.from_numpy(_imgs(56)), capture_layer=1, capture_layers=(1,))


# ---------------------------------------------------------------- HF naming


def _hf_state_dict(family, seed, depth=2, d=16):
    """An HF-layout numpy state dict of ``family`` with seeded values (the
    keys each renamer reads; shapes need only be consistent)."""
    rng = np.random.default_rng(seed)
    keys = {}

    def lin(name, o=d, i=d, bias=True):
        keys[f"{name}.weight"] = (o, i)
        if bias:
            keys[f"{name}.bias"] = (o,)

    def ln(name):
        keys[f"{name}.weight"] = (d,)
        keys[f"{name}.bias"] = (d,)

    if family in ("dinov2", "dino_v1"):
        keys.update({"embeddings.cls_token": (1, 1, d),
                     "embeddings.position_embeddings": (1, 5, d)})
        lin("embeddings.patch_embeddings.projection")
        ln("layernorm")
        for i in range(depth):
            h = f"encoder.layer.{i}"
            for t in ("query", "key", "value"):
                lin(f"{h}.attention.attention.{t}")
            lin(f"{h}.attention.output.dense")
            if family == "dinov2":
                ln(f"{h}.norm1")
                ln(f"{h}.norm2")
                keys[f"{h}.layer_scale1.lambda1"] = (d,)
                keys[f"{h}.layer_scale2.lambda1"] = (d,)
                if i == 0:
                    lin(f"{h}.mlp.fc1", 4 * d)
                    lin(f"{h}.mlp.fc2", d, 4 * d)
                else:   # the giant's SwiGLU naming
                    lin(f"{h}.mlp.weights_in", 2 * d)
                    lin(f"{h}.mlp.weights_out", d, d)
            else:
                ln(f"{h}.layernorm_before")
                ln(f"{h}.layernorm_after")
                lin(f"{h}.intermediate.dense", 4 * d)
                lin(f"{h}.output.dense", d, 4 * d)
        if family == "dinov2":
            keys["embeddings.register_tokens"] = (1, 4, d)
    elif family == "mae":
        keys.update({"vit.embeddings.cls_token": (1, 1, d), "decoder.mask_token": (1, 1, d)})
        lin("vit.embeddings.patch_embeddings.projection")
        for name in ("vit.layernorm", "decoder.decoder_norm"):
            ln(name)
        lin("decoder.decoder_embed")
        lin("decoder.decoder_pred")
        for pre in ("vit.encoder.layer", "decoder.decoder_layers"):
            for i in range(depth):
                h = f"{pre}.{i}"
                ln(f"{h}.layernorm_before")
                ln(f"{h}.layernorm_after")
                for t in ("query", "key", "value"):
                    lin(f"{h}.attention.attention.{t}")
                lin(f"{h}.attention.output.dense")
                lin(f"{h}.intermediate.dense", 4 * d)
                lin(f"{h}.output.dense", d, 4 * d)
    elif family == "clip":
        keys.update({"vision_model.embeddings.class_embedding": (d,),
                     "vision_model.embeddings.patch_embedding.weight": (d, 3, 2, 2),
                     "vision_model.embeddings.position_embedding.weight": (5, d),
                     "visual_projection.weight": (8, d), "text_projection.weight": (8, d),
                     "logit_scale": (),
                     "text_model.embeddings.token_embedding.weight": (11, d),
                     "text_model.embeddings.position_embedding.weight": (7, d)})
        for name in ("vision_model.pre_layrnorm", "vision_model.post_layernorm",
                     "text_model.final_layer_norm"):
            ln(name)
        for pre in ("vision_model.encoder.layers", "text_model.encoder.layers"):
            for i in range(depth):
                h = f"{pre}.{i}"
                ln(f"{h}.layer_norm1")
                ln(f"{h}.layer_norm2")
                for t in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    lin(f"{h}.self_attn.{t}")
                lin(f"{h}.mlp.fc1", 4 * d)
                lin(f"{h}.mlp.fc2", d, 4 * d)
    else:  # sam
        pre = "vision_encoder"
        keys[f"{pre}.pos_embed"] = (1, 2, 2, d)
        lin(f"{pre}.patch_embed.projection")
        for name in ("neck.conv1", "neck.conv2"):
            lin(f"{pre}.{name}", bias=False)
        for name in ("neck.layer_norm1", "neck.layer_norm2"):
            ln(f"{pre}.{name}")
        for i in range(depth):
            h = f"{pre}.layers.{i}"
            ln(f"{h}.layer_norm1")
            ln(f"{h}.layer_norm2")
            lin(f"{h}.attn.qkv", 3 * d)
            lin(f"{h}.attn.proj")
            keys[f"{h}.attn.rel_pos_h"] = (3, 4)
            keys[f"{h}.attn.rel_pos_w"] = (3, 4)
            lin(f"{h}.mlp.lin1", 4 * d)
            lin(f"{h}.mlp.lin2", d, 4 * d)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in sorted(keys.items())}


@pytest.mark.parametrize("prefix", ["", "model."])
@pytest.mark.parametrize("family", ["dinov2", "dino_v1", "mae", "clip", "sam"])
def test_ensure_native_naming_matches_jax(family, prefix):
    sd = {prefix + k: v for k, v in _hf_state_dict(family, 11).items()}
    want = jax_hf.ensure_native_naming(sd, family)
    got = port_hf.ensure_native_naming(sd, family)
    assert want is not sd and set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # a state dict already in the original naming comes back as it is
    assert port_hf.ensure_native_naming(got, family) is got


def test_hf_named_dinov2_checkpoint_loads_and_extracts_like_jax():
    """An HF ``Dinov2Model`` layout of the mini trunk (registers and the
    final norm included) through ``native_state_dict`` gives the same
    facets as the JAX package's ``convert_dinov2`` of the same dict."""
    sd = _state_dict(9, regs=4)
    hf = {"embeddings.cls_token": sd["cls_token"], "embeddings.position_embeddings":
          sd["pos_embed"], "embeddings.register_tokens": sd["register_tokens"],
          "layernorm.weight": sd["norm.weight"], "layernorm.bias": sd["norm.bias"],
          "embeddings.patch_embeddings.projection.weight": sd["patch_embed.proj.weight"],
          "embeddings.patch_embeddings.projection.bias": sd["patch_embed.proj.bias"]}
    for i in range(4):
        h, b = f"encoder.layer.{i}", f"blocks.{i}"
        for t, part in zip(("query", "key", "value"), sd[f"{b}.attn.qkv.weight"].chunk(3)):
            hf[f"{h}.attention.attention.{t}.weight"] = part
        for t, part in zip(("query", "key", "value"), sd[f"{b}.attn.qkv.bias"].chunk(3)):
            hf[f"{h}.attention.attention.{t}.bias"] = part
        for src, dst in (("attn.proj", "attention.output.dense"), ("norm1", "norm1"),
                         ("norm2", "norm2"), ("mlp.fc1", "mlp.fc1"), ("mlp.fc2", "mlp.fc2")):
            hf[f"{h}.{dst}.weight"] = sd[f"{b}.{src}.weight"]
            hf[f"{h}.{dst}.bias"] = sd[f"{b}.{src}.bias"]
        hf[f"{h}.layer_scale1.lambda1"] = sd[f"{b}.ls1.gamma"]
        hf[f"{h}.layer_scale2.lambda1"] = sd[f"{b}.ls2.gamma"]
    native = native_state_dict(hf)
    assert set(native) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(np.asarray(native[k]), sd[k].numpy(), err_msg=k)
    jcfg, pcfg = _configs(regs=4)
    imgs = _imgs(84)
    want = JaxExtractor(jcfg, convert_dinov2(hf, jcfg), 2, "value")(jnp.asarray(imgs))
    got = port.ViTFacetExtractor(pcfg, hf, 2, "value", device="cpu")(imgs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ---------------------------------------------------------------- VLAD leftovers


def _vocab(tmp_path, seed=12, c=6, d=24):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((c, d)).astype(np.float32)
    descs = rng.standard_normal((3, 40, d)).astype(np.float32)
    return centers, descs


@pytest.mark.parametrize("norm_descs", [True, False])
def test_vlad_residuals_match_jax(norm_descs):
    centers, descs = _vocab(None)
    want = jax_vlad_residuals(jnp.asarray(descs), jnp.asarray(centers), norm_descs=norm_descs)
    got = port_vlad_residuals(torch.from_numpy(descs), torch.from_numpy(centers),
                              norm_descs=norm_descs)
    assert tuple(got.shape) == (3, 40, 6, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_generate_res_vec_caches_as_the_jax_package_does(tmp_path):
    """``<id>_r.npz`` written by one package is read by the other, and
    ``can_use_cache_ids(only_residuals=True)`` sees it in both."""
    centers, descs = _vocab(tmp_path)
    np.savez(tmp_path / "c_centers.npz", centers=centers)
    jv, pv = JaxVLAD(6, cache_dir=str(tmp_path)), port.VLAD(6, cache_dir=str(tmp_path))
    jv.fit(None)
    pv.fit(None)
    got = pv.generate_res_vec(descs[0], cache_id="img0")
    assert pv.can_use_cache_ids("img0", only_residuals=True)
    assert jv.can_use_cache_ids("img0", only_residuals=True)
    assert not pv.can_use_cache_ids("img0") and not pv.can_use_cache_ids(["img0", "img1"], True)
    np.testing.assert_allclose(np.asarray(jv.generate_res_vec(descs[0], cache_id="img0")),
                               got.numpy(), atol=0)      # the JAX class reads the port's file
    want = np.asarray(jv.generate_res_vec(descs[1], cache_id="img1"))
    np.testing.assert_array_equal(pv.generate_res_vec(np.zeros_like(descs[1]), "img1").numpy(),
                                  want)                 # the port reads the JAX class's file


def test_generate_multi_res_vec_passes_cache_ids_f3(tmp_path):
    """F3: the JAX package's ``generate_multi_res_vec`` drops ``cache_ids``
    (no ``_r.npz`` is written); the port writes them and reads them back."""
    centers, descs = _vocab(tmp_path)
    ids = ["a", "b", "c"]
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    for d_ in (jdir, pdir):
        d_.mkdir()
        np.savez(d_ / "c_centers.npz", centers=centers)
    jv, pv = JaxVLAD(6, cache_dir=str(jdir)), port.VLAD(6, cache_dir=str(pdir))
    jv.fit(None)
    pv.fit(None)
    want = np.asarray(jv.generate_multi_res_vec(list(descs), cache_ids=ids))
    assert not jv.can_use_cache_ids(ids, only_residuals=True)     # the fault, in the reference
    got = pv.generate_multi_res_vec(list(descs), cache_ids=ids)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert pv.can_use_cache_ids(ids, only_residuals=True)
    again = pv.generate_multi_res_vec([np.zeros_like(x) for x in descs], cache_ids=ids)
    torch.testing.assert_close(again, got, atol=0, rtol=0)         # read, not recomputed


def test_fit_reads_a_reference_c_centers_pt(tmp_path):
    """No ``c_centers.npz``: the vocabulary comes from a ``c_centers.pt``
    written with ``torch.save``, as the JAX package reads it."""
    centers, descs = _vocab(tmp_path)
    torch.save(torch.from_numpy(centers), tmp_path / "c_centers.pt")
    pv = port.VLAD(6, cache_dir=str(tmp_path))
    assert pv.can_use_cache_vlad()
    pv.fit(None)
    np.testing.assert_array_equal(pv.c_centers.numpy(), centers)
    jv = JaxVLAD(6, cache_dir=str(tmp_path))
    jv.fit(None)
    want = np.asarray(jv.generate_multi(descs))
    np.testing.assert_allclose(pv.generate_multi(torch.from_numpy(descs)).numpy(), want,
                               atol=1e-5)
    assert not (tmp_path / "c_centers.npz").exists()
