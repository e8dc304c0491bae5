"""The port's ViT trunk and its family knobs, and DINO v1, against the JAX
package's, in float32 on the CPU (the JAX side's ``attn_impl="auto"``
takes its plain XLA attention there; the port's wrappers take their
kernels' plain versions). MAE, SAM, ImageBind and LSeg:
``tests/test_torch_families.py``.

Weights cross two ways: the JAX package's parameter trees through
``from_jax_params``, and the same synthetic checkpoint-layout state dict
(numpy seeds) through both packages' ``convert_*`` and ``make_extractor``.
Widths are small; each family keeps its published head dim where a test
says so. Tolerance: atol 1e-5 in float32 unless a test states another
bound and its reason.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anyloc_tpu.models import dino_v1 as jdino
from anyloc_tpu.models import registry as jregistry
from anyloc_tpu.models import vit as jvit
from anyloc_tpu.models.extractor import ViTFacetExtractor as JaxFacetExtractor

from anyloc_tpu_torch.models import dino_v1 as pdino
from anyloc_tpu_torch.models import factory as pfactory
from anyloc_tpu_torch.models import registry as pregistry
from anyloc_tpu_torch.models import vit as pvit
from anyloc_tpu_torch.models.convert import from_jax_params, materialize
from anyloc_tpu_torch.models.dinov2 import build_vit
from anyloc_tpu_torch.models.extractor import ViTFacetExtractor

torch.set_num_threads(2)

F32 = dict(atol=1e-5, rtol=0)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _close(got, want, **kw):
    np.testing.assert_allclose(_np(got), _np(want), **(kw or F32))


def _imgs(seed, b, h, w):
    return np.random.default_rng(seed).standard_normal((b, h, w, 3)).astype(np.float32)


def _perturb(tree, seed):
    """Every leaf of a JAX parameter tree plus numpy noise (0.1 on vectors,
    0.02 on matrices), so that zero initializations (biases, rel-pos
    tables, LayerNorm offsets) matter."""
    rng = np.random.default_rng(seed)

    def noisy(a):
        a = np.asarray(a, np.float32)
        scale = 0.1 if a.ndim <= 1 else 0.02
        return a + scale * rng.standard_normal(a.shape).astype(np.float32)

    return jax.tree_util.tree_map(noisy, jax.device_get(tree))


def _init(module, *args, **kwargs):
    """A Flax module's parameters from a jitted init (the eager init
    dispatches op by op and takes seconds)."""
    return jax.jit(lambda *a: module.init(*a, **kwargs))(*args)


def _apply(module, params, *args, **kwargs):
    """A Flax module's jitted forward (one compile, not one per op)."""
    return jax.jit(lambda p, *a: module.apply(p, *a, **kwargs))(params, *args)


@functools.lru_cache(maxsize=None)
def _pair(family, seed=0):
    """A JAX ``ViTConfig`` of ``TRUNKS[family]`` and the port's with the
    same fields, the JAX trunk's perturbed random parameters and the
    port's state dict of them."""
    jcfg_kw = TRUNKS[family]
    img = jcfg_kw["img_size"]
    jcfg = jvit.ViTConfig(dtype=jnp.float32, **jcfg_kw)
    pcfg = pvit.ViTConfig(dtype=torch.float32, **jcfg_kw)
    params = _init(jvit.ViT(jcfg), jax.random.PRNGKey(seed), jnp.zeros((1, img, img, 3)))
    params = _perturb(params, seed + 1)
    return jcfg, pcfg, params, from_jax_params(params)


# ------------------------------------------------------------------ trunk pieces

@pytest.mark.parametrize("offset", [0.0, 0.1])
@pytest.mark.parametrize("grid", [(7, 4), (3, 6)])
def test_interpolate_pos_embed_matches_jax_on_a_non_native_grid(offset, grid):
    """The scale-factor form (DINOv2, DINO v1: offset 0.1) and the size
    form (CLIP, ImageBind, LSeg, HF ViT: offset 0) against the JAX
    package's torch-exact bicubic matrices."""
    pos = np.random.default_rng(1).standard_normal((1, 1 + 25, 8)).astype(np.float32)
    want = jvit.interpolate_pos_embed(jnp.asarray(pos), grid, 1, offset=offset)
    got = pvit.interpolate_pos_embed(torch.from_numpy(pos), grid, 1, offset=offset)
    assert tuple(got.shape) == (1, 1 + grid[0] * grid[1], 8)
    _close(got, want)


@pytest.mark.parametrize("cls", [True, False])
def test_sincos_2d_pos_embed_matches_jax(cls):
    _close(pvit.sincos_2d_pos_embed(16, 5, cls), jvit.sincos_2d_pos_embed(16, 5, cls), atol=0)


@pytest.mark.parametrize("name", ["quick_gelu", "exact_gelu"])
def test_activations_match_jax(name):
    x = np.linspace(-6, 6, 101).astype(np.float32)
    _close(getattr(pvit, name)(torch.from_numpy(x)), getattr(jvit, name)(jnp.asarray(x)), atol=1e-6)


# each family's trunk knobs at a small width (head dims as stated)
TRUNKS = {
    # DINO v1: overlapping patches, no LayerScale, offset 0.1
    "dino_v1": dict(img_size=32, patch_size=8, patch_stride=4, embed_dim=64, depth=2,
                    num_heads=4, layerscale_init=None),
    # CLIP: norm_pre, quick GELU, no patch bias, proj_out, size-form resize; hd 64
    "clip": dict(img_size=32, patch_size=16, embed_dim=128, depth=2, num_heads=2,
                 act="quick_gelu", layerscale_init=None, ln_eps=1e-5, pre_norm=True,
                 patch_bias=False, proj_dim=24, interpolate_offset=0.0),
    # ImageBind: norm_pre, no final norm; hd 80
    "imagebind": dict(img_size=28, patch_size=14, embed_dim=160, depth=2, num_heads=2,
                      layerscale_init=None, pre_norm=True, final_norm=False,
                      interpolate_offset=0.0),
    # HF ViT: LayerNorm eps 1e-12
    "hf_vit": dict(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4,
                   layerscale_init=None, ln_eps=1e-12, interpolate_offset=0.0),
    # no CLS: the mean token; the fixed sin-cos embedding; no qkv bias; registers
    "no_cls_sincos": dict(img_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=4,
                          use_cls_token=False, pos_embed_type="sincos2d", qkv_bias=False,
                          num_register_tokens=2, interpolate_offset=0.0),
}


@pytest.mark.parametrize("family", sorted(TRUNKS))
def test_trunk_full_forward_matches_jax(family):
    """Every output of the whole trunk on a non-square grid (the position
    embedding resized), weights carried across by ``from_jax_params``."""
    jcfg, pcfg, params, sd = _pair(family)
    x = _imgs(2, 2, 48, 40)
    want = _apply(jvit.ViT(jcfg), params, jnp.asarray(x))
    with torch.no_grad():
        got = build_vit(pcfg, sd, None, device="cpu")(torch.from_numpy(x))
    for key in ("tokens", "cls", "prefix", "pre_norm_tokens"):
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        _close(got[key], want[key])


@pytest.mark.parametrize("facet", ["query", "key", "value", "token"])
def test_facet_extractor_of_a_family_trunk_matches_jax(facet):
    """``ViTFacetExtractor`` over a non-DINOv2 config (CLIP's knobs),
    truncated at layer 1."""
    jcfg, pcfg, params, sd = _pair("clip")
    x = _imgs(3, 2, 48, 32)
    want = JaxFacetExtractor(jcfg, params, 1, facet)(jnp.asarray(x))
    got = ViTFacetExtractor(pcfg, sd, 1, facet, device="cpu")(x)
    _close(got, want)


def test_quant_stays_with_the_dinov2_family():
    with pytest.raises(ValueError, match="dinov2"):
        pfactory.make_extractor("dino_vits8", quant="int8_full", device="cpu")
    with pytest.raises(ValueError, match="int8"):
        pvit.ViTConfig(act="quick_gelu", quant="int8_full")


@pytest.mark.parametrize("knobs", [dict(attn_impl="xla"), dict(attn_impl="pallas"),
                                   dict(attn_pack_pairs=True)])
def test_jax_only_knobs_are_taken_and_change_nothing(knobs):
    """``attn_impl`` and ``attn_pack_pairs`` (JAX routing and TPU tiling)
    are ViTConfig fields in the port too; the port routes by device, so
    the trunk's output stays the JAX one's. Another attn_impl raises."""
    jcfg, pcfg, params, sd = _pair("hf_vit")
    x = _imgs(4, 2, 32, 32)
    want = _apply(jvit.ViT(jcfg), params, jnp.asarray(x))["tokens"]
    pcfg = dataclasses.replace(pcfg, **knobs)
    with torch.no_grad():
        got = build_vit(pcfg, sd, None, device="cpu")(torch.from_numpy(x))["tokens"]
    _close(got, want)
    with pytest.raises(ValueError, match="attn_impl"):
        pvit.ViTConfig(attn_impl="mosaic")


def test_registry_names_match_jax():
    assert pregistry.names() == jregistry.names()
    for name in pregistry.names():
        assert pregistry.get(name).family == jregistry.get(name).family


# ------------------------------------------------------------------ DINO v1

SMALL_DINO = (8, 48, 12, 6)   # patch, width, depth, heads: saliency reads layer 11, heads 0-5


@pytest.fixture
def small_dino(monkeypatch):
    """dino_vits8 at width 48 in both packages, and a timm-layout
    checkpoint state dict from a numpy seed."""
    for mod in (jdino, pdino):
        monkeypatch.setitem(mod._DIMS, "dino_vits8", SMALL_DINO)
    cfg = pdino.dino_v1_config("dino_vits8", stride=4, dtype=torch.float32)
    return _randomized(_layout(materialize(lambda: pvit.ViT(cfg), None, "cpu")), 5)


def _layout(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _randomized(sd, seed):
    """Numpy-seeded values for a layout: norms near 1, everything else
    normal at 1/sqrt(fan in) (0.3 for vectors)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sd.items():
        shape = v.shape
        if k.endswith("weight") and len(shape) == 1:
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif len(shape) >= 2 and not k.endswith(("pos_embed", "cls_token", "rel_pos_h",
                                                  "rel_pos_w", "positional_embedding")):
            a = rng.standard_normal(shape) * np.prod(shape[1:]) ** -0.5
        else:
            a = 0.3 * rng.standard_normal(shape)
        out[k] = a.astype(np.float32)
    return out


def _dino_pair(sd):
    """Both packages' ``ViTExtractor("dino_vits8", stride=4)`` holding the
    checkpoint ``sd`` through their ``convert_dino_v1`` (the JAX one's
    random init skipped)."""
    jext = jdino.ViTExtractor.__new__(jdino.ViTExtractor)
    jext.model_type, jext.cfg = "dino_vits8", jdino.dino_v1_config("dino_vits8", stride=4)
    jext.model, jext.p, jext.num_patches = jvit.ViT(jext.cfg), 8, None
    jext.params = jdino.convert_dino_v1(sd, jext.cfg)
    pext = pdino.ViTExtractor("dino_vits8", stride=4, device="cpu",
                              params=pdino.convert_dino_v1(sd, jext.cfg))
    return jext, pext


@pytest.mark.parametrize("facet", ["key", "query", "value", "token"])
def test_dino_v1_descriptors_match_jax(small_dino, facet):
    """Stride-4 patches at a non-square size (grid 11 x 7), the reference's
    head-minor flatten of q/k/v, through both ``convert_dino_v1``."""
    jext, pext = _dino_pair(small_dino)
    x = _imgs(4, 2, 48, 32)
    want = jext.extract_descriptors(jnp.asarray(x), layer=9, facet=facet)
    got = pext.extract_descriptors(x, layer=9, facet=facet)
    assert tuple(got.shape) == (2, 1, 11 * 7, 48) and pext.num_patches == (11, 7)
    _close(got, want)
    binned = pext.extract_descriptors(x, layer=3, facet=facet, bin=True)
    _close(binned, jext.extract_descriptors(jnp.asarray(x), layer=3, facet=facet, bin=True))


def test_log_bin_matches_jax():
    d = np.random.default_rng(6).standard_normal((2, 5 * 7, 3)).astype(np.float32)
    for h in (1, 2, 3):
        got = pdino.log_bin(torch.from_numpy(d), (5, 7), h)
        assert got.shape[-1] == 3 * (1 + 8 * h)
        _close(got, jdino.log_bin(jnp.asarray(d), (5, 7), h))


def test_dino_v1_saliency_matches_jax(small_dino):
    jext, pext = _dino_pair(small_dino)
    x = _imgs(7, 2, 32, 40)
    _close(pext.extract_saliency_maps(x), jext.extract_saliency_maps(jnp.asarray(x)), atol=1e-5)
