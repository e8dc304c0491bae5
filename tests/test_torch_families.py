"""MAE, SAM, ImageBind's vision trunk and LSeg against the JAX package's,
in float32 on the CPU, weights carried across by ``from_jax_params`` from
the JAX modules' perturbed random trees (the helpers and the tolerance,
atol 1e-5 unless a test states another, are ``tests/test_torch_models.py``'s).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_models import _apply, _close, _imgs, _init, _perturb

from anyloc_tpu.models import imagebind as jib
from anyloc_tpu.models import lseg as jlseg
from anyloc_tpu.models import mae as jmae
from anyloc_tpu.models import sam as jsam

from anyloc_tpu_torch.models import imagebind as pib
from anyloc_tpu_torch.models import lseg as plseg
from anyloc_tpu_torch.models import mae as pmae
from anyloc_tpu_torch.models import sam as psam
from anyloc_tpu_torch.models import vit as pvit
from anyloc_tpu_torch.models.convert import from_jax_params, materialize

torch.set_num_threads(2)


# ------------------------------------------------------------------ MAE

SMALL_MAE = dict(img_size=32, patch_size=8, embed_dim=160, depth=2, num_heads=2,
                 decoder_embed_dim=64, decoder_depth=1, decoder_num_heads=4)   # hd 80


@pytest.fixture(scope="module")
def mae_pair():
    jcfg = jmae.MAEConfig(**SMALL_MAE)
    model = jmae.MaskedAutoencoderViT(jcfg)
    key = jax.random.PRNGKey(0)
    params = _perturb(_init(model, {"params": key, "mask": key}, jnp.zeros((1, 32, 32, 3)),
                            mask_ratio=0.75), 1)
    pcfg = pmae.MAEConfig(**SMALL_MAE)
    port = materialize(lambda: pmae.MaskedAutoencoderViT(pcfg), from_jax_params(params), "cpu")
    return model, params, port


def test_mae_patchify_round_trip(mae_pair):
    model, _, port = mae_pair
    x = _imgs(8, 2, 32, 32)
    patches = port.patchify(torch.from_numpy(x))
    _close(patches, model.patchify(jnp.asarray(x)), atol=0)
    _close(port.unpatchify(patches), x, atol=0)


def test_mae_latent_at_ratio_0_matches_jax(mae_pair):
    model, params, port = mae_pair
    x = _imgs(9, 2, 32, 32)
    loss, pred, mask, latent = _apply(model, params, jnp.asarray(x), mask_ratio=0.0)
    with torch.no_grad():
        got = port(torch.from_numpy(x), 0.0)
    for g, w in zip(got, (loss, pred, mask, latent)):
        _close(g, w)


def test_mae_masked_forward_with_the_jax_noise_matches_jax(mae_pair):
    """The JAX package draws the masking noise with ``jax.random.uniform``;
    the port takes the same noise as ``noise=``."""
    model, params, port = mae_pair
    x = _imgs(10, 2, 32, 32)
    rng = jax.random.PRNGKey(3)
    want = _apply(model, params, jnp.asarray(x), mask_ratio=0.75, rng=rng)
    noise = torch.from_numpy(np.array(jax.random.uniform(rng, (2, 16))))
    with torch.no_grad():
        got = port(torch.from_numpy(x), 0.75, noise=noise)
    assert int(got[2].sum()) == 2 * 12 and tuple(got[3].shape) == (2, 5, 160)
    for g, w in zip(got, want):
        _close(g, w)


def test_mae_encoder_only_equals_the_full_forward(mae_pair):
    """The extractor's model builds no decoder; its latent is the full
    forward's at ratio 0."""
    _, params, port = mae_pair
    enc = materialize(lambda: pmae.MaskedAutoencoderViT(pmae.MAEConfig(**SMALL_MAE),
                                                        encoder_only=True),
                      pmae.encoder_state_dict(from_jax_params(params)), "cpu")
    assert not any(k.startswith("decoder") for k in enc.state_dict())
    x = torch.from_numpy(_imgs(11, 2, 32, 32))
    with torch.no_grad():
        _close(enc.encode(x), port(x, 0.0)[3], atol=0)


# ------------------------------------------------------------------ SAM

SMALL_SAM = dict(img_size=64, patch_size=16, embed_dim=32, depth=2, num_heads=4,
                 window_size=3, global_attn_indexes=(1,), out_chans=8)


@pytest.mark.parametrize("q,k,n", [(4, 4, 7), (3, 5, 9), (4, 4, 5), (2, 2, 7)])
def test_get_rel_pos_matches_jax(q, k, n):
    """Table rows per offset; a table of another length is resized
    linearly (``jax.image.resize``) first."""
    table = np.random.default_rng(12).standard_normal((n, 6)).astype(np.float32)
    _close(psam.get_rel_pos(q, k, torch.from_numpy(table)),
           jsam.get_rel_pos(q, k, jnp.asarray(table)))


@pytest.mark.parametrize("method", ["linear", "cubic"])
@pytest.mark.parametrize("src,dst", [(4, 9), (9, 4), (5, 5), (7, 3)])
def test_jax_resize_matrix_matches_jax_image_resize(method, src, dst):
    x = np.random.default_rng(13).standard_normal((src, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (dst, 3), method=method)
    _close(psam.jax_resize_matrix(src, dst, method) @ x, want)


@pytest.mark.parametrize("hw", [(6, 6), (5, 7)])
def test_sam_windows_match_jax(hw):
    x = np.random.default_rng(14).standard_normal((2, *hw, 4)).astype(np.float32)
    wins, pad = psam.window_partition(torch.from_numpy(x), 3)
    jw, jpad = jsam.window_partition(jnp.asarray(x), 3)
    assert tuple(pad) == tuple(jpad)
    _close(wins, jw, atol=0)
    _close(psam.window_unpartition(wins, 3, pad, hw), x, atol=0)


def test_sam_tokens_and_neck_match_jax():
    jcfg = jsam.SAMConfig(**SMALL_SAM)
    model = jsam.SAMImageEncoder(jcfg)
    x = _imgs(15, 2, 64, 64)
    params = _perturb(_init(model, jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    pcfg = psam.SAMConfig(**SMALL_SAM)
    port = materialize(lambda: psam.SAMImageEncoder(pcfg), psam.from_jax_params_sam(params), "cpu")
    with torch.no_grad():
        toks = port(torch.from_numpy(x), return_tokens=True)
        neck = port(torch.from_numpy(x))
    _close(toks, _apply(model, params, jnp.asarray(x), return_tokens=True))
    _close(neck, _apply(model, params, jnp.asarray(x)), atol=2e-5)   # LayerNorm2d of a 2-D conv
    assert tuple(neck.shape) == (2, 4, 4, 8)


# ------------------------------------------------------------------ ImageBind

def _small_ib_config(pkg):
    """ImageBind's vision config at width 160 (2 heads of 80), 2 blocks;
    with the JAX config's patch bias in both (F15: the JAX random tree
    has one)."""
    real = pkg.imagebind_vision_config
    return lambda dtype=None, img_size=28: dataclasses.replace(
        real(dtype=dtype, img_size=img_size), embed_dim=160, depth=2, num_heads=2,
        patch_bias=True)


def test_imagebind_vision_cls_and_tokens_match_jax(monkeypatch):
    for mod in (jib, pib):
        monkeypatch.setattr(mod, "imagebind_vision_config", _small_ib_config(mod))
    jm = jib.ImageBindVision(None, dtype=jnp.float32, seed=0)
    params = _perturb(jm.params, 3)
    jm.params = params
    port = pib.ImageBindVision(dtype=torch.float32, params=from_jax_params(params),
                               head=pib.from_jax_head(jm.head_ln, jm.head_w), device="cpu")
    x = _imgs(16, 2, 42, 28)
    want = jm(jnp.asarray(x))
    got = port(x)
    for key in ("cls", "tokens"):
        _close(got[key], want[key])
    with pytest.raises(NotImplementedError):
        port(x, modality="audio")


# ------------------------------------------------------------------ LSeg

@pytest.fixture(scope="module")
def lseg_pair():
    from test_lseg import _mini_cfg

    jcfg = _mini_cfg(use_bn=True)
    enc = jlseg.LSegEncoder(jcfg)
    params = _perturb(_init(enc, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))), 4)
    # frozen variances stay positive
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: np.abs(a) + 0.5 if p[-1].key == "var" else a, params)
    bc = dataclasses.replace(jcfg.backbone, dtype=torch.float32)
    pcfg = plseg.LSegConfig(backbone=pvit.ViTConfig(**{
        f.name: getattr(bc, f.name) for f in dataclasses.fields(pvit.ViTConfig)}),
        hooks=jcfg.hooks, reassemble_dims=jcfg.reassemble_dims, features=jcfg.features,
        out_dim=jcfg.out_dim, use_bn=True)
    port = materialize(lambda: plseg.LSegEncoder(pcfg), plseg.from_jax_params_lseg(params), "cpu")
    return enc, params, port


@pytest.mark.parametrize("normalize", [True, False])
def test_lseg_encoder_features_match_jax(lseg_pair, normalize):
    enc, params, port = lseg_pair
    x = _imgs(17, 2, 64, 64)
    with torch.no_grad():
        got = port(torch.from_numpy(x), normalize=normalize)
    want = _apply(enc, params, jnp.asarray(x), normalize=normalize)
    _close(got, want, atol=1e-5 if normalize else 2e-5)   # unnormalized: 3x3 conv sums of ~30


def test_lseg_logits_match_jax():
    rng = np.random.default_rng(18)
    feats = rng.standard_normal((2, 8, 8, 20)).astype(np.float32)
    text = rng.standard_normal((5, 20)).astype(np.float32)
    for up in (True, False):
        _close(plseg.lseg_logits(torch.from_numpy(feats), torch.from_numpy(text), 3.0, up),
               jlseg.lseg_logits(jnp.asarray(feats), jnp.asarray(text), 3.0, up), atol=2e-5)
