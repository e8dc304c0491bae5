"""The port's int8 W8A8 trunk (``quant=...``) against the JAX package.

Same numpy-seeded inputs and weights on both sides. The JAX side runs its
Pallas kernels in interpret mode, as tests/test_attn_proj.py does: K3
``fused_mlp_int8`` and K4 ``fused_attn_half_int8`` directly, and the trunk
with ``anyloc_tpu.models.vit._FUSED_MLP_INTERPRET`` /
``_FUSED_ATTN_INTERPRET`` switched on. The port's wrappers get CPU tensors,
so they run their plain PyTorch versions.

Tolerances (float32, stated per test):
* codes of the quantizers equal, except at most 0.1 % off by one (x / scale
  can land on a rounding midpoint differently after f32 reductions in
  another order);
* K3: rms_rel <= 1e-5, max abs <= 1e-3 (measured 7e-8 / 1e-6; the max-abs
  allowance covers one flipped int8 code);
* K4: rms_rel <= 1e-3, max abs <= 1e-2: the attention runs in bf16, and an
  int8 code flips when a bf16 rounding of q, k, v, P or o lands on the
  other side (measured 2.5e-5 / 7.5e-4 at head dim 64);
* trunk: per block (same input on both sides) rms_rel <= 1e-3 and min row
  cosine >= 0.999; free-running facets cosine >= 0.999 (see the trunk test).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import anyloc_tpu.models.vit as jax_vit
from anyloc_tpu.models.dinov2 import convert_dinov2
from anyloc_tpu.models.vit import Block as JaxBlock
from anyloc_tpu.models.vit import ViT as JaxViT
from anyloc_tpu.models.vit import ViTConfig as JaxViTConfig
from anyloc_tpu.ops.pallas.attn_proj import fused_attn_half_int8 as jax_attn_half
from anyloc_tpu.ops.pallas.fused_mlp import fused_mlp_int8 as jax_fused_mlp
from anyloc_tpu.ops import quant as jq

from oracles import TorchMiniDino

import anyloc_tpu_torch as port
from anyloc_tpu_torch.models.dinov2 import build_vit, from_jax_params, init_params
from anyloc_tpu_torch.ops import quant as pq
from anyloc_tpu_torch.ops.kernels import (
    attn_geometry_ok,
    fused_attn_half_int8,
    fused_mlp_int8,
    int8_mlp_geometry_ok,
    launch_counts,
)
from anyloc_tpu_torch.ops.kernels.attn_proj import _pick_int8_head_chunk
from anyloc_tpu_torch.ops.kernels.fused_mlp import _pick_hidden_chunk

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _rms_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(((got - want) ** 2).mean() / (want ** 2).mean()))


def _max_abs(got, want):
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())


def _codes_agree(got, want):
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


# ---------------------------------------------------------------- ops/quant.py

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 96)) * rng.uniform(0.1, 3, (64, 1))).astype(np.float32)
    x[3] = 0.0                                    # an all-zero row: scale 1e-6 / 127
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    jqx, jsx = jq.quantize_rows(jx)
    px = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    pqx, psx = pq.quantize_rows(px)
    assert pqx.dtype == torch.int8 and psx.dtype == torch.float32
    _codes_agree(pqx.numpy(), jqx)
    np.testing.assert_allclose(psx.numpy(), np.asarray(jsx), rtol=1e-6, atol=0)


def test_quantize_weight_cols_matches_jax():
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((96, 40)) * 0.05).astype(np.float32)
    w[:, 7] = 0.0                                 # an all-zero column: scale 1e-9 / 127
    jqw, jsw = jq.quantize_weight_cols(jnp.asarray(w))
    pqw, psw = pq.quantize_weight_cols(torch.from_numpy(w))
    _codes_agree(pqw.numpy(), jqw)
    np.testing.assert_allclose(psw.numpy(), np.asarray(jsw), rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qdense_matches_jax(dtype):
    """Per-row quantize + int8 product + dequantize, rounded to the output
    dtype before the bias (f32: 1e-5; bf16: 2e-2, one bf16 ulp at |y| < 4)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 48)) * 64 ** -0.5).astype(np.float32)
    b = (0.1 * rng.standard_normal(48)).astype(np.float32)
    jw, jsw = jq.quantize_weight_cols(jnp.asarray(w))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = jq.qdense(jnp.asarray(x, jdt), jw, jsw, jnp.asarray(b))
    pdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    got = pq.qdense(torch.from_numpy(x).to(pdt), _t(jw), _t(jsw), torch.from_numpy(b))
    assert got.dtype == pdt and tuple(got.shape) == (2, 9, 48)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2e-2 if dtype == "bfloat16" else 1e-5)


def test_quantize_vit_params_matches_jax_tree():
    """The port's state-dict quantizer gives the codes and scales of the
    JAX tree quantizer, under both naming schemes; min_size and the MLP-only
    modes leave the same Linears in float."""
    sd = _state_dict(3, d=64, depth=2, heads=2, ratio=4.0)
    jcfg = _jax_cfg(64, 2, 2, 4.0, None)
    tree = convert_dinov2(sd, jcfg)
    for mode, min_size in [("int8_full", 1), ("int8_fused", 1), ("int8", 1 << 14)]:
        want = from_jax_params(jq.quantize_vit_params(tree, mode, min_size=min_size))
        got = pq.quantize_vit_params(from_jax_params(tree), mode, min_size=min_size)
        assert set(got) == set(want), mode
        for k in got:
            if k.endswith("weight_q"):
                _codes_agree(got[k].numpy(), want[k].numpy())
            else:
                torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=0, msg=k)
    with pytest.raises(ValueError, match="quant mode"):
        pq.quantize_vit_params(sd, "int4")


# ---------------------------------------------------------------- K3

@pytest.mark.parametrize("mlp_type,hid,hidden_chunk,epilogue,m", [
    ("swiglu_fused", 384, 128, True, 37),     # three chunks, ragged M
    ("swiglu_fused", 344, 128, True, 16),     # 344 = 4 x 86: chunk 86
    ("swiglu_fused", 344, 512, False, 37),    # one whole-width chunk
    ("mlp", 256, 128, True, 37),              # GELU, two chunks
    ("mlp", 256, None, False, 21),            # the TPU rule: chunk 256
])
def test_k3_fused_mlp_matches_pallas(mlp_type, hid, hidden_chunk, epilogue, m):
    rng = np.random.default_rng(31)
    d = 64
    two = 2 if mlp_type == "swiglu_fused" else 1
    x = rng.standard_normal((m, d)).astype(np.float32)
    w12 = (rng.standard_normal((d, two * hid)) * d ** -0.5).astype(np.float32)
    b12 = (0.1 * rng.standard_normal(two * hid)).astype(np.float32)
    w3 = (rng.standard_normal((hid, d)) * hid ** -0.5).astype(np.float32)
    b3 = (0.1 * rng.standard_normal(d)).astype(np.float32)
    ln = ((1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
          (0.1 * rng.standard_normal(d)).astype(np.float32))
    gamma = (0.5 * rng.standard_normal(d)).astype(np.float32)
    w12q, s12 = jq.quantize_weight_cols(jnp.asarray(w12))
    w3q, s3 = jq.quantize_weight_cols(jnp.asarray(w3))
    jkw = dict(mlp_type=mlp_type, hidden_chunk=hidden_chunk or 512, interpret=True)
    pkw = dict(mlp_type=mlp_type, hidden_chunk=hidden_chunk)
    if epilogue:
        jkw.update(ln_params=tuple(map(jnp.asarray, ln)), layerscale=jnp.asarray(gamma),
                   residual=True)
        pkw.update(ln_params=tuple(map(_t, ln)), layerscale=_t(gamma), residual=True)
    want = jax_fused_mlp(jnp.asarray(x), w12q, s12, jnp.asarray(b12), w3q, s3,
                         jnp.asarray(b3), **jkw)
    before = launch_counts()
    got = fused_mlp_int8(_t(x), _t(w12q), _t(s12), _t(b12), _t(w3q), _t(s3), _t(b3), **pkw)
    assert launch_counts() == before  # CPU tensors never launch a kernel
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, d)
    assert _rms_rel(got.numpy(), want) <= 1e-5
    assert _max_abs(got.numpy(), want) <= 1e-3


def test_k3_hidden_chunk_rule_matches_jax():
    """The chunk is the requantization group: the TPU rule is part of the
    function (DINOv2-G: 512; no 128-multiple divides 344)."""
    from anyloc_tpu.ops.pallas.fused_mlp import _pick_hidden_chunk as jax_rule
    from anyloc_tpu.ops.pallas.fused_mlp import int8_mlp_geometry_ok as jax_ok

    for hid in (344, 384, 512, 1024, 1536, 3072, 4096):
        for kind in ("swiglu_fused", "mlp"):
            assert _pick_hidden_chunk(512, hid, kind == "mlp") == jax_rule(512, hid, kind == "mlp")
            assert int8_mlp_geometry_ok(kind, hid) == jax_ok(kind, hid)
    assert _pick_hidden_chunk(512, 4096, False) == 512


# ---------------------------------------------------------------- K4

@pytest.mark.parametrize("b,n,h,hd,hc,with_gamma", [
    (2, 13, 4, 32, 2, True),    # ragged N
    (2, 16, 4, 32, 1, True),
    (2, 37, 2, 64, 1, True),
    (2, 37, 2, 64, 2, False),   # no LayerScale
])
def test_k4_attn_half_matches_pallas(b, n, h, hd, hc, with_gamma):
    rng = np.random.default_rng(41)
    d = h * hd
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    wqkv = (rng.standard_normal((d, 3 * d)) * d ** -0.5).astype(np.float32)
    bqkv = (0.1 * rng.standard_normal(3 * d)).astype(np.float32)
    wp = (rng.standard_normal((d, d)) * d ** -0.5).astype(np.float32)
    bp = (0.1 * rng.standard_normal(d)).astype(np.float32)
    ln = ((1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
          (0.1 * rng.standard_normal(d)).astype(np.float32))
    gamma = (0.5 * rng.standard_normal(d)).astype(np.float32) if with_gamma else None
    wq, sq = jq.quantize_weight_cols(jnp.asarray(wqkv))
    wpq, sp = jq.quantize_weight_cols(jnp.asarray(wp))
    want = jax_attn_half(
        jnp.asarray(x), wq, sq, jnp.asarray(bqkv), wpq, sp, jnp.asarray(bp), num_heads=h,
        ln_params=tuple(map(jnp.asarray, ln)),
        layerscale=None if gamma is None else jnp.asarray(gamma),
        head_chunk=hc, interpret=True)
    before = launch_counts()
    got = fused_attn_half_int8(
        _t(x), _t(wq), _t(sq), _t(bqkv), _t(wpq), _t(sp), _t(bp), num_heads=h,
        ln_params=tuple(map(_t, ln)), layerscale=None if gamma is None else _t(gamma),
        head_chunk=hc)
    assert launch_counts() == before
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, n, d)
    assert _rms_rel(got.numpy(), want) <= 1e-3
    assert _max_abs(got.numpy(), want) <= 1e-2


def test_k4_head_chunk_rule_matches_jax():
    """DINOv2-G (24 heads of 64): 12 heads at N 257, 6 at 485, 2 at 730-1216."""
    from anyloc_tpu.ops.pallas.attn_proj import _pick_int8_head_chunk as jax_rule
    from anyloc_tpu.ops.pallas.attn_proj import int8_attn_geometry_ok as jax_ok

    for n in (17, 257, 485, 730, 1025, 1216):
        for h, hd in ((24, 64), (16, 64), (6, 64), (4, 32), (2, 64), (4, 16)):
            assert _pick_int8_head_chunk(n, h, hd, None) == jax_rule(n, h, hd, None)
            assert attn_geometry_ok(h, hd) == jax_ok(h, hd)
    assert [_pick_int8_head_chunk(n, 24, 64, None) for n in (257, 485, 730)] == [12, 6, 2]


def test_k3_k4_wrappers_refuse_mixed_devices():
    """A tensor off the CPU never takes the plain path silently."""
    x = torch.zeros(1, 4, 64)
    w = torch.zeros(64, 192, dtype=torch.int8)
    wp = torch.zeros(64, 64, dtype=torch.int8)
    s = torch.ones(192)
    with pytest.raises(ValueError, match="CUDA"):
        fused_attn_half_int8(x, w.to("meta"), s, None, wp, s[:64], None, num_heads=1,
                             ln_params=(torch.ones(64), torch.zeros(64)), head_chunk=1)
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp_int8(x.to("meta"), torch.zeros(64, 256, dtype=torch.int8), torch.ones(256),
                       None, torch.zeros(128, 64, dtype=torch.int8), torch.ones(64), None)


# ---------------------------------------------------------------- the trunk

def _state_dict(seed, d, depth, heads, ratio):
    """A DINOv2-named SwiGLU state dict with numpy-seeded values (LayerScale
    0.5 so that every block matters)."""
    layout = TorchMiniDino(img_size=56, d=d, depth=depth, heads=heads, ratio=ratio,
                           swiglu=True).state_dict()
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
        elif k in ("cls_token", "pos_embed"):
            a = 0.5 * rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) * np.prod(shape[1:]) ** -0.5
        sd[k] = torch.from_numpy(a.astype(np.float32))
    return sd


def _jax_cfg(d, depth, heads, ratio, quant):
    return JaxViTConfig(img_size=56, patch_size=14, embed_dim=d, depth=depth, num_heads=heads,
                        mlp_ratio=ratio, mlp_type="swiglu_fused", layerscale_init=1e-5,
                        ln_eps=1e-6, attn_impl="xla", dtype=jnp.float32, quant=quant)


def _trunks(mode, d=128, depth=3, heads=2, ratio=4.0, seed=5):
    """The same quantized weights for both packages: JAX tree ->
    quantize_vit_params(min_size=1) -> from_jax_params."""
    jcfg = _jax_cfg(d, depth, heads, ratio, None)
    qtree = jq.quantize_vit_params(convert_dinov2(_state_dict(seed, d, depth, heads, ratio), jcfg),
                                   mode, min_size=1)
    pcfg = port.ViTConfig(img_size=56, patch_size=14, embed_dim=d, depth=depth, num_heads=heads,
                          mlp_ratio=ratio, mlp_type="swiglu_fused", layerscale_init=1e-5,
                          ln_eps=1e-6, dtype=torch.float32, quant=mode)
    return dataclasses.replace(jcfg, quant=mode), qtree, pcfg, from_jax_params(qtree)


def _facets(mode, px, *, interpret, ratio=4.0, layer=2, heads=2, d=128, monkeypatch=None,
            blockwise=False):
    """Free-running facets of both trunks; with ``blockwise`` also the worst
    (rms_rel, min row cosine) over the blocks and the captured qkv when each
    port block gets the JAX block's input (teacher forcing)."""
    jcfg, qtree, pcfg, sd = _trunks(mode, d=d, heads=heads, ratio=ratio)
    imgs = np.random.default_rng(px).standard_normal((2, px, px, 3)).astype(np.float32)
    if interpret:
        monkeypatch.setattr(jax_vit, "_FUSED_ATTN_INTERPRET", True)
        monkeypatch.setattr(jax_vit, "_FUSED_MLP_INTERPRET", True)
    want = np.asarray(JaxViT(jcfg).apply(qtree, jnp.asarray(imgs), capture_layer=layer,
                                         capture_facet="value"))
    model = build_vit(pcfg, sd, layer + 1, device="cpu")
    got = model(torch.from_numpy(imgs), capture_layer=layer, capture_facet="value").numpy()
    assert got.shape == want.shape == (2, (px // 14) ** 2 + 1, d)
    if not blockwise:
        return got, want
    worst = (0.0, 1.0)
    x = JaxViT(jcfg).apply(qtree, jnp.asarray(imgs), embed_only=True)
    for i in range(layer + 1):
        params = {"params": qtree["params"][f"blocks_{i}"]}
        qkv_only = i == layer
        jout = JaxBlock(jcfg).apply(params, x, qkv_only=qkv_only)
        pout = model.blocks[i](_t(x), qkv_only=qkv_only).numpy()
        worst = (max(worst[0], _rms_rel(pout, jout)), min(worst[1], _cos_rows(pout, jout).min()))
        x = jout
    return got, want, worst


def _cos_rows(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12)


# 224 px: N = 257 -> K4 (head chunk 2) + K3 (mlp_ratio 12: hid 1024, two
# 512-wide chunks); 504 px: N = 1297 > 1216 -> LN + per-row qdense + K2,
# and hid 344 has no 128-multiple chunk -> the per-row MLP composition.
# Each block, given the JAX block's input, agrees to rms_rel <= 1e-3 and
# cosine >= 0.999. Free running, the ~1e-6 differences of the embedding and
# of f32 sums flip a few int8 codes; each flip is a whole quantization step,
# LayerScale 0.5 carries it into the residual stream and attention spreads
# it to every token: the facets stay at cosine >= 0.999 and rms_rel within
# 1e-2 (measured 6.9e-3 at 224 px, 6.2e-3 at 504 px).
@pytest.mark.parametrize("px,ratio", [(224, 12.0), (504, 4.0)])
def test_trunk_int8_full_matches_jax(monkeypatch, px, ratio):
    got, want, (block_rms, block_cos) = _facets(
        "int8_full", px, interpret=True, ratio=ratio, monkeypatch=monkeypatch, blockwise=True)
    assert block_rms <= 1e-3 and block_cos >= 0.999, (block_rms, block_cos)
    assert _cos_rows(got, want).min() >= 0.999
    assert _rms_rel(got, want) <= 1e-2


@pytest.mark.parametrize("mode", ["int8", "int8_mlp", "int8_fused"])
def test_trunk_other_quant_modes_match_jax(monkeypatch, mode):
    """int8: qdense everywhere + K2; int8_mlp: K5 + qdense MLP; int8_fused:
    K5 + K3 (56 px: 17 tokens)."""
    got, want = _facets(mode, 56, interpret=True, ratio=12.0, monkeypatch=monkeypatch)
    assert _cos_rows(got, want).min() >= 0.999
    assert _rms_rel(got, want) <= 1e-3


def test_trunk_int8_full_without_lane_geometry_takes_the_unfused_route(monkeypatch):
    """4 heads of 16: no head chunk is 128 wide, so both packages run LN +
    per-row qdense + attention in every block (the TPU kernel's rule)."""
    assert not attn_geometry_ok(4, 16)
    got, want = _facets("int8_full", 56, interpret=True, ratio=12.0, heads=4, d=64,
                        layer=1, monkeypatch=monkeypatch)
    assert _cos_rows(got, want).min() >= 0.999
    assert _rms_rel(got, want) <= 1e-3


def test_f1_port_tracks_the_jax_per_row_fallback():
    """F1: the JAX trunk's CPU fallback requantizes per full row where the
    kernels (and the port) requantize per (row, chunk); the two stay within
    int8 noise of each other: min facet cosine >= 0.99."""
    got, want = _facets("int8_full", 224, interpret=False, ratio=12.0)
    assert _cos_rows(got, want).min() >= 0.99


def test_from_jax_params_carries_a_quantized_tree():
    """int8 codes cross exactly (transposed to [out, in]), scales as f32;
    build_vit keeps codes, scales, int8 biases, LN and LayerScale in f32
    under a bf16 trunk."""
    jcfg, qtree, pcfg, sd = _trunks("int8_full", d=64, depth=2, heads=2)
    blk = qtree["params"]["blocks_1"]
    for mod, key in ((blk["attn"]["qkv"], "blocks.1.attn.qkv"), (blk["mlp"]["w3"], "blocks.1.mlp.w3")):
        assert sd[f"{key}.weight_q"].dtype == torch.int8
        np.testing.assert_array_equal(sd[f"{key}.weight_q"].numpy(), np.asarray(mod["kernel_q"]).T)
        assert sd[f"{key}.weight_scale"].dtype == torch.float32
        np.testing.assert_array_equal(sd[f"{key}.weight_scale"].numpy(), np.asarray(mod["kernel_scale"]))
    assert not any(k.endswith("attn.qkv.weight") for k in sd)
    model = build_vit(dataclasses.replace(pcfg, dtype=torch.bfloat16), sd, 2, device="cpu")
    b = model.blocks[1]
    assert b.attn.qkv.weight_q.dtype == torch.int8
    for t in (b.attn.qkv.weight_scale, b.attn.qkv.bias, b.mlp.w3.bias, b.norm1.weight,
              b.norm2.bias, b.ls1.gamma, b.ls2.gamma):
        assert t.dtype == torch.float32
    assert model.patch_embed.proj.weight.dtype == model.pos_embed.dtype == torch.bfloat16
    imgs = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 56, 56, 3)).astype(np.float32))
    out = model(imgs, capture_layer=1, capture_facet="value")
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out.float()).all())


def test_random_init_int8_trunk_quantizes_the_float_draws():
    """init_params of a quantized config draws the float trunk's weights
    and quantizes them: its codes are the quantized bf16 trunk's draws."""
    cfg = port.dinov2_config("dinov2_vits14", dtype=torch.float32)
    qcfg = dataclasses.replace(cfg, quant="int8_full")
    f = init_params(cfg, 7, n_blocks=1)
    q = init_params(qcfg, 7, n_blocks=1)
    want_q, want_s = pq.quantize_weight_cols(f["blocks.0.mlp.fc1.weight"].t())
    torch.testing.assert_close(q["blocks.0.mlp.fc1.weight_q"], want_q.t().contiguous(), atol=0, rtol=0)
    torch.testing.assert_close(q["blocks.0.mlp.fc1.weight_scale"], want_s, atol=0, rtol=0)
    ext = port.DinoV2ExtractFeatures("dinov2_vits14", 0, "value", dtype="float32",
                                     quant="int8_full", device="cpu", seed=7)
    out = ext(np.zeros((1, 56, 56, 3), np.uint8))
    assert tuple(out.shape) == (1, 16, 384)
    torch.testing.assert_close(out.norm(dim=-1), torch.ones(1, 16))


# ---------------------------------------------------------------- F5

def test_entry_points_need_a_card_or_a_named_device(monkeypatch):
    """With no device named the port runs on the card; without one it
    raises rather than carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port.ViTConfig(img_size=56, embed_dim=64, depth=1, num_heads=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.ViTFacetExtractor(cfg, None, 0, "value")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.DinoV2ExtractFeatures("dinov2_vits14", 0, "value", quant="int8_full")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.make_extractor("dinov2_vits14", 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.DescriptorEngine("dinov2_vits14", 0, quant="int8_full", transfer_dtype="uint8")
    largs = port.PipelineArgs()
    largs.extractor.model_type, largs.extractor.desc_layer = "dinov2_vits14", 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.run_global_vocab_vlad(largs, dataset=object(), vocab_dataset=object(), verbose=False)
    assert port.ViTFacetExtractor(cfg, None, 0, "value", device="cpu").device.type == "cpu"


def test_unknown_quant_mode_is_refused():
    with pytest.raises(ValueError, match="quant"):
        port.ViTConfig(quant="int4")
