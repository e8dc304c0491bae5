"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``gpu``; every test skips without a CUDA device. This file imports
no JAX, so on a machine with a card (and no JAX) run it without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: bfloat16 2e-2 absolute + 1e-2 relative (kernel and plain
version round to bf16 at the same points; the sums differ in order);
float32 2e-5 absolute (FMA order and the exp implementation).
"""

import numpy as np
import pytest
import torch

from anyloc_tpu_torch.ops.kernels import (
    flash_attention,
    flash_attention_qkv_proj,
    flash_attention_qkv_proj_ref,
    flash_attention_ref,
    vlad_aggregate_fused,
    vlad_aggregate_fused_ref,
)
from anyloc_tpu_torch.ops.kernels.vlad_kernel import hard_label_agreement

pytestmark = pytest.mark.gpu

BF16 = dict(atol=2e-2, rtol=1e-2)
F32 = dict(atol=2e-5, rtol=0)


@pytest.fixture(autouse=True)
def _card():
    """A card, and cuDNN's flags left at PyTorch's defaults: the tests see
    what a user's process runs (F17)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _randn(*shape, dtype=torch.float32, seed=0, scale=1.0):
    g = np.random.default_rng(seed)
    return torch.from_numpy((g.standard_normal(shape) * scale).astype(np.float32)).to("cuda", dtype)


# sequence lengths around the 64-key tiles and the query tiles of 64 rows
# (128 at head dim 128)
ATTN_NS = [1, 63, 64, 65, 77, 127, 128, 129, 130, 257, 485]


@pytest.mark.parametrize("hd", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", ATTN_NS)
def test_flash_attention_kernel_matches_ref(hd, dtype, n):
    q, k, v = (_randn(2, 3, n, hd, dtype=dtype, seed=s) for s in range(3))
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **(BF16 if dtype == torch.bfloat16 else F32))


@pytest.mark.parametrize("scale", [-0.3, 0.0, 2.0])
@pytest.mark.parametrize("n", [77, 130])
def test_flash_attention_kernel_takes_any_scale(scale, n):
    """The bf16 kernel keeps the running max as scale * max(s): a negative
    scale is moved onto q, a zero one gives uniform weights, and the keys
    past N (a tail tile) still add nothing."""
    q, k, v = (_randn(2, 3, n, 64, dtype=torch.bfloat16, seed=s) for s in range(3))
    got = flash_attention(q, k, v, scale=scale)
    want = flash_attention_ref(q, k, v, scale=scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **BF16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_kernel_single_token(dtype):
    q, k, v = (_randn(3, 2, 1, 64, dtype=dtype, seed=s) for s in range(3))
    torch.testing.assert_close(flash_attention(q, k, v).float(), v.float(), atol=0, rtol=0)


@pytest.mark.parametrize("hd", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("n", [1, 65, 129, 300, 485])
def test_flash_attention_kernel_takes_qkv_views(n, hd):
    """Strided column views of a fused [B, N, 3D] tensor (K5's case): the
    kernel's tensor maps read them in place."""
    b, h = 2, 4
    d = h * hd
    qkv = _randn(b, n, 3 * d, dtype=torch.bfloat16)
    views = [qkv[..., i * d:(i + 1) * d].view(b, n, h, hd).transpose(1, 2) for i in range(3)]
    got = flash_attention(*views)
    want = flash_attention_ref(*views)
    torch.testing.assert_close(got.float(), want.float(), **BF16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("epilogue", [True, False, "no_layerscale"])
@pytest.mark.parametrize("n,hd", [(97, 64), (1, 64), (65, 16), (129, 32), (257, 128), (485, 64),
                                  (97, 80), (257, 80), (145, 64), (197, 64), (577, 64)])
def test_qkv_proj_kernel_matches_ref(dtype, epilogue, n, hd):
    """K5: the attention with q pre-scaled and rounded to the input dtype
    (prescale_q) over strided views of qkv, then the projection; the
    epilogue with bias, LayerScale and residual, none of them, or bias and
    residual without LayerScale (every family but DINOv2)."""
    b, h = 3, 4
    d = h * hd
    qkv = _randn(b, n, 3 * d, dtype=dtype, seed=1)
    w = _randn(d, d, dtype=dtype, seed=2, scale=d ** -0.5).t()   # Linear layout
    kw = {}
    if epilogue:
        kw = dict(b_proj=_randn(d, seed=3, scale=0.1), layerscale=_randn(d, seed=4, scale=0.5),
                  residual=_randn(b, n, d, dtype=dtype, seed=5, scale=0.5))
    if epilogue == "no_layerscale":
        kw["layerscale"] = None
    before = flash_attention_qkv_proj.launches
    got = flash_attention_qkv_proj(qkv, w, num_heads=h, **kw)
    assert flash_attention_qkv_proj.launches == before + 1
    want = flash_attention_qkv_proj_ref(qkv, w, num_heads=h, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **(BF16 if dtype == torch.bfloat16 else F32))


@pytest.mark.parametrize("vlad_mode,dist_mode", [
    ("hard", "cosine"), ("hard", "euclidean"), ("soft", "cosine")])
@pytest.mark.parametrize("norm_descs", [True, False])
@pytest.mark.parametrize("intra_norm", [True, False])
def test_vlad_kernel_matches_ref(vlad_mode, dist_mode, norm_descs, intra_norm):
    descs = _randn(3, 333, 192, seed=6)
    centers = _randn(32, 192, seed=7)
    kw = dict(vlad_mode=vlad_mode, dist_mode=dist_mode, norm_descs=norm_descs,
              intra_norm=intra_norm, soft_temp=2.0)
    before = vlad_aggregate_fused.launches
    got = vlad_aggregate_fused(descs, centers, **kw)
    assert vlad_aggregate_fused.launches == before + 1
    want = vlad_aggregate_fused_ref(descs, centers, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **F32)


@pytest.mark.parametrize("c", [1, 5, 64])
def test_vlad_kernel_cluster_counts(c):
    descs = _randn(2, 70, 96, seed=8)
    centers = _randn(c, 96, seed=9)
    for mode in ("hard", "soft"):
        got = vlad_aggregate_fused(descs, centers, vlad_mode=mode)
        want = vlad_aggregate_fused_ref(descs, centers, vlad_mode=mode)
        torch.testing.assert_close(got, want, **F32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_head_dim_80_at_vit_h_width(dtype):
    """MAE-H / ImageBind-H heads (D 1280, 16 heads of 80): K2 on contiguous
    q/k/v and on qkv column views, K5 on qkv."""
    b, n, h, hd = 2, 257, 16, 80
    d = h * hd
    qkv = _randn(b, n, 3 * d, dtype=dtype, seed=10)
    views = [qkv[..., i * d:(i + 1) * d].view(b, n, h, hd).transpose(1, 2) for i in range(3)]
    tol = BF16 if dtype == torch.bfloat16 else F32
    for q, k, v in (views, [t.contiguous() for t in views]):
        torch.testing.assert_close(flash_attention(q, k, v).float(),
                                   flash_attention_ref(q, k, v).float(), **tol)
    w = _randn(d, d, dtype=dtype, seed=11, scale=d ** -0.5).t()
    kw = dict(b_proj=_randn(d, seed=12, scale=0.1), layerscale=_randn(d, seed=13, scale=0.5),
              residual=_randn(b, n, d, dtype=dtype, seed=14, scale=0.5), num_heads=h)
    got = flash_attention_qkv_proj(qkv, w, **kw)
    want = flash_attention_qkv_proj_ref(qkv, w, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("hd", [64, 80])
def test_flash_attention_at_1022_px_within_a_bound_scaled_to_the_output(hd):
    """The 1022-px sequence (5330 tokens): outputs of about sqrt(e/N) ~ 0.02
    sit under BF16's atol, so the bound is scaled to the output, 1e-2 of
    its largest value (one bf16 rounding is at most 2^-7 of a value)."""
    h = 1536 // 64 if hd == 64 else 16
    q, k, v = (_randn(1, h, 5330, hd, dtype=torch.bfloat16, seed=30 + s) for s in range(3))
    got = flash_attention(q, k, v).float()
    want = flash_attention_ref(q, k, v).float()
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-2 * want.abs().max().item()


# K1 at the main path's shapes (224-px and 308-px batches of 32, the 1022-px
# query, which splits its tokens over clusters), D 1536, C 32: a hard label
# sits on a near tie now and then, and the kernel's f32 dots sum in another
# order than the plain version's, so a label may flip there: min per-image
# cosine after the near ties are explained (hard_label_agreement), as
# chip_smoke.py bounds it. The ragged cases below are small enough to hold
# elementwise.
VLAD_MODES = [("hard", "cosine"), ("hard", "euclidean"), ("soft", "cosine")]


def _facets(b, n, d, seed):
    x = _randn(b, n, d, seed=seed)
    return x / x.norm(dim=-1, keepdim=True)


@pytest.mark.parametrize("vlad_mode,dist_mode", VLAD_MODES)
@pytest.mark.parametrize("b,n,d", [(8, 256, 1536), (32, 256, 1536), (32, 484, 1536),
                                   (1, 5329, 1536), (32, 3025, 768), (16, 4, 768)])
def test_vlad_kernel_at_main_path_shapes(vlad_mode, dist_mode, b, n, d):
    """DINOv2-G's 224 / 308 / 1022-px facets, DINO v1 ViT-B/8's 224-px
    key facets at stride 4 and patch-CLIP's crop descriptors."""
    x = _facets(b, n, d, seed=20)
    centers = x.reshape(-1, d)[torch.from_numpy(
        np.random.default_rng(21).choice(b * n, 32, replace=False)).cuda()]
    kw = dict(vlad_mode=vlad_mode, dist_mode=dist_mode)
    got = vlad_aggregate_fused(x, centers, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    if vlad_mode == "hard":
        cos = hard_label_agreement(got, x, centers, dist_mode=dist_mode)[1]
    else:
        cos = torch.nn.functional.cosine_similarity(
            got, vlad_aggregate_fused_ref(x, centers, **kw), dim=-1)
    assert cos.min().item() >= 0.9999


@pytest.mark.parametrize("vlad_mode,dist_mode", VLAD_MODES)
@pytest.mark.parametrize("c", [1, 32, 64])
@pytest.mark.parametrize("b,n", [(3, 77), (1, 1001)])   # ragged tiles; 1001: token splits
def test_vlad_kernel_ragged_and_cluster_counts(vlad_mode, dist_mode, c, b, n):
    descs = _randn(b, n, 1536, seed=22)
    centers = _randn(c, 1536, seed=23)
    kw = dict(vlad_mode=vlad_mode, dist_mode=dist_mode, soft_temp=2.0)
    got = vlad_aggregate_fused(descs, centers, **kw)
    want = vlad_aggregate_fused_ref(descs, centers, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **F32)


@pytest.mark.parametrize("vlad_mode", ["hard", "soft"])
@pytest.mark.parametrize("b,n", [(32, 484), (1, 5329)])
def test_vlad_kernel_is_bit_equal_across_launches(vlad_mode, b, n):
    """Fixed summation orders and no float atomics: two launches agree to
    the bit, the token-split path (1 x 5329) included."""
    x = _facets(b, n, 1536, seed=24)
    centers = _randn(32, 1536, seed=25)
    first = vlad_aggregate_fused(x, centers, vlad_mode=vlad_mode)
    second = vlad_aggregate_fused(x, centers, vlad_mode=vlad_mode)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_kernels_refuse_what_they_do_not_take():
    q = _randn(1, 2, 10, 24)                     # head dim 24
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="contiguous"):
        vlad_aggregate_fused(_randn(2, 10, 16).transpose(0, 1), _randn(4, 16))


# ---------------------------------------------------------------- K3, K4 (int8)
# The kernels repeat their plain versions' arithmetic in the same order, so
# they differ only where an f32 reduction in another order (LayerNorm sums,
# exp) or K4's online softmax (P rounded to bf16 before the division by the
# row sum, where the plain version rounds the normalized P) moves a value
# across an int8 or bf16 rounding boundary. A flipped int8 code is a whole
# quantization step, and a flipped input code moves its whole row: such
# flips are rare and discrete. So the bounds are rms_rel over the output,
# plus an elementwise atol/rtol that at most 0.1 % of the elements may
# exceed.

def _rms_rel(got, want):
    got, want = got.double(), want.double()
    return (((got - want) ** 2).mean() / (want ** 2).mean()).sqrt().item()


def _close_but_rare_flips(got, want, atol, rtol, share=1e-3):
    got, want = got.float(), want.float()
    out = (got - want).abs() > atol + rtol * want.abs()
    assert out.float().mean().item() <= share, (out.sum().item(), out.numel())


def _int8_weights(k, n, seed):
    from anyloc_tpu_torch.ops.quant import quantize_weight_cols

    return quantize_weight_cols(_randn(k, n, seed=seed, scale=k ** -0.5))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mlp_type,hid,chunk,epilogue", [
    ("swiglu_fused", 512, 128, True), ("swiglu_fused", 384, None, False),
    ("mlp", 256, 128, True)])
def test_fused_mlp_int8_kernel_matches_ref(dtype, mlp_type, hid, chunk, epilogue):
    from anyloc_tpu_torch.ops.kernels import fused_mlp_int8, fused_mlp_int8_ref

    m, d = 333, 128
    two = 2 if mlp_type == "swiglu_fused" else 1
    x = _randn(m, d, dtype=dtype, seed=10)
    w12, s12 = _int8_weights(d, two * hid, 11)
    w3, s3 = _int8_weights(hid, d, 12)
    args = (x, w12, s12, _randn(two * hid, seed=13, scale=0.1), w3, s3, _randn(d, seed=14, scale=0.1))
    kw = dict(mlp_type=mlp_type, hidden_chunk=chunk)
    if epilogue:
        kw.update(ln_params=(1 + _randn(d, seed=15, scale=0.1), _randn(d, seed=16, scale=0.1)),
                  layerscale=_randn(d, seed=17, scale=0.5), residual=True)
    before = fused_mlp_int8.launches
    got = fused_mlp_int8(*args, **kw)
    assert fused_mlp_int8.launches == before + 1
    want = fused_mlp_int8_ref(*args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    # bf16 output: one ulp is 2^-8 of the value, so a last-bit f32 difference
    # before the final rounding shows as ~4e-3 on that element
    assert _rms_rel(got, want) <= (1e-2 if dtype == torch.bfloat16 else 1e-3)
    tol = dict(atol=2e-2, rtol=1e-2) if dtype == torch.bfloat16 else dict(atol=1e-3, rtol=1e-4)
    _close_but_rare_flips(got, want, **tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,h,hd,hc,with_gamma", [
    (2, 77, 4, 64, None, True), (3, 130, 4, 32, 2, True), (2, 13, 2, 64, 1, False)])
def test_attn_half_int8_kernel_matches_ref(dtype, b, n, h, hd, hc, with_gamma):
    from anyloc_tpu_torch.ops.kernels import fused_attn_half_int8, fused_attn_half_int8_ref

    d = h * hd
    x = _randn(b, n, d, dtype=dtype, seed=20)
    wqkv, sqkv = _int8_weights(d, 3 * d, 21)
    wp, sp = _int8_weights(d, d, 22)
    args = (x, wqkv, sqkv, _randn(3 * d, seed=23, scale=0.1), wp, sp, _randn(d, seed=24, scale=0.1))
    kw = dict(num_heads=h, head_chunk=hc,
              ln_params=(1 + _randn(d, seed=25, scale=0.1), _randn(d, seed=26, scale=0.1)),
              layerscale=_randn(d, seed=27, scale=0.5) if with_gamma else None)
    before = fused_attn_half_int8.launches
    got = fused_attn_half_int8(*args, **kw)
    assert fused_attn_half_int8.launches == before + 1
    want = fused_attn_half_int8_ref(*args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert _rms_rel(got, want) <= 1e-2
    _close_but_rare_flips(got, want, atol=2e-2, rtol=1e-2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,d,hid,chunk,mlp_type", [
    (333, 96, 160, 32, "swiglu_fused"),     # K group 32; D, HID and M off the tiles
    (200, 128, 320, 64, "swiglu_fused"),    # group 64
    (333, 128, 768, 384, "mlp"),            # group 384 (three 128-byte K tiles)
    (130, 160, 1024, 512, "swiglu_fused"),  # group 512
    (333, 128, 352, 352, "swiglu_fused"),   # one group: the w3 GEMM's one-group instance
])
def test_int8_gemm_groups_match_ref(dtype, m, d, hid, chunk, mlp_type):
    """The int8 GEMM through K3: w12 is a one-group product (SwiGLU's W1 and
    W2 tiles as two TMA boxes, HID not a multiple of the 128-column tile),
    w3 folds one K group per hidden chunk, at 32-byte granularity."""
    from anyloc_tpu_torch.ops.kernels import fused_mlp_int8, fused_mlp_int8_ref

    two = 2 if mlp_type == "swiglu_fused" else 1
    x = _randn(m, d, dtype=dtype, seed=140)
    w12, s12 = _int8_weights(d, two * hid, 141)
    w3, s3 = _int8_weights(hid, d, 142)
    args = (x, w12, s12, _randn(two * hid, seed=143, scale=0.1), w3, s3, _randn(d, seed=144, scale=0.1))
    kw = dict(mlp_type=mlp_type, hidden_chunk=chunk, layerscale=_randn(d, seed=145, scale=0.5),
              residual=True, ln_params=(1 + _randn(d, seed=146, scale=0.1), _randn(d, seed=147, scale=0.1)))
    before = fused_mlp_int8.launches
    got = fused_mlp_int8(*args, **kw)
    assert fused_mlp_int8.launches == before + 1
    want = fused_mlp_int8_ref(*args, **kw)
    torch.cuda.synchronize()
    assert _rms_rel(got, want) <= (1e-2 if dtype == torch.bfloat16 else 1e-3)
    tol = dict(atol=2e-2, rtol=1e-2) if dtype == torch.bfloat16 else dict(atol=1e-3, rtol=1e-4)
    _close_but_rare_flips(got, want, **tol)


def test_int8_trunk_on_the_card_matches_the_cpu():
    """A small int8_full trunk (K4 + K3 at 224 px) on the card against the
    same trunk's plain path on the CPU: facet cosine >= 0.999."""
    import dataclasses

    from anyloc_tpu_torch import ViTConfig, ViTFacetExtractor
    from anyloc_tpu_torch.ops.kernels import fused_attn_half_int8, fused_mlp_int8

    cfg = ViTConfig(img_size=56, embed_dim=128, depth=2, num_heads=2, mlp_type="swiglu_fused",
                    mlp_ratio=12.0, dtype=torch.float32, quant="int8_full")
    cpu = ViTFacetExtractor(cfg, None, 1, "token", device="cpu", seed=3)
    sd = {k: (torch.full_like(v, 0.5) if k.endswith("gamma") else v)
          for k, v in cpu.model.state_dict().items()}
    cpu = ViTFacetExtractor(cfg, sd, 1, "token", device="cpu")
    gpu = ViTFacetExtractor(dataclasses.replace(cfg), sd, 1, "token", device="cuda")
    imgs = np.random.default_rng(1).standard_normal((2, 224, 224, 3)).astype(np.float32)
    k3, k4 = fused_mlp_int8.launches, fused_attn_half_int8.launches
    got = gpu(imgs).cpu()
    assert fused_mlp_int8.launches == k3 + 2 and fused_attn_half_int8.launches == k4 + 2
    want = cpu(imgs)
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1).min().item()
    assert cos >= 0.999, cos


# ---------------------------------------------------------------- K6-K9 (block variants)
# K6, K7 and K8 round at the same points as their plain versions (bf16: one
# ulp where f32 sums in another order cross a rounding boundary; K7 also
# rounds the unnormalized P, as K5 does); K9 is K4 then K3 with x2 in f32,
# so it takes their bounds.

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [77, 130])
def test_attention_proj_kernel_matches_ref(dtype, n):
    from anyloc_tpu_torch.ops.kernels import attention_proj, attention_proj_ref

    b, h, hd = 2, 4, 64
    qkv = _randn(b, n, 3 * h * hd, dtype=dtype, seed=30)
    q, k, v = (qkv[..., i * h * hd:(i + 1) * h * hd].view(b, n, h, hd).transpose(1, 2)
               for i in range(3))                       # strided views
    w = _randn(h * hd, 192, dtype=dtype, seed=31, scale=(h * hd) ** -0.5)
    before = attention_proj.launches
    got = attention_proj(q, k, v, w)
    assert attention_proj.launches == before + 1
    want = attention_proj_ref(q, k, v, w)
    torch.cuda.synchronize()
    assert got.dtype == dtype and tuple(got.shape) == (b, n, 192)
    torch.testing.assert_close(got.float(), want.float(), **(BF16 if dtype == torch.bfloat16 else F32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,with_bias", [(2, 77, True), (3, 130, False)])
def test_attn_half_bf16_kernel_matches_ref(dtype, b, n, with_bias):
    from anyloc_tpu_torch.ops.kernels import fused_attn_half_bf16, fused_attn_half_bf16_ref

    h, hd = 4, 64
    d = h * hd
    x = _randn(b, n, d, dtype=dtype, seed=40)
    wqkv = _randn(d, 3 * d, dtype=dtype, seed=41, scale=d ** -0.5)
    wp = _randn(d, d, dtype=dtype, seed=42, scale=d ** -0.5).t().contiguous().t()  # Linear .t()
    bq = _randn(3 * d, seed=43, scale=0.1) if with_bias else None
    bp = _randn(d, seed=44, scale=0.1) if with_bias else None
    kw = dict(num_heads=h, ln_params=(1 + _randn(d, seed=45, scale=0.1), _randn(d, seed=46, scale=0.1)),
              layerscale=_randn(d, seed=47, scale=0.5))
    before = fused_attn_half_bf16.launches
    got = fused_attn_half_bf16(x, wqkv, bq, wp, bp, **kw)
    assert fused_attn_half_bf16.launches == before + 1
    want = fused_attn_half_bf16_ref(x, wqkv, bq, wp, bp, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **(BF16 if dtype == torch.bfloat16 else F32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mlp_type,hid,with_ln", [
    ("swiglu_fused", 384, True), ("swiglu_fused", 256, False), ("mlp", 512, True)])
def test_fused_mlp_bf16_kernel_matches_ref(dtype, mlp_type, hid, with_ln):
    from anyloc_tpu_torch.ops.kernels import fused_mlp_bf16, fused_mlp_bf16_ref

    m, d = 333, 128
    two = 2 if mlp_type == "swiglu_fused" else 1
    x = _randn(m, d, dtype=dtype, seed=50)
    w12 = _randn(d, two * hid, dtype=dtype, seed=51, scale=d ** -0.5)
    w3 = _randn(hid, d, dtype=dtype, seed=52, scale=hid ** -0.5)
    args = (x, w12, _randn(two * hid, seed=53, scale=0.1), w3, _randn(d, seed=54, scale=0.1))
    kw = dict(mlp_type=mlp_type, layerscale=_randn(d, seed=55, scale=0.5), residual=with_ln)
    if with_ln:
        kw["ln_params"] = (1 + _randn(d, seed=56, scale=0.1), _randn(d, seed=57, scale=0.1))
    before = fused_mlp_bf16.launches
    got = fused_mlp_bf16(*args, **kw)
    assert fused_mlp_bf16.launches == before + 1
    want = fused_mlp_bf16_ref(*args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    # f32: FMA order over K = 384-1024 terms of O(1) products
    tol = BF16 if dtype == torch.bfloat16 else dict(atol=5e-5, rtol=1e-5)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mlp_type,hid,hc,mc", [
    ("swiglu_fused", 512, None, None), ("swiglu_fused", 384, 2, 128), ("mlp", 256, 4, 256)])
def test_fused_block_int8_kernel_matches_ref(dtype, mlp_type, hid, hc, mc):
    from anyloc_tpu_torch.ops.kernels import fused_block_int8, fused_block_int8_ref

    b, n, h, hd = 2, 77, 4, 64
    d = h * hd
    two = 2 if mlp_type == "swiglu_fused" else 1
    x = _randn(b, n, d, dtype=dtype, seed=60)
    wqkv, sqkv = _int8_weights(d, 3 * d, 61)
    wp, sp = _int8_weights(d, d, 62)
    w12, s12 = _int8_weights(d, two * hid, 63)
    w3, s3 = _int8_weights(hid, d, 64)
    attn_p = (wqkv, sqkv, _randn(3 * d, seed=65, scale=0.1), wp, sp, _randn(d, seed=66, scale=0.1))
    mlp_p = (w12, s12, _randn(two * hid, seed=67, scale=0.1), w3, s3, _randn(d, seed=68, scale=0.1))
    kw = dict(num_heads=h, mlp_type=mlp_type, head_chunk=hc, hidden_chunk=mc,
              ln1=(1 + _randn(d, seed=69, scale=0.1), _randn(d, seed=70, scale=0.1)),
              ln2=(1 + _randn(d, seed=71, scale=0.1), _randn(d, seed=72, scale=0.1)),
              gamma1=_randn(d, seed=73, scale=0.5), gamma2=_randn(d, seed=74, scale=0.5))
    before = fused_block_int8.launches
    got = fused_block_int8(x, attn_p, mlp_p, **kw)
    assert fused_block_int8.launches == before + 1
    want = fused_block_int8_ref(x, attn_p, mlp_p, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert _rms_rel(got, want) <= 1e-2
    _close_but_rare_flips(got, want, atol=2e-2, rtol=1e-2)


@pytest.mark.parametrize("n,hc", [(77, None), (257, 2)])
def test_fused_block_int8_kernel_keeps_x2_in_f32(n, hc):
    """The kernel's x2 for a bf16 x is the plain version's f32 x2 (K4's
    bound), not bf16 values: the output alone cannot show that."""
    from anyloc_tpu_torch.ops.kernels import fused_block_int8, fused_block_int8_ref

    b, h, hd, hid = 2, 4, 64, 512
    d = h * hd
    wqkv, sqkv = _int8_weights(d, 3 * d, 81)
    wp, sp = _int8_weights(d, d, 82)
    w12, s12 = _int8_weights(d, 2 * hid, 83)
    w3, s3 = _int8_weights(hid, d, 84)
    attn_p = (wqkv, sqkv, _randn(3 * d, seed=85, scale=0.1), wp, sp, _randn(d, seed=86, scale=0.1))
    mlp_p = (w12, s12, _randn(2 * hid, seed=87, scale=0.1), w3, s3, None)
    kw = dict(num_heads=h, head_chunk=hc,
              ln1=(1 + _randn(d, seed=88, scale=0.1), _randn(d, seed=89, scale=0.1)),
              ln2=(1 + _randn(d, seed=90, scale=0.1), _randn(d, seed=91, scale=0.1)),
              gamma1=_randn(d, seed=92, scale=0.5))
    x = _randn(b, n, d, dtype=torch.bfloat16, seed=80)
    _, x2 = fused_block_int8(x, attn_p, mlp_p, return_x2=True, **kw)
    _, x2_want = fused_block_int8_ref(x, attn_p, mlp_p, return_x2=True, **kw)
    torch.cuda.synchronize()
    assert x2.dtype == torch.float32 and tuple(x2.shape) == (b, n, d)
    assert (x2 == x2.to(torch.bfloat16).float()).float().mean().item() <= 1e-2
    assert _rms_rel(x2, x2_want) <= 1e-2
    _close_but_rare_flips(x2, x2_want, atol=2e-2, rtol=1e-2)


def test_block_variant_wrappers_refuse_what_they_do_not_take():
    from anyloc_tpu_torch.ops.kernels import attention_proj, fused_attn_half_bf16, fused_mlp_bf16

    q = _randn(1, 2, 10, 64, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="dtype"):
        attention_proj(q, q, q, _randn(128, 128))                  # f32 weight, bf16 q
    x = _randn(1, 10, 96)                                          # 2 heads of 48: no lane-valid chunk
    with pytest.raises(ValueError, match="head"):
        fused_attn_half_bf16(x, _randn(96, 288), None, _randn(96, 96), None, num_heads=2,
                             ln_params=(_randn(96), _randn(96)))
    with pytest.raises(ValueError, match="hidden chunk"):              # SwiGLU 344: no 128-multiple chunk
        fused_mlp_bf16(_randn(4, 64), _randn(64, 688), None, _randn(344, 64), None)


# ---------------------------------------------------------------- T1-T3 (the micro-benchmarks' kernels)
# T1 on int8 operands and T2 repeat their plain versions' arithmetic (exact
# int32 sums; then the same f32 conversion and products, one rounding), so
# T1 is bit-exact and T2 within one ulp of its output dtype; T1 on float
# operands sums exact products in f32 in another order. One ulp of a value
# is at most 2^-7 of it in bf16 (2^-22 in f32). T3 is K4 without
# biases: K4's bound, and its base variant bit-equal to the K4 kernel.

def _int8_operands(m, k, n, seed, big_sums=False):
    """Uniform codes, or with ``big_sums`` codes of magnitude 100..127 with
    one sign per row of a and per column of b, so that every sum passes
    2^24 at K 4096 (where f32 values lie 4 apart)."""
    g = np.random.default_rng(seed)
    if big_sums:
        a = g.integers(100, 128, (m, k)) * g.choice([-1, 1], (m, 1))
        b = g.integers(100, 128, (n, k)) * g.choice([-1, 1], (n, 1))
    else:
        a, b = g.integers(-127, 128, (m, k)), g.integers(-127, 128, (n, k))
    a = torch.from_numpy(a.astype(np.int8)).cuda()
    return a, torch.from_numpy(b.astype(np.int8)).cuda().t()          # Linear .t()


@pytest.mark.parametrize("m,k,n,big_sums", [(200, 160, 1000, False), (512, 1536, 384, False),
                                            (256, 4096, 512, True)])
@pytest.mark.parametrize("out_dtype", [None, torch.float32, torch.bfloat16])
def test_matmul_int8_kernel_is_exact(m, k, n, big_sums, out_dtype):
    from anyloc_tpu_torch.ops.kernels import matmul, matmul_ref

    a, b = _int8_operands(m, k, n, 100, big_sums)
    before = matmul.launches
    got = matmul(a, b, out_dtype=out_dtype)
    assert matmul.launches == before + 1
    want = matmul_ref(a, b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == (out_dtype or torch.int32)
    assert torch.equal(got, want)
    if big_sums:   # most sums are no f32 value: a fold through f32 would round them
        exact = matmul_ref(a, b).double()
        assert exact.abs().min().item() > 2 ** 24
        assert (exact.float().double() != exact).double().mean().item() > 0.5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("out_dtype", [None, torch.bfloat16])
def test_matmul_float_kernel_matches_ref(dtype, out_dtype):
    from anyloc_tpu_torch.ops.kernels import matmul, matmul_ref

    m, k, n = 200, 160, 1000                     # ragged against the 128 and 64 tiles
    a = _randn(m, k, dtype=dtype, seed=101)
    b = _randn(n, k, dtype=dtype, seed=102).t()
    got = matmul(a, b, out_dtype=out_dtype)
    want = matmul_ref(a, b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == (out_dtype or torch.float32)
    if out_dtype is None:   # f32 sums of exact products over K 160 in another order
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
    else:                   # one bf16 ulp where such a sum sits on a rounding boundary
        assert ((got.float() - want.float()).abs() <= 2.0 ** -7 * want.float().abs()).all()


@pytest.mark.parametrize("out_dtype,ulp", [(torch.bfloat16, 2.0 ** -7), (torch.float32, 2.0 ** -22)])
def test_matmul_dequant_kernel_matches_ref(out_dtype, ulp):
    from anyloc_tpu_torch.ops.kernels import matmul_dequant, matmul_dequant_ref

    m, k, n = 200, 1536, 1000
    a, b = _int8_operands(m, k, n, 103)
    sa = _randn(m, 1, seed=104).abs() * 0.01 + 1e-3
    sb = _randn(1, n, seed=105).abs() * 0.01 + 1e-3
    before = matmul_dequant.launches
    got = matmul_dequant(a, b, sa, sb, out_dtype=out_dtype)
    assert matmul_dequant.launches == before + 1
    want = matmul_dequant_ref(a, b, sa, sb, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype
    assert ((got.float() - want.float()).abs() <= ulp * want.float().abs()).all()
    assert torch.equal(got, want)   # the same f32 products in the same order: bit-exact


def test_matmul_refuses_what_it_does_not_take():
    from anyloc_tpu_torch.ops.kernels import matmul

    a, b = _int8_operands(64, 48, 64, 106)         # K % 32 != 0
    with pytest.raises(ValueError, match="K % 32"):
        matmul(a, b)
    a, b = _int8_operands(64, 64, 63, 107)         # odd N
    with pytest.raises(ValueError, match="even"):
        matmul(a, b)
    with pytest.raises(TypeError, match="share"):
        matmul(_randn(64, 64, dtype=torch.bfloat16), _randn(64, 64))


def _variant_args(b, n, d, dtype, seed):
    g = np.random.default_rng(seed)
    np_pad = -(-n // 8) * 8
    wqkv, sqkv = _int8_weights(d, 3 * d, seed + 1)
    wp, sp = _int8_weights(d, d, seed + 2)
    xq_in = torch.from_numpy(g.integers(-127, 128, (b, np_pad, d), dtype=np.int8)).cuda()
    xs_in = _randn(b, np_pad, 1, seed=seed + 3).abs() * 0.01 + 1e-3
    ln = (1 + _randn(1, d, seed=seed + 4, scale=0.1), _randn(1, d, seed=seed + 5, scale=0.1))
    return (_randn(b, n, d, dtype=dtype, seed=seed), xq_in, xs_in, wqkv, sqkv, wp, sp, ln,
            _randn(1, d, seed=seed + 6, scale=0.5))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pre_quant,batched_dots", [(False, False), (True, False), (False, True)])
@pytest.mark.parametrize("n", [77, 300])
def test_attn_half_variant_kernel_matches_ref(dtype, pre_quant, batched_dots, n):
    """Besides K4's bound on the output, the heads' outputs o: at K4's bound
    of the plain version's o, f32 values (not bf16 ones) with batched_dots,
    and the output far nearer the stages after the attention applied to the
    kernel's own o than to them applied to that o rounded to bf16 (the
    output's bound alone cannot tell the two apart)."""
    from anyloc_tpu_torch.ops.kernels import (
        attn_half_variant, attn_half_variant_proj_ref, attn_half_variant_ref)

    args = _variant_args(2, n, 256, dtype, 110)    # 4 heads of 64, ragged N (pads to 80, 304):
    # pre_quant's A rows are gathered (A_MAP) from images of padded rows
    kw = dict(pre_quant=pre_quant, batched_dots=batched_dots)
    before = attn_half_variant.launches
    got, o = attn_half_variant(*args, return_o=True, **kw)
    assert attn_half_variant.launches == before + 1
    want, o_want = attn_half_variant_ref(*args, return_o=True, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert _rms_rel(got, want) <= 1e-2
    _close_but_rare_flips(got, want, atol=2e-2, rtol=1e-2)
    assert _rms_rel(o, o_want) <= 1e-2
    _close_but_rare_flips(o, o_want, atol=2e-2, rtol=1e-2)
    bf16_share = (o == o.to(torch.bfloat16).float()).float().mean().item()
    assert bf16_share <= 1e-2 if batched_dots else bf16_share == 1.0
    if batched_dots:
        x, wp, sp, gamma = args[0], args[5], args[6], args[8]
        own = _rms_rel(got, attn_half_variant_proj_ref(x, o, wp, sp, gamma))
        rounded = _rms_rel(got, attn_half_variant_proj_ref(x, o.to(torch.bfloat16).float(), wp,
                                                           sp, gamma))
        assert own <= 0.5 * rounded, (own, rounded)


@pytest.mark.parametrize("n", [77, 1000])         # head chunks 4 (one) and 2 (two)
def test_attn_half_variant_base_is_k4_bit_for_bit(n):
    from anyloc_tpu_torch.ops.kernels import attn_half_variant, fused_attn_half_int8

    x, xq_in, xs_in, wqkv, sqkv, wp, sp, ln, gamma = _variant_args(1, n, 256, torch.bfloat16, 120)
    got = attn_half_variant(x, None, None, wqkv, sqkv, wp, sp, ln, gamma, pre_quant=False,
                            batched_dots=False)
    want = fused_attn_half_int8(x, wqkv, sqkv, None, wp, sp, None, num_heads=4,
                                ln_params=(ln[0].ravel(), ln[1].ravel()), layerscale=gamma.ravel())
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# ---------------------------------------------------------------- the bf16 GEMM
# csrc/bf16_gemm.cuh's bf16 operands run the TMA GEMM: 128 x 256 output
# tiles, stages of 64 K elements, ragged K left to TMA's zero fill. So the
# edges are M around the 128-row tile, N around the 256-column tile and K
# off the 64-element stage; M 4100 by N 1536 is 198 tiles, more than one
# wave on 132 SMs.

@pytest.mark.parametrize("out_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("k", [8, 136, 1536, 4096])
@pytest.mark.parametrize("n", [2, 254, 258, 1536])
@pytest.mark.parametrize("m", [1, 127, 129, 4100])
def test_bf16_gemm_edges_through_matmul(m, n, k, out_dtype):
    """T1 on bf16 operands. The values are small integers (|x| <= 4), so
    every product and every partial sum (at most 4096 * 16) is exact in
    f32 and any order of summation gives the same sums: T1's bounds (f32
    sums atol 1e-4 rtol 1e-5, one bf16 ulp for a bf16 output) hold at every
    K here, where sums of random normals over K 4096 differ by more in
    another order."""
    from anyloc_tpu_torch.ops.kernels import matmul, matmul_ref

    g = np.random.default_rng(200 + m + n + k)
    a = torch.from_numpy(g.integers(-4, 5, (m, k)).astype(np.float32)).to("cuda", torch.bfloat16)
    b = torch.from_numpy(g.integers(-4, 5, (n, k)).astype(np.float32)).to("cuda", torch.bfloat16).t()
    tiles = dict(bm=m, bn=n)   # TPU tiles of the whole output (F8 refuses bn 1024 at N 1536)
    before = matmul.launches
    got = matmul(a, b, out_dtype=out_dtype, **tiles)
    assert matmul.launches == before + 1
    want = matmul_ref(a, b, out_dtype=out_dtype, **tiles)
    torch.cuda.synchronize()
    assert got.dtype == (out_dtype or torch.float32) and tuple(got.shape) == (m, n)
    if out_dtype is None:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
    else:
        assert ((got.float() - want.float()).abs() <= 2.0 ** -7 * want.float().abs()).all()


def _k5_case(residual, bias, gamma):
    """K5's projection (EPI_RESID) with and without bias / LayerScale /
    residual: 3 images of 111 tokens (333 rows), 4 heads of 64 -> 264
    output columns (a whole 256-column tile and a ragged one)."""
    from anyloc_tpu_torch.ops.kernels import flash_attention_qkv_proj, flash_attention_qkv_proj_ref

    b, n, h, d, d_out = 3, 111, 4, 256, 264
    qkv = _randn(b, n, 3 * d, dtype=torch.bfloat16, seed=210)
    w = _randn(d_out, d, dtype=torch.bfloat16, seed=211, scale=d ** -0.5).t()   # Linear layout
    kw = dict(num_heads=h,
              b_proj=_randn(d_out, seed=212, scale=0.1) if bias else None,
              layerscale=_randn(d_out, seed=213, scale=0.5) if gamma else None,
              residual=_randn(b, n, d_out, dtype=torch.bfloat16, seed=214) if residual else None)
    return flash_attention_qkv_proj, flash_attention_qkv_proj_ref, (qkv, w), kw


def _k7_case(bias):
    """K7's qkv product (EPI_QKV): 6 heads of 64, so q_cols = 384 ends half
    way through the second 256-column tile, and N = 1152 is 4.5 tiles."""
    from anyloc_tpu_torch.ops.kernels import fused_attn_half_bf16, fused_attn_half_bf16_ref

    b, n, h, d = 3, 111, 6, 384
    args = (_randn(b, n, d, dtype=torch.bfloat16, seed=220),
            _randn(d, 3 * d, dtype=torch.bfloat16, seed=221, scale=d ** -0.5),
            _randn(3 * d, seed=222, scale=0.1) if bias else None,
            _randn(d, d, dtype=torch.bfloat16, seed=223, scale=d ** -0.5),
            _randn(d, seed=224, scale=0.1) if bias else None)
    kw = dict(num_heads=h, ln_params=(1 + _randn(d, seed=225, scale=0.1), _randn(d, seed=226, scale=0.1)),
              layerscale=_randn(d, seed=227, scale=0.5))
    return fused_attn_half_bf16, fused_attn_half_bf16_ref, args, kw


def _k8_case(mlp_type, hid, epilogue):
    """K8's w12 product (EPI_SWIGLU: W1 and W2 as two 128-row boxes; or
    EPI_GELU) and its w3 product (EPI_RESID, with or without b3, LayerScale
    and residual), at 333 rows and D 200 (off the 256-column tile)."""
    from anyloc_tpu_torch.ops.kernels import fused_mlp_bf16, fused_mlp_bf16_ref

    m, d = 333, 200
    two = 2 if mlp_type == "swiglu_fused" else 1
    args = (_randn(m, d, dtype=torch.bfloat16, seed=230),
            _randn(d, two * hid, dtype=torch.bfloat16, seed=231, scale=d ** -0.5),
            _randn(two * hid, seed=232, scale=0.1) if epilogue else None,
            _randn(hid, d, dtype=torch.bfloat16, seed=233, scale=hid ** -0.5),
            _randn(d, seed=234, scale=0.1) if epilogue else None)
    kw = dict(mlp_type=mlp_type, residual=epilogue,
              ln_params=(1 + _randn(d, seed=235, scale=0.1), _randn(d, seed=236, scale=0.1)),
              layerscale=_randn(d, seed=237, scale=0.5) if epilogue else None)
    return fused_mlp_bf16, fused_mlp_bf16_ref, args, kw


BF16_GEMM_EPILOGUES = {
    "resid-bias-gamma-residual": lambda: _k5_case(True, True, True),
    "resid-none": lambda: _k5_case(False, False, False),
    "resid-bias": lambda: _k5_case(False, True, False),
    "resid-gamma-residual": lambda: _k5_case(True, False, True),
    "qkv-bias": lambda: _k7_case(True),
    "qkv-no-bias": lambda: _k7_case(False),
    "swiglu-128": lambda: _k8_case("swiglu_fused", 128, True),
    "swiglu-384": lambda: _k8_case("swiglu_fused", 384, True),
    "swiglu-384-bare": lambda: _k8_case("swiglu_fused", 384, False),
    "gelu-200": lambda: _k8_case("mlp", 200, True),
}


@pytest.mark.parametrize("case", sorted(BF16_GEMM_EPILOGUES))
def test_bf16_gemm_epilogues_through_the_block_kernels(case):
    """Each EPI_* epilogue of the bf16 GEMM through the kernel that runs
    it, against its plain version at the block kernels' bf16 bound."""
    kernel, ref, args, kw = BF16_GEMM_EPILOGUES[case]()
    before = kernel.launches
    got = kernel(*args, **kw)
    assert kernel.launches == before + 1
    want = ref(*args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **BF16)


# ---------------------------------------------------------------- the entry point on the card
# Retrieval, the command line and the descriptor cache, each against the
# same call on the CPU (F11: with no device named, everything runs on the
# card).

def test_get_top_k_recall_on_the_card_matches_the_cpu(monkeypatch):
    """No device named: numpy inputs are searched on the card, with the
    CPU's indices exactly and its distances within 1e-5 (l2: and 1e-6 of
    their size)."""
    from anyloc_tpu_torch import get_top_k_recall
    from anyloc_tpu_torch.ops import retrieval

    rng = np.random.default_rng(7)
    db = rng.standard_normal((300, 512)).astype(np.float32)
    qu = rng.standard_normal((40, 512)).astype(np.float32)
    gt = [rng.choice(300, size=3, replace=False) for _ in range(40)]
    seen = []
    search = retrieval.top_k_search

    def spy(d, q, k, *a, **kw):
        seen.append(d.device.type)
        return search(d, q, k, *a, **kw)

    monkeypatch.setattr(retrieval, "top_k_search", spy)
    for method in ("cosine", "l2"):
        gd, gi, gr = get_top_k_recall([1, 5, 10], db, qu, gt, method=method)
        cd, ci, cr = get_top_k_recall([1, 5, 10], db, qu, gt, method=method, device="cpu")
        np.testing.assert_array_equal(gi, ci)
        np.testing.assert_allclose(gd, cd, atol=1e-5, rtol=1e-6 if method == "l2" else 0)
        assert gr == cr
    assert seen == ["cuda", "cpu", "cuda", "cpu"]


def _vits14_checkpoint(path):
    """A ViT-S/14 state dict from a numpy seed (both devices load the same
    weights; a torch generator draws differently on the card)."""
    from anyloc_tpu_torch.models.dinov2 import dinov2_config, init_params

    shapes = {k: tuple(v.shape) for k, v in init_params(
        dinov2_config("dinov2_vits14", dtype=torch.float32), n_blocks=2).items()}
    rng = np.random.default_rng(0)
    sd = {k: torch.from_numpy((rng.standard_normal(s) * (np.prod(s[1:]) ** -0.5 if len(s) > 1
                                                         else 0.1)).astype(np.float32))
          for k, s in sorted(shapes.items())}
    torch.save(sd, path)
    return path


def test_cli_with_a_small_trunk_on_the_card(tmp_path):
    """``cli.main`` with no device on a synthetic 17places + gardens root
    (ViT-S/14 layer 1, float32, 56 px, a shared vocabulary): the card's
    results JSON equals the CPU's but for the time stamp, and the trunk ran
    through K5 and K1."""
    import glob
    import json

    from anyloc_tpu_torch import cli
    from anyloc_tpu_torch.data import synthetic
    from anyloc_tpu_torch.ops import kernels as K

    synthetic.build_vpr_bench(str(tmp_path), n_db=12, n_q=6, seed=1, size=(60, 80))
    synthetic.build_gardens(str(tmp_path), n_db=6, n_q=3, seed=2, size=(60, 80))
    (tmp_path / "vocab").mkdir()
    np.savez(tmp_path / "vocab" / "c_centers.npz",
             centers=np.random.default_rng(3).standard_normal((8, 384)).astype(np.float32))
    ckpt = _vits14_checkpoint(tmp_path / "vits14.pth")
    saved = {}
    for side, device in (("card", None), ("cpu", "cpu")):
        args = ["global-vocab-vlad", "--prog.data-vg-dir", str(tmp_path),
                "--prog.vg-dataset-name", "17places", "--db-samples", "17places=1", "gardens=2",
                "--prog.cache-dir", str(tmp_path / side), "--extractor.model-type",
                "dinov2_vits14", "--extractor.desc-layer", "1", "--extractor.dtype", "float32",
                "--extractor.checkpoint", str(ckpt), "--bd-args.resize", "56", "56",
                "--vlad.num-clusters", "8", "--vlad.cache-dir", str(tmp_path / "vocab"),
                "--top-k-vals", "1", "3", "5"]
        K.reset_launch_counts()
        assert cli.main(args, device=device) == 0
        counts = K.launch_counts()
        (path,) = glob.glob(str(tmp_path / side / "experiments" / "default" / "*.json"))
        saved[side] = json.loads(open(path).read())
        saved[side].pop("Timestamp")
        ran = counts["K5_flash_attention_qkv_proj"] > 0 and counts["K1_vlad_aggregate_fused"] > 0
        assert ran == (side == "card"), counts
    assert saved["card"] == saved["cpu"]
    assert saved["card"]["VLAD-Dim"] == str(8 * 384)


def test_descriptor_cache_round_trip_on_the_card(tmp_path):
    """Two engines on the card over one cache directory: the second
    computes nothing and returns bit-equal VLADs and facets."""
    from pathlib import Path

    from anyloc_tpu_torch import VLAD, DescriptorEngine, ViTConfig, ViTFacetExtractor, VPRDataset
    from anyloc_tpu_torch import listdir_abs

    fixture = Path(__file__).parent / "fixtures" / "e2e"
    ds = VPRDataset(listdir_abs(str(fixture), "db")[:8], listdir_abs(str(fixture), "queries")[:4],
                    img_size=(112, 112))
    cfg = ViTConfig(img_size=56, embed_dim=128, depth=2, num_heads=2, dtype=torch.bfloat16)
    sd = ViTFacetExtractor(cfg, None, 1, "value", device="cpu", seed=5).model.state_dict()

    def engine():
        return DescriptorEngine(batch_size=4, cache_dir=str(tmp_path),
                                extractor=ViTFacetExtractor(cfg, sd, 1, "value", device="cuda"))

    first = engine()
    vlad = VLAD(8)
    vlad.fit(first.extract_dataset(ds, "db", verbose=False, keep_on_device=True).reshape(-1, 128))
    assert vlad.c_centers.device.type == "cuda"
    v1 = first.extract_vlads_dataset(ds, vlad, "all", verbose=False)
    f1 = first.extract_dataset(ds, "queries", verbose=False)
    second = engine()

    def no_compute(*a, **k):
        raise AssertionError("the second engine computed instead of reading the cache")

    second._extract_dataset = no_compute
    np.testing.assert_array_equal(second.extract_vlads_dataset(ds, vlad, "all", verbose=False), v1)
    np.testing.assert_array_equal(second.extract_dataset(ds, "queries", verbose=False), f1)
    assert v1.shape == (12, 8 * 128) and np.isfinite(v1).all()


# ---------------------------------------------------------------- F10: the block kernels at head dim 80
# 16 heads of 64 (D 1024) and of 80 (D 1280: MAE-H, ImageBind-H, SAM-H).
# At hd 80 an int8 head chunk is a multiple of 8 heads (hc·80 % 128 == 0),
# so the projection's K groups are 640 or 1280 wide, and the qkv product
# is 3840 columns; each kernel is held to its hd-64 bound at both.

def _head_dim_case(kernel, hd, dtype=torch.bfloat16):
    from anyloc_tpu_torch.ops import kernels as K

    b, n, h = 2, 77, 16
    d = h * hd
    x = _randn(b, n, d, dtype=dtype, seed=200)
    ln = (1 + _randn(d, seed=201, scale=0.1), _randn(d, seed=202, scale=0.1))
    gamma = _randn(d, seed=203, scale=0.5)
    if kernel == "K6":
        qkv = _randn(b, n, 3 * d, dtype=dtype, seed=204)
        q, k, v = (qkv[..., i * d:(i + 1) * d].view(b, n, h, hd).transpose(1, 2) for i in range(3))
        w = _randn(d, 256, dtype=dtype, seed=205, scale=d ** -0.5)
        return K.attention_proj, K.attention_proj_ref, (q, k, v, w), {}, "bf16"
    if kernel == "K7":
        wqkv = _randn(d, 3 * d, dtype=dtype, seed=206, scale=d ** -0.5)
        wp = _randn(d, d, dtype=dtype, seed=207, scale=d ** -0.5)
        args = (x, wqkv, _randn(3 * d, seed=208, scale=0.1), wp, _randn(d, seed=209, scale=0.1))
        return (K.fused_attn_half_bf16, K.fused_attn_half_bf16_ref, args,
                dict(num_heads=h, ln_params=ln, layerscale=gamma), "bf16")
    wqkv, sqkv = _int8_weights(d, 3 * d, 210)
    wp, sp = _int8_weights(d, d, 211)
    attn_p = (wqkv, sqkv, _randn(3 * d, seed=212, scale=0.1), wp, sp, _randn(d, seed=213, scale=0.1))
    if kernel == "K4":
        return (K.fused_attn_half_int8, K.fused_attn_half_int8_ref, (x, *attn_p),
                dict(num_heads=h, ln_params=ln, layerscale=gamma), "int8")
    if kernel == "K9":
        w12, s12 = _int8_weights(d, 1024, 214)
        w3, s3 = _int8_weights(512, d, 215)
        mlp_p = (w12, s12, _randn(1024, seed=216, scale=0.1), w3, s3, _randn(d, seed=217, scale=0.1))
        return (K.fused_block_int8, K.fused_block_int8_ref, (x, attn_p, mlp_p),
                dict(num_heads=h, ln1=ln, ln2=(1 + _randn(d, seed=218, scale=0.1),
                                              _randn(d, seed=219, scale=0.1)),
                     gamma1=gamma, gamma2=_randn(d, seed=220, scale=0.5)), "int8")
    args = (x, None, None, wqkv, sqkv, wp, sp, (ln[0][None], ln[1][None]), gamma[None])
    return (K.attn_half_variant, K.attn_half_variant_ref, args,
            dict(pre_quant=False, batched_dots=False, head_dim=hd), "int8")


@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("kernel", ["K4", "K6", "K7", "K9", "T3"])
def test_block_kernels_take_head_dim_80(kernel, hd):
    """F10: K4, K6, K7, K9 and T3 at 16 heads of 64 and of 80, each
    against its plain version within its hd-64 bound (bf16: BF16; int8:
    rms_rel 1e-2 and rare flips)."""
    fn, ref, args, kw, kind = _head_dim_case(kernel, hd)
    before = fn.launches
    got = fn(*args, **kw)
    assert fn.launches == before + 1
    want = ref(*args, **kw)
    torch.cuda.synchronize()
    if kind == "bf16":
        torch.testing.assert_close(got.float(), want.float(), **BF16)
    else:
        assert _rms_rel(got, want) <= 1e-2
        _close_but_rare_flips(got, want, atol=2e-2, rtol=1e-2)


# ---------------------------------------------------------------- the retrieval engines
# The engines are plain torch: on the card they compute what they compute
# on the CPU, up to f32 sums in other orders (1e-4 on unit rows) and, for
# bf16 scores, tensor-core sums of the same bf16 operands (2^-8).

def _clustered(n, d, seed):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((24, d)) * 2.0
    x = c[rng.integers(0, 24, n)] + 0.35 * rng.standard_normal((n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _same_results(got, want, tol):
    """Scores within ``tol`` and the same ids, as a set where scores lie
    within ``tol`` of each other (the last such group may reach past k and
    is not compared)."""
    gs, gi = (t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t) for t in got)
    ws, wi = (t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t) for t in want)
    np.testing.assert_allclose(gs, ws, atol=tol, rtol=0)
    for r in range(ws.shape[0]):
        start = 0
        for j in range(1, ws.shape[1] + 1):
            if j < ws.shape[1] and abs(ws[r, j] - ws[r, j - 1]) <= tol:
                continue
            if j < ws.shape[1] or start == 0:
                assert sorted(gi[r, start:j]) == sorted(wi[r, start:j]), (r, start, j)
            start = j


def test_bf16_dot_on_the_card_is_the_cpu_emulation():
    from anyloc_tpu_torch.ops.common import bf16_dot

    a, b = _randn(300, 512, seed=230), _randn(512, 200, seed=231)
    got = bf16_dot(a, b)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), bf16_dot(a.cpu(), b.cpu()), atol=1e-4, rtol=1e-5)


def test_blocked_stream_pins_and_overlaps_in_order():
    """_prepare_shard(pin=True) hands pinned host tensors to
    stream_to_device, which yields the shards on the card in order with
    their values; a 7-shard search equals the one-shard search."""
    from anyloc_tpu_torch.ops import retrieval as R

    db, qu = _clustered(5000, 96, 240), _clustered(70, 96, 241)
    blk, scale = R._prepare_shard(db, 0, 800, "int8", True, pin=True)
    assert blk.is_pinned() and scale.is_pinned() and blk.dtype == torch.int8
    shards = (R._prepare_shard(db, d0, d0 + 800, "float32", pin=True) for d0 in range(0, 5000, 800))
    got = list(R.stream_to_device(shards, torch.device("cuda")))
    assert len(got) == 7 and all(t.is_cuda for t, _ in got)
    torch.testing.assert_close(torch.cat([t for t, _ in got]).cpu(), torch.from_numpy(db))
    for sd in ("float32", "bfloat16", "int8"):
        many = R.top_k_search_blocked(db, qu, 20, db_block=800, query_block=32, stream_dtype=sd)
        one = R.top_k_search_blocked(db, qu, 20, db_block=5000, stream_dtype=sd)
        cpu = R.top_k_search_blocked(db, qu, 20, db_block=800, stream_dtype=sd, device="cpu")
        _same_results(many, one, 1e-5)
        _same_results(many, cpu, 1e-4 if sd == "float32" else 2 ** -8)


@pytest.mark.parametrize("method", ["cosine", "l2"])
@pytest.mark.parametrize("engine", ["device", "blocked", "ivf", "pq", "ivf_pq"])
def test_engine_on_the_card_matches_the_cpu(tmp_path, engine, method):
    """Each engine on the card against the same engine on the CPU. The
    compressed engines search one index, fitted on the CPU and loaded on
    the card from its .npz."""
    from anyloc_tpu_torch.ops import ivf, ivf_pq, pq
    from anyloc_tpu_torch.ops.retrieval import get_top_k_recall

    db, qu = _clustered(3000, 64, 250), _clustered(40, 64, 251)
    gt = [np.array([i]) for i in range(40)]
    kw = dict(engine=engine, method=method, n_probe=6, pq_m=8)
    card_kw = dict(kw)
    if engine != "device" and engine != "blocked":
        fit, save, load, name = {
            "ivf": (ivf.ivf_fit, ivf.save_ivf, ivf.load_ivf, "ivf_index"),
            "pq": (lambda x, **a: pq.pq_fit(x, 8, **a), pq.save_pq, pq.load_pq, "pq_index"),
            "ivf_pq": (lambda x, **a: ivf_pq.ivf_pq_fit(x, m=8, **a), ivf_pq.save_ivf_pq,
                       ivf_pq.load_ivf_pq, "ivf_pq_index")}[engine]
        index = fit(db, method=method, device="cpu")
        save(index, str(tmp_path / "i"))
        kw[name] = index
        card_kw[name] = load(str(tmp_path / "i"))
        assert getattr(card_kw[name], "codebooks", getattr(card_kw[name], "cells", None)).is_cuda
    want_d, want_i, want_r = get_top_k_recall([1, 5, 20], db, qu, gt, device="cpu", **kw)
    got_d, got_i, got_r = get_top_k_recall([1, 5, 20], db, qu, gt, **card_kw)
    _same_results((got_d, got_i), (want_d, want_i), 1e-4)
    if engine in ("pq", "ivf_pq"):   # bf16 tables / operands, f32 sums
        want = get_top_k_recall([20], db, qu, gt, device="cpu", score_dtype="bfloat16", **kw)
        got = get_top_k_recall([20], db, qu, gt, score_dtype="bfloat16", **card_kw)
        _same_results(got[:2], want[:2], 2 ** -8)


def test_fits_on_the_card_match_the_cpu():
    """ivf_fit, pq_fit (with OPQ) and ivf_pq_fit from the same starts on
    the card and on the CPU; kmeans_fit_streamed likewise."""
    from anyloc_tpu_torch.ops import ivf, ivf_pq, kmeans, pq

    db = _clustered(3000, 64, 260)
    a, b = ivf.ivf_fit(db, 30, device="cpu"), ivf.ivf_fit(db, 30)
    torch.testing.assert_close(b.cells.cpu(), a.cells, atol=1e-4, rtol=0)
    assert (b.bucket_ids.cpu() == a.bucket_ids).float().mean().item() >= 0.999
    a, b = pq.pq_fit(db, 8, opq_iters=2, device="cpu"), pq.pq_fit(db, 8, opq_iters=2)
    torch.testing.assert_close(b.rotation.cpu(), torch.from_numpy(np.asarray(a.rotation)),
                               atol=1e-3, rtol=0)
    assert (b.codes.cpu() == a.codes).float().mean().item() >= 0.99
    a, b = ivf_pq.ivf_pq_fit(db, m=8, device="cpu"), ivf_pq.ivf_pq_fit(db, m=8)
    torch.testing.assert_close(b.cells.cpu(), a.cells, atol=1e-4, rtol=0)
    c_cpu, l_cpu = kmeans.kmeans_fit_streamed(db, 16, max_iters=10, shard_rows=700, device="cpu",
                                              generator=torch.Generator().manual_seed(1))
    c_gpu, l_gpu = kmeans.kmeans_fit_streamed(db, 16, max_iters=10, shard_rows=700,
                                              generator=torch.Generator().manual_seed(1))
    assert c_gpu.is_cuda
    torch.testing.assert_close(c_gpu.cpu(), c_cpu, atol=1e-4, rtol=0)
    assert (l_gpu == l_cpu).mean() >= 0.999


# ---------------------------------------------------------------- the other pipelines on the card
# GeM and the pooling ops, the demo at 1022 px and the serving daemon, each
# against the CPU or against the extractor + aggregate they are built on.

def test_gem_and_pooling_on_the_card_match_the_cpu():
    """Float32 on both devices: the mean of 485 powers sums in another
    order (up to ~N·2^-24 of it), and the 1/p root passes that on: 5e-5
    relative."""
    from anyloc_tpu_torch.ops import gem, pooling

    x = _randn(4, 485, 64, seed=1)
    for p, use_abs, eps in ((3.0, False, 0.0), (3.0, True, 0.0), (3.0, False, 1e-3),
                            (2.5, True, 0.0)):
        got = gem.gem_pool(x, p=p, use_abs=use_abs, eps=eps)
        want = gem.gem_pool(x.cpu(), p=p, use_abs=use_abs, eps=eps)
        assert got.is_cuda
        torch.testing.assert_close(got.cpu(), want, rtol=5e-5, atol=1e-7)
    m = _randn(2, 9, 12, 16, seed=2)
    torch.testing.assert_close(gem.gem_pool_spatial(m).cpu(), gem.gem_pool_spatial(m.cpu()),
                               rtol=5e-5, atol=1e-7)
    for fn in (pooling.global_max_pool, pooling.global_avg_pool):
        torch.testing.assert_close(fn(x).cpu(), fn(x.cpu()), rtol=1e-5, atol=1e-6)
    for fn in (pooling.mac_spatial, pooling.spoc_spatial, pooling.rmac_spatial):
        torch.testing.assert_close(fn(m).cpu(), fn(m.cpu()), rtol=1e-5, atol=1e-6)


def _png(path, rng, h, w):
    from PIL import Image

    Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(path)
    return path


def test_demo_at_1022_px_on_the_card_is_the_extractor_and_aggregate(tmp_path):
    """``python -m anyloc_tpu_torch demo`` with no device: a 1100-px square
    runs at 1022 px (5330 tokens) through K2 and K1, and its .npy is the
    extractor + ``VLAD.aggregate`` of the preprocessed image on the card
    (1e-6)."""
    from PIL import Image

    from anyloc_tpu_torch import VLAD, cli
    from anyloc_tpu_torch.data.transforms import preprocess_image
    from anyloc_tpu_torch.models.extractor import DinoV2ExtractFeatures
    from anyloc_tpu_torch.ops import kernels as K
    from anyloc_tpu_torch.pipelines.demo import vocab_dir

    rng = np.random.default_rng(5)
    (tmp_path / "imgs").mkdir()
    src = _png(tmp_path / "imgs" / "a.png", rng, 1100, 1100)
    ckpt = _vits14_checkpoint(tmp_path / "vits14.pth")
    vdir = vocab_dir(str(tmp_path / "cache"), "dinov2_vits14", 1, "value", 8, "indoor")
    VLAD(8, cache_dir=vdir).fit(rng.standard_normal((100, 384)).astype(np.float32))
    K.reset_launch_counts()
    assert cli.main(["demo", "--in-dir", str(tmp_path / "imgs"), "--out-dir", str(tmp_path / "out"),
                     "--cache-dir", str(tmp_path / "cache"), "--model", "dinov2_vits14",
                     "--layer", "1", "--num-clusters", "8", "--checkpoint", str(ckpt)]) == 0
    counts = K.launch_counts()
    assert counts["K2_flash_attention"] > 0 and counts["K1_vlad_aggregate_fused"] > 0, counts
    arr = preprocess_image(Image.open(src).convert("RGB"), max_edge=1024)
    assert arr.shape == (1022, 1022, 3)
    vlad = VLAD(8, cache_dir=vdir)
    vlad.fit(None)
    ext = DinoV2ExtractFeatures("dinov2_vits14", 1, "value", checkpoint=str(ckpt))
    want = vlad.aggregate(ext(arr[None]))[0].cpu().numpy()
    np.testing.assert_allclose(np.load(tmp_path / "out" / "a.npy"), want, atol=1e-6)


def _serve_burst(port, plan):
    import json
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    def post(path, data):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())

    with ThreadPoolExecutor(len(plan)) as ex:
        return list(ex.map(lambda pd: post(*pd), plan))


def test_serve_on_the_card_answers_groups_as_batch_1_and_fetches_its_own_group(tmp_path):
    """The daemon on the card (no device named): a coalesced group's
    replies equal the batch-1 server's (ids; scores and descriptors within
    2e-3), and the fetch of one group returns while the next group's work
    is still running on the card (ordering, not milliseconds: the
    dispatcher's ``n_overlapped``). Each group's device work starts with
    ~50 ms of spinning, far longer than the host's side of a fetch: a
    fetch that waited for every queued group would never see the next one
    running."""
    import argparse
    import io
    import threading

    from PIL import Image

    from anyloc_tpu_torch import VLAD
    from anyloc_tpu_torch.pipelines import serve_http

    rng = np.random.default_rng(9)
    VLAD(8, cache_dir=str(tmp_path / "vocab")).fit(
        rng.standard_normal((100, 384)).astype(np.float32))
    np.save(tmp_path / "db.npy", rng.standard_normal((64, 8 * 384)).astype(np.float32))
    imgs = []
    for _ in range(12):
        buf = io.BytesIO()
        Image.fromarray((rng.random((300, 400, 3)) * 255).astype(np.uint8)).save(buf, "PNG")
        imgs.append(buf.getvalue())
    plan = [("/describe" if i % 3 == 0 else "/search?k=5", d) for i, d in enumerate(imgs)]

    def run(max_batch, window_ms, burst):
        args = argparse.Namespace(
            model="dinov2_vits14", layer=11, facet="value", num_clusters=8,
            vocab_dir=str(tmp_path / "vocab"), checkpoint=None, quant=None, max_img_size=640,
            img_size=448, max_batch=max_batch, batch_window_ms=window_ms,
            db=str(tmp_path / "db.npy"), ivf=False, n_probe=8, host="127.0.0.1", port=0)
        server = serve_http.build_server(args)
        svc = server.service
        assert svc.device.type == "cuda"
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            if burst:
                trunk = svc.extractor

                def spinning(imgs):
                    torch.cuda._sleep(100_000_000)
                    return trunk(imgs)

                svc.extractor = spinning
                outs = _serve_burst(server.server_address[1], plan)
            else:
                outs = [_serve_burst(server.server_address[1], [pd])[0] for pd in plan]
            b = svc.batcher
            return outs, (b.n_requests, b.n_batches, b.n_pipelined, b.n_overlapped)
        finally:
            server.shutdown()
            server.server_close()

    ref, _ = run(1, 0.0, burst=False)
    outs, (n_req, n_bat, n_pipe, n_over) = run(3, 50.0, burst=True)
    for (path, _), got, want in zip(plan, outs, ref):
        if path == "/describe":
            np.testing.assert_allclose(got["descriptor"], want["descriptor"], rtol=2e-3, atol=2e-3)
        else:
            assert got["ids"] == want["ids"]
            np.testing.assert_allclose(got["scores"], want["scores"], rtol=2e-3, atol=2e-3)
    assert n_req == 12 and n_bat < 12
    assert n_pipe > 0 and n_over > 0, (n_pipe, n_over)


def test_pca_on_the_card_is_full_float32():
    """PCA's products on the card run in float32, never TF32 (10-bit
    mantissa: errors ~1e-3 relative): projections' pairwise distances
    within 1e-4 relative of the CPU's, the residual-concat descriptor within
    1e-5."""
    from anyloc_tpu_torch.ops import pca

    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    rng = np.random.default_rng(4)
    spectrum = np.linspace(3, 0.2, 256).astype(np.float32)
    train = rng.standard_normal((400, 256)).astype(np.float32) * spectrum
    test = rng.standard_normal((50, 256)).astype(np.float32) * spectrum
    for kw in (dict(lower_dim=32), dict(lower_dim=32, whitening=True),
               dict(lower_dim=32, low_factor=0.25)):
        got = pca.reduce_pca(train, test, **kw)          # the card
        want = pca.reduce_pca(train, test, device="cpu", **kw)
        for g, w in zip(got, want):
            dg = np.linalg.norm(g[:, None] - g[None], axis=-1)
            dw = np.linalg.norm(w[:, None] - w[None], axis=-1)
            np.testing.assert_allclose(dg, dw, rtol=1e-4, atol=1e-4 * dw.max())
    centers, descs = rng.standard_normal((8, 256)), rng.standard_normal((60, 256))
    np.testing.assert_allclose(pca.concat_desc_dists_clusters(centers, descs).cpu().numpy(),
                               pca.concat_desc_dists_clusters(centers, descs, "cpu").numpy(),
                               atol=1e-5)



@pytest.mark.parametrize("family", ["dino_v1", "dino_v1_long", "clip", "imagebind", "hf_vit",
                                    "mae", "lseg", "sam"])
def test_family_trunks_on_the_card_match_the_cpu(family):
    """Each model family's small float32 trunk, one state dict on the CPU
    (plain versions) and on the card (K5 / K2; SAM's attention is plain),
    within ``family_checks.BOUND`` of the largest |value|, the expected
    kernels launched (tools/family_checks.py)."""
    from anyloc_tpu_torch.tools import family_checks

    r = family_checks.compare(family)
    assert r["ok"], family_checks.line(r)


@pytest.mark.parametrize("network", ["vgg16", "alexnet", "cct384", "efficientnet_b0",
                                     "efficientnet_b7", "swinv2_base", "crn", "rrm",
                                     "imagebind_huge"])
def test_trained_baseline_networks_on_the_card_match_the_cpu(network):
    """Each network of the trained baselines and ImageBind-H's five towers
    at full width and depth in float32, one state on the CPU and the card,
    within ``family_checks.BOUND`` of the largest |value| with cuDNN's
    TF32 flag at its default (F17), K5 launched by ImageBind's vision."""
    from anyloc_tpu_torch.tools import family_checks

    assert torch.backends.cudnn.allow_tf32   # PyTorch's default, untouched
    r = family_checks.compare_network(network)
    assert r["ok"], family_checks.network_line(r)


def test_float32_conv_on_the_card_is_full_float32():
    """F17: a float32 convolution through ``ops.common.Conv2d`` on the card
    with PyTorch's default flags (cuDNN's TF32 on) is within float32
    rounding of the CPU's; TF32's 10-bit mantissa would miss by ~1e-3."""
    from anyloc_tpu_torch.ops.common import Conv2d

    assert torch.backends.cudnn.allow_tf32
    torch.manual_seed(0)
    conv = Conv2d(512, 512, 3, padding=1)
    x = torch.randn(2, 512, 30, 40)
    want = conv(x)
    got = conv.cuda()(x.cuda()).cpu()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cudnn.conv.fp32_precision != "ieee"


@pytest.mark.parametrize("b,n,h,hd", [(16, 197, 12, 64), (8, 257, 16, 80)],
                         ids=["dvgl-vit-b16-224px", "imagebind-h14-f32"])
def test_k5_float32_at_the_eval_shapes(b, n, h, hd):
    """K5's float32 route at the shapes this slice gives it: dvgl's ViT-B/16
    backbone at 224 px (qkv [16, 197, 2304]) and ImageBind-H's vision tower
    (qkv [8, 257, 3840], heads of 80), no LayerScale."""
    d = h * hd
    qkv = _randn(b, n, 3 * d, seed=20)
    w = _randn(d, d, seed=21, scale=d ** -0.5).t()
    kw = dict(b_proj=_randn(d, seed=22, scale=0.1), layerscale=None,
              residual=_randn(b, n, d, seed=23), num_heads=h)
    before = flash_attention_qkv_proj.launches
    got = flash_attention_qkv_proj(qkv, w, **kw)
    assert flash_attention_qkv_proj.launches == before + 1
    want = flash_attention_qkv_proj_ref(qkv, w, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **F32)


# ---------------------------------------------------------------- training (F18, F17b)

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,h,hd", [(48, 197, 12, 64), (4, 257, 16, 80)],
                         ids=["dvgl-vit-b16-step", "hd80"])
def test_k5_gradient_matches_the_plain_versions(b, n, h, hd, dtype):
    """F18: K5 under autograd launches its kernel once and carries the
    plain version's gradient for qkv, the weight, the bias and the
    residual: each within 1e-4 of its largest |value| (the backward is the
    plain version recomputed on the same inputs, so the bound is the same
    in bf16); the output keeps the kernel's bound."""
    from anyloc_tpu_torch.tools import train_checks

    r = train_checks.k5_gradient(b, n, h, hd, dtype)
    assert r["launched"] == 1 and r["grad_fn"].startswith("QkvProjGrad")
    assert r["ok"], r["grad_errs"]
    assert r["out_err"] <= (2e-2 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize("b,h,n,hd,dtype", [(48, 6, 197, 64, torch.float32),
                                             (2, 4, 300, 80, torch.float32),
                                             (2, 8, 257, 64, torch.bfloat16)])
def test_k2_gradient_matches_the_plain_versions(b, h, n, hd, dtype):
    """K2 under autograd (a tensor-parallel rank's heads in training,
    ``FlashAttentionGrad``) launches its kernel once and carries the plain
    version's gradient for q, k and v: each within 1e-4 of its largest
    |value|; the output keeps the kernel's bound."""
    from anyloc_tpu_torch.tools import train_checks

    r = train_checks.k2_gradient(b, h, n, hd, dtype)
    assert r["launched"] == 1 and r["grad_fn"].startswith("FlashAttentionGrad")
    assert r["ok"], r["grad_errs"]
    assert r["out_err"] <= (2e-2 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize("mode", ["inference_mode", "no_grad", "no_input_requires_grad"])
def test_k2_without_a_gradient_launches_and_saves_nothing(mode):
    """K2 with grad mode off, or no input that requires a gradient: the
    kernel launches directly, the output has no grad_fn and nothing is saved
    for a backward."""
    from anyloc_tpu_torch.ops import kernels as K

    q = _randn(2, 4, 197, 64)
    args = (q.requires_grad_(mode != "no_input_requires_grad"), q, q)
    saved = []
    ctx = {"inference_mode": torch.inference_mode, "no_grad": torch.no_grad,
           "no_input_requires_grad": torch.enable_grad}[mode]
    before = K.flash_attention.launches
    with ctx(), torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t,
                                                         lambda t: t):
        out = K.flash_attention(*args)
    torch.cuda.synchronize()
    assert K.flash_attention.launches == before + 1
    assert out.grad_fn is None and saved == []


def _no_grad_cases():
    """Each kernel wrapper without a gradient, at a small shape: (wrapper,
    args, kwargs); its first float tensor will require a gradient."""
    from anyloc_tpu_torch.ops import kernels as K

    q = _randn(1, 2, 10, 64)
    d, hid = 128, 256
    wqkv, sqkv = _int8_weights(d, 3 * d, 81)
    wp, sp = _int8_weights(d, d, 82)
    w12, s12 = _int8_weights(d, 2 * hid, 83)
    w3, s3 = _int8_weights(hid, d, 84)
    ln = (1 + _randn(d, seed=85, scale=0.1), _randn(d, seed=86, scale=0.1))
    attn_p = (wqkv, sqkv, None, wp, sp, None)
    mlp_p = (w12, s12, None, w3, s3, None)
    x = _randn(1, 16, d, seed=87)
    a8, b8 = _int8_operands(64, 64, 64, 88)
    k7, k8 = _k7_case(True), _k8_case("mlp", 200, True)
    return {
        "K1": (K.vlad_aggregate_fused, (_randn(2, 10, 16), _randn(4, 16)), {}),
        "K3": (K.fused_mlp_int8, (x.reshape(16, d), w12, s12, None, w3, s3, None), {}),
        "K4": (K.fused_attn_half_int8, (x, wqkv, sqkv, None, wp, sp, None),
               dict(num_heads=2, ln_params=ln)),
        "K6": (K.attention_proj, (q, q, q, _randn(128, 128)), {}),
        "K7": (k7[0], k7[2], k7[3]),
        "K8": (k8[0], k8[2], k8[3]),
        "K9": (K.fused_block_int8, (x, attn_p, mlp_p), dict(num_heads=2, ln1=ln, ln2=ln)),
        "T1": (K.matmul, (_randn(64, 64), _randn(64, 64)), {}),
        "T2": (K.matmul_dequant, (a8, b8, _randn(64, 1).abs(), _randn(1, 64).abs()), {}),
        "T3": (K.attn_half_variant, _variant_args(1, 77, 128, torch.float32, 89),
               dict(pre_quant=False, batched_dots=False)),
    }


@pytest.mark.parametrize("name", ["K1", "K3", "K4", "K6", "K7", "K8", "K9", "T1", "T2", "T3"])
def test_no_gradient_wrappers_raise_under_grad(name):
    """F18: a wrapper whose kernel has no gradient raises when grad mode is
    on and an input requires one (its output would be detached), and
    launches under no_grad."""
    fn, args, kw = _no_grad_cases()[name]
    args = list(args)
    i = next(j for j, a in enumerate(args)
             if isinstance(a, torch.Tensor) and a.is_floating_point())
    args[i] = args[i].detach().requires_grad_(True)
    before = fn.launches
    with pytest.raises(RuntimeError, match="requires a gradient"):
        fn(*args, **kw)
    assert fn.launches == before
    with torch.no_grad():
        fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1


def test_train_step_on_the_card_matches_the_cpu_resnet18conv4():
    """F17b: one triplet step of dvgl's resnet18conv4 + NetVLAD-64 at
    480x640 (1 + 1 + 2 images) with cuDNN's flags at PyTorch's defaults:
    each gradient no farther from a CPU float64 run than 10x the CPU's
    float32 run (a random init's gradients are ill-conditioned), and each
    of its convolutions at the step's shapes with input and weight
    gradients within 1e-4 of the CPU's largest |value| (a TF32 backward
    misses that by ~3x-9x)."""
    from anyloc_tpu_torch.tools import train_checks

    assert torch.backends.cudnn.allow_tf32   # PyTorch's default, untouched
    r = train_checks.compare_step("resnet18conv4")
    assert r["ok"], train_checks.step_line(r)
    r = train_checks.compare_convs("resnet18conv4")
    assert r["ok"], train_checks.convs_line(r)
    assert torch.backends.cudnn.conv.fp32_precision != "ieee"


def test_inference_paths_launch_as_before_and_save_nothing():
    """The vit backbone's forward at 224 px under inference_mode and under
    no_grad (parameters requiring gradients): K5 launches once a block,
    as before F18, and nothing is saved for a backward; with grad on the
    same launches, through the autograd.Function."""
    from anyloc_tpu_torch.ops import kernels as K

    model = materialize_geo_vit()
    x = _randn(2, 224, 224, 3)
    saved = []

    def pack(t):
        saved.append(t.shape)
        return t

    for mode in (torch.inference_mode, torch.no_grad):
        K.reset_launch_counts()
        with mode(), torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = model(x)
        torch.cuda.synchronize()
        assert K.launch_counts()["K5_flash_attention_qkv_proj"] == 12
        assert out.grad_fn is None and saved == []
    K.reset_launch_counts()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = model(x)
    assert K.launch_counts()["K5_flash_attention_qkv_proj"] == 12
    assert saved and out.grad_fn is not None
    out.sum().backward()
    assert model.backbone.patch_embed.proj.weight.grad.abs().max() > 0


def materialize_geo_vit():
    from anyloc_tpu_torch.models.convert import materialize
    from anyloc_tpu_torch.training.network import GeoLocalizationNet

    return materialize(lambda: GeoLocalizationNet("vit", "netvlad", 64, img_size=224), None,
                       "cuda", seed=0).requires_grad_(True)


def test_world_one_mesh_on_the_card_equals_the_unsharded_paths(tmp_path):
    """``parallel/`` on a one-rank NCCL group in this process:
    ``DescriptorEngine(mesh=local_mesh(1))`` gives the unsharded engine's
    VLADs bit for bit, and the sharded exact search the single-device
    engine's results."""
    import torch.distributed as dist
    from PIL import Image

    from anyloc_tpu_torch import DescriptorEngine, VPRDataset, ViTFacetExtractor
    from anyloc_tpu_torch.ops.retrieval import top_k_search
    from anyloc_tpu_torch.ops.vlad import VLAD
    from anyloc_tpu_torch.parallel import local_mesh, top_k_search_sharded
    from anyloc_tpu_torch.tools import mesh_checks

    if dist.is_initialized():
        pytest.skip("this process already has a process group")
    rng = np.random.default_rng(3)
    paths = []
    for j in range(6):
        paths.append(str(tmp_path / f"i{j}.png"))
        Image.fromarray((rng.random((56, 56, 3)) * 255).astype(np.uint8)).save(paths[-1])
    ds = VPRDataset(paths, [], img_size=(56, 56))
    cfg = mesh_checks.vit_config("small")
    ext = ViTFacetExtractor(cfg, mesh_checks.vit_params(cfg, 0), 5, "value", device="cuda")
    vlad = VLAD(4)
    vlad.c_centers = _randn(4, cfg.embed_dim, seed=4)
    mesh = local_mesh(1, backend="nccl")
    try:
        assert dist.get_backend() == "nccl"
        kw = dict(extractor=ext, batch_size=4, transfer_dtype="uint8")
        want = DescriptorEngine(**kw).extract_vlads_dataset(ds, vlad, "db", verbose=False)
        got = DescriptorEngine(mesh=mesh, **kw).extract_vlads_dataset(ds, vlad, "db",
                                                                      verbose=False)
        np.testing.assert_array_equal(got, want)
        db, qu = _randn(1003, 64, seed=5), _randn(9, 64, seed=6)
        s, i = top_k_search_sharded(db.cpu().numpy(), qu, 7, mesh, device="cuda")
        s1, i1 = top_k_search(db, qu, 7)
        np.testing.assert_array_equal(i, i1.cpu().numpy())
        np.testing.assert_allclose(s, s1.cpu().numpy(), **F32)
    finally:
        dist.destroy_process_group()


def test_two_gloo_ranks_on_the_card_match_one_rank(tmp_path):
    """The multi-rank paths on two Gloo ranks that share this card
    (``tools/mesh_checks.py``, profile "small", float32): sharded k-means
    and search, the mesh engine, tensor / pipeline / sequence / expert
    parallelism against rank 0's single-device runs; K2 launches on each
    rank of the tensor-parallel trunk."""
    from anyloc_tpu_torch.tools import mesh_checks

    cases = ["kmeans", "search", "extract", "tp", "pp", "sp", "ep"]
    report = mesh_checks.launch(tmp_path, 2, "gloo", "cuda", "small", cases, timeout=600)
    res = {c: mesh_checks.results(tmp_path, c) for c in cases}
    for tag in ("cos", "euc"):
        np.testing.assert_allclose(res["kmeans"][f"{tag}_sharded"], res["kmeans"][f"{tag}_single"],
                                   atol=1e-4)
    for name in ("db509_cosine", "db512_l2", "clamp"):
        np.testing.assert_array_equal(res["search"][f"{name}_i"], res["search"][f"{name}_single_i"])
    ex = res["extract"]
    for name in ("vlads", "descs", "batch"):   # K5 f32 at another batch size: float32 rounding
        np.testing.assert_allclose(ex[f"float32_{name}"], ex[f"float32_single_{name}"], atol=1e-6)
    np.testing.assert_allclose(res["tp"]["tp"], res["tp"]["single"], atol=1e-4)
    assert all(report[r]["tp"]["launches"].get("K2_flash_attention", 0) > 0 for r in report)
    for name in ("5_value", "3_token", "2_query"):
        np.testing.assert_allclose(res["pp"][name], res["pp"][f"{name}_single"], atol=1e-4)
    for name in ("extractor", "extractor_u8"):
        np.testing.assert_allclose(res["sp"][name], res["sp"][f"{name}_single"], atol=1e-4)
    kept = res["ep"]["ample_kept"]
    assert kept.all()
    np.testing.assert_allclose(res["ep"]["ample_vlads"], res["ep"]["single"], atol=1e-5)
