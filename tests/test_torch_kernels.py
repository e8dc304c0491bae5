"""The PyTorch port's kernel modules against the JAX Pallas kernels.

Each port kernel wrapper, given CPU tensors, runs its plain PyTorch version
(``<kernel>_ref``); the JAX side runs the Pallas kernel itself in interpret
mode, the way tests/test_pallas.py and tests/test_attn_proj.py run it. Same
numpy-seeded inputs on both sides.

Tolerances: float32 1e-5 absolute on unit-scale outputs (both sides sum in
float32, only the order differs); bfloat16 2e-2 absolute (the two round to
bf16 at the same points, so they differ by the last-bit rounding of values
below 2, ~8e-3, plus sum-order effects).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from anyloc_tpu.ops.pallas.attn_proj import flash_attention_qkv_proj as jax_qkv_proj
from anyloc_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention,
    flash_attention_blocked as jax_flash_attention_blocked,
    flash_attention_heads as jax_flash_attention_heads,
)
from anyloc_tpu.ops.pallas.vlad_kernel import vlad_aggregate_fused as jax_vlad_fused
from anyloc_tpu_torch.ops.kernels import (
    flash_attention,
    flash_attention_qkv_proj,
    launch_counts,
    vlad_aggregate_fused,
    vlad_aggregate_fused_ref,
)
from anyloc_tpu_torch.ops.kernels.vlad_kernel import hard_label_agreement, vlad_cosine, vlad_plan

torch.set_num_threads(2)

F32_TOL = 1e-5
BF16_TOL = 2e-2


def _jnp(a, dtype):
    return jnp.asarray(a, dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------- K1 (VLAD)

@pytest.mark.parametrize("vlad_mode,dist_mode", [
    ("hard", "cosine"), ("hard", "euclidean"), ("soft", "cosine")])
@pytest.mark.parametrize("norm_descs", [True, False])
def test_k1_vlad_matches_pallas(vlad_mode, dist_mode, norm_descs):
    rng = np.random.default_rng(11)
    descs = rng.standard_normal((3, 50, 64)).astype(np.float32)
    centers = rng.standard_normal((8, 64)).astype(np.float32)
    kw = dict(dist_mode=dist_mode, norm_descs=norm_descs, vlad_mode=vlad_mode,
              soft_temp=2.0)
    want = jax_vlad_fused(jnp.asarray(descs), jnp.asarray(centers), interpret=True, **kw)
    before = launch_counts()
    got = vlad_aggregate_fused(torch.from_numpy(descs), torch.from_numpy(centers), **kw)
    assert launch_counts() == before  # CPU tensors never launch the kernel
    assert tuple(got.shape) == (3, 8 * 64)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL)


def test_k1_vlad_without_intra_norm_matches_pallas():
    rng = np.random.default_rng(12)
    descs = rng.standard_normal((2, 40, 32)).astype(np.float32)
    centers = rng.standard_normal((4, 32)).astype(np.float32)
    want = jax_vlad_fused(jnp.asarray(descs), jnp.asarray(centers),
                          intra_norm=False, interpret=True)
    got = vlad_aggregate_fused(torch.from_numpy(descs), torch.from_numpy(centers),
                               intra_norm=False)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL)


@pytest.mark.parametrize("vlad_mode", ["hard", "soft"])
def test_k1_vlad_token_blocked_regime_matches_pallas(vlad_mode):
    """N=2100, D=768: a 6.45 MB slab, over the Pallas kernel's 6 MB
    single-block budget, so the JAX side accumulates over 512-token
    blocks."""
    rng = np.random.default_rng(13)
    descs = rng.standard_normal((1, 2100, 768)).astype(np.float32)
    centers = rng.standard_normal((8, 768)).astype(np.float32)
    want = jax_vlad_fused(jnp.asarray(descs), jnp.asarray(centers),
                          vlad_mode=vlad_mode, interpret=True)
    got = vlad_aggregate_fused(torch.from_numpy(descs), torch.from_numpy(centers),
                               vlad_mode=vlad_mode)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL)


def H100_CLUSTERS(smem_bytes):
    """The clusters one H100 holds at once at D 1536 (the card's occupancy
    query, anyloc_vlad_resident_clusters, reads 30)."""
    return 30


def test_k1_plan_covers_every_token_once():
    for b, n in [(1, 5329), (1, 1001), (8, 256), (32, 484), (3, 77), (2, 1), (4, 0)]:
        plan = vlad_plan(b, n, 1536, 32, H100_CLUSTERS)
        ranges = [(s * plan.tokens_per_split, min(n, (s + 1) * plan.tokens_per_split))
                  for s in range(plan.splits)]
        assert [t for lo, hi in ranges for t in range(lo, hi)] == list(range(n))
        assert all(hi > lo for lo, hi in ranges) or n == 0
        assert plan.tokens_per_split % 32 == 0 or plan.splits == 1


@pytest.mark.parametrize("c", [1, 32, 64])
def test_k1_plan_fits_shared_memory(c):
    """D 1536 (DINOv2-G): every block's shared memory within 227 KB, the
    cluster's slices cover D, and the batch-1 query (5329 tokens) is split
    over more than one cluster."""
    for b, n in [(32, 256), (32, 484), (1, 5329)]:
        plan = vlad_plan(b, n, 1536, c, H100_CLUSTERS)
        assert plan.smem_bytes <= 227 * 1024
        assert 8 * plan.slice >= 1536 and plan.slice % 4 == 0
    assert vlad_plan(1, 5329, 1536, c, H100_CLUSTERS).splits > 1


def test_k1_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="clusters"):
        vlad_plan(1, 100, 1536, 65, H100_CLUSTERS)
    with pytest.raises(ValueError, match="clusters"):
        vlad_plan(1, 100, 1536, 0, H100_CLUSTERS)
    with pytest.raises(ValueError, match="shared memory"):
        vlad_plan(1, 100, 8192, 64, H100_CLUSTERS)


def test_k1_ref_takes_its_own_labels():
    """``labels`` equal to the argmax give the plain version's result to
    the bit; other labels move it."""
    rng = np.random.default_rng(14)
    descs = torch.from_numpy(rng.standard_normal((2, 30, 48)).astype(np.float32))
    centers = torch.from_numpy(rng.standard_normal((5, 48)).astype(np.float32))
    for dist_mode in ("cosine", "euclidean"):
        want = vlad_aggregate_fused_ref(descs, centers, dist_mode=dist_mode)
        raw, best, flips, ties = hard_label_agreement(want, descs, centers, dist_mode=dist_mode)
        assert flips.sum() == 0 and torch.equal(raw, best) and raw.min() > 1 - 1e-12
        x = descs / descs.norm(dim=-1, keepdim=True)
        sim = 2 * x @ centers.T - (centers ** 2).sum(-1) if dist_mode == "euclidean" else \
            x @ (centers / centers.norm(dim=-1, keepdim=True)).T
        labels = sim.argmax(-1)
        assert torch.equal(vlad_aggregate_fused_ref(descs, centers, dist_mode=dist_mode,
                                                    labels=labels), want)
        labels[0, 0] = (labels[0, 0] + 1) % 5
        moved = vlad_aggregate_fused_ref(descs, centers, dist_mode=dist_mode, labels=labels)
        assert not torch.allclose(moved[0], want[0]) and torch.equal(moved[1], want[1])


@pytest.mark.parametrize("dist_mode", ["cosine", "euclidean"])
def test_k1_zeroes_a_hard_residual_at_its_rounding_floor(dist_mode):
    """patch-CLIP's shape: 16 images of 4 unit crop descriptors over 32
    clusters from the port's k-means, so that some tokens are singleton
    clusters' centers. Normalizing the tokens another way (their last bits
    change, as the kernel's rsqrt changes them) leaves every VLAD as it
    was: such residuals are zero in the plain versions, not unit noise. A
    token 1e-4 from its center keeps its residual."""
    from anyloc_tpu_torch.ops.common import l2_normalize
    from anyloc_tpu_torch.ops.vlad import VLAD, vlad_aggregate

    torch.manual_seed(0)
    descs = l2_normalize(torch.randn(16, 4, 768))
    vlad = VLAD(32)
    vlad.fit(descs.reshape(-1, 768))
    centers = vlad.c_centers
    other = descs * torch.rsqrt((descs.double() ** 2).sum(-1, keepdim=True)).float()
    assert not torch.equal(other, descs)
    kw = dict(dist_mode=dist_mode)
    want = vlad_aggregate_fused_ref(descs, centers, **kw)
    for got in (vlad_aggregate_fused_ref(other, centers, norm_descs=False, **kw),
                vlad_aggregate(descs, centers, **kw),
                vlad_aggregate(other, centers, norm_descs=False, **kw)):
        cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
        assert cos.min().item() >= 1 - 1e-6, cos.min().item()
    rows = want.view(16, 32, 768).norm(dim=-1)
    assert (rows == 0).sum() > (rows.sum(-1) == 0).sum()   # zeroed clusters, no empty image
    near = centers[:1] + 1e-4 * l2_normalize(torch.randn(1, 768))
    kept = vlad_aggregate_fused_ref(near[None], centers, norm_descs=False, **kw)
    assert kept.view(32, 768)[0].norm().item() > 0.99
    # an image whose every token is a center: the zero vector, which
    # vlad_cosine takes as agreeing only with the zero vector
    unit = l2_normalize(torch.randn(8, 768))
    zero = vlad_aggregate_fused_ref(unit[None, :4], unit, **kw)
    assert torch.equal(zero, torch.zeros_like(zero))
    assert vlad_cosine(zero, zero).tolist() == [1.0]
    ones = torch.ones_like(zero)
    assert vlad_cosine(zero, ones).tolist() == [0.0]
    assert vlad_cosine(ones, zero).tolist() == [0.0]


@pytest.mark.parametrize("dist_mode", ["cosine", "euclidean"])
def test_k1_hard_label_agreement_explains_only_near_ties(dist_mode):
    """A token placed on an exact tie between two unit centers may take
    either label (the kernel's f32 sums run in another order than the
    plain version's): a result with the other label is explained by one
    flip. A flip away from a tie is not explained."""
    rng = np.random.default_rng(15)
    d = 64
    centers = rng.standard_normal((4, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    descs = rng.standard_normal((1, 40, d))
    descs[0, 7] = centers[1] + centers[2]                     # equidistant from 1 and 2
    descs = torch.from_numpy(descs.astype(np.float32))
    centers = torch.from_numpy(centers.astype(np.float32))
    kw = dict(dist_mode=dist_mode)
    want = vlad_aggregate_fused_ref(descs, centers, **kw)
    x = descs / descs.norm(dim=-1, keepdim=True)
    labels = (x @ centers.T).argmax(-1)       # unit centers: one argmax away from ties
    for lab in (1, 2):                         # the plain version's pick on the tie
        labels[0, 7] = lab
        if torch.equal(vlad_aggregate_fused_ref(descs, centers, labels=labels, **kw), want):
            break
    else:
        raise AssertionError("the plain version labels the tie neither 1 nor 2")
    tie_flip = labels.clone()
    tie_flip[0, 7] = 3 - labels[0, 7]
    got = vlad_aggregate_fused_ref(descs, centers, labels=tie_flip, **kw)
    raw, best, flips, ties = hard_label_agreement(got, descs, centers, **kw)
    assert ties[0] >= 1 and flips[0] == 1
    assert raw[0] < 0.9999 and best[0] > 1 - 1e-12
    far = labels.clone()
    far[0, 3] = (labels[0, 3] + 1) % 4                        # token 3 sits on no tie
    got = vlad_aggregate_fused_ref(descs, centers, labels=far, **kw)
    raw, best, flips, _ = hard_label_agreement(got, descs, centers, **kw)
    assert flips[0] == 0 and best[0] == raw[0] < 0.9999


# ---------------------------------------------------------------- K2 (attention)

@pytest.mark.parametrize("hd", [16, 80])         # 80: MAE-H / ImageBind-H / SAM-H heads
@pytest.mark.parametrize("variant", ["flash_attention", "heads", "blocked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_flash_attention_matches_pallas(variant, dtype, hd):
    rng = np.random.default_rng(21)
    b, h, n = 2, 4, 57                   # 57: not a multiple of 16
    q, k, v = (rng.standard_normal((b, h, n, hd)).astype(np.float32) for _ in range(3))
    jq, jk, jv = (_jnp(a, dtype) for a in (q, k, v))
    if variant == "flash_attention":
        want = jax_flash_attention(jq, jk, jv, interpret=True)
    elif variant == "heads":
        want = jax_flash_attention_heads(jq, jk, jv, head_chunk=2, interpret=True)
    else:
        want = jax_flash_attention_blocked(jq, jk, jv, block_q=32, block_k=32,
                                           interpret=True)
    got = flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype))
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(_np(got), _np(want), atol=tol)


def test_k2_takes_strided_head_views():
    """The trunk's long-N route hands K2 head-split views of the fused qkv
    tensor; the result must equal the contiguous call."""
    rng = np.random.default_rng(22)
    b, n, h, hd = 1, 30, 2, 16
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h * hd)).astype(np.float32))
    d = h * hd
    views = [qkv[..., i * d:(i + 1) * d].view(b, n, h, hd).transpose(1, 2) for i in range(3)]
    got = flash_attention(*views)
    want = flash_attention(*[t.contiguous() for t in views])
    torch.testing.assert_close(got, want, atol=0, rtol=0)


# ---------------------------------------------------------------- K5 (qkv + proj)

@pytest.mark.parametrize("hd", [16, 80])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [8, 13])           # aligned and ragged
def test_k5_qkv_proj_matches_pallas(dtype, n, hd):
    rng = np.random.default_rng(51)
    b, h = 2, 4
    d = h * hd
    qkv = rng.standard_normal((b, n, 3 * d)).astype(np.float32)
    wp = (rng.standard_normal((d, d)) * 0.1).astype(np.float32)
    bp = (rng.standard_normal((d,)) * 0.1).astype(np.float32)
    gamma = (rng.standard_normal((d,)) * 0.5).astype(np.float32)
    res = (rng.standard_normal((b, n, d)) * 0.5).astype(np.float32)
    want = jax_qkv_proj(_jnp(qkv, dtype), _jnp(wp, dtype), jnp.asarray(bp),
                        num_heads=h, layerscale=jnp.asarray(gamma),
                        residual=_jnp(res, dtype), head_chunk=2, interpret=True)
    got = flash_attention_qkv_proj(
        _t(qkv, dtype), _t(wp, dtype), torch.from_numpy(bp), num_heads=h,
        layerscale=torch.from_numpy(gamma), residual=_t(res, dtype))
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(_np(got), _np(want), atol=tol)


def test_k5_without_epilogue_matches_pallas():
    rng = np.random.default_rng(52)
    b, n, h, hd = 1, 12, 8, 8
    d = h * hd
    qkv = rng.standard_normal((b, n, 3 * d)).astype(np.float32)
    wp = (rng.standard_normal((d, d)) * 0.1).astype(np.float32)
    want = jax_qkv_proj(jnp.asarray(qkv), jnp.asarray(wp), num_heads=h,
                        head_chunk=8, interpret=True)
    got = flash_attention_qkv_proj(torch.from_numpy(qkv), torch.from_numpy(wp),
                                   num_heads=h)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL)


def test_wrappers_refuse_mixed_devices():
    """A tensor off the CPU never takes the plain path silently."""
    q = torch.zeros(1, 1, 4, 16)
    with pytest.raises(ValueError):
        flash_attention(q, q.to("meta"), q)
