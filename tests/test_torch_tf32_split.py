"""The numerics of the port's float32 routes on the tensor cores (3xTF32).

The f32 GEMM (``csrc/bf16_gemm.cuh``'s ``OpTF32x3``) and the f32 flash
attention (``csrc/flash_attention.cuh``'s ``flash_attn_tf32x3_kernel``)
split each f32 operand x into hi = x rounded to tf32 (``cvt.rna.tf32.f32``:
10 explicit mantissa bits, nearest, ties away from zero) and lo = x - hi,
exact in f32, and sum lo·hi + hi·lo + hi·hi; the tensor core reads each
32-bit word as tf32, so lo loses its last 2 significant bits. V takes a
third piece (the rest) so that P V is exact where P is. This file emulates
those products in float64 on the CPU at K5's float32 geometries and holds
them to the port's float32 bound of 2e-5 absolute (``tests/test_torch_gpu.py``'s
``F32``), and shows that one tf32 product does not hold it, so a dropped
term would be caught. The tensor core's own f32 sums are not emulated: the
kernels keep them apart by size (hi·hi and the small products in separate
accumulators in the GEMM), and the card tests bound the whole.

The attention backward's wgmma kernel (``csrc/flash_attention_bwd.cuh``)
splits each operand once: K, V and K^T per key block, Q, dO, Q^T and dO^T
per query step, P^T in registers, and dS once (the same hi and lo feed dK
from registers and dQ^T from shared memory); its five products are
emulated here at a tensor-parallel rank's [4 x 6, 197, 64] heads.

K5's projection backward (``csrc/attn_qkv_proj_bwd.cu``) forms G' = G ∘ γ
in f32 before the split, runs d_o = G' W^T over the columns and d_W = o^T G'
over the rows in chunks (``proj_bwd_plan``), each chunk's f32 partial added
in chunk order; emulated here at K5's f32 widths.
"""

import numpy as np
import pytest
import torch

from anyloc_tpu_torch.ops.kernels.attn_proj import proj_bwd_plan

F32_BOUND = 2e-5


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> tf32 value (an f32 with the low 13 mantissa bits zero),
    rounded to nearest, ties away from zero, as ``cvt.rna.tf32.f32``."""
    bits = x.float().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_read(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core takes from an f32 word: its tf32 part."""
    return (x.float().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, x.float() - hi


def split3(x: torch.Tensor):
    hi = tf32_rna(x)
    r = x.float() - hi
    lo = tf32_rna(r)
    return hi, lo, r - lo


def mm64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.double() @ b.double()


def tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels compute it, the sums in float64."""
    ah, al = split(a)
    bh, bl = split(b)
    return mm64(tf32_read(al), bh) + mm64(ah, tf32_read(bl)) + mm64(ah, bh)


def tf32x3_v(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """P V as the attention kernel computes it: P in two pieces, V in three."""
    ph, pl = split(p)
    vh, vl, vr = split3(v)
    return mm64(tf32_read(pl), vh) + mm64(ph, vr) + mm64(ph, vl) + mm64(ph, vh)


def tf32x1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One tf32 product of the raw words (the dropped terms' route)."""
    return mm64(tf32_read(a), tf32_read(b))


def _randn(*shape, seed, scale=1.0):
    g = np.random.default_rng(seed)
    return torch.from_numpy((g.standard_normal(shape) * scale).astype(np.float32))


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got - want).abs().max().item()


def test_rna_rounds_to_nearest_ties_away():
    one = torch.tensor([1.0])
    ulp = 2.0 ** -10                                   # tf32's ulp at 1
    x = torch.tensor([1 + ulp / 2, 1 + ulp / 2 - 2 ** -23, -(1 + ulp / 2), 1 + 3 * ulp / 2])
    assert tf32_rna(x).tolist() == [1 + ulp, 1.0, -(1 + ulp), 1 + 2 * ulp]
    assert tf32_read(one + ulp * 0.99).item() == 1.0   # the raw word: truncated


# scales that keep every piece a normal f32: a library loaded earlier in
# the same test process may flush subnormals on the CPU (the card keeps them)
@pytest.mark.parametrize("scale", [1e-20, 1.0, 1e20])
def test_split_is_exact_and_in_tf32(scale):
    x = _randn(4096, seed=0, scale=scale)
    hi, lo = split(x)
    assert torch.equal(hi + lo, x)                     # x - hi is exact in f32
    assert torch.equal(tf32_read(hi), hi)
    h3, l3, r3 = split3(x)
    assert torch.equal(h3 + l3 + r3, x)
    for piece in (h3, l3, r3):
        assert torch.equal(tf32_read(piece), piece)    # three tf32 pieces, nothing lost


@pytest.mark.parametrize("k", [768, 1024, 1280])
def test_projection_within_the_f32_bound(k):
    """K5's projection o @ W_O at dvgl ViT-B/16 (768), CLIP-L (1024) and
    ImageBind-H (1280) widths: randn activations, weights of scale K^-0.5."""
    a = _randn(256, k, seed=1)
    w = _randn(k, 256, seed=2, scale=k ** -0.5)
    exact = mm64(a, w)
    assert _err(tf32x3(a, w), exact) <= F32_BOUND / 4
    assert _err(tf32x1(a, w), exact) > F32_BOUND


@pytest.mark.parametrize("hd", [64, 80])
def test_scores_within_the_f32_bound(hd):
    """S = (q hd^-0.5) k^T over 577 keys (CLIP-L/14@336px's sequence)."""
    q = (_randn(64, hd, seed=3) * hd ** -0.5).float()
    k = _randn(577, hd, seed=4)
    exact = mm64(q, k.t())
    assert _err(tf32x3(q, k.t()), exact) <= F32_BOUND / 4
    assert _err(tf32x1(q, k.t()), exact) > F32_BOUND


@pytest.mark.parametrize("hd", [64, 80])
def test_pv_within_the_f32_bound(hd):
    """O = P V over 577 keys, P a softmax row of scores of unit scale."""
    s = mm64(_randn(64, hd, seed=5) * hd ** -0.5, _randn(577, hd, seed=6).t())
    p = torch.softmax(s, dim=-1).float()
    v = _randn(577, hd, seed=7)
    exact = mm64(p, v)
    assert _err(tf32x3_v(p, v), exact) <= F32_BOUND / 4
    assert _err(tf32x1(p, v), exact) > F32_BOUND


def test_pv_is_exact_at_one_key():
    """One key: P = 1 and O must be V itself (the card test of a single
    token holds the kernel to exact equality); V's third piece gives it."""
    v = _randn(1, 128, seed=8)
    p = torch.ones(1, 1)
    assert torch.equal(tf32x3_v(p, v).float(), v)
    ph, pl = split(p)
    vh, vl = split(v)
    two = mm64(tf32_read(pl), vh) + mm64(ph, tf32_read(vl)) + mm64(ph, vh)
    assert not torch.equal(two.float(), v)               # two pieces of V lose its last bits


@pytest.mark.parametrize("one", [False, True], ids=["3xtf32", "one-tf32-product"])
def test_attention_backward_within_the_f32_bound(one):
    """The backward's five products (S^T = K Q^T, dP^T = V dO^T, dV = P^T
    dO, dK = dS^T Q, dQ^T = K^T dS^T) as the wgmma kernel computes them, the
    elementwise steps in f32, against the float64 gradient: every gradient
    within 2e-5 of its largest |value|; one tf32 product of the raw words
    instead falls outside it."""
    b, n, hd = 24, 197, 64
    scale = hd ** -0.5
    q, k, v, do = (_randn(b, n, hd, seed=10 + i) for i in range(4))
    prod = tf32x1 if one else tf32x3
    # float64 reference
    s64 = mm64(q, k.transpose(-1, -2)) * scale
    p64 = torch.softmax(s64, dim=-1)
    o64 = p64 @ v.double()
    dp64 = mm64(do, v.transpose(-1, -2))
    ds64 = p64 * (dp64 - (do.double() * o64).sum(-1, keepdim=True))
    want = (ds64 @ k.double() * scale, ds64.transpose(-1, -2) @ q.double() * scale,
            p64.transpose(-1, -2) @ do.double())
    # the kernel: key-major tiles (S^T rows are keys), f32 between products,
    # LSE and O as the forward kept them (f32)
    lse = torch.logsumexp(s64, dim=-1).float()
    st = prod(k, q.transpose(-1, -2)).float()
    pt = torch.exp(st * scale - lse[:, None, :])
    dpt = prod(v, do.transpose(-1, -2)).float()
    d = (do * o64.float()).sum(-1)
    dst = pt * (dpt - d[:, None, :])
    dv = prod(pt, do)
    dk = prod(dst, q) * scale
    dq = prod(k.transpose(-1, -2), dst).transpose(-1, -2) * scale
    errs = [_err(g, w) / w.abs().max().item() for g, w in zip((dq, dk, dv), want)]
    if one:
        assert max(errs) > F32_BOUND
    else:
        assert max(errs) <= F32_BOUND, errs


@pytest.mark.parametrize("one", [False, True], ids=["3xtf32", "one-tf32-product"])
@pytest.mark.parametrize("k,layerscale", [(768, False), (1024, True), (1280, False)])
def test_projection_backward_within_the_f32_bound(k, layerscale, one):
    """d_o = G' W^T and d_W = o^T G' as the persistent kernel computes them
    at dvgl ViT-B/16 (768, no LayerScale), CLIP-L (1024, with it) and
    ImageBind-H (1280) widths over 2400 rows (128 of D's rows, all of the
    reduction's): G' = G ∘ γ rounded to f32 before the split; d_W's chunks of
    ``proj_bwd_plan`` (4 at 768) summed in float64 inside a chunk, rounded
    to f32, then added in chunk order in f32. Each within 2e-5 of its
    largest |value| from the float64 products; one tf32 product falls
    outside."""
    m, d = 2400, 128
    grad = _randn(m, k, seed=20)
    gamma = _randn(k, seed=21, scale=0.5) if layerscale else None
    o = _randn(m, d, seed=22, scale=0.3)
    w = _randn(d, k, seed=23, scale=k ** -0.5)
    gp = grad * gamma if layerscale else grad          # f32, rounded once
    prod = tf32x1 if one else tf32x3
    d_o = prod(gp, w.t()).float()
    plan = proj_bwd_plan(m, d, k, 132)
    assert plan["chunks"] > 1
    d_w = None
    for c in range(plan["chunks"]):
        rows = slice(c * plan["chunk_rows"], min(m, (c + 1) * plan["chunk_rows"]))
        part = prod(o[rows].t(), gp[rows]).float()
        d_w = part if d_w is None else d_w + part       # f32 adds, chunk order
    errs = [_err(got, want) / want.abs().max().item()
            for got, want in ((d_o, mm64(gp, w.t())), (d_w, mm64(o.t(), gp)))]
    if one:
        assert max(errs) > F32_BOUND
    else:
        assert max(errs) <= F32_BOUND, errs


def test_bf16_o_needs_no_lo():
    """bf16 values are exact in tf32: their split's lo is 0, so in bf16's
    d_W the product that reads o's lo adds zeros (the kernel runs it, on the
    f32 path's code) and the three products sum to the two others."""
    o = _randn(512, 64, seed=24).to(torch.bfloat16).float()
    hi, lo = split(o)
    assert torch.equal(hi, o) and not lo.any()
    gp = _randn(512, 96, seed=25) * _randn(96, seed=26, scale=0.5)
    gh, gl = split(gp)
    two = mm64(hi.t(), tf32_read(gl)) + mm64(hi.t(), gh)
    assert torch.equal(two, tf32x3(o.t(), gp))
