"""The plain versions of K2's and K5's backward kernels
(``flash_attention_bwd_ref``, ``flash_attention_qkv_proj_bwd_ref``, with
the kernels' arguments: the saved output, each query row's log-sum-exp and,
for K5, the projection before LayerScale) on the CPU:

  * against ``jax.vjp`` of the JAX package's XLA attention route
    (``anyloc_tpu/ops/pallas/flash_attention.py::xla_attention``), for K5
    composed with the projection, bias, LayerScale and residual in jnp, in
    float32: within 1e-5 of each gradient's largest |value|;
  * against the port's plain versions' autograd (what ``FlashAttentionGrad``
    and ``QkvProjGrad`` run on CPU tensors): float32 within 1e-5 of the
    largest |g|; bfloat16 by ``train_checks.bf16_errors``, the bound the card
    tests hold the kernels to: within 2.5e-3 of the largest |g| beyond one
    bf16 rounding step (the backward mirrors the plain version's rounding
    points but sums in another order, so a final rounding may land one step
    apart), and an L2 distance from the float64 gradient of the same inputs
    no more than 1.25x the plain version's own.

Inputs are made from numpy seeds; N 1, 9, 33 and 65 cover one key, fewer
keys than one block and ragged key blocks (the kernels mask the keys past N
of their last 64-key block); the head dims are every one the route table
names (16, 32, 64, 80, 128) and 8.

The route table of the attention backward (which kernel each head dim and
dtype runs) and its Python mirror are held to a table written here and to
the CUDA source; the dq scratch's slices to a hand count; and each routed
block's shared memory, mirrored from the tile constants, to the 227 KB a
block may use on the H100.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anyloc_tpu.ops.pallas.flash_attention import xla_attention

from anyloc_tpu_torch.ops import kernels as K
from anyloc_tpu_torch.ops.kernels.attn_proj import _split_heads
from anyloc_tpu_torch.ops.kernels.flash_attention import (
    BWD_KEYS,
    BWD_MIN_GRID,
    attention_bwd_route,
    attention_bwd_slices,
    attention_bwd_smem,
)
from anyloc_tpu_torch.tools.train_checks import BF16_BOUND, BF16_RATIO, attention64, bf16_errors

torch.set_num_threads(2)

F32_BOUND = 1e-5
SHAPES = [(2, 2, 1, 8), (2, 4, 9, 16), (2, 3, 65, 16), (2, 2, 65, 80), (2, 2, 65, 32),
          (2, 2, 33, 64), (2, 1, 65, 128)]


def _arrays(shape, n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * scale).astype(np.float32) for _ in range(n)]


def _rel(got, want, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    s = np.abs(want).max() if scale is None else scale
    return np.abs(got - want).max() / max(s, 1e-30)


def _scales(wants):
    """Each gradient's largest |value|; a gradient that is zero (one key:
    q and k have none) takes the largest of the others."""
    top = max(np.abs(np.asarray(w, np.float64)).max() for w in wants)
    return [np.abs(np.asarray(w, np.float64)).max() or top for w in wants]


def _lse(q, k, scale, prescale):
    qf, kf = q.float(), k.float()
    if prescale:
        s = (qf * scale).to(q.dtype).float() @ kf.transpose(-1, -2)
    else:
        s = (qf @ kf.transpose(-1, -2)) * scale
    return torch.logsumexp(s, dim=-1)


def _k2_inputs(shape, seed, dtype):
    q, k, v, g = (torch.from_numpy(a).to(dtype) for a in _arrays(shape, 4, seed))
    return q, k, v, g


def _k2_ref_grads(q, k, v, g, scale):
    """The plain backward with O and the log-sum-exp of the plain forward."""
    with torch.no_grad():
        o = K.flash_attention_ref(q, k, v, scale=scale)
        return K.flash_attention_bwd_ref(q, k, v, o, _lse(q, k, scale, False), g, scale=scale)


def _k2_autograd(q, k, v, g, scale, fn=K.flash_attention_ref):
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    return torch.autograd.grad(fn(*leaves, scale=scale), leaves, g)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k2_backward_ref_matches_jax_vjp(shape):
    hd = shape[-1]
    scale = hd ** -0.5
    arrs = _arrays(shape, 4, seed=1)
    _, vjp = jax.vjp(lambda q, k, v: xla_attention(q, k, v, scale=scale),
                     *map(jnp.asarray, arrs[:3]))
    want = vjp(jnp.asarray(arrs[3]))
    got = _k2_ref_grads(*(torch.from_numpy(a) for a in arrs), scale)
    for name, a, w, s in zip("qkv", got, want, _scales(want)):
        assert _rel(a.numpy(), w, s) <= F32_BOUND, name


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k2_backward_ref_matches_the_plain_autograd_f32(shape):
    scale = 0.3
    q, k, v, g = _k2_inputs(shape, 2, torch.float32)
    got = _k2_ref_grads(q, k, v, g, scale)
    want = _k2_autograd(q, k, v, g, scale)
    for name, a, w, s in zip("qkv", got, want, _scales([w.numpy() for w in want])):
        assert _rel(a.numpy(), w.numpy(), s) <= F32_BOUND, name


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k2_backward_ref_bf16_mirrors_the_plain_rounding(shape):
    scale = shape[-1] ** -0.5
    q, k, v, g = _k2_inputs(shape, 3, torch.bfloat16)
    got = _k2_ref_grads(q, k, v, g, scale)
    want = _k2_autograd(q, k, v, g, scale)
    exact = _k2_autograd(q.double(), k.double(), v.double(), g.double(), scale, attention64)
    for name, a, w, x in zip("qkv", got, want, exact):
        r = bf16_errors(a, w, x)
        assert r["err"] <= BF16_BOUND and r["ratio"] <= BF16_RATIO, (name, r)


def _k5_inputs(b, n, h, hd, seed, dtype, ls=True):
    d = h * hd
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    return dict(qkv=r(b, n, 3 * d).to(dtype), w_proj=r(d, d, scale=d ** -0.5).to(dtype),
                b_proj=r(d, scale=0.1), layerscale=r(d, scale=0.5) if ls else None,
                residual=r(b, n, d).to(dtype)), r(b, n, d).to(dtype)


def _k5_saved(inputs, h, scale):
    """What the forward kernel keeps under autograd, from plain ops: the
    heads' outputs o, each row's log-sum-exp, the projection before
    LayerScale."""
    qkv, w, bias = inputs["qkv"], inputs["w_proj"], inputs["b_proj"]
    b, n, three_d = qkv.shape
    d = three_d // 3
    q, k, v = _split_heads(qkv, h)
    wide = torch.float64 if qkv.dtype == torch.float64 else torch.float32
    with torch.no_grad():
        qe = (q.to(wide) * scale).to(qkv.dtype).to(wide)
        s = qe @ k.to(wide).transpose(-1, -2)
        p = torch.softmax(s, dim=-1)
        o = (p.to(qkv.dtype).to(wide) @ v.to(wide)).to(qkv.dtype)
        o = o.transpose(1, 2).reshape(b, n, d)
        pre = o.to(wide) @ w.to(wide) + bias if inputs["layerscale"] is not None else None
        return o, torch.logsumexp(s, dim=-1).float(), pre


def _k5_ref_grads(inputs, grad, h, scale):
    o, lse, pre = _k5_saved(inputs, h, scale)
    with torch.no_grad():
        return K.flash_attention_qkv_proj_bwd_ref(
            grad, inputs["qkv"], inputs["w_proj"], inputs["b_proj"], inputs["layerscale"], o,
            lse, pre, num_heads=h, scale=scale)


def _k5_autograd(inputs, grad, h, scale):
    leaves = {k: None if v is None else v.detach().requires_grad_(True)
              for k, v in inputs.items()}
    out = K.flash_attention_qkv_proj_ref(num_heads=h, scale=scale, **leaves)
    names = [k for k, v in leaves.items() if v is not None]
    return names, torch.autograd.grad(out, [leaves[k] for k in names], grad)


K5_SHAPES = [(2, 1, 2, 8, True), (2, 9, 4, 16, False), (2, 65, 2, 16, True),
             (2, 65, 2, 80, True), (2, 65, 2, 32, False), (2, 33, 2, 64, True),
             (2, 65, 1, 128, False)]


@pytest.mark.parametrize("b,n,h,hd,ls", K5_SHAPES,
                         ids=lambda v: str(v) if not isinstance(v, bool) else ("ls" if v else "-"))
def test_k5_backward_ref_matches_jax_vjp(b, n, h, hd, ls):
    d = h * hd
    scale = hd ** -0.5
    inputs, grad = _k5_inputs(b, n, h, hd, 4, torch.float32, ls)

    def route(qkv, w, bias, gamma, res):
        q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, n, h, hd).transpose(0, 2, 1, 3)
                   for i in range(3))
        o = xla_attention(q, k, v, scale=scale).transpose(0, 2, 1, 3).reshape(b, n, d)
        out = o @ w + bias
        return (out * gamma if ls else out) + res

    names = ["qkv", "w_proj", "b_proj", "layerscale", "residual"]
    args = [jnp.asarray(inputs[k].numpy()) if inputs[k] is not None else jnp.ones(d)
            for k in names]
    _, vjp = jax.vjp(route, *args)
    want = vjp(jnp.asarray(grad.numpy()))
    got = _k5_ref_grads(inputs, grad, h, scale)
    for name, a, w in zip(names, got, want):
        if inputs[name] is None:
            assert a is None, name
            continue
        assert _rel(a.numpy(), w) <= F32_BOUND, name


@pytest.mark.parametrize("b,n,h,hd,ls", K5_SHAPES,
                         ids=lambda v: str(v) if not isinstance(v, bool) else ("ls" if v else "-"))
def test_k5_backward_ref_matches_the_plain_autograd_f32(b, n, h, hd, ls):
    scale = hd ** -0.5
    inputs, grad = _k5_inputs(b, n, h, hd, 5, torch.float32, ls)
    got = dict(zip(["qkv", "w_proj", "b_proj", "layerscale", "residual"],
                   _k5_ref_grads(inputs, grad, h, scale)))
    names, want = _k5_autograd(inputs, grad, h, scale)
    assert {k for k, v in got.items() if v is not None} == set(names)
    for name, w in zip(names, want):
        assert _rel(got[name].numpy(), w.numpy()) <= F32_BOUND, name


@pytest.mark.parametrize("b,n,h,hd,ls", K5_SHAPES,
                         ids=lambda v: str(v) if not isinstance(v, bool) else ("ls" if v else "-"))
def test_k5_backward_ref_bf16_mirrors_the_plain_rounding(b, n, h, hd, ls):
    scale = hd ** -0.5
    inputs, grad = _k5_inputs(b, n, h, hd, 6, torch.bfloat16, ls)
    got = dict(zip(["qkv", "w_proj", "b_proj", "layerscale", "residual"],
                   _k5_ref_grads(inputs, grad, h, scale)))
    names, want = _k5_autograd(inputs, grad, h, scale)
    wide = {k: None if v is None else v.double() for k, v in inputs.items()}
    _, exact = _k5_autograd(wide, grad.double(), h, scale)
    for name, w, x in zip(names, want, exact):
        r = bf16_errors(got[name], w, x)
        bound = BF16_BOUND if w.dtype == torch.bfloat16 else F32_BOUND
        assert r["err"] <= bound and r["ratio"] <= BF16_RATIO, (name, r)


def test_backward_wrappers_on_cpu_tensors_take_their_plain_versions():
    """On CPU tensors the backward wrappers return their plain versions'
    results (``needs`` masks K5's), and no launch is counted."""
    before = K.launch_counts()
    q, k, v, g = _k2_inputs((2, 2, 9, 16), 7, torch.float32)
    o = K.flash_attention_ref(q, k, v)
    lse = _lse(q, k, 0.25, False)
    for a, w in zip(K.flash_attention_bwd(q, k, v, o, lse, g, scale=0.25),
                    K.flash_attention_bwd_ref(q, k, v, o, lse, g, scale=0.25)):
        assert torch.equal(a, w)
    inputs, grad = _k5_inputs(2, 9, 2, 16, 8, torch.float32)
    o, lse, pre = _k5_saved(inputs, 2, 0.25)
    args = (grad, inputs["qkv"], inputs["w_proj"], inputs["b_proj"], inputs["layerscale"], o,
            lse, pre)
    want = K.flash_attention_qkv_proj_bwd_ref(*args, num_heads=2, scale=0.25)
    got = K.flash_attention_qkv_proj_bwd(*args, num_heads=2, scale=0.25,
                                         needs=(True, False, True, False, True))
    assert got[1] is None and got[3] is None
    for i in (0, 2, 4):
        assert torch.equal(got[i], want[i])
    assert K.launch_counts() == before
    assert {"K2b_flash_attention_bwd", "K5b_flash_attention_qkv_proj_bwd",
            "Kab_attention_bwd_wgmma", "Kab_attention_bwd_split"} <= set(before)
    assert not any("mma_sync" in name for name in before)


PROJ_SHAPES = [(2, 1, 32, 16, True), (2, 9, 64, 24, False), (3, 65, 40, 136, True)]


@pytest.mark.parametrize("b,n,d,d_out,ls", PROJ_SHAPES,
                         ids=lambda v: str(v) if not isinstance(v, bool) else ("ls" if v else "-"))
@pytest.mark.parametrize("needs", [(True,) * 4, (True, False, True, False),
                                   (False, True, False, True)], ids=["all", "o-b", "w-ls"])
def test_projection_backward_on_cpu_matches_jax_vjp(b, n, d, d_out, ls, needs):
    """K5's projection backward alone (``qkv_proj_bwd``; on CPU tensors its
    plain version) against ``jax.vjp`` of (o·W + b)·γ + residual in jnp, in
    float32: d_o, d_W, d_b and d_γ within 1e-5 of each one's largest
    |value|; what ``needs`` leaves out is None."""
    from anyloc_tpu_torch.ops.kernels.attn_proj import qkv_proj_bwd

    o, grad, res = (torch.from_numpy(a) for a in _arrays((b, n, d), 1, 30) +
                    _arrays((b, n, d_out), 2, 31))
    w, = (torch.from_numpy(a) for a in _arrays((d, d_out), 1, 32, scale=d ** -0.5))
    bias, gamma = (torch.from_numpy(a) for a in _arrays((d_out,), 2, 33, scale=0.5))
    gamma = gamma if ls else None
    pre = o @ w + bias if ls else None

    def proj(o_, w_, b_, g_):
        out = o_ @ w_ + b_
        return (out * g_ if ls else out) + jnp.asarray(res.numpy())

    _, vjp = jax.vjp(proj, *(jnp.asarray(t.numpy()) for t in (o, w, bias)),
                     jnp.ones(d_out) if gamma is None else jnp.asarray(gamma.numpy()))
    want = vjp(jnp.asarray(grad.numpy()))
    got = qkv_proj_bwd(grad, w, bias, gamma, o, pre, needs=needs)
    for name, a, wt, need in zip(("d_o", "d_w", "d_b", "d_ls"), got, want, needs):
        if not need or (name == "d_ls" and not ls):
            assert a is None, name
            continue
        assert _rel(a.numpy(), wt) <= F32_BOUND, name


F64_PROJ = [(2, 9, 32, 32, False), (2, 33, 48, 96, True)]
F64_K5 = [(2, 33, 2, 16, False), (2, 65, 2, 32, True)]


@pytest.mark.parametrize("b,n,d,d_out,ls", F64_PROJ, ids=str)
def test_projection_backward_float64_helper_on_cpu(b, n, d, d_out, ls):
    """``train_checks.proj_bwd_float64_errors`` on CPU tensors: the plain
    version on both sides, each of d_o, d_W, d_b (and d_γ with LayerScale)
    a float32 result held to the float64 plain version of the same inputs:
    within the bound, and off float64 by float32's own rounding only."""
    from anyloc_tpu_torch.tools import train_checks

    errs = train_checks.proj_bwd_float64_errors(b, n, d, d_out, layerscale=ls, seed=n,
                                                device="cpu")
    assert list(errs) == ["d_o", "d_w", "d_b", "d_ls"][:4 if ls else 3]
    for name, e in errs.items():
        assert e["ok"] and e["kernel"] == e["plain"], (name, e)
        assert 0 < e["plain"] < F32_BOUND, (name, e)


@pytest.mark.parametrize("b,n,h,hd,ls", F64_K5, ids=str)
def test_k5_gradient_float64_helper_on_cpu(b, n, h, hd, ls):
    """``train_checks.k5_gradient_float64_errors`` on CPU tensors: K5 under
    autograd (the plain versions here) and the plain version's autograd in
    float32, every input's gradient against the float64 autograd of the
    same inputs: within the bound, off float64 by float32's rounding only
    (the residual's gradient is the output gradient itself: exact)."""
    from anyloc_tpu_torch.tools import train_checks

    errs = train_checks.k5_gradient_float64_errors(b, n, h, hd, layerscale=ls, seed=n,
                                                   device="cpu")
    names = ["qkv", "w_proj", "b_proj"] + (["layerscale"] if ls else []) + ["residual"]
    assert list(errs) == names
    for name, e in errs.items():
        assert e["ok"], (name, e)
        if name == "residual":
            assert e["kernel"] == e["plain"] == 0.0
        else:
            assert 0 < e["plain"] < F32_BOUND and e["kernel"] < F32_BOUND, (name, e)


# ---------------------------------------------------------------- the route table

# the attention backward's kernels for each (head dim, dtype), written out:
# the wgmma kernel everywhere but hd 128 in float32, whose resident K, V and
# K^T in hi and lo would not leave room for a query tile in a block; that
# pair takes the split route (the wgmma kernel without dQ, then the
# query-major dQ kernel). No pair is left on mma.sync.
ROUTES = {(hd, dt): ("split" if (hd, dt) == (128, torch.float32) else "wgmma")
          for hd in (16, 32, 64, 80, 128) for dt in (torch.float32, torch.bfloat16)}
CUH = Path(K.__file__).resolve().parents[2] / "csrc" / "flash_attention_bwd.cuh"
SMEM_LIMIT = 232448   # a block's shared memory on the H100 (227 KB)


@pytest.mark.parametrize("hd,dtype", sorted(ROUTES, key=str), ids=lambda x: str(x))
def test_attention_bwd_route_mirror_matches_the_table(hd, dtype):
    """The Python mirror of the route table (``attention_bwd_route``) gives
    each (head dim, dtype) the kernel the table above names."""
    assert attention_bwd_route(hd, dtype) == ROUTES[hd, dtype]


def test_attention_bwd_route_table_matches_the_cuda_source():
    """The CUDA route table (``attention_bwd_route`` of
    ``csrc/flash_attention_bwd.cuh``) sends hd 128 in f32 to the split route
    and every other pair to the wgmma kernel, with no mma.sync route or
    kernel left in the source, and the tile constants the Python mirrors
    read are the source's: the query step, the tiles' bytes, where Q and dO
    land in place, what the wgmma kernel leaves out without dQ, the dQ
    kernel's tiles."""
    src = CUH.read_text()
    body = src[src.index("constexpr int attention_bwd_route("):]
    body = body[:body.index("}")]
    assert "dtype == DT_F32 && hd == 128 ? BWD_SPLIT : BWD_WGMMA" in body
    assert "enum { BWD_WGMMA = 1, BWD_SPLIT = 2 };" in src
    for gone in ("mma.sync.aligned", "attn_bwd_kernel", "BwdTile", "BWD_MMA_SYNC",
                 "launch_attention_bwd_mma_sync"):
        assert gone not in src, gone
    for line in ("constexpr int BWD_KEYS = 64;", "constexpr int BWD_MIN_GRID = 512;",
                 "static constexpr int BKV = 64, BQ = HD == 128 ? 16 : 32;",
                 "static constexpr int MIN_BLOCKS = HD == 16 ? 2 : 1;",
                 "static constexpr int KTILE = BKV * HD * 4;",
                 "static constexpr int QTILE = BQ * HD * 4;",
                 "static constexpr int Q_ = KT_ + (DQ ? COPIES * KTILE : 0);",
                 "static constexpr int LAND_ = S_ + (DQ ? 2 * STILE : 0);",
                 "static constexpr bool IN_PLACE = LAND_ + 4 * LAND + 2 * BQ * 4 + 10 * 8 + 1024 > "
                 "232448;",
                 "static constexpr int STAGES = IN_PLACE ? 1 : 2;",
                 "static constexpr int BAR_ = L_ + 2 * BQ * 4;",
                 "static constexpr int NBAR = 2 * STAGES + 6;",
                 # the split route's query-major dQ kernel
                 "static constexpr int BQM = 64, BKS = 16;",
                 "static constexpr int QTILE = BQM * HD * 4;",
                 "static constexpr int KTILE = BKS * HD * 4;",
                 "static constexpr int LAND_ = KT_ + 2 * KTILE;",
                 "static constexpr int BAR_ = LAND_ + STAGES * 2 * KTILE;",
                 "static constexpr int NBAR = 2 * STAGES + 5;",
                 "static constexpr int SMEM = BAR_ + NBAR * 8 + 1024;"):
        assert line in src, line
    assert src.count('static_assert(SMEM <= 232448, "a block\'s shared memory");') == 2
    assert (BWD_KEYS, BWD_MIN_GRID) == (64, 512)


# B, H, N -> the dq scratch slices, counted by hand: key blocks of 64, at
# least four groups, and B·H blocks alone under 512 keep more
SLICES = {(48, 6, 197): 4,      # 4 key blocks, 288 heads: a slice each
          (48, 12, 1370): 4,    # 22 key blocks in 4 groups of 6 (the last 4)
          (8, 16, 300): 3}      # 5 key blocks, 128 heads: 4 groups of 2 -> 3 slices


@pytest.mark.parametrize("b,h,n", sorted(SLICES))
def test_attention_bwd_slices_against_a_hand_count(b, h, n):
    assert attention_bwd_slices(b, h, n) == SLICES[b, h, n]


# a block's shared memory on the wgmma route, counted by hand from the
# tiles: K, V, K^T [64 x hd] per key block, Q, dO, Q^T, dO^T [step x hd]
# per step, all f32 (x2 for f32's hi and lo), dS hi and lo [step x 64], two
# landing stages of Q and dO in the input dtype, LSE and D, 10 mbarriers,
# 1 KB to align. f32 at hd 80, where the stages would take 263,504 bytes,
# lands Q and dO in place: 2·3·20480 + 4·2·10240 + 2·8192 + 256 + 8·8 + 1024
WGMMA_SMEM = {(16, torch.float32): 66896, (16, torch.bfloat16): 42320,
              (32, torch.float32): 116048, (32, torch.bfloat16): 66896,
              (64, torch.float32): 214352, (64, torch.bfloat16): 116048,
              (80, torch.float32): 222528, (80, torch.bfloat16): 140624,
              (128, torch.bfloat16): 156880}
# the split route's two kernels at hd 128 f32, counted by hand: the wgmma
# kernel without dQ keeps K, V [64 x 128] and Q, dO, Q^T, dO^T [16 x 128],
# hi and lo, two landing stages of Q and dO, LSE and D, 10 mbarriers, 1 KB:
# 2·2·32768 + 4·2·8192 + 2·2·8192 + 128 + 80 + 1024; the query-major dQ
# kernel Q, dO [64 x 128] and K, V, K^T [16 keys x 128], hi and lo, two
# landing stages of K and V, 9 mbarriers, 1 KB:
# 2·2·32768 + 3·2·8192 + 2·2·8192 + 72 + 1024
SPLIT_SMEM = {"attn_bwd_wgmma_kernel": 230608, "attn_bwd_dq_wgmma_kernel": 214088}


@pytest.mark.parametrize("hd,dtype", sorted(ROUTES, key=str), ids=lambda x: str(x))
def test_attention_bwd_tiles_fit_a_block(hd, dtype):
    """Each (head dim, dtype)'s blocks on its route fit the 227 KB a block
    may use (``attention_bwd_smem``, mirrored from the tile constants); on
    the wgmma route the block takes the bytes counted by hand above (hd 64:
    214,352 in f32, hi and lo of every tile, and 116,048 in bf16), and the
    split route's two kernels at hd 128 f32 230,608 and 214,088. At hd 16
    two wgmma blocks share an SM's 228 KB, each with the 1 KB the card keeps
    a block."""
    route = ROUTES[hd, dtype]
    smem = attention_bwd_smem(hd, dtype, route)
    assert all(n <= SMEM_LIMIT for n in smem.values())
    assert set(WGMMA_SMEM) == {key for key, r in ROUTES.items() if r == "wgmma"}
    assert smem == ({"attn_bwd_wgmma_kernel": WGMMA_SMEM[hd, dtype]} if route == "wgmma"
                    else SPLIT_SMEM)
    if hd == 16:
        assert 2 * (smem["attn_bwd_wgmma_kernel"] + 1024) <= 233472


@pytest.mark.parametrize("cases", [["k2"], ["vith", "k5fwd"], ["hds"], ["f27"], ["f28"], None,
                                   ["f29"], ["f29time"]],
                         ids=["k2", "vith-k5fwd", "hds", "f27", "f28", "default", "f29", "f29time"])
def test_bench_attention_bwd_refuses_without_a_card(cases):
    """``tools/bench_attention_bwd.py`` takes the cases it is given (k2, k5,
    vith and hds by default) and, with no CUDA card, raises before it times
    anything: a measurement never falls back to the CPU."""
    from anyloc_tpu_torch.tools import bench_attention_bwd as bench

    argv = [] if cases is None else ["--cases", *cases]
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench.main(argv)
    with pytest.raises(SystemExit):
        bench.main(["--cases", "nope"])
    assert bench.CASES == ("k2", "k5", "vith", "hds", "k5fwd", "f27", "f28", "f29", "f29time")
