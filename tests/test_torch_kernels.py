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
)

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


# ---------------------------------------------------------------- K2 (attention)

@pytest.mark.parametrize("variant", ["flash_attention", "heads", "blocked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_flash_attention_matches_pallas(variant, dtype):
    rng = np.random.default_rng(21)
    b, h, n, hd = 2, 4, 57, 16           # 57: not a multiple of 16
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

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [8, 13])           # aligned and ragged
def test_k5_qkv_proj_matches_pallas(dtype, n):
    rng = np.random.default_rng(51)
    b, h, hd = 2, 4, 16
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
