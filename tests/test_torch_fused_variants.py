"""The port's block-variant kernels K6-K9 against the JAX package.

K9 ``fused_block_int8``, K7 ``fused_attn_half_bf16``, K8 ``fused_mlp_bf16``
and K6 ``attention_proj``: the same numpy-seeded inputs go to the Pallas
kernel in interpret mode and to the port's wrapper on CPU tensors (its
plain PyTorch version). The JAX side is unchanged.

F7: in interpret mode ``fused_block_int8`` ignores both chunk arguments and
quantizes the attention output and the MLP hidden per whole row (one head
chunk of all heads, one hidden chunk of HID), so those comparisons pass
``head_chunk=H, hidden_chunk=HID`` to the port. The TPU chunk rules are
held separately (``test_k9_chunk_rules_match_jax``) and through K4 and K3
(``test_k9_plain_is_k4_then_k3``).

Tolerances (stated per test, measured values in brackets):
* K9 in f32: rms_rel <= 1e-3, max abs <= 5e-2. As for K4
  (tests/test_torch_int8.py), the attention runs in bf16, so an int8 code
  of o flips where a bf16 rounding lands on the other side; in K9 that step
  then passes through LN2 and the MLP half [7e-8 / 1e-6 SwiGLU, 8e-4 /
  2.2e-2 GELU]. In bf16 the output's own rounding adds up to one ulp
  (2^-8 relative): rms_rel <= 3e-3, max abs <= 6.25e-2 [7e-4 / 2e-2];
* K6, K7, K8 in f32: rms_rel <= 1e-6, max abs <= 1e-5 (f32 sums in another
  order) [<= 3e-7 / 1.7e-6]; in bf16: rms_rel <= 1e-3, max abs <= 2e-2 (one
  bf16 ulp where an f32 sum in another order crosses a rounding boundary of
  g, xn or the output) [<= 6e-5 / 2e-3].
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from anyloc_tpu.ops import quant as jq
from anyloc_tpu.ops.pallas.attn_proj import attention_proj as jax_attention_proj
from anyloc_tpu.ops.pallas.attn_proj import fused_attn_half_bf16 as jax_attn_half_bf16
from anyloc_tpu.ops.pallas.fused_block import fused_block_int8 as jax_fused_block
from anyloc_tpu.ops.pallas.fused_mlp import fused_mlp_bf16 as jax_fused_mlp_bf16

from anyloc_tpu_torch.ops.kernels import (
    attention_proj,
    fused_attn_half_bf16,
    fused_attn_half_int8_ref,
    fused_block_int8,
    fused_block_int8_ref,
    fused_mlp_bf16,
    fused_mlp_int8_ref,
    launch_counts,
)

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FLOAT_TOL = {"float32": (1e-6, 1e-5), "bfloat16": (1e-3, 2e-2)}   # (rms_rel, max abs)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, dtype=np.float32) if a.dtype == jnp.bfloat16
                         else np.array(a, copy=True))
    return t if dtype is None else t.to(dtype)


def _check(got, want, rms_max, abs_max):
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(want, np.float32).astype(np.float64)
    assert got.shape == want.shape
    rms = float(np.sqrt(((got - want) ** 2).mean() / (want ** 2).mean()))
    err = float(np.abs(got - want).max())
    assert rms <= rms_max and err <= abs_max, (rms, err)


def _ln(rng, d):
    return ((1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
            (0.1 * rng.standard_normal(d)).astype(np.float32))


def _w(rng, k, n):
    return (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)


def _vec(rng, n, scale=0.1):
    return (scale * rng.standard_normal(n)).astype(np.float32)


# ---------------------------------------------------------------- K9

def _block_inputs(seed, d, hid, mlp_type):
    rng = np.random.default_rng(seed)
    two = 2 if mlp_type == "swiglu_fused" else 1
    wqkv, sqkv = jq.quantize_weight_cols(jnp.asarray(_w(rng, d, 3 * d)))
    wp, sp = jq.quantize_weight_cols(jnp.asarray(_w(rng, d, d)))
    w12, s12 = jq.quantize_weight_cols(jnp.asarray(_w(rng, d, two * hid)))
    w3, s3 = jq.quantize_weight_cols(jnp.asarray(_w(rng, hid, d)))
    attn_p = (wqkv, sqkv, _vec(rng, 3 * d), wp, sp, _vec(rng, d))
    mlp_p = (w12, s12, _vec(rng, two * hid), w3, s3, _vec(rng, d))
    kw = dict(ln1=_ln(rng, d), ln2=_ln(rng, d), gamma1=_vec(rng, d, 0.5),
              gamma2=_vec(rng, d, 0.5))
    return rng, attn_p, mlp_p, kw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mlp_type", ["swiglu_fused", "mlp"])
def test_k9_fused_block_matches_pallas(dtype, mlp_type):
    b, n, h, hd, hid = 2, 13, 2, 64, 256          # ragged N (the kernel pads to 16)
    d = h * hd
    rng, attn_p, mlp_p, kw = _block_inputs(90, d, hid, mlp_type)
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    jdt, pdt = DTYPES[dtype]
    want = jax_fused_block(
        jnp.asarray(x, jdt), tuple(jnp.asarray(a) for a in attn_p),
        tuple(jnp.asarray(a) for a in mlp_p), num_heads=h, mlp_type=mlp_type,
        ln1=tuple(map(jnp.asarray, kw["ln1"])), ln2=tuple(map(jnp.asarray, kw["ln2"])),
        gamma1=jnp.asarray(kw["gamma1"]), gamma2=jnp.asarray(kw["gamma2"]), interpret=True)
    before = launch_counts()
    got = fused_block_int8(
        _t(x, pdt), tuple(_t(np.asarray(a)) for a in attn_p),
        tuple(_t(np.asarray(a)) for a in mlp_p), num_heads=h, mlp_type=mlp_type,
        ln1=tuple(map(_t, kw["ln1"])), ln2=tuple(map(_t, kw["ln2"])),
        gamma1=_t(kw["gamma1"]), gamma2=_t(kw["gamma2"]), head_chunk=h, hidden_chunk=hid)
    assert launch_counts() == before      # CPU tensors never launch a kernel
    assert got.dtype == pdt and tuple(got.shape) == (b, n, d)
    _check(got, want, *((1e-3, 5e-2) if dtype == "float32" else (3e-3, 6.25e-2)))


def test_k9_plain_is_k4_then_k3():
    """In f32 the block is K4's plain version then K3's with the TPU chunk
    rules (head chunk by the score budget, hidden chunk 512 of 1024): only
    x2's rounding to x's dtype separates them, and in f32 there is none."""
    b, n, h, hd, hid = 2, 37, 4, 64, 1024
    d = h * hd
    rng, attn_p, mlp_p, kw = _block_inputs(91, d, hid, "swiglu_fused")
    x = _t(rng.standard_normal((b, n, d)).astype(np.float32))
    attn_p = tuple(_t(np.asarray(a)) for a in attn_p)
    mlp_p = tuple(_t(np.asarray(a)) for a in mlp_p)
    ln1, ln2 = tuple(map(_t, kw["ln1"])), tuple(map(_t, kw["ln2"]))
    g1, g2 = _t(kw["gamma1"]), _t(kw["gamma2"])
    got = fused_block_int8_ref(x, attn_p, mlp_p, num_heads=h, ln1=ln1, ln2=ln2, gamma1=g1,
                               gamma2=g2)
    x2 = fused_attn_half_int8_ref(x, *attn_p, num_heads=h, ln_params=ln1, layerscale=g1)
    want = fused_mlp_int8_ref(x2, *mlp_p, ln_params=ln2, layerscale=g2, residual=True)
    _check(got, want.numpy(), 1e-5, 1e-5)


def test_k9_keeps_x2_in_f32():
    """For a bf16 x the block's x2 is K4's plain version on the f32 x, not
    rounded to bf16 (what K9 adds over K4 -> K3); the wrapper on CPU tensors
    returns the same pair as the plain version."""
    b, n, h, hd, hid = 2, 13, 2, 64, 256
    d = h * hd
    rng, attn_p, mlp_p, kw = _block_inputs(92, d, hid, "swiglu_fused")
    x = _t(rng.standard_normal((b, n, d)).astype(np.float32), torch.bfloat16)
    attn_p = tuple(_t(np.asarray(a)) for a in attn_p)
    mlp_p = tuple(_t(np.asarray(a)) for a in mlp_p)
    kw = dict(num_heads=h, ln1=tuple(map(_t, kw["ln1"])), ln2=tuple(map(_t, kw["ln2"])),
              gamma1=_t(kw["gamma1"]), gamma2=_t(kw["gamma2"]))
    out, x2 = fused_block_int8_ref(x, attn_p, mlp_p, return_x2=True, **kw)
    want = fused_attn_half_int8_ref(x.float(), *attn_p, num_heads=h, ln_params=kw["ln1"],
                                    layerscale=kw["gamma1"])
    assert x2.dtype == torch.float32 and out.dtype == torch.bfloat16
    assert torch.equal(x2, want)
    assert (x2 == x2.to(torch.bfloat16).float()).float().mean().item() <= 1e-2
    got_out, got_x2 = fused_block_int8(x, attn_p, mlp_p, return_x2=True, **kw)
    assert torch.equal(got_out, out) and torch.equal(got_x2, x2)


def test_k9_chunk_rules_match_jax():
    """At DINOv2-G (24 heads of 64, SwiGLU 4096) the port's K9 takes the TPU
    kernel's head chunk for each N and hidden chunk 512; it refuses a head
    geometry with no 128-lane chunk, as the TPU wrapper does."""
    from anyloc_tpu.ops.pallas.attn_proj import _pick_int8_head_chunk as jax_head_rule
    from anyloc_tpu.ops.pallas.fused_mlp import _pick_hidden_chunk as jax_hidden_rule
    from anyloc_tpu_torch.ops.kernels.fused_block import _resolve

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    d, hid = 1536, 4096
    attn_p = (meta(d, 3 * d, dtype=torch.int8), meta(3 * d), None,
              meta(d, d, dtype=torch.int8), meta(d), None)
    for mlp_type, two in (("swiglu_fused", 2), ("mlp", 1)):
        mlp_p = (meta(d, two * hid, dtype=torch.int8), meta(two * hid), None,
                 meta(hid, d, dtype=torch.int8), meta(d), None)
        for n in (257, 485, 530, 730, 1216):
            *_, hc, mc = _resolve(meta(32, n, d), attn_p, mlp_p, 24, mlp_type, None, None)
            assert hc == jax_head_rule(n, 24, 64, None)
            assert mc == jax_hidden_rule(512, hid, mlp_type == "mlp")
    d = 96                                     # 2 heads of 48: no 128-lane head chunk
    attn_p = (meta(d, 3 * d, dtype=torch.int8), meta(3 * d), None,
              meta(d, d, dtype=torch.int8), meta(d), None)
    mlp_p = (meta(d, 256, dtype=torch.int8), meta(256), None, meta(128, d, dtype=torch.int8),
             meta(d), None)
    with pytest.raises(ValueError, match="geometry"):
        _resolve(meta(1, 5, d), attn_p, mlp_p, 2, "swiglu_fused", 2, 128)


# ---------------------------------------------------------------- K7

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k7_attn_half_bf16_matches_pallas(dtype):
    rng = np.random.default_rng(70)
    b, n, h, hd = 2, 13, 2, 64                 # ragged N
    d = h * hd
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    wqkv, wp = _w(rng, d, 3 * d), _w(rng, d, d)
    bq, bp, gamma = _vec(rng, 3 * d), _vec(rng, d), _vec(rng, d, 0.5)
    ln = _ln(rng, d)
    jdt, pdt = DTYPES[dtype]
    want = jax_attn_half_bf16(
        jnp.asarray(x, jdt), jnp.asarray(wqkv, jdt), jnp.asarray(bq), jnp.asarray(wp, jdt),
        jnp.asarray(bp), num_heads=h, ln_params=tuple(map(jnp.asarray, ln)),
        layerscale=jnp.asarray(gamma), interpret=True)
    before = launch_counts()
    got = fused_attn_half_bf16(
        _t(x, pdt), _t(wqkv, pdt), _t(bq), _t(wp, pdt), _t(bp), num_heads=h,
        ln_params=tuple(map(_t, ln)), layerscale=_t(gamma))
    assert launch_counts() == before
    assert got.dtype == pdt
    _check(got, want, *FLOAT_TOL[dtype])


# ---------------------------------------------------------------- K8

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mlp_type", ["swiglu_fused", "mlp"])
@pytest.mark.parametrize("epilogue", [True, False])
def test_k8_fused_mlp_bf16_matches_pallas(dtype, mlp_type, epilogue):
    """With ``epilogue``: LayerNorm, LayerScale and the residual; without:
    the bare MLP (+ b3)."""
    rng = np.random.default_rng(80)
    m, d, hid = 37, 128, 256
    two = 2 if mlp_type == "swiglu_fused" else 1
    x = rng.standard_normal((m, d)).astype(np.float32)
    w12, w3 = _w(rng, d, two * hid), _w(rng, hid, d)
    b12, b3, gamma = _vec(rng, two * hid), _vec(rng, d), _vec(rng, d, 0.5)
    ln = _ln(rng, d)
    jdt, pdt = DTYPES[dtype]
    jkw, pkw = {}, {}
    if epilogue:
        jkw = dict(ln_params=tuple(map(jnp.asarray, ln)), layerscale=jnp.asarray(gamma),
                   residual=True)
        pkw = dict(ln_params=tuple(map(_t, ln)), layerscale=_t(gamma), residual=True)
    want = jax_fused_mlp_bf16(
        jnp.asarray(x, jdt), jnp.asarray(w12, jdt), jnp.asarray(b12), jnp.asarray(w3, jdt),
        jnp.asarray(b3), mlp_type=mlp_type, hidden_chunk=128, interpret=True, **jkw)
    before = launch_counts()
    got = fused_mlp_bf16(_t(x, pdt), _t(w12, pdt), _t(b12), _t(w3, pdt), _t(b3),
                         mlp_type=mlp_type, hidden_chunk=128, **pkw)
    assert launch_counts() == before
    assert got.dtype == pdt
    _check(got, want, *FLOAT_TOL[dtype])


# ---------------------------------------------------------------- K6

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k6_attention_proj_matches_pallas(dtype):
    """N = 21 is no multiple of 16: the Pallas kernel pads and masks it, the
    port masks the ragged key tile."""
    rng = np.random.default_rng(60)
    b, h, n, hd, d_out = 2, 2, 21, 64, 96
    q, k, v = (rng.standard_normal((b, h, n, hd)).astype(np.float32) for _ in range(3))
    wp = _w(rng, h * hd, d_out)
    jdt, pdt = DTYPES[dtype]
    want = jax_attention_proj(*(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(wp, jdt),
                              interpret=True)
    before = launch_counts()
    got = attention_proj(*(_t(a, pdt) for a in (q, k, v)), _t(wp, pdt))
    assert launch_counts() == before
    assert got.dtype == pdt and tuple(got.shape) == (b, n, d_out)
    _check(got, want, *FLOAT_TOL[dtype])


# ---------------------------------------------------------------- wrappers and tools

def _refusals():
    d, h = 128, 2
    x = torch.zeros(1, 4, d)
    w = torch.zeros(d, 3 * d)
    ln = (torch.ones(d), torch.zeros(d))
    i8 = dict(dtype=torch.int8)
    attn_p = (torch.zeros(d, 3 * d, **i8), torch.ones(3 * d), None, torch.zeros(d, d, **i8),
              torch.ones(d), None)
    mlp_p = (torch.zeros(d, 512, **i8), torch.ones(512), None, torch.zeros(256, d, **i8),
             torch.ones(d), None)
    q = torch.zeros(1, h, 4, 64)
    return {
        "K6": lambda: attention_proj(q, q.to("meta"), q, torch.zeros(d, d)),
        "K7": lambda: fused_attn_half_bf16(x.to("meta"), w, None, torch.zeros(d, d), None,
                                           num_heads=h, ln_params=ln),
        "K8": lambda: fused_mlp_bf16(x, torch.zeros(d, 512).to("meta"), None,
                                     torch.zeros(256, d), None),
        "K9": lambda: fused_block_int8(x, attn_p, mlp_p[:3] + (mlp_p[3].to("meta"),) + mlp_p[4:],
                                       num_heads=h, ln1=ln, ln2=ln),
    }


@pytest.mark.parametrize("kernel", ["K6", "K7", "K8", "K9"])
def test_block_variant_wrappers_refuse_non_cpu_tensors_without_a_card(kernel):
    """A tensor off the CPU never takes the plain path; without a card (or on
    the meta device) the wrapper raises instead of launching."""
    before = launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        _refusals()[kernel]()
    assert launch_counts() == before


@pytest.mark.parametrize("tool", ["bench_fused_block", "bench_attn_half_bf16", "bench_attn_proj"])
def test_block_variant_tools_need_a_card(tool, monkeypatch):
    """The ported tools import without CUDA and raise rather than time the CPU."""
    import importlib

    mod = importlib.import_module(f"anyloc_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        mod.run()
    with pytest.raises(RuntimeError, match="CUDA card"):
        mod.main([])
