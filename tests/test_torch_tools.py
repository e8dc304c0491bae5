"""The port's T1, T2 and T3 and the two tools that drive them, against the
JAX tools.

The JAX side is ``tools/bench_int8_matmul.py`` (``pallas_matmul``, T1;
``pallas_matmul_dequant``, T2) and ``tools/bench_xlayer.py``
(``attn_half_variant``, T3), loaded by file path (``tools/`` is no package)
and run under ``pltpu.force_tpu_interpret_mode()``; nothing of them changes.
The port's wrappers get the same numpy-seeded inputs as CPU tensors, so they
run their plain PyTorch versions.

Tolerances (measured values in brackets):
* T1 on int8 operands: exact, as int32 and converted to f32 or bf16; one
  case at K 4096 has sums past 2^24 (most of them no f32 value), which a
  product folded through f32 would round;
* T1 on bf16 or f32 operands, f32 out: atol 1e-4 + rtol 1e-5, f32 sums of
  exact products over K 256 in another order (values up to ~64) [3.4e-5]; bf16
  out: one bf16 ulp (at most 2^-7 of the value) where such a sum sits on a
  rounding boundary [exact];
* T2: one ulp of the output dtype (at most 2^-7 of the value in bf16,
  2^-22 in f32) [exact];
* T3's batched_dots: the only thing it changes is that o stays f32, which
  moves the output by about as much as the bound allows, so the port must
  sit at most half as far from the JAX batched_dots as from the JAX base
  [ratio <= 0.12], and its o must hold (almost) no bf16 values;
* T3: K4's bound (tests/test_torch_int8.py) in f32, rms_rel <= 1e-3 and
  max abs <= 1e-2: the attention runs in bf16, so an int8 code of o flips
  where a bf16 rounding lands on the other side [<= 4.5e-5 / 1.8e-3]; in
  bf16 the output's own rounding adds up to one ulp at |y| ~ 4, rms_rel <=
  3e-3 and max abs <= 6.25e-2 (K9's bf16 bound, tests/
  test_torch_fused_variants.py) [<= 2.6e-4 / 1.6e-2].
"""

import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from anyloc_tpu.ops import quant as jq

from anyloc_tpu_torch.ops.kernels import (
    attn_half_variant,
    attn_half_variant_proj_ref,
    fused_attn_half_int8_ref,
    launch_counts,
    matmul,
    matmul_dequant,
)

torch.set_num_threads(2)

TOOLS = Path(__file__).resolve().parent.parent / "tools"


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_mm():
    return _load_tool("bench_int8_matmul")


@pytest.fixture(scope="module")
def jax_xl():
    return _load_tool("bench_xlayer")


def _t(a, dtype=None):
    a = np.asarray(a)
    t = torch.from_numpy(a.astype(np.float32) if a.dtype == jnp.bfloat16 else a.copy())
    return t if dtype is None else t.to(dtype)


def _np64(a):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    return a.astype(np.float64)


def _int8(rng, *shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


# ---------------------------------------------------------------- T1, T2

M, K, N = 64, 256, 128


@pytest.mark.parametrize("tiles", [dict(bm=32, bn=64, bk=128), dict()])
def test_t1_int8_matches_pallas_exactly(jax_mm, tiles):
    rng = np.random.default_rng(1)
    a, b = _int8(rng, M, K), _int8(rng, K, N)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_mm.pallas_matmul(jnp.asarray(a), jnp.asarray(b), **tiles))
    before = launch_counts()
    got = matmul(_t(a), _t(b), **tiles)
    assert launch_counts() == before              # CPU tensors never launch a kernel
    assert got.dtype == torch.int32 and want.dtype == np.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, a.astype(np.int64) @ b.astype(np.int64))


def _int8_big_sums(rng, m, k, n):
    """int8 operands whose sums pass 2^24: |codes| 100..127 with one sign
    per row of a and per column of b, so every product of a sum shares its
    sign (|sum| ~ 5e7 at K 4096, where f32 values lie 4 apart)."""
    a = rng.integers(100, 128, (m, k)) * rng.choice([-1, 1], (m, 1))
    b = rng.integers(100, 128, (k, n)) * rng.choice([-1, 1], (1, n))
    return a.astype(np.int8), b.astype(np.int8)


@pytest.mark.parametrize("out_dtype", [None, "float32", "bfloat16"])
def test_t1_int8_is_exact_past_2_24(jax_mm, out_dtype):
    rng = np.random.default_rng(5)
    a, b = _int8_big_sums(rng, 32, 4096, 128)
    exact = a.astype(np.int64) @ b.astype(np.int64)
    assert np.abs(exact).min() > 2 ** 24
    assert (exact.astype(np.float32).astype(np.int64) != exact).mean() > 0.5
    jo = None if out_dtype is None else getattr(jnp, out_dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jax_mm.pallas_matmul(jnp.asarray(a), jnp.asarray(b), bk=512, out_dtype=jo)
    got = matmul(_t(a), _t(b), bk=512,
                 out_dtype=None if out_dtype is None else getattr(torch, out_dtype))
    if out_dtype is None:
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), exact)
    assert np.array_equal(_np64(got), _np64(want))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_t1_int8_out_dtype_matches_pallas_exactly(jax_mm, out_dtype):
    rng = np.random.default_rng(2)
    a, b = _int8(rng, M, K), _int8(rng, K, N)
    with pltpu.force_tpu_interpret_mode():
        want = jax_mm.pallas_matmul(jnp.asarray(a), jnp.asarray(b), bk=128,
                                    out_dtype=getattr(jnp, out_dtype))
    got = matmul(_t(a), _t(b), bk=128, out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    assert np.array_equal(_np64(got), _np64(want))


@pytest.mark.parametrize("dtype,out_dtype", [
    ("bfloat16", None), ("bfloat16", "bfloat16"), ("float32", None)])
def test_t1_float_matches_pallas(jax_mm, dtype, out_dtype):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    jo = None if out_dtype is None else getattr(jnp, out_dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jax_mm.pallas_matmul(jnp.asarray(a, getattr(jnp, dtype)),
                                    jnp.asarray(b, getattr(jnp, dtype)), bk=128, out_dtype=jo)
    got = matmul(_t(a, getattr(torch, dtype)), _t(b, getattr(torch, dtype)), bk=128,
                 out_dtype=None if out_dtype is None else getattr(torch, out_dtype))
    assert got.dtype == (torch.float32 if out_dtype is None else torch.bfloat16)
    g, w = _np64(got), _np64(want)
    if out_dtype is None:
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-5)
    else:
        assert (np.abs(g - w) <= 2.0 ** -7 * np.abs(w)).all()


@pytest.mark.parametrize("out_dtype,ulp", [("bfloat16", 2.0 ** -7), ("float32", 2.0 ** -22)])
def test_t2_matches_pallas(jax_mm, out_dtype, ulp):
    rng = np.random.default_rng(4)
    a, b = _int8(rng, M, K), _int8(rng, K, N)
    sa = (rng.random((M, 1)) * 0.01 + 1e-3).astype(np.float32)
    sb = (rng.random((1, N)) * 0.01 + 1e-3).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jax_mm.pallas_matmul_dequant(*map(jnp.asarray, (a, b, sa, sb)), bk=128,
                                            out_dtype=getattr(jnp, out_dtype))
    got = matmul_dequant(*map(_t, (a, b, sa, sb)), bk=128, out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    g, w = _np64(got), _np64(want)
    assert (np.abs(g - w) <= ulp * np.abs(w)).all()


@pytest.mark.parametrize("tile", [dict(bm=48), dict(bn=96), dict(bk=96)])
def test_tiles_that_leave_output_unwritten_are_refused(tile):
    """F8: the TPU kernels' grid (m // bm, n // bn, k // bk) skips the rows
    and columns past the last whole tile and the last partial K block; the
    port refuses such tiles instead of inventing an answer."""
    a, b = torch.zeros(M, K, dtype=torch.int8), torch.zeros(K, N, dtype=torch.int8)
    with pytest.raises(ValueError, match="F8"):
        matmul(a, b, **tile)
    with pytest.raises(ValueError, match="F8"):
        matmul_dequant(a, b, torch.ones(M, 1), torch.ones(1, N), **tile)


# ---------------------------------------------------------------- T3

D = 1536    # the JAX tool fixes 24 heads of 64


def _variant_inputs(seed, n, b=2):
    rng = np.random.default_rng(seed)
    np_pad = -(-n // 8) * 8
    x = rng.standard_normal((b, n, D)).astype(np.float32)
    wq, sq = jq.quantize_weight_cols(jnp.asarray((rng.standard_normal((D, 3 * D)) * D ** -0.5)
                                                 .astype(np.float32)))
    wp, sp = jq.quantize_weight_cols(jnp.asarray((rng.standard_normal((D, D)) * D ** -0.5)
                                                 .astype(np.float32)))
    ln = ((1 + 0.1 * rng.standard_normal((1, D))).astype(np.float32),
          (0.1 * rng.standard_normal((1, D))).astype(np.float32))
    gamma = (0.5 * rng.standard_normal((1, D))).astype(np.float32)
    xq_in = _int8(rng, b, np_pad, D)
    xs_in = (rng.random((b, np_pad, 1)) * 0.01 + 1e-3).astype(np.float32)
    return x, xq_in, xs_in, [np.asarray(w) for w in (wq, sq, wp, sp)], ln, gamma


def _port_variant(inputs, dtype, **knobs):
    x, xq_in, xs_in, (wq, sq, wp, sp), ln, gamma = inputs
    return attn_half_variant(_t(x, dtype), _t(xq_in), _t(xs_in), _t(wq), _t(sq), _t(wp), _t(sp),
                             tuple(map(_t, ln)), _t(gamma), **knobs)


MODES = {"base": dict(pre_quant=False, batched_dots=False),
         "pre_quant": dict(pre_quant=True, batched_dots=False),
         "batched_dots": dict(pre_quant=False, batched_dots=True)}


@pytest.mark.parametrize("mode,n,dtype", [
    *[(mode, n, "bfloat16") for mode in MODES for n in (16, 17)],   # N 16: no padded rows
    *[(mode, 17, "float32") for mode in MODES]])
def test_t3_attn_half_variant_matches_pallas(jax_xl, mode, n, dtype):
    inputs = _variant_inputs(30, n)
    x, xq_in, xs_in, (wq, sq, wp, sp), ln, gamma = inputs
    with pltpu.force_tpu_interpret_mode():
        want = jax_xl.attn_half_variant(
            jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(xq_in), jnp.asarray(xs_in),
            *map(jnp.asarray, (wq, sq, wp, sp)), tuple(map(jnp.asarray, ln)), jnp.asarray(gamma),
            **MODES[mode])
    before = launch_counts()
    got = _port_variant(inputs, getattr(torch, dtype), **MODES[mode])
    assert launch_counts() == before
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (2, n, D)
    g, w = _np64(got), _np64(want)
    rms = float(np.sqrt(((g - w) ** 2).mean() / (w ** 2).mean()))
    err = float(np.abs(g - w).max())
    rms_max, abs_max = (1e-3, 1e-2) if dtype == "float32" else (3e-3, 6.25e-2)
    assert rms <= rms_max and err <= abs_max, (rms, err)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_t3_batched_dots_keeps_o_in_f32(jax_xl, dtype):
    """batched_dots differs from base only in o's rounding, by about the
    size of the bound above: the port must sit clearly nearer the JAX
    batched_dots than the JAX base, its o must not be bf16 values (base's
    are), and its output must be the stages after the attention applied to
    that o."""
    inputs = _variant_inputs(33, 17)
    x, xq_in, xs_in, (wq, sq, wp, sp), ln, gamma = inputs
    want = {}
    for mode in ("base", "batched_dots"):
        with pltpu.force_tpu_interpret_mode():
            want[mode] = _np64(jax_xl.attn_half_variant(
                jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(xq_in), jnp.asarray(xs_in),
                *map(jnp.asarray, (wq, sq, wp, sp)), tuple(map(jnp.asarray, ln)),
                jnp.asarray(gamma), **MODES[mode]))
    got, o = _port_variant(inputs, getattr(torch, dtype), return_o=True, **MODES["batched_dots"])
    _, o_base = _port_variant(inputs, getattr(torch, dtype), return_o=True, **MODES["base"])
    g = _np64(got)

    def rms(w):
        return float(np.sqrt(((g - w) ** 2).mean() / (w ** 2).mean()))

    assert rms(want["batched_dots"]) <= 0.5 * rms(want["base"])
    assert (o == o.to(torch.bfloat16).float()).float().mean().item() <= 1e-2
    assert torch.equal(o_base, o_base.to(torch.bfloat16).float())
    assert torch.equal(got, attn_half_variant_proj_ref(_t(x, getattr(torch, dtype)), o, _t(wp),
                                                       _t(sp), _t(gamma)))


def test_t3_base_is_k4_without_biases():
    """The base variant is K4 with zero biases (+ 0 is exact): bit-equal to
    the port's K4 plain version with no biases."""
    inputs = _variant_inputs(31, 37)
    x, _, _, (wq, sq, wp, sp), ln, gamma = inputs
    got = _port_variant(inputs, torch.float32, **MODES["base"])
    want = fused_attn_half_int8_ref(
        _t(x), _t(wq), _t(sq), None, _t(wp), _t(sp), None, num_heads=D // 64,
        ln_params=(_t(ln[0]).ravel(), _t(ln[1]).ravel()), layerscale=_t(gamma).ravel())
    assert torch.equal(got, want)


def test_t3_pre_quant_reads_only_the_first_n_rows():
    """Only the first N pre-quantized rows of each image reach the output:
    the rows that pad an image to a multiple of 8 may hold anything."""
    inputs = _variant_inputs(32, 13)
    x, xq_in, xs_in, w, ln, gamma = inputs
    got = _port_variant(inputs, torch.float32, **MODES["pre_quant"])
    xq2, xs2 = xq_in.copy(), xs_in.copy()
    xq2[:, 13:] = 127
    xs2[:, 13:] = 1e3
    again = _port_variant((x, xq2, xs2, w, ln, gamma), torch.float32, **MODES["pre_quant"])
    assert torch.equal(got, again)


# ---------------------------------------------------------------- wrappers and tools

def _refusals():
    a = torch.zeros(M, K, dtype=torch.int8)
    x = torch.zeros(1, 4, 128)
    w = torch.zeros(128, 384, dtype=torch.int8)
    ln = (torch.ones(128), torch.zeros(128))
    return {
        "T1": lambda: matmul(a, a.t().contiguous().to("meta")),
        "T2": lambda: matmul_dequant(a, torch.zeros(K, N, dtype=torch.int8), torch.ones(M, 1),
                                     torch.ones(1, N).to("meta")),
        "T3": lambda: attn_half_variant(x.to("meta"), None, None, w, torch.ones(384),
                                        torch.zeros(128, 128, dtype=torch.int8), torch.ones(128),
                                        ln, None, pre_quant=False, batched_dots=False),
    }


@pytest.mark.parametrize("kernel", ["T1", "T2", "T3"])
def test_wrappers_refuse_non_cpu_tensors_without_a_card(kernel):
    """A tensor off the CPU never takes the plain path; without a card (or on
    the meta device) the wrapper raises instead of launching."""
    before = launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        _refusals()[kernel]()
    assert launch_counts() == before


@pytest.mark.parametrize("tool", ["bench_int8_matmul", "bench_xlayer", "vlad_near_ties"])
def test_tools_need_a_card(tool, monkeypatch):
    """The ported tools import without CUDA and raise rather than time the CPU."""
    mod = importlib.import_module(f"anyloc_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        mod.run()
    with pytest.raises(RuntimeError, match="CUDA card"):
        mod.main([])
