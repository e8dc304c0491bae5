"""The attention halves of a trunk block at N <= ``MAX_FUSED_TOKENS``.

K5 — attention read straight from the fused qkv tensor, then the output
projection with bias, LayerScale and residual. Hand-written Hopper kernels
(``csrc/attn_qkv_proj.cu``, reusing K2's device attention code through
strided column views and the bf16 GEMM of ``csrc/bf16_gemm.cuh``) replacing
``anyloc_tpu/ops/pallas/attn_proj.py::flash_attention_qkv_proj`` (:327);
the bf16 trunk's attention half. Math (K5's rounding, which differs from
K2's): q * scale in f32, rounded to qkv's dtype, then f32-summed scores;
softmax in f32; P in v's dtype; each head's output rounded to v's dtype;
``o_cat @ w_proj`` summed in f32, + bias, * layerscale, + residual (read as
f32), cast to qkv's dtype.

K4 — the int8 W8A8 attention half (``csrc/attn_half_int8.cu``) replacing
``anyloc_tpu/ops/pallas/attn_proj.py::fused_attn_half_int8`` (:501); the
``int8_full`` trunk's attention half. Math (the Pallas kernel's): LN1 in
f32; per-row int8 quantize; ``qkv = (acc · x_scale) · w_scale + b`` in
f32, q times the softmax scale; q, k, v rounded to bf16; f32 scores,
softmax, P in bf16, each head's output in bf16; o requantized per (row,
head chunk); the projection accumulated chunk by chunk as
``(acc_j · o_scale_j) · w_scale``; ``+ b_proj``, ``· layerscale``, ``+ x``
(f32), cast to x's dtype. The attention is always bf16, whatever x's dtype.

The head chunk is the quantization group of K4's projection, so it is part
of the function: ``head_chunk=None`` takes the TPU kernel's rule
(``_pick_int8_head_chunk``), an explicit value is honoured as the largest
divisor of H not above it (the rule the TPU kernel uses in interpret mode).

K7 — the bf16 attention half (``csrc/attn_half_bf16.cu``) replacing
``anyloc_tpu/ops/pallas/attn_proj.py::fused_attn_half_bf16`` (:709): K4's
dataflow without quantization. Math: LN1 in f32, written in x's dtype;
``qkv = xn @ wqkv + b`` in f32, q times the softmax scale, each rounded
once to x's dtype; f32 scores, softmax, P and each head's output in x's
dtype; ``o_cat @ w_proj`` in f32, ``+ b_proj``, ``· layerscale``, ``+ x``,
cast to x's dtype.

K6 — attention + projection over head-split q/k/v
(``csrc/attention_proj.cu``) replacing
``anyloc_tpu/ops/pallas/attn_proj.py::attention_proj`` (:822): K5's
rounding (q · scale rounded to q's dtype) with no bias, LayerScale or
residual; output in q's dtype.

T3 — K4's stages with the two knobs of
``tools/bench_xlayer.py::attn_half_variant`` (:150;
``csrc/attn_half_variant.cu`` on K4's stages, ``csrc/attn_half_int8.cuh``):
zero biases (so the base variant is K4 without biases, bit for bit);
``pre_quant`` reads pre-quantized rows instead of LN1 + quantize;
``batched_dots`` keeps each head's output in f32 for the requantize.

K6, K7 and T3 are not wired into the trunk, as in the JAX package; the
tools (``anyloc_tpu_torch/tools/``) drive them. The K6/K7 head
chunk and ``skew`` only order f32 sums on the TPU: the wrappers accept and
ignore them (K7 still refuses a head geometry the TPU kernel refuses).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from anyloc_tpu_torch import _build
from anyloc_tpu_torch.ops.common import round_up
from anyloc_tpu_torch.ops.kernels import _launch
from anyloc_tpu_torch.ops.kernels.flash_attention import (
    SUPPORTED_HEAD_DIMS, attention_bwd_launch, attention_bwd_math)
from anyloc_tpu_torch.ops.kernels.fused_mlp import ln_rows, row_quant_scratch
from anyloc_tpu_torch.ops.quant import _int_mm, quantize_rows

# The TPU kernels' token bound (anyloc_tpu/ops/pallas/attn_proj.py:41); the
# trunk keeps the same routing: N <= this -> K5 (bf16) or K4 (int8_full),
# longer -> K2 between plain (or qdense) projections.
MAX_FUSED_TOKENS = 1216


def _pick_head_chunk(n: int, h: int, requested: Optional[int]) -> int:
    """Heads per chunk under the TPU kernels' ~6 MB f32 score budget,
    rounded down to a divisor of ``h`` (``attn_proj.py:214-228``)."""
    if requested is not None and requested < 1:
        raise ValueError(f"head_chunk must be >= 1, got {requested}")
    if requested is None:
        np_tok = round_up(n, 8)
        requested = max(1, min(h, (6 * 1024 * 1024) // (np_tok * np_tok * 4)))
    hc = min(requested, h)
    while h % hc:
        hc -= 1
    return hc


def _pick_int8_head_chunk(n: int, h: int, hd: int, requested: Optional[int]) -> Optional[int]:
    """The int8 TPU kernel's head chunk (``attn_proj.py:158-173``): the
    budget's chunk, moved to the nearest divisor of ``h`` whose width
    ``hc * hd`` is a multiple of 128; None when no divisor qualifies."""
    budget = _pick_head_chunk(n, h, requested)
    for hc in range(budget, 0, -1):
        if h % hc == 0 and (hc * hd) % 128 == 0:
            return hc
    for hc in range(budget + 1, h + 1):
        if h % hc == 0 and (hc * hd) % 128 == 0:
            return hc
    return None


def attn_geometry_ok(num_heads: int, head_dim: int) -> bool:
    """True iff the TPU's fused attention kernels lower for this head
    geometry (``attn_proj.py:176-189``): some head chunk dividing the heads
    is a multiple of 128 lanes wide. The JAX trunk runs the fused int8
    attention half only then; else LN + per-row ``qdense`` + attention. K7
    and K9 refuse any other geometry, as their TPU wrappers do."""
    return any(num_heads % hc == 0 and (hc * head_dim) % 128 == 0
               for hc in range(1, num_heads + 1))


def resolve_head_chunk(n: int, h: int, hd: int, head_chunk: Optional[int]) -> int:
    if head_chunk is not None:
        return _pick_head_chunk(n, h, head_chunk)
    hc = _pick_int8_head_chunk(n, h, hd, None)
    if hc is None:
        raise ValueError(
            f"fused_attn_half_int8: no head chunk with hc*head_dim % 128 == 0 "
            f"exists for num_heads={h}, head_dim={hd}; gate with "
            "attn_geometry_ok() or pass head_chunk")
    return hc


def attn_half_int8_scratch(m: int, d: int, n_chunks: int, dev,
                           o_dtype: torch.dtype = torch.bfloat16) -> list:
    """K4's (and K9's, T3's) attention scratch after the row-quantized
    input, in the C argument order: qkv [M, 3D] bf16, o [M, D] (bf16; f32
    for T3's batched_dots), its codes oq [M, D] int8 and scales os
    [M, head chunks] f32."""
    return [torch.empty((m, 3 * d), dtype=torch.bfloat16, device=dev),
            torch.empty((m, d), dtype=o_dtype, device=dev),
            torch.empty((m, d), dtype=torch.int8, device=dev),
            torch.empty((m, n_chunks), dtype=torch.float32, device=dev)]


def _split_heads(qkv: torch.Tensor, num_heads: int):
    b, n, three_d = qkv.shape
    d = three_d // 3
    hd = d // num_heads
    return [qkv[..., i * d:(i + 1) * d].reshape(b, n, num_heads, hd).transpose(1, 2)
            for i in range(3)]


def _f32(t: torch.Tensor) -> torch.Tensor:
    """At least float32 (float64 stays: gradcheck runs the plain versions
    in float64)."""
    return t if t.dtype == torch.float64 else t.float()


def _attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ) v per head for q already scaled and rounded: f32 sums
    and softmax, P rounded to v's dtype, the output rounded to v's dtype."""
    p = torch.softmax(_f32(q) @ _f32(k).transpose(-1, -2), dim=-1)
    return (_f32(p.to(v.dtype)) @ _f32(v)).to(v.dtype)


def flash_attention_qkv_proj_ref(
    qkv: torch.Tensor,
    w_proj: torch.Tensor,
    b_proj: Optional[torch.Tensor] = None,
    *,
    num_heads: int,
    layerscale: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel's math."""
    b, n, three_d = qkv.shape
    d = three_d // 3
    hd = d // num_heads
    scale = hd ** -0.5 if scale is None else float(scale)
    q, k, v = _split_heads(qkv, num_heads)
    o = _attention_ref((_f32(q) * scale).to(qkv.dtype), k, v)
    o_cat = o.transpose(1, 2).reshape(b, n, d)
    out = _f32(o_cat) @ _f32(w_proj)
    if b_proj is not None:
        out = out + _f32(b_proj)
    if layerscale is not None:
        out = out * _f32(layerscale)
    if residual is not None:
        out = out + _f32(residual)
    return out.to(qkv.dtype)


def flash_attention_qkv_proj(
    qkv: torch.Tensor,
    w_proj: torch.Tensor,
    b_proj: Optional[torch.Tensor] = None,
    *,
    num_heads: int,
    layerscale: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """qkv [B, N, 3D] (columns q | k | v, head-minor), w_proj [D, D_out]
    (the JAX layout; pass ``linear.weight.t()`` for a ``nn.Linear``),
    optional b_proj / layerscale [D_out] and residual [B, N, D_out]
    -> [B, N, D_out] in qkv's dtype. CPU tensors take the ``_ref``; CUDA
    tensors launch the kernels or raise."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be [B, N, 3D], got {tuple(qkv.shape)}")
    b, n, three_d = qkv.shape
    d = three_d // 3
    if d % num_heads:
        raise ValueError(f"D={d} is not divisible by num_heads={num_heads}")
    hd = d // num_heads
    if w_proj.dim() != 2 or w_proj.shape[0] != d:
        raise ValueError(f"w_proj must be [D={d}, D_out], got {tuple(w_proj.shape)}")
    d_out = w_proj.shape[1]
    scale = hd ** -0.5 if scale is None else float(scale)
    if residual is not None and tuple(residual.shape) != (b, n, d_out):
        raise ValueError(f"residual must be [{b}, {n}, {d_out}], got {tuple(residual.shape)}")
    for name, vec in (("b_proj", b_proj), ("layerscale", layerscale)):
        if vec is not None and tuple(vec.shape) != (d_out,):
            raise ValueError(f"{name} must be [{d_out}], got {tuple(vec.shape)}")
    tensors = [t for t in (qkv, w_proj, b_proj, layerscale, residual) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return flash_attention_qkv_proj_ref(
            qkv, w_proj, b_proj, num_heads=num_heads, layerscale=layerscale,
            residual=residual, scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return QkvProjGrad.apply(_qkv_proj_launch, num_heads, scale, qkv, w_proj, b_proj,
                                 layerscale, residual)
    return _qkv_proj_launch(qkv, w_proj, b_proj, num_heads=num_heads, layerscale=layerscale,
                            residual=residual, scale=scale)


class QkvProjGrad(torch.autograd.Function):
    """K5 with a gradient (F18): ``forward`` runs ``kernel`` (the launch;
    the tests fill the slot with the plain version on the CPU) on the
    inputs as given. On CUDA tensors the launch also keeps the heads'
    outputs o, each query row's log-sum-exp and (with LayerScale) the
    projection before LayerScale, and ``backward`` launches K5's backward
    kernels (``flash_attention_qkv_proj_bwd``); on CPU tensors it
    recomputes the plain version under autograd on detached copies of the
    inputs. Both return the gradients for qkv, w_proj, b_proj, layerscale
    and residual of the JAX package's XLA attention route: no Pallas kernel
    there has a backward (F19)."""

    @staticmethod
    def forward(ctx, kernel, num_heads, scale, qkv, w_proj, b_proj, layerscale, residual):
        ctx.num_heads, ctx.scale = num_heads, scale
        ctx.on_card = qkv.device.type == "cuda"
        if ctx.on_card:
            keep = {}
            out = kernel(qkv, w_proj, b_proj, num_heads=num_heads, layerscale=layerscale,
                         residual=residual, scale=scale, keep=keep)
            ctx.save_for_backward(qkv, w_proj, b_proj, layerscale, keep["o"], keep["lse"],
                                  keep["pre"])
            return out
        ctx.save_for_backward(qkv, w_proj, b_proj, layerscale, residual)
        return kernel(qkv, w_proj, b_proj, num_heads=num_heads, layerscale=layerscale,
                      residual=residual, scale=scale)

    @staticmethod
    def backward(ctx, grad):
        if ctx.on_card:
            qkv, w_proj, b_proj, layerscale, o, lse, pre = ctx.saved_tensors
            grads = flash_attention_qkv_proj_bwd(
                grad, qkv, w_proj, b_proj, layerscale, o, lse, pre, num_heads=ctx.num_heads,
                scale=ctx.scale, needs=ctx.needs_input_grad[3:])
            return (None, None, None) + grads
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[3:])]
        wanted = [t for t in inputs if t is not None and t.requires_grad]
        with torch.enable_grad():
            out = flash_attention_qkv_proj_ref(
                inputs[0], inputs[1], inputs[2], num_heads=ctx.num_heads,
                layerscale=inputs[3], residual=inputs[4], scale=ctx.scale)
        grads = iter(torch.autograd.grad(out, wanted, grad))
        return (None, None, None) + tuple(
            next(grads) if t is not None and t.requires_grad else None for t in inputs)


def _qkv_proj_launch(qkv, w_proj, b_proj, *, num_heads, layerscale, residual, scale,
                     keep=None):
    """K5's launch on CUDA tensors (shapes checked by the caller). A dict
    ``keep`` receives what the backward reads: ``o`` (the heads' outputs
    [B, N, D]), ``lse`` ([B, H, N] f32) and ``pre`` (o·W + b before
    LayerScale, [B, N, D_out] f32; None without LayerScale)."""
    tensors = [t for t in (qkv, w_proj, b_proj, layerscale, residual) if t is not None]
    b, n, three_d = qkv.shape
    d = three_d // 3
    hd, d_out = d // num_heads, w_proj.shape[1]
    _launch.require_cuda("flash_attention_qkv_proj", *tensors)
    code = _launch.dtype_code(qkv, "flash_attention_qkv_proj")
    if w_proj.dtype != qkv.dtype or (residual is not None and residual.dtype != qkv.dtype):
        raise TypeError("flash_attention_qkv_proj: w_proj and residual must "
                        "have qkv's dtype")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention_qkv_proj: head dim {hd} not "
                         f"supported (kernel takes {SUPPORTED_HEAD_DIMS})")
    if d_out % 8:
        raise ValueError(f"flash_attention_qkv_proj: D_out={d_out} must be a "
                         "multiple of 8")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("flash_attention_qkv_proj: qkv must be contiguous "
                         "and 16-byte aligned")
    _launch.check_gemm_rows(b * n, "flash_attention_qkv_proj")
    if residual is not None and not residual.is_contiguous():
        raise ValueError("flash_attention_qkv_proj: residual must be contiguous")
    w_nk = _launch.nk_weight(w_proj, "flash_attention_qkv_proj")
    bias = None if b_proj is None else b_proj.float().contiguous()
    gamma = None if layerscale is None else layerscale.float().contiguous()
    o = torch.empty((b, n, d), dtype=qkv.dtype, device=qkv.device)
    out = torch.empty((b, n, d_out), dtype=qkv.dtype, device=qkv.device)
    lse = pre = None
    if keep is not None:
        lse = torch.empty((b, num_heads, n), dtype=torch.float32, device=qkv.device)
        if layerscale is not None:
            pre = torch.empty((b, n, d_out), dtype=torch.float32, device=qkv.device)
        keep.update(o=o, lse=lse, pre=pre)
    rc = _build.load_library().anyloc_attn_qkv_proj(
        qkv.data_ptr(), w_nk.data_ptr(), _launch.ptr(bias), _launch.ptr(gamma),
        _launch.ptr(residual), o.data_ptr(), out.data_ptr(), _launch.ptr(lse), _launch.ptr(pre),
        code, b, n, num_heads, hd, d_out, scale, _launch.stream(qkv))
    _build.check(rc, "flash_attention_qkv_proj")
    flash_attention_qkv_proj.launches += 1
    return out


flash_attention_qkv_proj.launches = 0


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, N, H·hd] -> its [B, H, N, hd] view."""
    b, n, d = x.shape
    return x.view(b, n, num_heads, d // num_heads).transpose(1, 2)


# The work plan of the projection backward (csrc/proj_bwd_plan.cuh, which the
# C entry also computes: it refuses a launch whose plan differs): 128 x 128
# output tiles, stages of 32 reduction elements, d_W's chunks at least 8
# stages, reduction units of 32 rows of a d_W tile, column sums in blocks
# of 32 columns and splits of at least 64 rows, counters rounded up to 64
# ints; the unit kinds.
PB_TILE, PB_K, PB_MIN_CHUNK, PB_RED_ROWS = 128, 32, 8, 32
PB_COL, PB_COL_ROWS, PB_COUNTERS_ALIGN = 32, 64, 64
PB_DO, PB_DW, PB_RED = 0, 1, 2


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def proj_bwd_plan(m: int, d: int, nc: int, sms: int, want_o: bool = True,
                  want_w: bool = True, want_sums: bool = True) -> dict:
    """``proj_bwd_plan`` of ``csrc/proj_bwd_plan.cuh``: the tiles of M, D
    and Nc, d_W's reduction over the m rows cut into ``chunks`` chunks of
    ``chunk_rows`` rows (about as many 32-row stages as a d_o tile has
    32-column ones, at least 8), the work units (d_W's (tile, chunk) units,
    d_o's tiles, then with more than one chunk the reduction units, four a
    d_W tile) over ``grid`` = min(units, sms) persistent blocks, and the
    column sums' row splits (about four blocks of 32 columns per SM)."""
    p = dict(m_tiles=_cdiv(m, PB_TILE), d_tiles=_cdiv(d, PB_TILE), c_tiles=_cdiv(nc, PB_TILE),
             chunks=0, chunk_rows=0, n_dw=0, n_do=0, n_red=0, col_splits=0, col_rows=0)
    if want_w and m > 0:
        stages = _cdiv(m, PB_K)
        chunks = _cdiv(stages, max(_cdiv(nc, PB_K), PB_MIN_CHUNK))
        p["chunk_rows"] = _cdiv(stages, chunks) * PB_K
        p["chunks"] = _cdiv(m, p["chunk_rows"])
        p["n_dw"] = p["d_tiles"] * p["c_tiles"] * p["chunks"]
    if want_o and m > 0:
        p["n_do"] = p["m_tiles"] * p["d_tiles"]
    if p["chunks"] > 1:
        p["n_red"] = p["d_tiles"] * p["c_tiles"] * (PB_TILE // PB_RED_ROWS)
    p["units"] = p["n_dw"] + p["n_do"] + p["n_red"]
    p["grid"] = min(p["units"], sms)
    if want_sums and m > 0:
        splits = max(1, min(_cdiv(4 * sms, _cdiv(nc, PB_COL)), _cdiv(m, PB_COL_ROWS)))
        p["col_rows"] = _cdiv(m, splits)
        p["col_splits"] = _cdiv(m, p["col_rows"])
    return p


def proj_bwd_unit(plan: dict, m: int, nc: int, u: int) -> tuple:
    """Unit u (``proj_bwd_unit``): (kind, ti, tj, chunk, k0, k1): d_W's tile
    (D-tile ti, Nc-tile tj) over rows k0..k1 - 1 of chunk ``chunk``
    (``PB_DW``), d_o's tile (M-tile ti, D-tile tj) over the columns
    0..nc - 1 (``PB_DO``), or rows k0..k1 - 1 of d_W tile (ti, tj) summed
    over the chunks (``PB_RED``)."""
    tiles = plan["d_tiles"] * plan["c_tiles"]
    if u < plan["n_dw"]:
        chunk, tile = divmod(u, tiles)
        k0 = chunk * plan["chunk_rows"]
        return (PB_DW, tile // plan["c_tiles"], tile % plan["c_tiles"], chunk, k0,
                min(m, k0 + plan["chunk_rows"]))
    if u < plan["n_dw"] + plan["n_do"]:
        ti, tj = divmod(u - plan["n_dw"], plan["d_tiles"])
        return (PB_DO, ti, tj, 0, 0, nc)
    tile, part = divmod(u - plan["n_dw"] - plan["n_do"], PB_TILE // PB_RED_ROWS)
    return (PB_RED, tile // plan["c_tiles"], tile % plan["c_tiles"], 0, part * PB_RED_ROWS,
            (part + 1) * PB_RED_ROWS)


def proj_bwd_units(plan: dict, m: int, nc: int) -> list:
    """Each persistent block's units in order: block b takes units b,
    b + grid, ... (``proj_bwd_unit``)."""
    return [[proj_bwd_unit(plan, m, nc, u) for u in range(b, plan["units"], plan["grid"])]
            for b in range(plan["grid"])]


def proj_bwd_workspace(plan: dict, d: int, nc: int) -> dict:
    """``proj_bwd_workspace``: byte offsets of the arrival counters (d_W's
    tiles when there is more than one chunk, the column sums' blocks), of
    d_W's f32 partials [chunks, D, Nc] (more than one chunk) and of the
    column sums' partials [2, col_splits, Nc], and the total."""
    n_counters = ((plan["d_tiles"] * plan["c_tiles"] if plan["chunks"] > 1 else 0)
                  + (_cdiv(nc, PB_COL) if plan["col_splits"] > 0 else 0))
    part = 4 * _cdiv(n_counters, PB_COUNTERS_ALIGN) * PB_COUNTERS_ALIGN
    col = part + (4 * plan["chunks"] * d * nc if plan["chunks"] > 1 else 0)
    return dict(counters=0, part=part, col=col, bytes=col + 4 * 2 * plan["col_splits"] * nc)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def qkv_proj_bwd_ref(grad, w_proj, b_proj, layerscale, o, pre, *, needs=(True,) * 4):
    """Plain PyTorch version of K5's projection backward (``qkv_proj_bwd``):
    (d_o, d_w, d_b, d_layerscale) from the output gradient, the weight, bias
    and LayerScale, the heads' outputs o [B, N, D] and, with LayerScale, the
    projection before it ``pre`` [B, N, D_out] f32; None for what ``needs``
    does not want or an input that is None. Rounding as the plain version's
    autograd: G' = G · LayerScale in f32, d_o = G'·Wᵀ rounded to o's dtype,
    d_w = oᵀ·G' in W's dtype, d_b and d_layerscale summed in f32."""
    want_o, want_w, want_b, want_ls = needs
    d = o.shape[-1]
    g = _f32(grad)
    gp = g * _f32(layerscale) if layerscale is not None else g
    d_o = (gp @ _f32(w_proj).t()).to(o.dtype) if want_o else None
    d_w = None
    if want_w:
        d_w = (_f32(o).reshape(-1, d).t() @ gp.reshape(-1, gp.shape[-1])).to(w_proj.dtype)
    d_b = gp.sum((0, 1)) if want_b and b_proj is not None else None
    d_ls = (g * pre).sum((0, 1)) if want_ls and layerscale is not None else None
    return d_o, d_w, d_b, d_ls


def flash_attention_qkv_proj_bwd_ref(grad, qkv, w_proj, b_proj, layerscale, o, lse, pre, *,
                                     num_heads: int, scale: Optional[float] = None):
    """Plain PyTorch version of K5's backward kernels, with their
    arguments: the output gradient, the inputs, and what the forward kept
    (o, the heads' outputs [B, N, D]; lse [B, H, N]; pre = o·W + b before
    LayerScale [B, N, D_out] f32, or None) -> (d_qkv, d_w_proj, d_b_proj,
    d_layerscale, d_residual), None for an input that is None: the
    projection backward (``qkv_proj_bwd_ref``), then the attention backward
    (``attention_bwd_math`` with K5's pre-scaled q) on its d_o."""
    b, n, three_d = qkv.shape
    d = three_d // 3
    hd = d // num_heads
    scale = hd ** -0.5 if scale is None else float(scale)
    d_o, d_w, d_b, d_ls = qkv_proj_bwd_ref(grad, w_proj, b_proj, layerscale, o, pre)
    q, k, v = _split_heads(qkv, num_heads)
    grads = attention_bwd_math(q, k, v, _heads(o, num_heads), lse, _heads(d_o, num_heads),
                               scale=scale, prescale_q=True)
    d_qkv = torch.cat([t.transpose(1, 2).reshape(b, n, d) for t in grads], dim=-1)
    return (d_qkv, d_w, None if d_b is None else d_b.to(b_proj.dtype),
            None if d_ls is None else d_ls.to(layerscale.dtype), grad)


def qkv_proj_bwd(grad, w_proj, b_proj, layerscale, o, pre, *, needs=(True,) * 4,
                 name: str = "qkv_proj_bwd"):
    """K5's projection backward alone on CUDA tensors (``csrc/
    attn_qkv_proj_bwd.cu``): (d_o, d_w, d_b, d_layerscale) from the output
    gradient ``grad`` [B, N, D_out], the weight, bias and LayerScale, the
    kept attention output ``o`` [B, N, D] (contiguous) and, with LayerScale,
    the projection before it ``pre``; ``needs`` says which are wanted (None
    for the others; d_b and d_layerscale in f32). CPU tensors take the
    plain version (``qkv_proj_bwd_ref``); on CUDA tensors one persistent
    kernel computes d_o and d_w (``proj_bwd_plan``'s units), after a small
    one for d_b and d_layerscale, with ``proj_bwd_workspace``'s scratch;
    after each launch ``qkv_proj_bwd.last_call`` holds the plan, the
    scratch's bytes and the launches (kernels and memsets).
    ``flash_attention_qkv_proj_bwd`` checks the shapes and then runs it
    before the attention backward."""
    tensors = [t for t in (grad, w_proj, b_proj, layerscale, o, pre) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return qkv_proj_bwd_ref(grad, w_proj, b_proj, layerscale, o, pre, needs=needs)
    _launch.require_cuda(name, *tensors)
    want_o, want_w, want_b, want_ls = needs
    want_b = want_b and b_proj is not None
    want_ls = want_ls and layerscale is not None
    b, n, d = o.shape
    d_out = w_proj.shape[1]
    code = _launch.dtype_code(o, name)
    m = b * n
    if d % 8 or d_out % 8:
        raise ValueError(f"{name}: D={d} and D_out={d_out} must be multiples of 8")
    if not o.is_contiguous() or o.data_ptr() % 16:
        raise ValueError(f"{name}: o must be contiguous and 16-byte aligned")
    grad = grad.contiguous()
    dev = o.device
    f32 = dict(dtype=torch.float32, device=dev)
    sms = _sm_count(dev.index if dev.index is not None else torch.cuda.current_device())
    plan = proj_bwd_plan(m, d, d_out, sms, want_o, want_w, want_b or want_ls)
    ws = proj_bwd_workspace(plan, d, d_out)
    work = torch.empty(max(ws["bytes"], 16), dtype=torch.uint8, device=dev)
    d_o = torch.empty((b, n, d), dtype=o.dtype, device=dev) if want_o else None
    d_w = torch.empty((d, d_out), dtype=w_proj.dtype, device=dev) if want_w else None
    d_b = torch.empty(d_out, **f32) if want_b else None
    d_ls = torch.empty(d_out, **f32) if want_ls else None
    w32 = w_proj.float().contiguous()      # W_O [D, D_out]: d_o's B operand rows
    gamma = None if layerscale is None else layerscale.float().contiguous()
    rc = _build.load_library().anyloc_qkv_proj_bwd(
        grad.data_ptr(), _launch.ptr(pre), _launch.ptr(gamma), w32.data_ptr(), o.data_ptr(),
        work.data_ptr(), _launch.ptr(d_o), _launch.ptr(d_w), _launch.ptr(d_b),
        _launch.ptr(d_ls), code, _launch.dtype_code(w_proj, name), m, d, d_out, sms,
        plan["chunks"], plan["chunk_rows"], plan["col_splits"], _launch.stream(o))
    _build.check(rc, name)
    qkv_proj_bwd.last_call = dict(
        plan=plan, workspace_bytes=ws["bytes"],
        kernels=int(plan["col_splits"] > 0) + int(plan["units"] > 0),
        memsets=int(ws["part"] > 0))
    return d_o, d_w, d_b, d_ls


qkv_proj_bwd.last_call = None


def flash_attention_qkv_proj_bwd(grad, qkv, w_proj, b_proj, layerscale, o, lse, pre, *,
                                 num_heads: int, scale: Optional[float] = None,
                                 needs=(True,) * 5):
    """K5's backward: the gradients of ``flash_attention_qkv_proj`` for
    qkv, w_proj, b_proj, layerscale and residual (``needs``: which are
    wanted; None for the others and for inputs that are None) from the
    output gradient and what the forward kept (see
    ``flash_attention_qkv_proj_bwd_ref``). CPU tensors take the ``_ref``;
    CUDA tensors launch the projection backward (``csrc/
    attn_qkv_proj_bwd.cu``: d_o, d_w, d_b, d_layerscale) and the attention
    backward (``csrc/flash_attention_bwd.cu``: d_qkv) or raise."""
    b, n, three_d = qkv.shape
    d = three_d // 3
    hd = d // num_heads
    d_out = w_proj.shape[1]
    scale = hd ** -0.5 if scale is None else float(scale)
    want_qkv, want_w, want_b, want_ls, want_res = needs
    want_b = want_b and b_proj is not None
    want_ls = want_ls and layerscale is not None
    tensors = [t for t in (grad, qkv, w_proj, b_proj, layerscale, o, lse, pre) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        r = flash_attention_qkv_proj_bwd_ref(grad, qkv, w_proj, b_proj, layerscale, o, lse, pre,
                                             num_heads=num_heads, scale=scale)
        return tuple(x if w else None for x, w in
                     zip(r, (want_qkv, want_w, want_b, want_ls, want_res)))
    name = "flash_attention_qkv_proj_bwd"
    _launch.require_cuda(name, *tensors)
    _launch.dtype_code(qkv, name)
    if grad.dtype != qkv.dtype or o.dtype != qkv.dtype:
        raise TypeError(f"{name}: the output gradient and o must have qkv's dtype")
    if tuple(grad.shape) != (b, n, d_out) or tuple(o.shape) != (b, n, d):
        raise ValueError(f"{name}: grad must be [{b}, {n}, {d_out}] and o [{b}, {n}, {d}], got "
                         f"{tuple(grad.shape)} {tuple(o.shape)}")
    if layerscale is not None and (pre is None or tuple(pre.shape) != (b, n, d_out)
                                   or pre.dtype != torch.float32 or not pre.is_contiguous()):
        raise ValueError(f"{name}: with LayerScale, pre must be a contiguous float32 "
                         f"[{b}, {n}, {d_out}]")
    if not qkv.is_contiguous() or not o.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError(f"{name}: qkv and o must be contiguous and 16-byte aligned")
    if d_out % 8 or hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name}: D_out={d_out} must be a multiple of 8 and the head dim one "
                         f"of {SUPPORTED_HEAD_DIMS}")
    d_o, d_w, d_b, d_ls = qkv_proj_bwd(grad, w_proj, b_proj, layerscale, o, pre,
                                       needs=(want_qkv, want_w, want_b, want_ls), name=name)
    d_qkv = None
    if want_qkv:
        d_qkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
        q, k, v = _split_heads(qkv, num_heads)
        dq, dk, dv = _split_heads(d_qkv, num_heads)
        attention_bwd_launch(q, k, v, _heads(o, num_heads), lse, _heads(d_o, num_heads),
                             dq, dk, dv, scale=scale, prescale_q=True, name=name)
    flash_attention_qkv_proj_bwd.launches += 1
    return (d_qkv, d_w, None if d_b is None else d_b.to(b_proj.dtype),
            None if d_ls is None else d_ls.to(layerscale.dtype), grad if want_res else None)


flash_attention_qkv_proj_bwd.launches = 0


def _check_attn_half(x, wqkv_q, wp_q, num_heads):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, D], got {tuple(x.shape)}")
    b, n, d = x.shape
    if d % num_heads:
        raise ValueError(f"D={d} is not divisible by num_heads={num_heads}")
    if tuple(wqkv_q.shape) != (d, 3 * d) or tuple(wp_q.shape) != (d, d):
        raise ValueError(f"fused_attn_half_int8: wqkv_q must be [{d}, {3 * d}] and wp_q "
                         f"[{d}, {d}], got {tuple(wqkv_q.shape)} {tuple(wp_q.shape)}")
    return b, n, d, d // num_heads


def fused_attn_half_int8_ref(
    x: torch.Tensor, wqkv_q, wqkv_scale, b_qkv, wp_q, wp_scale, b_proj, *,
    num_heads: int, ln_params: tuple, ln_eps: float = 1e-6,
    layerscale: Optional[torch.Tensor] = None, scale: Optional[float] = None,
    head_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel's math (materializes the
    [B, H, N, N] scores)."""
    b, n, d, hd = _check_attn_half(x, wqkv_q, wp_q, num_heads)
    scale = hd ** -0.5 if scale is None else float(scale)
    hc = resolve_head_chunk(n, num_heads, hd, head_chunk)
    xq, xs = quantize_rows(ln_rows(x.reshape(-1, d).float(), *ln_params, ln_eps))
    return _attn_half_int8_from_codes(x, xq, xs, wqkv_q, wqkv_scale, b_qkv, wp_q, wp_scale,
                                      b_proj, layerscale, num_heads, scale, hc)


def _attn_half_int8_from_codes(x, xq, xs, wqkv_q, wqkv_scale, b_qkv, wp_q, wp_scale, b_proj,
                               layerscale, h, scale, hc, o_bf16=True, return_o=False):
    """K4's plain math after the row quantize (codes xq [M, D], scales xs
    [M, 1]): shared by K4's and T3's plain versions. ``o_bf16=False`` keeps
    each head's output in f32 (T3's batched_dots); ``return_o`` also returns
    the heads' outputs as f32 [B, N, D] (bf16 values unless ``o_bf16`` is
    false)."""
    b, n, d = x.shape
    hd = d // h
    hcw = hc * hd
    qkv = _int_mm(xq, wqkv_q).float() * xs * wqkv_scale.float()
    if b_qkv is not None:
        qkv = qkv + b_qkv.float()
    q, k, v = ((t.to(torch.bfloat16).float().reshape(b, n, h, hd).transpose(1, 2))
               for t in (qkv[:, :d] * scale, qkv[:, d:2 * d], qkv[:, 2 * d:]))
    p = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
    o = p.to(torch.bfloat16).float() @ v
    if o_bf16:
        o = o.to(torch.bfloat16)
    o_cat = o.transpose(1, 2).reshape(b * n, d).float()
    out = _attn_half_int8_from_heads(x, o_cat, wp_q, wp_scale, b_proj, layerscale, hcw)
    return (out, o_cat.reshape(b, n, d)) if return_o else out


def _attn_half_int8_from_heads(x, o_cat, wp_q, wp_scale, b_proj, layerscale, hcw):
    """K4's plain math from the heads' outputs o_cat [M, D] f32 on:
    requantize per (row, head chunk of width hcw), int8 out-projection,
    bias, LayerScale, residual."""
    b, n, d = x.shape
    acc = torch.zeros((b * n, d), dtype=torch.float32, device=x.device)
    for c in range(0, d, hcw):
        oq, os_ = quantize_rows(o_cat[:, c:c + hcw])
        acc = acc + _int_mm(oq, wp_q[c:c + hcw]).float() * os_ * wp_scale.float()
    if b_proj is not None:
        acc = acc + b_proj.float()
    if layerscale is not None:
        acc = acc * layerscale.float()
    return (acc + x.reshape(-1, d).float()).to(x.dtype).reshape(b, n, d)


def fused_attn_half_int8(
    x: torch.Tensor, wqkv_q, wqkv_scale, b_qkv, wp_q, wp_scale, b_proj, *,
    num_heads: int, ln_params: tuple, ln_eps: float = 1e-6,
    layerscale: Optional[torch.Tensor] = None, scale: Optional[float] = None,
    head_chunk: Optional[int] = None,
) -> torch.Tensor:
    """out = x + layerscale · (proj(attn(qkv(LN1(x)))) + b_proj) with int8
    W8A8 products: the first residual branch of a pre-norm ViT block.

    x [B, N, D] (bf16 or f32); weights in the JAX layout, wqkv_q int8
    [D, 3D] (q | k | v column thirds, head-minor) and wp_q int8 [D, D],
    with per-column f32 scales and optional biases; ``ln_params`` =
    (scale, bias) of norm1. For ``nn.Linear``-layout codes [out, in] pass
    ``weight_q.t()`` (the kernel reads that storage as it is, no copy).
    CPU tensors take ``fused_attn_half_int8_ref``; CUDA tensors launch the
    kernels or raise."""
    b, n, d, hd = _check_attn_half(x, wqkv_q, wp_q, num_heads)
    scale = hd ** -0.5 if scale is None else float(scale)
    hc = resolve_head_chunk(n, num_heads, hd, head_chunk)
    vecs = dict(wqkv_scale=wqkv_scale, b_qkv=b_qkv, wp_scale=wp_scale, b_proj=b_proj,
                ln_scale=ln_params[0], ln_bias=ln_params[1], layerscale=layerscale)
    tensors = [x, wqkv_q, wp_q] + [t for t in vecs.values() if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return fused_attn_half_int8_ref(
            x, wqkv_q, wqkv_scale, b_qkv, wp_q, wp_scale, b_proj, num_heads=num_heads,
            ln_params=ln_params, ln_eps=ln_eps, layerscale=layerscale, scale=scale,
            head_chunk=hc)
    _launch.require_cuda("fused_attn_half_int8", *tensors)
    code = _launch.dtype_code(x, "fused_attn_half_int8")
    if wqkv_q.dtype != torch.int8 or wp_q.dtype != torch.int8:
        raise TypeError("fused_attn_half_int8: wqkv_q and wp_q must be int8")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"fused_attn_half_int8: head dim {hd} not supported "
                         f"(kernel takes {SUPPORTED_HEAD_DIMS})")
    if d % 32 or (hc * hd) % 32:
        raise ValueError(f"fused_attn_half_int8: the kernel needs D and the head chunk "
                         f"width % 32 == 0 (D={d}, chunk {hc} x {hd})")
    widths = dict(wqkv_scale=3 * d, b_qkv=3 * d)
    for name, vec in vecs.items():
        want = widths.get(name, d)
        if vec is not None and tuple(vec.shape) != (want,):
            raise ValueError(f"fused_attn_half_int8: {name} must be [{want}], "
                             f"got {tuple(vec.shape)}")
    _launch.check_gemm_rows(b * n, "fused_attn_half_int8")
    wqkv_nk = _launch.nk_weight(wqkv_q, "fused_attn_half_int8")
    wp_nk = _launch.nk_weight(wp_q, "fused_attn_half_int8")
    f32 = {k: None if v is None else v.float().contiguous() for k, v in vecs.items()}
    x = x.contiguous()
    m = b * n
    scratch = (row_quant_scratch(m, d, x.device)
               + attn_half_int8_scratch(m, d, num_heads // hc, x.device))
    out = torch.empty_like(x)
    p = _launch.ptr
    rc = _build.load_library().anyloc_attn_half_int8(
        x.data_ptr(), f32["ln_scale"].data_ptr(), f32["ln_bias"].data_ptr(),
        wqkv_nk.data_ptr(), f32["wqkv_scale"].data_ptr(), p(f32["b_qkv"]),
        wp_nk.data_ptr(), f32["wp_scale"].data_ptr(), p(f32["b_proj"]),
        p(f32["layerscale"]), *[t.data_ptr() for t in scratch], out.data_ptr(), code, code,
        b, n, num_heads, hd, hc, float(ln_eps), scale, _launch.stream(x))
    _build.check(rc, "fused_attn_half_int8")
    fused_attn_half_int8.launches += 1
    return out


fused_attn_half_int8.launches = 0


# ---------------------------------------------------------------- T3

# tools/bench_xlayer.py:42,184: heads of 64 (24 of them at its D 1536; the
# port takes D // head_dim, 64 unless the caller names another one of
# SUPPORTED_HEAD_DIMS), LayerNorm eps 1e-6, softmax scale head_dim ** -0.5
VARIANT_HEAD_DIM = 64
VARIANT_EPS = 1e-6


def _check_variant(x, xq_in, xs_in, wqkv_q, wp_q, pre_quant, hd=VARIANT_HEAD_DIM):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, D], got {tuple(x.shape)}")
    b, n, d = x.shape
    if d % hd:
        raise ValueError(f"attn_half_variant: D={d} is not a multiple of the head dim {hd}")
    h = d // hd
    if tuple(wqkv_q.shape) != (d, 3 * d) or tuple(wp_q.shape) != (d, d):
        raise ValueError(f"attn_half_variant: wqkv_q must be [{d}, {3 * d}] and wp_q [{d}, {d}], "
                         f"got {tuple(wqkv_q.shape)} {tuple(wp_q.shape)}")
    hc = _pick_int8_head_chunk(n, h, hd, None)
    if hc is None:
        raise ValueError(f"attn_half_variant: no head chunk with hc*{hd} % 128 == 0 exists "
                         f"for {h} heads")
    np_pad = round_up(n, 8)
    if pre_quant and (xq_in is None or xs_in is None
                      or tuple(xq_in.shape) != (b, np_pad, d)
                      or tuple(xs_in.shape) != (b, np_pad, 1)):
        raise ValueError(
            f"attn_half_variant: pre_quant needs xq_in [{b}, {np_pad}, {d}] and xs_in "
            f"[{b}, {np_pad}, 1] (rows padded to a multiple of 8), got "
            f"{None if xq_in is None else tuple(xq_in.shape)} "
            f"{None if xs_in is None else tuple(xs_in.shape)}")
    return b, n, d, h, hc, np_pad


def attn_half_variant_ref(x, xq_in, xs_in, wqkv_q, wqkv_scale, wp_q, wp_scale, ln, gamma, *,
                          pre_quant: bool, batched_dots: bool, return_o: bool = False,
                          head_dim: int = VARIANT_HEAD_DIM):
    """Plain PyTorch version of the kernel's math: K4's plain version with
    no biases, reading the first N pre-quantized rows of each image with
    ``pre_quant``, each head's output kept in f32 with ``batched_dots``."""
    b, n, d, h, hc, _ = _check_variant(x, xq_in, xs_in, wqkv_q, wp_q, pre_quant, head_dim)
    if pre_quant:
        xq = xq_in[:, :n].reshape(-1, d)
        xs = xs_in[:, :n].reshape(-1, 1).float()
    else:
        xq, xs = quantize_rows(ln_rows(x.reshape(-1, d).float(), ln[0].reshape(d),
                                       ln[1].reshape(d), VARIANT_EPS))
    return _attn_half_int8_from_codes(
        x, xq, xs, wqkv_q, wqkv_scale.reshape(3 * d), None, wp_q, wp_scale.reshape(d), None,
        None if gamma is None else gamma.reshape(d), h, head_dim ** -0.5, hc,
        o_bf16=not batched_dots, return_o=return_o)


def attn_half_variant_proj_ref(x, o, wp_q, wp_scale, gamma,
                               head_dim: int = VARIANT_HEAD_DIM) -> torch.Tensor:
    """T3's plain math from the heads' outputs o [B, N, D] (``return_o``)
    on: requantize per (row, head chunk), out-projection, LayerScale,
    residual. Given the kernel's own o, it isolates the stages after the
    attention: the kernel's output must match it far more closely than it
    matches the same math on o rounded to bf16 (batched_dots)."""
    b, n, d = x.shape
    hc = _pick_int8_head_chunk(n, d // head_dim, head_dim, None)
    return _attn_half_int8_from_heads(x, o.reshape(b * n, d).float(), wp_q, wp_scale.reshape(d),
                                      None, None if gamma is None else gamma.reshape(d),
                                      hc * head_dim)


def attn_half_variant(x, xq_in, xs_in, wqkv_q, wqkv_scale, wp_q, wp_scale, ln, gamma, *,
                      pre_quant: bool, batched_dots: bool, return_o: bool = False,
                      head_dim: int = VARIANT_HEAD_DIM):
    """T3, the counterpart of ``tools/bench_xlayer.py::attn_half_variant``:
    K4 (``fused_attn_half_int8``) with zero biases and two experiment knobs.

    x [B, N, D] (bf16 or f32, D a multiple of ``head_dim``: D // head_dim
    heads; 64 as in the JAX tool, or another of ``SUPPORTED_HEAD_DIMS``);
    wqkv_q [D, 3D] and wp_q [D, D] int8 in the JAX layout (pass
    ``weight_q.t()`` of [out, in] storage: no copy), wqkv_scale (3D values)
    and wp_scale (D values) f32; ``ln`` = (scale, bias) and ``gamma``, D
    values each (the JAX tool's [1, D]). ``pre_quant`` skips LN1 and the
    per-token quantize and reads xq_in [B, round_up(N, 8), D] int8 and
    xs_in [B, round_up(N, 8), 1] f32 instead (the first N rows of each
    image, read in place); otherwise both may be None. ``batched_dots``
    keeps each head's attention output in f32 for the requantize. The head
    chunk is the TPU kernel's (``_pick_int8_head_chunk(N, H, head_dim, None)``).
    ``return_o`` also returns the heads' outputs, the requantize's input,
    as f32 [B, N, D] (bf16 values unless ``batched_dots``): the one place
    where the knob shows beyond the int8 noise of the output. CPU tensors
    take ``attn_half_variant_ref``; CUDA tensors launch the kernels or
    raise."""
    b, n, d, h, hc, np_pad = _check_variant(x, xq_in, xs_in, wqkv_q, wp_q, pre_quant, head_dim)
    hd = head_dim
    vecs = dict(wqkv_scale=wqkv_scale, wp_scale=wp_scale, ln_scale=ln[0], ln_bias=ln[1],
                gamma=gamma)
    rows = (xq_in, xs_in) if pre_quant else ()
    tensors = [x, wqkv_q, wp_q, *rows] + [t for t in vecs.values() if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return attn_half_variant_ref(x, xq_in, xs_in, wqkv_q, wqkv_scale, wp_q, wp_scale, ln,
                                     gamma, pre_quant=pre_quant, batched_dots=batched_dots,
                                     return_o=return_o, head_dim=hd)
    _launch.require_cuda("attn_half_variant", *tensors)
    code = _launch.dtype_code(x, "attn_half_variant")
    if wqkv_q.dtype != torch.int8 or wp_q.dtype != torch.int8:
        raise TypeError("attn_half_variant: wqkv_q and wp_q must be int8")
    if pre_quant and xq_in.dtype != torch.int8:
        raise TypeError("attn_half_variant: xq_in must be int8")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"attn_half_variant: head dim {hd} not supported "
                         f"(kernel takes {SUPPORTED_HEAD_DIMS})")
    if d % 32:
        raise ValueError(f"attn_half_variant: the kernel needs D % 32 == 0 (D={d})")
    widths = dict(wqkv_scale=3 * d)
    for name, vec in vecs.items():
        if vec is not None and vec.numel() != widths.get(name, d):
            raise ValueError(f"attn_half_variant: {name} must hold {widths.get(name, d)} "
                             f"values, got {tuple(vec.shape)}")
    _launch.check_gemm_rows(b * n, "attn_half_variant")
    wqkv_nk = _launch.nk_weight(wqkv_q, "attn_half_variant")
    wp_nk = _launch.nk_weight(wp_q, "attn_half_variant")
    f32 = {k: None if v is None else v.reshape(-1).float().contiguous() for k, v in vecs.items()}
    x = x.contiguous()
    m, dev = b * n, x.device
    if pre_quant:
        rows = [xq_in.contiguous(), xs_in.float().contiguous()]
        row_scratch = [None, None]
    else:
        rows = [None, None]
        row_scratch = row_quant_scratch(m, d, dev)
    scratch = row_scratch + attn_half_int8_scratch(
        m, d, h // hc, dev, torch.float32 if batched_dots else torch.bfloat16)
    out = torch.empty_like(x)
    p = _launch.ptr
    rc = _build.load_library().anyloc_attn_half_variant(
        x.data_ptr(), f32["ln_scale"].data_ptr(), f32["ln_bias"].data_ptr(), wqkv_nk.data_ptr(),
        f32["wqkv_scale"].data_ptr(), wp_nk.data_ptr(), f32["wp_scale"].data_ptr(),
        p(f32["gamma"]), *[p(t) for t in rows + scratch], out.data_ptr(), code, b, n, np_pad,
        h, hd, hc, int(batched_dots), VARIANT_EPS, hd ** -0.5, _launch.stream(x))
    _build.check(rc, "attn_half_variant")
    attn_half_variant.launches += 1
    return (out, scratch[3].float().reshape(b, n, d)) if return_o else out


attn_half_variant.launches = 0


# ---------------------------------------------------------------- K7


def _check_attn_half_bf16(x, wqkv, wp, num_heads):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, D], got {tuple(x.shape)}")
    b, n, d = x.shape
    if d % num_heads:
        raise ValueError(f"D={d} is not divisible by num_heads={num_heads}")
    if tuple(wqkv.shape) != (d, 3 * d) or tuple(wp.shape) != (d, d):
        raise ValueError(f"fused_attn_half_bf16: wqkv must be [{d}, {3 * d}] and wp "
                         f"[{d}, {d}], got {tuple(wqkv.shape)} {tuple(wp.shape)}")
    return b, n, d, d // num_heads


def fused_attn_half_bf16_ref(
    x: torch.Tensor, wqkv, b_qkv, wp, b_proj, *, num_heads: int, ln_params: tuple,
    ln_eps: float = 1e-6, layerscale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None, head_chunk: Optional[int] = None, skew: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel's math (materializes the
    [B, H, N, N] scores)."""
    b, n, d, hd = _check_attn_half_bf16(x, wqkv, wp, num_heads)
    scale = hd ** -0.5 if scale is None else float(scale)
    xf = x.reshape(-1, d).float()
    xn = ln_rows(xf, *ln_params, ln_eps).to(x.dtype)
    qkv = xn.float() @ wqkv.float()
    if b_qkv is not None:
        qkv = qkv + b_qkv.float()
    q, k, v = (t.to(x.dtype).reshape(b, n, num_heads, hd).transpose(1, 2)
               for t in (qkv[:, :d] * scale, qkv[:, d:2 * d], qkv[:, 2 * d:]))
    o_cat = _attention_ref(q, k, v).transpose(1, 2).reshape(b * n, d)
    acc = o_cat.float() @ wp.float()
    if b_proj is not None:
        acc = acc + b_proj.float()
    if layerscale is not None:
        acc = acc * layerscale.float()
    return (acc + xf).to(x.dtype).reshape(b, n, d)


def fused_attn_half_bf16(
    x: torch.Tensor, wqkv, b_qkv, wp, b_proj, *, num_heads: int, ln_params: tuple,
    ln_eps: float = 1e-6, layerscale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None, head_chunk: Optional[int] = None, skew: bool = True,
) -> torch.Tensor:
    """out = x + layerscale · (proj(attn(qkv(LN1(x)))) + b_proj) with float
    weights: the first residual branch of a pre-norm ViT block.

    x [B, N, D] (bf16 or f32); weights in x's dtype and the JAX layout,
    wqkv [D, 3D] (q | k | v column thirds, head-minor), wp [D, D]; for
    ``nn.Linear`` storage pass ``weight.t()`` (read as it is, no copy);
    biases, LN parameters and layerscale [D] of any float dtype, used in
    f32. ``head_chunk`` and ``skew`` are accepted and ignored (on the TPU
    they only order f32 sums). CPU tensors take
    ``fused_attn_half_bf16_ref``; CUDA tensors launch the kernels or raise."""
    b, n, d, hd = _check_attn_half_bf16(x, wqkv, wp, num_heads)
    scale = hd ** -0.5 if scale is None else float(scale)
    vecs = dict(b_qkv=b_qkv, b_proj=b_proj, ln_scale=ln_params[0], ln_bias=ln_params[1],
                layerscale=layerscale)
    tensors = [x, wqkv, wp] + [t for t in vecs.values() if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return fused_attn_half_bf16_ref(
            x, wqkv, b_qkv, wp, b_proj, num_heads=num_heads, ln_params=ln_params,
            ln_eps=ln_eps, layerscale=layerscale, scale=scale)
    _launch.require_cuda("fused_attn_half_bf16", *tensors)
    code = _launch.dtype_code(x, "fused_attn_half_bf16")
    if wqkv.dtype != x.dtype or wp.dtype != x.dtype:
        raise TypeError("fused_attn_half_bf16: wqkv and wp must have x's dtype")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"fused_attn_half_bf16: head dim {hd} not supported "
                         f"(kernel takes {SUPPORTED_HEAD_DIMS})")
    if not attn_geometry_ok(num_heads, hd):
        raise ValueError(f"fused_attn_half_bf16: no head chunk with hc*head_dim % 128 == 0 "
                         f"exists for num_heads={num_heads}, head_dim={hd}")
    for name, vec in vecs.items():
        want = 3 * d if name == "b_qkv" else d
        if vec is not None and tuple(vec.shape) != (want,):
            raise ValueError(f"fused_attn_half_bf16: {name} must be [{want}], "
                             f"got {tuple(vec.shape)}")
    _launch.check_gemm_rows(b * n, "fused_attn_half_bf16")
    wqkv_nk = _launch.nk_weight(wqkv, "fused_attn_half_bf16")
    wp_nk = _launch.nk_weight(wp, "fused_attn_half_bf16")
    f32 = {k: None if v is None else v.float().contiguous() for k, v in vecs.items()}
    x = x.contiguous()
    m, dev = b * n, x.device
    xn = torch.empty((m, d), dtype=x.dtype, device=dev)
    qkv = torch.empty((m, 3 * d), dtype=x.dtype, device=dev)
    o = torch.empty((m, d), dtype=x.dtype, device=dev)
    out = torch.empty_like(x)
    p = _launch.ptr
    rc = _build.load_library().anyloc_attn_half_bf16(
        x.data_ptr(), f32["ln_scale"].data_ptr(), f32["ln_bias"].data_ptr(),
        wqkv_nk.data_ptr(), p(f32["b_qkv"]), wp_nk.data_ptr(), p(f32["b_proj"]),
        p(f32["layerscale"]), xn.data_ptr(), qkv.data_ptr(), o.data_ptr(), out.data_ptr(),
        code, b, n, num_heads, hd, float(ln_eps), scale, _launch.stream(x))
    _build.check(rc, "fused_attn_half_bf16")
    fused_attn_half_bf16.launches += 1
    return out


fused_attn_half_bf16.launches = 0


# ---------------------------------------------------------------- K6


def attention_proj_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w_proj: torch.Tensor, *, scale: Optional[float] = None,
                       head_chunk: Optional[int] = None, skew: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the kernel's math."""
    b, h, n, hd = q.shape
    scale = hd ** -0.5 if scale is None else float(scale)
    o = _attention_ref((q.float() * scale).to(q.dtype), k, v)
    o_cat = o.transpose(1, 2).reshape(b, n, h * hd)
    return (o_cat.float() @ w_proj.float()).to(q.dtype)


def attention_proj(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w_proj: torch.Tensor, *, scale: Optional[float] = None,
                   head_chunk: Optional[int] = None, skew: bool = True) -> torch.Tensor:
    """softmax(q kᵀ · scale) v per head, heads concatenated, @ w_proj.

    q/k/v [B, H, N, hd] (views of any strides with a contiguous head dim),
    w_proj [H·hd, D_out] in q's dtype (the JAX layout; pass
    ``linear.weight.t()`` for a ``nn.Linear``) -> [B, N, D_out] in q's
    dtype. ``head_chunk`` and ``skew`` are accepted and ignored (on the TPU
    they only order f32 sums). CPU tensors take ``attention_proj_ref``;
    CUDA tensors launch the kernels or raise."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"attention_proj: q/k/v must share one [B, H, N, hd] shape, "
                         f"got {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    b, h, n, hd = q.shape
    if w_proj.dim() != 2 or w_proj.shape[0] != h * hd:
        raise ValueError(f"attention_proj: w_proj must be [{h * hd}, D_out], "
                         f"got {tuple(w_proj.shape)}")
    d_out = w_proj.shape[1]
    scale = hd ** -0.5 if scale is None else float(scale)
    if all(t.device.type == "cpu" for t in (q, k, v, w_proj)):
        return attention_proj_ref(q, k, v, w_proj, scale=scale)
    _launch.require_cuda("attention_proj", q, k, v, w_proj)
    code = _launch.dtype_code(q, "attention_proj")
    if k.dtype != q.dtype or v.dtype != q.dtype or w_proj.dtype != q.dtype:
        raise TypeError("attention_proj: q, k, v and w_proj must share one dtype")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"attention_proj: head dim {hd} not supported "
                         f"(kernel takes {SUPPORTED_HEAD_DIMS})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or not _launch.aligned(t, 8):
            raise ValueError(
                f"attention_proj: {name} needs a contiguous head dim, a 16-byte aligned "
                f"base and strides that are multiples of 8 (strides {t.stride()})")
    if d_out % 2:
        raise ValueError(f"attention_proj: D_out={d_out} must be even")
    _launch.check_gemm_rows(b * n, "attention_proj")
    w_nk = _launch.nk_weight(w_proj, "attention_proj")
    o = torch.empty((b, n, h * hd), dtype=q.dtype, device=q.device)
    out = torch.empty((b, n, d_out), dtype=q.dtype, device=q.device)
    rc = _build.load_library().anyloc_attention_proj(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), w_nk.data_ptr(), o.data_ptr(),
        out.data_ptr(), code, b, h, n, hd, d_out,
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), scale, _launch.stream(q))
    _build.check(rc, "attention_proj")
    attention_proj.launches += 1
    return out


attention_proj.launches = 0
