"""K9 — a whole pre-norm int8 W8A8 ViT block in one call.

Hand-written Hopper kernels (``csrc/fused_block_int8.cu``: K4's attention
half with its residual written in f32, then K3's MLP half reading that f32
x2) replacing ``anyloc_tpu/ops/pallas/fused_block.py::fused_block_int8``
(:128). Not wired into the trunk, as in the JAX package; the block-variant
tool ``anyloc_tpu_torch/tools/bench_fused_block.py`` drives it.

Math (the Pallas kernel's): K4's math up to ``x2 = x + gamma1 · (acc1 +
b_proj)``, which stays f32 (never rounded to x's dtype); then K3's math on
x2 (LN2, per-row quantize, int8 w12, SwiGLU / GELU, requantize per (row,
hidden chunk), int8 w3) and ``out = x2 + gamma2 · (acc2 + b3)``, cast to
x's dtype. So it equals K4 then K3 in f32, and differs from them in bf16
only by the rounding of x2.

The head chunk and the hidden chunk are quantization groups, as in K4 and
K3: ``None`` takes the TPU rules, an explicit value is honoured as the
largest divisor not above it. The TPU kernel in interpret mode ignores both
and uses whole-width groups (F7 in ROADMAP.md), so a comparison with it
passes ``head_chunk=num_heads, hidden_chunk=HID``. Like the TPU wrapper,
this one refuses a geometry with no lane-valid chunk.
"""

from __future__ import annotations

from typing import Optional

import torch

from anyloc_tpu_torch import _build
from anyloc_tpu_torch.ops.kernels import _launch
from anyloc_tpu_torch.ops.kernels.attn_proj import (
    _check_attn_half,
    attn_geometry_ok,
    attn_half_int8_scratch,
    fused_attn_half_int8_ref,
    resolve_head_chunk,
)
from anyloc_tpu_torch.ops.kernels.flash_attention import SUPPORTED_HEAD_DIMS
from anyloc_tpu_torch.ops.kernels.fused_mlp import (
    _check_shapes,
    fused_mlp_int8_ref,
    int8_mlp_geometry_ok,
    mlp_int8_scratch,
    resolve_hidden_chunk,
    row_quant_scratch,
)


def _resolve(x, attn_p, mlp_p, num_heads, mlp_type, head_chunk, hidden_chunk):
    b, n, d, hd = _check_attn_half(x, attn_p[0], attn_p[3], num_heads)
    _, hid = _check_shapes(x, mlp_p[0], mlp_p[3], mlp_type, "fused_block_int8")
    if not (attn_geometry_ok(num_heads, hd) and int8_mlp_geometry_ok(mlp_type, hid)):
        raise ValueError("fused_block_int8 geometry unsupported (lane alignment); gate with "
                         "attn_geometry_ok/int8_mlp_geometry_ok")
    hc = resolve_head_chunk(n, num_heads, hd, head_chunk)
    mc = resolve_hidden_chunk(hidden_chunk, hid, mlp_type)
    return b, n, d, hd, hid, hc, mc


def fused_block_int8_ref(
    x: torch.Tensor, attn_p: tuple, mlp_p: tuple, *, num_heads: int, ln1: tuple,
    ln2: tuple, gamma1: Optional[torch.Tensor] = None, gamma2: Optional[torch.Tensor] = None,
    mlp_type: str = "swiglu_fused", ln_eps: float = 1e-6, head_chunk: Optional[int] = None,
    hidden_chunk: Optional[int] = None, return_x2: bool = False,
):
    """Plain PyTorch version of the kernel's math: K4's plain version on the
    f32 x (so x2 stays f32), then K3's on x2, rounded once to x's dtype;
    with ``return_x2`` also that f32 x2 [B, N, D]."""
    *_, hc, mc = _resolve(x, attn_p, mlp_p, num_heads, mlp_type, head_chunk, hidden_chunk)
    x2 = fused_attn_half_int8_ref(x.float(), *attn_p, num_heads=num_heads, ln_params=ln1,
                                  ln_eps=ln_eps, layerscale=gamma1, head_chunk=hc)
    out = fused_mlp_int8_ref(x2, *mlp_p, mlp_type=mlp_type, hidden_chunk=mc, ln_params=ln2,
                             ln_eps=ln_eps, layerscale=gamma2, residual=True)
    return (out.to(x.dtype), x2) if return_x2 else out.to(x.dtype)


def fused_block_int8(
    x: torch.Tensor, attn_p: tuple, mlp_p: tuple, *, num_heads: int, ln1: tuple,
    ln2: tuple, gamma1: Optional[torch.Tensor] = None, gamma2: Optional[torch.Tensor] = None,
    mlp_type: str = "swiglu_fused", ln_eps: float = 1e-6, head_chunk: Optional[int] = None,
    hidden_chunk: Optional[int] = None, return_x2: bool = False,
):
    """out = Block(x) for a pre-norm int8 ViT block.

    x [B, N, D] (bf16 or f32). ``attn_p = (wqkv_q, wqkv_scale, b_qkv,
    wp_q, wp_scale, b_proj)`` and ``mlp_p = (w12_q, w12_scale, b12, w3_q,
    w3_scale, b3)`` in the JAX layout, as ``fused_attn_half_int8`` and
    ``fused_mlp_int8`` take them (int8 codes [in, out]; for ``nn.Linear``
    storage pass ``weight_q.t()``, read as it is); biases may be None.
    ``ln1``/``ln2`` = (scale, bias) of norm1/norm2, ``gamma1``/``gamma2``
    the LayerScales (None: 1). ``return_x2`` also returns the f32 x2
    [B, N, D] that the MLP half read, the one thing K9 adds over K4 -> K3,
    for checks. CPU tensors take ``fused_block_int8_ref``; CUDA tensors
    launch the kernels or raise."""
    b, n, d, hd, hid, hc, mc = _resolve(x, attn_p, mlp_p, num_heads, mlp_type, head_chunk,
                                        hidden_chunk)
    wqkv_q, wqkv_s, b_qkv, wp_q, wp_s, b_proj = attn_p
    w12_q, w12_s, b12, w3_q, w3_s, b3 = mlp_p
    two = 2 if mlp_type == "swiglu_fused" else 1
    vecs = dict(wqkv_scale=(wqkv_s, 3 * d), b_qkv=(b_qkv, 3 * d), wp_scale=(wp_s, d),
                b_proj=(b_proj, d), ln1_scale=(ln1[0], d), ln1_bias=(ln1[1], d),
                gamma1=(gamma1, d), w12_scale=(w12_s, two * hid), b12=(b12, two * hid),
                w3_scale=(w3_s, d), b3=(b3, d), ln2_scale=(ln2[0], d), ln2_bias=(ln2[1], d),
                gamma2=(gamma2, d))
    tensors = [x, wqkv_q, wp_q, w12_q, w3_q] + [t for t, _ in vecs.values() if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return fused_block_int8_ref(x, attn_p, mlp_p, num_heads=num_heads, ln1=ln1, ln2=ln2,
                                    gamma1=gamma1, gamma2=gamma2, mlp_type=mlp_type,
                                    ln_eps=ln_eps, head_chunk=hc, hidden_chunk=mc,
                                    return_x2=return_x2)
    _launch.require_cuda("fused_block_int8", *tensors)
    code = _launch.dtype_code(x, "fused_block_int8")
    if any(w.dtype != torch.int8 for w in (wqkv_q, wp_q, w12_q, w3_q)):
        raise TypeError("fused_block_int8: the weight codes must be int8")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"fused_block_int8: head dim {hd} not supported "
                         f"(kernel takes {SUPPORTED_HEAD_DIMS})")
    if d % 32 or (hc * hd) % 32 or hid % 32 or mc % 32:
        raise ValueError(f"fused_block_int8: the kernels need D, HID and both chunk widths "
                         f"% 32 == 0 (D={d}, head chunk {hc} x {hd}, HID={hid}, chunk {mc})")
    for name, (vec, want) in vecs.items():
        if vec is not None and tuple(vec.shape) != (want,):
            raise ValueError(f"fused_block_int8: {name} must be [{want}], "
                             f"got {tuple(vec.shape)}")
    m = b * n
    _launch.check_gemm_rows(m, "fused_block_int8")
    w_nk = [_launch.nk_weight(w, "fused_block_int8") for w in (wqkv_q, wp_q, w12_q, w3_q)]
    f32 = {k: None if v is None else v.float().contiguous() for k, (v, _) in vecs.items()}
    x = x.contiguous()
    x2 = torch.empty((m, d), dtype=torch.float32, device=x.device)
    scratch = (row_quant_scratch(m, d, x.device)
               + attn_half_int8_scratch(m, d, num_heads // hc, x.device) + [x2]
               + mlp_int8_scratch(m, hid, hid // mc, x.device))
    out = torch.empty_like(x)
    p = _launch.ptr
    rc = _build.load_library().anyloc_fused_block_int8(
        x.data_ptr(), f32["ln1_scale"].data_ptr(), f32["ln1_bias"].data_ptr(),
        w_nk[0].data_ptr(), f32["wqkv_scale"].data_ptr(), p(f32["b_qkv"]),
        w_nk[1].data_ptr(), f32["wp_scale"].data_ptr(), p(f32["b_proj"]), p(f32["gamma1"]),
        f32["ln2_scale"].data_ptr(), f32["ln2_bias"].data_ptr(),
        w_nk[2].data_ptr(), f32["w12_scale"].data_ptr(), p(f32["b12"]),
        w_nk[3].data_ptr(), f32["w3_scale"].data_ptr(), p(f32["b3"]), p(f32["gamma2"]),
        *[t.data_ptr() for t in scratch], out.data_ptr(),
        code, b, n, num_heads, hd, hc, hid, mc, int(mlp_type == "swiglu_fused"),
        float(ln_eps), hd ** -0.5, _launch.stream(x))
    _build.check(rc, "fused_block_int8")
    fused_block_int8.launches += 1
    return (out, x2.view(b, n, d)) if return_x2 else out


fused_block_int8.launches = 0
