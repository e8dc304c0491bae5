"""K3 — the int8 W8A8 MLP half of a ViT block.

Hand-written Hopper kernels (``csrc/fused_mlp_int8.cu`` on the device code
of ``csrc/int8_common.cuh``) replacing
``anyloc_tpu/ops/pallas/fused_mlp.py::fused_mlp_int8`` (:250), both the
SwiGLU and the GELU variant. The MLP half of every trunk block in the
``int8_fused`` and ``int8_full`` modes.

Math (the Pallas kernel's): optional LayerNorm in f32; per-row int8
quantize; ``g = (acc · x_scale) · w_scale + b`` in f32; SwiGLU
``silu(g1) · g2`` or exact GELU through the Abramowitz-Stegun erf
polynomial; requantize g per (row, hidden chunk); the second product
accumulated chunk by chunk as ``(acc_c · g_scale_c) · w3_scale``; then
``+ b3``, ``· layerscale``, ``+ x`` (f32), cast to x's dtype.

The hidden chunk is the quantization group of the second product, so it
is part of the function: ``hidden_chunk=None`` takes the TPU kernel's rule
(``_pick_hidden_chunk(512, ...)``: a divisor of HID that is a multiple of
128, or the whole width for GELU), an explicit value is honoured as the
largest divisor of HID not above it (the rule the TPU kernel uses in
interpret mode).

K8 — the bf16 MLP half (``csrc/fused_mlp_bf16.cu``) replacing
``anyloc_tpu/ops/pallas/fused_mlp.py::fused_mlp_bf16`` (:414): K3's
dataflow without quantization, not wired into the trunk (as in the JAX
package). Math: optional LayerNorm in f32, written in x's dtype;
``g = silu(xn @ W1 + b1) · (xn @ W2 + b2)`` (or the erf-polynomial GELU of
``xn @ fc1 + b1``) in f32, rounded to x's dtype; ``g @ W3`` in f32,
``+ b3``, ``· layerscale``, ``+ x``, cast to x's dtype. Its hidden chunk
and row tile only order f32 sums on the TPU: accepted and ignored.
"""

from __future__ import annotations

from typing import Optional

import torch

from anyloc_tpu_torch import _build
from anyloc_tpu_torch.ops.kernels import _launch
from anyloc_tpu_torch.ops.quant import _int_mm, quantize_rows

MLP_TYPES = ("swiglu_fused", "mlp")


def _pick_hidden_chunk(hidden_chunk: int, hid: int, whole_ok: bool) -> Optional[int]:
    """The TPU kernel's hidden chunk (``fused_mlp.py:224-238``): the largest
    divisor of ``hid`` not above the request that is a multiple of 128,
    else the smallest one above it, else ``hid`` itself when ``whole_ok``
    (GELU), else None."""
    for hc in range(min(hidden_chunk, hid), 127, -1):
        if hid % hc == 0 and hc % 128 == 0:
            return hc
    for hc in range(min(hidden_chunk, hid) + 1, hid + 1):
        if hid % hc == 0 and hc % 128 == 0:
            return hc
    return hid if whole_ok else None


def int8_mlp_geometry_ok(mlp_type: str, hid: int) -> bool:
    """True iff the JAX trunk runs the fused MLP half for this hidden width
    (else it takes the per-row ``qdense`` composition)."""
    return _pick_hidden_chunk(512, hid, mlp_type != "swiglu_fused") is not None


def resolve_hidden_chunk(hidden_chunk: Optional[int], hid: int, mlp_type: str) -> int:
    if hidden_chunk is None:
        hc = _pick_hidden_chunk(512, hid, mlp_type != "swiglu_fused")
        if hc is None:
            raise ValueError(
                f"fused_mlp_int8: no hidden chunk that is a multiple of 128 "
                f"divides hid={hid}; gate with int8_mlp_geometry_ok() and use "
                "the per-row qdense MLP, or pass hidden_chunk")
        return hc
    if hidden_chunk < 1:
        raise ValueError(f"hidden_chunk must be >= 1, got {hidden_chunk}")
    hc = min(hidden_chunk, hid)
    while hid % hc:
        hc -= 1
    return hc


def ln_rows(xf: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float) -> torch.Tensor:
    """LayerNorm over the last dim in f32, as the TPU kernels compute it
    (``fused_mlp.py:76-80``): two-pass mean and variance."""
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def _erf_poly(x: torch.Tensor) -> torch.Tensor:
    """erf by Abramowitz & Stegun 7.1.26 (the TPU kernel's polynomial)."""
    a1, a2, a3, a4, a5 = 0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429
    ax = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def gelu_poly(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + _erf_poly(x * 2.0 ** -0.5))


def _check_shapes(x, w12_q, w3_q, mlp_type, name="fused_mlp_int8"):
    if mlp_type not in MLP_TYPES:
        raise ValueError(f"mlp_type must be one of {MLP_TYPES}, got {mlp_type!r}")
    d = x.shape[-1]
    hid = w3_q.shape[0]
    two = 2 if mlp_type == "swiglu_fused" else 1
    if tuple(w12_q.shape) != (d, two * hid) or tuple(w3_q.shape) != (hid, d):
        raise ValueError(f"{name} ({mlp_type}): w12 must be [{d}, {two * hid}] "
                         f"and w3 [{hid}, {d}], got {tuple(w12_q.shape)} {tuple(w3_q.shape)}")
    return d, hid


def row_quant_scratch(m: int, d: int, dev) -> list:
    """The per-row quantized input of K3, K4 and K9 in their C argument
    order: codes xq [M, D] int8, scales xs [M] f32."""
    return [torch.empty((m, d), dtype=torch.int8, device=dev),
            torch.empty((m,), dtype=torch.float32, device=dev)]


def mlp_int8_scratch(m: int, hid: int, n_chunks: int, dev) -> list:
    """K3's (and K9's) hidden activations in their C argument order: g
    [M, HID] f32, its codes gq [M, HID] int8, scales gs [M, chunks] f32."""
    return [torch.empty((m, hid), dtype=torch.float32, device=dev),
            torch.empty((m, hid), dtype=torch.int8, device=dev),
            torch.empty((m, n_chunks), dtype=torch.float32, device=dev)]


def _swiglu_or_gelu(g: torch.Tensor, hid: int, mlp_type: str) -> torch.Tensor:
    if mlp_type == "swiglu_fused":
        g1, g2 = g[:, :hid], g[:, hid:]
        return g1 / (1.0 + torch.exp(-g1)) * g2
    return gelu_poly(g)


def fused_mlp_int8_ref(
    x: torch.Tensor, w12_q, w12_scale, b12, w3_q, w3_scale, b3, *,
    mlp_type: str = "swiglu_fused", hidden_chunk: Optional[int] = None,
    ln_params: Optional[tuple] = None, ln_eps: float = 1e-6,
    layerscale: Optional[torch.Tensor] = None, residual: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel's math."""
    d, hid = _check_shapes(x, w12_q, w3_q, mlp_type)
    hc = resolve_hidden_chunk(hidden_chunk, hid, mlp_type)
    x2 = x.reshape(-1, d)
    xf = x2.float()
    if ln_params is not None:
        xf = ln_rows(xf, *ln_params, ln_eps)
    xq, xs = quantize_rows(xf)
    g = _int_mm(xq, w12_q).float() * xs * w12_scale.float()
    if b12 is not None:
        g = g + b12.float()
    g = _swiglu_or_gelu(g, hid, mlp_type)
    acc = torch.zeros((x2.shape[0], d), dtype=torch.float32, device=x.device)
    for c in range(0, hid, hc):
        gq, gs = quantize_rows(g[:, c:c + hc])
        acc = acc + _int_mm(gq, w3_q[c:c + hc]).float() * gs * w3_scale.float()
    if b3 is not None:
        acc = acc + b3.float()
    if layerscale is not None:
        acc = acc * layerscale.float()
    if residual:
        acc = acc + x2.float()
    return acc.to(x.dtype).reshape(x.shape)


def fused_mlp_int8(
    x: torch.Tensor, w12_q, w12_scale, b12, w3_q, w3_scale, b3, *,
    mlp_type: str = "swiglu_fused", hidden_chunk: Optional[int] = None,
    ln_params: Optional[tuple] = None, ln_eps: float = 1e-6,
    layerscale: Optional[torch.Tensor] = None, residual: bool = False,
) -> torch.Tensor:
    """x [..., D] -> MLP half [..., D] with int8 W8A8 products.

    Weights in the JAX layout: ``swiglu_fused`` w12_q int8 [D, 2·HID]
    (W1 | W2 column blocks), ``mlp`` w12_q = fc1 [D, HID]; w3_q [HID, D];
    per-output-column f32 scales; optional biases. For ``nn.Linear``-layout
    codes [out, in] pass ``weight_q.t()`` (the kernel reads that storage
    as it is, no copy). ``ln_params=(scale, bias)`` applies LayerNorm to x
    first; ``layerscale`` multiplies the MLP output; ``residual`` adds x.
    CPU tensors take ``fused_mlp_int8_ref``; CUDA tensors launch the kernels
    or raise."""
    d, hid = _check_shapes(x, w12_q, w3_q, mlp_type)
    hc = resolve_hidden_chunk(hidden_chunk, hid, mlp_type)
    vecs = dict(w12_scale=w12_scale, b12=b12, w3_scale=w3_scale, b3=b3, layerscale=layerscale)
    if ln_params is not None:
        vecs.update(ln_scale=ln_params[0], ln_bias=ln_params[1])
    tensors = [x, w12_q, w3_q] + [t for t in vecs.values() if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return fused_mlp_int8_ref(
            x, w12_q, w12_scale, b12, w3_q, w3_scale, b3, mlp_type=mlp_type,
            hidden_chunk=hc, ln_params=ln_params, ln_eps=ln_eps,
            layerscale=layerscale, residual=residual)
    _launch.require_cuda("fused_mlp_int8", *tensors)
    code = _launch.dtype_code(x, "fused_mlp_int8")
    if w12_q.dtype != torch.int8 or w3_q.dtype != torch.int8:
        raise TypeError("fused_mlp_int8: w12_q and w3_q must be int8")
    if d % 16 or hid % 32 or hc % 32:
        raise ValueError(f"fused_mlp_int8: the kernel needs D % 16 == 0 and HID and the "
                         f"hidden chunk % 32 == 0 (D={d}, HID={hid}, chunk={hc})")
    widths = dict(w12_scale=w12_q.shape[1], b12=w12_q.shape[1], w3_scale=d, b3=d,
                  layerscale=d, ln_scale=d, ln_bias=d)
    for name, vec in vecs.items():
        if vec is not None and tuple(vec.shape) != (widths[name],):
            raise ValueError(f"fused_mlp_int8: {name} must be [{widths[name]}], "
                             f"got {tuple(vec.shape)}")
    w12_nk = _launch.nk_weight(w12_q, "fused_mlp_int8")
    w3_nk = _launch.nk_weight(w3_q, "fused_mlp_int8")
    f32 = {k: None if v is None else v.float().contiguous() for k, v in vecs.items()}
    x2 = x.reshape(-1, d).contiguous()
    m = x2.shape[0]
    _launch.check_gemm_rows(m, "fused_mlp_int8")
    scratch = (row_quant_scratch(m, d, x.device)
               + mlp_int8_scratch(m, hid, hid // hc, x.device))
    out = torch.empty_like(x2)
    p = _launch.ptr
    rc = _build.load_library().anyloc_fused_mlp_int8(
        x2.data_ptr(), p(f32.get("ln_scale")), p(f32.get("ln_bias")),
        w12_nk.data_ptr(), f32["w12_scale"].data_ptr(), p(f32["b12"]),
        w3_nk.data_ptr(), f32["w3_scale"].data_ptr(), p(f32["b3"]), p(f32["layerscale"]),
        *[t.data_ptr() for t in scratch],
        out.data_ptr(), code, code, m, d, hid, hc, int(mlp_type == "swiglu_fused"),
        int(residual), float(ln_eps), _launch.stream(x))
    _build.check(rc, "fused_mlp_int8")
    fused_mlp_int8.launches += 1
    return out.reshape(x.shape)


fused_mlp_int8.launches = 0


# ---------------------------------------------------------------- K8


def fused_mlp_bf16_ref(
    x: torch.Tensor, w12, b12, w3, b3, *, mlp_type: str = "swiglu_fused",
    hidden_chunk: int = 512, m_tile: int = 1088, ln_params: Optional[tuple] = None,
    ln_eps: float = 1e-6, layerscale: Optional[torch.Tensor] = None, residual: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel's math."""
    d, hid = _check_shapes(x, w12, w3, mlp_type, "fused_mlp_bf16")
    x2 = x.reshape(-1, d)
    xf = x2.float()
    if ln_params is not None:
        xf = ln_rows(xf, *ln_params, ln_eps)
    g = xf.to(x.dtype).float() @ w12.float()
    if b12 is not None:
        g = g + b12.float()
    g = _swiglu_or_gelu(g, hid, mlp_type).to(x.dtype)
    acc = g.float() @ w3.float()
    if b3 is not None:
        acc = acc + b3.float()
    if layerscale is not None:
        acc = acc * layerscale.float()
    if residual:
        acc = acc + x2.float()
    return acc.to(x.dtype).reshape(x.shape)


def fused_mlp_bf16(
    x: torch.Tensor, w12, b12, w3, b3, *, mlp_type: str = "swiglu_fused",
    hidden_chunk: int = 512, m_tile: int = 1088, ln_params: Optional[tuple] = None,
    ln_eps: float = 1e-6, layerscale: Optional[torch.Tensor] = None, residual: bool = False,
) -> torch.Tensor:
    """x [..., D] -> MLP half [..., D] with float weights.

    Weights in x's dtype and the JAX layout: ``swiglu_fused`` w12 [D, 2·HID]
    (W1 | W2 column blocks), ``mlp`` w12 = fc1 [D, HID]; w3 [HID, D]; for
    ``nn.Linear`` storage pass ``weight.t()`` (read as it is, no copy).
    Biases, LN parameters and layerscale of any float dtype, used in f32.
    ``ln_params=(scale, bias)`` applies LayerNorm to x first; ``residual``
    adds x. ``hidden_chunk`` and ``m_tile`` are accepted and ignored (TPU
    tilings), except that a SwiGLU width the TPU kernel refuses is refused
    here too. CPU tensors take ``fused_mlp_bf16_ref``; CUDA tensors launch
    the kernels or raise."""
    d, hid = _check_shapes(x, w12, w3, mlp_type, "fused_mlp_bf16")
    vecs = dict(b12=b12, b3=b3, layerscale=layerscale)
    if ln_params is not None:
        vecs.update(ln_scale=ln_params[0], ln_bias=ln_params[1])
    tensors = [x, w12, w3] + [t for t in vecs.values() if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return fused_mlp_bf16_ref(x, w12, b12, w3, b3, mlp_type=mlp_type, ln_params=ln_params,
                                  ln_eps=ln_eps, layerscale=layerscale, residual=residual)
    _launch.require_cuda("fused_mlp_bf16", *tensors)
    code = _launch.dtype_code(x, "fused_mlp_bf16")
    if w12.dtype != x.dtype or w3.dtype != x.dtype:
        raise TypeError("fused_mlp_bf16: w12 and w3 must have x's dtype")
    if _pick_hidden_chunk(hidden_chunk, hid, mlp_type != "swiglu_fused") is None:
        raise ValueError(f"fused_mlp_bf16: no hidden chunk that is a multiple of 128 "
                         f"divides hid={hid} (the TPU kernel's lane rule)")
    if d % 8 or hid % 8:
        raise ValueError(f"fused_mlp_bf16: the kernel needs D and HID % 8 == 0 "
                         f"(D={d}, HID={hid})")
    widths = dict(b12=w12.shape[1], b3=d, layerscale=d, ln_scale=d, ln_bias=d)
    for name, vec in vecs.items():
        if vec is not None and tuple(vec.shape) != (widths[name],):
            raise ValueError(f"fused_mlp_bf16: {name} must be [{widths[name]}], "
                             f"got {tuple(vec.shape)}")
    w12_nk = _launch.nk_weight(w12, "fused_mlp_bf16")
    w3_nk = _launch.nk_weight(w3, "fused_mlp_bf16")
    f32 = {k: None if v is None else v.float().contiguous() for k, v in vecs.items()}
    x2 = x.reshape(-1, d).contiguous()
    m = x2.shape[0]
    _launch.check_gemm_rows(m, "fused_mlp_bf16")
    xn = torch.empty_like(x2) if ln_params is not None else None
    g = torch.empty((m, hid), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x2)
    p = _launch.ptr
    rc = _build.load_library().anyloc_fused_mlp_bf16(
        x2.data_ptr(), p(f32.get("ln_scale")), p(f32.get("ln_bias")), w12_nk.data_ptr(),
        p(f32["b12"]), w3_nk.data_ptr(), p(f32["b3"]), p(f32["layerscale"]), p(xn),
        g.data_ptr(), out.data_ptr(), code, m, d, hid, int(mlp_type == "swiglu_fused"),
        int(residual), float(ln_eps), _launch.stream(x))
    _build.check(rc, "fused_mlp_bf16")
    fused_mlp_bf16.launches += 1
    return out.reshape(x.shape)


fused_mlp_bf16.launches = 0
