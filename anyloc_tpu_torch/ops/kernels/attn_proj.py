"""K5 — attention read straight from the fused qkv tensor, then the output
projection with bias, LayerScale and residual.

Hand-written Hopper kernels (``csrc/attn_qkv_proj.cu``, reusing K2's
device attention code through strided column views) replacing
``anyloc_tpu/ops/pallas/attn_proj.py::flash_attention_qkv_proj`` (:327).
The attention half of every trunk block at N <= ``MAX_FUSED_TOKENS``.

Math (K5's rounding, which differs from K2's): q * scale in f32, rounded
to qkv's dtype, then f32-summed scores; softmax in f32; P in v's dtype;
each head's output rounded to v's dtype; ``o_cat @ w_proj`` summed in f32,
+ bias, * layerscale, + residual (read as f32), cast to qkv's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

from anyloc_tpu_torch import _build
from anyloc_tpu_torch.ops.kernels import _launch
from anyloc_tpu_torch.ops.kernels.flash_attention import SUPPORTED_HEAD_DIMS

# The TPU kernel's token bound (anyloc_tpu/ops/pallas/attn_proj.py:41); the
# trunk keeps the same routing: N <= this -> K5, longer -> K2 + plain proj.
MAX_FUSED_TOKENS = 1216


def _split_heads(qkv: torch.Tensor, num_heads: int):
    b, n, three_d = qkv.shape
    d = three_d // 3
    hd = d // num_heads
    return [qkv[..., i * d:(i + 1) * d].reshape(b, n, num_heads, hd).transpose(1, 2)
            for i in range(3)]


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
    q = (q.float() * scale).to(qkv.dtype)
    s = q.float() @ k.float().transpose(-1, -2)
    p = torch.softmax(s, dim=-1)
    o = (p.to(v.dtype).float() @ v.float()).to(v.dtype)
    o_cat = o.transpose(1, 2).reshape(b, n, d)
    out = o_cat.float() @ w_proj.float()
    if b_proj is not None:
        out = out + b_proj.float()
    if layerscale is not None:
        out = out * layerscale.float()
    if residual is not None:
        out = out + residual.float()
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
    if b * n > 64 * 65535:  # the GEMM puts 64-row tiles on the grid's y axis
        raise ValueError(f"flash_attention_qkv_proj: B*N = {b * n} rows > "
                         f"{64 * 65535}; split the batch")
    if residual is not None and not residual.is_contiguous():
        raise ValueError("flash_attention_qkv_proj: residual must be contiguous")
    # the kernel reads W_O as [D_out, D] rows; a Linear weight's .t() view
    # is exactly that, so the usual caller pays no copy
    w_nk = w_proj.t().contiguous()
    if w_nk.data_ptr() % 16:
        raise ValueError("flash_attention_qkv_proj: w_proj must be 16-byte aligned")
    bias = None if b_proj is None else b_proj.float().contiguous()
    gamma = None if layerscale is None else layerscale.float().contiguous()
    o = torch.empty((b, n, d), dtype=qkv.dtype, device=qkv.device)
    out = torch.empty((b, n, d_out), dtype=qkv.dtype, device=qkv.device)
    rc = _build.load_library().anyloc_attn_qkv_proj(
        qkv.data_ptr(), w_nk.data_ptr(), _launch.ptr(bias), _launch.ptr(gamma),
        _launch.ptr(residual), o.data_ptr(), out.data_ptr(), code,
        b, n, num_heads, hd, d_out, scale, _launch.stream(qkv))
    _build.check(rc, "flash_attention_qkv_proj")
    flash_attention_qkv_proj.launches += 1
    return out


flash_attention_qkv_proj.launches = 0
