"""K2 — flash attention over head-split [B, H, N, hd] tensors.

Hand-written Hopper kernel (``csrc/flash_attention.cu``) replacing the
three TPU tilings of one function in
``anyloc_tpu/ops/pallas/flash_attention.py``: ``flash_attention`` (:62),
``flash_attention_heads`` (:139) and ``flash_attention_blocked`` (:241).
The trunk calls it for sequences longer than ``MAX_FUSED_TOKENS`` (the
1022-px demo shape, 5330 tokens); shorter ones take K5.

Math: ``s = (q·kᵀ with f32 sums) * scale`` in f32, padded/ragged keys
never contribute, softmax in f32, P rounded to v's dtype before the PV
product, output in q's dtype.

Under autograd (a tensor-parallel trunk in training) the launch runs
inside ``FlashAttentionGrad``: the kernel forward, the plain version's
gradient backward, as K5's ``QkvProjGrad`` (no Pallas kernel has a
backward, F19).
"""

from __future__ import annotations

from typing import Optional

import torch

from anyloc_tpu_torch import _build
from anyloc_tpu_torch.ops.kernels import _launch

# every kernel on the shared attention core (K2, K4-K7, K9, T3) takes these;
# hd 80 is MAE-H, ImageBind-H and SAM-H
SUPPORTED_HEAD_DIMS = (16, 32, 64, 80, 128)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel's math (materializes the
    [B, H, N, N] scores)."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    o = p.to(v.dtype).float() @ v.float()
    return o.to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q kᵀ · scale) v over [B, H, N, hd] -> [B, H, N, hd].

    q/k/v may be strided views (for example head-split views of a fused
    [B, N, 3D] tensor) as long as the head dim is contiguous. CPU tensors
    take ``flash_attention_ref``; CUDA tensors launch the kernel or raise.
    """
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash_attention: q/k/v must share one [B, H, N, hd] "
                         f"shape, got {q.shape} {k.shape} {v.shape}")
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale=scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionGrad.apply(_flash_launch, scale, q, k, v)
    return _flash_launch(q, k, v, scale=scale)


class FlashAttentionGrad(torch.autograd.Function):
    """K2 with a gradient: ``forward`` runs ``kernel`` (the launch; the
    tests fill the slot with the plain version on the CPU) on q, k, v as
    given; ``backward`` recomputes ``flash_attention_ref`` under autograd
    on detached copies of them and returns its gradients, the JAX XLA
    attention route's gradient."""

    @staticmethod
    def forward(ctx, kernel, scale, q, k, v):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v)
        return kernel(q, k, v, scale=scale)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = flash_attention_ref(*inputs, scale=ctx.scale)
        grads = iter(torch.autograd.grad(out, wanted, grad))
        return (None, None) + tuple(next(grads) if t.requires_grad else None for t in inputs)


def _flash_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float) -> torch.Tensor:
    """K2's launch on CUDA tensors (shapes checked by the caller)."""
    b, h, n, hd = q.shape
    _launch.require_cuda("flash_attention", q, k, v)
    code = _launch.dtype_code(q, "flash_attention")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share one dtype")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not supported "
                         f"(kernel takes {SUPPORTED_HEAD_DIMS})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or not _launch.aligned(t, 8):
            raise ValueError(
                f"flash_attention: {name} needs a contiguous head dim, a "
                f"16-byte aligned base and strides that are multiples of 8 "
                f"(strides {t.stride()})")
    # [B, N, H, hd] storage: the caller's merge back to [B, N, H*hd] is free
    out = torch.empty((b, n, h, hd), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    rc = _build.load_library().anyloc_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), code,
        b, h, n, hd,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        scale, _launch.stream(q))
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

