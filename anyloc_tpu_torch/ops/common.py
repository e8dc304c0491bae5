"""Shared numeric helpers for the ops layer (counterpart of
``anyloc_tpu/ops/common.py``).

Float32 products that decide rankings (cluster assignment, retrieval
scores) run in full float32: the port relies on PyTorch's defaults
(``torch.backends.cuda.matmul.allow_tf32`` False, float32 matmul precision
"highest") and never flips them. cuDNN's convolutions default to TF32
(``torch.backends.cudnn.allow_tf32`` True), so every convolution of the
port is a ``Conv2d`` below, which runs a float32 one in full float32
whatever the process's flags say (F17).
"""

from __future__ import annotations

from typing import Union

import torch
import torch.nn.functional as F
from torch import nn

# torch.nn.functional.normalize uses x / max(||x||, eps) with eps=1e-12; the
# JAX package matches that, and so does the port.
NORM_EPS = 1e-12


def l2_normalize(x: torch.Tensor, axis: int = -1, eps: float = NORM_EPS) -> torch.Tensor:
    """``x / max(||x||, eps)`` along ``axis`` — zero vectors stay zero."""
    norm = torch.linalg.vector_norm(x, dim=axis, keepdim=True)
    return x / torch.clamp_min(norm, eps)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (zero padding) that runs a float32 input in full
    float32 (F17): cuDNN's convolution precision is set to "ieee" for the
    call, then put back as it was. It uses the per-operator
    ``torch.backends.cudnn.conv.fp32_precision`` only (not the legacy
    ``allow_tf32``, whose mixing with it can raise). Every convolution of
    the port is one."""

    def _conv_forward(self, input: torch.Tensor, weight: torch.Tensor, bias):
        def conv():
            return F.conv2d(input, weight, bias, self.stride, self.padding, self.dilation,
                            self.groups)

        if input.dtype != torch.float32:
            return conv()
        flags = torch.backends.cudnn.conv
        before = flags.fp32_precision
        flags.fp32_precision = "ieee"
        try:
            return conv()
        finally:
            flags.fp32_precision = before


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another one. With no card and no device named it raises; it never
    falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller "
            "names another device (device='cpu' runs the plain PyTorch path)")
    return torch.device("cuda")


def score_dot(score_dtype: str = "float32"):
    """The retrieval scoring product ``a @ b`` -> float32.

    "float32": full float32 (ranking-exact, FAISS semantics); "bfloat16":
    bf16 operands, float32 result (near-ties can flip)."""
    if score_dtype == "bfloat16":
        def dot(a, b):
            return (a.to(torch.bfloat16) @ b.to(torch.bfloat16)).float()
    elif score_dtype == "float32":
        def dot(a, b):
            return a.float() @ b.float()
    else:
        raise ValueError(f"Unknown score_dtype: {score_dtype}")
    return dot


def bf16_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` [M, K] x [K, N] with bf16 operands and float32 sums and
    result (the JAX package's ``preferred_element_type=float32`` products).
    On the card the tensor cores take it through ``mm``'s ``out_dtype``;
    on the CPU the operands are rounded to bf16 and multiplied in float32,
    the same math (a product of two bf16 values is exact in float32), as
    the JAX package emulates it off the TPU."""
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if a16.is_cuda:
        return torch.mm(a16, b16, out_dtype=torch.float32)
    return a16.float() @ b16.float()


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
