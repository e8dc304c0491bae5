"""Shared numeric helpers for the ops layer (counterpart of
``anyloc_tpu/ops/common.py``).

Float32 products that decide rankings (cluster assignment, retrieval
scores) run in full float32: the port relies on PyTorch's defaults
(``torch.backends.cuda.matmul.allow_tf32`` False, float32 matmul precision
"highest") and never flips them.
"""

from __future__ import annotations

import torch

# torch.nn.functional.normalize uses x / max(||x||, eps) with eps=1e-12; the
# JAX package matches that, and so does the port.
NORM_EPS = 1e-12


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = NORM_EPS) -> torch.Tensor:
    """``x / max(||x||, eps)`` along ``dim`` — zero vectors stay zero."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp_min(norm, eps)


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


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
