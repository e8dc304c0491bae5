"""GeM (generalized-mean) pooling over patch descriptors (counterpart of
``anyloc_tpu/ops/gem.py``; reference scripts/dino_v2_gem.py:170-190).

The reference takes ``mean(descs ** p)`` over the patches and keeps the
sign of a negative mean through a complex power at the 1/p step; for the
default p = 3 that reduces to ``sign(x) * |x| ** (1/p)``, computed here
directly. ``descs ** p`` of a negative value is NaN for a non-integer p in
torch as in XLA.
"""

from __future__ import annotations

import torch


def gem_pool(descs: torch.Tensor, p: float = 3.0, use_abs: bool = False,
             eps: float = 0.0) -> torch.Tensor:
    """GeM pool patch descriptors [..., N, D] -> [..., D] float32 on their
    device. ``use_abs`` is ``--gem-use-abs`` (mean of |d|^p); otherwise the
    signed variant (the reference default)."""
    descs = descs.float()
    if use_abs:
        return (descs.abs() ** p).mean(-2) ** (1.0 / p)
    x = (descs ** p).mean(-2)
    if eps:
        x = torch.where(x.abs() < eps, torch.sign(x) * eps, x)
    return torch.sign(x) * x.abs() ** (1.0 / p)


def gem_pool_spatial(x: torch.Tensor, p: float = 3.0, eps: float = 1e-6) -> torch.Tensor:
    """CNN-style GeM over the spatial dims of non-negative feature maps
    [..., H, W, C] -> [..., C]: clamp at ``eps``, then the p-mean
    (dvgl_benchmark/model/functional.py:43-47)."""
    x = torch.clamp_min(x.float(), eps)
    return (x ** p).mean(dim=(-3, -2)) ** (1.0 / p)
