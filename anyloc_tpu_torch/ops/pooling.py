"""Global pooling descriptors: max / avg over tokens, MAC / SPoC / R-MAC
over spatial maps (counterpart of ``anyloc_tpu/ops/pooling.py``; the
reference's scripts/dino_v2_gp.py and dvgl_benchmark/model/functional.py:29-84).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from anyloc_tpu_torch.ops.common import l2_normalize


def global_max_pool(descs: torch.Tensor) -> torch.Tensor:
    """[..., N, D] -> [..., D]: max over the patches (MAC over tokens)."""
    return descs.amax(dim=-2)


def global_avg_pool(descs: torch.Tensor) -> torch.Tensor:
    """[..., N, D] -> [..., D]: mean over the patches (SPoC over tokens)."""
    return descs.mean(dim=-2)


def mac_spatial(x: torch.Tensor) -> torch.Tensor:
    """MAC over a spatial map [..., H, W, C] -> [..., C]."""
    return x.amax(dim=(-3, -2))


def spoc_spatial(x: torch.Tensor) -> torch.Tensor:
    """SPoC over a spatial map [..., H, W, C] -> [..., C]."""
    return x.mean(dim=(-3, -2))


def rmac_regions(h: int, w: int, levels: int = 3,
                 overlap: float = 0.4) -> List[Tuple[int, int, int]]:
    """The R-MAC region grid as (y0, x0, size) ints: at level l an l x ~l
    grid of square regions with ~40 % overlap (host arithmetic)."""
    min_hw = min(h, w)
    regions = []
    for l in range(1, levels + 1):
        size = max(1, int(2 * min_hw / (l + 1)))
        if l == 1 and h == w:
            regions.append((0, 0, size))
            continue
        n_h = max(1, int(round((h - size) / max(size * (1 - overlap), 1))) + 1)
        n_w = max(1, int(round((w - size) / max(size * (1 - overlap), 1))) + 1)
        ys = [0] if n_h == 1 else [int(round(i * (h - size) / (n_h - 1))) for i in range(n_h)]
        xs = [0] if n_w == 1 else [int(round(i * (w - size) / (n_w - 1))) for i in range(n_w)]
        for y0 in ys:
            for x0 in xs:
                regions.append((y0, x0, size))
    return regions


def rmac_spatial(x: torch.Tensor, levels: int = 3) -> torch.Tensor:
    """R-MAC over [..., H, W, C]: the MAC of each region, L2-normalized,
    summed -> [..., C]."""
    acc = None
    for y0, x0, s in rmac_regions(x.shape[-3], x.shape[-2], levels):
        r = l2_normalize(x[..., y0:y0 + s, x0:x0 + s, :].amax(dim=(-3, -2)))
        acc = r if acc is None else acc + r
    return acc
