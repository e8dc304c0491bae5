"""Learned aggregation heads (counterpart of
``anyloc_tpu/training/aggregators.py``):

  * NetVLAD: dvgl_benchmark/model/aggregation.py:85-174 (soft assignment
    by a learned 1x1 projection, residuals to learned centroids in the
    rank-1 form ``a^T x - (sum a) c``, intra-norm, flatten, L2);
  * GeM head: CosPlace/model/network.py:22-44 (L2 -> GeM -> Linear -> L2);
  * GeMPool, ConvAP, MixVPR: MixVPR/models/aggregators/{gem,convap,mixvpr}.py.

Heads take token features [B, N, D] (a CNN map reshaped [B, h*w, C]);
ConvAP takes the map [B, h, w, C]. Flax infers input widths at the first
call; these modules take them as keywords after the JAX fields
(``in_dim``, ``in_channels``, ``n_tokens``). NetVLAD stays plain torch,
as in the JAX package (its assignment is a learned projection, not K1's
center similarity).
"""

from __future__ import annotations

import torch
from torch import nn

from anyloc_tpu_torch.ops.common import l2_normalize

_TRAINING = '(ROADMAP.md, port queue: "Training")'


class NetVLAD(nn.Module):
    """NetVLAD with a learned soft assignment: [B, N, D] -> [B, C*D]."""

    def __init__(self, num_clusters: int = 64, dim: int = 256) -> None:
        super().__init__()
        self.num_clusters, self.dim = num_clusters, dim
        self.assign = nn.Linear(dim, num_clusters, bias=False)
        self.centroids = nn.Parameter(torch.empty(num_clusters, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        if d != self.dim:
            raise ValueError(f"expected dim {self.dim}, got {d}")
        a = torch.softmax(self.assign(x), dim=-1)                    # [B, N, C]
        v = torch.einsum("bnc,bnd->bcd", a, x) - a.sum(1)[..., None] * self.centroids[None]
        return l2_normalize(l2_normalize(v).reshape(b, self.num_clusters * d))

    @staticmethod
    def init_from_descriptors(params, descs, seed: int = 42):
        """The k-means initialization of training (dvgl init_params)."""
        raise NotImplementedError(
            f"NetVLAD.init_from_descriptors (training's k-means init) is not ported yet "
            f"{_TRAINING}")


class GeMHead(nn.Module):
    """CosPlace head: L2 -> GeM(p) over tokens -> Linear(out_dim) -> L2."""

    def __init__(self, out_dim: int = 512, p_init: float = 3.0, *, in_dim: int = 2048) -> None:
        super().__init__()
        self.p_init = p_init
        self.p = nn.Parameter(torch.full((), float(p_init)))
        self.fc = nn.Linear(in_dim, out_dim)

    @torch.no_grad()
    def init_constants_(self) -> None:
        self.p.fill_(self.p_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # [B, N, D] -> [B, out]
        x = torch.clamp_min(l2_normalize(x), 1e-6)
        g = (x ** self.p).mean(dim=1) ** (1.0 / self.p)
        return l2_normalize(self.fc(g))


class GeMPool(nn.Module):
    """GeM over tokens (MixVPR/models/aggregators/gem.py:5-18): clamp ->
    p-mean -> L2, a learnable scalar p."""

    def __init__(self, p_init: float = 3.0, eps: float = 1e-6) -> None:
        super().__init__()
        self.p_init, self.eps = p_init, eps
        self.p = nn.Parameter(torch.full((), float(p_init)))

    @torch.no_grad()
    def init_constants_(self) -> None:
        self.p.fill_(self.p_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # [B, N, D] -> [B, D]
        g = (torch.clamp_min(x, self.eps) ** self.p).mean(dim=1) ** (1.0 / self.p)
        return l2_normalize(g)


class ConvAP(nn.Module):
    """ConvAP (arXiv 2210.10239): 1x1 channel projection -> adaptive
    average pool to (s1, s2) -> flatten channel-major -> L2, over the map
    [B, h, w, C]."""

    def __init__(self, out_channels: int = 512, s1: int = 2, s2: int = 2, *,
                 in_channels: int = 1024) -> None:
        super().__init__()
        self.s1, self.s2 = s1, s2
        self.channel_pool = nn.Linear(in_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # [B, h, w, C] -> [B, s1*s2*Co]
        b, h, w, _ = x.shape
        x = self.channel_pool(x)
        # torch AdaptiveAvgPool2d: cell i covers [floor(i*h/s), ceil((i+1)*h/s))
        rows = []
        for i in range(self.s1):
            h0, h1 = (i * h) // self.s1, -(-((i + 1) * h) // self.s1)
            rows.append(torch.stack([
                x[:, h0:h1, (j * w) // self.s2:-(-((j + 1) * w) // self.s2)].mean(dim=(1, 2))
                for j in range(self.s2)], dim=1))
        pooled = torch.stack(rows, dim=1)                      # [B, s1, s2, Co]
        return l2_normalize(pooled.permute(0, 3, 1, 2).reshape(b, -1))


class FeatureMixer(nn.Module):
    """One MixVPR mixer block over [B, D, N]: LayerNorm(N) -> Linear ->
    ReLU -> Linear + skip."""

    def __init__(self, mix_ratio: int = 1, *, n: int = 400) -> None:
        super().__init__()
        self.norm = nn.LayerNorm(n, eps=1e-5)   # torch's eps, not Flax's
        self.mix1 = nn.Linear(n, int(n * mix_ratio))
        self.mix2 = nn.Linear(int(n * mix_ratio), n)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.mix2(torch.relu(self.mix1(self.norm(x))))


class MixVPRHead(nn.Module):
    """MixVPR: ``depth`` mixer blocks over the token axis, then channel
    and row projections -> L2 (MixVPR/models/aggregators/mixvpr.py:28-66);
    [B, N, D] -> [B, out_channels * out_rows]. The release's mixer is
    sized for its N (``n_tokens``: 400 at 320 px on ResNet-50 conv4)."""

    def __init__(self, out_channels: int = 256, out_rows: int = 4, depth: int = 4,
                 mix_ratio: int = 1, *, in_channels: int = 1024, n_tokens: int = 400) -> None:
        super().__init__()
        self.mixer = nn.ModuleList([FeatureMixer(mix_ratio, n=n_tokens) for _ in range(depth)])
        self.channel_proj = nn.Linear(in_channels, out_channels)
        self.row_proj = nn.Linear(n_tokens, out_rows)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.transpose(1, 2)                                   # [B, D, N]
        for mixer in self.mixer:
            x = mixer(x)
        x = self.channel_proj(x.transpose(1, 2))               # [B, N, Co]
        x = self.row_proj(x.transpose(1, 2))                   # [B, Co, R]
        return l2_normalize(x.reshape(x.shape[0], -1))

