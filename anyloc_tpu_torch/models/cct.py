"""CCT, the Compact Convolutional Transformer backbone (counterpart of
``anyloc_tpu/models/cct.py``; dvgl_benchmark's cct_14_7x2_384 truncated at
a transformer layer, network.py:144-155).

A conv tokenizer (conv kxk stride 2 + ReLU + max-pool 3/2, 64 channels
between layers), a learned position embedding, pre-norm blocks and
sequence pooling (a softmax-weighted token average). The blocks keep the
JAX module's flat names (``norm1_{i}``, ``qkv_{i}``, ...) as one
``nn.ModuleList`` per kind, so ``from_jax_params`` carries them across
unchanged. The attention is plain torch, as in the JAX module.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from anyloc_tpu_torch.models.resnet import nchw, pool_out
from anyloc_tpu_torch.ops.common import Conv2d


@dataclasses.dataclass(frozen=True)
class CCTConfig:
    img_size: int = 384
    embed_dim: int = 384
    n_conv_layers: int = 2
    kernel_size: int = 7
    depth: int = 14
    num_heads: int = 6
    mlp_ratio: float = 3.0
    truncate_at: Optional[int] = None  # keep blocks [0, truncate_at)
    dtype: Any = torch.float32

    @property
    def n_tokens(self) -> int:
        n = self.img_size
        for _ in range(self.n_conv_layers):
            n = pool_out(pool_out(n, self.kernel_size, 2, self.kernel_size // 2), 3, 2, 1)
        return n * n


def cct_14_7x2_384(**kw) -> CCTConfig:
    return CCTConfig(img_size=384, embed_dim=384, n_conv_layers=2, kernel_size=7, depth=14,
                     num_heads=6, **kw)


class CCTTokenizer(nn.Module):
    """[B, H, W, 3] -> tokens [B, T, D]."""

    def __init__(self, cfg: CCTConfig) -> None:
        super().__init__()
        c = cfg
        chans = [3] + [64] * (c.n_conv_layers - 1) + [c.embed_dim]
        self.conv = nn.ModuleList([
            Conv2d(chans[i], chans[i + 1], c.kernel_size, 2, c.kernel_size // 2, bias=False,
                   dtype=c.dtype) for i in range(c.n_conv_layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nchw(x)
        for conv in self.conv:
            x = F.max_pool2d(F.relu(conv(x)), 3, 2, 1)
        return x.flatten(2).transpose(1, 2)


class CCT(nn.Module):
    """``seq_pool=False`` builds no pooling head (Flax creates it only when
    a call pools): the module then returns tokens only."""

    def __init__(self, cfg: CCTConfig, *, seq_pool: bool = True) -> None:
        super().__init__()
        c = self.cfg = cfg
        d, t = c.embed_dim, c.dtype
        n = c.truncate_at if c.truncate_at is not None else c.depth
        self.tokenizer = CCTTokenizer(c)
        self.pos_embed = nn.Parameter(torch.zeros(1, c.n_tokens, d, dtype=t))

        def each(make):
            return nn.ModuleList([make() for _ in range(n)])

        hidden = int(d * c.mlp_ratio)
        self.norm1 = each(lambda: nn.LayerNorm(d, eps=1e-6, dtype=t))
        self.qkv = each(lambda: nn.Linear(d, 3 * d, dtype=t))
        self.proj = each(lambda: nn.Linear(d, d, dtype=t))
        self.norm2 = each(lambda: nn.LayerNorm(d, eps=1e-6, dtype=t))
        self.fc1 = each(lambda: nn.Linear(d, hidden, dtype=t))
        self.fc2 = each(lambda: nn.Linear(hidden, d, dtype=t))
        self.norm = nn.LayerNorm(d, eps=1e-6, dtype=t)
        if seq_pool:
            self.attention_pool = nn.Linear(d, 1, dtype=t)

    def forward(self, imgs: torch.Tensor, return_tokens: bool = False) -> torch.Tensor:
        """[B, H, W, 3] -> the seq-pooled [B, D], or with
        ``return_tokens`` the final-normed tokens [B, T, D]."""
        c = self.cfg
        x = self.tokenizer(imgs.to(c.dtype)) + self.pos_embed
        b, t, d = x.shape
        hd = d // c.num_heads
        for i in range(len(self.qkv)):
            qkv = self.qkv[i](self.norm1[i](x))
            q, k, v = (z.reshape(b, t, c.num_heads, hd).transpose(1, 2)
                       for z in qkv.split(d, dim=-1))
            a = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q * hd ** -0.5, k).float(), dim=-1)
            o = torch.einsum("bhqk,bhkd->bhqd", a.to(c.dtype), v)
            x = x + self.proj[i](o.transpose(1, 2).reshape(b, t, d))
            x = x + self.fc2[i](F.gelu(self.fc1[i](self.norm2[i](x))))
        x = self.norm(x)
        if return_tokens:
            return x
        w = torch.softmax(self.attention_pool(x), dim=1)
        return (w * x).sum(dim=1)
