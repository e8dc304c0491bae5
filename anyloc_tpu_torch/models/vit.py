"""The DINOv2 ViT trunk in PyTorch (counterpart of ``anyloc_tpu/models/vit.py``,
the subset the AnyLoc-VLAD-DINOv2 path runs).

* channels-last input [B, H, W, 3], already normalized; H and W are
  multiples of the patch size;
* patch embed, CLS and register tokens, learned position embedding
  interpolated bicubically with DINOv2's 0.1 scale offset;
* pre-norm blocks with LayerScale, GELU or SwiGLU-fused MLP;
* ``capture_layer`` truncation: blocks after the captured one never run,
  and the captured block runs only norm1 + qkv for the q/k/v facets (the
  trunk-final LayerNorm never runs, so it is not built).

Attention routing follows the JAX trunk: N <= ``MAX_FUSED_TOKENS`` goes
to K5 (attention + projection + LayerScale + residual from the fused
qkv), longer sequences to K2 on head-split views with a plain projection.

Module names match the facebookresearch/dinov2 checkpoints, so their state
dicts load unchanged (``models/dinov2.py::native_state_dict``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from anyloc_tpu_torch.ops.kernels import (
    MAX_FUSED_TOKENS,
    flash_attention,
    flash_attention_qkv_proj,
)

FACET_OFFSETS = {"query": 0, "key": 1, "value": 2}


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Architecture hyperparameters (DINOv2 factories in dinov2.py)."""

    img_size: int = 518            # training-time image size (pos-embed grid)
    patch_size: int = 14
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    mlp_type: str = "mlp"          # "mlp" (GELU) | "swiglu_fused"
    layerscale_init: float = 1e-5
    ln_eps: float = 1e-6
    num_register_tokens: int = 0
    interpolate_offset: float = 0.1
    interpolate_antialias: bool = False
    dtype: torch.dtype = torch.float32   # parameter and activation dtype

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def mlp_hidden(self) -> int:
        if self.mlp_type == "swiglu_fused":
            # DINOv2-giant SwiGLUFFNFused: round8(int(4 d * 2/3))
            return ((int(self.embed_dim * self.mlp_ratio * 2 / 3) + 7) // 8) * 8
        return int(self.embed_dim * self.mlp_ratio)


def interpolate_pos_embed(
    pos_embed: torch.Tensor,
    grid_hw: Tuple[int, int],
    num_prefix: int,
    offset: float = 0.1,
    antialias: bool = False,
) -> torch.Tensor:
    """Bicubic resize of the patch position embeddings [1, P + M*M, D] to
    a new grid, as DINOv2's ``interpolate_pos_encoding``: scale factor
    (g + offset) / M with ``recompute_scale_factor=False`` (the offset
    shifts the sampling grid, not only the size), in float32."""
    h, w = grid_hw
    n_patch = pos_embed.shape[1] - num_prefix
    m = int(round(math.sqrt(n_patch)))
    if m * m != n_patch:
        raise ValueError(f"pos_embed grid is not square: {n_patch} tokens")
    if (h, w) == (m, m):
        return pos_embed
    prefix = pos_embed[:, :num_prefix]
    patch = pos_embed[:, num_prefix:].float().reshape(1, m, m, -1).permute(0, 3, 1, 2)
    patch = F.interpolate(patch, scale_factor=((h + offset) / m, (w + offset) / m),
                          mode="bicubic", align_corners=False, antialias=antialias,
                          recompute_scale_factor=False)
    if tuple(patch.shape[-2:]) != (h, w):
        raise ValueError(f"interpolated grid {tuple(patch.shape[-2:])} != {(h, w)}")
    patch = patch.permute(0, 2, 3, 1).reshape(1, h * w, -1)
    return torch.cat([prefix.float(), patch], dim=1)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float, **factory) -> None:
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init, **factory))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class Attention(nn.Module):
    """Fused-qkv attention (the facet API slices the fused qkv output)."""

    def __init__(self, cfg: ViTConfig, **factory) -> None:
        super().__init__()
        d = cfg.embed_dim
        self.qkv = nn.Linear(d, 3 * d, **factory)
        self.proj = nn.Linear(d, d, **factory)


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig, **factory) -> None:
        super().__init__()
        self.fc1 = nn.Linear(cfg.embed_dim, cfg.mlp_hidden, **factory)
        self.fc2 = nn.Linear(cfg.mlp_hidden, cfg.embed_dim, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))  # exact (erf) GELU


class SwiGLUFFNFused(nn.Module):
    def __init__(self, cfg: ViTConfig, **factory) -> None:
        super().__init__()
        self.w12 = nn.Linear(cfg.embed_dim, 2 * cfg.mlp_hidden, **factory)
        self.w3 = nn.Linear(cfg.mlp_hidden, cfg.embed_dim, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


class Block(nn.Module):
    """Pre-norm block: x + ls1(attn(norm1 x)); x + ls2(mlp(norm2 x))."""

    def __init__(self, cfg: ViTConfig, **factory) -> None:
        super().__init__()
        d = cfg.embed_dim
        self.cfg = cfg
        self.norm1 = nn.LayerNorm(d, eps=cfg.ln_eps, **factory)
        self.attn = Attention(cfg, **factory)
        self.norm2 = nn.LayerNorm(d, eps=cfg.ln_eps, **factory)
        mlp = SwiGLUFFNFused if cfg.mlp_type == "swiglu_fused" else Mlp
        self.mlp = mlp(cfg, **factory)
        self.ls1 = LayerScale(d, cfg.layerscale_init, **factory)
        self.ls2 = LayerScale(d, cfg.layerscale_init, **factory)

    def forward(self, x: torch.Tensor, qkv_only: bool = False) -> torch.Tensor:
        qkv = self.attn.qkv(self.norm1(x))            # [B, N, 3D] facet source
        if qkv_only:
            return qkv
        b, n, d = x.shape
        if n <= MAX_FUSED_TOKENS:
            # K5: attention + proj + LayerScale + residual from the raw qkv
            x = flash_attention_qkv_proj(
                qkv, self.attn.proj.weight.t(), self.attn.proj.bias,
                num_heads=self.cfg.num_heads, layerscale=self.ls1.gamma, residual=x)
        else:
            # K2 on head-split strided views of qkv, then a plain projection
            h, hd = self.cfg.num_heads, self.cfg.head_dim
            q, k, v = (qkv[..., i * d:(i + 1) * d].view(b, n, h, hd).transpose(1, 2)
                       for i in range(3))
            o = flash_attention(q, k, v).transpose(1, 2).reshape(b, n, d)
            x = x + self.ls1(self.attn.proj(o))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig, **factory) -> None:
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size, cfg.patch_size,
                              **factory)


class ViT(nn.Module):
    """The truncated trunk: ``n_blocks`` (default: all) materializes only
    the first blocks — an extractor never needs the rest.

    ``forward(x, capture_layer=L, capture_facet=f)``:
      * facet "query" | "key" | "value": blocks 0..L-1, then norm1 + qkv of
        block L; returns [B, 1+R+N, D] (prefix tokens included);
      * facet "token": blocks 0..L, returns block L's output.
    """

    def __init__(self, cfg: ViTConfig, n_blocks: Optional[int] = None,
                 device=None) -> None:
        super().__init__()
        factory = dict(device=device, dtype=cfg.dtype)
        d = cfg.embed_dim
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg, **factory)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, **factory))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + cfg.grid_size ** 2, d, **factory))
        if cfg.num_register_tokens:
            self.register_tokens = nn.Parameter(
                torch.zeros(1, cfg.num_register_tokens, d, **factory))
        n_blocks = cfg.depth if n_blocks is None else n_blocks
        if not 0 < n_blocks <= cfg.depth:
            raise ValueError(f"n_blocks {n_blocks} not in 1..{cfg.depth}")
        self.blocks = nn.ModuleList([Block(cfg, **factory) for _ in range(n_blocks)])

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> token sequence [B, 1+R+N, D] (CLS, registers,
        patches), before the blocks."""
        c = self.cfg
        b = x.shape[0]
        x = self.patch_embed.proj(x.to(c.dtype).permute(0, 3, 1, 2))
        gh, gw = x.shape[-2:]
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(b, -1, -1), x], dim=1)
        pos = interpolate_pos_embed(self.pos_embed, (gh, gw), 1,
                                    offset=c.interpolate_offset,
                                    antialias=c.interpolate_antialias)
        x = x + pos.to(x.dtype)
        if c.num_register_tokens:
            x = torch.cat([x[:, :1], self.register_tokens.expand(b, -1, -1),
                           x[:, 1:]], dim=1)
        return x

    def forward(self, x: torch.Tensor, capture_layer: int,
                capture_facet: str = "value") -> torch.Tensor:
        if capture_facet != "token" and capture_facet not in FACET_OFFSETS:
            raise ValueError(f"unknown facet {capture_facet!r}")
        if not 0 <= capture_layer < len(self.blocks):
            raise ValueError(f"layer {capture_layer} is outside the "
                             f"{len(self.blocks)} materialized blocks")
        x = self.embed(x)
        if capture_facet == "token":
            for blk in self.blocks[:capture_layer + 1]:
                x = blk(x)
            return x
        for blk in self.blocks[:capture_layer]:
            x = blk(x)
        qkv = self.blocks[capture_layer](x, qkv_only=True)
        d = self.cfg.embed_dim
        off = FACET_OFFSETS[capture_facet] * d
        return qkv[..., off:off + d]
