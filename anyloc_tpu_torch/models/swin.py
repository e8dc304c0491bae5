"""SwinV2 backbone (counterpart of ``anyloc_tpu/models/swin.py``; MixVPR's
timm backbone ``swinv2_base_window12to16_192to256_22kft1k``,
``MixVPR/models/backbones/swin.py:24``, parity oracle ``transformers``'
Swinv2Model).

The JAX module's semantics: res-post-norm blocks, cosine attention with a
learned per-head ``exp(clamp(logit_scale, max=log(100)))``, the
continuous position bias (log-spaced coordinates through Linear(2, 512) +
ReLU + Linear(512, heads) then ``16·sigmoid``), the key without bias,
windows and shifts from the config's resolution (a smaller input is
padded, not given a smaller window), a static -100 mask for shifted
windows, 2x2 patch merging with the norm after the reduction, and a final
LayerNorm. The attention stays plain torch (the bias sits inside the
softmax), as the JAX attention is plain XLA. Images [B, H, W, 3] in;
``{"tokens": [B, L, C], "fmap": [B, h, w, C]}`` out.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from anyloc_tpu_torch.models.convert import t2np, tensors
from anyloc_tpu_torch.ops.common import Conv2d


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    img_size: int = 256
    patch_size: int = 4
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 8
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    ln_eps: float = 1e-5
    # per-stage window size the CPB table was trained at; 0 = this window
    # (the timm base ckpt is window12to16 -> (12, 12, 12, 12))
    pretrained_window_sizes: Tuple[int, ...] = (0, 0, 0, 0)
    dtype: Any = torch.float32

    @property
    def out_channels(self) -> int:
        return self.embed_dim * 2 ** (len(self.depths) - 1)


def swinv2_base_config(**kw) -> SwinConfig:
    """timm swinv2_base_window12to16_192to256_22kft1k geometry (MixVPR's
    default Swin: 256 px, window 16, C=1024 out)."""
    kw.setdefault("embed_dim", 128)
    kw.setdefault("depths", (2, 2, 18, 2))
    kw.setdefault("num_heads", (4, 8, 16, 32))
    kw.setdefault("window_size", 16)
    kw.setdefault("pretrained_window_sizes", (12, 12, 12, 12))
    return SwinConfig(**kw)


def _log_coords_table(ws: Tuple[int, int], pretrained: int = 0) -> np.ndarray:
    """[1, 2wh-1, 2ww-1, 2] log-spaced relative coordinates (CPB input);
    ``pretrained`` > 0 normalizes by the training-time window."""
    ch = np.arange(-(ws[0] - 1), ws[0], dtype=np.float64)
    cw = np.arange(-(ws[1] - 1), ws[1], dtype=np.float64)
    table = np.stack(np.meshgrid(ch, cw, indexing="ij"), -1)[None]
    if pretrained > 0:
        table[..., 0] /= pretrained - 1
        table[..., 1] /= pretrained - 1
    elif ws[0] > 1:
        table[..., 0] /= ws[0] - 1
        table[..., 1] /= ws[1] - 1
    table *= 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8.0)
    return table.astype(np.float32)


def _relative_position_index(ws: Tuple[int, int]) -> np.ndarray:
    """[N, N] indices into the flattened (2wh-1)x(2ww-1) bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws[0]), np.arange(ws[1]), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws[0] - 1
    rel[:, :, 1] += ws[1] - 1
    rel[:, :, 0] *= 2 * ws[1] - 1
    return rel.sum(-1)


def _shift_mask(hp: int, wp: int, ws: int, ss: int) -> np.ndarray:
    """Static [nW, N, N] additive mask for shifted-window attention."""
    img = np.zeros((hp, wp))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
        for wsl in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
            img[hs, wsl] = cnt
            cnt += 1
    m = img.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _on(device: torch.device, fn, *args) -> torch.Tensor:
    """A static numpy table of ``fn(*args)`` as a tensor on ``device``,
    made once."""
    return torch.from_numpy(np.ascontiguousarray(fn(*args))).to(device)


class WindowAttention(nn.Module):
    """Cosine window attention with the continuous position bias; x [Bw, N,
    C] (windows flattened into the batch)."""

    def __init__(self, cfg: SwinConfig, dim: int, heads: int, window: Tuple[int, int],
                 pretrained: int = 0) -> None:
        super().__init__()
        t = cfg.dtype
        self.dim, self.heads, self.window, self.pretrained = dim, heads, tuple(window), pretrained
        self.query = nn.Linear(dim, dim, bias=cfg.qkv_bias, dtype=t)
        self.key = nn.Linear(dim, dim, bias=False, dtype=t)
        self.value = nn.Linear(dim, dim, bias=cfg.qkv_bias, dtype=t)
        self.logit_scale = nn.Parameter(torch.empty(heads, 1, 1, dtype=t))
        self.cpb_fc1 = nn.Linear(2, 512, dtype=t)
        self.cpb_fc2 = nn.Linear(512, heads, bias=False, dtype=t)
        self.proj = nn.Linear(dim, dim, dtype=t)
        if not self.logit_scale.is_meta:
            self.init_constants_()

    @torch.no_grad()
    def init_constants_(self) -> None:
        self.logit_scale.fill_(math.log(10.0))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        bw, n, _ = x.shape
        hd = self.dim // self.heads

        def heads(z):
            return z.reshape(bw, n, self.heads, hd).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        qn = q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1, keepdim=True), 1e-12)
        kn = k / torch.clamp_min(torch.linalg.vector_norm(k, dim=-1, keepdim=True), 1e-12)
        scores = torch.einsum("bhnd,bhmd->bhnm", qn, kn)
        scores = scores * torch.exp(torch.clamp(self.logit_scale, max=math.log(100.0)))
        table = _on(x.device, _log_coords_table, self.window, self.pretrained).to(x.dtype)
        bias_table = self.cpb_fc2(F.relu(self.cpb_fc1(table))).reshape(-1, self.heads)
        idx = _on(x.device, _relative_position_index, self.window).reshape(-1)
        bias = bias_table[idx].reshape(n, n, self.heads).permute(2, 0, 1)
        scores = scores + 16.0 * torch.sigmoid(bias)[None]
        if mask is not None:
            nw = mask.shape[0]
            scores = (scores.reshape(bw // nw, nw, self.heads, n, n)
                      + mask[None, :, None]).reshape(bw, self.heads, n, n)
        ctx = torch.einsum("bhnm,bhmd->bhnd", torch.softmax(scores, dim=-1), v)
        return self.proj(ctx.transpose(1, 2).reshape(bw, n, self.dim))


class SwinBlock(nn.Module):
    """Shifted-window block, res-post-norm. ``resolution`` is the feature
    map's size at the config's image size; ``forward(x, hw)`` takes the
    runtime one (padded up to whole windows). The window and shift come
    from ``cfg_resolution``, as in HF (collapsed to dim 0)."""

    def __init__(self, cfg: SwinConfig, dim: int, heads: int, resolution: Tuple[int, int],
                 cfg_resolution: Tuple[int, int], shift: bool, pretrained: int = 0) -> None:
        super().__init__()
        c = self.cfg = cfg
        self.resolution = tuple(resolution)
        rh, rw = cfg_resolution
        win = [r if r <= c.window_size else c.window_size for r in (rh, rw)]
        self.ws = win[0]
        self.ss = (c.window_size // 2) if (shift and rh > win[0]) else 0
        t = c.dtype
        self.attn = WindowAttention(c, dim, heads, (self.ws, self.ws), pretrained)
        self.norm1 = nn.LayerNorm(dim, eps=c.ln_eps, dtype=t)
        self.fc1 = nn.Linear(dim, int(c.mlp_ratio * dim), dtype=t)
        self.fc2 = nn.Linear(int(c.mlp_ratio * dim), dim, dtype=t)
        self.norm2 = nn.LayerNorm(dim, eps=c.ln_eps, dtype=t)

    def forward(self, x: torch.Tensor, hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        h, w = hw or self.resolution
        ws, ss = self.ws, self.ss
        b, _, ch = x.shape
        shortcut = x
        x = x.reshape(b, h, w, ch)
        pad_b, pad_r = (ws - h % ws) % ws, (ws - w % ws) % ws
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        if ss > 0:
            x = torch.roll(x, (-ss, -ss), dims=(1, 2))
        x = x.reshape(b, hp // ws, ws, wp // ws, ws, ch).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(-1, ws * ws, ch)
        mask = _on(x.device, _shift_mask, hp, wp, ws, ss).to(x.dtype) if ss > 0 else None
        x = self.attn(x, mask)
        x = x.reshape(b, hp // ws, wp // ws, ws, ws, ch).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, hp, wp, ch)
        if ss > 0:
            x = torch.roll(x, (ss, ss), dims=(1, 2))
        x = x[:, :h, :w].reshape(b, h * w, ch)
        x = shortcut + self.norm1(x)
        y = self.fc2(F.gelu(self.fc1(x)))
        return x + self.norm2(y)


class PatchMerging(nn.Module):
    """2x2 quadrant concat -> Linear(4C, 2C, no bias) -> LayerNorm."""

    def __init__(self, cfg: SwinConfig, dim: int, resolution: Tuple[int, int]) -> None:
        super().__init__()
        self.resolution = tuple(resolution)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False, dtype=cfg.dtype)
        self.norm = nn.LayerNorm(2 * dim, eps=cfg.ln_eps, dtype=cfg.dtype)

    def forward(self, x: torch.Tensor, hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        h, w = hw or self.resolution
        b, _, ch = x.shape
        x = x.reshape(b, h, w, ch)
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.norm(self.reduction(x.reshape(b, -1, 4 * ch)))


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: SwinConfig) -> None:
        super().__init__()
        self.proj = Conv2d(3, cfg.embed_dim, cfg.patch_size, cfg.patch_size, dtype=cfg.dtype)


class _Stage(nn.Module):
    def __init__(self, blocks, merge: Optional[PatchMerging]) -> None:
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if merge is not None:
            self.merge = merge


class SwinV2(nn.Module):
    """SwinV2 trunk: [B, H, W, 3] -> {'tokens': [B, L, C], 'fmap': [B, h, w, C]}."""

    def __init__(self, cfg: SwinConfig) -> None:
        super().__init__()
        c = self.cfg = cfg
        self.patch_embed = _PatchEmbed(c)
        # HF's embeddings norm keeps torch's default eps 1e-5 whatever the
        # config says (modeling_swinv2.py:235)
        self.embed_norm = nn.LayerNorm(c.embed_dim, eps=1e-5, dtype=c.dtype)
        cg = c.img_size // c.patch_size
        res = (cg, cg)
        stages = []
        for i, depth in enumerate(c.depths):
            dim = c.embed_dim * 2 ** i
            blocks = [SwinBlock(c, dim, c.num_heads[i], res, res, j % 2 == 1,
                                c.pretrained_window_sizes[i]) for j in range(depth)]
            last = i == len(c.depths) - 1
            stages.append(_Stage(blocks, None if last else PatchMerging(c, dim, res)))
            res = (res[0] // 2, res[1] // 2)
        self.stage = nn.ModuleList(stages)
        self.final_norm = nn.LayerNorm(c.out_channels, eps=c.ln_eps, dtype=c.dtype)

    @property
    def out_channels(self) -> int:
        return self.cfg.out_channels

    def fmap_hw(self, h: int, w: int) -> Tuple[int, int]:
        h, w = h // self.cfg.patch_size, w // self.cfg.patch_size
        for _ in range(len(self.cfg.depths) - 1):
            h, w = (h + 1) // 2, (w + 1) // 2
        return h, w

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        c = self.cfg
        b = x.shape[0]
        x = self.patch_embed.proj(x.to(c.dtype).permute(0, 3, 1, 2))
        h, w = x.shape[-2:]
        x = self.embed_norm(x.flatten(2).transpose(1, 2))
        for stage in self.stage:
            for blk in stage.block:
                x = blk(x, (h, w))
            if hasattr(stage, "merge"):
                x = stage.merge(x, (h, w))
                h, w = (h + 1) // 2, (w + 1) // 2
        x = self.final_norm(x)
        return {"tokens": x, "fmap": x.reshape(b, h, w, -1)}


def convert_hf_swinv2(sd: Dict, cfg: SwinConfig) -> Dict[str, torch.Tensor]:
    """transformers Swinv2Model state dict (optionally under ``swinv2.``) ->
    ``SwinV2(cfg)``'s."""
    if any(k.startswith("swinv2.") for k in sd):
        sd = {k[len("swinv2."):]: v for k, v in sd.items() if k.startswith("swinv2.")}
    out: Dict = {}

    def copy(src, dst):
        for kind in ("weight", "bias"):
            if f"{src}.{kind}" in sd:
                out[f"{dst}.{kind}"] = t2np(sd[f"{src}.{kind}"])

    copy("embeddings.patch_embeddings.projection", "patch_embed.proj")
    copy("embeddings.norm", "embed_norm")
    copy("layernorm", "final_norm")
    for i, depth in enumerate(cfg.depths):
        for j in range(depth):
            t, f = f"encoder.layers.{i}.blocks.{j}", f"stage.{i}.block.{j}"
            a = f"{t}.attention.self"
            for name in ("query", "key", "value"):
                copy(f"{a}.{name}", f"{f}.attn.{name}")
            out[f"{f}.attn.logit_scale"] = t2np(sd[f"{a}.logit_scale"]).reshape(-1, 1, 1)
            copy(f"{a}.continuous_position_bias_mlp.0", f"{f}.attn.cpb_fc1")
            copy(f"{a}.continuous_position_bias_mlp.2", f"{f}.attn.cpb_fc2")
            copy(f"{t}.attention.output.dense", f"{f}.attn.proj")
            copy(f"{t}.layernorm_before", f"{f}.norm1")
            copy(f"{t}.intermediate.dense", f"{f}.fc1")
            copy(f"{t}.output.dense", f"{f}.fc2")
            copy(f"{t}.layernorm_after", f"{f}.norm2")
        if i < len(cfg.depths) - 1:
            copy(f"encoder.layers.{i}.downsample.reduction", f"stage.{i}.merge.reduction")
            copy(f"encoder.layers.{i}.downsample.norm", f"stage.{i}.merge.norm")
    return tensors(out)
