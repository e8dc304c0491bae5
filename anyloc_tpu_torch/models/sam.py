"""SAM (Segment Anything) image encoder, a ViTDet-style trunk
(counterpart of ``anyloc_tpu/models/sam.py``; the reference feeds it to
VLAD in scripts/SAM_vlad.py:140):

* a patch-16 conv and a learned absolute position embedding [1, g, g, D],
  no CLS;
* blocks with windowed attention (window 14) except at the global-attention
  indices, with decomposed relative position embeddings added to the
  logits (``get_rel_pos``, the SAM source's add_decomposed_rel_pos). The
  attention is plain, as in the JAX package: the rel-pos bias sits inside
  the softmax, where no kernel of the port takes it;
* a neck (1x1 conv -> LayerNorm2d -> 3x3 conv -> LayerNorm2d) to 256
  channels.

Module names are Meta's ``image_encoder.*``; resizes of the position
table and of the rel-pos tables follow ``jax.image.resize`` (Keys cubic
with a = -0.5 and linear, antialiased when shrinking), as the JAX
package does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from anyloc_tpu_torch.models.convert import from_jax_params, tensors
from anyloc_tpu_torch.models.hf_convert import ensure_native_naming
from anyloc_tpu_torch.ops.common import Conv2d


@dataclasses.dataclass(frozen=True)
class SAMConfig:
    img_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    out_chans: int = 256
    mlp_ratio: float = 4.0
    dtype: torch.dtype = torch.float32


def sam_vit_b() -> SAMConfig:
    return SAMConfig(embed_dim=768, depth=12, num_heads=12, global_attn_indexes=(2, 5, 8, 11))


def sam_vit_l() -> SAMConfig:
    return SAMConfig(embed_dim=1024, depth=24, num_heads=16, global_attn_indexes=(5, 11, 17, 23))


def sam_vit_h() -> SAMConfig:
    return SAMConfig(embed_dim=1280, depth=32, num_heads=16, global_attn_indexes=(7, 15, 23, 31))


SAM_FACTORIES = {"vit_b": sam_vit_b, "vit_l": sam_vit_l, "vit_h": sam_vit_h}


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def jax_resize_matrix(src: int, dst: int, method: str) -> np.ndarray:
    """[dst, src] weights of ``jax.image.resize`` along one axis
    (``scale_and_translate`` with half-pixel centers, antialiased: the
    kernel widens by src/dst when shrinking; weights renormalized over
    the taps inside the input)."""
    kernel = {"linear": lambda x: np.maximum(0.0, 1.0 - x), "cubic": _keys_cubic}[method]
    inv_scale = src / dst
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(dst) + 0.5) * inv_scale - 0.5
    w = kernel(np.abs(sample[None, :] - np.arange(src)[:, None]) / kernel_scale)   # [src, dst]
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= src - 0.5)
    return np.where(inside[None, :], w, 0.0).T.astype(np.float32)


def _resize_rows(t: torch.Tensor, n: int, method: str) -> torch.Tensor:
    m = torch.from_numpy(jax_resize_matrix(t.shape[0], n, method)).to(t.device)
    return m @ t.float()


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """SAM's decomposed relative positions: the table row of every (q, k)
    offset -> [q_size, k_size, hd]; a table of another length than
    2 max(q, k) - 1 is resized linearly first."""
    max_rel = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel:
        rel_pos = _resize_rows(rel_pos, max_rel, "linear")
    q_coords = torch.arange(q_size, device=rel_pos.device)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=rel_pos.device)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


class SAMAttention(nn.Module):
    """Attention over a [B, H, W, D] window (or the whole grid) with the
    decomposed rel-pos bias; ``size`` is the side its tables were made for."""

    def __init__(self, cfg: SAMConfig, use_rel_pos: bool = True, *, size: int,
                 device=None) -> None:
        super().__init__()
        d, hd = cfg.embed_dim, cfg.embed_dim // cfg.num_heads
        f = dict(device=device, dtype=cfg.dtype)
        self.cfg = cfg
        self.use_rel_pos = use_rel_pos
        self.qkv = nn.Linear(d, 3 * d, **f)
        self.proj = nn.Linear(d, d, **f)
        if use_rel_pos:
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, hd, device=device))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, hd, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b, h, w, d = x.shape
        nh = c.num_heads
        hd = d // nh
        qkv = self.qkv(x.reshape(b, h * w, d)).reshape(b, h * w, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]   # [B, nh, HW, hd]
        attn = (q * hd ** -0.5).float() @ k.float().transpose(-1, -2)
        if self.use_rel_pos:
            rh = get_rel_pos(h, h, self.rel_pos_h.float())
            rw = get_rel_pos(w, w, self.rel_pos_w.float())
            qr = q.reshape(b, nh, h, w, hd).float()
            bias_h = torch.einsum("bnhwd,hkd->bnhwk", qr, rh)
            bias_w = torch.einsum("bnhwd,wkd->bnhwk", qr, rw)
            attn = attn.reshape(b, nh, h, w, h, w) + bias_h[..., :, None] + bias_w[..., None, :]
            attn = attn.reshape(b, nh, h * w, h * w)
        attn = torch.softmax(attn, dim=-1).to(c.dtype)
        out = (attn @ v).transpose(1, 2).reshape(b, h, w, d)
        return self.proj(out)


def window_partition(x: torch.Tensor, win: int):
    """[B, H, W, D] -> windows [B·nh·nw, win, win, D] (zero-padded to a
    multiple of ``win``) and the padded size."""
    b, h, w, d = x.shape
    ph, pw = (win - h % win) % win, (win - w % win) % win
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // win, win, wp // win, win, d)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win, win, d), (hp, wp)


def window_unpartition(wins: torch.Tensor, win: int, pad_hw, hw) -> torch.Tensor:
    hp, wp = pad_hw
    h, w = hw
    b = wins.shape[0] // (hp * wp // win // win)
    x = wins.reshape(b, hp // win, wp // win, win, win, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)[:, :h, :w]


class _SAMMlp(nn.Module):
    def __init__(self, cfg: SAMConfig, device=None) -> None:
        super().__init__()
        f = dict(device=device, dtype=cfg.dtype)
        hidden = int(cfg.embed_dim * cfg.mlp_ratio)
        self.lin1 = nn.Linear(cfg.embed_dim, hidden, **f)
        self.lin2 = nn.Linear(hidden, cfg.embed_dim, **f)


class SAMBlock(nn.Module):
    """``window`` 0: global attention over the whole grid."""

    def __init__(self, cfg: SAMConfig, window: int, device=None) -> None:
        super().__init__()
        f = dict(device=device, dtype=cfg.dtype)
        self.window = window
        self.norm1 = nn.LayerNorm(cfg.embed_dim, eps=1e-6, **f)
        self.attn = SAMAttention(cfg, size=window or cfg.img_size // cfg.patch_size,
                                 device=device)
        self.norm2 = nn.LayerNorm(cfg.embed_dim, eps=1e-6, **f)
        self.mlp = _SAMMlp(cfg, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # [B, H, W, D]
        shortcut = x
        x = self.norm1(x)
        if self.window > 0:
            hw = x.shape[1:3]
            x, pad_hw = window_partition(x, self.window)
            x = window_unpartition(self.attn(x), self.window, pad_hw, hw)
        else:
            x = self.attn(x)
        x = shortcut + x
        return x + self.mlp.lin2(F.gelu(self.mlp.lin1(self.norm2(x))))


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of [B, H, W, C], in float32."""

    def __init__(self, dim: int, device=None) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-6) * self.weight + self.bias


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: SAMConfig, device=None) -> None:
        super().__init__()
        self.proj = Conv2d(3, cfg.embed_dim, cfg.patch_size, cfg.patch_size,
                              device=device, dtype=cfg.dtype)


class SAMImageEncoder(nn.Module):
    """[B, H, W, 3] -> neck features [B, H/16, W/16, out_chans] (float32),
    or with ``return_tokens`` the trunk's tokens [B, gh·gw, D] (the facet
    the VLAD pipeline aggregates)."""

    def __init__(self, cfg: SAMConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        g = cfg.img_size // cfg.patch_size
        f = dict(device=device, dtype=cfg.dtype)
        self.patch_embed = _PatchEmbed(cfg, device)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, cfg.embed_dim, device=device))
        self.blocks = nn.ModuleList([
            SAMBlock(cfg, 0 if i in cfg.global_attn_indexes else cfg.window_size, device)
            for i in range(cfg.depth)])
        self.neck = nn.Sequential(
            Conv2d(cfg.embed_dim, cfg.out_chans, 1, bias=False, **f),
            LayerNorm2d(cfg.out_chans, device),
            Conv2d(cfg.out_chans, cfg.out_chans, 3, padding=1, bias=False, **f),
            LayerNorm2d(cfg.out_chans, device))

    def forward(self, x: torch.Tensor, return_tokens: bool = False) -> torch.Tensor:
        c = self.cfg
        x = self.patch_embed.proj(x.to(c.dtype).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        b, ph, pw, d = x.shape
        pos = self.pos_embed.float()
        if (ph, pw) != tuple(pos.shape[1:3]):
            mh = torch.from_numpy(jax_resize_matrix(pos.shape[1], ph, "cubic")).to(x.device)
            mw = torch.from_numpy(jax_resize_matrix(pos.shape[2], pw, "cubic")).to(x.device)
            pos = torch.einsum("hm,bmnd,wn->bhwd", mh, pos, mw)
        x = x + pos.to(c.dtype)
        for blk in self.blocks:
            x = blk(x)
        if return_tokens:
            return x.reshape(b, -1, d)
        y = x.permute(0, 3, 1, 2)
        y = self.neck[1](self.neck[0](y).permute(0, 2, 3, 1))
        y = self.neck[2](y.to(c.dtype).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return self.neck[3](y)


_NECK = {"neck_conv1": "neck.0", "neck_ln1": "neck.1", "neck_conv2": "neck.2",
         "neck_ln2": "neck.3"}


def _jax_rename(key: str, arr: np.ndarray):
    head, _, rest = key.partition(".")
    if head in _NECK:
        return f"{_NECK[head]}.{rest}", arr
    return key.replace(".mlp_lin", ".mlp.lin"), arr


def from_jax_params_sam(params) -> Dict[str, torch.Tensor]:
    """The JAX package's ``SAMImageEncoder`` tree -> the port's state dict."""
    return from_jax_params(params, _jax_rename)


def convert_sam(sd: Dict, cfg: SAMConfig) -> Dict[str, torch.Tensor]:
    """A SAM checkpoint (Meta's ``image_encoder.*`` names, or HuggingFace's
    ``SamModel`` layout) -> the port's state dict (the image encoder's
    keys of ``cfg.depth`` blocks)."""
    sd = ensure_native_naming(sd, "sam")
    pre = "image_encoder." if any(k.startswith("image_encoder.") for k in sd) else ""
    sd = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
    keep = ("patch_embed.", "pos_embed", "neck.") + tuple(
        f"blocks.{i}." for i in range(cfg.depth))
    return tensors({k: v for k, v in sd.items() if k.startswith(keep)})

