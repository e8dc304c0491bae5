"""The DINOv2 ViT trunk in PyTorch (counterpart of ``anyloc_tpu/models/vit.py``,
the subset the AnyLoc-VLAD-DINOv2 path runs).

* channels-last input [B, H, W, 3], already normalized; H and W are
  multiples of the patch size;
* patch embed, CLS and register tokens, learned position embedding
  interpolated bicubically with DINOv2's 0.1 scale offset;
* pre-norm blocks with LayerScale, GELU or SwiGLU-fused MLP;
* ``capture_layer`` truncation: blocks after the captured one never run,
  and the captured block runs only norm1 + qkv for the q/k/v facets;
  ``capture_layers`` captures several layers in one pass;
* the untruncated forward (``capture_layer=None``) ends with the
  trunk-final LayerNorm, built only for the whole trunk (``n_blocks``
  None); ``embed_only`` returns the embedded tokens; the "attn" facet
  returns a block's softmax attention probabilities.

Attention routing follows the JAX trunk: N <= ``MAX_FUSED_TOKENS`` goes
to K5 (attention + projection + LayerScale + residual from the fused
qkv), longer sequences to K2 on head-split views with a plain projection.

``ViTConfig.quant`` selects an int8 W8A8 trunk (``anyloc_tpu/models/vit.py``
``QDense`` and the routing of ``Block``, :288-299, :491-538, :565-701):
  * "int8_full" (the serving mode): K4 for the attention half and K3 for
    the MLP half of every block; at N > ``MAX_FUSED_TOKENS``, or for the
    captured block's norm1 + qkv, LayerNorm + per-row ``qdense`` with K2;
  * "int8": per-row ``qdense`` for all four block matmuls, K2 attention;
  * "int8_mlp": the bf16 attention half (K5 / K2), ``qdense`` in the MLP;
  * "int8_fused": the bf16 attention half, K3 for the MLP half.
Which half runs fused also follows the TPU kernels' geometry rules
(``attn_geometry_ok``, ``int8_mlp_geometry_ok``): the fused halves
requantize per (row, chunk), the unfused ones per row, so the rule is part
of the function. A quantized trunk keeps LayerNorm parameters, LayerScale
gammas, weight scales and the int8 layers' biases in f32 (as the JAX
parameter tree does) and computes its LayerNorms in f32.

Module names match the facebookresearch/dinov2 checkpoints, so their state
dicts load unchanged (``models/dinov2.py::native_state_dict``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from anyloc_tpu_torch.ops.kernels import (
    MAX_FUSED_TOKENS,
    flash_attention,
    flash_attention_qkv_proj,
    fused_attn_half_int8,
    fused_mlp_int8,
    attn_geometry_ok,
    int8_mlp_geometry_ok,
)
from anyloc_tpu_torch.ops.kernels.fused_mlp import ln_rows
from anyloc_tpu_torch.ops.quant import MLP_MODULE_NAMES, QUANT_MODES, qdense

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
    quant: Optional[str] = None    # None | "int8" | "int8_mlp" | "int8_fused" | "int8_full"

    def __post_init__(self) -> None:
        if self.quant is not None and self.quant not in QUANT_MODES:
            raise ValueError(f"quant must be None or one of {QUANT_MODES}, got {self.quant!r}")

    def quantizes(self, name: str) -> bool:
        """Whether the block Linear ``name`` (qkv, proj, fc1, fc2, w12, w3)
        is int8 in this trunk."""
        if self.quant in ("int8", "int8_full"):
            return True
        return self.quant is not None and name in MLP_MODULE_NAMES

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


def layer_norm(cfg: "ViTConfig", norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """A trunk LayerNorm: the module itself in a float trunk; in a
    quantized one f32 math and parameters, output in the trunk dtype
    (flax's ``LayerNorm(dtype=...)``)."""
    if cfg.quant is None:
        return norm(x)
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias,
                        norm.eps).to(cfg.dtype)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float, **factory) -> None:
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init, **factory))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class QLinear(nn.Module):
    """int8 W8A8 Linear of the frozen trunk (the JAX package's ``QDense``):
    ``weight_q`` int8 [out, in] — nn.Linear's layout, which is the
    K-contiguous B operand of the int8 tensor-core product —
    ``weight_scale`` f32 [out] and ``bias`` f32 [out]. The forward is
    ``qdense``: per-row activation quantize, int8 product, output in x's
    dtype, then the bias in that dtype."""

    def __init__(self, in_features: int, out_features: int, device=None) -> None:
        super().__init__()
        self.register_buffer("weight_q", torch.empty(
            (out_features, in_features), dtype=torch.int8, device=device))
        self.register_buffer("weight_scale", torch.empty(
            out_features, dtype=torch.float32, device=device))
        self.register_buffer("bias", torch.empty(
            out_features, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return qdense(x, self.weight_q.t(), self.weight_scale, self.bias)


def _linear(cfg: ViTConfig, name: str, in_f: int, out_f: int, device) -> nn.Module:
    if cfg.quantizes(name):
        return QLinear(in_f, out_f, device=device)
    return nn.Linear(in_f, out_f, device=device, dtype=cfg.dtype)


class Attention(nn.Module):
    """Fused-qkv attention (the facet API slices the fused qkv output)."""

    def __init__(self, cfg: ViTConfig, device=None) -> None:
        super().__init__()
        d = cfg.embed_dim
        self.qkv = _linear(cfg, "qkv", d, 3 * d, device)
        self.proj = _linear(cfg, "proj", d, d, device)


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None) -> None:
        super().__init__()
        self.fc1 = _linear(cfg, "fc1", cfg.embed_dim, cfg.mlp_hidden, device)
        self.fc2 = _linear(cfg, "fc2", cfg.mlp_hidden, cfg.embed_dim, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))  # exact (erf) GELU

    def int8_layers(self):
        return self.fc1, self.fc2


class SwiGLUFFNFused(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None) -> None:
        super().__init__()
        self.w12 = _linear(cfg, "w12", cfg.embed_dim, 2 * cfg.mlp_hidden, device)
        self.w3 = _linear(cfg, "w3", cfg.mlp_hidden, cfg.embed_dim, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)

    def int8_layers(self):
        return self.w12, self.w3


class Block(nn.Module):
    """Pre-norm block: x + ls1(attn(norm1 x)); x + ls2(mlp(norm2 x))."""

    def __init__(self, cfg: ViTConfig, device=None) -> None:
        super().__init__()
        d = cfg.embed_dim
        self.cfg = cfg
        # LayerNorm and LayerScale stay f32 in a quantized trunk
        keep = dict(device=device, dtype=torch.float32 if cfg.quant else cfg.dtype)
        self.norm1 = nn.LayerNorm(d, eps=cfg.ln_eps, **keep)
        self.attn = Attention(cfg, device)
        self.norm2 = nn.LayerNorm(d, eps=cfg.ln_eps, **keep)
        mlp = SwiGLUFFNFused if cfg.mlp_type == "swiglu_fused" else Mlp
        self.mlp = mlp(cfg, device)
        self.ls1 = LayerScale(d, cfg.layerscale_init, **keep)
        self.ls2 = LayerScale(d, cfg.layerscale_init, **keep)

    def forward(self, x: torch.Tensor, qkv_only: bool = False, return_qkv: bool = False,
                return_attn_probs: bool = False):
        """The block; ``qkv_only``: norm1 + qkv only, returns the fused
        [B, N, 3D] qkv; ``return_qkv``: (block output, qkv), the int8_full
        attention half then unfused as in the JAX trunk;
        ``return_attn_probs``: the post-softmax attention [B, H, N, N] f32
        (plain attention on every device, as in the JAX trunk)."""
        c = self.cfg
        b, n, d = x.shape
        if (c.quant == "int8_full" and not (qkv_only or return_qkv or return_attn_probs)
                and n <= MAX_FUSED_TOKENS and attn_geometry_ok(c.num_heads, c.head_dim)):
            # K4: norm1 + int8 qkv + attention + int8 proj + ls1 + residual
            qkv, proj = self.attn.qkv, self.attn.proj
            x = fused_attn_half_int8(
                x, qkv.weight_q.t(), qkv.weight_scale, qkv.bias, proj.weight_q.t(),
                proj.weight_scale, proj.bias, num_heads=c.num_heads,
                ln_params=(self.norm1.weight, self.norm1.bias), ln_eps=c.ln_eps,
                layerscale=self.ls1.gamma)
            return self._mlp_half(x)
        qkv = self.attn.qkv(layer_norm(c, self.norm1, x))   # [B, N, 3D] facet source
        if qkv_only:
            return qkv
        if return_attn_probs:
            h, hd = c.num_heads, c.head_dim
            q, k = (qkv[..., i * d:(i + 1) * d].view(b, n, h, hd).transpose(1, 2)
                    for i in range(2))
            s = (q * hd ** -0.5).float() @ k.float().transpose(-1, -2)
            return torch.softmax(s, dim=-1)
        x = self._attn_half(x, qkv)
        out = self._mlp_half(x)
        return (out, qkv) if return_qkv else out

    def _attn_half(self, x: torch.Tensor, qkv: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b, n, d = x.shape
        if n <= MAX_FUSED_TOKENS and c.quant not in ("int8", "int8_full"):
            # K5: attention + proj + LayerScale + residual from the raw qkv
            x = flash_attention_qkv_proj(
                qkv, self.attn.proj.weight.t(), self.attn.proj.bias,
                num_heads=c.num_heads, layerscale=self.ls1.gamma, residual=x)
        else:
            # K2 on head-split strided views of qkv, then the projection
            h, hd = c.num_heads, c.head_dim
            q, k, v = (qkv[..., i * d:(i + 1) * d].view(b, n, h, hd).transpose(1, 2)
                       for i in range(3))
            o = flash_attention(q, k, v).transpose(1, 2).reshape(b, n, d)
            x = x + self.ls1(self.attn.proj(o))
        return x

    def _mlp_half(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        if c.quant not in ("int8_fused", "int8_full"):
            return x + self.ls2(self.mlp(layer_norm(c, self.norm2, x)))
        ln = (self.norm2.weight, self.norm2.bias)
        if int8_mlp_geometry_ok(c.mlp_type, c.mlp_hidden):
            # K3: norm2 + int8 w12 + SwiGLU/GELU + int8 w3 + ls2 + residual
            l1, l3 = self.mlp.int8_layers()
            return fused_mlp_int8(
                x, l1.weight_q.t(), l1.weight_scale, l1.bias, l3.weight_q.t(),
                l3.weight_scale, l3.bias, mlp_type=c.mlp_type, ln_params=ln,
                ln_eps=c.ln_eps, layerscale=self.ls2.gamma, residual=True)
        # the per-row composition the JAX trunk falls back to (vit.py:670-682)
        h = ln_rows(x.float(), *ln, c.ln_eps).to(c.dtype)
        m = self.mlp(h).float() * self.ls2.gamma.float()
        return (x.float() + m).to(c.dtype)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None) -> None:
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size, cfg.patch_size,
                              device=device, dtype=cfg.dtype)


class ViT(nn.Module):
    """The trunk: ``n_blocks`` materializes only the first blocks (an
    extractor never needs the rest); None builds every block and the
    trunk-final ``norm``.

    ``forward(x, capture_layer=L, capture_facet=f)``:
      * facet "query" | "key" | "value": blocks 0..L-1, then norm1 + qkv of
        block L; returns [B, 1+R+N, D] (prefix tokens included);
      * facet "token": blocks 0..L, returns block L's output;
      * facet "attn": blocks 0..L-1, then block L's post-softmax attention
        probabilities [B, H, N, N] (f32, plain attention);
      * ``capture_layers=(L1, L2, ...)``: those layers' facets (q/k/v or
        token) from one pass, {L: [B, 1+R+N, D]}; a captured block that is
        not the last runs whole, the last one norm1 + qkv only;
      * ``capture_layer=None``: the full forward with the final norm, a
        dict of ``tokens`` [B, N, D] (patch tokens after the norm), ``cls``
        [B, D], ``prefix`` (CLS and registers after the norm) and
        ``pre_norm_tokens`` (every token before it);
      * ``embed_only``: the embedded tokens [B, 1+R+N, D] before any block.
    """

    def __init__(self, cfg: ViTConfig, n_blocks: Optional[int] = None,
                 device=None) -> None:
        super().__init__()
        factory = dict(device=device, dtype=cfg.dtype)
        d = cfg.embed_dim
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg, device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, **factory))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + cfg.grid_size ** 2, d, **factory))
        if cfg.num_register_tokens:
            self.register_tokens = nn.Parameter(
                torch.zeros(1, cfg.num_register_tokens, d, **factory))
        if n_blocks is None:
            # the whole trunk, with its final norm (f32 in a quantized trunk)
            self.norm = nn.LayerNorm(d, eps=cfg.ln_eps, device=device,
                                     dtype=torch.float32 if cfg.quant else cfg.dtype)
            n_blocks = cfg.depth
        if not 0 < n_blocks <= cfg.depth:
            raise ValueError(f"n_blocks {n_blocks} not in 1..{cfg.depth}")
        self.blocks = nn.ModuleList([Block(cfg, device) for _ in range(n_blocks)])

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

    def forward(self, x: torch.Tensor, capture_layer: Optional[int] = None,
                capture_facet: str = "value", embed_only: bool = False,
                capture_layers: Optional[Sequence[int]] = None):
        if capture_facet not in ("token", "attn") and capture_facet not in FACET_OFFSETS:
            raise ValueError(f"unknown facet {capture_facet!r}")
        x = self.embed(x)
        if embed_only:
            return x
        if capture_layers is not None:
            if capture_layer is not None:
                raise ValueError("pass either capture_layer or capture_layers, not both")
            return self._capture_many(x, sorted(set(int(i) for i in capture_layers)),
                                      capture_facet)
        if capture_layer is None:
            return self._full(x)
        self._check_layer(capture_layer)
        if capture_facet == "attn":
            for blk in self.blocks[:capture_layer]:
                x = blk(x)
            return self.blocks[capture_layer](x, return_attn_probs=True)
        if capture_facet == "token":
            for blk in self.blocks[:capture_layer + 1]:
                x = blk(x)
            return x
        for blk in self.blocks[:capture_layer]:
            x = blk(x)
        qkv = self.blocks[capture_layer](x, qkv_only=True)
        return self._facet(qkv, capture_facet)

    def _check_layer(self, layer: int) -> None:
        if not 0 <= layer < len(self.blocks):
            raise ValueError(f"layer {layer} is outside the {len(self.blocks)} "
                             f"materialized blocks")

    def _facet(self, qkv: torch.Tensor, facet: str) -> torch.Tensor:
        d = self.cfg.embed_dim
        off = FACET_OFFSETS[facet] * d
        return qkv[..., off:off + d]

    def _capture_many(self, x: torch.Tensor, want, facet: str) -> Dict[int, torch.Tensor]:
        """Several layers' facets in one pass (the reference hooks several
        blocks at once): max(L) + 1 blocks instead of sum(L_i + 1)."""
        if facet == "attn":
            raise ValueError("capture_layers supports q/k/v/token facets")
        self._check_layer(want[-1])
        outs = {}
        for i in range(want[-1] + 1):
            blk = self.blocks[i]
            if facet == "token":
                x = blk(x)
                if i in want:
                    outs[i] = x
            elif i == want[-1]:
                outs[i] = self._facet(blk(x, qkv_only=True), facet)
            elif i in want:
                x, qkv = blk(x, return_qkv=True)
                outs[i] = self._facet(qkv, facet)
            else:
                x = blk(x)
        return outs

    def _full(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if not hasattr(self, "norm"):
            raise ValueError("the full forward needs the whole trunk (ViT(cfg, n_blocks=None))")
        for blk in self.blocks:
            x = blk(x)
        pre_norm_tokens = x
        x = layer_norm(self.cfg, self.norm, x)
        skip = 1 + self.cfg.num_register_tokens
        return {"tokens": x[:, skip:], "cls": x[:, 0], "prefix": x[:, :skip],
                "pre_norm_tokens": pre_norm_tokens}
