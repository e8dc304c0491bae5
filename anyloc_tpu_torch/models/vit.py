"""One ViT trunk for the model zoo in PyTorch (counterpart of
``anyloc_tpu/models/vit.py``): DINOv2, DINO v1, CLIP's vision tower, the
HF / CosPlace ViT, ImageBind's vision trunk and LSeg's backbone are
configurations of it.

* channels-last input [B, H, W, 3], already normalized; the patch conv
  strides by ``patch_stride`` (DINO v1's overlapping patches: a grid of
  1 + (H - p) // stride) or by the patch size;
* optional CLS and register tokens; a learned position embedding (or the
  fixed 2-D sin-cos one) resized bicubically to the grid: with DINOv2's
  scale offset (``interpolate_offset`` 0.1), or to the grid's size when
  the offset is 0 (CLIP, ImageBind, LSeg, HF ViT);
* an optional LayerNorm before the blocks (``pre_norm``: CLIP,
  ImageBind); pre-norm blocks with or without LayerScale, an exact-GELU,
  quick-GELU (CLIP) or SwiGLU-fused MLP;
* ``capture_layer`` truncation: blocks after the captured one never run,
  and the captured block runs only norm1 + qkv for the q/k/v facets;
  ``capture_layers`` captures several layers in one pass;
* the untruncated forward (``capture_layer=None``) ends with the
  trunk-final LayerNorm (unless ``final_norm`` is off) and, with
  ``proj_dim``, CLIP's output projection of the pooled token (CLS, or the
  mean token without one), both built only for the whole trunk
  (``n_blocks`` None); ``embed_only`` returns the embedded tokens; the
  "attn" facet returns a block's softmax attention probabilities.

Attention routing follows the JAX trunk: N <= ``MAX_FUSED_TOKENS`` goes
to K5 (attention + projection + LayerScale when the trunk has it +
residual from the fused qkv), longer sequences to K2 on head-split views
with a plain projection.

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

Module names match the facebookresearch/dinov2 (timm) checkpoints, so
their state dicts load unchanged (``models/dinov2.py::native_state_dict``);
the other families' converters rename into them, plus ``norm_pre`` and
``proj_out``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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
from anyloc_tpu_torch.ops.common import Conv2d

FACET_OFFSETS = {"query": 0, "key": 1, "value": 2}


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Architecture hyperparameters (each family's factory in its module:
    dinov2.py, dino_v1.py, clip.py, ...)."""

    img_size: int = 518            # training-time image size (pos-embed grid)
    patch_size: int = 14
    patch_stride: Optional[int] = None   # < patch_size: overlapping patches
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    mlp_type: str = "mlp"          # "mlp" | "swiglu_fused"
    act: str = "gelu"              # the "mlp" activation: "gelu" (erf) | "quick_gelu"
    layerscale_init: Optional[float] = 1e-5   # None: no LayerScale
    ln_eps: float = 1e-6
    num_register_tokens: int = 0
    use_cls_token: bool = True
    pos_embed_type: str = "learned"  # "learned" | "sincos2d" (fixed)
    qkv_bias: bool = True
    patch_bias: bool = True        # CLIP's patch conv has no bias
    proj_dim: Optional[int] = None  # CLIP: projection of the pooled token
    pre_norm: bool = False         # CLIP, ImageBind: LayerNorm before the blocks
    final_norm: bool = True        # the trunk-final LayerNorm
    interpolate_offset: float = 0.1   # 0: resize the pos-embed to the grid's size
    interpolate_antialias: bool = False
    dtype: torch.dtype = torch.float32   # parameter and activation dtype
    attn_impl: str = "auto"        # "auto" | "pallas" | "xla": taken, not read (the port
    # routes by device: the kernels on the card, their plain versions on the CPU)
    quant: Optional[str] = None    # None | "int8" | "int8_mlp" | "int8_fused" | "int8_full"
    attn_pack_pairs: bool = False  # taken, not read: a TPU MXU tiling of int8_full
    tp_split: bool = False         # wq / wk / wv and SwiGLU w1 / w2 stored apart (tensor
    # parallelism shards them head- and gate-aligned, parallel/tp.py); the fused facet
    # layout is their concatenation, and the K4 / K3 halves (fused layouts) do not run
    remat: bool = False            # recompute each block in the backward (activation memory)

    def __post_init__(self) -> None:
        if self.attn_impl not in ("auto", "pallas", "xla"):
            raise ValueError(f"attn_impl must be 'auto', 'pallas' or 'xla', got {self.attn_impl!r}")
        if self.act not in ACTIVATIONS:
            raise ValueError(f"act must be one of {sorted(ACTIVATIONS)}, got {self.act!r}")
        if self.pos_embed_type not in ("learned", "sincos2d"):
            raise ValueError(f"unknown pos_embed_type {self.pos_embed_type!r}")
        if self.quant is not None:
            if self.quant not in QUANT_MODES:
                raise ValueError(f"quant must be None or one of {QUANT_MODES}, got {self.quant!r}")
            if self.act != "gelu" or not self.qkv_bias:
                # the int8 kernels' MLP is exact GELU or SwiGLU, and QLinear
                # carries a bias: the int8 modes are the DINOv2 family's
                raise ValueError("the int8 modes need act='gelu' and qkv_bias (DINOv2 trunks)")

        if self.tp_split and self.quant == "int8_fused":
            # F23: int8_fused quantizes the MLP for its K3 half, which needs the
            # fused layouts; the JAX tp_split trunk then builds a float MLP that
            # cannot take its own quantized tree
            raise ValueError("tp_split cannot run quant='int8_fused' (its int8 MLP half needs "
                             "the fused w12 / fc layouts); use 'int8_mlp', 'int8' or 'int8_full'")

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
    def num_prefix_tokens(self) -> int:
        """CLS (when the trunk has one) and registers, ahead of the patches."""
        return int(self.use_cls_token) + self.num_register_tokens

    def grid(self, h: int, w: int) -> Tuple[int, int]:
        """The patch grid of an H x W image: 1 + (H - p) // stride per side."""
        s = self.patch_stride or self.patch_size
        return 1 + (h - self.patch_size) // s, 1 + (w - self.patch_size) // s

    @property
    def mlp_hidden(self) -> int:
        if self.mlp_type == "swiglu_fused":
            # DINOv2-giant SwiGLUFFNFused: round8(int(4 d * 2/3))
            return ((int(self.embed_dim * self.mlp_ratio * 2 / 3) + 7) // 8) * 8
        return int(self.embed_dim * self.mlp_ratio)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's GELU approximation, x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def exact_gelu(x: torch.Tensor) -> torch.Tensor:
    """torch's ``nn.GELU()`` default: the erf form, not the tanh one."""
    return F.gelu(x)


ACTIVATIONS = {"gelu": exact_gelu, "quick_gelu": quick_gelu}


def interpolate_pos_embed(
    pos_embed: torch.Tensor,
    grid_hw: Tuple[int, int],
    num_prefix: int,
    offset: float = 0.1,
    antialias: bool = False,
) -> torch.Tensor:
    """Bicubic resize of the patch position embeddings [1, P + M*M, D] to
    a new grid, in float32. With an ``offset`` (DINOv2's and DINO v1's
    ``interpolate_pos_encoding``) the scale factor is (g + offset) / M
    with ``recompute_scale_factor=False``: the offset shifts the sampling
    grid, not only the size. With offset 0 the resize is to the grid's
    size (CLIP, ImageBind, LSeg, HF ViT)."""
    h, w = grid_hw
    n_patch = pos_embed.shape[1] - num_prefix
    m = int(round(math.sqrt(n_patch)))
    if m * m != n_patch:
        raise ValueError(f"pos_embed grid is not square: {n_patch} tokens")
    if (h, w) == (m, m):
        return pos_embed
    prefix = pos_embed[:, :num_prefix]
    patch = pos_embed[:, num_prefix:].float().reshape(1, m, m, -1).permute(0, 3, 1, 2)
    if offset:
        patch = F.interpolate(patch, scale_factor=((h + offset) / m, (w + offset) / m),
                              mode="bicubic", align_corners=False, antialias=antialias,
                              recompute_scale_factor=False)
    else:
        patch = F.interpolate(patch, size=(h, w), mode="bicubic", align_corners=False,
                              antialias=antialias)
    if tuple(patch.shape[-2:]) != (h, w):
        raise ValueError(f"interpolated grid {tuple(patch.shape[-2:])} != {(h, w)}")
    patch = patch.permute(0, 2, 3, 1).reshape(1, h * w, -1)
    return torch.cat([prefix.float(), patch], dim=1)


def sincos_2d_pos_embed(embed_dim: int, grid: int, cls_token: bool) -> torch.Tensor:
    """The fixed 2-D sin-cos position embedding [1, (1) + grid², D] in
    float32 (MAE; the reference's utilities.py:309-356): half the channels
    encode the column, half the row, each as sin | cos of the position at
    frequencies 10000^(-k / (D/4))."""
    gh = np.arange(grid, dtype=np.float32)
    gw = np.arange(grid, dtype=np.float32)
    mesh = np.stack(np.meshgrid(gw, gh), axis=0).reshape(2, -1)   # w first

    def emb_1d(dim, pos):
        omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
        out = np.einsum("m,d->md", pos, omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    emb = np.concatenate([emb_1d(embed_dim // 2, mesh[0]), emb_1d(embed_dim // 2, mesh[1])],
                         axis=1)
    if cls_token:
        emb = np.concatenate([np.zeros((1, embed_dim)), emb], axis=0)
    return torch.from_numpy(emb[None].astype(np.float32))


@functools.lru_cache(maxsize=32)
def sincos_on(embed_dim: int, grid: int, cls_token: bool, device: torch.device) -> torch.Tensor:
    """``sincos_2d_pos_embed`` on ``device``, made once per device (a copy
    from pageable host memory would wait for the device's queued work)."""
    return sincos_2d_pos_embed(embed_dim, grid, cls_token).to(device)


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


def _linear(cfg: ViTConfig, name: str, in_f: int, out_f: int, device,
            bias: bool = True) -> nn.Module:
    if cfg.quantizes(name):
        return QLinear(in_f, out_f, device=device)
    return nn.Linear(in_f, out_f, bias=bias, device=device, dtype=cfg.dtype)


class Attention(nn.Module):
    """Fused-qkv attention (the facet API slices the fused qkv output); with
    ``tp_split`` three towers wq / wk / wv whose outputs concatenate to the
    same [B, N, 3D] layout (q|k|v, head-minor)."""

    def __init__(self, cfg: ViTConfig, device=None) -> None:
        super().__init__()
        d = cfg.embed_dim
        if cfg.tp_split:
            for name in ("wq", "wk", "wv"):
                setattr(self, name, _linear(cfg, name, d, d, device, bias=cfg.qkv_bias))
        else:
            self.qkv = _linear(cfg, "qkv", d, 3 * d, device, bias=cfg.qkv_bias)
        self.proj = _linear(cfg, "proj", d, d, device)

    def qkv_out(self, h: torch.Tensor) -> torch.Tensor:
        """The fused [B, N, 3D] qkv of the normalized tokens ``h``."""
        if hasattr(self, "qkv"):
            return self.qkv(h)
        return torch.cat([self.wq(h), self.wk(h), self.wv(h)], dim=-1)


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None) -> None:
        super().__init__()
        self.fc1 = _linear(cfg, "fc1", cfg.embed_dim, cfg.mlp_hidden, device)
        self.fc2 = _linear(cfg, "fc2", cfg.mlp_hidden, cfg.embed_dim, device)
        self.act = ACTIVATIONS[cfg.act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))

    def int8_layers(self):
        return self.fc1, self.fc2


class SwiGLUFFNFused(nn.Module):
    """SwiGLU with the fused [D, 2H] gate pair w12, or with ``tp_split``
    the gate-aligned towers w1 / w2."""

    def __init__(self, cfg: ViTConfig, device=None) -> None:
        super().__init__()
        h = cfg.mlp_hidden
        if cfg.tp_split:
            self.w1 = _linear(cfg, "w1", cfg.embed_dim, h, device)
            self.w2 = _linear(cfg, "w2", cfg.embed_dim, h, device)
        else:
            self.w12 = _linear(cfg, "w12", cfg.embed_dim, 2 * h, device)
        self.w3 = _linear(cfg, "w3", h, cfg.embed_dim, device)

    def gates(self, x: torch.Tensor) -> torch.Tensor:
        """silu(x·W1) * (x·W2): the input of w3."""
        if hasattr(self, "w12"):
            x1, x2 = self.w12(x).chunk(2, dim=-1)
        else:
            x1, x2 = self.w1(x), self.w2(x)
        return F.silu(x1) * x2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w3(self.gates(x))

    def int8_layers(self):
        return self.w12, self.w3


class Block(nn.Module):
    """Pre-norm block: x + ls1(attn(norm1 x)); x + ls2(mlp(norm2 x)), with
    ls1 / ls2 the identity (and not built) when the trunk has no
    LayerScale."""

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
        if cfg.layerscale_init is not None:
            self.ls1 = LayerScale(d, cfg.layerscale_init, **keep)
            self.ls2 = LayerScale(d, cfg.layerscale_init, **keep)
        self.tp = None   # (mesh, axis) of a tensor-parallel block (parallel/tp.py::shard_vit_tp)

    def gamma(self, i: int) -> Optional[torch.Tensor]:
        """LayerScale ``i``'s gamma, or None without LayerScale."""
        return None if self.cfg.layerscale_init is None else getattr(self, f"ls{i}").gamma

    def _scale(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return x if self.cfg.layerscale_init is None else getattr(self, f"ls{i}")(x)

    def forward(self, x: torch.Tensor, qkv_only: bool = False, return_qkv: bool = False,
                return_attn_probs: bool = False, attn_fn=None):
        """The block; ``qkv_only``: norm1 + qkv only, returns the fused
        [B, N, 3D] qkv; ``return_qkv``: (block output, qkv), the int8_full
        attention half then unfused as in the JAX trunk;
        ``return_attn_probs``: the post-softmax attention [B, H, N, N] f32
        (plain attention on every device, as in the JAX trunk);
        ``attn_fn(q, k, v)``: the caller's attention over the head-split
        [B, H, N, hd] tensors in place of the trunk's (the JAX hook, where
        the sequence-parallel ring goes, ``parallel/sp.py``)."""
        c = self.cfg
        b, n, d = x.shape
        if self.tp is not None:
            from anyloc_tpu_torch.parallel.tp import tp_block_forward

            if return_qkv or return_attn_probs or attn_fn is not None:
                raise ValueError("a tensor-parallel block returns its output or its qkv only")
            return tp_block_forward(self, x, qkv_only=qkv_only)
        if (c.quant == "int8_full" and not (qkv_only or return_qkv or return_attn_probs)
                and attn_fn is None and not c.tp_split and n <= MAX_FUSED_TOKENS
                and attn_geometry_ok(c.num_heads, c.head_dim)):
            # K4: norm1 + int8 qkv + attention + int8 proj + ls1 + residual
            qkv, proj = self.attn.qkv, self.attn.proj
            x = fused_attn_half_int8(
                x, qkv.weight_q.t(), qkv.weight_scale, qkv.bias, proj.weight_q.t(),
                proj.weight_scale, proj.bias, num_heads=c.num_heads,
                ln_params=(self.norm1.weight, self.norm1.bias), ln_eps=c.ln_eps,
                layerscale=self.gamma(1))
            return self._mlp_half(x)
        qkv = self.attn.qkv_out(layer_norm(c, self.norm1, x))   # [B, N, 3D] facet source
        if qkv_only:
            return qkv
        if return_attn_probs:
            h, hd = c.num_heads, c.head_dim
            q, k = (qkv[..., i * d:(i + 1) * d].view(b, n, h, hd).transpose(1, 2)
                    for i in range(2))
            s = (q * hd ** -0.5).float() @ k.float().transpose(-1, -2)
            return torch.softmax(s, dim=-1)
        x = self._attn_half(x, qkv, attn_fn)
        out = self._mlp_half(x)
        return (out, qkv) if return_qkv else out

    def _attn_half(self, x: torch.Tensor, qkv: torch.Tensor, attn_fn=None) -> torch.Tensor:
        c = self.cfg
        b, n, d = x.shape
        if n <= MAX_FUSED_TOKENS and c.quant not in ("int8", "int8_full") and attn_fn is None:
            # K5: attention + proj (+ LayerScale) + residual from the raw qkv
            x = flash_attention_qkv_proj(
                qkv, self.attn.proj.weight.t(), self.attn.proj.bias,
                num_heads=c.num_heads, layerscale=self.gamma(1), residual=x)
        else:
            # K2 on head-split strided views of qkv, then the projection
            h, hd = c.num_heads, c.head_dim
            q, k, v = (qkv[..., i * d:(i + 1) * d].view(b, n, h, hd).transpose(1, 2)
                       for i in range(3))
            o = (attn_fn or flash_attention)(q, k, v).transpose(1, 2).reshape(b, n, d)
            x = x + self._scale(1, self.attn.proj(o))
        return x

    def _mlp_half(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        if c.quant not in ("int8_fused", "int8_full") or c.tp_split:
            return x + self._scale(2, self.mlp(layer_norm(c, self.norm2, x)))
        ln = (self.norm2.weight, self.norm2.bias)
        if int8_mlp_geometry_ok(c.mlp_type, c.mlp_hidden):
            # K3: norm2 + int8 w12 + SwiGLU/GELU + int8 w3 + ls2 + residual
            l1, l3 = self.mlp.int8_layers()
            return fused_mlp_int8(
                x, l1.weight_q.t(), l1.weight_scale, l1.bias, l3.weight_q.t(),
                l3.weight_scale, l3.bias, mlp_type=c.mlp_type, ln_params=ln,
                ln_eps=c.ln_eps, layerscale=self.gamma(2), residual=True)
        # the per-row composition the JAX trunk falls back to (vit.py:670-682)
        h = ln_rows(x.float(), *ln, c.ln_eps).to(c.dtype)
        m = self.mlp(h).float()
        if self.gamma(2) is not None:
            m = m * self.gamma(2).float()
        return (x.float() + m).to(c.dtype)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None) -> None:
        super().__init__()
        self.proj = Conv2d(3, cfg.embed_dim, cfg.patch_size,
                              cfg.patch_stride or cfg.patch_size, bias=cfg.patch_bias,
                              device=device, dtype=cfg.dtype)


class ViT(nn.Module):
    """The trunk: ``n_blocks`` materializes only the first blocks (an
    extractor never needs the rest); None builds every block, the
    trunk-final ``norm`` (with ``final_norm``) and ``proj_out`` (with
    ``proj_dim``).

    ``forward(x, capture_layer=L, capture_facet=f)``:
      * facet "query" | "key" | "value": blocks 0..L-1, then norm1 + qkv of
        block L; returns [B, P+N, D] (the P prefix tokens included);
      * facet "token": blocks 0..L, returns block L's output;
      * facet "attn": blocks 0..L-1, then block L's post-softmax attention
        probabilities [B, H, N, N] (f32, plain attention);
      * ``capture_layers=(L1, L2, ...)``: those layers' facets (q/k/v or
        token) from one pass, {L: [B, P+N, D]}; a captured block that is
        not the last runs whole, the last one norm1 + qkv only;
      * ``capture_layer=None``: the full forward, a dict of ``tokens``
        [B, N, D] (patch tokens after the final norm), ``cls`` [B, D]
        (the CLS token, or the mean of every token without one, through
        ``proj_out`` when there is one: [B, proj_dim]), ``prefix`` (CLS
        and registers after the norm) and ``pre_norm_tokens`` (every token
        before it);
      * ``embed_only``: the embedded tokens [B, P+N, D] before any block.
    """

    def __init__(self, cfg: ViTConfig, n_blocks: Optional[int] = None,
                 device=None) -> None:
        super().__init__()
        factory = dict(device=device, dtype=cfg.dtype)
        # LayerNorms outside the blocks are f32 in a quantized trunk
        ln = dict(eps=cfg.ln_eps, device=device,
                  dtype=torch.float32 if cfg.quant else cfg.dtype)
        d = cfg.embed_dim
        self.cfg = cfg
        self.whole = n_blocks is None
        self.patch_embed = PatchEmbed(cfg, device)
        if cfg.use_cls_token:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, d, **factory))
        if cfg.pos_embed_type == "learned":
            self.pos_embed = nn.Parameter(torch.zeros(
                1, int(cfg.use_cls_token) + cfg.grid_size ** 2, d, **factory))
        if cfg.num_register_tokens:
            self.register_tokens = nn.Parameter(
                torch.zeros(1, cfg.num_register_tokens, d, **factory))
        if cfg.pre_norm:
            self.norm_pre = nn.LayerNorm(d, **ln)
        if n_blocks is None:
            # the whole trunk, with its final norm and output projection
            if cfg.final_norm:
                self.norm = nn.LayerNorm(d, **ln)
            if cfg.proj_dim is not None:
                self.proj_out = nn.Linear(d, cfg.proj_dim, bias=False, **factory)
            n_blocks = cfg.depth
        if not 0 < n_blocks <= cfg.depth:
            raise ValueError(f"n_blocks {n_blocks} not in 1..{cfg.depth}")
        self.blocks = nn.ModuleList([Block(cfg, device) for _ in range(n_blocks)])

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> token sequence [B, P+N, D] (CLS, registers,
        patches), before the blocks (after ``norm_pre``)."""
        c = self.cfg
        b = x.shape[0]
        x = self.patch_embed.proj(x.to(c.dtype).permute(0, 3, 1, 2))
        gh, gw = x.shape[-2:]
        x = x.flatten(2).transpose(1, 2)
        n_cls = int(c.use_cls_token)
        if n_cls:
            x = torch.cat([self.cls_token.expand(b, -1, -1), x], dim=1)
        pos = (self.pos_embed if c.pos_embed_type == "learned"
               else sincos_on(c.embed_dim, c.grid_size, c.use_cls_token, x.device))
        pos = interpolate_pos_embed(pos, (gh, gw), n_cls, offset=c.interpolate_offset,
                                    antialias=c.interpolate_antialias)
        x = x + pos.to(x.dtype)
        if c.num_register_tokens:
            x = torch.cat([x[:, :n_cls], self.register_tokens.expand(b, -1, -1),
                           x[:, n_cls:]], dim=1)
        if c.pre_norm:
            x = layer_norm(c, self.norm_pre, x)
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
                x = self._run(blk, x)
            return self.blocks[capture_layer](x, return_attn_probs=True)
        if capture_facet == "token":
            for blk in self.blocks[:capture_layer + 1]:
                x = self._run(blk, x)
            return x
        for blk in self.blocks[:capture_layer]:
            x = self._run(blk, x)
        qkv = self.blocks[capture_layer](x, qkv_only=True)
        return self._facet(qkv, capture_facet)

    def _run(self, blk: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """One whole block; with ``cfg.remat`` and a gradient to build, its
        activations are recomputed in the backward instead of kept (the JAX
        trunk's ``nn.remat(Block)``)."""
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(blk, x, use_reentrant=False)
        return blk(x)

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
                x = self._run(blk, x)
                if i in want:
                    outs[i] = x
            elif i == want[-1]:
                outs[i] = self._facet(blk(x, qkv_only=True), facet)
            elif i in want:
                x, qkv = blk(x, return_qkv=True)
                outs[i] = self._facet(qkv, facet)
            else:
                x = self._run(blk, x)
        return outs

    def _full(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        c = self.cfg
        if not self.whole:
            raise ValueError("the full forward needs the whole trunk (ViT(cfg, n_blocks=None))")
        for blk in self.blocks:
            x = self._run(blk, x)
        pre_norm_tokens = x
        if c.final_norm:
            x = layer_norm(c, self.norm, x)
        skip = c.num_prefix_tokens
        cls = x[:, 0] if c.use_cls_token else x.mean(dim=1)
        if c.proj_dim is not None:
            cls = self.proj_out(cls)
        return {"tokens": x[:, skip:], "cls": cls, "prefix": x[:, :skip],
                "pre_norm_tokens": pre_norm_tokens}
