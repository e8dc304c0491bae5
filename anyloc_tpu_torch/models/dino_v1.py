"""DINO v1 family and the dense-descriptor ``ViTExtractor`` API
(counterpart of ``anyloc_tpu/models/dino_v1.py``; the reference's
vendored ShirAmir/dino-vit-features extractor, dino_extractor.py:30-348).

* Stride patching is ``ViTConfig.patch_stride``: the patch conv strides
  densely and the position embedding resamples (offset 0.1) to the
  1 + (H - p) // s grid. ViT-B/8 at stride 4 and 224 px: 3025 patches,
  3026 tokens, so the trunk runs K2 (over ``MAX_FUSED_TOKENS``).
* Facets come from the truncated trunk. The reference flattens per-head
  facets head-minor (d' = dh_idx * heads + head); this is that fixed
  permutation of the fused-qkv slice.
* Log-binning (:260-306) gathers 3^k-window average pools at the 9
  clamped offsets of each level.
* Saliency (:334-348): layer 11's "attn" facet, heads {0, 2, 4, 5}, the
  CLS row, min-max normalized.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

# the JAX package's DINO v1 tree is the generic ViT tree (no LayerScale)
from anyloc_tpu_torch.models.convert import (from_jax_params, maybe_tp_split,  # noqa: F401
                                             strip_prefix, tensors)
from anyloc_tpu_torch.models.hf_convert import ensure_native_naming
from anyloc_tpu_torch.models.vit import ViTConfig
from anyloc_tpu_torch.ops.common import resolve_device

_DIMS = {
    # name: (patch, embed_dim, depth, heads)
    "dino_vits8": (8, 384, 12, 6),
    "dino_vits16": (16, 384, 12, 6),
    "dino_vitb8": (8, 768, 12, 12),
    "dino_vitb16": (16, 768, 12, 12),
}


def dino_v1_config(name: str, stride: Optional[int] = None, dtype=None,
                   img_size: int = 224) -> ViTConfig:
    if name not in _DIMS:
        raise ValueError(f"Unknown DINO v1 model: {name} (have {list(_DIMS)})")
    p, d, depth, heads = _DIMS[name]
    if stride is not None and (p // stride) * stride != p:
        raise ValueError(f"stride {stride} must divide patch {p}")
    kwargs = dict(
        img_size=img_size, patch_size=p, patch_stride=stride, embed_dim=d, depth=depth,
        num_heads=heads, mlp_type="mlp", layerscale_init=None,   # no LayerScale
        ln_eps=1e-6, interpolate_offset=0.1,   # dino_extractor.py:127, the +0.1 fudge
    )
    if dtype is not None:
        kwargs["dtype"] = dtype
    return ViTConfig(**kwargs)


def convert_dino_v1(sd: Dict, cfg: ViTConfig) -> Dict[str, torch.Tensor]:
    """A DINO v1 checkpoint (the original timm naming, or HuggingFace's
    ``ViTModel`` layout of facebook/dino-vit*) -> the port's state dict:
    the trunk's keys of ``cfg.depth`` blocks (a classifier head drops)."""
    sd = ensure_native_naming(sd, "dino_v1")
    keep = ("patch_embed.", "cls_token", "pos_embed", "norm.")
    blocks = tuple(f"blocks.{i}." for i in range(cfg.depth))
    return maybe_tp_split(tensors({k: v for k, v in sd.items() if k.startswith(keep + blocks)}),
                          cfg)


def log_bin(descs: torch.Tensor, grid: Tuple[int, int], hierarchy: int = 2) -> torch.Tensor:
    """Log-binning (ref _log_bin, dino_extractor.py:260-306): descs [B, T, D]
    (patch tokens, row-major over ``grid``) -> [B, T, D * (1 + 8 *
    hierarchy)], in the reference's bin order: per level k the 3x3
    offsets of step 3^k in row-major order (the center only at level 0)
    of the 3^k-window averages; offsets past the edge clamp to the edge
    cell; window averages count only cells inside the grid."""
    b, t, d = descs.shape
    gh, gw = grid
    if t != gh * gw:
        raise ValueError(f"{t} tokens do not fill the grid {grid}")
    x = descs.reshape(b, gh, gw, d).permute(0, 3, 1, 2)   # [B, D, gh, gw]
    pools = []
    for k in range(hierarchy):
        win = 3 ** k
        pools.append(x if win == 1 else F.avg_pool2d(
            x, win, stride=1, padding=win // 2, count_include_pad=False))
    parts = []
    ys = torch.arange(gh, device=x.device)
    xs = torch.arange(gw, device=x.device)
    for k in range(hierarchy):
        step = 3 ** k
        for dy in (-step, 0, step):
            for dx in (-step, 0, step):
                if k != 0 and dy == 0 and dx == 0:
                    continue
                iy = (ys + dy).clamp(0, gh - 1)
                ix = (xs + dx).clamp(0, gw - 1)
                parts.append(pools[k][:, :, iy][:, :, :, ix])
    out = torch.cat(parts, dim=1)   # [B, D * bins, gh, gw]
    return out.permute(0, 2, 3, 1).reshape(b, t, -1)


class ViTExtractor:
    """The reference's dense-descriptor extractor: ``extract_descriptors(
    batch, layer, facet, bin, include_cls)`` takes channels-last
    [B, H, W, 3] images (numpy or torch) and returns [B, 1, T, D']
    float32 descriptors on ``device`` (None: the card), the reference's
    shape convention. ``checkpoint`` is a local ``.pth``; None means
    random weights from ``seed``."""

    def __init__(self, model_type: str = "dino_vits8", stride: int = 4,
                 checkpoint: Optional[str] = None, dtype=torch.float32, seed: int = 42,
                 *, device: Union[None, str, torch.device] = None,
                 params: Optional[Dict] = None) -> None:
        from anyloc_tpu_torch.models.dinov2 import build_vit, init_params

        self.model_type = model_type
        self.cfg = dino_v1_config(model_type, stride=stride, dtype=dtype)
        self.p = self.cfg.patch_size
        self.stride = (stride, stride)
        self.device = resolve_device(device)
        if params is None and checkpoint is not None:
            from anyloc_tpu_torch.models.convert import load_torch_checkpoint

            params = convert_dino_v1(strip_prefix(load_torch_checkpoint(checkpoint), "module."),
                                     self.cfg)
        if params is None:
            params = init_params(self.cfg, seed, device=self.device)
        self.model = build_vit(self.cfg, params, None, device=self.device)
        self.num_patches: Optional[Tuple[int, int]] = None

    def _batch(self, batch) -> torch.Tensor:
        if isinstance(batch, np.ndarray):
            batch = torch.from_numpy(batch)
        batch = batch.to(self.device, torch.float32)
        return batch[None] if batch.dim() == 3 else batch

    @torch.inference_mode()
    def extract_descriptors(self, batch, layer: int = 11, facet: str = "key",
                            bin: bool = False, include_cls: bool = False) -> torch.Tensor:
        if facet not in ("key", "query", "value", "token"):
            raise ValueError(f"unknown facet {facet!r}")
        if bin and include_cls:
            raise ValueError("bin=True with include_cls=True is not supported")
        batch = self._batch(batch)
        b, h, w, _ = batch.shape
        self.num_patches = self.cfg.grid(h, w)
        out = self.model(batch, capture_layer=layer, capture_facet=facet).float()
        if facet != "token":
            # the reference's head-minor flatten: [B, T, heads, dh] -> [B, T, dh, heads]
            nh, dh = self.cfg.num_heads, self.cfg.head_dim
            t = out.shape[1]
            out = out.reshape(b, t, nh, dh).transpose(2, 3).reshape(b, t, nh * dh)
        if not include_cls:
            out = out[:, 1:]
        if bin:
            out = log_bin(out, self.num_patches)
        return out[:, None]

    @torch.inference_mode()
    def extract_saliency_maps(self, batch) -> torch.Tensor:
        """CLS attention saliency (ref :334-348): [B, H, W, 3] -> [B, T-1]."""
        if self.model_type != "dino_vits8":
            raise ValueError("saliency maps are supported only for dino_vits8")
        attn = self.model(self._batch(batch), capture_layer=11, capture_facet="attn")
        cls_map = attn[:, [0, 2, 4, 5], 0, 1:].mean(dim=1)   # [B, T-1]
        mins = cls_map.min(dim=1, keepdim=True).values
        maxs = cls_map.max(dim=1, keepdim=True).values
        return (cls_map - mins) / (maxs - mins)

