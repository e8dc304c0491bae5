"""Facet extractors (counterpart of ``anyloc_tpu/models/extractor.py``).

The reference hooks ``blocks[layer].attn.qkv``, runs the full model, slices
a third of the fused [B, N, 3D] output, drops CLS and L2-normalizes. Here
the trunk is truncated at the captured layer: only blocks 0..layer are
materialized, and the captured block runs norm1 + qkv only.
"""

from __future__ import annotations

from typing import Mapping, Optional, Union

import numpy as np
import torch

from anyloc_tpu_torch.data.transforms import device_normalize
from anyloc_tpu_torch.models.dinov2 import build_vit, dinov2_config, init_params, load_checkpoint
from anyloc_tpu_torch.models.vit import ViTConfig
from anyloc_tpu_torch.ops.common import l2_normalize

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {list(_DTYPES)}, got {dtype!r}")
    return _DTYPES[dtype]


class ViTFacetExtractor:
    """Batched facet extraction over a ``ViT`` config.

    Call with channels-last images [B, H, W, 3] (numpy or torch): float
    inputs are already normalized; uint8 inputs are normalized on the
    device with ImageNet statistics. Returns [B, n_patches (+1 with
    ``use_cls``), D] float32 facets on ``device``.

    ``params``: a DINOv2-named state dict (torch tensors or numpy arrays),
    or None for random weights from ``seed``.
    """

    supports_uint8 = True

    def __init__(
        self,
        cfg: ViTConfig,
        params: Optional[Mapping],
        layer: int,
        facet: str = "token",
        use_cls: bool = False,
        norm_descs: bool = True,
        *,
        device: Union[str, torch.device] = "cpu",
        seed: int = 42,
    ) -> None:
        if facet not in ("query", "key", "value", "token"):
            raise ValueError(f"unknown facet {facet!r}")
        if not 0 <= layer < cfg.depth:
            raise ValueError(f"layer {layer} out of range [0, {cfg.depth})")
        self.cfg = cfg
        self.layer = layer
        self.facet = facet
        self.use_cls = use_cls
        self.norm_descs = norm_descs
        self.device = torch.device(device)
        n_blocks = layer + 1
        if params is None:
            params = init_params(cfg, seed, n_blocks=n_blocks, device=self.device)
        self.model = build_vit(cfg, params, n_blocks, device=self.device)

    @torch.inference_mode()
    def __call__(self, imgs) -> torch.Tensor:
        if isinstance(imgs, np.ndarray):
            imgs = torch.from_numpy(imgs)
        imgs = imgs.to(self.device, non_blocking=True)
        if imgs.dim() == 3:
            imgs = imgs[None]
        if imgs.dtype == torch.uint8:
            imgs = device_normalize(imgs)
        out = self.model(imgs, capture_layer=self.layer, capture_facet=self.facet)
        skip = 1 + self.cfg.num_register_tokens
        if self.use_cls:
            # keep CLS (token 0) with the patches; registers always drop
            if self.cfg.num_register_tokens:
                out = torch.cat([out[:, :1], out[:, skip:]], dim=1)
        else:
            out = out[:, skip:]
        out = out.float()
        if self.norm_descs:
            out = l2_normalize(out, dim=-1)
        return out.contiguous()


class DinoV2ExtractFeatures(ViTFacetExtractor):
    """The reference's constructor: ``DinoV2ExtractFeatures(dino_model,
    layer, facet, use_cls, norm_descs, device)``. ``checkpoint`` is a local
    ``.pth`` state dict; None means random weights from ``seed``."""

    def __init__(
        self,
        dino_model: str,
        layer: int,
        facet: str = "token",
        use_cls: bool = False,
        norm_descs: bool = True,
        device: Union[str, torch.device] = "cpu",
        checkpoint: Optional[str] = None,
        dtype: Union[str, torch.dtype] = torch.bfloat16,
        seed: int = 42,
        quant: Optional[str] = None,
    ) -> None:
        if quant is not None:
            raise NotImplementedError(
                f"quant={quant!r}: the int8 trunk modes are the port's next "
                "slice (ROADMAP.md, port queue item 1)")
        cfg = dinov2_config(dino_model, dtype=resolve_dtype(dtype))
        params = load_checkpoint(checkpoint) if checkpoint is not None else None
        super().__init__(cfg, params, layer, facet, use_cls=use_cls,
                         norm_descs=norm_descs, device=device, seed=seed)
        self.vit_type = dino_model
