"""Facet extractors (counterpart of ``anyloc_tpu/models/extractor.py``).

The reference hooks ``blocks[layer].attn.qkv``, runs the full model, slices
a third of the fused [B, N, 3D] output, drops CLS and L2-normalizes. Here
the trunk is truncated at the captured layer: only blocks 0..layer are
materialized, and the captured block runs norm1 + qkv only.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Union

import numpy as np
import torch

from anyloc_tpu_torch.data.transforms import device_normalize
from anyloc_tpu_torch.models import dinov2
from anyloc_tpu_torch.models.dinov2 import (
    build_vit,
    dinov2_config,
    load_checkpoint,
    native_state_dict,
)
from anyloc_tpu_torch.models.vit import ViTConfig
from anyloc_tpu_torch.ops.common import l2_normalize, resolve_device
from anyloc_tpu_torch.ops.quant import quantize_vit_params

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {list(_DTYPES)}, got {dtype!r}")
    return _DTYPES[dtype]


def init_params(cfg: ViTConfig, seed: int = 42, img_size: Optional[int] = None, *,
                n_blocks: Optional[int] = None, device=None):
    """Random shape-true weights of a ``ViT`` config (``dinov2.init_params``:
    made on ``device`` from a ``torch.Generator`` seeded with ``seed``;
    ``n_blocks`` the blocks a truncated trunk holds, None the whole trunk).
    ``img_size`` is the JAX signature's: the weights do not depend on it."""
    del img_size
    return dinov2.init_params(cfg, seed, n_blocks=n_blocks, device=device)


class ViTFacetExtractor:
    """Batched facet extraction over a ``ViT`` config.

    Call with channels-last images [B, H, W, 3] (numpy or torch): float
    inputs are already normalized; uint8 inputs are normalized on the
    device with ImageNet statistics. Returns [B, n_patches (+1 with
    ``use_cls``), D] float32 facets on ``device``.

    ``params``: a state dict in the trunk's (DINOv2 / timm) naming (torch
    tensors or numpy arrays; for a quantized ``cfg`` in
    ``quantize_vit_params``' layout), or None for random weights from
    ``seed``. ``device`` None means the card.
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
        device: Union[None, str, torch.device] = None,
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
        self.device = resolve_device(device)
        n_blocks = layer + 1
        if params is None:
            params = init_params(cfg, seed, n_blocks=n_blocks, device=self.device)
        self.model = build_vit(cfg, params, n_blocks, device=self.device)

    def _images(self, imgs) -> torch.Tensor:
        if isinstance(imgs, np.ndarray):
            imgs = torch.from_numpy(imgs)
        imgs = imgs.to(self.device, non_blocking=True)
        if imgs.dim() == 3:
            imgs = imgs[None]
        return device_normalize(imgs) if imgs.dtype == torch.uint8 else imgs

    @torch.inference_mode()
    def __call__(self, imgs) -> torch.Tensor:
        return self._post(self.model(self._images(imgs), capture_layer=self.layer,
                                     capture_facet=self.facet))

    def _forward(self, params, imgs) -> torch.Tensor:
        """The JAX extractors' forward hook ``_forward(params, imgs)``, which
        ``DescriptorEngine(mesh=...)`` runs on each rank's images. The
        module holds its weights, so ``params`` is None."""
        if params is not None:
            raise ValueError("the port's extractor holds its weights: pass params=None")
        return self(imgs)

    @torch.inference_mode()
    def extract_multilayer(self, imgs, layers) -> dict:
        """Facets of several layers from one trunk pass (the reference's
        multi-hook pattern): {layer: [B, N (+1), D]}. The trunk holds blocks
        0..``layer``, so ``layers`` may not pass the extractor's own."""
        outs = self.model(self._images(imgs), capture_layers=tuple(layers),
                          capture_facet=self.facet)
        return {li: self._post(out) for li, out in outs.items()}

    def _post(self, out: torch.Tensor) -> torch.Tensor:
        """Drop registers (and CLS unless ``use_cls``), f32, L2-normalize."""
        skip = self.cfg.num_prefix_tokens
        if self.use_cls:
            # keep CLS (token 0) with the patches; registers always drop
            if self.cfg.num_register_tokens:
                out = torch.cat([out[:, :1], out[:, skip:]], dim=1)
        else:
            out = out[:, skip:]
        out = out.float()
        if self.norm_descs:
            out = l2_normalize(out)
        return out.contiguous()


class DinoV2ExtractFeatures(ViTFacetExtractor):
    """The reference's constructor: ``DinoV2ExtractFeatures(dino_model,
    layer, facet, use_cls, norm_descs, device)``. ``checkpoint`` is a local
    ``.pth`` state dict; None means random weights from ``seed``.
    ``quant``: None or an int8 trunk mode ("int8", "int8_mlp",
    "int8_fused", "int8_full" — see ``ViTConfig.quant``); "int8_full" is
    the serving mode. Checkpoint weights are quantized after loading.
    ``device`` None means the card."""

    def __init__(
        self,
        dino_model: str,
        layer: int,
        facet: str = "token",
        use_cls: bool = False,
        norm_descs: bool = True,
        device: Union[None, str, torch.device] = None,
        checkpoint: Optional[str] = None,
        dtype: Union[str, torch.dtype] = torch.bfloat16,
        seed: int = 42,
        quant: Optional[str] = None,
    ) -> None:
        cfg = dataclasses.replace(dinov2_config(dino_model, dtype=resolve_dtype(dtype)),
                                  quant=quant)
        params = None
        if checkpoint is not None:
            params = native_state_dict(load_checkpoint(checkpoint), layer + 1)
            if quant:
                params = quantize_vit_params(params, quant)
        super().__init__(cfg, params, layer, facet, use_cls=use_cls,
                         norm_descs=norm_descs, device=device, seed=seed)
        self.vit_type = dino_model
