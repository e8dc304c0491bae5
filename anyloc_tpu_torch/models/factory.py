"""Extractor factory: model name -> batched patch-descriptor callable
(counterpart of ``anyloc_tpu/models/factory.py``).

One constructor for every family the reference spreads over six wrappers
(DinoV2ExtractFeatures, ViTExtractor, ClipWrapper, MAE, SAM, ImageBind,
plus the HF / CosPlace ViT and LSeg). Each returns an object with ``cfg``,
``device`` and ``__call__(imgs [B, H, W, 3]) -> [B, N, D]`` float32 patch
descriptors on ``device`` ([B, 1, D] for CLIP, which is global by
nature); ``device`` None means the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from anyloc_tpu_torch.ops.common import l2_normalize, resolve_device


def _images(imgs, device) -> torch.Tensor:
    if isinstance(imgs, np.ndarray):
        imgs = torch.from_numpy(imgs)
    imgs = imgs.to(device, torch.float32)
    return imgs[None] if imgs.dim() == 3 else imgs


class _Facets:
    """A family's model behind the factory's call: ``fn(images on the
    device)`` -> [B, N, D], then float32 and, with ``norm_descs``, L2."""

    def __init__(self, cfg, device, fn, norm_descs: bool) -> None:
        self.cfg, self.device, self._fn, self.norm_descs = cfg, device, fn, norm_descs

    @torch.inference_mode()
    def __call__(self, imgs) -> torch.Tensor:
        out = self._fn(_images(imgs, self.device)).float()
        return l2_normalize(out) if self.norm_descs else out


def make_extractor(
    model_type: str,
    layer: int = 11,
    facet: str = "value",
    checkpoint: Optional[str] = None,
    dtype: Union[str, torch.dtype] = torch.bfloat16,
    use_cls: bool = False,
    norm_descs: bool = True,
    stride: Optional[int] = None,
    seed: int = 42,
    quant: Optional[str] = None,
    device: Union[None, str, torch.device] = None,
):
    """``stride``: DINO v1's patch stride (default 4); the other families
    ignore it. ``quant`` selects an int8 trunk mode (the DINOv2 family
    only, the frozen-trunk serving path). An unknown family raises
    ``KeyError``."""
    from anyloc_tpu_torch.models.convert import load_torch_checkpoint, materialize
    from anyloc_tpu_torch.models.extractor import resolve_dtype

    if quant and not model_type.startswith("dinov2"):
        raise ValueError(f"quant={quant!r} is only supported for the dinov2 family "
                         f"(got {model_type!r})")
    dtype = resolve_dtype(dtype)
    if model_type.startswith("dinov2"):
        from anyloc_tpu_torch.models.extractor import DinoV2ExtractFeatures

        return DinoV2ExtractFeatures(
            model_type, layer, facet, use_cls=use_cls, norm_descs=norm_descs,
            device=device, checkpoint=checkpoint, dtype=dtype, seed=seed, quant=quant)
    if model_type.startswith(("hf_vit", "cosplace_vit")):
        from anyloc_tpu_torch.models.cosplace_vit import CosPlaceViTExtractFeatures

        return CosPlaceViTExtractFeatures(checkpoint, layer, facet, use_cls=use_cls,
                                          norm_descs=norm_descs, device=device, dtype=dtype,
                                          seed=seed)
    device = resolve_device(device)
    if model_type.startswith("dino_"):
        from anyloc_tpu_torch.models.dino_v1 import ViTExtractor

        ext = ViTExtractor(model_type, stride=stride or 4, checkpoint=checkpoint, dtype=dtype,
                           seed=seed, device=device)
        return _Facets(ext.cfg, device, lambda x: ext.extract_descriptors(
            x, layer=layer, facet=facet, include_cls=use_cls)[:, 0], norm_descs)
    if model_type.startswith("clip_"):
        from anyloc_tpu_torch.models.clip import ClipWrapper

        m = ClipWrapper(ClipWrapper.IMPL_OPENAI, model_type[len("clip_"):], use_caching=False,
                        checkpoint=checkpoint, dtype=dtype, seed=seed, device=device)
        return _Facets(m.vcfg, device, lambda x: m.encode_image(x)[:, None, :], norm_descs)
    if model_type.startswith("mae_"):
        from anyloc_tpu_torch.models.mae import (MAE_FACTORIES, MaskedAutoencoderViT,
                                                 convert_mae, encoder_state_dict)

        mcfg = MAE_FACTORIES[model_type](dtype=dtype)
        sd = None
        if checkpoint is not None:
            sd = encoder_state_dict(convert_mae(load_torch_checkpoint(checkpoint), mcfg))
        # the encoder alone: the extractor keeps the latent, never the decoder's output
        model = materialize(lambda: MaskedAutoencoderViT(mcfg, encoder_only=True), sd, device,
                            seed)
        return _Facets(mcfg.block_cfg(), device,
                       lambda x: model.encode(x)[:, 0 if use_cls else 1:], norm_descs)
    if model_type.startswith("sam_"):
        from anyloc_tpu_torch.models.sam import SAM_FACTORIES, SAMImageEncoder, convert_sam

        scfg = dataclasses.replace(SAM_FACTORIES[model_type[len("sam_"):]](), dtype=dtype)
        sd = None if checkpoint is None else convert_sam(load_torch_checkpoint(checkpoint), scfg)
        model = materialize(lambda: SAMImageEncoder(scfg), sd, device, seed)
        return _Facets(scfg, device, lambda x: model(x, return_tokens=True), norm_descs)
    if model_type.startswith("imagebind"):
        from anyloc_tpu_torch.models.imagebind import ImageBindVision

        m = ImageBindVision(checkpoint, dtype=dtype, seed=seed, device=device)
        return _Facets(m.cfg, device, lambda x: m(x)["tokens"], norm_descs)
    if model_type.startswith("lseg"):
        # the encoder itself runs (the reference only reads .npy caches of
        # it): dense pixel features in CLIP's text space, flattened to the
        # standard [B, N, D] layout
        from anyloc_tpu_torch.models.lseg import LSegEncoder, convert_lseg, lseg_config

        cfg = lseg_config(dtype=dtype)
        sd = None if checkpoint is None else convert_lseg(load_torch_checkpoint(checkpoint), cfg)
        enc = materialize(lambda: LSegEncoder(cfg), sd, device, seed)
        ext = _Facets(cfg.backbone, device, lambda x: enc(x, normalize=norm_descs).flatten(1, 2),
                      False)
        ext.backbone_cfg, ext.lseg_cfg = cfg.backbone, cfg
        return ext
    raise KeyError(f"Unknown model family for '{model_type}'")
