"""Extractor factory: model name -> batched patch-descriptor callable
(counterpart of ``anyloc_tpu/models/factory.py``, DINOv2 family only)."""

from __future__ import annotations

from typing import Optional, Union

import torch


def make_extractor(
    model_type: str,
    layer: int = 11,
    facet: str = "value",
    checkpoint: Optional[str] = None,
    dtype: Union[str, torch.dtype] = torch.bfloat16,
    use_cls: bool = False,
    norm_descs: bool = True,
    seed: int = 42,
    quant: Optional[str] = None,
    device: Union[None, str, torch.device] = None,
):
    """An object with ``__call__(imgs) -> [B, N, D]`` facets and ``cfg``;
    ``device`` None means the card."""
    if model_type.startswith("dinov2"):
        from anyloc_tpu_torch.models.extractor import DinoV2ExtractFeatures

        return DinoV2ExtractFeatures(
            model_type, layer, facet, use_cls=use_cls, norm_descs=norm_descs,
            device=device, checkpoint=checkpoint, dtype=dtype, seed=seed,
            quant=quant,
        )
    raise NotImplementedError(
        f"model family of {model_type!r} is not ported yet (ROADMAP.md, "
        'port queue: "The other model families")')
