"""CosPlace-finetuned HF-ViT extractor (counterpart of
``anyloc_tpu/models/cosplace_vit.py``; the reference's
``CosPlaceViTExtractFeatures``, utilities.py:134-211): a HuggingFace
``ViTModel`` (vit-base-224: LayerNorm eps 1e-12, separate q/k/v Linears,
learned position embeddings) loaded from a CosPlace checkpoint, facets
from the q/k/v Linears or a block's output. The separate q/k/v fuse into
the trunk's qkv: the fused slice is each projection's output.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

# the JAX package's HF ViT tree is the generic ViT tree (no LayerScale)
from anyloc_tpu_torch.models.convert import (from_jax_params, maybe_tp_split,  # noqa: F401
                                             t2np, tensors)
from anyloc_tpu_torch.models.extractor import ViTFacetExtractor
from anyloc_tpu_torch.models.vit import ViTConfig


def hf_vit_config(dtype=None, img_size: int = 224) -> ViTConfig:
    kwargs = dict(
        img_size=img_size, patch_size=16, embed_dim=768, depth=12, num_heads=12,
        mlp_type="mlp", layerscale_init=None,
        ln_eps=1e-12,   # HF ViTConfig's layer_norm_eps
        interpolate_offset=0.0,
    )
    if dtype is not None:
        kwargs["dtype"] = dtype
    return ViTConfig(**kwargs)


def convert_hf_vit(sd: Dict, cfg: ViTConfig) -> Dict[str, torch.Tensor]:
    """A HuggingFace ``ViTModel`` state dict (optionally under ``vit.``)
    -> the port's state dict, the q/k/v Linears fused into ``attn.qkv``."""
    pre = "vit." if any(k.startswith("vit.") for k in sd) else ""
    e = f"{pre}embeddings."
    out = {
        "patch_embed.proj.weight": sd[f"{e}patch_embeddings.projection.weight"],
        "patch_embed.proj.bias": sd[f"{e}patch_embeddings.projection.bias"],
        "cls_token": sd[f"{e}cls_token"],
        "pos_embed": sd[f"{e}position_embeddings"],
        "norm.weight": sd[f"{pre}layernorm.weight"],
        "norm.bias": sd[f"{pre}layernorm.bias"],
    }
    for i in range(cfg.depth):
        h, b = f"{pre}encoder.layer.{i}", f"blocks.{i}"
        a = f"{h}.attention.attention"
        for kind in ("weight", "bias"):
            out[f"{b}.attn.qkv.{kind}"] = np.concatenate(
                [t2np(sd[f"{a}.{n}.{kind}"]) for n in ("query", "key", "value")])
        for ours, theirs in (("norm1", "layernorm_before"), ("norm2", "layernorm_after"),
                             ("attn.proj", "attention.output.dense"),
                             ("mlp.fc1", "intermediate.dense"), ("mlp.fc2", "output.dense")):
            for kind in ("weight", "bias"):
                out[f"{b}.{ours}.{kind}"] = sd[f"{h}.{theirs}.{kind}"]
    return maybe_tp_split(tensors({k: t2np(v) for k, v in out.items()}), cfg)


class CosPlaceViTExtractFeatures(ViTFacetExtractor):
    """The reference's constructor, ``(ckpt_path, layer, facet, use_cls,
    norm_descs)``; ``ckpt_path`` None means random weights from ``seed``;
    ``device`` None means the card."""

    def __init__(self, ckpt_path: Optional[str], layer: int, facet: str = "value",
                 use_cls: bool = False, norm_descs: bool = True, device=None,
                 dtype=torch.bfloat16, seed: int = 42) -> None:
        cfg = hf_vit_config(dtype=dtype)
        params = None
        if ckpt_path is not None:
            from anyloc_tpu_torch.models.convert import load_torch_checkpoint

            params = convert_hf_vit(load_torch_checkpoint(ckpt_path), cfg)
        super().__init__(cfg, params, layer, facet, use_cls=use_cls, norm_descs=norm_descs,
                         device=device, seed=seed)
