"""GeoLocalizationNet: backbone + learned aggregation (counterpart of
``anyloc_tpu/training/network.py``; dvgl_benchmark/model/network.py:29-56
and model/aggregation.py).

Backbones: resnet18/50/101 conv4 | conv5, vgg16 and alexnet (CNN maps
[B, h, w, C]), and the token backbones cct384 (CCT-14/7x2, truncatable by
``trunc_te``) and vit (HF ViT-B/16 geometry on the port's trunk, so K5
runs its attention on the card). Aggregations: netvlad, crn, rrm, gem,
mac, spoc, rmac; on token backbones netvlad, gem, cls (and seqpool on
cct), as the reference's parser allows. ``img_size`` (a keyword after the
JAX fields) sizes the vit backbone's position table: the JAX module takes
it from the first input's height.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from anyloc_tpu_torch.models.resnet import (AlexNet, ResNet, VGG16, nchw, nhwc, refuse_sync,
                                            resnet18_config, resnet50_config, resnet101_config)
from anyloc_tpu_torch.ops.common import Conv2d, l2_normalize
from anyloc_tpu_torch.ops.gem import gem_pool, gem_pool_spatial
from anyloc_tpu_torch.ops.pooling import mac_spatial, rmac_spatial, spoc_spatial
from anyloc_tpu_torch.training.aggregators import NetVLAD


class CRNModule(nn.Module):
    """Contextual reweighting mask (aggregation.py:178-241): a 3/2 average
    pool (ceil mode), context convs 3x3 (32) + 5x5 (32) + 7x7 (20), the
    frozen all-ones accumulation, 2x bilinear back: [B, h, w, C] -> [B, h,
    w, 1]."""

    def __init__(self, dim: int) -> None:
        super().__init__()
        self.filter_3_3 = Conv2d(dim, 32, 3, padding=1)
        self.filter_5_5 = Conv2d(dim, 32, 5, padding=2)
        self.filter_7_7 = Conv2d(dim, 20, 7, padding=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        down = F.avg_pool2d(F.pad(nchw(x), (0, (-(w - 3)) % 2, 0, (-(h - 3)) % 2)), 3, 2)
        g = torch.cat([self.filter_3_3(down), self.filter_5_5(down), self.filter_7_7(down)], 1)
        wacc = F.relu(F.relu(g).sum(dim=1, keepdim=True))
        mask = F.interpolate(wacc, scale_factor=2, mode="bilinear", align_corners=False)
        return nhwc(mask[:, :, :h, :w])


class CRN(nn.Module):
    """NetVLAD with a CRN-weighted soft assignment (aggregation.py:244-259)."""

    def __init__(self, num_clusters: int = 64, dim: int = 256) -> None:
        super().__init__()
        self.num_clusters = num_clusters
        self.crn = CRNModule(dim)
        self.assign = nn.Linear(dim, num_clusters)
        self.centroids = nn.Parameter(torch.empty(num_clusters, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # [B, h, w, C]
        b, h, w, d = x.shape
        x = l2_normalize(x)
        mask = self.crn(x).reshape(b, h * w, 1)
        tokens = x.reshape(b, h * w, d)
        a = torch.softmax(self.assign(tokens), dim=-1) * mask
        v = torch.einsum("bnc,bnd->bcd", a, tokens) - a.sum(1)[..., None] * self.centroids[None]
        return l2_normalize(l2_normalize(v).reshape(b, -1))


class RRM(nn.Module):
    """Residual retrieval module (aggregation.py:58-81): GAP -> LN -> MLP
    residual -> LN -> L2."""

    def __init__(self, dim: int) -> None:
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=1e-6)   # Flax's default eps
        self.fc1 = nn.Linear(dim, dim)
        self.fc2 = nn.Linear(dim, dim)
        self.ln2 = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # [B, h, w, C] -> [B, C]
        x = self.ln1(x.mean(dim=(1, 2)))
        out = self.fc2(F.relu(self.fc1(x))) + x
        return l2_normalize(self.ln2(out))


_RESNETS = {
    "resnet18conv4": (resnet18_config, "conv4"),
    "resnet18conv5": (resnet18_config, "conv5"),
    "resnet50conv4": (resnet50_config, "conv4"),
    "resnet50conv5": (resnet50_config, "conv5"),
    "resnet101conv4": (resnet101_config, "conv4"),
    "resnet101conv5": (resnet101_config, "conv5"),
}
_POOLS = {"gem": None, "mac": mac_spatial, "spoc": spoc_spatial, "rmac": rmac_spatial}


class GeoLocalizationNet(nn.Module):
    """backbone + aggregation -> an L2-normalized global descriptor [B, D]
    from images [B, H, W, 3]."""

    def __init__(self, backbone: str = "resnet18conv4", aggregation: str = "netvlad",
                 netvlad_clusters: int = 64, fc_output_dim: Optional[int] = None,
                 gem_p: float = 3.0, sync_axis: Optional[str] = None,
                 trunc_te: Optional[int] = None, remat: bool = False, *,
                 img_size: int = 224) -> None:
        super().__init__()
        refuse_sync(sync_axis)
        self.arch, self.agg, self.gem_p = backbone, aggregation, gem_p
        self.tokens = backbone.startswith(("cct", "vit"))
        if self.tokens:
            allowed = (("netvlad", "gem", "cls", "seqpool") if backbone.startswith("cct")
                       else ("netvlad", "gem", "cls"))
            if aggregation not in allowed:
                raise ValueError(f"{backbone} can't work with aggregation {aggregation}; use "
                                 f"one among {list(allowed)}")
            if backbone.startswith("cct"):
                if remat:
                    # CCT's blocks are inline, as in the JAX package: no hook
                    raise ValueError("remat is supported for the 'vit' token backbone only")
                from anyloc_tpu_torch.models.cct import CCT, cct_14_7x2_384

                self.backbone = CCT(cct_14_7x2_384(truncate_at=trunc_te),
                                    seq_pool=aggregation not in ("netvlad", "gem"))
                channels = 384
            else:
                from anyloc_tpu_torch.models.cosplace_vit import hf_vit_config
                from anyloc_tpu_torch.models.vit import ViT

                cfg = hf_vit_config(img_size=img_size)
                if trunc_te is not None:
                    cfg = dataclasses.replace(cfg, depth=trunc_te)
                cfg = dataclasses.replace(cfg, remat=remat)
                self.backbone, channels = ViT(cfg), cfg.embed_dim
            out = channels
            if aggregation == "netvlad":
                self.aggregation = NetVLAD(netvlad_clusters, channels)
                out = netvlad_clusters * channels
        else:
            if backbone in _RESNETS:
                fac, trunc = _RESNETS[backbone]
                self.backbone = ResNet(fac(truncate=trunc))
            elif backbone == "vgg16":
                self.backbone = VGG16()
            elif backbone == "alexnet":
                self.backbone = AlexNet()
            else:
                raise ValueError(f"Unknown backbone {backbone}")
            channels = out = self.backbone.out_channels
            if aggregation in ("netvlad", "crn"):
                self.aggregation = (NetVLAD if aggregation == "netvlad" else CRN)(
                    netvlad_clusters, channels)
                out = netvlad_clusters * channels
            elif aggregation == "rrm":
                self.aggregation = RRM(channels)
            elif aggregation not in _POOLS:
                raise ValueError(f"Unknown aggregation {aggregation}")
        if fc_output_dim is not None:
            self.fc = nn.Linear(out, fc_output_dim)

    def _token_route(self, imgs: torch.Tensor) -> torch.Tensor:
        wants_tokens = self.agg in ("netvlad", "gem")
        if self.arch.startswith("cct"):
            out = self.backbone(imgs, return_tokens=wants_tokens)
            tokens, pooled = (out, None) if wants_tokens else (None, out)
        else:
            out = self.backbone(imgs)
            tokens, pooled = (out["tokens"], None) if wants_tokens else (None, out["cls"])
        if pooled is not None:   # VitWrapper's CLS / CCT's seq-pool: L2 only
            return l2_normalize(pooled.float())
        if self.agg == "netvlad":
            return self.aggregation(l2_normalize(tokens.float()))
        return l2_normalize(gem_pool(tokens.float(), p=self.gem_p))

    def forward(self, imgs: torch.Tensor, train: bool = False) -> torch.Tensor:
        """``train=True``: a CNN trunk's BatchNorm on batch statistics (the
        token backbones have none)."""
        if self.tokens:
            out = self._token_route(imgs)
        else:
            fmap = self.backbone(imgs, train=train)            # [B, h, w, C]
            if self.agg == "netvlad":
                b, h, w, d = fmap.shape
                out = self.aggregation(l2_normalize(fmap).reshape(b, h * w, d))
            elif self.agg in ("crn", "rrm"):
                out = self.aggregation(fmap)
            elif self.agg == "gem":
                out = l2_normalize(gem_pool_spatial(fmap, p=self.gem_p))
            else:
                out = l2_normalize(_POOLS[self.agg](fmap))
        if hasattr(self, "fc"):
            out = l2_normalize(self.fc(out))
        return out


_TE_BLOCK = re.compile(r"(?:^|\.)(?:blocks|norm1|norm2|qkv|proj|fc1|fc2)\.(\d+)(?:\.|$)")


def make_freeze_te_mask(freeze_te: int):
    """dvgl's ``--freeze_te`` (network.py:150-160, 169-180) as a mask over
    the port's parameter names: ``mask(params) -> {name: trainable}``.
    Every backbone parameter freezes except those of transformer-encoder
    blocks with an index above ``freeze_te`` (embeddings, tokenizer and the
    final norm stay frozen; -1 unfreezes every block); heads and the
    aggregation stay trainable. The JAX regex over Flax paths
    (``blocks_i``, CCT's flat ``qkv_i`` ...), read through the converter's
    name map (``blocks.i``, ``qkv.i``)."""

    def mask(params) -> Dict[str, bool]:
        out = {}
        for name in params:
            parts = name.split(".")
            if "backbone" not in parts:
                out[name] = True
                continue
            m = _TE_BLOCK.search(".".join(parts[parts.index("backbone") + 1:]))
            out[name] = m is not None and int(m.group(1)) > freeze_te
        return out

    return mask
