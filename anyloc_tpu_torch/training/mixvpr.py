"""The MixVPR sub-framework: backbone / aggregator registry and VPRModel
(counterpart of ``anyloc_tpu/training/mixvpr.py``; MixVPR/mixer_top_k_vpr.py
:29-118 and MixVPR/models/helper.py:6-75), and the converters of the
MixVPR and CosPlace release checkpoints.

Backbones are the port's ResNet, EfficientNet and SwinV2 (and VGG-16 for
CosPlace); the heads are ``training/aggregators.py``'s. MixVPR's head is
sized for its token count, so ``get_aggregator("mixvpr", cfg)`` reads the
map's ``in_channels``, ``in_h`` and ``in_w`` from ``cfg`` (the reference's
own config keys) and ``VPRModel`` fills them for its ``input_hw``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from anyloc_tpu_torch.models.convert import t2np, tensors
from anyloc_tpu_torch.models.efficientnet import EfficientNet, efficientnet_config
from anyloc_tpu_torch.models.resnet import (ResNet, VGG16, convert_torchvision_resnet,
                                            resnet18_config,
                                            resnet50_config, resnet101_config)
from anyloc_tpu_torch.models.swin import SwinV2, swinv2_base_config
from anyloc_tpu_torch.training.aggregators import ConvAP, GeMHead, GeMPool, MixVPRHead

_RESNET_CONFIGS = {
    "resnet18": resnet18_config,
    "resnet50": resnet50_config,
    "resnet101": resnet101_config,
}


def get_backbone(backbone_arch: str = "resnet50", layers_to_crop: Tuple[int, ...] = (),
                 sync_axis: Optional[str] = None, img_size: int = 256
                 ) -> Tuple[nn.Module, int]:
    """Backbone by name -> (module, out_channels): resnet* (``layers_to_crop``
    4 drops layer4, 3 drops layer3 too), efficientnet_b* (unknown variants
    fall back to b0), swin*, vgg16 (CosPlace's)."""
    arch = backbone_arch.lower()
    if "resnet" in arch:
        maker = _RESNET_CONFIGS.get(arch)
        if maker is None:
            raise ValueError(f"unsupported resnet variant: {backbone_arch!r}")
        if 3 in layers_to_crop and 4 not in layers_to_crop:
            raise ValueError("cropping layer3 requires cropping layer4 too")
        truncate = "conv3" if 3 in layers_to_crop else "conv4" if 4 in layers_to_crop else "conv5"
        mod = ResNet(maker(truncate=truncate, sync_axis=sync_axis))
        return mod, mod.out_channels
    if "efficient" in arch:
        variant = arch.split("_b")[-1] if "_b" in arch else None
        variant = f"b{variant}" if variant in tuple("01234567") else "b0"
        cfg = efficientnet_config(variant, sync_axis=sync_axis)
        return EfficientNet(cfg), cfg.hidden_dim
    if "swin" in arch:
        cfg = swinv2_base_config(img_size=img_size)
        return SwinV2(cfg), cfg.out_channels
    if "vgg" in arch:
        return VGG16(), 512
    raise ValueError(f"unknown backbone arch: {backbone_arch!r}")


def get_aggregator(agg_arch: str = "ConvAP",
                   agg_config: Optional[Dict[str, Any]] = None) -> nn.Module:
    """Aggregator by name, with the reference's required-key checks."""
    cfg = dict(agg_config or {})
    arch = agg_arch.lower()
    if "cosplace" in arch:
        for key in ("in_dim", "out_dim"):
            if key not in cfg:
                raise ValueError(f"cosplace aggregator requires {key!r}")
        return GeMHead(out_dim=cfg["out_dim"], in_dim=cfg["in_dim"])
    if "gem" in arch:
        return GeMPool(p_init=float(cfg.get("p", 3.0)))
    if "convap" in arch:
        if "in_channels" not in cfg:
            raise ValueError("convap aggregator requires 'in_channels'")
        return ConvAP(out_channels=cfg.get("out_channels", 512), s1=cfg.get("s1", 2),
                      s2=cfg.get("s2", 2), in_channels=cfg["in_channels"])
    if "mixvpr" in arch:
        for key in ("in_channels", "in_h", "in_w"):
            if key not in cfg:
                raise ValueError(f"mixvpr aggregator requires {key!r} (the map it mixes)")
        return MixVPRHead(out_channels=cfg.get("out_channels", 256),
                          out_rows=cfg.get("out_rows", 4), depth=cfg.get("mix_depth", 4),
                          mix_ratio=cfg.get("mlp_ratio", 1), in_channels=cfg["in_channels"],
                          n_tokens=cfg["in_h"] * cfg["in_w"])
    raise ValueError(f"unknown aggregator arch: {agg_arch!r}")


def _aggregator_sd(sd, depth: int) -> Dict:
    out: Dict = {}
    for i in range(depth):
        t = f"aggregator.mix.{i}.mix"
        for ours, theirs in (("norm", "0"), ("mix1", "1"), ("mix2", "3")):
            for kind in ("weight", "bias"):
                out[f"aggregator.mixer.{i}.{ours}.{kind}"] = t2np(sd[f"{t}.{theirs}.{kind}"])
    for name in ("channel_proj", "row_proj"):
        for kind in ("weight", "bias"):
            out[f"aggregator.{name}.{kind}"] = t2np(sd[f"aggregator.{name}.{kind}"])
    return out


def convert_mixvpr_checkpoint(sd) -> Dict[str, torch.Tensor]:
    """A MixVPR release (resnet50_MixVPR_4096 etc., the lightning module's
    state dict: ``backbone.model.*`` in torchvision naming cropped at
    layer4, ``aggregator.mix.{i}.mix.{0,1,3}``, ``channel_proj``,
    ``row_proj``) -> ``VPRModel``'s state dict."""
    bb_sd = {k[len("backbone.model."):]: v for k, v in sd.items()
             if k.startswith("backbone.model.")}
    bb = convert_torchvision_resnet(bb_sd, resnet50_config(truncate="conv4"))
    depth = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("aggregator.mix."))
    out = {f"backbone.{k}": v for k, v in bb.items()}
    out.update(tensors(_aggregator_sd(sd, depth)))
    return out


# CosPlace wraps list(resnet.children())[:-2] in an nn.Sequential, which
# renumbers the torchvision module names (CosPlace/model/network.py:57-77)
_COSPLACE_RESNET_IDX = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2", "6": "layer3",
                        "7": "layer4"}
# torchvision vgg16 conv layers inside features[:-2], renumbered 1:1
_VGG16_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def convert_cosplace_checkpoint(sd, backbone: str = "resnet50") -> Dict[str, torch.Tensor]:
    """A CosPlace release (``backbone.{i}.*``, a Sequential renumbering of
    the torchvision children at full conv5, ``aggregation.1.p`` (GeM) and
    ``aggregation.3`` (fc)) -> ``VPRModel(agg_arch="cosplace")``'s."""
    arch = backbone.lower()
    out: Dict = {}
    if "resnet" in arch:
        bb_sd = {}
        for k, v in sd.items():
            if k.startswith("backbone."):
                idx, rest = k[len("backbone."):].split(".", 1)
                bb_sd[f"{_COSPLACE_RESNET_IDX[idx]}.{rest}"] = v
        bb = convert_torchvision_resnet(bb_sd, _RESNET_CONFIGS[arch](truncate="conv5"))
        out.update({f"backbone.{k}": v for k, v in bb.items()})
    elif arch == "vgg16":
        for i, idx in enumerate(_VGG16_CONV_IDX):
            for kind in ("weight", "bias"):
                out[f"backbone.conv.{i}.{kind}"] = t2np(sd[f"backbone.{idx}.{kind}"])
    else:
        raise ValueError(f"unsupported CosPlace backbone: {backbone!r}")
    out["aggregator.p"] = np.asarray(t2np(sd["aggregation.1.p"]).reshape(()))
    out["aggregator.fc.weight"] = t2np(sd["aggregation.3.weight"])
    out["aggregator.fc.bias"] = t2np(sd["aggregation.3.bias"])
    return tensors(out)


class VPRModel(nn.Module):
    """Backbone + aggregation (the reference's VPRModel); the default is
    MixVPR's SOTA config, ResNet-50 conv4 into the feature mixer. ConvAP
    gets the map [B, h, w, C], the other heads [B, h*w, C]. ``input_hw``
    (a keyword after the JAX fields; default ``img_size`` square) is the
    input the MixVPR head is sized for."""

    def __init__(self, backbone: str = "resnet50", agg_arch: str = "mixvpr",
                 agg_config: Optional[Dict[str, Any]] = None,
                 layers_to_crop: Tuple[int, ...] = (4,), out_channels: int = 1024,
                 out_rows: int = 4, mixer_depth: int = 4, sync_axis: Optional[str] = None,
                 img_size: int = 256, *, input_hw: Optional[Tuple[int, int]] = None) -> None:
        super().__init__()
        self.backbone, d = get_backbone(backbone, layers_to_crop, sync_axis, img_size)
        self.swin = isinstance(self.backbone, SwinV2)
        h, w = self.backbone.fmap_hw(*(input_hw or (img_size, img_size)))
        cfg = agg_config
        if cfg is None and agg_arch.lower() == "mixvpr":
            cfg = {"out_channels": out_channels, "out_rows": out_rows, "mix_depth": mixer_depth}
        elif cfg is None:
            cfg = {"in_channels": d, "in_dim": d, "out_dim": 512}
        if "mixvpr" in agg_arch.lower():
            cfg = {"in_channels": d, "in_h": h, "in_w": w, **cfg}
        self.aggregator = get_aggregator(agg_arch, cfg)

    def forward(self, imgs: torch.Tensor, train: bool = False) -> torch.Tensor:
        # train=True: the CNN trunks' BatchNorm on batch statistics (SwinV2 has none)
        fmap = self.backbone(imgs)["fmap"] if self.swin else self.backbone(imgs, train=train)
        if isinstance(self.aggregator, ConvAP):
            return self.aggregator(fmap)
        b, h, w, d = fmap.shape
        return self.aggregator(fmap.reshape(b, h * w, d))
