"""EfficientNet (b0-b7) backbone (counterpart of
``anyloc_tpu/models/efficientnet.py``; MixVPR's timm backbone,
``MixVPR/models/backbones/efficientnet.py:24``, the TF-EfficientNet that
``transformers`` redistributes as google/efficientnet-b*).

The same semantics as the JAX module: channel rounding with the 10 %
round-down guard, ``ceil`` block repeats, TF 'same' padding of the strided
convs as explicit asymmetric zero pads (stem (0, 1) per side, a stride-2
depthwise conv (k//2 - 1, k//2)), MBConv with squeeze-excite sized from
the pre-expansion width, residuals inside a stage only, a 1x1 head conv.
Images [B, H, W, 3] in, the feature map [B, h, w, C] out; NCHW inside,
every conv through ``ops.common.Conv2d`` (F17), BatchNorm on its stored
statistics, or with ``train=True`` on the batch's (Flax's momentum 0.99).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from anyloc_tpu_torch.models.convert import t2np, tensors
from anyloc_tpu_torch.models.resnet import BatchNorm, nchw, nhwc, refuse_sync
from anyloc_tpu_torch.ops.common import Conv2d


@dataclasses.dataclass(frozen=True)
class EfficientNetConfig:
    width_coefficient: float = 1.0
    depth_coefficient: float = 1.0
    depth_divisor: int = 8
    # per-stage base geometry (b0; scaled by the coefficients)
    in_channels: Tuple[int, ...] = (32, 16, 24, 40, 80, 112, 192)
    out_channels: Tuple[int, ...] = (16, 24, 40, 80, 112, 192, 320)
    kernel_sizes: Tuple[int, ...] = (3, 3, 5, 3, 5, 5, 3)
    strides: Tuple[int, ...] = (1, 2, 2, 2, 1, 2, 1)
    expand_ratios: Tuple[int, ...] = (1, 6, 6, 6, 6, 6, 6)
    num_block_repeats: Tuple[int, ...] = (1, 2, 2, 3, 3, 4, 1)
    se_ratio: float = 0.25
    bn_eps: float = 1e-3
    dtype: Any = torch.float32
    sync_axis: Optional[str] = None

    def round_filters(self, n: int) -> int:
        d = self.depth_divisor
        n *= self.width_coefficient
        new = max(d, int(n + d / 2) // d * d)
        if new < 0.9 * n:
            new += d
        return int(new)

    def round_repeats(self, n: int) -> int:
        return int(math.ceil(self.depth_coefficient * n))

    @property
    def hidden_dim(self) -> int:
        return self.round_filters(1280)

    def block_plan(self):
        """Flattened per-block (in, out, stride, kernel, expand, id_skip)."""
        plan = []
        for i in range(len(self.in_channels)):
            in_dim = self.round_filters(self.in_channels[i])
            out_dim = self.round_filters(self.out_channels[i])
            for j in range(self.round_repeats(self.num_block_repeats[i])):
                plan.append((out_dim if j > 0 else in_dim, out_dim,
                             1 if j > 0 else self.strides[i], self.kernel_sizes[i],
                             self.expand_ratios[i], j == 0))
        return plan


# (width, depth) per variant: the standard compound-scaling table
_COEFFS = {
    "b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2), "b3": (1.2, 1.4),
    "b4": (1.4, 1.8), "b5": (1.6, 2.2), "b6": (1.8, 2.6), "b7": (2.0, 3.1),
}


def efficientnet_config(variant: str = "b0", **kw) -> EfficientNetConfig:
    w, d = _COEFFS[variant]
    return EfficientNetConfig(width_coefficient=w, depth_coefficient=d, **kw)


class _BN(nn.Module):
    """BatchNorm with the config's eps under ``bn``, Flax momentum 0.99."""

    def __init__(self, cfg: EfficientNetConfig, features: int) -> None:
        super().__init__()
        refuse_sync(cfg.sync_axis)
        self.bn = BatchNorm(features, cfg.bn_eps, cfg.dtype, momentum=0.99)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.bn(x, train)


def _swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class MBConvBlock(nn.Module):
    """[1x1 expand + BN + swish] -> depthwise conv + BN + swish ->
    squeeze-excite -> 1x1 project + BN [+ residual], NCHW."""

    def __init__(self, cfg: EfficientNetConfig, in_dim: int, out_dim: int, stride: int,
                 kernel: int, expand_ratio: int, id_skip: bool) -> None:
        super().__init__()
        c, t = cfg, cfg.dtype
        self.stride, self.kernel, self.id_skip = stride, kernel, id_skip
        self.expand = expand_ratio != 1
        mid = in_dim * expand_ratio
        if self.expand:
            self.expand_conv = Conv2d(in_dim, mid, 1, bias=False, dtype=t)
            self.expand_bn = _BN(c, mid)
        # stride 1 is 'SAME' (odd kernels: k // 2 each side); stride 2 pads
        # explicitly in forward
        self.dw_conv = Conv2d(mid, mid, kernel, stride, 0 if stride == 2 else kernel // 2,
                              groups=mid, bias=False, dtype=t)
        self.dw_bn = _BN(c, mid)
        dim_se = max(1, int(in_dim * c.se_ratio))
        self.se_reduce = Conv2d(mid, dim_se, 1, dtype=t)
        self.se_expand = Conv2d(dim_se, mid, 1, dtype=t)
        self.project_conv = Conv2d(mid, out_dim, 1, bias=False, dtype=t)
        self.project_bn = _BN(c, out_dim)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        inputs = x
        if self.expand:
            x = _swish(self.expand_bn(self.expand_conv(x), train))
        if self.stride == 2:
            lo, hi = self.kernel // 2 - 1, self.kernel // 2
            x = F.pad(x, (lo, hi, lo, hi))
        x = _swish(self.dw_bn(self.dw_conv(x), train))
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.se_expand(_swish(self.se_reduce(s)))
        x = self.project_bn(self.project_conv(x * torch.sigmoid(s)), train)
        if self.stride == 1 and not self.id_skip:
            x = x + inputs   # no drop-connect, as in the JAX package
        return x


class EfficientNet(nn.Module):
    """Stem + MBConv stages + head conv: [B, H, W, 3] -> [B, h, w, C]."""

    def __init__(self, cfg: EfficientNetConfig) -> None:
        super().__init__()
        refuse_sync(cfg.sync_axis)
        c = self.cfg = cfg
        self.stem_conv = Conv2d(3, c.round_filters(32), 3, 2, 0, bias=False, dtype=c.dtype)
        self.stem_bn = _BN(c, c.round_filters(32))
        plan = c.block_plan()
        self.block = nn.ModuleList([MBConvBlock(c, *p) for p in plan])
        self.top_conv = Conv2d(plan[-1][1], c.hidden_dim, 1, bias=False, dtype=c.dtype)
        self.top_bn = _BN(c, c.hidden_dim)

    @property
    def out_channels(self) -> int:
        return self.cfg.hidden_dim

    def fmap_hw(self, h: int, w: int) -> Tuple[int, int]:
        def side(n):
            n = (n + 1 - 3) // 2 + 1
            for p in self.cfg.block_plan():
                if p[2] == 2:   # pads (k//2 - 1, k//2), then a k-wide stride-2 window
                    n = (n - 2) // 2 + 1
            return n

        return side(h), side(w)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        c = self.cfg
        # stem: TF 'same' for a 3x3 stride-2 conv == pad (0, 1) per side
        x = F.pad(nchw(x.to(c.dtype)), (0, 1, 0, 1))
        x = _swish(self.stem_bn(self.stem_conv(x), train))
        for blk in self.block:
            x = blk(x, train)
        return nhwc(_swish(self.top_bn(self.top_conv(x), train)))


def convert_hf_efficientnet(sd: Dict, cfg: EfficientNetConfig) -> Dict[str, torch.Tensor]:
    """transformers EfficientNetModel state dict (optionally under
    ``efficientnet.``) -> ``EfficientNet(cfg)``'s."""
    if any(k.startswith("efficientnet.") for k in sd):
        sd = {k[len("efficientnet."):]: v for k, v in sd.items() if k.startswith("efficientnet.")}
    out: Dict = {}

    def bn(src, dst):
        for kind in ("weight", "bias", "running_mean", "running_var"):
            out[f"{dst}.bn.{kind}"] = t2np(sd[f"{src}.{kind}"])

    def conv(src, dst, bias=False):
        out[f"{dst}.weight"] = t2np(sd[f"{src}.weight"])
        if bias:
            out[f"{dst}.bias"] = t2np(sd[f"{src}.bias"])

    conv("embeddings.convolution", "stem_conv")
    bn("embeddings.batchnorm", "stem_bn")
    for i, (_, _, _, _, e, _) in enumerate(cfg.block_plan()):
        f, t = f"block.{i}", f"encoder.blocks.{i}"
        if e != 1:
            conv(f"{t}.expansion.expand_conv", f"{f}.expand_conv")
            bn(f"{t}.expansion.expand_bn", f"{f}.expand_bn")
        conv(f"{t}.depthwise_conv.depthwise_conv", f"{f}.dw_conv")   # [C, 1, k, k] both
        bn(f"{t}.depthwise_conv.depthwise_norm", f"{f}.dw_bn")
        conv(f"{t}.squeeze_excite.reduce", f"{f}.se_reduce", bias=True)
        conv(f"{t}.squeeze_excite.expand", f"{f}.se_expand", bias=True)
        conv(f"{t}.projection.project_conv", f"{f}.project_conv")
        bn(f"{t}.projection.project_bn", f"{f}.project_bn")
    conv("encoder.top_conv", "top_conv")
    bn("encoder.top_bn", "top_bn")
    return tensors(out)
