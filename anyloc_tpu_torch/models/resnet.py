"""ResNet / VGG / AlexNet backbones of the trained baselines (counterpart of
``anyloc_tpu/models/resnet.py``; dvgl_benchmark's torchvision backbones,
``model/network.py:106-186``: resnet18/50/101 truncated at conv3, conv4 or
conv5, vgg16 at its last conv, alexnet at ``features[:-2]``).

The API keeps the JAX layout: images [B, H, W, 3] in, a feature map [B,
h, w, C] out. Inside, the blocks run NCHW on channels-last memory (the
layout cuDNN prefers), and every convolution goes through
``ops.common.Conv2d``: full float32 for float32 inputs (F17, F17b).
BatchNorm runs over its stored statistics, or with ``train=True`` over
the batch's, updating the stored ones as Flax does; with ``sync_axis``
(cross-device BatchNorm) the batch is the one spread over that axis of the
mesh bound around the call (``parallel.mesh.use_mesh``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from anyloc_tpu_torch.models.convert import t2np, tensors
from anyloc_tpu_torch.ops.common import Conv2d

@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (2, 2, 2, 2)
    bottleneck: bool = False
    width: int = 64
    # "conv4" drops the last stage (dvgl layers_to_crop=[4]); "conv3" also
    # drops layer3 (MixVPR backbones/resnet.py:77-80 layers_to_crop=[3,4])
    truncate: str = "conv5"
    dtype: Any = torch.float32
    sync_axis: Optional[str] = None


def resnet18_config(**kw) -> ResNetConfig:
    return ResNetConfig(stage_sizes=(2, 2, 2, 2), bottleneck=False, **kw)


def resnet50_config(**kw) -> ResNetConfig:
    return ResNetConfig(stage_sizes=(3, 4, 6, 3), bottleneck=True, **kw)


def resnet101_config(**kw) -> ResNetConfig:
    return ResNetConfig(stage_sizes=(3, 4, 23, 3), bottleneck=True, **kw)


_TRUNCATE_STAGES = {"conv3": 2, "conv4": 3, "conv5": 4}


def _n_stages(truncate: str) -> int:
    return _TRUNCATE_STAGES[truncate]


def nchw(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, C, H, W] on the same (channels-last) memory."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def pool_out(n: int, k: int, s: int, p: int) -> int:
    """Output length of a conv / pool window (floor)."""
    return (n + 2 * p - k) // s + 1


class BatchNorm(nn.Module):
    """Flax's ``BatchNorm`` over NCHW: weight, bias, running_mean,
    running_var. ``train=False`` normalizes with the stored statistics;
    ``train=True`` with the batch's mean and biased variance, and moves the
    stored ones to ``momentum * running + (1 - momentum) * batch``, the
    variance biased too (Flax's convention; ``nn.BatchNorm2d`` stores the
    unbiased variance, with its momentum the other way round).

    ``sync_axis`` (Flax's ``axis_name``): with ``train=True`` the batch is
    every rank's along that axis of the mesh bound around the call
    (``with parallel.mesh.use_mesh(mesh):``): [sum, sum of squares, count]
    in float32 (float64 for a float64 input, as Flax computes its
    statistics), reduced in one collective whose backward sums the
    cotangents over the axis (``sync_reduce``), and the stored statistics
    take the whole batch's values on every rank. It raises with no mesh
    bound or without that axis; an axis of one rank is the local
    computation."""

    def __init__(self, features: int, eps: float = 1e-5, dtype=torch.float32,
                 momentum: float = 0.9, sync_axis: Optional[str] = None) -> None:
        super().__init__()
        self.eps, self.momentum, self.sync_axis = eps, momentum, sync_axis
        self.weight = nn.Parameter(torch.ones(features, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(features, dtype=dtype))
        self.register_buffer("running_mean", torch.zeros(features, dtype=dtype))
        self.register_buffer("running_var", torch.ones(features, dtype=dtype))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))   # as Flax: float64 stays
        mesh = self._mesh()
        if mesh is None:
            mean = xf.mean(dim=(0, 2, 3))
            var = (xf * xf).mean(dim=(0, 2, 3)) - mean * mean   # Flax's fast variance
        else:
            from anyloc_tpu_torch.parallel.mesh import sync_reduce

            c = xf.shape[1]
            count = torch.full((1,), xf.numel() // c, dtype=xf.dtype, device=xf.device)
            sums = sync_reduce(torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)),
                                          count]), mesh, self.sync_axis)
            mean = sums[:c] / sums[-1]
            var = sums[c:2 * c] / sums[-1] - mean * mean
        var = torch.clamp_min(var, 0.0)
        with torch.no_grad():
            for buf, batch in ((self.running_mean, mean), (self.running_var, var)):
                buf.mul_(self.momentum).add_(batch.detach().to(buf.dtype), alpha=1 - self.momentum)
        shape = (1, -1, 1, 1)
        y = (xf - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
        weight, bias = (t.to(xf.dtype).view(shape) for t in (self.weight, self.bias))
        return (y * weight + bias).to(x.dtype)

    def _mesh(self):
        """The mesh to reduce the statistics over: None for local statistics
        (no ``sync_axis``, or an axis of one rank)."""
        if self.sync_axis is None:
            return None
        from anyloc_tpu_torch.parallel.mesh import axis_size, bound_mesh

        mesh = bound_mesh()
        if mesh is None:
            raise RuntimeError(
                f"BatchNorm(sync_axis={self.sync_axis!r}) in training needs a mesh: call it "
                "inside parallel.mesh.use_mesh(mesh) (as Flax needs its axis name bound by "
                "shard_map)")
        if self.sync_axis not in mesh.mesh_dim_names:
            raise ValueError(f"sync_axis {self.sync_axis!r} is not an axis of the mesh "
                             f"{mesh.mesh_dim_names}")
        return None if axis_size(mesh, self.sync_axis) == 1 else mesh


class _BN(nn.Module):
    """The JAX ``_BN`` wrapper: its BatchNorm under ``bn`` (the Flax tree's
    ``<name>/bn``), eps 1e-5."""

    def __init__(self, features: int, dtype=torch.float32,
                 sync_axis: Optional[str] = None) -> None:
        super().__init__()
        self.bn = BatchNorm(features, 1e-5, dtype, sync_axis=sync_axis)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.bn(x, train)


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0, bias: bool = False,
          dtype=torch.float32) -> Conv2d:
    return Conv2d(cin, cout, k, stride, padding, bias=bias, dtype=dtype)


class _Block(nn.Module):
    """A residual block, NCHW: conv + BN stages (``kernels[j]`` wide, the
    first 3x3 strided), relu between them, a 1x1 + BN downsample where
    the shape changes, relu after the sum. ``in_channels`` is the block's
    input width (Flax infers it)."""

    def __init__(self, cfg: ResNetConfig, filters: int, strides: int, in_channels: int,
                 kernels: Tuple[int, ...], expansion: int) -> None:
        super().__init__()
        t, sync = cfg.dtype, cfg.sync_axis
        widths = [in_channels] + [filters] * (len(kernels) - 1) + [filters * expansion]
        strided = kernels.index(3) + 1
        for j, k in enumerate(kernels, start=1):
            stride = strides if j == strided else 1
            setattr(self, f"conv{j}", _conv(widths[j - 1], widths[j], k, stride, k // 2, dtype=t))
            setattr(self, f"bn{j}", _BN(widths[j], t, sync))
        self.n = len(kernels)
        if strides != 1 or in_channels != widths[-1]:
            self.downsample_conv = _conv(in_channels, widths[-1], 1, strides, dtype=t)
            self.downsample_bn = _BN(widths[-1], t, sync)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = x
        for j in range(1, self.n + 1):
            y = getattr(self, f"bn{j}")(getattr(self, f"conv{j}")(y), train)
            if j < self.n:
                y = F.relu(y)
        if hasattr(self, "downsample_conv"):
            x = self.downsample_bn(self.downsample_conv(x), train)
        return F.relu(y + x)


class BasicBlock(_Block):
    """conv3x3 -> BN -> relu -> conv3x3 -> BN (+ 1x1 downsample) -> relu."""

    expansion = 1

    def __init__(self, cfg: ResNetConfig, filters: int, strides: int = 1, *,
                 in_channels: int = 64) -> None:
        super().__init__(cfg, filters, strides, in_channels, (3, 3), self.expansion)


class BottleneckBlock(_Block):
    """1x1 -> 3x3 (strided) -> 1x1 (x4 wide), each with BN."""

    expansion = 4

    def __init__(self, cfg: ResNetConfig, filters: int, strides: int = 1, *,
                 in_channels: int = 64) -> None:
        super().__init__(cfg, filters, strides, in_channels, (1, 3, 1), self.expansion)


class ResNet(nn.Module):
    """Truncated ResNet feature extractor: [B, H, W, 3] -> [B, h, w, C]."""

    def __init__(self, cfg: ResNetConfig) -> None:
        super().__init__()
        c = self.cfg = cfg
        self.conv1 = _conv(3, c.width, 7, 2, 3, dtype=c.dtype)
        self.bn1 = _BN(c.width, c.dtype, c.sync_axis)
        block = BottleneckBlock if c.bottleneck else BasicBlock
        cin = c.width
        for stage in range(_n_stages(c.truncate)):
            filters = c.width * 2 ** stage
            blocks = []
            for i in range(c.stage_sizes[stage]):
                blocks.append(block(c, filters, 2 if (stage > 0 and i == 0) else 1,
                                    in_channels=cin))
                cin = filters * block.expansion
            setattr(self, f"layer{stage + 1}", nn.ModuleList(blocks))

    @property
    def out_channels(self) -> int:
        mult = 4 if self.cfg.bottleneck else 1
        return self.cfg.width * 2 ** (_n_stages(self.cfg.truncate) - 1) * mult

    def fmap_hw(self, h: int, w: int) -> Tuple[int, int]:
        """The feature map's [h, w] for an [H, W] input."""
        def side(n):
            n = pool_out(pool_out(n, 7, 2, 3), 3, 2, 1)
            for _ in range(_n_stages(self.cfg.truncate) - 1):
                n = pool_out(n, 3, 2, 1)
            return n

        return side(h), side(w)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        c = self.cfg
        x = nchw(x.to(c.dtype))
        x = F.relu(self.bn1(self.conv1(x), train))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage in range(_n_stages(c.truncate)):
            for blk in getattr(self, f"layer{stage + 1}"):
                x = blk(x, train)
        return nhwc(x)


_VGG16_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512)


class VGG16(nn.Module):
    """VGG-16 features truncated at the last conv (dvgl network.py:121-129)."""

    out_channels = 512

    def __init__(self, dtype: Any = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        convs, cin = [], 3
        for v in _VGG16_PLAN:
            if v != "M":
                convs.append(_conv(cin, v, 3, 1, 1, bias=True, dtype=dtype))
                cin = v
        self.conv = nn.ModuleList(convs)

    def fmap_hw(self, h: int, w: int) -> Tuple[int, int]:
        return h // 16, w // 16

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        del train   # no BatchNorm
        x = nchw(x.to(self.dtype))
        convs = iter(self.conv)
        for v in _VGG16_PLAN:
            x = F.max_pool2d(x, 2, 2) if v == "M" else F.relu(next(convs)(x))
        return nhwc(x)


class AlexNet(nn.Module):
    """AlexNet ``features[:-2]`` (dvgl_benchmark/model/network.py:139-145):
    torchvision's feature stack before its final ReLU + MaxPool, ending at
    the last 256-channel conv."""

    out_channels = 256

    def __init__(self, dtype: Any = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        spec = ((3, 64, 11, 4, 2), (64, 192, 5, 1, 2), (192, 384, 3, 1, 1), (384, 256, 3, 1, 1),
                (256, 256, 3, 1, 1))
        self.conv = nn.ModuleList([_conv(i, o, k, s, p, bias=True, dtype=dtype)
                                   for i, o, k, s, p in spec])

    def fmap_hw(self, h: int, w: int) -> Tuple[int, int]:
        def side(n):
            return pool_out(pool_out(pool_out(n, 11, 4, 2), 3, 2, 0), 3, 2, 0)

        return side(h), side(w)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        del train   # no BatchNorm
        x = nchw(x.to(self.dtype))
        x = F.max_pool2d(F.relu(self.conv[0](x)), 3, 2)
        x = F.max_pool2d(F.relu(self.conv[1](x)), 3, 2)
        x = F.relu(self.conv[2](x))
        x = F.relu(self.conv[3](x))
        return nhwc(self.conv[4](x))


def convert_torchvision_alexnet(sd: Dict) -> Dict[str, torch.Tensor]:
    """torchvision alexnet state dict -> ``AlexNet``'s (the five feature
    convs at indices 0, 3, 6, 8, 10)."""
    out = {}
    for i, idx in enumerate((0, 3, 6, 8, 10)):
        for kind in ("weight", "bias"):
            out[f"conv.{i}.{kind}"] = t2np(sd[f"features.{idx}.{kind}"])
    return tensors(out)


def convert_torchvision_resnet(sd: Dict, cfg: ResNetConfig) -> Dict[str, torch.Tensor]:
    """torchvision resnet state dict -> ``ResNet(cfg)``'s: the stages that
    ``cfg.truncate`` keeps; each BatchNorm under ``bn``, ``downsample.0`` /
    ``.1`` as ``downsample_conv`` / ``downsample_bn``."""
    out: Dict = {}

    def bn(src, dst):
        for kind in ("weight", "bias", "running_mean", "running_var"):
            out[f"{dst}.bn.{kind}"] = t2np(sd[f"{src}.{kind}"])

    out["conv1.weight"] = t2np(sd["conv1.weight"])
    bn("bn1", "bn1")
    convs = 3 if cfg.bottleneck else 2
    for stage in range(_n_stages(cfg.truncate)):
        for i in range(cfg.stage_sizes[stage]):
            t = f"layer{stage + 1}.{i}"
            for j in range(1, convs + 1):
                out[f"{t}.conv{j}.weight"] = t2np(sd[f"{t}.conv{j}.weight"])
                bn(f"{t}.bn{j}", f"{t}.bn{j}")
            if f"{t}.downsample.0.weight" in sd:
                out[f"{t}.downsample_conv.weight"] = t2np(sd[f"{t}.downsample.0.weight"])
                bn(f"{t}.downsample.1", f"{t}.downsample_bn")
    return tensors(out)
