"""LSeg (language-driven semantic segmentation) image encoder
(counterpart of ``anyloc_tpu/models/lseg.py``): the encoder that produces
the dense pixel descriptors the reference's scripts/lseg_vlad.py only
reads from caches.

A CLIP-initialized timm ViT-L/16 backbone at 384 px (577 tokens: K5 in
every block), four block outputs (hooks 5, 11, 17, 23, captured in one
pass) reassembled into a pyramid (readout-project -> 1x1 conv -> up /
down-sample -> 3x3 conv), fused coarse to fine by four refinenets
(residual conv units + 2x bilinear with align_corners), and a 1x1 head
into the 512-d CLIP text space. BatchNorms run frozen. Zero-shot logits
are the dot product with CLIP text embeddings (``models/clip.py``'s text
tower, ``convert_lseg_text``).

The decoder's module names follow the JAX package's tree
(``readout.{i}``, ``reassemble.{i}``, ``resample.{0,1,3}``,
``layer_rn.{i}``, ``refinenet.{i}``, ``head1``; the backbone is
``trunk.*``); ``convert_lseg`` reads the published lang-seg checkpoint
into them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from anyloc_tpu_torch.models.convert import from_jax_params, t2np, tensors
from anyloc_tpu_torch.models.vit import ViT, ViTConfig
from anyloc_tpu_torch.ops.common import Conv2d


def lseg_backbone_config(dtype=None, img_size: int = 384) -> ViTConfig:
    """timm ``vit_large_patch16_384`` geometry (lang-seg ``clip_vitl16_384``:
    pre-LN blocks, erf GELU, learned pos-embed with CLS, no LayerScale)."""
    kwargs = dict(
        img_size=img_size, patch_size=16, embed_dim=1024, depth=24, num_heads=16,
        mlp_type="mlp", act="gelu", layerscale_init=None, ln_eps=1e-6,
        interpolate_offset=0.0, interpolate_antialias=False,
    )
    if dtype is not None:
        kwargs["dtype"] = dtype
    return ViTConfig(**kwargs)


@dataclasses.dataclass(frozen=True)
class LSegConfig:
    backbone: ViTConfig
    hooks: Tuple[int, ...] = (5, 11, 17, 23)
    reassemble_dims: Tuple[int, ...] = (256, 512, 1024, 1024)
    features: int = 256
    out_dim: int = 512           # CLIP text-embedding width
    use_bn: bool = True          # the refinenets' ResidualConvUnit BNs (frozen)
    bn_eps: float = 1e-5


def lseg_config(dtype=None, img_size: int = 384, **kw) -> LSegConfig:
    return LSegConfig(backbone=lseg_backbone_config(dtype, img_size), **kw)


def _bilinear_ac_matrix(src: int, dst: int) -> np.ndarray:
    """[dst, src] weights of torch's bilinear ``align_corners=True`` resize
    along one axis."""
    m = np.zeros((dst, src), np.float32)
    if src == 1:
        m[:, 0] = 1.0
        return m
    pos = np.arange(dst, dtype=np.float64) * (src - 1) / max(dst - 1, 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, src - 1)
    frac = (pos - lo).astype(np.float32)
    m[np.arange(dst), lo] += 1.0 - frac
    m[np.arange(dst), hi] += frac
    return m


def upsample2x_bilinear_ac(x: torch.Tensor) -> torch.Tensor:
    """NHWC 2x bilinear upsample with align_corners=True, as two small
    interpolation matrices."""
    _, h, w, _ = x.shape
    mh = torch.from_numpy(_bilinear_ac_matrix(h, 2 * h)).to(x.device, x.dtype)
    mw = torch.from_numpy(_bilinear_ac_matrix(w, 2 * w)).to(x.device, x.dtype)
    x = torch.einsum("oh,bhwc->bowc", mh, x)
    return torch.einsum("ow,bhwc->bhoc", mw, x)


def _conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """An NCHW conv on NHWC activations."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class TileDeconv(nn.Module):
    """ConvTranspose2d with kernel_size == stride (padding 0): each input
    pixel expands into a k x k output tile, one product and a reshape.
    ``weight`` [in, features, k, k] is torch's ConvTranspose2d layout."""

    def __init__(self, features: int, k: int, dtype=torch.float32, *, in_features: int,
                 device=None) -> None:
        super().__init__()
        self.k = k
        self.weight = nn.Parameter(torch.empty(in_features, features, k, k, device=device,
                                               dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(features, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # NHWC
        b, h, w, _ = x.shape
        t = torch.einsum("bhwc,coij->bhiwjo", x, self.weight)
        return t.reshape(b, h * self.k, w * self.k, -1) + self.bias


class FrozenBN(nn.Module):
    """Inference-mode BatchNorm2d over stored statistics (NHWC)."""

    def __init__(self, features: int, eps: float = 1e-5, dtype=torch.float32,
                 device=None) -> None:
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        return x * inv.to(self.dtype) + (self.bias - self.running_mean * inv).to(self.dtype)


class ResidualConvUnit(nn.Module):
    """relu -> 3x3 conv [-> bn] -> relu -> 3x3 conv [-> bn] -> + skip."""

    def __init__(self, features: int, use_bn: bool, bn_eps: float, dtype=torch.float32,
                 device=None) -> None:
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.conv1 = Conv2d(features, features, 3, padding=1, bias=not use_bn, **f)
        self.conv2 = Conv2d(features, features, 3, padding=1, bias=not use_bn, **f)
        if use_bn:
            self.bn1 = FrozenBN(features, bn_eps, dtype, device)
            self.bn2 = FrozenBN(features, bn_eps, dtype, device)
        self.use_bn = use_bn

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # NHWC
        out = _conv(F.relu(x), self.conv1)
        if self.use_bn:
            out = self.bn1(out)
        out = _conv(F.relu(out), self.conv2)
        if self.use_bn:
            out = self.bn2(out)
        return out + x


class FeatureFusionBlock(nn.Module):
    """DPT's FeatureFusionBlock_custom: the lateral RCU (``lateral``),
    an RCU, 2x bilinear (align_corners) and a 1x1 out conv."""

    def __init__(self, features: int, use_bn: bool, bn_eps: float, dtype=torch.float32, *,
                 lateral: bool = True, device=None) -> None:
        super().__init__()
        if lateral:
            self.rcu1 = ResidualConvUnit(features, use_bn, bn_eps, dtype, device)
        self.rcu2 = ResidualConvUnit(features, use_bn, bn_eps, dtype, device)
        self.out_conv = Conv2d(features, features, 1, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, res: Optional[torch.Tensor] = None) -> torch.Tensor:
        if res is not None:
            x = x + self.rcu1(res)
        x = upsample2x_bilinear_ac(self.rcu2(x))
        return _conv(x, self.out_conv)


class LSegEncoder(nn.Module):
    """imgs [B, H, W, 3] (normalized, H and W multiples of 32) -> pixel
    features [B, H/2, W/2, out_dim] in CLIP's text space, float32
    (L2-normalized with ``normalize``, the form the reference's lseg_vlad
    caches hold)."""

    def __init__(self, cfg: LSegConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        bc = cfg.backbone
        f = dict(device=device, dtype=bc.dtype)
        d, dims = bc.embed_dim, cfg.reassemble_dims
        self.trunk = ViT(bc, n_blocks=max(cfg.hooks) + 1, device=device)
        self.readout = nn.ModuleList([nn.Linear(2 * d, d, **f) for _ in dims])
        self.reassemble = nn.ModuleList([Conv2d(d, n, 1, **f) for n in dims])
        self.resample = nn.ModuleDict({
            "0": TileDeconv(dims[0], 4, bc.dtype, in_features=dims[0], device=device),
            "1": TileDeconv(dims[1], 2, bc.dtype, in_features=dims[1], device=device),
            "3": Conv2d(dims[3], dims[3], 3, stride=2, padding=1, **f)})
        self.layer_rn = nn.ModuleList([Conv2d(n, cfg.features, 3, padding=1, bias=False, **f)
                                       for n in dims])
        self.refinenet = nn.ModuleList([
            FeatureFusionBlock(cfg.features, cfg.use_bn, cfg.bn_eps, bc.dtype, lateral=i != 3,
                               device=device) for i in range(4)])
        self.head1 = Conv2d(cfg.features, cfg.out_dim, 1, **f)

    def forward(self, imgs: torch.Tensor, normalize: bool = True) -> torch.Tensor:
        c, bc = self.cfg, self.cfg.backbone
        b, h, w, _ = imgs.shape
        gh, gw = h // bc.patch_size, w // bc.patch_size
        hooked = self.trunk(imgs, capture_layers=list(c.hooks), capture_facet="token")
        pyramids = []
        for idx, layer in enumerate(c.hooks):
            t = hooked[layer]   # [B, 1+N, D]
            cls, toks = t[:, :1], t[:, 1:]
            # readout "project": CLS concatenated onto every token, Linear + GELU
            r = F.gelu(self.readout[idx](torch.cat([toks, cls.expand_as(toks)], dim=-1)))
            r = _conv(r.reshape(b, gh, gw, bc.embed_dim), self.reassemble[idx])
            if idx in (0, 1):
                r = self.resample[str(idx)](r)
            elif idx == 3:
                r = _conv(r, self.resample["3"])
            pyramids.append(_conv(r, self.layer_rn[idx]))
        p = self.refinenet[3](pyramids[3])
        for i in (2, 1, 0):
            p = self.refinenet[i](p, pyramids[i])
        feats = _conv(p, self.head1).float()
        if normalize:
            feats = feats / (torch.linalg.vector_norm(feats, dim=-1, keepdim=True) + 1e-12)
        return feats


def lseg_logits(pixel_feats: torch.Tensor, text_feats: torch.Tensor, logit_scale=1.0,
                upsample: bool = True) -> torch.Tensor:
    """Zero-shot segmentation logits: pixel features [B, H/2, W/2, D]
    (L2-normalized) x text embeddings [K, D] (L2-normalized) ->
    [B, H, W, K] (2x bilinear with align_corners up to the input's size,
    LSegNet's output_conv)."""
    logits = logit_scale * torch.einsum("bhwd,kd->bhwk", pixel_feats, text_feats)
    return upsample2x_bilinear_ac(logits) if upsample else logits


def _jax_rename(key: str, arr: np.ndarray):
    if key.startswith("trunk.norm."):
        return None   # the hooks never reach the trunk's final norm
    if key.startswith(("resample.0.weight", "resample.1.weight")):
        return key, arr.transpose(1, 0, 2, 3)   # -> ConvTranspose2d's [in, out, k, k]
    return key, arr


def from_jax_params_lseg(params) -> Dict[str, torch.Tensor]:
    """The JAX package's ``LSegEncoder`` tree -> the port's state dict."""
    return from_jax_params(params, _jax_rename)


def _strip_net(sd: Dict) -> Dict:
    if any(k.startswith("net.") for k in sd):
        return {k[4:]: v for k, v in sd.items() if k.startswith("net.")}
    return dict(sd)


def convert_lseg(sd: Dict, cfg: LSegConfig) -> Dict[str, torch.Tensor]:
    """A lang-seg checkpoint -> the port's ``LSegEncoder`` state dict.

    Its layout: ``pretrained.model.*`` (timm ViT-L/16), the reassemble
    stages ``pretrained.act_postprocess{1..4}`` = Sequential(readout
    project (.0), Transpose (.1), Unflatten (.2), 1x1 conv (.3)[, resample
    (.4)]), ``scratch.layer{1..4}_rn``, ``scratch.refinenet{1..4}`` and
    ``scratch.head1``; an optional lightning ``net.`` prefix. The
    checkpoint's BatchNorms must agree with ``cfg.use_bn``."""
    sd = _strip_net(sd)
    out: Dict = {}
    n_blocks = max(cfg.hooks) + 1
    for k, v in sd.items():
        if not k.startswith("pretrained.model."):
            continue
        k = k[len("pretrained.model."):]
        if k.startswith(("patch_embed.", "cls_token", "pos_embed")) or any(
                k.startswith(f"blocks.{i}.") for i in range(n_blocks)):
            out[f"trunk.{k}"] = v

    def copy(ours: str, theirs: str, kinds=("weight", "bias")) -> None:
        for kind in kinds:
            out[f"{ours}.{kind}"] = sd[f"{theirs}.{kind}"]

    for idx in range(4):
        ap = f"pretrained.act_postprocess{idx + 1}"
        copy(f"readout.{idx}", f"{ap}.0.project.0")
        copy(f"reassemble.{idx}", f"{ap}.3")
        if idx != 2:
            copy(f"resample.{idx}", f"{ap}.4")
        copy(f"layer_rn.{idx}", f"scratch.layer{idx + 1}_rn", ("weight",))
    has_bn = "scratch.refinenet1.resConfUnit1.bn1.weight" in sd
    if has_bn != cfg.use_bn:
        raise ValueError(f"checkpoint use_bn={has_bn} but config use_bn={cfg.use_bn}")
    conv_kinds = ("weight",) if cfg.use_bn else ("weight", "bias")
    # scratch.refinenet4 takes the deepest hook (ours 3) and has no lateral
    # input: its resConfUnit1 is in the checkpoint but never runs
    for ours, theirs in ((3, 4), (2, 3), (1, 2), (0, 1)):
        units = (("rcu2", "resConfUnit2"),) + ((("rcu1", "resConfUnit1"),) if ours != 3 else ())
        for unit, their_unit in units:
            pre, tpre = f"refinenet.{ours}.{unit}", f"scratch.refinenet{theirs}.{their_unit}"
            for conv in ("conv1", "conv2"):
                copy(f"{pre}.{conv}", f"{tpre}.{conv}", conv_kinds)
            if cfg.use_bn:
                for bn in ("bn1", "bn2"):
                    copy(f"{pre}.{bn}", f"{tpre}.{bn}",
                         ("weight", "bias", "running_mean", "running_var"))
        copy(f"refinenet.{ours}.out_conv", f"scratch.refinenet{theirs}.out_conv")
    copy("head1", "scratch.head1")
    return tensors({k: t2np(v) for k, v in out.items()})


def convert_lseg_text(sd: Dict, depth: int = 12) -> Dict[str, torch.Tensor]:
    """The CLIP text tower inside a lang-seg checkpoint (``clip_pretrained.*``,
    an OpenAI CLIP; LSeg takes ViT-B/32's text width 512, 12 layers) ->
    ``models.clip.CLIPTextTower``'s state dict."""
    from anyloc_tpu_torch.models.clip import convert_clip_text

    sd = _strip_net(sd)
    inner = {k[len("clip_pretrained."):]: v for k, v in sd.items()
             if k.startswith("clip_pretrained.")}
    return convert_clip_text(inner, depth)


def lseg_logit_scale(sd: Dict) -> float:
    sd = _strip_net(sd)
    return float(np.exp(t2np(sd["logit_scale"]))) if "logit_scale" in sd else 1.0
