"""ImageBind's vision trunk (counterpart of the vision part of
``anyloc_tpu/models/imagebind.py``; the reference evaluates it in
scripts/imagebind_global_vpr.py).

imagebind_huge's vision geometry: 1280 wide, 32 blocks of 16 heads (head
dim 80: K5 at 257 tokens), 14-px patches (the reference's 3-D patch conv
over two duplicated frames collapses to a 2-D conv, exactly, for still
images), CLS, a learned pre-transformer LayerNorm (``norm_pre``) and no
trunk-final LayerNorm: that one lives in the modality head, LN -> CLS ->
Linear(1280, 1024) -> L2 normalize (imagebind_extractor.py:1403-1410,
1466-1470).

The multimodal surface (``ImageBindModel``, the text, audio, depth,
thermal and IMU towers, ``log_mel_spectrogram`` and their converters) is
not ported yet: each raises, naming its ROADMAP.md port-queue item.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

# the JAX package's vision trunk tree is the generic ViT tree
from anyloc_tpu_torch.models.convert import (from_jax_params, maybe_tp_split,  # noqa: F401
                                             t2np, tensors)
from anyloc_tpu_torch.models.vit import ViTConfig
from anyloc_tpu_torch.ops.common import l2_normalize, resolve_device

_NOT_PORTED = ('{} is not ported yet (ROADMAP.md, port queue: "The other model '
               'families")')


class ModalityType:   # API parity (imagebind_extractor.py:1115)
    VISION = "vision"
    TEXT = "text"
    AUDIO = "audio"
    THERMAL = "thermal"
    DEPTH = "depth"
    IMU = "imu"


def imagebind_vision_config(dtype=None, img_size: int = 224) -> ViTConfig:
    kwargs = dict(
        img_size=img_size, patch_size=14, embed_dim=1280, depth=32, num_heads=16,
        mlp_type="mlp", layerscale_init=None, ln_eps=1e-6, pre_norm=True, final_norm=False,
        interpolate_offset=0.0,
        patch_bias=False,   # the reference's Conv3d stem has no bias (F15)
    )
    if dtype is not None:
        kwargs["dtype"] = dtype
    return ViTConfig(**kwargs)


class ImageBindVision:
    """The vision extractor of the VPR path: ``__call__(imgs)`` ->
    {"cls": the modality head's embedding [B, 1024] (LN -> CLS -> Linear,
    L2-normalized, float32), "tokens": the trunk's patch tokens [B, N, D]
    (float32)} on ``device`` (None: the card). ``checkpoint`` is a local
    ImageBind ``.pth``; None means a random trunk from ``seed`` and a
    random head from ``seed + 1``. ``params`` / ``head`` give the trunk's
    state dict and (head LayerNorm {"weight", "bias"}, head matrix
    [1280, 1024]) instead."""

    def __init__(self, checkpoint: Optional[str] = None, dtype=torch.bfloat16,
                 seed: int = 42, *, device: Union[None, str, torch.device] = None,
                 params: Optional[Dict] = None,
                 head: Optional[Tuple[Dict, object]] = None) -> None:
        from anyloc_tpu_torch.models.dinov2 import build_vit, init_params

        self.cfg = imagebind_vision_config(dtype=dtype)
        self.device = resolve_device(device)
        if checkpoint is not None:
            from anyloc_tpu_torch.models.convert import load_torch_checkpoint

            sd = load_torch_checkpoint(checkpoint)
            params = convert_imagebind_vision(sd, self.cfg)
            head = convert_imagebind_vision_head(sd)
        if params is None:
            params = init_params(self.cfg, seed, device=self.device)
        self.model = build_vit(self.cfg, params, None, device=self.device)
        d = self.cfg.embed_dim
        if head is None:
            gen = torch.Generator(device=self.device).manual_seed(seed + 1)
            head = ({"weight": torch.ones(d), "bias": torch.zeros(d)},
                    torch.randn((d, 1024), generator=gen, device=self.device) * 0.02)
        ln, w = head
        self.head_ln = {k: torch.as_tensor(t2np(v)).to(self.device) for k, v in ln.items()}
        self.head_w = torch.as_tensor(t2np(w)).to(self.device)

    @torch.inference_mode()
    def __call__(self, imgs, modality: str = ModalityType.VISION) -> Dict[str, torch.Tensor]:
        if modality != ModalityType.VISION:
            raise NotImplementedError(
                "ImageBindVision is the vision-only extractor; use ImageBindModel for the "
                "multimodal surface")
        if isinstance(imgs, np.ndarray):
            imgs = torch.from_numpy(imgs)
        imgs = imgs.to(self.device, torch.float32)
        if imgs.dim() == 3:
            imgs = imgs[None]
        out = self.model(imgs)
        # the trunk-final LayerNorm lives in the head (reference :1466-1470)
        pre = out["pre_norm_tokens"][:, 0].float()
        mu = pre.mean(-1, keepdim=True)
        var = ((pre - mu) ** 2).mean(-1, keepdim=True)
        normed = (pre - mu) / torch.sqrt(var + 1e-6) * self.head_ln["weight"] + self.head_ln["bias"]
        return {"cls": l2_normalize(normed @ self.head_w), "tokens": out["tokens"].float()}


def convert_imagebind_vision(sd: Dict, cfg: ViTConfig) -> Dict[str, torch.Tensor]:
    """An ImageBind checkpoint (``modality_*.vision.*``) -> the vision
    trunk's state dict. The 3-D patch kernel [D, 3, T, p, p] sums over
    time (still images duplicate the frame: an exact equivalence); the
    pre-transformer LayerNorm is ``norm_pre``."""
    vp, vt = "modality_preprocessors.vision.", "modality_trunks.vision."
    out = {
        "patch_embed.proj.weight": t2np(sd[f"{vp}rgbt_stem.proj.1.weight"]).sum(axis=2),
        "cls_token": sd[f"{vp}cls_token"],
        "pos_embed": sd[f"{vp}pos_embedding_helper.pos_embed"],
        "norm_pre.weight": sd[f"{vt}pre_transformer_layer.0.weight"],
        "norm_pre.bias": sd[f"{vt}pre_transformer_layer.0.bias"],
    }
    for i in range(cfg.depth):
        h, b = f"{vt}blocks.{i}", f"blocks.{i}"
        out[f"{b}.attn.qkv.weight"] = sd[f"{h}.attn.in_proj_weight"]
        out[f"{b}.attn.qkv.bias"] = sd[f"{h}.attn.in_proj_bias"]
        for ours, theirs in (("norm1", "norm_1"), ("norm2", "norm_2"),
                             ("attn.proj", "attn.out_proj"), ("mlp.fc1", "mlp.fc1"),
                             ("mlp.fc2", "mlp.fc2")):
            for kind in ("weight", "bias"):
                out[f"{b}.{ours}.{kind}"] = sd[f"{h}.{theirs}.{kind}"]
    return maybe_tp_split(tensors({k: t2np(v) for k, v in out.items()}), cfg)


def convert_imagebind_vision_head(sd: Dict) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """``modality_heads.vision``: LN(1280) -> CLS -> Linear(1280, 1024, no
    bias) (imagebind_extractor.py:1466-1470) -> ({"weight", "bias"} of the
    LN, the matrix [1280, 1024] that multiplies the CLS row)."""
    ln = {k: torch.from_numpy(t2np(sd[f"modality_heads.vision.0.{k}"])) for k in ("weight", "bias")}
    return ln, torch.from_numpy(np.ascontiguousarray(t2np(sd["modality_heads.vision.2.weight"]).T))


def from_jax_head(head_ln: Dict, head_w) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The JAX package's head (``ImageBindVision.head_ln`` {"scale",
    "bias"} and ``head_w`` [1280, 1024]) -> the port's ``head``."""
    return ({"weight": torch.from_numpy(t2np(head_ln["scale"])),
             "bias": torch.from_numpy(t2np(head_ln["bias"]))},
            torch.from_numpy(t2np(head_w).copy()))


def imagebind_huge(checkpoint: Optional[str] = None, full: bool = False, **kw):
    """Factory-name parity (imagebind_extractor.py:1567-1596): the vision
    extractor of the VPR pipeline; ``full=True`` (the multimodal model)
    is not ported yet."""
    if full:
        raise NotImplementedError(_NOT_PORTED.format("imagebind_huge(full=True), the multimodal "
                                                     "ImageBindModel,"))
    return ImageBindVision(checkpoint, **kw)


def _not_ported(name: str):
    def stub(*args, **kwargs):
        raise NotImplementedError(_NOT_PORTED.format(f"ImageBind's {name}"))

    stub.__name__ = stub.__qualname__ = name
    stub.__doc__ = f"ImageBind's {name}: not ported yet (it raises)."
    return stub


# the multimodal surface (anyloc_tpu/models/imagebind.py:65-400, :504-598)
ImageBindModel = _not_ported("ImageBindModel")
ImageBindText = _not_ported("ImageBindText")
log_mel_spectrogram = _not_ported("log_mel_spectrogram")
convert_imagebind_text = _not_ported("convert_imagebind_text")
convert_imagebind_patch = _not_ported("convert_imagebind_patch")
