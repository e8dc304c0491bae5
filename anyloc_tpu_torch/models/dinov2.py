"""DINOv2 family: configs, checkpoint loading and random initialization
(counterpart of ``anyloc_tpu/models/dinov2.py``).

Architecture facts (public dinov2 ``vision_transformer.py``): patch 14,
LayerNorm eps 1e-6, LayerScale 1e-5 on both branches; S/B/L use a 4x GELU
MLP, G a SwiGLU-fused MLP with hidden round8(4·D·2/3) = 4096; learned
pos-embed on a 37x37 grid (518 px); ``_reg`` variants add 4 registers.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from anyloc_tpu_torch.models.convert import from_jax_params  # noqa: F401 (the JAX tree's loader)
from anyloc_tpu_torch.models.hf_convert import ensure_native_naming
from anyloc_tpu_torch.models.vit import ViT, ViTConfig
from anyloc_tpu_torch.ops.quant import quantize_vit_params

_DIMS = {
    # name: (embed_dim, depth, heads, mlp_type)
    "dinov2_vits14": (384, 12, 6, "mlp"),
    "dinov2_vitb14": (768, 12, 12, "mlp"),
    "dinov2_vitl14": (1024, 24, 16, "mlp"),
    "dinov2_vitg14": (1536, 40, 24, "swiglu_fused"),
}


def dinov2_config(name: str, *, num_register_tokens: int = 0,
                  dtype: Optional[torch.dtype] = None, img_size: int = 518) -> ViTConfig:
    base = name.replace("_reg", "")
    if base not in _DIMS:
        raise ValueError(f"Unknown DINOv2 model: {name} (have {list(_DIMS)})")
    if name.endswith("_reg"):
        num_register_tokens = 4
    d, depth, heads, mlp = _DIMS[base]
    kwargs = dict(
        img_size=img_size, patch_size=14, embed_dim=d, depth=depth,
        num_heads=heads, mlp_type=mlp, layerscale_init=1e-5, ln_eps=1e-6,
        num_register_tokens=num_register_tokens, interpolate_offset=0.1,
        interpolate_antialias=False,
    )
    if dtype is not None:
        kwargs["dtype"] = dtype
    return ViTConfig(**kwargs)


_CHUNKED = re.compile(r"^blocks\.\d+\.(\d+)\.(.*)$")
_BLOCK = re.compile(r"^blocks\.(\d+)\.")


def native_state_dict(sd: Mapping, n_blocks: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """A DINOv2 state dict in the port's key space. A HuggingFace
    ``Dinov2Model`` layout is renamed first (``ensure_native_naming``);
    chunked ``blocks.{c}.{i}.*`` keys (``block_chunks > 0``; ``i`` stays the
    global block index) become ``blocks.{i}.*``; the training-only
    ``mask_token`` is dropped, and with ``n_blocks`` (a truncated trunk)
    the blocks at or past it, the trunk-final ``norm`` and ``proj_out``,
    which such a trunk never runs."""
    sd = ensure_native_naming(sd, "dinov2")
    out = {}
    for k, v in sd.items():
        if k == "mask_token" or (n_blocks is not None and k.startswith(("norm.", "proj_out."))):
            continue
        m = _CHUNKED.match(k)
        if m:
            k = f"blocks.{m.group(1)}.{m.group(2)}"
        m = _BLOCK.match(k)
        if m and n_blocks is not None and int(m.group(1)) >= n_blocks:
            continue
        out[k] = torch.as_tensor(np.asarray(v)) if isinstance(v, np.ndarray) else v
    return out


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A local ``.pth`` state dict (no torch.hub): tensors only, nested
    under "state_dict" / "model" / "teacher" where a trainer saved it so."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model", "model_state_dict", "teacher"):
        if isinstance(sd.get(key), dict):
            sd = sd[key]
            break
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


@torch.no_grad()
def init_params(cfg: ViTConfig, seed: int = 42, *, n_blocks: Optional[int] = None,
                device=None) -> Dict[str, torch.Tensor]:
    """Random shape-true weights (no pretrained weights are available),
    made on ``device`` in ``cfg.dtype`` from a ``torch.Generator`` seeded
    with ``seed``: Linear/Conv weights normal(0, 1/sqrt(fan_in)), biases 0,
    LayerNorm 1/0, LayerScale ``cfg.layerscale_init``, CLS / pos-embed /
    registers normal(0, 0.02) — the JAX package's initializers. A quantized
    ``cfg`` draws the same float32 weights as the unquantized trunk and
    quantizes every Linear its mode names (``quantize_vit_params``)."""
    device = torch.device("cpu" if device is None else device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device("meta"):
        shape_model = ViT(dataclasses.replace(cfg, quant=None), n_blocks)
    sd: Dict[str, torch.Tensor] = {}
    dtype = torch.float32 if cfg.quant else cfg.dtype  # build_vit casts

    def normal(shape, std):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        return t.normal_(0.0, std, generator=gen).to(dtype)

    for mname, mod in shape_model.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            fan_in = mod.weight[0].numel()
            sd[pre + "weight"] = normal(mod.weight.shape, fan_in ** -0.5)
            if mod.bias is not None:
                sd[pre + "bias"] = torch.zeros(mod.bias.shape, dtype=dtype, device=device)
        elif isinstance(mod, nn.LayerNorm):
            sd[pre + "weight"] = torch.ones(mod.weight.shape, dtype=dtype, device=device)
            sd[pre + "bias"] = torch.zeros(mod.bias.shape, dtype=dtype, device=device)
    for name, p in shape_model.named_parameters():
        if name.endswith(".gamma"):
            sd[name] = torch.full(p.shape, cfg.layerscale_init, dtype=dtype, device=device)
        elif name in ("cls_token", "pos_embed", "register_tokens"):
            sd[name] = normal(p.shape, 0.02)
    if cfg.quant:
        sd = quantize_vit_params(sd, cfg.quant, min_size=1)
    return sd


def build_vit(cfg: ViTConfig, state_dict: Mapping, n_blocks: Optional[int] = None,
              device=None) -> ViT:
    """A ``ViT`` with ``n_blocks`` blocks on ``device``, holding
    ``state_dict`` (DINOv2 naming, see ``native_state_dict``; for a
    quantized ``cfg`` in ``quantize_vit_params``' layout). Every tensor
    takes the type its module declares: ``cfg.dtype``, except that a
    quantized trunk keeps int8 codes and f32 scales, biases of int8 layers,
    LayerNorm parameters and LayerScale gammas."""
    sd = native_state_dict(state_dict, n_blocks)
    with torch.device("meta"):
        model = ViT(cfg, n_blocks)
    declared = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    sd = {k: v.to(declared[k].dtype) if k in declared else v for k, v in sd.items()}
    model.load_state_dict(sd, strict=True, assign=True)
    return model.to(device=device).requires_grad_(False).eval()
