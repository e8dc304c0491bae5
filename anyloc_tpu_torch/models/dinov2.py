"""DINOv2 family: configs, checkpoint loading and random initialization
(counterpart of ``anyloc_tpu/models/dinov2.py``).

Architecture facts (public dinov2 ``vision_transformer.py``): patch 14,
LayerNorm eps 1e-6, LayerScale 1e-5 on both branches; S/B/L use a 4x GELU
MLP, G a SwiGLU-fused MLP with hidden round8(4·D·2/3) = 4096; learned
pos-embed on a 37x37 grid (518 px); ``_reg`` variants add 4 registers.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from anyloc_tpu_torch.models.vit import ViT, ViTConfig

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
    """A facebookresearch DINOv2 state dict in the port's key space:
    chunked ``blocks.{c}.{i}.*`` keys (``block_chunks > 0``; ``i`` stays the
    global block index) become ``blocks.{i}.*``; blocks at or past
    ``n_blocks``, the trunk-final ``norm`` (a truncated trunk never runs
    it) and the training-only ``mask_token`` are dropped."""
    out = {}
    for k, v in sd.items():
        if k == "mask_token" or k.startswith("norm."):
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


def from_jax_params(params) -> Dict[str, torch.Tensor]:
    """The JAX package's Flax parameter tree (numpy leaves, optionally
    under "params") -> this port's state dict; inverts
    ``anyloc_tpu.models.dinov2.convert_dinov2``: HWIO conv kernel -> OIHW,
    Dense kernel [in, out] -> weight [out, in], LayerNorm ``scale`` ->
    ``weight``, ``blocks_{i}`` -> ``blocks.{i}``, ``patch_embed`` ->
    ``patch_embed.proj``. The fused qkv column order (q|k|v, head-minor)
    is the same in both."""
    tree = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if hasattr(node, "items"):
            for k, v in node.items():
                walk(v, path + [str(k)])
            return
        arr = np.asarray(node, np.float32)
        parts = [re.sub(r"^blocks_(\d+)$", r"blocks.\1", p) for p in path]
        if parts[0] == "patch_embed":
            parts.insert(1, "proj")
        leaf = parts[-1]
        if leaf == "kernel":
            parts[-1] = "weight"
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        elif leaf == "scale":
            parts[-1] = "weight"
        out[".".join(parts)] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(tree, [])
    return out


@torch.no_grad()
def init_params(cfg: ViTConfig, seed: int = 42, *, n_blocks: Optional[int] = None,
                device=None) -> Dict[str, torch.Tensor]:
    """Random shape-true weights (no pretrained weights are available),
    made on ``device`` in ``cfg.dtype`` from a ``torch.Generator`` seeded
    with ``seed``: Linear/Conv weights normal(0, 1/sqrt(fan_in)), biases 0,
    LayerNorm 1/0, LayerScale ``cfg.layerscale_init``, CLS / pos-embed /
    registers normal(0, 0.02) — the JAX package's initializers."""
    device = torch.device("cpu" if device is None else device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device("meta"):
        shape_model = ViT(cfg, n_blocks)
    sd: Dict[str, torch.Tensor] = {}

    def normal(shape, std):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        return t.normal_(0.0, std, generator=gen).to(cfg.dtype)

    for mname, mod in shape_model.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            fan_in = mod.weight[0].numel()
            sd[pre + "weight"] = normal(mod.weight.shape, fan_in ** -0.5)
            if mod.bias is not None:
                sd[pre + "bias"] = torch.zeros(mod.bias.shape, dtype=cfg.dtype, device=device)
        elif isinstance(mod, nn.LayerNorm):
            sd[pre + "weight"] = torch.ones(mod.weight.shape, dtype=cfg.dtype, device=device)
            sd[pre + "bias"] = torch.zeros(mod.bias.shape, dtype=cfg.dtype, device=device)
    for name, p in shape_model.named_parameters():
        if name.endswith(".gamma"):
            sd[name] = torch.full(p.shape, cfg.layerscale_init, dtype=cfg.dtype, device=device)
        elif name in ("cls_token", "pos_embed", "register_tokens"):
            sd[name] = normal(p.shape, 0.02)
    return sd


def build_vit(cfg: ViTConfig, state_dict: Mapping, n_blocks: Optional[int] = None,
              device=None) -> ViT:
    """A ``ViT`` with ``n_blocks`` blocks on ``device`` in ``cfg.dtype``,
    holding ``state_dict`` (DINOv2 naming, see ``native_state_dict``)."""
    sd = native_state_dict(state_dict, n_blocks)
    with torch.device("meta"):
        model = ViT(cfg, n_blocks)
    model.load_state_dict(sd, strict=True, assign=True)
    return model.to(device=device, dtype=cfg.dtype).requires_grad_(False).eval()
