"""Model registry: name -> (config factory, converter, family)
(counterpart of ``anyloc_tpu/models/registry.py``, with its names). Each
entry's ``convert(state_dict, cfg)`` returns the port's state dict."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple


class ModelEntry(NamedTuple):
    config: Callable    # (**kwargs) -> the family's config
    convert: Callable   # (state_dict, cfg) -> the port's state dict
    family: str


_REGISTRY: Dict[str, ModelEntry] = {}


def register(name: str, config: Callable, convert: Callable, family: str) -> None:
    _REGISTRY[name] = ModelEntry(config, convert, family)


def get(name: str) -> ModelEntry:
    if name not in _REGISTRY:
        raise KeyError(f"Unknown model '{name}'. Registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names():
    return sorted(_REGISTRY)


def _convert_dinov2(sd, cfg):
    from anyloc_tpu_torch.models.dinov2 import native_state_dict

    return native_state_dict(sd)


def _install_builtin() -> None:
    from anyloc_tpu_torch.models import (clip, cosplace_vit, dino_v1, dinov2, imagebind, mae,
                                         sam)

    for n in ("dinov2_vits14", "dinov2_vitb14", "dinov2_vitl14", "dinov2_vitg14"):
        for name in (n, n + "_reg"):
            register(name, lambda name=name, **kw: dinov2.dinov2_config(name, **kw),
                     _convert_dinov2, "dinov2")
    for n in ("dino_vits8", "dino_vits16", "dino_vitb8", "dino_vitb16"):
        register(n, lambda name=n, **kw: dino_v1.dino_v1_config(name, **kw),
                 dino_v1.convert_dino_v1, "dino_v1")
    for n in clip._VISION:
        register(f"clip_{n}", lambda name=n, **kw: clip.clip_vision_config(name, **kw),
                 clip.convert_clip_vision, "clip")
    register("hf_vit_base", lambda **kw: cosplace_vit.hf_vit_config(**kw),
             cosplace_vit.convert_hf_vit, "hf_vit")
    register("imagebind_huge", lambda **kw: imagebind.imagebind_vision_config(**kw),
             imagebind.convert_imagebind_vision, "imagebind")
    for n, fac in mae.MAE_FACTORIES.items():
        register(n, lambda fac=fac, **kw: fac(**kw), mae.convert_mae, "mae")
    for n, fac in sam.SAM_FACTORIES.items():
        register(f"sam_{n}", lambda fac=fac, **kw: dataclasses.replace(fac(), **kw),
                 sam.convert_sam, "sam")


_install_builtin()
