"""The model zoo: one ViT trunk configured per family (DINOv2, DINO v1,
CLIP, HF / CosPlace ViT, ImageBind's vision trunk, LSeg's backbone), the
MAE and SAM encoders, and their checkpoint converters (``registry``).

The JAX package's CNN and Swin backbones (``resnet``, ``cct``,
``efficientnet``, ``swin``) are not ported yet: naming one here raises,
naming its ROADMAP.md port-queue item."""

_NOT_PORTED = ("resnet", "cct", "efficientnet", "swin")


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"the {name} backbone is not ported yet (ROADMAP.md, port queue: "
            '"The other model families")')
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
