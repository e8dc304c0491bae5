"""Misc image/array converters with the reference's exact semantics
(utilities.py:79-129 ``to_np``/``to_pil_list``, :474-500 ``pad_img``): a
copy of ``anyloc_tpu/utils/images.py`` (numpy and PIL only)."""

from __future__ import annotations

from typing import List, Union

import numpy as np
from PIL import Image


def to_np(x, ret_type=float) -> np.ndarray:
    """Array-like (torch tensors included) -> numpy of dtype ret_type."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x).astype(ret_type)


def to_pil_list(x) -> List[Image.Image]:
    """Images (single or batch, channels first or last) -> list of PIL
    images, per-image min-max normalized (utilities.py:99-129)."""
    if isinstance(x, Image.Image):
        return [x]
    if isinstance(x, list) and x and isinstance(x[0], Image.Image):
        return x
    x = to_np(x)
    if x.ndim == 3:
        x = x[None]
    out = []
    for img in x:
        if img.shape[0] in (1, 3):  # [C, H, W] -> [H, W, C]
            img = img.transpose(1, 2, 0)
        norm = (img - img.min()) / max(img.max() - img.min(), 1e-12)
        out.append(Image.fromarray((norm * 255).astype(np.uint8).squeeze()))
    return out


def pad_img(img: np.ndarray, padding: int, color=(0, 0, 0)) -> np.ndarray:
    """Pad [H, W, 3] on all sides with a solid color (utilities.py:474-500)."""
    color = np.asarray(tuple(color), np.uint8)
    assert color.shape == (3,), "Color should be (R, G, B)"
    if padding <= 0:
        return img
    h, w = img.shape[:2]
    # allocate in the IMAGE dtype (a uint8 buffer truncates float content)
    out = (np.ones((h + 2 * padding, w + 2 * padding, 3)) * color).astype(
        img.dtype
    )
    out[padding:-padding, padding:-padding] = img
    return out
