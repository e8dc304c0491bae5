"""Image preprocessing with the reference's constants and order.

A copy of the numpy/PIL parts of ``anyloc_tpu/data/transforms.py`` (the
port cannot import that package without importing JAX). PIL decode ->
[0, 1] -> ImageNet normalize -> tensor-mode bilinear resize -> center-crop
to a multiple of the patch size. Output layout is channels-last [H, W, 3]
float32; ``device_normalize`` is the on-device counterpart for uint8
batches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from PIL import Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def load_pil(path: str) -> Image.Image:
    return Image.open(path).convert("RGB")


def resize_pil(img: Image.Image, size_hw: Tuple[int, int]) -> Image.Image:
    """(H, W) PIL bilinear resize (antialiased on downscale)."""
    h, w = size_hw
    return img.resize((w, h), Image.BILINEAR)


def normalize(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] float in [0,1] -> ImageNet-normalized."""
    return (img - IMAGENET_MEAN) / IMAGENET_STD


def _bilinear_matrix(src: int, dst: int) -> np.ndarray:
    """[dst, src] matrix reproducing torch tensor-mode bilinear resize
    (align_corners=False, antialias=False). PIL bilinear antialiases on
    downscale and does not match; the reference resizes the normalized
    tensor."""
    m = np.zeros((dst, src), np.float32)
    scale = src / dst
    for i in range(dst):
        pos = (i + 0.5) * scale - 0.5
        lo = int(np.floor(pos))
        t = pos - lo
        m[i, min(max(lo, 0), src - 1)] += 1.0 - t
        m[i, min(max(lo + 1, 0), src - 1)] += t
    return m


def resize_tensor_bilinear(arr: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """[H, W, C] float -> [h, w, C], torch F.interpolate bilinear semantics."""
    h, w = size_hw
    if arr.shape[:2] == (h, w):
        return arr
    mh = _bilinear_matrix(arr.shape[0], h)
    mw = _bilinear_matrix(arr.shape[1], w)
    return np.einsum("hs,swc,tw->htc", mh, arr, mw, optimize=True)


def max_edge_resize(img: Image.Image, max_edge: int = 1024) -> Image.Image:
    """Demo path: cap the longest edge (PIL bilinear)."""
    w, h = img.size
    if max(w, h) <= max_edge:
        return img
    scale = max_edge / max(w, h)
    return img.resize((int(round(w * scale)), int(round(h * scale))), Image.BILINEAR)


def center_crop_multiple(img: np.ndarray, multiple: int = 14) -> np.ndarray:
    """Center-crop [H, W, C] so H and W are multiples of ``multiple``.
    torchvision CenterCrop semantics: crop_top = int(round(margin / 2))
    (banker's rounding), not floor division."""
    h, w = img.shape[:2]
    ch, cw = (h // multiple) * multiple, (w // multiple) * multiple
    top = int(round((h - ch) / 2.0))
    left = int(round((w - cw) / 2.0))
    return img[top : top + ch, left : left + cw]


def base_transform(img: Image.Image, size_hw: Optional[Tuple[int, int]]) -> np.ndarray:
    """decode -> [0,1] -> normalize -> optional tensor-mode bilinear resize.
    Returns [H, W, 3] float32."""
    arr = np.asarray(img, np.float32) / 255.0
    arr = normalize(arr)
    if size_hw is not None and arr.shape[:2] != tuple(size_hw):
        arr = resize_tensor_bilinear(arr, tuple(size_hw))
    return arr


def load_image(path: str, size_hw: Optional[Tuple[int, int]] = (320, 320)) -> np.ndarray:
    return base_transform(load_pil(path), size_hw)


def resize_round_u8(arr: np.ndarray,
                    size_hw: Optional[Tuple[int, int]]) -> np.ndarray:
    """[H, W, 3] float array -> tensor-mode bilinear resize -> rounded uint8."""
    if size_hw is not None and arr.shape[:2] != tuple(size_hw):
        arr = resize_tensor_bilinear(arr, tuple(size_hw))
    return np.clip(np.rint(arr), 0, 255).astype(np.uint8)


def load_image_u8(
    path: str, size_hw: Optional[Tuple[int, int]] = (320, 320)
) -> np.ndarray:
    """decode -> optional resize -> rounded uint8 [H, W, 3]; normalization
    happens on the device (``device_normalize``)."""
    return resize_round_u8(np.asarray(load_pil(path), np.float32), size_hw)


_DEVICE_STATS: dict = {}


def device_normalize(imgs: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """On-device counterpart of ``normalize`` for uint8 batches:
    (x/255 - mean)/std in float32, on the batch's device. The default
    (ImageNet) statistics are copied to a device once: a copy from pageable
    host memory waits for the device's queued work."""
    if mean is IMAGENET_MEAN and std is IMAGENET_STD:
        stats = _DEVICE_STATS.get(imgs.device)
        if stats is None:
            stats = _DEVICE_STATS[imgs.device] = (
                torch.as_tensor(mean, device=imgs.device), torch.as_tensor(std, device=imgs.device))
    else:
        stats = (torch.as_tensor(np.asarray(mean, np.float32), device=imgs.device),
                 torch.as_tensor(np.asarray(std, np.float32), device=imgs.device))
    mean, std = stats
    return (imgs.float() / 255.0 - mean) / std


def preprocess_image(
    img: Image.Image,
    size_hw: Optional[Tuple[int, int]] = None,
    max_edge: Optional[int] = None,
    crop_multiple: Optional[int] = 14,
) -> np.ndarray:
    """Full demo-style preprocessing chain."""
    if max_edge is not None:
        img = max_edge_resize(img, max_edge)
    arr = base_transform(img, size_hw)
    if crop_multiple:
        arr = center_crop_multiple(arr, crop_multiple)
    return arr
