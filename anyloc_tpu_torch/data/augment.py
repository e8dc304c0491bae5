"""Batched train-time augmentations on the device (counterpart of
``anyloc_tpu/data/augment.py``; CosPlace's ``augmentations.py``
DeviceAgnostic* classes and dvgl's query transforms) over [B, H, W, 3]
batches.

Each random transform is two steps: draw its parameters from a
``torch.Generator`` (in the JAX ``key`` position; torch cannot reproduce
``jax.random``, F2), then apply the transform given them
(``apply_color_jitter``, ``resized_crop_batch``, ``rotate_batch``,
``perspective_batch``), which holds to the JAX function for the same
parameters.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from anyloc_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD


def _uniform(generator: torch.Generator, shape, lo: float, hi: float, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device) * (hi - lo) + lo


def _rgb_to_gray(x: torch.Tensor) -> torch.Tensor:
    return (0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2])[..., None]


def draw_color_jitter(generator: torch.Generator, b: int, brightness: float = 0.7,
                      contrast: float = 0.7, saturation: float = 0.7, hue: float = 0.5,
                      device=None) -> Dict[str, Optional[torch.Tensor]]:
    """Per-image factors [B] (None where the jitter is off): brightness,
    contrast and saturation uniform in [max(0, 1 - f), 1 + f], the hue
    angle uniform in [-2π·hue, 2π·hue] (torchvision's hue is a fraction of
    the whole circle)."""
    out = {}
    for name, f in (("brightness", brightness), ("contrast", contrast),
                    ("saturation", saturation)):
        out[name] = _uniform(generator, (b,), max(0.0, 1 - f), 1 + f, device) if f else None
    out["hue"] = (_uniform(generator, (b,), -hue * 2 * math.pi, hue * 2 * math.pi, device)
                  if hue else None)
    return out


def apply_color_jitter(imgs: torch.Tensor, brightness=None, contrast=None, saturation=None,
                       hue=None) -> torch.Tensor:
    """torchvision ColorJitter's factors on [B, H, W, 3] in [0, 1] space,
    in order brightness, contrast (about the image's gray mean),
    saturation (about its gray), hue (a rotation in YIQ space)."""
    x = imgs
    if brightness is not None:
        x = x * brightness.view(-1, 1, 1, 1)
    if contrast is not None:
        mean = _rgb_to_gray(x).mean(dim=(1, 2, 3), keepdim=True)
        x = mean + (x - mean) * contrast.view(-1, 1, 1, 1)
    if saturation is not None:
        gray = _rgb_to_gray(x)
        x = gray + (x - gray) * saturation.view(-1, 1, 1, 1)
    if hue is not None:
        theta = hue.view(-1, 1, 1)
        y = _rgb_to_gray(x)[..., 0]
        i = 0.596 * x[..., 0] - 0.274 * x[..., 1] - 0.322 * x[..., 2]
        q = 0.211 * x[..., 0] - 0.523 * x[..., 1] + 0.312 * x[..., 2]
        ci, si = torch.cos(theta), torch.sin(theta)
        i2 = ci * i - si * q
        q2 = si * i + ci * q
        x = torch.stack([y + 0.956 * i2 + 0.621 * q2, y - 0.272 * i2 - 0.647 * q2,
                         y - 1.106 * i2 + 1.703 * q2], dim=-1)
    return x


def color_jitter(generator: torch.Generator, imgs: torch.Tensor, brightness: float = 0.7,
                 contrast: float = 0.7, saturation: float = 0.7, hue: float = 0.5
                 ) -> torch.Tensor:
    """Per-image random brightness / contrast / saturation / hue jitter
    (CosPlace train.py defaults) on [B, H, W, 3] in [0, 1]-ish space."""
    return apply_color_jitter(imgs, **draw_color_jitter(
        generator, imgs.shape[0], brightness, contrast, saturation, hue, imgs.device))


def _bilinear_gather(imgs: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor,
                     fill: torch.Tensor) -> torch.Tensor:
    """Sample each image [B, H, W, C] at float source coordinates ``yy`` /
    ``xx`` [B, h, w]; a coordinate outside the image takes ``fill`` [C]."""
    b, h, w, _ = imgs.shape
    inb = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
    y0 = torch.clamp(torch.floor(yy), 0, h - 1).long()
    x0 = torch.clamp(torch.floor(xx), 0, w - 1).long()
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = (yy - y0)[..., None]
    wx = (xx - x0)[..., None]
    bi = torch.arange(b, device=imgs.device).view(b, 1, 1)
    tl, tr = imgs[bi, y0, x0], imgs[bi, y0, x1]
    bl, br = imgs[bi, y1, x0], imgs[bi, y1, x1]
    top = tl + (tr - tl) * wx
    bot = bl + (br - bl) * wx
    out = top + (bot - top) * wy
    return torch.where(inb[..., None], out, fill.to(out.dtype))


def resized_crop_batch(imgs: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                       ch: torch.Tensor, cw: torch.Tensor, out_hw: Tuple[int, int]
                       ) -> torch.Tensor:
    """Crop each image at (y0, x0) of size (ch, cw) [B] ints and resize it
    bilinearly to ``out_hw`` (the corners map onto the corner pixels)."""
    oh, ow = out_hw
    ys = torch.linspace(0.0, 1.0, oh, device=imgs.device)
    xs = torch.linspace(0.0, 1.0, ow, device=imgs.device)
    b = imgs.shape[0]
    yy = (y0.float().view(b, 1, 1) + ys.view(1, oh, 1) * (ch - 1).float().view(b, 1, 1))
    xx = (x0.float().view(b, 1, 1) + xs.view(1, 1, ow) * (cw - 1).float().view(b, 1, 1))
    yy, xx = yy.expand(b, oh, ow), xx.expand(b, oh, ow)
    # crops lie inside the image, so the fill never shows
    return _bilinear_gather(imgs, yy, xx, torch.zeros(imgs.shape[-1], device=imgs.device))


def random_resized_crop(generator: torch.Generator, imgs: torch.Tensor,
                        out_hw: Tuple[int, int], scale: Tuple[float, float] = (0.5, 1.0)
                        ) -> torch.Tensor:
    """Per-image random crop of area share s ~ U(scale) (sides scaled by
    √s), resized to ``out_hw`` (DeviceAgnostic RandomResizedCrop;
    bilinear)."""
    b, h, w, _ = imgs.shape
    dev = imgs.device
    s = _uniform(generator, (b,), scale[0], scale[1], dev)
    ch = torch.floor(h * torch.sqrt(s)).int()
    cw = torch.floor(w * torch.sqrt(s)).int()
    y0 = (torch.rand(b, generator=generator, device=dev) * (h - ch)).int()
    x0 = (torch.rand(b, generator=generator, device=dev) * (w - cw)).int()
    return resized_crop_batch(imgs, y0, x0, ch, cw, out_hw)


def rotate_batch(imgs: torch.Tensor, angles_deg: torch.Tensor, fill: torch.Tensor
                 ) -> torch.Tensor:
    """Rotate each image about its center by its angle (degrees, counter-
    clockwise in image coordinates, as torchvision's F.rotate), bilinear,
    the same size; outside the source -> ``fill``."""
    b, h, w, _ = imgs.shape
    theta = torch.deg2rad(angles_deg.float()).view(b, 1, 1)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ygrid, xgrid = torch.meshgrid(torch.arange(h, device=imgs.device),
                                  torch.arange(w, device=imgs.device), indexing="ij")
    dy, dx = (ygrid - cy).float(), (xgrid - cx).float()
    c, s = torch.cos(theta), torch.sin(theta)
    # the inverse rotation of the output grid into the source image
    sx = cx + c * dx - s * dy
    sy = cy + s * dx + c * dy
    return _bilinear_gather(imgs, sy, sx, fill)


def perspective_coeffs(endpoints: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The homographies [B, 8] (a..h) taking each image's ``endpoints``
    [B, 4, 2] back to its corners: xs = (a xe + b ye + c) / (g xe + h ye +
    1), ys likewise. Solved in float64."""
    starts = torch.tensor([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]],
                          dtype=torch.float64, device=endpoints.device)
    e = endpoints.double()
    b = e.shape[0]
    rows = torch.zeros(b, 8, 8, dtype=torch.float64, device=e.device)
    rhs = torch.zeros(b, 8, dtype=torch.float64, device=e.device)
    for i in range(4):
        xe, ye = e[:, i, 0], e[:, i, 1]
        xs, ys = starts[i]
        rows[:, 2 * i, 0], rows[:, 2 * i, 1], rows[:, 2 * i, 2] = xe, ye, 1.0
        rows[:, 2 * i, 6], rows[:, 2 * i, 7] = -xs * xe, -xs * ye
        rows[:, 2 * i + 1, 3], rows[:, 2 * i + 1, 4], rows[:, 2 * i + 1, 5] = xe, ye, 1.0
        rows[:, 2 * i + 1, 6], rows[:, 2 * i + 1, 7] = -ys * xe, -ys * ye
        rhs[:, 2 * i], rhs[:, 2 * i + 1] = xs, ys
    return torch.linalg.solve(rows, rhs)


def perspective_batch(imgs: torch.Tensor, endpoints: torch.Tensor, fill: torch.Tensor
                      ) -> torch.Tensor:
    """Warp each image so that its corners land on ``endpoints`` [B, 4, 2]
    ((x, y): top-left, top-right, bottom-right, bottom-left), torchvision
    F.perspective's semantics; outside the source -> ``fill``."""
    b, h, w, _ = imgs.shape
    k = perspective_coeffs(endpoints, h, w).float().view(b, 8, 1, 1).unbind(1)
    ygrid, xgrid = torch.meshgrid(torch.arange(h, device=imgs.device, dtype=torch.float32),
                                  torch.arange(w, device=imgs.device, dtype=torch.float32),
                                  indexing="ij")
    den = k[6] * xgrid + k[7] * ygrid + 1.0
    sx = (k[0] * xgrid + k[1] * ygrid + k[2]) / den
    sy = (k[3] * xgrid + k[4] * ygrid + k[5]) / den
    return _bilinear_gather(imgs, sy, sx, fill)


def random_rotation(generator: torch.Generator, imgs: torch.Tensor, degrees: float,
                    fill: torch.Tensor) -> torch.Tensor:
    """torchvision RandomRotation(degrees): a per-image angle uniform in
    [-degrees, degrees]."""
    angles = _uniform(generator, (imgs.shape[0],), -degrees, degrees, imgs.device)
    return rotate_batch(imgs, angles, fill)


def perspective_endpoints(d: torch.Tensor, h: int, w: int, distortion_scale: float
                          ) -> torch.Tensor:
    """Corner endpoints [B, 4, 2] from per-corner fractions ``d`` [B, 4, 2]
    in [0, 1): each corner moves inward by d · scale · half the side."""
    half_h, half_w = h // 2, w // 2
    dx = d[..., 0] * (distortion_scale * half_w)
    dy = d[..., 1] * (distortion_scale * half_h)
    return torch.stack([
        torch.stack([dx[:, 0], dy[:, 0]], -1),                    # TL
        torch.stack([w - 1 - dx[:, 1], dy[:, 1]], -1),            # TR
        torch.stack([w - 1 - dx[:, 2], h - 1 - dy[:, 2]], -1),    # BR
        torch.stack([dx[:, 3], h - 1 - dy[:, 3]], -1),            # BL
    ], dim=1)


def random_perspective(generator: torch.Generator, imgs: torch.Tensor,
                       distortion_scale: float, fill: torch.Tensor, p: float = 0.5
                       ) -> torch.Tensor:
    """torchvision RandomPerspective(distortion_scale, p): each corner moves
    inward by uniform(0, scale · half extent); per image with probability
    ``p``."""
    b, h, w, _ = imgs.shape
    d = torch.rand((b, 4, 2), generator=generator, device=imgs.device)
    warped = perspective_batch(imgs, perspective_endpoints(d, h, w, distortion_scale), fill)
    apply = torch.rand((b, 1, 1, 1), generator=generator, device=imgs.device) < p
    return torch.where(apply, warped, imgs)


# the make_augment_fn parameters of the same (dvgl flag) names shadow these
_random_resized_crop = random_resized_crop
_random_rotation = random_rotation


def make_augment_fn(brightness: float = 0, contrast: float = 0, saturation: float = 0,
                    hue: float = 0, horizontal_flip: bool = False,
                    random_resized_crop: float = 0, rand_perspective: float = 0,
                    random_rotation: float = 0, imagenet_normalized: bool = True):
    """The dvgl parser's augmentation flags (parser.py:73-84) as one
    ``(generator, imgs [B, H, W, 3]) -> imgs`` transform, in the reference
    query transform's order (datasets_ws.py:292-298): jitter ->
    perspective -> flip -> resized crop -> rotation. ``random_resized_crop``
    r crops an area share in (1 - r, 1); 0 is off.

    With ``imagenet_normalized`` (batches arrive normalized), the jitter
    runs in [0, 1] space between an un-normalize and a re-normalize; the
    geometric ops commute with the per-channel affine normalization, and
    their fill is normalized black (the reference's fill 0)."""

    def augment(generator: torch.Generator, imgs: torch.Tensor) -> torch.Tensor:
        x = imgs
        dev, dt = imgs.device, imgs.dtype
        mean = torch.as_tensor(IMAGENET_MEAN, dtype=dt, device=dev)
        std = torch.as_tensor(IMAGENET_STD, dtype=dt, device=dev)
        fill = (-mean / std) if imagenet_normalized else torch.zeros(3, dtype=dt, device=dev)
        if brightness or contrast or saturation or hue:
            if imagenet_normalized:
                x = x * std + mean
            x = color_jitter(generator, x, brightness=brightness, contrast=contrast,
                             saturation=saturation, hue=hue)
            if imagenet_normalized:
                x = (x - mean) / std
        if rand_perspective:
            x = random_perspective(generator, x, float(rand_perspective), fill)
        if horizontal_flip:
            flip = torch.rand((x.shape[0], 1, 1, 1), generator=generator, device=dev) < 0.5
            x = torch.where(flip, x.flip(2), x)
        if random_resized_crop:
            x = _random_resized_crop(generator, x, out_hw=tuple(x.shape[1:3]),
                                     scale=(1.0 - float(random_resized_crop), 1.0))
        if random_rotation:
            x = _random_rotation(generator, x, float(random_rotation), fill)
        return x

    return augment
