"""Sequence parallelism for the ViT trunk (counterpart of
``anyloc_tpu/parallel/sp.py``): ring attention over the mesh's ``model``
axis.

The demo path runs images up to 1024 px through ViT-G (~5.3k tokens),
where activations, not parameters, fill a device. Sequence parallelism
shards the TOKEN axis: LayerNorm, qkv, projection and MLP are token-local,
and only attention needs the other shards' keys. They come round a ring:
each rank holds one K / V shard and passes it on (``shift``, the send and
the receive posted together) while it accumulates an online softmax, the
distributed form of the key-blocked flash attention. This is plain torch
math, as in the JAX package.

Token counts rarely divide the axis (257 at 224 px): shards are
zero-padded and the ring masks padded KEYS out of every softmax; padded
query rows compute values that are dropped on unpadding and never read as
keys. Weights are replicated; images shard over ``data``.

A trunk whose tensors require a gradient trains through it, as through
the JAX package's (F25): the trunk runs functionally over the caller's
tensors, the ring passes K / V by ``shift_grad``, the gathers are
``tp_gather`` (a loss replicated over every rank), and ``sum_grads`` sums
what each rank computed of the trunk's gradients (its token shard of its
images) over the mesh. Masked keys get exact zero probabilities, so padded
keys take zero gradient, not NaN. ``SPFacetExtractor`` stays an
extractor (inference only).
"""

from __future__ import annotations

import contextlib
from typing import Mapping, Optional, Union

import torch

from anyloc_tpu_torch.models.vit import FACET_OFFSETS, ViTConfig
from anyloc_tpu_torch.ops.common import l2_normalize, resolve_device
from anyloc_tpu_torch.parallel.mesh import (
    axis_index,
    axis_size,
    shard_rows,
    shift,
    shift_grad,
    tp_gather,
)

_NEG = -1e30


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_mask: torch.Tensor,
                   *, axis_name: str = "model", n_shards: Optional[int] = None,
                   mesh) -> torch.Tensor:
    """Exact attention with K / V sharded over ``axis_name``: q / k / v are
    this rank's token shard [B, H, n_loc, hd], ``kv_mask`` [n_loc] marks its
    real keys (False: padding). ``n_shards`` ring steps of (online-softmax
    update; K / V / mask passed on) give softmax(q·kᵀ·scale)·v over the
    whole sequence, accumulated in float32. Under autograd the K / V
    shards go round by ``shift_grad``, so their cotangents come back to
    the rank that holds them."""
    n_shards = n_shards or axis_size(mesh, axis_name)
    b, h, nq, hd = q.shape
    qf = q.float() * hd ** -0.5
    m = torch.full((b, h, nq, 1), _NEG, device=q.device)
    el = torch.zeros((b, h, nq, 1), device=q.device)
    acc = torch.zeros((b, h, nq, hd), device=q.device)
    kv, msk = torch.stack([k, v]), kv_mask
    for step in range(n_shards):
        s = qf @ kv[0].float().transpose(-1, -2)
        valid = msk.bool()[None, None, None, :]
        s = torch.where(valid, s, _NEG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        # explicit zeroing: an all-padded block gives s == m_new == _NEG,
        # whose exp(0) would be 1
        p = torch.where(valid, torch.exp(s - m_new), 0.0)
        corr = torch.exp(m - m_new)
        acc = acc * corr + p @ kv[1].float()
        el = el * corr + p.sum(-1, keepdim=True)
        m = m_new
        if step < n_shards - 1:
            kv = shift_grad(kv, mesh, axis_name)
            msk = shift(msk.to(torch.uint8), mesh, axis_name)
    return (acc / torch.clamp_min(el, 1e-30)).to(q.dtype)


def _sp_trunk(model, imgs, mesh, layer: int, facet: str, data_axis: str,
              sp_axis: str, dev) -> torch.Tensor:
    """The truncated trunk ``model`` (blocks 0..layer) with the images
    sharded over ``data_axis`` and the tokens over ``sp_axis``; returns
    [B, P+N, D] (the facet, or block ``layer``'s output for "token") on
    every rank, on ``dev``."""
    n_data, n_sp = axis_size(mesh, data_axis), axis_size(mesh, sp_axis)
    imgs = torch.as_tensor(imgs).to(dev)
    n_imgs, pad = imgs.shape[0], (-imgs.shape[0]) % n_data
    if pad:
        imgs = torch.cat([imgs, imgs.new_zeros((pad,) + tuple(imgs.shape[1:]))])
    x = model.embed(shard_rows(imgs, mesh, data_axis))
    b, t, d = x.shape
    t_loc = -(-t // n_sp)
    x = torch.nn.functional.pad(x, (0, 0, 0, t_loc * n_sp - t))
    i = axis_index(mesh, sp_axis)
    x = x[:, i * t_loc:(i + 1) * t_loc]
    mask = torch.arange(i * t_loc, (i + 1) * t_loc, device=dev) < t

    def ring(q, k, v):
        return ring_attention(q, k, v, mask, axis_name=sp_axis, n_shards=n_sp, mesh=mesh)

    n_run = layer + 1 if facet == "token" else layer
    for blk in model.blocks[:n_run]:
        x = blk(x, attn_fn=ring)
    if facet != "token":
        off = FACET_OFFSETS[facet] * d
        x = model.blocks[layer](x, qkv_only=True)[..., off:off + d]
    x = tp_gather(x.transpose(0, 1).contiguous(), mesh, sp_axis).transpose(0, 1)[:, :t]
    return tp_gather(x.contiguous(), mesh, data_axis)[:n_imgs]


def _check(cfg: ViTConfig, layer: int, facet: str) -> None:
    if facet not in ("query", "key", "value", "token"):
        raise ValueError(f"sp route supports q/k/v/token, got {facet}")
    if not 0 <= layer < cfg.depth:
        raise ValueError(f"layer {layer} out of range [0, {cfg.depth})")
    if cfg.quant is not None:
        raise ValueError("sequence parallelism uses the unfused block path; run with quant=None "
                         "(the fused int8 kernels are single-device)")


def sp_facet_extract(
    cfg: ViTConfig,
    params: Mapping,
    imgs,
    mesh,
    layer: int,
    facet: str = "value",
    *,
    data_axis: str = "data",
    sp_axis: str = "model",
    device: Union[None, str, torch.device] = None,
) -> torch.Tensor:
    """Facet extraction with the activations token-sharded over
    ``mesh[sp_axis]`` and batch-sharded over ``mesh[data_axis]``: equal to
    ``ViT.forward(imgs, capture_layer=layer, capture_facet=facet)`` on
    ``params`` (the trunk's state dict), on ``device`` (None: the card).
    When a tensor of ``params`` (or ``imgs``) requires a gradient under
    grad mode, the result carries the gradient of a loss replicated over
    every rank back to them (module docstring)."""
    from torch.func import functional_call

    from anyloc_tpu_torch.models.convert import maybe_tp_split
    from anyloc_tpu_torch.models.vit import ViT
    from anyloc_tpu_torch.parallel.pp import (_cast, _template, _wants_grad, summed_over_mesh,
                                              trunk_tensors)

    _check(cfg, layer, facet)
    dev = resolve_device(device)
    grad = _wants_grad(params, imgs)
    sd = trunk_tensors(params, layer, facet)
    if grad:
        sd, imgs, _ = summed_over_mesh(sd, imgs, mesh)
    sd = maybe_tp_split(sd, cfg)
    vit_t = _template(lambda: ViT(cfg, layer + 1))

    class _Trunk(torch.nn.Module):       # functional_call runs forward: the trunk's own
        def __init__(self):
            super().__init__()
            self.vit = vit_t

        def forward(self, x):
            return _sp_trunk(self.vit, x, mesh, layer, facet, data_axis, sp_axis, dev)

    with contextlib.nullcontext() if grad else torch.no_grad():
        tensors = {f"vit.{k}": v for k, v in _cast(vit_t, sd, dev).items()}
        return functional_call(_Trunk(), tensors, (imgs,))


class SPFacetExtractor:
    """An extractor (``ViTFacetExtractor``'s interface: ``_forward``,
    ``__call__``, ``supports_uint8``) whose trunk runs sequence-parallel
    over ``mesh``: tokens sharded on ``sp_axis``, images on ``data_axis``.
    It plugs into ``DescriptorEngine`` and the pipelines unchanged (with
    the engine's ``mesh=None``: the sharding lives in here); every rank
    makes the same calls. ``params``: the trunk's state dict, or None for
    random weights from ``seed``. ``device`` None means the card."""

    supports_uint8 = True

    def __init__(self, cfg: ViTConfig, params: Optional[Mapping], layer: int,
                 facet: str = "value", mesh=None, *, use_cls: bool = False,
                 norm_descs: bool = True, data_axis: str = "data", sp_axis: str = "model",
                 device: Union[None, str, torch.device] = None, seed: int = 42) -> None:
        from anyloc_tpu_torch.models.dinov2 import build_vit, init_params

        if mesh is None:
            raise ValueError("SPFacetExtractor requires a mesh")
        _check(cfg, layer, facet)
        self.cfg, self.layer, self.facet = cfg, layer, facet
        self.use_cls, self.norm_descs = use_cls, norm_descs
        self.mesh, self.data_axis, self.sp_axis = mesh, data_axis, sp_axis
        self.device = resolve_device(device)
        if params is None:
            params = init_params(cfg, seed, n_blocks=layer + 1, device=self.device)
        self.model = build_vit(cfg, params, layer + 1, device=self.device)

    @torch.inference_mode()
    def _forward(self, params, imgs) -> torch.Tensor:
        """[B, H, W, 3] images (uint8: normalized on the device) -> [B, N
        (+1 with ``use_cls``), D] float32 facets; ``params`` is None (the
        module holds its weights)."""
        from anyloc_tpu_torch.data.transforms import device_normalize

        if params is not None:
            raise ValueError("the port's extractor holds its weights: pass params=None")
        imgs = torch.as_tensor(imgs).to(self.device)
        if imgs.dtype == torch.uint8:
            imgs = device_normalize(imgs)
        out = _sp_trunk(self.model, imgs, self.mesh, self.layer, self.facet, self.data_axis,
                        self.sp_axis, self.device)
        skip = self.cfg.num_prefix_tokens
        if self.use_cls:
            if self.cfg.num_register_tokens:
                out = torch.cat([out[:, :1], out[:, skip:]], dim=1)
        else:
            out = out[:, skip:]
        out = out.float()
        return l2_normalize(out) if self.norm_descs else out

    def __call__(self, imgs) -> torch.Tensor:
        if imgs.ndim == 3:
            imgs = imgs[None]
        return self._forward(None, imgs)
