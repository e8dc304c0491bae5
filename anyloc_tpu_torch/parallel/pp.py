"""Pipeline parallelism for the ViT trunk (counterpart of
``anyloc_tpu/parallel/pp.py``): GPipe microbatching over the mesh's
``model`` axis.

Stage ``s`` of ``S`` holds a contiguous run of K = ceil(n_run / S) blocks
and nothing of the others, so a rank's block bytes drop to ~1/S. With M
microbatches the schedule runs M + S - 1 steps; at each step a stage with
a microbatch runs its blocks on it, and every stage passes its output to
the next by one ``shift`` (``batch_isend_irecv``, the send and the
receive posted together). The last stage's outputs reach every rank of
its row by a broadcast (the JAX package sums the masked emissions). The
embedding and the captured block's norm1 + qkv run outside the pipeline,
on every rank, as in the JAX package.

Facets follow ``ViT.forward``: query / key / value run blocks 0..layer-1
through the pipeline, then block ``layer``'s norm1 + qkv; "token" runs
blocks 0..layer through it. The output equals the blocks run in sequence.

The stages run functionally over the caller's tensors
(``torch.func.functional_call`` on meta-device templates), so a trunk
whose tensors require a gradient trains through the pipeline, as
``jax.grad`` passes through the JAX package's ``lax.scan`` + ``ppermute``
(F25). Under autograd the loss is one replicated over every rank: the
stage hand-offs are ``shift_grad`` (their cotangents go back a stage), the
last stage's broadcast is ``broadcast_grad``, the gather over ``data`` is
``tp_gather``, and the trunk's tensors enter through ``sum_grads``, which
sums what each rank computed of their gradients (a stage its blocks, a
data row its images) over the mesh, so that every rank holds the gradient
one process would compute. The capture block's tensors count on the last
stage only. Whether a collective carries a gradient is decided once per
call, from ``params`` and ``imgs``, which are the same on every rank: the
embedded images carry an ``anchor`` of every ``sum_grads`` output, so
every rank's hand-offs carry a gradient also where its own stage is
frozen, and every stage keeps each hand-off it received reachable from
its output, so that every rank runs the backward of every collective its
neighbours run. With nothing to differentiate it runs under
``torch.no_grad()``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from anyloc_tpu_torch.models.convert import tensor
from anyloc_tpu_torch.models.vit import FACET_OFFSETS, Block, ViT, ViTConfig
from anyloc_tpu_torch.ops.common import cdiv, resolve_device
from anyloc_tpu_torch.parallel.mesh import (
    anchor,
    axis_index,
    axis_size,
    broadcast_grad,
    shard_rows,
    shift_grad,
    sum_grads,
    tp_gather,
)

Stacked = Tuple[Dict[str, torch.Tensor], np.ndarray, int]


def _block_names(params: Mapping) -> list:
    return [k[len("blocks.0."):] for k in params if k.startswith("blocks.0.")]


def stack_stage_params(params: Mapping, n_run: int, n_stages: int) -> Stacked:
    """Blocks 0..n_run-1 of the trunk's state dict stacked into ``[S·K,
    ...]`` tensors keyed by the block-relative name (K = ceil(n_run / S));
    slots past ``n_run`` repeat block 0 as inert fillers. Returns
    ``(stacked, active mask [S·K], K)``."""
    k_per = cdiv(n_run, n_stages)
    total = k_per * n_stages
    stacked = {name: torch.stack([tensor(params[f"blocks.{i if i < n_run else 0}.{name}"])
                                  for i in range(total)])
               for name in _block_names(params)}
    return stacked, np.arange(total) < n_run, k_per


def stage_params(stacked: Stacked, mesh, stage_axis: str = "model") -> Stacked:
    """This rank's stage of a stacked tree: its ``[K, ...]`` rows (the
    counterpart of ``stage_shardings``: each stage's blocks on its rank)."""
    tree, mask, k_per = stacked
    s = axis_index(mesh, stage_axis)
    rows = slice(s * k_per, (s + 1) * k_per)
    return {name: t[rows] for name, t in tree.items()}, mask[rows], k_per


def _template(make) -> nn.Module:
    """A module built on the meta device, in eval mode: its tensors come
    from ``functional_call``."""
    with torch.device("meta"):
        return make().eval()


def _cast(module: nn.Module, sd: Mapping, device) -> Dict[str, torch.Tensor]:
    """``sd``'s tensors on ``device``, each in the type ``module``
    declares for it (differentiable casts)."""
    declared = {**dict(module.named_parameters()), **dict(module.named_buffers())}
    return {k: tensor(v).to(device=device, dtype=declared[k].dtype) for k, v in sd.items()}


def data_rows(imgs, mesh, data_axis: str):
    """(this rank's block of the images (numpy or a tensor) along
    ``data_axis``, zero rows padding the batch to the axis, as a tensor;
    the batch). Differentiable."""
    imgs = tensor(imgs)
    n, n_data = imgs.shape[0], axis_size(mesh, data_axis)
    pad = (-n) % n_data
    if pad:
        imgs = torch.cat([imgs, imgs.new_zeros((pad,) + tuple(imgs.shape[1:]))])
    return shard_rows(imgs, mesh, data_axis), n


def trunk_tensors(params: Mapping, layer: int, facet: str) -> Dict[str, torch.Tensor]:
    """The tensors of the trunk's state dict ``params`` (the port's
    naming) that the facet of block ``layer`` reads: the embedding, blocks
    0..layer-1, and block ``layer`` whole ("token") or its norm1 + qkv."""
    from anyloc_tpu_torch.models.dinov2 import native_state_dict

    cap = f"blocks.{layer}."
    return {k: v for k, v in native_state_dict(params, layer + 1).items()
            if facet == "token" or not k.startswith(cap)
            or k.startswith((cap + "norm1.", cap + "attn.qkv."))}


def _wants_grad(params: Mapping, imgs) -> bool:
    return torch.is_grad_enabled() and (
        any(isinstance(v, torch.Tensor) and v.requires_grad for v in params.values())
        or (isinstance(imgs, torch.Tensor) and imgs.requires_grad))


def summed_over_mesh(sd: Mapping, imgs, mesh):
    """(``sd``, ``imgs``, the ``sum_grads`` outputs) with each tensor that
    requires a gradient passed through one ``sum_grads`` over every rank of
    ``mesh``."""
    live = [k for k, v in sd.items() if isinstance(v, torch.Tensor) and v.requires_grad]
    with_imgs = isinstance(imgs, torch.Tensor) and imgs.requires_grad
    out = sum_grads([sd[k] for k in live] + ([imgs] if with_imgs else []), mesh, None)
    return {**sd, **dict(zip(live, out))}, (out[-1] if with_imgs else imgs), out


def pipeline_facet_extract(
    cfg: ViTConfig,
    params: Mapping,
    imgs,
    mesh,
    layer: int,
    facet: str = "value",
    *,
    n_micro: Optional[int] = None,
    data_axis: str = "data",
    stage_axis: str = "model",
    stacked: Optional[Stacked] = None,
    device: Union[None, str, torch.device] = None,
) -> torch.Tensor:
    """Facet extraction with the trunk's blocks pipelined over
    ``mesh[stage_axis]`` and the images sharded over ``mesh[data_axis]``:
    equal to ``ViT.forward(imgs, capture_layer=layer, capture_facet=facet)``
    on ``params`` (the trunk's state dict), [B, P+N, D] on ``device``
    (None: the card), the same on every rank. ``stacked``:
    ``stack_stage_params(...)`` or its ``stage_params`` (this rank's rows)
    to reuse across calls. ``n_micro`` defaults to the largest divisor of
    the per-rank batch up to 2S.

    When a tensor of ``params`` (or ``imgs``) requires a gradient under
    grad mode, the result carries the gradient of a loss replicated over
    every rank back to them, summed over the mesh (module docstring; one
    call per backward, and ``stacked`` None: the stages are read from
    ``params``)."""
    if facet not in ("query", "key", "value", "token"):
        raise ValueError(f"pipeline route supports q/k/v/token, got {facet}")
    grad = _wants_grad(params, imgs)
    if grad and stacked is not None:
        raise ValueError("under autograd the stages are read from params: pass stacked=None")
    with contextlib.nullcontext() if grad else torch.no_grad():
        return _pipeline(cfg, params, imgs, mesh, layer, facet, n_micro, data_axis, stage_axis,
                         stacked, resolve_device(device), grad)


def _pipeline(cfg, params, imgs, mesh, layer, facet, n_micro, data_axis, stage_axis, stacked,
              dev, grad) -> torch.Tensor:
    n_stages, s = axis_size(mesh, stage_axis), axis_index(mesh, stage_axis)
    n_run = layer + 1 if facet == "token" else layer
    block_t = _template(lambda: Block(cfg))
    vit_t = _template(lambda: ViT(cfg, 1))
    sd = trunk_tensors(params, layer, facet)
    if grad:
        sd, imgs, summed = summed_over_mesh(sd, imgs, mesh)
    if stacked is None:
        k_per = cdiv(n_run, n_stages)
        stage = [{name[len(f"blocks.{i}."):]: v for name, v in sd.items()
                  if name.startswith(f"blocks.{i}.")}
                 for i in range(s * k_per, min((s + 1) * k_per, n_run))]
    else:
        tree, mask, k_per = stacked
        if next(iter(tree.values())).shape[0] != k_per:
            tree, mask, k_per = stage_params(stacked, mesh, stage_axis)
        stage = [{name: t[j] for name, t in tree.items()} for j in range(k_per) if mask[j]]
    stage = [_cast(block_t, row, dev) for row in stage]
    local, n_imgs = data_rows(imgs, mesh, data_axis)
    b_loc = local.shape[0]
    if n_micro is None:
        n_micro = max(d for d in range(1, min(b_loc, 2 * n_stages) + 1) if b_loc % d == 0)
    if b_loc % n_micro:
        raise ValueError(f"per-rank batch {b_loc} must divide into n_micro={n_micro}")

    embed = _cast(vit_t, {k: v for k, v in sd.items() if not k.startswith("blocks.")}, dev)
    x = functional_call(vit_t, embed, (local.to(dev),), {"embed_only": True})
    if grad:
        # every rank's activations and hand-offs carry a gradient, whatever
        # of the trunk its own stage trains, so that each rank builds (and
        # runs the backward of) every collective its neighbours do
        x = x + anchor(*summed)
    micro = x.reshape(n_micro, b_loc // n_micro, *x.shape[1:])
    state = torch.zeros_like(micro[0])
    if grad:
        state = state + anchor(micro)
    outs, handoffs = [], []
    n_steps = n_micro + n_stages - 1
    for t in range(n_steps):
        y = micro[min(t, n_micro - 1)] if s == 0 else state
        if s <= t < s + n_micro:    # this stage holds microbatch t - s
            for row in stage:
                y = functional_call(block_t, row, (y,))
            if s == n_stages - 1:
                outs.append(y)
        if t < n_steps - 1:
            state = shift_grad(y, mesh, stage_axis, wrap=False)   # stage 0 receives zeros
            handoffs.append(state)
    out = torch.cat(outs) if outs else torch.zeros_like(x)
    if grad:
        out = out + anchor(*handoffs)
    out = broadcast_grad(out, mesh, stage_axis, n_stages - 1)
    if facet != "token":
        cap = {name[len(f"blocks.{layer}."):]: v for name, v in sd.items()
               if name.startswith(f"blocks.{layer}.")}
        if s != n_stages - 1:   # its gradient counts on the last stage alone
            cap = {k: v.detach() for k, v in cap.items()}
        off = FACET_OFFSETS[facet] * cfg.embed_dim
        qkv = functional_call(block_t, _cast(block_t, cap, dev), (out,), {"qkv_only": True})
        out = qkv[..., off:off + cfg.embed_dim]
    return tp_gather(out.contiguous(), mesh, data_axis)[:n_imgs]


def pipeline_params_bytes_per_device(stacked_sharded: Union[Stacked, Mapping]) -> int:
    """Bytes of block parameters this rank holds: a ``stage_params`` stage
    (or its tree). The pipeline footprint check, as
    ``tp.params_bytes_per_device`` is tensor parallelism's."""
    from anyloc_tpu_torch.parallel.tp import params_bytes_per_device

    tree = stacked_sharded[0] if isinstance(stacked_sharded, tuple) else stacked_sharded
    return params_bytes_per_device(tree)
