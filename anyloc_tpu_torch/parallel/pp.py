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
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from anyloc_tpu_torch.models.convert import tensor
from anyloc_tpu_torch.models.vit import FACET_OFFSETS, Block, ViTConfig
from anyloc_tpu_torch.ops.common import cdiv, resolve_device
from anyloc_tpu_torch.parallel.mesh import (
    all_gather,
    axis_index,
    axis_size,
    broadcast,
    pad_to_multiple,
    shard_rows,
    shift,
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


def _blocks(cfg: ViTConfig, rows: Sequence[Dict[str, torch.Tensor]], device) -> nn.ModuleList:
    """Blocks holding ``rows`` (block-relative state dicts), each tensor in
    the type its module declares, frozen and in eval mode."""
    with torch.device("meta"):
        blocks = nn.ModuleList([Block(cfg) for _ in rows])
    declared = {**dict(blocks.named_parameters()), **dict(blocks.named_buffers())}
    sd = {f"{j}.{name}": t for j, row in enumerate(rows) for name, t in row.items()}
    sd = {k: v.to(declared[k].dtype) for k, v in sd.items()}
    blocks.load_state_dict(sd, strict=True, assign=True)
    return blocks.to(device).requires_grad_(False).eval()


def data_rows(imgs, mesh, data_axis: str):
    """(this rank's block of the images along ``data_axis``, the batch)."""
    imgs = np.asarray(imgs) if not isinstance(imgs, torch.Tensor) else imgs.cpu().numpy()
    padded, n = pad_to_multiple(imgs, axis_size(mesh, data_axis))
    return shard_rows(padded, mesh, data_axis), n


def _embed(cfg: ViTConfig, params: Mapping, imgs: np.ndarray, device) -> torch.Tensor:
    from anyloc_tpu_torch.models.dinov2 import build_vit

    return build_vit(cfg, params, 1, device=device).embed(torch.from_numpy(imgs).to(device))


@torch.inference_mode()
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
    the per-rank batch up to 2S."""
    if facet not in ("query", "key", "value", "token"):
        raise ValueError(f"pipeline route supports q/k/v/token, got {facet}")
    dev = resolve_device(device)
    n_stages, s = axis_size(mesh, stage_axis), axis_index(mesh, stage_axis)
    n_run = layer + 1 if facet == "token" else layer
    local, n_imgs = data_rows(imgs, mesh, data_axis)
    b_loc = local.shape[0]
    if n_micro is None:
        n_micro = max(d for d in range(1, min(b_loc, 2 * n_stages) + 1) if b_loc % d == 0)
    if b_loc % n_micro:
        raise ValueError(f"per-rank batch {b_loc} must divide into n_micro={n_micro}")
    if stacked is None:
        stacked = stack_stage_params(params, n_run, n_stages)
    tree, mask, k_per = stacked
    if next(iter(tree.values())).shape[0] != k_per:
        tree, mask, k_per = stage_params(stacked, mesh, stage_axis)
    rows = [{name: t[j] for name, t in tree.items()} for j in range(k_per) if mask[j]]
    blocks = _blocks(cfg, rows, dev)

    x = _embed(cfg, params, local, dev)
    micro = x.reshape(n_micro, b_loc // n_micro, *x.shape[1:])
    state, outs = torch.zeros_like(micro[0]), []
    for t in range(n_micro + n_stages - 1):
        y = micro[min(t, n_micro - 1)] if s == 0 else state
        if s <= t < s + n_micro:    # this stage holds microbatch t - s
            for blk in blocks:
                y = blk(y)
            if s == n_stages - 1:
                outs.append(y)
        state = shift(y, mesh, stage_axis, wrap=False)   # stage 0 receives None
    out = torch.cat(outs) if outs else torch.empty_like(x)
    out = broadcast(out, mesh, stage_axis, n_stages - 1)
    if facet != "token":
        cap = _blocks(cfg, [{name: tensor(params[f"blocks.{layer}.{name}"]).to(dev)
                             for name in _block_names(params)}], dev)[0]
        off = FACET_OFFSETS[facet] * cfg.embed_dim
        out = cap(out, qkv_only=True)[..., off:off + cfg.embed_dim]
    return all_gather(out.contiguous(), mesh, data_axis)[:n_imgs]


def pipeline_params_bytes_per_device(stacked_sharded: Union[Stacked, Mapping]) -> int:
    """Bytes of block parameters this rank holds: a ``stage_params`` stage
    (or its tree). The pipeline footprint check, as
    ``tp.params_bytes_per_device`` is tensor parallelism's."""
    from anyloc_tpu_torch.parallel.tp import params_bytes_per_device

    tree = stacked_sharded[0] if isinstance(stacked_sharded, tuple) else stacked_sharded
    return params_bytes_per_device(tree)
