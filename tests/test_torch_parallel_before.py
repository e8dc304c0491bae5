"""The forwards of the port's pipeline, ring and expert layers as they
were before they carried gradients (F25): ``pipeline_facet_extract``,
``ring_attention`` / ``sp_facet_extract`` and ``ep_vlad_aggregate`` on
frozen modules under ``inference_mode``, with the generic collectives.
``tests/test_torch_parallel_grad.py`` holds the port's outputs without a
gradient bit-equal to them on the same ranks (``case_before``, a
``mesh_checks`` case); this module holds no test of its own."""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from anyloc_tpu_torch.models.convert import tensor
from anyloc_tpu_torch.models.vit import FACET_OFFSETS, Block, ViTConfig
from anyloc_tpu_torch.ops.common import cdiv, resolve_device
from anyloc_tpu_torch.parallel.mesh import (
    all_gather,
    all_to_all,
    axis_index,
    axis_size,
    broadcast,
    pad_to_multiple,
    shard_rows,
    shift,
)
from anyloc_tpu_torch.parallel.sp import _check

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


_NEG = -1e30


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_mask: torch.Tensor,
                   *, axis_name: str = "model", n_shards: Optional[int] = None,
                   mesh) -> torch.Tensor:
    """Exact attention with K / V sharded over ``axis_name``: q / k / v are
    this rank's token shard [B, H, n_loc, hd], ``kv_mask`` [n_loc] marks its
    real keys (False: padding). ``n_shards`` ring steps of (online-softmax
    update; K / V / mask passed on) give softmax(q·kᵀ·scale)·v over the
    whole sequence, accumulated in float32."""
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
            kv = shift(kv, mesh, axis_name)
            msk = shift(msk.to(torch.uint8), mesh, axis_name)
    return (acc / torch.clamp_min(el, 1e-30)).to(q.dtype)


def _sp_trunk(model, imgs, mesh, layer: int, facet: str, data_axis: str,
              sp_axis: str) -> torch.Tensor:
    """The truncated trunk ``model`` (blocks 0..layer) with the images
    sharded over ``data_axis`` and the tokens over ``sp_axis``; returns
    [B, P+N, D] (the facet, or block ``layer``'s output for "token") on
    every rank."""
    dev = next(model.parameters()).device
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
    x = all_gather(x.transpose(0, 1).contiguous(), mesh, sp_axis).transpose(0, 1)[:, :t]
    return all_gather(x.contiguous(), mesh, data_axis)[:n_imgs]


@torch.inference_mode()
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
    ``params`` (the trunk's state dict), on ``device`` (None: the card)."""
    from anyloc_tpu_torch.models.dinov2 import build_vit

    _check(cfg, layer, facet)
    model = build_vit(cfg, params, layer + 1, device=resolve_device(device))
    return _sp_trunk(model, imgs, mesh, layer, facet, data_axis, sp_axis)


def _tensor(x, device) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x)).to(device)


def ep_vlad_aggregate(
    descs,
    route,
    experts,
    mesh,
    *,
    capacity_factor: float = 1.25,
    data_axis: str = "data",
    expert_axis: str = "model",
    **vlad_kw,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed VLAD: image ``i`` aggregated against expert ``route[i]``.

    Every rank passes the whole ``descs`` [B, T, D], ``route`` [B] and
    ``experts`` [E, C, D] (tensors stay on their device; numpy goes to the
    card) and takes its block: B / (n_data · n_exp) images (chip order,
    data-major) and E / n_exp experts along ``expert_axis``. Each rank
    fills a [n_exp, capacity, T, D] dispatch buffer (capacity =
    ceil(B_loc · capacity_factor / n_exp) slots per target),
    ``all_to_all``s it along its expert row, aggregates the images it
    receives against its experts (``vlad_aggregate`` with ``vlad_kw``),
    and ``all_to_all``s the [capacity, C·D] results back.

    Returns ``(vlads [B, C·D], kept [B] bool)``, the same on every rank:
    images beyond a target's capacity, and routes outside [0, E), come back
    as zeros with kept=False (the MoE overflow contract; a zero descriptor
    is never marked valid). ``capacity_factor`` >= n_exp makes dropping
    impossible."""
    from anyloc_tpu_torch.ops.vlad import vlad_aggregate

    dev = descs.device if isinstance(descs, torch.Tensor) else resolve_device(None)
    descs, route, experts = (_tensor(a, dev) for a in (descs, route, experts))
    n_exp, n_data = axis_size(mesh, expert_axis), axis_size(mesh, data_axis)
    e_total, n_clusters, d = experts.shape
    if e_total % n_exp:
        raise ValueError(f"experts ({e_total}) must divide the {expert_axis!r} axis ({n_exp})")
    e_loc = e_total // n_exp
    b = descs.shape[0]
    n_chips = n_data * n_exp
    if b % n_chips:
        raise ValueError(f"batch ({b}) must divide the mesh ({n_chips})")
    b_loc = b // n_chips
    capacity = max(1, int(math.ceil(b_loc * capacity_factor / n_exp)))
    chip = axis_index(mesh, data_axis) * n_exp + axis_index(mesh, expert_axis)
    x = descs[chip * b_loc:(chip + 1) * b_loc]
    r = route[chip * b_loc:(chip + 1) * b_loc].long()
    mine = experts[axis_index(mesh, expert_axis) * e_loc:][:e_loc]

    # the dispatch plan: each image's target rank and its slot there
    in_range = (r >= 0) & (r < e_total)
    target = torch.where(in_range, r // e_loc, 0)
    onehot = F.one_hot(target, n_exp) * in_range[:, None]
    pos = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
    kept = (pos < capacity) & in_range
    sel = kept.nonzero()[:, 0]
    buf = x.new_zeros((n_exp, capacity) + tuple(x.shape[1:]))
    slot_e = torch.full((n_exp, capacity), -1, dtype=torch.int64, device=dev)
    buf[target[sel], pos[sel]] = x[sel]
    slot_e[target[sel], pos[sel]] = r[sel] % e_loc
    got = all_to_all(buf.flatten(0, 1), mesh, expert_axis)      # [n_src · cap, T, D]
    got_e = all_to_all(slot_e.flatten(), mesh, expert_axis)

    # aggregate what came in against the local experts (empty slots stay 0)
    y = torch.zeros((n_exp * capacity, n_clusters * d), dtype=torch.float32, device=dev)
    for j in range(e_loc):
        rows = (got_e == j).nonzero()[:, 0]
        if rows.numel():
            y[rows] = vlad_aggregate(got[rows], mine[j], **vlad_kw).float()
    back = all_to_all(y, mesh, expert_axis).view(n_exp, capacity, -1)   # at the source
    out = torch.zeros((b_loc, n_clusters * d), dtype=torch.float32, device=dev)
    out[sel] = back[target[sel], pos[sel]]
    return all_gather(out, mesh, None), all_gather(kept.to(torch.uint8), mesh, None).bool()


def case_before(r) -> None:
    """``mesh_checks``' case: the inputs of its ``pp``, ``sp`` and ``ep``
    cases ("small") through the functions above, under the same names."""
    from anyloc_tpu_torch.tools import mesh_checks as mc

    mesh = mc._pp_sp_mesh(r)
    cfg = mc.vit_config(r.profile)
    t = mc.TRUNK[r.profile]
    params = mc.vit_params(cfg, 0, r.device)
    img = mc.images(r.profile, t["img"], t["batch"])
    for layer, facet in mc._facets(r):
        r.keep(f"pp_{layer}_{facet}", pipeline_facet_extract(cfg, params, img, mesh, layer, facet,
                                                             device=r.device))
    img = mc.images(r.profile, mc.SP_PX[r.profile], 4)
    for layer, facet in mc._facets(r):
        r.keep(f"sp_{layer}_{facet}", sp_facet_extract(cfg, params, img, mesh, layer, facet,
                                                       device=r.device))
    from anyloc_tpu_torch.parallel import get_mesh

    ring_mesh = get_mesh(1, r.world)
    inp = mc.inputs("sp", "small")
    loc = {n: shard_rows(torch.from_numpy(a).transpose(0, 2), ring_mesh, "model")
           .transpose(0, 2).to(r.device) for n, a in inp.items()}
    mask = shard_rows(torch.arange(16) < 11, ring_mesh, "model").to(r.device)
    with torch.inference_mode():
        got = ring_attention(loc["q"], loc["k"], loc["v"], mask, axis_name="model",
                             n_shards=r.world, mesh=ring_mesh)
        r.keep("ring", all_gather(got.transpose(0, 2).contiguous(), ring_mesh, "model")
               .transpose(0, 2))
    inp = {k: torch.from_numpy(v).to(r.device) for k, v in mc.inputs("ep", r.profile).items()}
    for name, route, cap in (("ample", "route", 8.0), ("tight", "route", 0.7),
                             ("oor", "route_oor", 8.0)):
        with torch.inference_mode():
            v, kept = ep_vlad_aggregate(inp["descs"], inp[route], inp["experts"], mesh,
                                        capacity_factor=cap)
        r.keep(f"ep_{name}_vlads", v)
        r.keep(f"ep_{name}_kept", kept)
