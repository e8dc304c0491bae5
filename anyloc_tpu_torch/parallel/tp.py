"""Tensor parallelism for the ViT trunk (counterpart of
``anyloc_tpu/parallel/tp.py``), Megatron's layout over the mesh's
``model`` axis.

With ``ViTConfig(tp_split=True)`` the trunk stores its big matrices apart
(wq / wk / wv, SwiGLU w1 / w2), and ``shard_vit_tp`` keeps on each rank:

  * wq / wk / wv, w1 / w2 and fc1 column-parallel: the rank's block of
    output rows (torch's [out, in]) and bias; heads are column-minor, so
    a contiguous block holds whole heads when the axis divides them;
  * proj, w3 and fc2 row-parallel: the rank's block of input columns;
    each rank's partial product is summed by an ``all_reduce`` and the
    replicated bias added after it (what GSPMD inserts for the JAX
    package).

Each rank's attention over its own heads is K2 on the card. Under
autograd (training, F24) the replicated tokens enter the column-parallel
products through ``tp_copy`` (their cotangent all-reduced over ``model``)
and the row-parallel sums leave through ``tp_reduce`` (identity
backward), Megatron's f and g: every rank then gets the one-process
gradient of each replicated parameter and of its own shards, and K2
carries its gradient (the plain version's, ``FlashAttentionGrad``). The fused
[D, 3D] / [D, 2H] layouts cannot shard head- and gate-aligned, so a
trunk without ``tp_split`` has no tensor parallelism; a quantized trunk
stays replicated, as the JAX package's shardings leave its int8 kernels
(``kernel_q`` matches none of its patterns).
"""

from __future__ import annotations

from typing import Mapping, Union

import torch
import torch.nn.functional as F
from torch import nn

from anyloc_tpu_torch.ops.common import bf16_dot
from anyloc_tpu_torch.parallel.mesh import axis_index, axis_size, tp_copy, tp_gather, tp_reduce

_SPLITS = {"attn.qkv.": ("attn.wq.", "attn.wk.", "attn.wv."),
           "mlp.w12.": ("mlp.w1.", "mlp.w2.")}
_COLUMN = ("wq", "wk", "wv", "w1", "w2", "fc1")
_ROW = ("proj", "w3", "fc2")


def split_fused_params(params: Mapping[str, torch.Tensor]) -> dict:
    """A state dict in the fused layout (``attn.qkv.*`` [3D, D], SwiGLU
    ``mlp.w12.*`` [2H, D], quantized ``weight_q`` / ``weight_scale``
    included) -> the ``tp_split`` layout (``attn.wq / wk / wv.*``,
    ``mlp.w1 / w2.*``): each split along the output rows, the same split
    ``maybe_tp_split`` applies to the converters' dicts. Other entries
    pass unchanged; an already split dict comes back as it is."""
    out = {}
    for key, v in params.items():
        fused = next((f for f in _SPLITS if f in key), None)
        if fused is None:
            out[key] = v
            continue
        names = _SPLITS[fused]
        for part, name in zip(torch.as_tensor(v).chunk(len(names), dim=0), names):
            out[key.replace(fused, name)] = part.contiguous()
    return out


def shard_vit_tp(model: nn.Module, mesh, axis: str = "model") -> nn.Module:
    """Shard a ``tp_split`` ``ViT`` in place over ``axis`` (the counterpart
    of ``vit_tp_shardings``; module docstring): each block keeps its
    rank's shards and runs ``tp_block_forward``. A quantized trunk is left
    replicated. Returns ``model``."""
    c = model.cfg
    if not c.tp_split:
        raise ValueError("tensor parallelism needs ViTConfig(tp_split=True): the fused qkv / "
                         "w12 layouts cannot shard head- and gate-aligned")
    if c.quant is not None:
        return model
    n, r = axis_size(mesh, axis), axis_index(mesh, axis)
    if c.num_heads % n or c.mlp_hidden % n:
        raise ValueError(f"the {axis!r} axis ({n}) must divide the heads ({c.num_heads}) and "
                         f"the MLP hidden width ({c.mlp_hidden})")
    for blk in model.blocks:
        for parent in (blk.attn, blk.mlp):
            for name, lin in parent.named_children():
                if name in _COLUMN:
                    part = lin.out_features // n
                    lin.weight = _shard(lin.weight, lin.weight[r * part:(r + 1) * part])
                    if lin.bias is not None:
                        lin.bias = _shard(lin.bias, lin.bias[r * part:(r + 1) * part])
                    lin.out_features = part
                elif name in _ROW:
                    part = lin.in_features // n
                    lin.weight = _shard(lin.weight, lin.weight[:, r * part:(r + 1) * part])
                    lin.in_features = part
        blk.tp = (mesh, axis)
    return model


def _shard(param: nn.Parameter, part: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(part.detach().clone(memory_format=torch.contiguous_format),
                        requires_grad=param.requires_grad)


def _row_parallel(lin: nn.Linear, x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The rank's partial product (float32 sums of the trunk-dtype
    operands) summed over ``axis`` ("g"), plus the replicated bias:
    float32."""
    x2 = x.reshape(-1, x.shape[-1])
    part = bf16_dot(x2, lin.weight.T) if x.dtype == torch.bfloat16 else F.linear(x2, lin.weight)
    y = tp_reduce(part.float(), mesh, axis).view(*x.shape[:-1], -1)
    return y + lin.bias.float() if lin.bias is not None else y


def tp_block_forward(blk: nn.Module, x: torch.Tensor, qkv_only: bool = False) -> torch.Tensor:
    """One tensor-parallel block on the replicated tokens ``x`` [B, N, D]:
    the rank's heads (K2 on the card) and MLP columns, the row-parallel
    products all-reduced. ``qkv_only`` returns the fused [B, N, 3D] qkv,
    the ranks' heads all-gathered into the facet layout."""
    from anyloc_tpu_torch.models.vit import layer_norm
    from anyloc_tpu_torch.ops.kernels import flash_attention

    c = blk.cfg
    mesh, axis = blk.tp
    n = axis_size(mesh, axis)
    b, t, d = x.shape
    a = blk.attn
    h = tp_copy(layer_norm(c, blk.norm1, x), mesh, axis)     # "f"
    q, k, v = a.wq(h), a.wk(h), a.wv(h)              # [B, N, D/n]: the rank's heads
    if qkv_only:
        parts = tp_gather(torch.stack([q, k, v]), mesh, axis)   # [n·3, B, N, D/n]
        return parts.view(n, 3, b, t, d // n).permute(2, 3, 1, 0, 4).reshape(b, t, 3 * d)
    hd = c.head_dim

    def heads(z):
        return z.view(b, t, z.shape[-1] // hd, hd).transpose(1, 2)

    o = flash_attention(heads(q), heads(k), heads(v)).transpose(1, 2).reshape(b, t, d // n)
    # the attention half's tail in float32, rounded once, as K5 ends the
    # fused trunk's: projection + bias, LayerScale, residual
    y = _row_parallel(a.proj, o, mesh, axis)
    if blk.gamma(1) is not None:
        y = y * blk.gamma(1).float()
    x = (x.float() + y).to(x.dtype)
    h = tp_copy(layer_norm(c, blk.norm2, x), mesh, axis)     # "f"
    mlp = blk.mlp
    if hasattr(mlp, "w1"):
        y = _row_parallel(mlp.w3, mlp.gates(h), mesh, axis)
    else:
        y = _row_parallel(mlp.fc2, mlp.act(mlp.fc1(h)), mesh, axis)
    # the MLP's output rounded once (a Linear's bias epilogue), then the
    # fused trunk's LayerScale and residual in the trunk dtype
    return x + blk._scale(2, y.to(x.dtype))


def vit_tp_shardings(params: Mapping[str, torch.Tensor], mesh, axis: str = "model") -> dict:
    """{name: ``fsdp.Sharding``} of the state dict ``params`` of a trunk
    ``shard_vit_tp`` sharded (any prefix): the column-parallel weights and
    biases split along dim 0, the row-parallel weights along dim 1 (torch's
    [out, in]), everything else replicated; the layout of the JAX
    ``vit_tp_shardings``, which the FSDP checkpoint reads to put the
    shards back together."""
    import re

    from anyloc_tpu_torch.parallel.fsdp import Sharding

    col = re.compile(r"(?:^|\.)(?:attn\.(?:wq|wk|wv)|mlp\.(?:w1|w2|fc1))\.(?:weight|bias)$")
    row = re.compile(r"(?:^|\.)(?:attn\.proj|mlp\.(?:w3|fc2))\.weight$")
    out = {}
    for name, t in params.items():
        dim = 0 if col.search(name) else 1 if row.search(name) else None
        spec = () if dim is None else tuple(axis if d == dim else None for d in range(t.dim()))
        out[name] = Sharding(mesh, spec)
    return out


def params_bytes_per_device(params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> int:
    """Bytes of parameters and buffers this rank holds: a module's
    (``shard_vit_tp`` leaves each rank its shards) or a state dict's. The
    tensor-parallel footprint check."""
    tensors = (list(params.state_dict().values()) if isinstance(params, nn.Module)
               else list(params.values()))
    return sum(t.numel() * t.element_size() for t in tensors)
