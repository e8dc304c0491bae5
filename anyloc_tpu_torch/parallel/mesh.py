"""Process groups, the (data, model) mesh and the collectives of the
sharded layers (counterpart of ``anyloc_tpu/parallel/mesh.py``).

The JAX package is single-controller: one process holds a ``Mesh`` of
devices and ``shard_map`` runs a body per device. PyTorch runs one
process per device over ``torch.distributed`` (SPMD): every rank calls the
same function with the same host inputs, runs the body for its own
coordinates on the mesh, and gets the same, replicated result. The mesh is
a ``DeviceMesh`` with the JAX axis names:

  * ``data``  shards images, descriptor sets and the retrieval database;
  * ``model`` shards the trunk (tensor, pipeline and sequence
    parallelism) and the expert banks.

The port's kernels take raw pointers through ctypes, so a ``DTensor``
cannot carry them: shards are plain local tensors and the collectives
below are explicit (``psum`` -> ``all_reduce``, ``all_gather`` ->
``all_gather_into_tensor``, ``ppermute`` -> ``batch_isend_irecv``,
``all_to_all`` -> ``all_to_all_single``, ``axis_index`` -> the rank's
coordinate). A Gloo group takes host tensors, so ``_buffer`` copies a card
tensor through host memory for it, and only for it: an NCCL group gets the
card's memory as it is.

NCCL refuses two ranks of one communicator on one card, so ranks that
share a card run a Gloo group (the CPU tests, and a one-card check of the
multi-rank paths); NCCL needs one card per rank.

Under autograd (F24) a collective's backward depends on where the loss
lives, which JAX reads from ``shard_map``'s replication types and the port
names at each call site:

  * tensor parallelism, one loss replicated over ``model`` (Megatron's
    pair): ``tp_reduce`` ("g", after a row-parallel product: ``all_reduce``
    forward, identity backward), ``tp_copy`` ("f", where replicated
    activations enter a column-parallel product: identity forward,
    ``all_reduce`` backward) and ``tp_gather`` (``all_gather`` forward, the
    rank's slice of the cotangent backward);
  * data parallelism, a loss per rank whose mean is the objective:
    ``sync_reduce`` (the statistics of cross-device BatchNorm:
    ``all_reduce`` forward and backward).

With grad mode off, or no input that requires a gradient, each runs as
the plain collective (``tp_copy`` as nothing). The generic
``all_reduce``, ``all_gather``, ``all_to_all``, ``broadcast`` and ``shift``
have no backward: given an input that requires a gradient with grad mode
on, they raise.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model")
_BOUND = contextvars.ContextVar("anyloc_tpu_torch_mesh", default=None)   # use_mesh


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: str = "nccl",
) -> None:
    """Join this process to the group: ``coordinator_address`` is
    "host:port" (a TCP store on that host) or a URL ("tcp://...",
    "file://..."), with the world size ``num_processes`` and this rank
    ``process_id``; None reads all three from a launcher's environment
    (``torchrun``'s MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK).
    ``backend`` "nccl" (one card per rank, each rank on the card of its
    local rank) or "gloo" (host transport)."""
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized in this process")
    kwargs = {}
    if coordinator_address is not None:
        url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        kwargs = dict(init_method=url, world_size=num_processes, rank=process_id)
    if backend == "nccl":
        rank = process_id if process_id is not None else int(os.environ.get("RANK", 0))
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, **kwargs)


def _world_of_one(backend: str) -> None:
    """A group of this process alone, with an in-process store: what a
    one-rank mesh needs, as the JAX package's ``local_mesh(1)`` needs
    nothing."""
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def get_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    devices: Optional[Sequence[int]] = None,
):
    """A (data, model) ``DeviceMesh`` over the group's ranks, data-major:
    rank i at (i // n_model, i % n_model), where the JAX mesh puts device i
    (``devices``, the JAX parameter, may list the ranks, in that order).
    The mesh covers the whole world; ``n_data`` None takes world //
    n_model."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed() first (local_mesh(1) "
                           "makes a group of one)")
    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    if n_data is None:
        n_data = len(ranks) // n_model
    n = n_data * n_model
    if ranks != list(range(len(ranks))):
        raise ValueError(f"devices must list the ranks 0..{len(ranks) - 1} in order, got {ranks}")
    if n != world or len(ranks) != world:
        raise ValueError(
            f"mesh {n_data}x{n_model} needs a world of {n} ranks, one per device, and this "
            f"world has {world}: launch it as torchrun --nproc-per-node {n} ...")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(n_data, n_model),
                      mesh_dim_names=AXES)


def local_mesh(n: Optional[int] = None, *, backend: Optional[str] = None):
    """1-D data mesh over ``n`` ranks (default: the world). With no group
    in this process it joins a launcher's (``torchrun``'s environment), or
    for ``n`` 1 makes a group of one, with ``backend`` (None: NCCL when a
    card is present, else Gloo); a larger ``n`` in a plain process raises
    with the launch line it needs."""
    if not dist.is_initialized():
        backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
        if "WORLD_SIZE" in os.environ:      # started by a launcher (torchrun)
            init_distributed(backend=backend)
        elif n in (None, 1):
            _world_of_one(backend)
        else:
            raise ValueError(
                f"a mesh of {n} needs a world of {n} ranks: launch it as torchrun "
                f"--nproc-per-node {n} ... (only a mesh of 1 runs in a plain process)")
    return get_mesh(n_data=n, n_model=1)


@contextlib.contextmanager
def use_mesh(mesh):
    """Bind ``mesh`` for the calls inside the block: the mesh whose axes a
    layer that names one (``BatchNorm(sync_axis=...)``) reduces over, as
    the JAX ``shard_map`` binds its axis names. Blocks nest; leaving one
    restores the binding before it."""
    token = _BOUND.set(mesh)
    try:
        yield mesh
    finally:
        _BOUND.reset(token)


def bound_mesh():
    """The mesh of the innermost ``use_mesh`` block around this call, or
    None."""
    return _BOUND.get()


def axis_size(mesh, name: Optional[str]) -> int:
    """The mesh's extent along ``name`` (None: every rank of the mesh)."""
    if name is None:
        return mesh.size()
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_index(mesh, name: Optional[str]) -> int:
    """This rank's coordinate along ``name`` (None: its rank in the mesh,
    data-major)."""
    if name is None:
        return dist.get_rank()
    return mesh.get_local_rank(name)


def _group(mesh, name: Optional[str]):
    return dist.group.WORLD if name is None else mesh.get_group(name)


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0):
    """Pad ``x`` along ``axis`` to a multiple (sharding needs even splits).
    Returns (padded, original_length)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    return np.pad(x, pad), n


def shard_rows(x, mesh, axis: Optional[str] = "data"):
    """This rank's block of rows of ``x`` (numpy or tensor) along ``axis``:
    the JAX ``data_sharding``. The row count must divide the axis
    (``pad_to_multiple``)."""
    n, i = axis_size(mesh, axis), axis_index(mesh, axis)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not divide the {axis!r} axis ({n}); "
                         "pad them first (pad_to_multiple)")
    local = x.shape[0] // n
    return x[i * local:(i + 1) * local]


def _buffer(group, t: torch.Tensor, copy: bool = False) -> torch.Tensor:
    """``t`` as ``group``'s backend takes it: a host copy for a Gloo group
    when ``t`` is on the card; for an NCCL group (the card's memory) or a
    host tensor ``t`` itself, or a fresh copy with ``copy`` (a buffer the
    collective writes into)."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu()
    return t.clone() if copy else t.contiguous()


def _back(out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return out.to(like.device) if out.device != like.device else out


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# all_gather_into_tensor under the name newer releases give it
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _refuse_grad(name: str, t: torch.Tensor) -> None:
    """A collective without a backward given an input that requires a
    gradient under grad mode raises (F24): its backward would be the
    identity, or nothing, without a word."""
    if torch.is_grad_enabled() and t.requires_grad:
        raise RuntimeError(
            f"{name}: the input requires a gradient and this collective has no backward; "
            "use tp_reduce / tp_copy / tp_gather (tensor parallelism, a replicated loss) or "
            "sync_reduce (data parallelism, a loss per rank), or call it under torch.no_grad()")


def all_reduce(t: torch.Tensor, mesh, axis: Optional[str], op: str = "sum") -> torch.Tensor:
    """``psum`` (or ``pmax``) over ``axis``: a new tensor, the same on
    every rank of the axis. No backward (``tp_reduce``, ``sync_reduce``)."""
    _refuse_grad("all_reduce", t)
    return _all_reduce(t, mesh, axis, op)


def _all_reduce(t: torch.Tensor, mesh, axis: Optional[str], op: str = "sum") -> torch.Tensor:
    if axis_size(mesh, axis) == 1:
        return t
    group = _group(mesh, axis)
    buf = _buffer(group, t, copy=True)
    dist.all_reduce(buf, op=_OPS[op], group=group)
    return _back(buf, t)


def all_gather(t: torch.Tensor, mesh, axis: Optional[str]) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0, in axis order. No
    backward (``tp_gather``)."""
    _refuse_grad("all_gather", t)
    return _all_gather(t, mesh, axis)


def _all_gather(t: torch.Tensor, mesh, axis: Optional[str]) -> torch.Tensor:
    n = axis_size(mesh, axis)
    if n == 1:
        return t
    group = _group(mesh, axis)
    src = _buffer(group, t)
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    _ALL_GATHER(out, src, group=group)
    return _back(out, t)


def all_to_all(t: torch.Tensor, mesh, axis: Optional[str]) -> torch.Tensor:
    """``all_to_all`` over ``axis`` along dim 0: block j of ``t`` goes to
    coordinate j; block j of the result came from coordinate j. No
    backward."""
    _refuse_grad("all_to_all", t)
    if axis_size(mesh, axis) == 1:
        return t
    group = _group(mesh, axis)
    src = _buffer(group, t)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return _back(out, t)


def broadcast(t: torch.Tensor, mesh, axis: Optional[str], src: int = 0) -> torch.Tensor:
    """Coordinate ``src``'s ``t`` on every rank of ``axis`` (the others
    pass a tensor of the same shape and dtype): the JAX ``replicated``. No
    backward."""
    _refuse_grad("broadcast", t)
    if axis_size(mesh, axis) == 1:
        return t
    group = _group(mesh, axis)
    buf = _buffer(group, t, copy=True)
    dist.broadcast(buf, src=dist.get_global_rank(group, src), group=group)
    return _back(buf, t)


def shift(t: torch.Tensor, mesh, axis: str, wrap: bool = True) -> Optional[torch.Tensor]:
    """``ppermute`` by one along ``axis``: send ``t`` to coordinate i + 1
    and receive coordinate i - 1's, both posted together in one
    ``batch_isend_irecv``. With ``wrap`` False the last coordinate sends
    nothing and the first receives nothing (None). No backward."""
    _refuse_grad("shift", t)
    n = axis_size(mesh, axis)
    if n == 1:
        return t if wrap else None
    group = _group(mesh, axis)
    i = axis_index(mesh, axis)
    src = _buffer(group, t)
    ops, out = [], None
    if wrap or i < n - 1:
        ops.append(dist.P2POp(dist.isend, src, dist.get_global_rank(group, (i + 1) % n), group))
    if wrap or i > 0:
        out = torch.empty_like(src)
        ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (i - 1) % n), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return None if out is None else _back(out, t)


# ---------------------------------------------------------------------------
# collectives under autograd (F24; module docstring)
# ---------------------------------------------------------------------------

def _grad_wanted(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class _TpReduce(torch.autograd.Function):
    """"g": the row-parallel partial products summed over ``axis``; the
    cotangent of the replicated sum is every rank's own."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        return _all_reduce(t, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _TpCopy(torch.autograd.Function):
    """"f": replicated activations into a column-parallel product; the
    ranks' cotangents (each from its own columns) summed over ``axis``."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.mesh, ctx.axis), None, None


class _TpGather(torch.autograd.Function):
    """Every rank's block concatenated along dim 0; the cotangent of the
    replicated result is the same on every rank, so a rank's block gets its
    own slice of it."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.rows, ctx.index = t.shape[0], axis_index(mesh, axis)
        return _all_gather(t, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.index * ctx.rows
        return grad[lo:lo + ctx.rows], None, None


class _SyncReduce(torch.autograd.Function):
    """Sums over ``axis`` that every rank's own loss reads: the cotangents
    of all ranks' losses summed back over ``axis`` (PyTorch's
    ``SyncBatchNorm`` reduces ``sum_dy`` and ``sum_dy_xmu`` so)."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_reduce(t, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.mesh, ctx.axis), None, None


def tp_reduce(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Tensor parallelism's "g": ``all_reduce`` over ``axis``, identity
    backward (the loss is replicated over ``axis``)."""
    if axis_size(mesh, axis) == 1 or not _grad_wanted(t):
        return _all_reduce(t, mesh, axis)
    return _TpReduce.apply(t, mesh, axis)


def tp_copy(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Tensor parallelism's "f": ``t`` itself forward, the cotangent
    all-reduced over ``axis`` backward. With no gradient to build it is
    ``t`` and runs nothing."""
    if axis_size(mesh, axis) == 1 or not _grad_wanted(t):
        return t
    return _TpCopy.apply(t, mesh, axis)


def tp_gather(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``all_gather`` along dim 0 over ``axis``; backward, the rank's rows of
    the cotangent (the loss is replicated over ``axis``)."""
    if axis_size(mesh, axis) == 1 or not _grad_wanted(t):
        return _all_gather(t, mesh, axis)
    return _TpGather.apply(t, mesh, axis)


def sync_reduce(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``all_reduce`` over ``axis`` whose backward all-reduces the
    cotangent: the data-parallel case, a loss per rank (cross-device
    BatchNorm's statistics)."""
    if axis_size(mesh, axis) == 1 or not _grad_wanted(t):
        return _all_reduce(t, mesh, axis)
    return _SyncReduce.apply(t, mesh, axis)


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank of the world."""
    if dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def barrier() -> None:
    if dist.get_world_size() > 1:
        dist.barrier()
