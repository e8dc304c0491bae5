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
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model")


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


def all_reduce(t: torch.Tensor, mesh, axis: Optional[str], op: str = "sum") -> torch.Tensor:
    """``psum`` (or ``pmax``) over ``axis``: a new tensor, the same on
    every rank of the axis."""
    if axis_size(mesh, axis) == 1:
        return t
    group = _group(mesh, axis)
    buf = _buffer(group, t, copy=True)
    dist.all_reduce(buf, op=_OPS[op], group=group)
    return _back(buf, t)


def all_gather(t: torch.Tensor, mesh, axis: Optional[str]) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0, in axis order."""
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
    coordinate j; block j of the result came from coordinate j."""
    if axis_size(mesh, axis) == 1:
        return t
    group = _group(mesh, axis)
    src = _buffer(group, t)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return _back(out, t)


def broadcast(t: torch.Tensor, mesh, axis: Optional[str], src: int = 0) -> torch.Tensor:
    """Coordinate ``src``'s ``t`` on every rank of ``axis`` (the others
    pass a tensor of the same shape and dtype): the JAX ``replicated``."""
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
    nothing and the first receives nothing (None)."""
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
