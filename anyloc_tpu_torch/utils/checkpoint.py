"""Checkpoint save / load (counterpart of ``anyloc_tpu/utils/checkpoint.py``;
dvgl ``util.py:22-60``: last and best checkpoints).

The JAX package writes orbax directories; the port writes one
``torch.save`` file at the same path with the same keys (``params`` as the
port's state dict, ``epoch``, ``best_r5``, ...). An orbax directory is not
readable without orbax: ``load_checkpoint`` given one raises, naming
``models.convert.from_jax_params`` as the way across (restore the tree
with the JAX package, then convert it). ``resume_train`` reads the file
back with its epoch and best Recall@5.

A state whose optimizer is an ``FsdpOptimizer`` (``parallel/fsdp.py``:
each rank holds slices of the moments) saves in the same one-file format
with the whole moments: every rank calls ``save_checkpoint``, the slices
(and tensor-parallel shards) are gathered to every rank, and rank 0 writes
the file. ``load_checkpoint(path, target=state)`` restores into the live
state's layout: the file is memory-mapped, and each rank reads only its
slices of the moments.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch


def save_checkpoint(output_dir: str, state: Dict[str, Any], is_best: bool,
                    filename: str = "last_checkpoint") -> None:
    """``state`` (params / epoch / best_r5 / ...) -> ``<dir>/<filename>``,
    copied to ``<dir>/best_checkpoint`` when ``is_best``. A state with an
    ``FsdpOptimizer`` is gathered and written by rank 0 (module
    docstring)."""
    from anyloc_tpu_torch.parallel.fsdp import FsdpOptimizer

    fsdp = [v for v in state.values() if isinstance(v, FsdpOptimizer)]
    writer = True
    if fsdp:
        import torch.distributed as dist

        state = _gathered(state, fsdp[0])
        writer = dist.get_rank() == 0
    if writer:
        os.makedirs(output_dir, exist_ok=True)
        torch.save(state, os.path.join(output_dir, filename))
        if is_best:
            torch.save(state, os.path.join(output_dir, "best_checkpoint"))
    if fsdp:
        from anyloc_tpu_torch.parallel.mesh import barrier

        barrier()


def _gathered(state: Dict[str, Any], opt) -> Dict[str, Any]:
    """``state`` with its ``FsdpOptimizer`` as the whole moments and its
    tensor-parallel shards put back together, tensors on the CPU."""
    from anyloc_tpu_torch.parallel.fsdp import FsdpOptimizer, _gather

    out = {}
    for key, v in state.items():
        if isinstance(v, FsdpOptimizer):
            v = v.state_dict()
        elif key == "params":
            with torch.no_grad():
                v = {k: _gather(t.detach(), opt.tp.get(k)).cpu() for k, t in v.items()}
        out[key] = v
    return out


def _restore(saved: Dict[str, Any], target: Dict[str, Any]) -> Dict[str, Any]:
    """``saved`` in the layout of the live state ``target``: parameters on
    their devices (a tensor-parallel shard's block only), trainable ones
    fresh leaves that require a gradient; an ``FsdpOptimizer`` rebuilt over
    them with this rank's slices of the moments; other entries as saved."""
    from anyloc_tpu_torch.parallel.fsdp import FsdpOptimizer, _narrow

    opt = next((v for v in target.values() if isinstance(v, FsdpOptimizer)), None)
    tp = opt.tp if opt is not None else {}
    out = dict(saved)
    if "params" in target:
        params = {}
        with torch.no_grad():
            for k, t in target["params"].items():
                v = _narrow(saved["params"][k], tp.get(k)).to(t.device, t.dtype, copy=True)
                params[k] = v.requires_grad_(t.requires_grad)
        out["params"] = params
    for key, v in target.items():
        if isinstance(v, FsdpOptimizer):
            named = {k: out["params"][k] for k in v.params}
            out[key] = v.restored(saved[key], named)
    return out


def load_checkpoint(path: str, target: Optional[Any] = None) -> Dict[str, Any]:
    """A checkpoint ``save_checkpoint`` wrote, on the CPU; with ``target``
    (a live state dict, e.g. ``state._asdict()`` of an FSDP
    ``TripletTrainState``) restored into its layout (module docstring)."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: an orbax checkpoint of the JAX package, which the port "
            "cannot read (no orbax). Restore it with anyloc_tpu.utils.checkpoint."
            "load_checkpoint, convert its params with anyloc_tpu_torch.models.convert."
            "from_jax_params, and save the result with this module's save_checkpoint")
    if target is None:
        return torch.load(path, map_location="cpu", weights_only=False)
    return _restore(torch.load(path, map_location="cpu", weights_only=False, mmap=True),
                    dict(target))


def resume_train(output_dir: str, template_state: Optional[Dict[str, Any]] = None,
                 filename: str = "last_checkpoint") -> Tuple[Dict[str, Any], int, float]:
    """-> (state, start_epoch, best_r5) from ``<dir>/<filename>`` (dvgl
    util.py:29-60 keys). ``template_state`` (the JAX package's restore
    target) is not needed by a ``torch.save`` file: the state comes back as
    saved, on the CPU."""
    del template_state
    state = load_checkpoint(os.path.join(output_dir, filename))
    return state, int(state.get("epoch", 0)), float(state.get("best_r5", 0.0))
