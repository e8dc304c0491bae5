"""Checkpoint save / load (counterpart of ``anyloc_tpu/utils/checkpoint.py``;
dvgl ``util.py:22-60``: last and best checkpoints).

The JAX package writes orbax directories; the port writes one
``torch.save`` file at the same path with the same keys (``params`` as the
port's state dict, ``epoch``, ``best_r5``, ...). An orbax directory is not
readable without orbax: ``load_checkpoint`` given one raises, naming
``models.convert.from_jax_params`` as the way across (restore the tree
with the JAX package, then convert it). Resuming training is not ported.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch


def save_checkpoint(output_dir: str, state: Dict[str, Any], is_best: bool,
                    filename: str = "last_checkpoint") -> None:
    """``state`` (params / epoch / best_r5 / ...) -> ``<dir>/<filename>``,
    copied to ``<dir>/best_checkpoint`` when ``is_best``."""
    os.makedirs(output_dir, exist_ok=True)
    torch.save(state, os.path.join(output_dir, filename))
    if is_best:
        torch.save(state, os.path.join(output_dir, "best_checkpoint"))


def load_checkpoint(path: str, target: Optional[Any] = None) -> Dict[str, Any]:
    """A checkpoint ``save_checkpoint`` wrote, on the CPU. ``target`` (the
    JAX package's sharded restore) is not ported: it must be None."""
    if target is not None:
        raise NotImplementedError(
            'a sharded restore (target=) is not ported yet (ROADMAP.md, port queue: '
            '"parallel/ on torch.distributed")')
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: an orbax checkpoint of the JAX package, which the port "
            "cannot read (no orbax). Restore it with anyloc_tpu.utils.checkpoint."
            "load_checkpoint, convert its params with anyloc_tpu_torch.models.convert."
            "from_jax_params, and save the result with this module's save_checkpoint")
    return torch.load(path, map_location="cpu", weights_only=False)


def resume_train(output_dir: str, template_state: Optional[Dict[str, Any]] = None,
                 filename: str = "last_checkpoint") -> Tuple[Dict[str, Any], int, float]:
    """Resuming a training run: not ported."""
    raise NotImplementedError(
        'resume_train (checkpoint resume of training) is not ported yet (ROADMAP.md, port '
        'queue: "Training")')
