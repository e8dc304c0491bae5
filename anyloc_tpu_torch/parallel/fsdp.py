"""Optimizer-state sharding over the ``data`` axis (counterpart of
``anyloc_tpu/parallel/fsdp.py``: ZeRO-1).

Adam holds two float32 moments per trainable parameter, so a replicated
trunk + head costs three times its parameters on every device. The moments
are only read and written elementwise with the gradients, so each rank can
hold a slice of every large moment: ``fsdp_shardings`` makes the JAX
package's decision per leaf (sharded along its largest dimension that the
axis divides, or replicated), and the step ``fsdp_train_step`` returns
runs, on each rank:

  * the triplet step's forward and backward on the rank's block of tuples
    (``shard_rows``);
  * the mean of the gradients over ``data`` (one ``all_reduce``);
  * the optimizer's update of the rank's slice of each sharded parameter,
    with the slice's moments (the same ``torch.optim`` class and
    hyperparameters as the step without FSDP, so that the two differ only
    by the rounding of that ``all_reduce``), then an ``all_gather`` of the
    updated slices: the parameters stay replicated.

JAX pins the moments' layout with ``jit(out_shardings=...)`` and GSPMD
runs the elementwise update on each shard; here ``FsdpOptimizer`` owns
the slices. A parameter that tensor parallelism already shards over
``model`` (``state_shardings.params``, e.g. ``tp.vit_tp_shardings``) is
sliced further over ``data``; the checkpoint gathers both
(``utils/checkpoint.py``).

    specs = fsdp_shardings(state.params, mesh)          # the moments' layout
    step = fsdp_train_step(train_step, specs)           # or TripletTrainState(p, specs, None)
    state = step.init_state(params)
    state, loss = step(state, tuples)                   # the same tuples on every rank
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch

from anyloc_tpu_torch.parallel.mesh import (_all_gather, _all_reduce, axis_index, axis_size,
                                            shard_rows)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """One leaf's layout on ``mesh`` (the JAX ``NamedSharding``): ``spec``
    holds, per dimension, the mesh axis it is split over or None; ``()`` is
    replicated (the JAX ``PartitionSpec()``)."""

    mesh: Any
    spec: tuple = ()

    @property
    def dim(self) -> Optional[int]:
        """The dimension split over an axis, or None."""
        return next((d for d, a in enumerate(self.spec) if a is not None), None)

    @property
    def axis(self) -> Optional[str]:
        d = self.dim
        return None if d is None else self.spec[d]


def _numel(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel()
    size = getattr(x, "size", 0)
    return 0 if callable(size) else int(size)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def fsdp_shardings(tree: Any, mesh, axis: str = "data", min_size: int = 1 << 10) -> Any:
    """A ``Sharding`` for each leaf of ``tree`` (nested dicts, lists and
    tuples of tensors or arrays): a leaf of at least ``min_size`` elements
    is split along its largest dimension that the ``axis`` size divides;
    everything else (scalars, step counts, small biases, shapes nothing
    divides) is replicated."""
    n = axis_size(mesh, axis)

    def one(x):
        shape = tuple(getattr(x, "shape", ()))
        if n > 1 and _numel(x) >= min_size:
            for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
                if shape[d] % n == 0 and shape[d] >= n:
                    spec = [None] * len(shape)
                    spec[d] = axis
                    return Sharding(mesh, tuple(spec))
        return Sharding(mesh, ())

    return _tree_map(one, tree)


def _narrow(t: torch.Tensor, sh: Optional[Sharding]) -> torch.Tensor:
    """This rank's block of ``t`` under ``sh`` (``t`` itself when
    replicated)."""
    if sh is None or sh.dim is None:
        return t
    n, i = axis_size(sh.mesh, sh.axis), axis_index(sh.mesh, sh.axis)
    part = t.shape[sh.dim] // n
    return t.narrow(sh.dim, i * part, part)


def _gather(t: torch.Tensor, sh: Optional[Sharding]) -> torch.Tensor:
    """Every rank's block of ``t`` put back together along ``sh``'s
    dimension (inverse of ``_narrow``)."""
    if sh is None or sh.dim is None:
        return t
    moved = t.movedim(sh.dim, 0).contiguous()
    return _all_gather(moved, sh.mesh, sh.axis).movedim(0, sh.dim)


class FsdpOptimizer:
    """A ``torch.optim`` optimizer over this rank's slices of the trainable
    parameters ``params`` ({name: tensor}, each replicated over the data
    axis): ``shardings`` {name: ``Sharding``} says which are sliced (the
    others it updates in place, whole). ``tp`` {name: ``Sharding``} names
    the parameters that are themselves shards over ``model`` (the
    checkpoint puts them back together)."""

    def __init__(self, params: Dict[str, torch.Tensor], shardings: Dict[str, Sharding],
                 optimizer_class, hyper: Dict[str, Any], tp: Optional[Dict[str, Sharding]] = None):
        self.params, self.shardings = dict(params), dict(shardings)
        self.optimizer_class, self.hyper, self.tp = optimizer_class, dict(hyper), dict(tp or {})
        self.local = {}
        with torch.no_grad():
            for name, p in self.params.items():
                sh = self.shardings[name]
                self.local[name] = p if sh.dim is None else _narrow(p.detach(), sh).clone()
        self.inner = optimizer_class(list(self.local.values()), **self.hyper)

    @property
    def state(self):
        return self.inner.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in list(self.params.values()) + list(self.local.values()):
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    @torch.no_grad()
    def step(self) -> None:
        """Update each rank's slices from the (already averaged) gradients of
        the whole parameters, then gather the updated slices."""
        for name, p in self.params.items():
            loc = self.local[name]
            if loc is not p:
                loc.grad = None if p.grad is None else _narrow(p.grad, self.shardings[name]).clone()
        self.inner.step()
        for name, p in self.params.items():
            loc = self.local[name]
            if loc is not p:
                p.copy_(_gather(loc, self.shardings[name]))

    def _full(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """A slice-shaped state tensor of ``name`` as the whole parameter's
        (over ``data``, then over ``model`` for a tensor-parallel shard)."""
        if t.shape != self.local[name].shape or t.dim() == 0:
            return t
        return _gather(_gather(t, self.shardings[name]), self.tp.get(name))

    @torch.no_grad()
    def state_dict(self) -> Dict[str, Any]:
        """The whole moments, gathered on every rank (a collective: every
        rank calls it): {"optimizer", "hyper", "state": {name: {key: tensor
        on the CPU}}}. The one-file checkpoint's ``opt_state``."""
        state = {}
        for name, loc in self.local.items():
            st = self.inner.state.get(loc, {})
            state[name] = {k: self._full(v, name).cpu() if isinstance(v, torch.Tensor) else v
                           for k, v in st.items()}
        return {"optimizer": f"{self.optimizer_class.__module__}.{self.optimizer_class.__name__}",
                "hyper": self.hyper, "state": state}

    def restored(self, saved: Dict[str, Any], params: Dict[str, torch.Tensor]) -> "FsdpOptimizer":
        """A new optimizer of this one's layout over ``params`` with the
        moments of ``saved`` (``state_dict``'s format), each rank reading
        only its slices (``saved`` may hold memory-mapped tensors)."""
        out = FsdpOptimizer(params, self.shardings, self.optimizer_class, saved["hyper"], self.tp)
        state = {}
        for i, (name, loc) in enumerate(out.local.items()):
            st = {}
            for k, v in saved["state"].get(name, {}).items():
                if isinstance(v, torch.Tensor) and v.dim() > 0:
                    v = _narrow(_narrow(v, self.tp.get(name)), self.shardings[name])
                    v = v.to(loc.device, loc.dtype, copy=True)
                elif isinstance(v, torch.Tensor):
                    v = v.clone()
                st[k] = v
            if st:
                state[i] = st
        groups = [{**_hyper(out.inner), "params": list(range(len(out.local)))}]
        out.inner.load_state_dict({"state": state, "param_groups": groups})
        return out


def _hyper(opt: torch.optim.Optimizer) -> Dict[str, Any]:
    if len(opt.param_groups) != 1:
        raise ValueError("FSDP takes an optimizer with one parameter group")
    return {k: v for k, v in opt.param_groups[0].items() if k != "params"}


def _specs(state_shardings) -> tuple:
    """(moment shardings, tensor-parallel shardings) of ``state_shardings``:
    a {name: Sharding} of the moments, or a ``TripletTrainState`` of
    (param shardings, moment shardings, step)."""
    if hasattr(state_shardings, "opt_state"):
        tp = {k: s for k, s in (state_shardings.params or {}).items() if s.dim is not None}
        return dict(state_shardings.opt_state), tp
    return dict(state_shardings), {}


def fsdp_train_step(train_step, state_shardings: Any):
    """A step over the same host tuples on every rank, with the moments
    sharded as ``state_shardings`` says (module docstring): ``step(state,
    tuples) -> (state, loss)``, the loss the mean over every rank's tuples
    of the axis the moments are sharded over ("data" when none is sharded:
    the axis of ``shard_rows``, the JAX ``data_sharding``).
    ``step.init_state(params, trainable=None)`` builds the sharded state,
    and ``step`` takes no other. ``train_step`` is
    ``make_triplet_train_step``'s."""
    from anyloc_tpu_torch.training.triplet import TripletTrainState

    specs, tp = _specs(state_shardings)
    mesh = next(iter(specs.values())).mesh
    axes = {s.axis for s in specs.values() if s.axis is not None}
    if len(axes) > 1:
        raise ValueError(f"the moments are sharded over more than one axis: {sorted(axes)}")
    axis = axes.pop() if axes else "data"

    def step(state, tuples):
        if not isinstance(state.opt_state, FsdpOptimizer):
            raise TypeError("fsdp_train_step's step takes the state of its init_state, not "
                            f"one with a {type(state.opt_state).__name__}")
        n = axis_size(mesh, axis)
        loss = train_step.backward(state, shard_rows(tuples, mesh, axis))
        grads = [p.grad for p in state.opt_state.params.values() if p.grad is not None]
        if n > 1:
            with torch.no_grad():
                for dtype in {g.dtype for g in grads}:
                    same = [g for g in grads if g.dtype == dtype]
                    flat = _all_reduce(torch.cat([g.reshape(-1) for g in same]), mesh, axis)
                    flat /= n
                    for g, part in zip(same, flat.split([g.numel() for g in same])):
                        g.copy_(part.view_as(g))
                loss = _all_reduce(loss, mesh, axis) / n
        state.opt_state.step()
        return TripletTrainState(state.params, state.opt_state, state.step + 1), loss

    def init_state(params, trainable=None):
        """``train_step.init_state``'s state with its optimizer (no moments
        yet) replaced by an ``FsdpOptimizer`` of the same class and
        hyperparameters over this rank's slices."""
        state = train_step.init_state(params, trainable)
        opt = state.opt_state
        named = {k: t for k, t in state.params.items() if t.requires_grad}
        missing = sorted(set(named) - set(specs))
        if missing:
            raise ValueError(f"state_shardings has no entry for {missing[:3]}")
        out = FsdpOptimizer(named, {k: specs[k] for k in named}, type(opt), _hyper(opt),
                            {k: tp[k] for k in named if k in tp})
        return TripletTrainState(state.params, out, state.step)

    step.init_state = init_state
    return step


def state_bytes_per_device(state: Any) -> int:
    """Bytes of a train state that this rank holds: its parameters and
    buffers (``state.params``) and its optimizer's state (an
    ``FsdpOptimizer``'s slices, or a ``torch.optim`` optimizer's whole
    moments). The sibling of ``tp.params_bytes_per_device`` for whole
    states."""
    def nbytes(ts: Sequence) -> int:
        return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))

    params = state.params if isinstance(state.params, dict) else dict(state.params)
    opt = state.opt_state
    held = [v for st in getattr(opt, "state", {}).values() for v in st.values()]
    local = [t for t in getattr(opt, "local", {}).values()
             if all(t is not p for p in params.values())]
    return nbytes(list(params.values())) + nbytes(held) + nbytes(local)
