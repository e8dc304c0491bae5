"""Triplet training step (counterpart of ``anyloc_tpu/training/triplet.py``;
dvgl_benchmark train.py:132-169: query + positive + neg_num negatives per
tuple, TripletMarginLoss or SARE, Adam).

The step is functional, as the JAX one: ``descriptor_fn(params, images
[B*, H, W, 3]) -> [B*, D]`` over a dict ``params`` of the model's
parameters and buffers by name (e.g. ``torch.func.functional_call(model,
params, (images,))``), and ``train_step(state, tuples) -> (state, loss)``.
The optimizer is ``torch.optim``'s: a factory called with the list of
trainable tensors (``functools.partial(torch.optim.Adam, lr=1e-5)``; its
``betas`` (0.9, 0.999) and ``eps`` 1e-8 outside the square root are
optax's) or an optimizer already built over the tensors of ``params``.

BatchNorm is frozen, as in the JAX step: the model runs its BatchNorm on
the running statistics (``descriptor_fn`` is called without
``train=True``), and the statistics (``running_mean`` / ``running_var``,
the JAX package's ``batch_stats`` through the converter's name map) never
enter the optimizer; every other parameter, BatchNorm's weight and bias
included, trains.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F


class TripletTrainState(NamedTuple):
    params: Any          # {name: tensor}: the trainable ones are the optimizer's leaves
    opt_state: Any       # the torch.optim optimizer over them
    step: int


def triplet_margin_loss(q: torch.Tensor, p: torch.Tensor, n: torch.Tensor,
                        margin: float = 0.1) -> torch.Tensor:
    """``torch.nn.TripletMarginLoss`` semantics with the JAX package's
    1e-12 under the root (margin 0.1 = dvgl's default; L2 distance, mean
    reduction). q [B, D]; p [B, D]; n [B, NEG, D]: each negative forms one
    triplet."""
    d_qp = torch.sqrt(((q - p) ** 2).sum(-1) + 1e-12)                  # [B]
    d_qn = torch.sqrt(((q[:, None] - n) ** 2).sum(-1) + 1e-12)         # [B, NEG]
    return torch.clamp_min(d_qp[:, None] - d_qn + margin, 0.0).mean()


def sare_ind_loss(q: torch.Tensor, p: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """SARE-independent (dvgl model/functional.py:6-16): per negative,
    softplus(d_qp - d_qn) over squared distances, averaged."""
    d_qp = ((q - p) ** 2).sum(-1)
    d_qn = ((q[:, None] - n) ** 2).sum(-1)
    return F.softplus(d_qp[:, None] - d_qn).mean()


def sare_joint_loss(q: torch.Tensor, p: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """SARE-joint (functional.py:19-27): softmax over the negative set; the
    per-query mean is further scaled by 1/NEG, as the reference's loop
    divides the batch sum by B * NEG (train.py:150-165)."""
    d_qp = ((q - p) ** 2).sum(-1)                                       # [B]
    d_qn = ((q[:, None] - n) ** 2).sum(-1)                              # [B, NEG]
    logits = torch.cat([-d_qp[:, None], -d_qn], dim=1)
    return (-torch.log_softmax(logits, dim=1)[:, 0]).mean() / n.shape[1]


_LOSSES = {
    "triplet": triplet_margin_loss,
    "sare_ind": lambda q, p, n, margin=None: sare_ind_loss(q, p, n),
    "sare_joint": lambda q, p, n, margin=None: sare_joint_loss(q, p, n),
}
_STATS = ("running_mean", "running_var")


def is_statistic(name: str) -> bool:
    """A BatchNorm running statistic (the JAX package's ``batch_stats``)."""
    return name.rsplit(".", 1)[-1] in _STATS


def make_optimizer(optimizer, tensors):
    """``optimizer`` (a factory or a built ``torch.optim.Optimizer``) over
    ``tensors``: a built one must hold exactly them."""
    if isinstance(optimizer, torch.optim.Optimizer):
        held = {id(p) for g in optimizer.param_groups for p in g["params"]}
        if held != {id(t) for t in tensors}:
            raise ValueError("the optimizer must be built over the trainable tensors of params")
        return optimizer
    return optimizer(list(tensors))


def trainable_leaves(params: Dict[str, torch.Tensor], optimizer,
                     trainable: Optional[Dict[str, bool]] = None) -> Dict[str, torch.Tensor]:
    """``params`` with every trainable entry (not a statistic, not masked
    off by ``trainable``) a leaf that requires a gradient: a fresh copy for
    a factory, the tensor itself for a built optimizer. The rest stay as
    given and get no update."""
    out = {}
    for name, t in params.items():
        train = (t.is_floating_point() and not is_statistic(name)
                 and (trainable is None or trainable.get(name, True)))
        if not train:
            out[name] = t
        elif isinstance(optimizer, torch.optim.Optimizer):
            out[name] = t.requires_grad_(True)
        else:
            out[name] = t.detach().clone().requires_grad_(True)
    return out


def make_triplet_train_step(descriptor_fn: Callable, optimizer, neg_num: int = 10,
                            margin: float = 0.1, criterion: str = "triplet"):
    """The step over tuples [B, 1 + 1 + neg_num, H, W, 3] (query, positive,
    negatives: dvgl's 12-image tuple at neg_num 10). ``train_step.init_state
    (params, trainable=None)`` builds the state; ``trainable`` ({name:
    bool}, e.g. ``make_freeze_te_mask(k)(params)``) leaves the names it
    maps to False out of the optimizer: they get no gradient and a zero
    update (the JAX loop's ``set_to_zero``)."""
    loss_fn = _LOSSES[criterion]

    def train_step(state: TripletTrainState, tuples: torch.Tensor):
        b, t = tuples.shape[:2]
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        descs = descriptor_fn(state.params, tuples.reshape(b * t, *tuples.shape[2:]))
        descs = descs.reshape(b, t, -1)
        loss = loss_fn(descs[:, 0], descs[:, 1], descs[:, 2:], margin)
        loss.backward()
        opt.step()
        return TripletTrainState(state.params, opt, state.step + 1), loss.detach()

    def init_state(params, trainable: Optional[Dict[str, bool]] = None) -> TripletTrainState:
        leaves = trainable_leaves(params, optimizer, trainable)
        opt = make_optimizer(optimizer, [t for t in leaves.values() if t.requires_grad])
        return TripletTrainState(leaves, opt, 0)

    train_step.init_state = init_state
    return train_step
