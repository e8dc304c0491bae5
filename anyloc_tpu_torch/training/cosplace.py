"""CosPlace classification training (counterpart of
``anyloc_tpu/training/cosplace.py``; the reference's ``CosPlace/train.py``,
``cosface_loss.py`` and ``datasets/train_dataset.py``):

  * the database splits into UTM cell x heading classes (cells of M = 10 m,
    heading buckets of alpha = 30 deg) in N * N * L groups (N 5, L 2), so
    that no group holds two adjacent cells (train_dataset.py:20-80);
  * each group has its own CosFace classifier (``MarginCosineProduct``,
    s 30, m 0.40; cosface_loss.py:16-38) over the shared descriptor net;
  * one train step per group batch, with two optimizers (the model's and
    the active group's head's).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from anyloc_tpu_torch.ops.common import l2_normalize
from anyloc_tpu_torch.training.triplet import make_optimizer, trainable_leaves


def assign_classes(utm_east: np.ndarray, utm_north: np.ndarray,
                   heading: Optional[np.ndarray] = None, M: float = 10.0, alpha: float = 30.0,
                   N: int = 5, L: int = 2) -> Tuple[List[np.ndarray], List[Dict[Tuple, int]]]:
    """-> (per-group image-index arrays, per-group {class_key: class_id},
    per-image within-group class labels).

    class key = (east//M, north//M, heading//alpha); group id =
    ((east//M) % N, (north//M) % N, (heading//alpha) % L) flattened: the
    reference's spatial separation, so that one group's classifier never
    sees adjacent cells. (A copy of the JAX package's numpy code.)
    """
    if heading is None:
        heading = np.zeros_like(utm_east)
    ce = np.floor(utm_east / M).astype(int)
    cn = np.floor(utm_north / M).astype(int)
    ch = np.floor(heading / alpha).astype(int)
    group = (ce % N) * N * L + (cn % N) * L + (ch % L)
    n_groups = N * N * L
    group_indices: List[List[int]] = [[] for _ in range(n_groups)]
    group_classes: List[Dict[Tuple, int]] = [dict() for _ in range(n_groups)]
    labels = np.zeros(len(utm_east), int)
    for i in range(len(utm_east)):
        g = group[i]
        key = (ce[i], cn[i], ch[i])
        if key not in group_classes[g]:
            group_classes[g][key] = len(group_classes[g])
        labels[i] = group_classes[g][key]
        group_indices[g].append(i)
    return ([np.asarray(gi, int) for gi in group_indices], group_classes, labels)


class MarginCosineProduct(nn.Module):
    """cos(theta) - m margin head (CosPlace/cosface_loss.py:16-38):
    ``s * (cos(feats, weight) - m * onehot(labels))``; weight [C, D]
    xavier-uniform. ``in_dim`` (D, a keyword after the JAX fields) is what
    Flax infers at the first call; ``generator`` draws the weight."""

    def __init__(self, num_classes: int, s: float = 30.0, m: float = 0.40, *,
                 in_dim: int = 512, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.num_classes, self.s, self.m = num_classes, s, m
        bound = (6.0 / (num_classes + in_dim)) ** 0.5
        w = torch.empty(num_classes, in_dim)
        self.weight = nn.Parameter(w.uniform_(-bound, bound, generator=generator))

    def forward(self, feats: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        cos = l2_normalize(feats) @ l2_normalize(self.weight).T          # [B, C]
        onehot = F.one_hot(labels.long(), self.num_classes).to(cos.dtype)
        return self.s * (cos - self.m * onehot)


def cosface_loss_fn(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy with integer labels, averaged."""
    return F.cross_entropy(logits.float(), labels.long())


class CosPlaceTrainState(NamedTuple):
    model_params: Dict
    classifier_params: Dict   # the active group's head
    model_opt: Any
    cls_opt: Any
    step: int


def make_cosplace_train_step(descriptor_fn, head: MarginCosineProduct, model_optimizer,
                             cls_optimizer):
    """``descriptor_fn(params, images) -> [B, D]`` L2-normalized
    descriptors; the head runs on ``classifier_params`` through
    ``torch.func.functional_call``. The optimizers are torch.optim
    factories (or built optimizers, as in ``make_triplet_train_step``);
    ``train_step.init_state(model_params, classifier_params)`` builds the
    state (BatchNorm statistics stay out of the model's optimizer)."""

    def train_step(state: CosPlaceTrainState, images: torch.Tensor, labels: torch.Tensor):
        for opt in (state.model_opt, state.cls_opt):
            opt.zero_grad(set_to_none=True)
        feats = descriptor_fn(state.model_params, images)
        logits = torch.func.functional_call(head, state.classifier_params, (feats, labels))
        loss = cosface_loss_fn(logits, labels)
        loss.backward()
        state.model_opt.step()
        state.cls_opt.step()
        return state._replace(step=state.step + 1), loss.detach()

    def init_state(model_params, classifier_params) -> CosPlaceTrainState:
        mp = trainable_leaves(model_params, model_optimizer)
        cp = trainable_leaves(classifier_params, cls_optimizer)
        return CosPlaceTrainState(
            mp, cp, make_optimizer(model_optimizer, [t for t in mp.values() if t.requires_grad]),
            make_optimizer(cls_optimizer, [t for t in cp.values() if t.requires_grad]), 0)

    train_step.init_state = init_state
    return train_step
