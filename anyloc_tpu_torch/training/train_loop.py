"""Triplet training loop (counterpart of ``anyloc_tpu/training/
train_loop.py``; dvgl_benchmark/train.py:106-206): each epoch refreshes the
mined triplets every ``cache_refresh_every`` queries, runs train steps on
whole batches (the remainder dropped, as the JAX loop does), augments the
query slot only, evaluates Recall@5 on the validation set, keeps the last
and best checkpoints and stops early after ``patience`` epochs without a
better R@5.

Mining and evaluation run the model under ``torch.inference_mode`` (K5
without saved tensors); the steps run with autograd on ``device`` (None:
the card).
"""

from __future__ import annotations

import functools
import logging
from typing import Callable, Optional, Union

import numpy as np
import torch

from anyloc_tpu_torch.ops.common import resolve_device
from anyloc_tpu_torch.training.evaluate import evaluate
from anyloc_tpu_torch.training.mining import TripletMiner
from anyloc_tpu_torch.training.triplet import make_triplet_train_step
from anyloc_tpu_torch.utils.checkpoint import save_checkpoint


def train_triplet(
    descriptor_fn: Callable,  # (params, images [B, H, W, 3]) -> [B, D]
    init_params,
    train_ds,
    val_ds,
    epochs: int = 3,
    queries_per_epoch: int = 500,
    cache_refresh_every: int = 250,
    batch_size: int = 2,
    neg_num: int = 10,
    mining: str = "partial",
    criterion: str = "triplet",
    margin: float = 0.1,
    lr: float = 1e-5,
    optim: str = "adam",
    patience: Optional[int] = None,
    trainable_mask=None,
    neg_samples_num: int = 1000,
    output_dir: Optional[str] = None,
    recall_values=(1, 5, 10, 20),
    eval_batch_size: int = 16,
    test_method: str = "hard_resize",
    efficient_ram: bool = False,
    augment_fn=None,
    seed: int = 42,
    *,
    device: Union[None, str, torch.device] = None,
):
    """Returns (final_state, best_r5, history).

    ``init_params`` is a dict {name: tensor} of the model's parameters and
    buffers (moved to ``device``). ``optim`` (adam | sgd) and ``patience``
    mirror the dvgl parser. ``trainable_mask(params) -> {name: bool}``
    (``network.make_freeze_te_mask``) freezes the names it maps to False:
    a zero update. ``augment_fn(generator, images [B, H, W, 3])`` augments
    the query of each tuple on the device (the reference's query_transform;
    positives and negatives stay plain, datasets_ws.py:287-298)."""
    dev = resolve_device(device)
    if optim == "adam":
        opt = functools.partial(torch.optim.Adam, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    else:
        opt = functools.partial(torch.optim.SGD, lr=lr)
    step = make_triplet_train_step(descriptor_fn, opt, neg_num=neg_num, margin=margin,
                                   criterion=criterion)
    params = {k: v.to(dev) for k, v in init_params.items()}
    state = step.init_state(params, None if trainable_mask is None else trainable_mask(params))
    miner = TripletMiner(train_ds, neg_num=neg_num, mining=mining, seed=seed,
                         neg_samples_num=neg_samples_num, device=dev)
    aug_gen = torch.Generator(device=dev).manual_seed(seed + 1)

    @torch.inference_mode()
    def infer(imgs):
        return descriptor_fn(state.params, torch.as_tensor(np.asarray(imgs, np.float32)).to(dev))

    best_r5 = 0.0
    epochs_since_best = 0
    history = []
    for epoch in range(epochs):
        losses = []
        done = 0
        while done < queries_per_epoch:
            n = min(cache_refresh_every, queries_per_epoch - done)
            triplets = miner.compute_triplets(infer, n_queries=n, batch_size=eval_batch_size)
            for s in range(0, len(triplets), batch_size):
                idxs = range(s, min(s + batch_size, len(triplets)))
                tuples = miner.tuples_as_batch(triplets, idxs)
                if tuples.shape[0] < batch_size:
                    continue  # the remainder is dropped, as in the JAX loop
                tuples = torch.from_numpy(tuples).to(dev)
                if augment_fn is not None:
                    tuples[:, 0] = augment_fn(aug_gen, tuples[:, 0])
                state, loss = step(state, tuples)
                losses.append(float(loss))
            done += n
        recalls, recalls_str = evaluate(infer, val_ds, test_method=test_method,
                                        recall_values=recall_values,
                                        batch_size=eval_batch_size,
                                        efficient_ram=efficient_ram, device=dev)
        r5 = recalls[min(1, len(recalls) - 1)]
        is_best = r5 > best_r5
        best_r5 = max(best_r5, r5)
        history.append({"epoch": epoch, "loss": float(np.mean(losses)) if losses else None,
                        "recalls": recalls.tolist()})
        logging.info(f"epoch {epoch}: loss={np.mean(losses) if losses else float('nan'):.4f} "
                     f"{recalls_str}{' (best)' if is_best else ''}")
        if output_dir is not None:
            params_cpu = {k: v.detach().cpu() for k, v in state.params.items()}
            save_checkpoint(output_dir, {"params": params_cpu, "epoch": epoch + 1,
                                         "best_r5": best_r5}, is_best)
        if is_best:
            epochs_since_best = 0
        else:
            epochs_since_best += 1
            if patience is not None and epochs_since_best >= patience:
                logging.info(f"early stop: no R@5 improvement for {patience} epochs "
                             f"(train.py:183-206 patience semantics)")
                break
    return state, best_r5, history
