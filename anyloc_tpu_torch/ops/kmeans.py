"""k-means with a fixed number of Lloyd iterations (counterpart of
``anyloc_tpu/ops/kmeans.py``).

Assignment is one [N, D] @ [D, C] product (cosine on unit vectors, or the
``2x·c - |c|²`` euclidean expansion); the update is a one-hot product
[C, N] @ [N, D] (deterministic, no atomics); an empty cluster keeps its
center. Init samples k distinct rows with a seeded ``torch.Generator`` —
the JAX package's ``jax.random.choice`` draw cannot be reproduced in torch,
so ``init_centers`` lets a caller give both packages the same start.
``kmeans_fit_streamed`` runs the same Lloyd steps over host-resident
descriptors that stream to the device shard by shard.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from anyloc_tpu_torch.ops.common import l2_normalize, resolve_device


def _similarity(descs: torch.Tensor, centers: torch.Tensor, mode: str) -> torch.Tensor:
    """Higher-is-closer similarity of each descriptor to each center: [N, C]."""
    if mode == "cosine":
        return l2_normalize(descs) @ l2_normalize(centers).T
    if mode == "euclidean":
        # -|x - c|^2 up to the per-row constant |x|^2
        return 2.0 * (descs @ centers.T) - (centers * centers).sum(-1)
    raise ValueError(f"Unknown distance mode: {mode}")


def assign_labels(descs: torch.Tensor, centers: torch.Tensor,
                  mode: str = "cosine") -> torch.Tensor:
    """Hard assignment, ties to the lowest index. [N, D], [C, D] -> [N]."""
    return torch.argmax(_similarity(descs, centers, mode), dim=-1)


def _shard_stats(descs: torch.Tensor, centers: torch.Tensor,
                 mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd statistics of one set of rows: (sums [C, D], counts [C])."""
    labels = assign_labels(descs, centers, mode)
    onehot = torch.zeros((descs.shape[0], centers.shape[0]), dtype=torch.float32,
                         device=descs.device).scatter_(1, labels[:, None], 1.0)
    return onehot.T @ descs.float(), onehot.sum(0)


def _update_centers(sums: torch.Tensor, counts: torch.Tensor,
                    centers: torch.Tensor) -> torch.Tensor:
    """Mean update; an empty cluster keeps its center."""
    new = sums / torch.clamp_min(counts, 1.0)[:, None]
    return torch.where(counts[:, None] > 0, new, centers)


def _lloyd_step(descs: torch.Tensor, centers: torch.Tensor, mode: str) -> torch.Tensor:
    return _update_centers(*_shard_stats(descs, centers, mode), centers)


def kmeans_fit(
    descs: torch.Tensor,
    n_clusters: int,
    mode: str = "cosine",
    max_iters: int = 100,
    *,
    generator: Optional[torch.Generator] = None,
    init_centers: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit on ``descs`` [N, D] -> (centers [C, D], labels [N]). Starts from
    ``init_centers`` when given, else from k distinct rows drawn with
    ``generator`` (a CPU generator, so the draw is the same on any device)."""
    descs = descs.float()
    if init_centers is not None:
        centers = torch.as_tensor(init_centers, dtype=torch.float32).to(descs.device)
        if tuple(centers.shape) != (n_clusters, descs.shape[1]):
            raise ValueError(f"init_centers must be [{n_clusters}, {descs.shape[1]}]")
    else:
        idx = torch.from_numpy(draw_rows(descs.shape[0], n_clusters, generator))
        centers = descs[idx.to(descs.device)]
    for _ in range(max_iters):
        centers = _lloyd_step(descs, centers, mode)
    return centers, assign_labels(descs, centers, mode)


def kmeans_fit_streamed(
    descs,
    n_clusters: int,
    mode: str = "cosine",
    max_iters: int = 100,
    shard_rows: int = 100_000,
    *,
    generator: Optional[torch.Generator] = None,
    init_centers=None,
    device: Union[None, str, torch.device] = None,
) -> Tuple[torch.Tensor, np.ndarray]:
    """Lloyd iterations over a descriptor set beyond device memory, the
    fit-side sibling of the blocked retrieval engine: ``descs`` [N, D]
    stays on the host (numpy, ``np.memmap`` or a CPU tensor) and streams
    to ``device`` in ``shard_rows`` slices each iteration through the
    blocked engine's stream (pinned buffers, the copy of the next slice on
    a side stream); only the [C, D] sums and [C] counts stay on the device.
    Same start (``init_centers``, else k distinct rows drawn with
    ``generator``) and update as ``kmeans_fit``: on data that fits, the two
    agree up to the order of float sums. ``device`` None means the card.
    Returns (centers [C, D] on ``device``, labels [N] int64 numpy)."""
    from anyloc_tpu_torch.ops.retrieval import host_rows, stream_rows

    dev = resolve_device(device)
    n, d = descs.shape
    if init_centers is not None:
        centers = torch.as_tensor(init_centers, dtype=torch.float32).to(dev)
        if tuple(centers.shape) != (n_clusters, d):
            raise ValueError(f"init_centers must be [{n_clusters}, {d}]")
    else:
        centers = host_rows(descs[draw_rows(n, n_clusters, generator)]).float().to(dev)
    for _ in range(max_iters):
        sums = torch.zeros((n_clusters, d), dtype=torch.float32, device=dev)
        counts = torch.zeros((n_clusters,), dtype=torch.float32, device=dev)
        for _, shard in stream_rows(descs, shard_rows, dev):
            s, c = _shard_stats(shard, centers, mode)
            sums += s
            counts += c
        centers = _update_centers(sums, counts, centers)
    labels = [assign_labels(shard, centers, mode).cpu()
              for _, shard in stream_rows(descs, shard_rows, dev)]
    return centers, (torch.cat(labels).numpy() if labels else np.zeros((0,), np.int64))


def draw_rows(n: int, k: int, generator: Optional[torch.Generator] = None) -> np.ndarray:
    """k distinct row indices of n, drawn with ``generator`` (the start
    ``kmeans_fit`` takes when given no ``init_centers``)."""
    if n < k:
        raise ValueError(f"{n} descriptors < {k} clusters")
    return torch.randperm(n, generator=generator)[:k].numpy()


class KMeans:
    """``fit`` / ``predict`` / ``.centroids``, the surface the reference's
    VLAD uses."""

    def __init__(self, n_clusters: int, mode: str = "cosine",
                 max_iters: int = 100, seed: int = 42) -> None:
        self.n_clusters = n_clusters
        self.mode = mode
        self.max_iters = max_iters
        self.seed = seed
        self.centroids: Optional[torch.Tensor] = None

    def fit(self, descs, init_centers=None) -> "KMeans":
        descs = torch.as_tensor(descs, dtype=torch.float32)
        gen = torch.Generator().manual_seed(self.seed)
        self.centroids, _ = kmeans_fit(
            descs, self.n_clusters, self.mode, self.max_iters,
            generator=gen, init_centers=init_centers)
        return self

    def predict(self, descs) -> torch.Tensor:
        if self.centroids is None:
            raise RuntimeError("Call fit() first (or set .centroids)")
        descs = torch.as_tensor(descs, dtype=torch.float32).to(self.centroids.device)
        return assign_labels(descs, self.centroids, self.mode)
