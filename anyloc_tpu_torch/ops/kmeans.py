"""k-means with a fixed number of Lloyd iterations (counterpart of
``anyloc_tpu/ops/kmeans.py``).

Assignment is one [N, D] @ [D, C] product (cosine on unit vectors, or the
``2x·c - |c|²`` euclidean expansion); the update is a one-hot product
[C, N] @ [N, D] (deterministic, no atomics); an empty cluster keeps its
center. Init samples k distinct rows with a seeded ``torch.Generator`` —
the JAX package's ``jax.random.choice`` draw cannot be reproduced in torch,
so ``init_centers`` lets a caller give both packages the same start.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from anyloc_tpu_torch.ops.common import l2_normalize


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


def _lloyd_step(descs: torch.Tensor, centers: torch.Tensor, mode: str) -> torch.Tensor:
    onehot = torch.nn.functional.one_hot(
        assign_labels(descs, centers, mode), centers.shape[0]).to(descs.dtype)
    sums = onehot.T @ descs
    counts = onehot.sum(0)
    new = sums / torch.clamp_min(counts, 1.0)[:, None]
    return torch.where(counts[:, None] > 0, new, centers)


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
        if descs.shape[0] < n_clusters:
            raise ValueError(f"{descs.shape[0]} descriptors < {n_clusters} clusters")
        idx = torch.randperm(descs.shape[0], generator=generator)[:n_clusters]
        centers = descs[idx.to(descs.device)]
    for _ in range(max_iters):
        centers = _lloyd_step(descs, centers, mode)
    return centers, assign_labels(descs, centers, mode)


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
