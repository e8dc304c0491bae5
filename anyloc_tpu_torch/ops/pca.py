"""PCA on the device (counterpart of ``anyloc_tpu/ops/pca.py``; the
reference's sklearn PCA, utilities.py:522-586 ``reduce_pca``): fit on the
training rows, transform both sides; optional whitening; the
``low_factor`` mix of the lowest-variance directions; the ``fallback``
projection when there are fewer samples than dimensions.

The SVD is ``torch.linalg.svd`` (LAPACK on the CPU, cuSOLVER on the
card): each component's sign is the solver's choice, as it is XLA's, so
two solvers agree on the components up to a sign per row. Float32
products stay float32 (the port never enables TF32).
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import numpy as np
import torch

from anyloc_tpu_torch.ops.common import l2_normalize, resolve_device


def as_f32(x, device: Union[None, str, torch.device] = None) -> torch.Tensor:
    """A float32 tensor: a tensor stays on its device unless ``device`` is
    named; numpy goes to ``device`` (None: the card)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=x.device if device is None else device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(x, np.float32)).to(resolve_device(device))


def pca_fit(x: torch.Tensor, n_components: int,
            whiten: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fit on x [N, D] -> (mean [D], components [n_components, D], scale
    [n_components]); transform = ((x - mean) @ components.T) / scale.
    ``scale`` is 1, or sqrt(explained variance) with ``whiten`` (sklearn)."""
    rank = min(x.shape)
    if n_components > rank:
        raise ValueError(
            f"n_components={n_components} exceeds min(n_samples, n_features)="
            f"{rank} (sklearn raises here too; use the low_factor fallback "
            "path of reduce_pca for few-sample regimes)")
    x = x.float()
    mean = x.mean(0)
    _, s, vt = torch.linalg.svd(x - mean, full_matrices=False)
    components = vt[:n_components]
    if whiten:
        scale = torch.clamp_min(s[:n_components] / math.sqrt(max(x.shape[0] - 1, 1)), 1e-12)
    else:
        scale = torch.ones((n_components,), dtype=torch.float32, device=x.device)
    return mean, components, scale


def pca_transform(x: torch.Tensor, mean: torch.Tensor, components: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    return (x.float() - mean) @ components.T / scale


def reduce_pca(train_descs, test_descs, lower_dim: int, low_factor: float = 0.0,
               fallback: int = 256, svd_solver: str = "full", whitening: bool = False,
               device: Union[None, str, torch.device] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Drop-in for utilities.py:522-586 -> (train, test) numpy. Numpy
    inputs run on ``device`` (None: the card), tensors on their own."""
    del svd_solver   # the SVD is always exact
    assert 0 <= low_factor <= 1
    train = as_f32(train_descs, device)
    test = as_f32(test_descs, train.device)
    if low_factor == 0.0:
        mean, comps, scale = pca_fit(train, lower_dim, whiten=whitening)
        return (pca_transform(train, mean, comps, scale).cpu().numpy(),
                pca_transform(test, mean, comps, scale).cpu().numpy())
    n_samples, n_components = train.shape
    if n_samples < n_components:
        # too few samples: project everything to `fallback` dims first,
        # fitted on the concatenation as the reference does (:566-575)
        allx = torch.cat([train, test])
        mean, comps, scale = pca_fit(allx, fallback)
        alld = pca_transform(allx, mean, comps, scale)
        train, test = alld[:n_samples], alld[n_samples:]
    down = int(low_factor * lower_dim)
    up = lower_dim - down
    rank = min(train.shape)
    mean, comps, _ = pca_fit(train, rank)
    tf = torch.cat([comps[:up], comps[rank - down:]])
    return ((train - mean) @ tf.T).cpu().numpy(), ((test - mean) @ tf.T).cpu().numpy()


def concat_desc_dists_clusters(cluster_centers, descs,
                               device: Union[None, str, torch.device] = None) -> torch.Tensor:
    """The residual-concat descriptor (utilities.py:590-619): per
    descriptor, its intra-normalized residuals to every center,
    concatenated and L2-normalized. centers [C, D], descs [N, D] -> [N, C·D]
    on the descriptors' device (numpy: ``device``, None the card)."""
    descs = as_f32(descs, device)
    centers = as_f32(cluster_centers, descs.device)
    ndists = l2_normalize(descs[:, None, :] - centers[None, :, :])
    return l2_normalize(ndists.reshape(descs.shape[0], -1))
