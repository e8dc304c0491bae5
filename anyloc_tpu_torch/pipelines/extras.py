"""Long-tail experiment pipelines of the reference's scripts/ inventory
(counterpart of ``anyloc_tpu/pipelines/extras.py``):

  * multilayer VLAD (scripts/dino_multilayer_vlad.py): per-layer VLADs
    concatenated;
  * sliding-window VLAD (scripts/dino_vlad_sliding_window.py): VLAD per
    window of the patch grid, max-similarity retrieval;
  * joint PCA across datasets (scripts/joint_pca_project.py) and recall
    over PCA dims (scripts/pca_downsample_experiment.py);
  * LSeg VLAD over precomputed pixel descriptors (scripts/lseg_vlad.py);
  * sequence clustering and residual-enhanced retrieval from the
    reference's examples/ (trivial_vpr_with_clip.py, vpr_residuals.py).

Every k-means here takes its start (F2): ``init_centers=`` (the JAX
package's ``jax.random`` draw cannot be reproduced in torch, so a test
passes its rows), else rows drawn with a ``torch.Generator`` seeded from
``seed``. Numpy inputs run on ``device`` (None: the card).

Also the contrastive MLP head over VLADs, its loss and its train step
(scripts/dino_vlad_contrastive_train.py).
"""

from __future__ import annotations

import glob
import os
import shutil
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from anyloc_tpu_torch.data.base import natsorted
from anyloc_tpu_torch.ops.common import l2_normalize, resolve_device
from anyloc_tpu_torch.ops.kmeans import KMeans, kmeans_fit
from anyloc_tpu_torch.ops.pca import (as_f32, concat_desc_dists_clusters, pca_fit,
                                      pca_transform, reduce_pca)
from anyloc_tpu_torch.ops.retrieval import get_top_k_recall
from anyloc_tpu_torch.ops.vlad import VLAD, vlad_aggregate

Device = Union[None, str, torch.device]


def _fit(vlad: VLAD, flat: torch.Tensor, init_centers=None) -> VLAD:
    """``vlad.fit(flat)``, from ``init_centers`` when given (rows of the
    normalized descriptors, as ``VLAD.fit`` clusters those)."""
    if init_centers is None:
        vlad.fit(flat)
        return vlad
    x = l2_normalize(flat) if vlad.norm_descs else flat
    vlad.kmeans = KMeans(vlad.num_clusters, mode=vlad.mode, seed=vlad.seed).fit(
        x, init_centers=as_f32(init_centers, x.device))
    vlad.c_centers = vlad.kmeans.centroids
    vlad.desc_dim = int(x.shape[1])
    return vlad


# --------------------------------------------------------------- multi-layer VLAD

def multilayer_vlad(descs_per_layer: Sequence, num_clusters: int, seed: int = 42, *,
                    init_centers: Optional[Sequence] = None, device: Device = None) -> np.ndarray:
    """One vocabulary per layer, fitted on that layer's descriptors
    [B, N, D]; the per-layer VLADs concatenated and L2-normalized ->
    [B, L·C·D]. ``init_centers`` gives each layer's k-means start."""
    outs = []
    for li, descs in enumerate(descs_per_layer):
        x = as_f32(descs, device)
        v = _fit(VLAD(num_clusters, seed=seed + li), x.reshape(-1, x.shape[-1]),
                 None if init_centers is None else init_centers[li])
        outs.append(v.generate_multi(x).cpu().numpy())
    cat = np.concatenate(outs, axis=1)
    return cat / np.maximum(np.linalg.norm(cat, axis=1, keepdims=True), 1e-12)


# --------------------------------------------------------------- sliding-window VLAD

def sliding_window_vlad(descs, grid: Tuple[int, int], centers, window: int, stride: int,
                        device: Device = None) -> np.ndarray:
    """VLAD per spatial window -> [B, n_windows, C·D]; descs [B, N, D] with
    N = gh·gw (row-major grid)."""
    gh, gw = grid
    x = as_f32(descs, device)
    b, n, d = x.shape
    assert n == gh * gw
    x = x.reshape(b, gh, gw, d)
    c = as_f32(centers, x.device)
    wins = []
    for y0 in range(0, gh - window + 1, stride):
        for x0 in range(0, gw - window + 1, stride):
            w = x[:, y0:y0 + window, x0:x0 + window].reshape(b, -1, d)
            wins.append(vlad_aggregate(w.contiguous(), c).cpu().numpy())
    return np.stack(wins, axis=1)


def sliding_window_scores(db_wins: np.ndarray, qu_wins: np.ndarray) -> np.ndarray:
    """Max cosine over all (db window, query window) pairs -> [Q, Ndb]."""
    q = qu_wins.shape[0]
    ndb = db_wins.shape[0]
    sims = np.einsum("qwd,nvd->qnwv", qu_wins, db_wins)
    return sims.reshape(q, ndb, -1).max(axis=-1)


# --------------------------------------------------------------- contrastive MLP head

class ContrastiveMLP(torch.nn.Module):
    """The 2-layer MLP head over VLAD descriptors
    (dino_vlad_contrastive_train.py:344-358): fc1 -> relu -> fc2. ``in_dim``
    (a keyword after the JAX fields) is what Flax infers at the first
    call."""

    def __init__(self, out_dim: int, hidden_dim: int = 512, *, in_dim: int = 512) -> None:
        super().__init__()
        self.fc1 = torch.nn.Linear(in_dim, hidden_dim)
        self.fc2 = torch.nn.Linear(hidden_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.fc1(x)))


def contrastive_loss(emb: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor,
                     temp: float = 1.0) -> torch.Tensor:
    """The reference's loss (:360-381): -log(sum_p e^{cos(a,p)/T} /
    sum_n e^{cos(a,n)/T}), averaged over the batch. emb [B, D], pos
    [B, P, D], neg [B, N, D]."""
    ea = l2_normalize(emb)[:, None, :]
    sp = (ea * l2_normalize(pos)).sum(-1)   # [B, P]
    sn = (ea * l2_normalize(neg)).sum(-1)   # [B, N]
    return (-torch.log(torch.exp(sp / temp).sum(-1) / torch.exp(sn / temp).sum(-1))).mean()


def make_contrastive_train_step(mlp: ContrastiveMLP, optimizer, temp: float = 1.0):
    """``step(params, opt_state, anchor, pos, neg) -> (params, opt_state,
    loss)``: ``params`` a dict {name: tensor} of the head's (the
    optimizer's leaves, updated in place), ``opt_state`` the torch.optim
    optimizer over them; ``step.init_state(params) -> (params, opt_state)``
    makes both from a state dict and ``optimizer`` (a factory or a built
    optimizer, as in ``training.triplet``)."""
    from anyloc_tpu_torch.training.triplet import make_optimizer, trainable_leaves

    def step(params, opt_state, anchor, pos, neg):
        def f(x):
            return torch.func.functional_call(mlp, params, (x,))

        opt_state.zero_grad(set_to_none=True)
        loss = contrastive_loss(
            f(anchor), f(pos.reshape(-1, pos.shape[-1])).reshape(*pos.shape[:-1], -1),
            f(neg.reshape(-1, neg.shape[-1])).reshape(*neg.shape[:-1], -1), temp)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    def init_state(params):
        leaves = trainable_leaves(params, optimizer)
        return leaves, make_optimizer(optimizer, list(leaves.values()))

    step.init_state = init_state
    return step


# --------------------------------------------------------------- PCA tools

def joint_pca_project(desc_sets: Mapping[str, np.ndarray], lower_dim: int,
                      whiten: bool = False, device: Device = None) -> Dict[str, np.ndarray]:
    """One PCA fitted on every dataset's descriptors together, each
    projected with it (scripts/joint_pca_project.py)."""
    allx = as_f32(np.concatenate([np.asarray(v, np.float32) for v in desc_sets.values()]),
                  device)
    mean, comps, scale = pca_fit(allx, lower_dim, whiten=whiten)
    return {k: pca_transform(as_f32(v, allx.device), mean, comps, scale).cpu().numpy()
            for k, v in desc_sets.items()}


def pca_downsample_experiment(db, qu, gt_pos, dims: Sequence[int],
                              top_k: Sequence[int] = (1, 5, 10),
                              device: Device = None) -> Dict[int, Dict[int, float]]:
    """Recall against the PCA-reduced dimension
    (scripts/pca_downsample_experiment.py)."""
    dev = resolve_device(device)
    out = {}
    for dim in dims:
        db_r, qu_r = reduce_pca(db, qu, dim, device=dev)
        _, _, recalls = get_top_k_recall(list(top_k), db_r, qu_r, gt_pos, device=dev)
        out[dim] = recalls
    return out


# --------------------------------------------------------------- LSeg VLAD

def lseg_vlad(db_cache_dir: str, query_cache_dir: str, soft_positives, num_clusters: int = 64,
              top_k_vals: Sequence[int] = tuple(range(1, 21)), sub_sample_db: int = 1,
              sub_sample_qu: int = 1, sub_sample_db_vlad: int = 1, sub_sample_pixels: int = 1,
              use_inorm: bool = True, vlad_assignment: str = "hard",
              vlad_soft_temp: float = 1.0, *, init_centers=None, device: Device = None):
    """The reference's LSeg ablation (scripts/lseg_vlad.py:158-232): it
    runs no LSeg model, it reads precomputed per-image ``.npy`` pixel
    descriptors [H, W, D] (natsorted, file-level and ``[::s, ::s]`` pixel
    sub-sampling), fits the vocabulary on the database pixels
    (``sub_sample_db_vlad`` within ``sub_sample_db``), VLADs every image
    and scores Recall@K, with the sub-sampled ground truth corrected.
    Returns (dists, indices, recalls)."""
    dev = resolve_device(device)

    def load(dirname, sub):
        files = natsorted(glob.glob(os.path.join(dirname, "*.npy")))[::sub]
        if not files:
            raise FileNotFoundError(f"no .npy descriptor caches in {dirname}")
        return np.stack([np.load(f)[::sub_sample_pixels, ::sub_sample_pixels, :]
                         .astype(np.float32) for f in files])   # [N, H, W, D]

    db = load(db_cache_dir, sub_sample_db)
    qu = load(query_cache_dir, sub_sample_qu)
    n, h, w, d = db.shape
    vlad = VLAD(num_clusters, intra_norm=use_inorm, vlad_mode=vlad_assignment,
                soft_temp=vlad_soft_temp)
    _fit(vlad, as_f32(db.reshape(-1, d)[::sub_sample_db_vlad], dev), init_centers)
    db_vlads = vlad.generate_multi(as_f32(db.reshape(n, h * w, d), dev))
    qu_vlads = vlad.generate_multi(as_f32(qu.reshape(qu.shape[0], -1, d), dev))
    return get_top_k_recall(list(top_k_vals), db_vlads, qu_vlads, soft_positives,
                            sub_sample_db=sub_sample_db, sub_sample_qu=sub_sample_qu,
                            device=dev)


# --------------------------------------------------------------- the reference's examples/

def sequence_clusters(descs, n_clusters: int = 10, use_pca: bool = False,
                      n_components: int = 256, seed: int = 0, *, init_centers=None,
                      generator: Optional[torch.Generator] = None,
                      device: Device = None) -> np.ndarray:
    """Cosine k-means of per-image global descriptors, optionally after
    PCA (examples/trivial_vpr_with_clip.py:94-121) -> per-image labels.
    ``pca_fit`` raises when ``n_components`` exceeds min(n_samples,
    n_features), as sklearn does: no silent clamping."""
    x = as_f32(descs, device)
    if use_pca:
        x = pca_transform(x, *pca_fit(x, n_components))
    if init_centers is None and generator is None:
        generator = torch.Generator().manual_seed(seed)
    _, labels = kmeans_fit(x, n_clusters, mode="cosine", generator=generator,
                           init_centers=None if init_centers is None
                           else as_f32(init_centers, x.device))
    return labels.cpu().numpy()


def group_images_by_cluster(imgfiles: Sequence[str], labels,
                            save_dir: str) -> Dict[int, List[str]]:
    """Copy a natsorted image sequence into one directory per cluster
    (examples/trivial_vpr_with_clip.py:118-131, byte-identical copies).
    Returns {cluster: [destination paths]}."""
    labels = np.asarray(labels)
    if len(imgfiles) != len(labels):
        raise ValueError(f"{len(imgfiles)} images vs {len(labels)} labels")
    out: Dict[int, List[str]] = {}
    for k in sorted(set(int(v) for v in labels)):
        os.makedirs(os.path.join(save_dir, str(k)), exist_ok=True)
    for f, lab in zip(imgfiles, labels):
        dst = os.path.join(save_dir, str(int(lab)), os.path.basename(f))
        shutil.copyfile(f, dst)
        out.setdefault(int(lab), []).append(dst)
    return out


def _natural_key(path: str):
    """natsort-style key: the basename split into (text, int) runs, so
    ``img_2`` sorts before ``img_10`` (the reference natsorts the glob
    before striding, examples/trivial_vpr_with_clip.py)."""
    import re

    name = os.path.basename(path)
    return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", name)]


def trivial_clip_vpr(imgfiles: Sequence[str], encode_fn, stride: int = 1,
                     feat_dir: Optional[str] = None, n_clusters: int = 10, use_pca: bool = False,
                     n_components: int = 256, save_dir: Optional[str] = None, seed: int = 0,
                     cache_tag: str = "", *, init_centers=None, device: Device = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Image-level CLIP VPR over a directory sequence
    (examples/trivial_vpr_with_clip.py end to end): natural-sort the file
    list, stride-subsample it, encode each image to one L2-normalized
    global descriptor with ``encode_fn(path) -> [1, D]`` (e.g. a
    ClipWrapper image encode), optionally cache the vectors as per-image
    ``.npy`` files, then cluster the sequence with cosine k-means
    (optionally after PCA; ``sequence_clusters``, whose start is
    ``init_centers`` or rows drawn from ``seed``) and copy the images into
    per-cluster folders. Returns (descs [N, D], labels [N]).

    Cache files are keyed by the image's basename stem plus ``cache_tag``
    and never invalidated: when switching encoders, or when two directories
    share stems, pass a distinct ``cache_tag`` or a fresh ``feat_dir``. A
    cached vector whose dimension disagrees with the run's is re-encoded."""
    files = sorted(imgfiles, key=_natural_key)[::stride]
    descs = []
    seen_dim: Optional[int] = None
    tag = f".{cache_tag}" if cache_tag else ""
    for f in files:
        stem = os.path.splitext(os.path.basename(f))[0]
        cached = os.path.join(feat_dir, stem + tag + ".npy") if feat_dir is not None else None
        v = None
        if cached is not None and os.path.exists(cached):
            v = np.load(cached)
            if seen_dim is not None and v.size != seen_dim:
                v = None   # a stale cache (another dimension): encode again
        if v is None:
            out = encode_fn(f)
            out = out.detach().cpu().numpy() if isinstance(out, torch.Tensor) else out
            v = np.asarray(out, np.float32).reshape(1, -1)
            v = v / max(float(np.linalg.norm(v)), 1e-12)
            if cached is not None:
                os.makedirs(feat_dir, exist_ok=True)
                np.save(cached, v)
        if seen_dim is None:
            seen_dim = v.size
        descs.append(v.reshape(1, -1))
    descs = np.concatenate(descs, axis=0)
    labels = sequence_clusters(descs, n_clusters=n_clusters, use_pca=use_pca,
                               n_components=n_components, seed=seed, init_centers=init_centers,
                               device=device)
    if save_dir is not None:
        group_images_by_cluster(files, labels, save_dir)
    return descs, labels


def residual_vpr(db_descs, qu_descs, soft_positives,
                 cluster_sizes: Sequence[int] = (4, 8, 16, 32, 64),
                 top_k: Sequence[int] = (1, 5, 10, 15, 20), seed: int = 0, *,
                 init_centers: Optional[Mapping[int, np.ndarray]] = None,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None) -> Dict[int, Dict[int, float]]:
    """Residual-enhanced retrieval (examples/vpr_residuals.py): L2-normalize
    the global descriptors, fit cosine k-means on the database per cluster
    count, expand both sides with the residual-concat descriptor
    (``concat_desc_dists_clusters``), inner-product top-k, Recall@K.
    ``init_centers`` maps a cluster count to its k-means start; otherwise
    ``generator`` (default: one seeded with ``seed`` per count) draws the
    start rows.
    Returns {n_clusters: {k: recall}}."""
    db = l2_normalize(as_f32(db_descs, device))
    qu = l2_normalize(as_f32(qu_descs, db.device))
    out: Dict[int, Dict[int, float]] = {}
    for c in cluster_sizes:
        init = None if init_centers is None else as_f32(init_centers[int(c)], db.device)
        # one seed for every cluster count, as the JAX package's key
        gen = generator if generator is not None else torch.Generator().manual_seed(seed)
        centers, _ = kmeans_fit(db, int(c), mode="cosine", generator=gen, init_centers=init)
        edb = concat_desc_dists_clusters(centers, db)
        eq = concat_desc_dists_clusters(centers, qu)
        _, _, recalls = get_top_k_recall(list(top_k), edb, eq, soft_positives,
                                         device=db.device)
        out[int(c)] = recalls
    return out
