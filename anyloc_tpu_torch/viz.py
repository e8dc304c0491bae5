"""Visualization + paper utilities (counterpart of ``anyloc_tpu/viz.py``;
matplotlib and scikit-learn are imported by the functions that need them).

Covers the reference's qualitative/figure surface (SURVEY.md §2.3, §2.9):
  * ``radar_chart`` — the paper's per-domain R@1 radar figure with the
    published aggregates as defaults (paper_utils/radar_chart.py:104-121);
  * ``recall_curve`` — per-experiment recall@k plot (the scripts' show_plot);
  * ``cluster_assignment_map`` — per-patch VLAD cluster colors over the
    image grid (scripts/dino_v2_vlad_viz.py, demo/gradio_imgs_vlad_clusters);
  * ``similarity_map`` — pixel-to-image facet similarity
    (scripts/dino_v2_sim_facets.py get_sims);
  * ``tsne_projection`` — GeM-descriptor domain projection
    (scripts/dino_v2_datasets_tsne_clustering.py, HF-space domain picker).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Published headline R@1 aggregates (reference radar_chart.py:104-121).
PAPER_RADAR_AXES = [
    "Indoor", "Outdoor", "Day-vs-Night", "SubT", "Aerial", "Underwater",
    "Viewpoint", "Opp-Viewpoint",
]
PAPER_RADAR_R1 = {
    "NetVLAD": [57.73, 65.63, 28.28, 26.46, 18.81, 21.78, 71.28, 18.52],
    "CosPlace": [58.90, 93.71, 47.88, 31.95, 35.64, 30.69, 55.32, 22.22],
    "MixVPR": [73.24, 93.74, 64.22, 46.61, 45.54, 24.75, 80.85, 44.44],
    "AnyLoc-GeM-DINOv2": [67.23, 78.37, 51.62, 42.79, 35.64, 27.72, 53.19, 40.74],
    "AnyLoc-VLAD-DINO": [73.32, 83.48, 52.49, 53.11, 62.38, 29.70, 63.83, 44.44],
    "AnyLoc-VLAD-DINOv2": [78.58, 94.26, 86.49, 63.43, 76.24, 34.65, 76.54, 67.64],
}


def _agg_backend():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def radar_chart(
    data: Optional[Dict[str, Sequence[float]]] = None,
    axes_labels: Optional[List[str]] = None,
    output_path: str = "radar_chart.png",
):
    plt = _agg_backend()
    data = data or PAPER_RADAR_R1
    labels = axes_labels or PAPER_RADAR_AXES
    n = len(labels)
    angles = np.linspace(0, 2 * np.pi, n, endpoint=False).tolist() + [0.0]
    fig, ax = plt.subplots(subplot_kw=dict(polar=True), figsize=(7, 7))
    for name, vals in data.items():
        v = list(vals) + [vals[0]]
        ax.plot(angles, v, label=name, linewidth=1.6)
        ax.fill(angles, v, alpha=0.06)
    ax.set_xticks(angles[:-1])
    ax.set_xticklabels(labels)
    ax.set_ylim(0, 100)
    ax.legend(loc="upper right", bbox_to_anchor=(1.35, 1.1), fontsize=8)
    fig.savefig(output_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return output_path


def recall_curve(
    recalls: Dict[int, float], output_path: str = "recalls.png",
    title: str = "Recall curve",
):
    plt = _agg_backend()
    ks = sorted(recalls)
    fig, ax = plt.subplots()
    ax.plot(ks, [recalls[k] for k in ks], marker="o")
    ax.set_ylim(0, 1)
    ax.set_xticks(ks)
    ax.set_xlabel("top-k")
    ax.set_ylabel("% recall")
    ax.set_title(title)
    fig.savefig(output_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return output_path


_CLUSTER_COLORS = np.array([
    [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
    [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
    [210, 245, 60], [250, 190, 212], [0, 128, 128], [220, 190, 255],
    [170, 110, 40], [255, 250, 200], [128, 0, 0], [170, 255, 195],
    [128, 128, 0], [255, 215, 180], [0, 0, 128], [128, 128, 128],
], np.uint8)


def cluster_assignment_map(
    descs: np.ndarray,  # [N, D] patch descriptors (row-major grid)
    centers: np.ndarray,  # [C, D]
    grid: Tuple[int, int],
    image: Optional[np.ndarray] = None,  # [H, W, 3] uint8 for overlay
    alpha: float = 0.5,
    *,
    device=None,
) -> np.ndarray:
    """Per-patch hard-assignment colors upsampled to the image (the gradio
    demo's per-pixel cluster overlay). Returns an RGB uint8 image. The
    labels come from ``ops.kmeans.assign_labels`` (cosine) on ``device``
    (None: the card)."""
    import torch

    from anyloc_tpu_torch.ops.common import resolve_device
    from anyloc_tpu_torch.ops.kmeans import assign_labels

    dev = resolve_device(device)
    labels = assign_labels(torch.as_tensor(descs).to(dev),
                           torch.as_tensor(centers).to(dev)).cpu().numpy()
    gh, gw = grid
    colors = _CLUSTER_COLORS[labels % len(_CLUSTER_COLORS)]
    cmap = colors.reshape(gh, gw, 3)
    if image is None:
        return cmap
    h, w = image.shape[:2]
    # index-map upsample: pixel (y, x) takes its patch's color exactly
    # (repeat-by-(h//gh+1) drifts cells and truncates the last row/column)
    up = cmap[np.arange(h) * gh // h][:, np.arange(w) * gw // w]
    out = (alpha * up + (1 - alpha) * image).astype(np.uint8)
    return out


def similarity_map(
    query_desc: np.ndarray,  # [D] one patch/pixel descriptor
    target_descs: np.ndarray,  # [N, D]
    grid: Tuple[int, int],
) -> np.ndarray:
    """Cosine similarity of one descriptor against a target image's patch
    grid (dino_v2_sim_facets.py get_sims) -> [gh, gw] float in [-1, 1]."""
    q = query_desc / max(np.linalg.norm(query_desc), 1e-12)
    t = target_descs / np.maximum(
        np.linalg.norm(target_descs, axis=-1, keepdims=True), 1e-12
    )
    return (t @ q).reshape(grid)


def tsne_projection(
    desc_sets: Dict[str, np.ndarray],
    perplexity: float = 10.0,
    seed: int = 42,
) -> Dict[str, np.ndarray]:
    """Joint 2-D t-SNE of per-dataset global descriptors (the dataset-domain
    projections behind the HF-space domain picker). Returns {name: [N, 2]}."""
    from sklearn.manifold import TSNE

    names, lens, allx = [], [], []
    for k, v in desc_sets.items():
        names.append(k)
        lens.append(len(v))
        allx.append(np.asarray(v, np.float32))
    x = np.concatenate(allx)
    emb = TSNE(
        n_components=2, perplexity=min(perplexity, max(2, len(x) // 4)),
        random_state=seed, init="pca",
    ).fit_transform(x)
    out = {}
    ofs = 0
    for k, n in zip(names, lens):
        out[k] = emb[ofs : ofs + n]
        ofs += n
    return out


def pca_projection(desc_sets: Dict[str, np.ndarray], *, device=None) -> Dict[str, np.ndarray]:
    """2-D PCA variant of the same projection (gem_pca_clustering), fitted
    on ``device`` (None: the card)."""
    from anyloc_tpu_torch.pipelines.extras import joint_pca_project

    return joint_pca_project(desc_sets, 2, device=device)


def ablation_plot(
    csv_paths: Dict[str, str],
    x_col: str,
    y_col: str = "R@1",
    output_path: str = "ablation.png",
    title: str = "",
):
    """Line plot of recall vs a swept hyperparameter from result CSVs —
    the paper_utils/data/ablations figure generator (facet / layer / cluster
    sweeps). CSV columns are the WandB-export style the reference stores."""
    import csv as _csv

    plt = _agg_backend()
    fig, ax = plt.subplots()
    for name, path in csv_paths.items():
        xs, ys = [], []
        with open(path) as f:
            for row in _csv.DictReader(f):
                if x_col in row and y_col in row and row[y_col]:
                    xs.append(row[x_col])
                    ys.append(float(row[y_col]))
        try:
            order = np.argsort([float(x) for x in xs])
            xs = [xs[i] for i in order]
            ys = [ys[i] for i in order]
        except ValueError:
            pass  # categorical x (facets)
        ax.plot(xs, ys, marker="o", label=name)
    ax.set_xlabel(x_col)
    ax.set_ylabel(y_col)
    ax.set_title(title)
    ax.legend(fontsize=8)
    fig.savefig(output_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return output_path
