"""CLIP pipelines (counterpart of ``anyloc_tpu/pipelines/clip_pipelines.py``):

* ``run_clip_top_k``: CLIP global image embeddings -> (optional PCA) ->
  top-k recall (the reference's scripts/clip_top_k_vpr.py:168-370);
* ``run_patch_clip``: each image unfolds into a grid of half-overlapping
  crops, each crop is CLIP-encoded and the crops' descriptors are
  VLAD-aggregated (scripts/patch_clip.py:195-205: kernel = stride =
  2·size/num_patches).

Both run the CLIP vision tower in float32 (as the JAX pipelines do) on
``device`` (None: the card), and their VLAD (K1) and top-k there too.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from anyloc_tpu_torch.config import PipelineArgs
from anyloc_tpu_torch.ops.common import resolve_device
from anyloc_tpu_torch.ops.pca import reduce_pca
from anyloc_tpu_torch.ops.retrieval import get_top_k_recall
from anyloc_tpu_torch.ops.vlad import VLAD
from anyloc_tpu_torch.pipelines.vlad_pipeline import build_results_dict, dataset_from_args


def _check_flags(largs: PipelineArgs) -> None:
    if largs.extractor.quant or largs.extractor.transfer_dtype != "float32":
        # the serving flags apply to the facet-extractor pipelines only;
        # refusing beats running full precision while the user believes
        # otherwise
        raise ValueError(
            "extractor.quant / extractor.transfer_dtype are not supported by this pipeline")


def _clip_model(largs: PipelineArgs, device):
    from anyloc_tpu_torch.models.clip import ClipWrapper

    name = largs.extractor.model_type
    if name.startswith("clip_"):
        name = name[len("clip_"):]
    return ClipWrapper(ClipWrapper.IMPL_OPENAI, name, use_caching=False,
                       checkpoint=largs.extractor.checkpoint, device=device)


def _encode_dataset(m, dataset, which, sub_sample, batch_size) -> torch.Tensor:
    """[N, embed] L2-normalized embeddings of the selected images, on the
    model's device."""
    feats = []
    for imgs, bidx in dataset.batches(batch_size, which=which, sub_sample=sub_sample):
        f = m.encode_image(imgs, normalize=True)
        feats.append(f[torch.from_numpy(bidx >= 0).to(f.device)])
    return torch.cat(feats)


def run_clip_top_k(largs: PipelineArgs, dataset=None, pca_dim: Optional[int] = None,
                   verbose: bool = True, device=None) -> Dict:
    _check_flags(largs)
    device = resolve_device(device)
    ds_name = largs.prog.vg_dataset_name
    if dataset is None:
        dataset = dataset_from_args(largs, ds_name)
    m = _clip_model(largs, device)
    bs = largs.extractor.batch_size
    db = _encode_dataset(m, dataset, "db", largs.sub_sample_db, bs)
    qu = _encode_dataset(m, dataset, "queries", largs.sub_sample_qu, bs)
    if pca_dim is not None:
        db, qu = reduce_pca(db, qu, pca_dim, device=device)
    dists, indices, recalls = get_top_k_recall(
        largs.top_k_vals, db, qu, dataset.get_positives(),
        sub_sample_db=largs.sub_sample_db, sub_sample_qu=largs.sub_sample_qu, device=device)
    results = build_results_dict(largs, db, qu, recalls, ds_name, agg="CLIP-global")
    results["Qual-Dists"], results["Qual-Indices"] = dists, indices
    return results


def unfold_crops(imgs: np.ndarray, num_patches: int) -> np.ndarray:
    """[B, H, W, 3] -> [B, num_crops, h, w, 3] half-overlapping grid crops
    (patch_clip.py:196-201: kernel = stride = 2·dim/num_patches)."""
    b, h, w, c = imgs.shape
    kh = sh = max(1, int(h * 2 / num_patches))
    kw = sw = max(1, int(w * 2 / num_patches))
    crops = [imgs[:, y0:y0 + kh, x0:x0 + kw]
             for y0 in range(0, h - kh + 1, sh) for x0 in range(0, w - kw + 1, sw)]
    return np.stack(crops, axis=1)


def run_patch_clip(largs: PipelineArgs, dataset=None, num_patches: int = 4,
                   verbose: bool = True, device=None) -> Dict:
    _check_flags(largs)
    device = resolve_device(device)
    ds_name = largs.prog.vg_dataset_name
    if dataset is None:
        dataset = dataset_from_args(largs, ds_name)
    m = _clip_model(largs, device)
    bs = max(1, largs.extractor.batch_size // num_patches)

    def crop_descs(which, sub_sample) -> torch.Tensor:
        out = []
        for imgs, bidx in dataset.batches(bs, which=which, sub_sample=sub_sample):
            crops = unfold_crops(imgs, num_patches)   # [B, n, h, w, 3]
            bsz, n = crops.shape[:2]
            f = m.encode_image(crops.reshape((-1,) + crops.shape[2:]), normalize=True)
            f = f.reshape(bsz, n, -1)
            out.append(f[torch.from_numpy(bidx >= 0).to(f.device)])
        return torch.cat(out)

    db_descs = crop_descs("db", largs.sub_sample_db)
    qu_descs = crop_descs("queries", largs.sub_sample_qu)
    vlad = VLAD(largs.vlad.num_clusters, vlad_mode=largs.vlad.vlad_assignment,
                cache_dir=largs.vlad.cache_dir)
    if vlad.can_use_cache_vlad():
        vlad.fit(None)
    else:
        vlad.fit(db_descs.reshape(-1, db_descs.shape[-1]))
    db_v = vlad.generate_multi(db_descs)
    qu_v = vlad.generate_multi(qu_descs)
    dists, indices, recalls = get_top_k_recall(
        largs.top_k_vals, db_v, qu_v, dataset.get_positives(),
        sub_sample_db=largs.sub_sample_db, sub_sample_qu=largs.sub_sample_qu, device=device)
    results = build_results_dict(largs, db_v, qu_v, recalls, ds_name, agg="Patch-CLIP-VLAD")
    results["Qual-Dists"], results["Qual-Indices"] = dists, indices
    return results
