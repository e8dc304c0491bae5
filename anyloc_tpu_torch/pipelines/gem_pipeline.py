"""GeM pooling pipeline (counterpart of ``anyloc_tpu/pipelines/gem_pipeline.py``;
reference scripts/dino_v2_gem.py): patch descriptors -> GeM p-mean global
descriptors, pooled on the engine's device inside each batch -> exact
top-k on that device -> Recall@K. No vocabulary."""

from __future__ import annotations

from typing import Dict, Optional

from anyloc_tpu_torch.config import PipelineArgs
from anyloc_tpu_torch.ops.gem import gem_pool
from anyloc_tpu_torch.ops.retrieval import get_top_k_recall
from anyloc_tpu_torch.pipelines.engine import DescriptorEngine
from anyloc_tpu_torch.pipelines.vlad_pipeline import (
    build_results_dict, dataset_from_args, engine_from_args)


def run_gem_pipeline(largs: PipelineArgs, dataset=None,
                     engine: Optional[DescriptorEngine] = None, verbose: bool = True,
                     device=None) -> Dict:
    """``device`` places the engine built from ``largs`` (None: the card;
    an ``engine`` given keeps its own). Retrieval runs on the engine's
    device."""
    ds_name = largs.prog.vg_dataset_name
    if dataset is None:
        dataset = dataset_from_args(largs, ds_name)
    if engine is None:
        engine = engine_from_args(largs, device)
    # the patch tensor stays on the device; GeM is N times smaller
    def pool_fn(d):
        return gem_pool(d, p=largs.gem_p, use_abs=largs.gem_use_abs)

    agg_key = f"gem{largs.gem_p}{'_abs' if largs.gem_use_abs else ''}"
    db_g = engine.extract_aggregated_dataset(
        dataset, pool_fn, agg_key, "db", largs.sub_sample_db, verbose)
    qu_g = engine.extract_aggregated_dataset(
        dataset, pool_fn, agg_key, "queries", largs.sub_sample_qu, verbose)
    dists, indices, recalls = get_top_k_recall(
        largs.top_k_vals, db_g, qu_g, dataset.get_positives(),
        sub_sample_db=largs.sub_sample_db, sub_sample_qu=largs.sub_sample_qu,
        device=engine.extractor.device,
    )
    results = build_results_dict(largs, db_g, qu_g, recalls, ds_name, agg="GeM")
    results["GeM-p"] = largs.gem_p
    results["Qual-Dists"] = dists
    results["Qual-Indices"] = indices
    if verbose:
        for k in largs.top_k_vals:
            print(f"R@{k}: {recalls[k]:.5f}")
    return results
