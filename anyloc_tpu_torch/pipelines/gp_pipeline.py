"""Global-pooling pipeline (counterpart of ``anyloc_tpu/pipelines/gp_pipeline.py``;
reference scripts/dino_v2_gp.py): patch descriptors -> global max or mean
pooling on the engine's device -> exact top-k there -> Recall@K."""

from __future__ import annotations

from typing import Dict, Optional

from anyloc_tpu_torch.config import PipelineArgs
from anyloc_tpu_torch.ops.pooling import global_avg_pool, global_max_pool
from anyloc_tpu_torch.ops.retrieval import get_top_k_recall
from anyloc_tpu_torch.pipelines.engine import DescriptorEngine
from anyloc_tpu_torch.pipelines.vlad_pipeline import (
    build_results_dict, dataset_from_args, engine_from_args)


def run_gp_pipeline(largs: PipelineArgs, dataset=None,
                    engine: Optional[DescriptorEngine] = None, pooling: str = "max",
                    verbose: bool = True, device=None) -> Dict:
    """``device`` places the engine built from ``largs`` (None: the card;
    an ``engine`` given keeps its own). Retrieval runs on the engine's
    device."""
    assert pooling in ("max", "avg"), pooling
    pool = global_max_pool if pooling == "max" else global_avg_pool
    ds_name = largs.prog.vg_dataset_name
    if dataset is None:
        dataset = dataset_from_args(largs, ds_name)
    if engine is None:
        engine = engine_from_args(largs, device)
    db = engine.extract_aggregated_dataset(
        dataset, pool, f"gp_{pooling}", "db", largs.sub_sample_db, verbose)
    qu = engine.extract_aggregated_dataset(
        dataset, pool, f"gp_{pooling}", "queries", largs.sub_sample_qu, verbose)
    dists, indices, recalls = get_top_k_recall(
        largs.top_k_vals, db, qu, dataset.get_positives(),
        sub_sample_db=largs.sub_sample_db, sub_sample_qu=largs.sub_sample_qu,
        device=engine.extractor.device,
    )
    results = build_results_dict(largs, db, qu, recalls, ds_name, agg=f"GP-{pooling}")
    results["Qual-Dists"], results["Qual-Indices"] = dists, indices
    return results
