"""Per-dataset-vocabulary VLAD pipeline (counterpart of
``anyloc_tpu/pipelines/vlad_pipeline.py``; reference scripts/dino_v2_vlad.py):
vocabulary fitted on the target dataset's own database images, then fused
extract + VLAD, exact top-k on the card and Recall@K. The results dict's
keys match the reference's (dino_v2_global_vocab_vlad.py:560-573).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from anyloc_tpu_torch.config import PipelineArgs
from anyloc_tpu_torch.data.registry import get_dataset
from anyloc_tpu_torch.ops.retrieval import get_top_k_recall
from anyloc_tpu_torch.ops.vlad import VLAD
from anyloc_tpu_torch.pipelines.engine import DescriptorEngine


def build_results_dict(largs: PipelineArgs, db_vlads, qu_vlads, recalls,
                       ds_name: str, agg: str = "VLAD") -> Dict:
    ts = time.strftime("%Y_%m_%d_%H_%M_%S")
    results = {
        "Model-Type": str(largs.extractor.model_type),
        "Desc-Layer": str(largs.extractor.desc_layer),
        "Desc-Facet": str(largs.extractor.desc_facet),
        "Desc-Dim": str(db_vlads.shape[1] // largs.vlad.num_clusters)
        if agg == "VLAD" else str(db_vlads.shape[1]),
        "VLAD-Dim": str(db_vlads.shape[1]),
        "Num-Clusters": str(largs.vlad.num_clusters),
        "Experiment-ID": str(largs.exp_id),
        "DB-Name": str(ds_name),
        "Num-DB": str(len(db_vlads)),
        "Num-QU": str(len(qu_vlads)),
        "Agg-Method": agg,
        "Timestamp": str(ts),
    }
    for k, v in recalls.items():
        results[f"R@{k}"] = v
    return results


def dataset_from_args(largs: PipelineArgs, name: str):
    """The registry's dataset ``name`` at the arguments' root, split, load
    size and positive radius."""
    return get_dataset(
        name, largs.prog.data_vg_dir, largs.data_split,
        img_size=tuple(largs.bd_args.resize),
        dist_thresh=largs.bd_args.val_positive_dist_threshold,
    )


def engine_from_args(largs: PipelineArgs, device=None) -> DescriptorEngine:
    e = largs.extractor
    return DescriptorEngine(
        e.model_type, e.desc_layer, e.desc_facet, e.checkpoint, e.dtype,
        e.batch_size, quant=e.quant, transfer_dtype=e.transfer_dtype,
        device=device,
    )


def fit_vocabulary(largs: PipelineArgs, engine: DescriptorEngine, vocab_dataset,
                   verbose: bool) -> VLAD:
    """VLAD over a vocabulary read from ``largs.vlad.cache_dir`` or fitted
    on the database images of ``vocab_dataset``; without a descriptor cache
    those facets stay on the device for the k-means."""
    vlad = VLAD(
        largs.vlad.num_clusters,
        vlad_mode=largs.vlad.vlad_assignment,
        soft_temp=largs.vlad.vlad_soft_temp,
        cache_dir=largs.vlad.cache_dir,
    )
    if vlad.can_use_cache_vlad():
        vlad.fit(None)
    else:
        vocab_descs = engine.extract_dataset(
            vocab_dataset, "db", largs.sub_sample_db_vlad, verbose,
            keep_on_device=engine.desc_cache is None,
        )
        vlad.fit(vocab_descs.reshape(-1, vocab_descs.shape[-1]))
    return vlad


def run_vlad_pipeline(
    largs: PipelineArgs, dataset=None, engine: Optional[DescriptorEngine] = None,
    verbose: bool = True, device=None,
) -> Dict:
    """``device`` places the engine built from ``largs`` (None: the card;
    an ``engine`` given keeps its own). Retrieval runs on the engine's
    device."""
    ds_name = largs.prog.vg_dataset_name
    if dataset is None:
        dataset = dataset_from_args(largs, ds_name)
    if engine is None:
        engine = engine_from_args(largs, device)
    vlad = fit_vocabulary(largs, engine, dataset, verbose)

    # fused extract + aggregate: only the VLAD vectors leave the device
    db_vlads = engine.extract_vlads_dataset(
        dataset, vlad, "db", largs.sub_sample_db, verbose)
    qu_vlads = engine.extract_vlads_dataset(
        dataset, vlad, "queries", largs.sub_sample_qu, verbose)

    dists, indices, recalls = get_top_k_recall(
        largs.top_k_vals, db_vlads, qu_vlads, dataset.get_positives(),
        sub_sample_db=largs.sub_sample_db, sub_sample_qu=largs.sub_sample_qu,
        device=engine.extractor.device,
    )
    results = build_results_dict(largs, db_vlads, qu_vlads, recalls, ds_name)
    results["Qual-Dists"] = dists
    results["Qual-Indices"] = indices
    if verbose:
        for k in largs.top_k_vals:
            print(f"R@{k}: {recalls[k]:.5f}")
    return results
