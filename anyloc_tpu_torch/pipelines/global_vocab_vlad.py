"""AnyLoc-VLAD with a multi-dataset domain vocabulary (counterpart of
``anyloc_tpu/pipelines/global_vocab_vlad.py``; reference
scripts/dino_v2_global_vocab_vlad.py): k-means vocabulary over the
concatenated database images of the domain's datasets (each sub-sampled
by its recipe) -> fused extract + VLAD per batch on the target dataset ->
exact top-k on the card -> Recall@K; VPAir appends distractor VLADs to
the database.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from anyloc_tpu_torch.config import PipelineArgs
from anyloc_tpu_torch.data.loaders.global_vocab import GlobalVocabDataset
from anyloc_tpu_torch.data.registry import DOMAIN_RECIPES
from anyloc_tpu_torch.ops.retrieval import get_top_k_recall
from anyloc_tpu_torch.pipelines.engine import DescriptorEngine
from anyloc_tpu_torch.pipelines.vlad_pipeline import (
    build_results_dict, dataset_from_args, engine_from_args, fit_vocabulary)


def run_global_vocab_vlad(
    largs: PipelineArgs,
    dataset=None,
    vocab_dataset=None,
    engine: Optional[DescriptorEngine] = None,
    verbose: bool = True,
    device=None,
) -> Dict:
    """``device`` places the engine built from ``largs`` (None: the card;
    an ``engine`` given keeps its own). Retrieval runs on the engine's
    device."""
    ds_name = largs.prog.vg_dataset_name
    if dataset is None:
        dataset = dataset_from_args(largs, ds_name)
    if vocab_dataset is None:
        samples = largs.db_samples or DOMAIN_RECIPES[largs.global_vocab]
        vocab_dataset = GlobalVocabDataset(
            list(samples), largs.prog.data_vg_dir, largs.data_split,
            dict(samples), img_size=tuple(largs.bd_args.resize),
        )
    if engine is None:
        engine = engine_from_args(largs, device)
    vlad = fit_vocabulary(largs, engine, vocab_dataset, verbose)

    # fused extract + aggregate: only the VLAD vectors leave the device
    db_vlads = engine.extract_vlads_dataset(
        dataset, vlad, "db", largs.sub_sample_db, verbose)
    qu_vlads = engine.extract_vlads_dataset(
        dataset, vlad, "queries", largs.sub_sample_qu, verbose)

    # VPAir: distractors extend the database only
    # (ref dino_v2_global_vocab_vlad.py:434-470)
    if largs.use_distractor and ds_name == "VPAir":
        distractor = dataset_from_args(largs, "VPAir_distractor")
        dis_vlads = engine.extract_vlads_dataset(distractor, vlad, "db", 1, verbose)
        db_vlads = np.concatenate([db_vlads, dis_vlads])

    dists, indices, recalls = get_top_k_recall(
        largs.top_k_vals, db_vlads, qu_vlads, dataset.get_positives(),
        sub_sample_db=largs.sub_sample_db, sub_sample_qu=largs.sub_sample_qu,
        device=engine.extractor.device,
    )
    results = build_results_dict(largs, db_vlads, qu_vlads, recalls, ds_name)
    results["Global-Vocab"] = str(largs.global_vocab or sorted(largs.db_samples))
    results["Qual-Dists"] = dists
    results["Qual-Indices"] = indices
    if verbose:
        for k in largs.top_k_vals:
            print(f"R@{k}: {recalls[k]:.5f}")
    return results
