"""AnyLoc-VLAD with a vocabulary fitted on one dataset's database images
and applied to another (counterpart of
``anyloc_tpu/pipelines/global_vocab_vlad.py::run_global_vocab_vlad``):
k-means vocabulary -> fused extract + VLAD per batch -> exact top-k ->
Recall@K.

The dataset registry, the loaders and the CLI are a later item of the port
(ROADMAP.md): callers pass ``dataset`` and ``vocab_dataset`` objects with
the ``VPRDataset`` protocol.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from anyloc_tpu_torch.config import PipelineArgs
from anyloc_tpu_torch.ops.retrieval import get_top_k_recall
from anyloc_tpu_torch.ops.vlad import VLAD
from anyloc_tpu_torch.pipelines.engine import DescriptorEngine
from anyloc_tpu_torch.pipelines.vlad_pipeline import build_results_dict

_NOT_PORTED = ("the dataset registry and loaders are not ported yet "
               '(ROADMAP.md, port queue: "The dataset registry and loaders"): '
               "pass {}= a VPRDataset")


def run_global_vocab_vlad(
    largs: PipelineArgs,
    dataset=None,
    vocab_dataset=None,
    engine: Optional[DescriptorEngine] = None,
    verbose: bool = True,
    device=None,
) -> Dict:
    """``device`` places the engine built from ``largs`` (None: the card;
    ignored when an ``engine`` is given)."""
    if dataset is None:
        raise NotImplementedError(_NOT_PORTED.format("dataset"))
    if vocab_dataset is None:
        raise NotImplementedError(_NOT_PORTED.format("vocab_dataset"))
    ds_name = largs.prog.vg_dataset_name
    if engine is None:
        engine = DescriptorEngine(
            largs.extractor.model_type, largs.extractor.desc_layer,
            largs.extractor.desc_facet, largs.extractor.checkpoint,
            largs.extractor.dtype, largs.extractor.batch_size,
            quant=largs.extractor.quant,
            transfer_dtype=largs.extractor.transfer_dtype, device=device,
        )
    vlad = VLAD(
        largs.vlad.num_clusters,
        vlad_mode=largs.vlad.vlad_assignment,
        soft_temp=largs.vlad.vlad_soft_temp,
        cache_dir=largs.vlad.cache_dir,
    )
    if vlad.can_use_cache_vlad():
        vlad.fit(None)
    else:
        # the vocabulary set stays on the device for the k-means fit
        vocab_descs = engine.extract_dataset(
            vocab_dataset, "db", largs.sub_sample_db_vlad, verbose,
            keep_on_device=True)
        vlad.fit(vocab_descs.reshape(-1, vocab_descs.shape[-1]))

    # fused extract + aggregate: only the VLAD vectors leave the device
    db_vlads = engine.extract_vlads_dataset(
        dataset, vlad, "db", largs.sub_sample_db, verbose)
    qu_vlads = engine.extract_vlads_dataset(
        dataset, vlad, "queries", largs.sub_sample_qu, verbose)

    dists, indices, recalls = get_top_k_recall(
        largs.top_k_vals, db_vlads, qu_vlads, dataset.get_positives(),
        sub_sample_db=largs.sub_sample_db, sub_sample_qu=largs.sub_sample_qu,
    )
    results = build_results_dict(largs, db_vlads, qu_vlads, recalls, ds_name)
    results["Global-Vocab"] = str(largs.global_vocab or sorted(largs.db_samples))
    results["Qual-Dists"] = np.asarray(dists)
    results["Qual-Indices"] = np.asarray(indices)
    if verbose:
        for k in largs.top_k_vals:
            print(f"R@{k}: {recalls[k]:.5f}")
    return results
