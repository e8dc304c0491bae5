"""Results dict shared by the VLAD pipelines (counterpart of
``anyloc_tpu/pipelines/vlad_pipeline.py::build_results_dict``; keys match
the reference's)."""

from __future__ import annotations

import time
from typing import Dict

from anyloc_tpu_torch.config import PipelineArgs


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
