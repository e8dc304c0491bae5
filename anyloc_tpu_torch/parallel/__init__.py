"""Multi-device execution of the port on ``torch.distributed``: the mesh,
sharded k-means / retrieval / extraction, and the trunk's tensor,
pipeline, sequence and expert parallelism (counterpart of
``anyloc_tpu/parallel/``).

The SPMD contract: one process per device (``torchrun --nproc-per-node N``,
or ``init_distributed``), every rank calls each function with the same host
inputs, runs the part its coordinates on the (data, model) mesh own, and
gets the same, replicated result, as the JAX package's single controller
gets it from ``shard_map``. NCCL needs one card per rank; Gloo carries
ranks that share a device (the CPU, or one card). ``local_mesh(1)`` works
in a plain process.
"""

from anyloc_tpu_torch.parallel.distributed import (
    get_top_k_recall_sharded,
    ivf_pq_search_sharded,
    ivf_search_sharded,
    kmeans_fit_sharded,
    pq_search_sharded,
    sharded_extract_fn,
    top_k_search_sharded,
)
from anyloc_tpu_torch.parallel.ep import ep_vlad_aggregate, route_by_domain
from anyloc_tpu_torch.parallel.mesh import get_mesh, init_distributed, local_mesh
from anyloc_tpu_torch.parallel.pp import pipeline_facet_extract, stack_stage_params
from anyloc_tpu_torch.parallel.sp import SPFacetExtractor, ring_attention, sp_facet_extract

__all__ = [
    "ep_vlad_aggregate",
    "route_by_domain",
    "get_mesh",
    "init_distributed",
    "local_mesh",
    "get_top_k_recall_sharded",
    "ivf_pq_search_sharded",
    "ivf_search_sharded",
    "kmeans_fit_sharded",
    "pq_search_sharded",
    "sharded_extract_fn",
    "top_k_search_sharded",
    "pipeline_facet_extract",
    "stack_stage_params",
    "ring_attention",
    "SPFacetExtractor",
    "sp_facet_extract",
]
