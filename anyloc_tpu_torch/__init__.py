"""anyloc_tpu_torch — the AnyLoc-VLAD-DINOv2 path in PyTorch for one NVIDIA
H100, with hand-written CUDA kernels for the TPU kernels of the JAX
package (``anyloc_tpu``), which stays the reference.

Importing the package needs only torch, numpy and PIL: the CUDA kernels
are compiled from ``csrc/`` at their first launch (``_build.py``), the
native image pipe at its first use (``native.py``). The command line is
``python -m anyloc_tpu_torch`` (``cli.py``).
"""

from anyloc_tpu_torch.config import PipelineArgs
from anyloc_tpu_torch.data.base import VPRDataset, listdir_abs
from anyloc_tpu_torch.data.registry import dataset_names, get_dataset
from anyloc_tpu_torch.models.dinov2 import dinov2_config, from_jax_params, init_params
from anyloc_tpu_torch.models.extractor import DinoV2ExtractFeatures, ViTFacetExtractor
from anyloc_tpu_torch.models.factory import make_extractor
from anyloc_tpu_torch.models.vit import ViT, ViTConfig
from anyloc_tpu_torch.ops.common import l2_normalize
from anyloc_tpu_torch.ops.kmeans import KMeans
from anyloc_tpu_torch.ops.retrieval import compute_recalls, get_top_k_recall, top_k_search
from anyloc_tpu_torch.ops.vlad import VLAD, vlad_aggregate
from anyloc_tpu_torch.pipelines.engine import DescriptorEngine
from anyloc_tpu_torch.pipelines.global_vocab_vlad import run_global_vocab_vlad
from anyloc_tpu_torch.pipelines.vlad_pipeline import run_vlad_pipeline

__all__ = [
    "DescriptorEngine", "DinoV2ExtractFeatures", "KMeans", "PipelineArgs",
    "VLAD", "ViT", "ViTConfig", "ViTFacetExtractor", "VPRDataset",
    "compute_recalls", "dataset_names", "dinov2_config", "from_jax_params",
    "get_dataset", "get_top_k_recall", "init_params", "l2_normalize",
    "listdir_abs", "make_extractor", "run_global_vocab_vlad",
    "run_vlad_pipeline", "top_k_search", "vlad_aggregate",
]
