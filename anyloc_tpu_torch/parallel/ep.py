"""Domain routing (counterpart of ``route_by_domain`` in
``anyloc_tpu/parallel/ep.py``): the single-device math the demo's
``--domain auto`` needs. The sharded expert dispatch of that module comes
with ROADMAP.md's port-queue item "`parallel/` on `torch.distributed`".
"""

from __future__ import annotations

import torch

from anyloc_tpu_torch.ops.common import l2_normalize
from anyloc_tpu_torch.ops.gem import gem_pool


def route_by_domain(descs: torch.Tensor, domain_centroids: torch.Tensor,
                    p: float = 3.0) -> torch.Tensor:
    """Nearest-domain router: GeM-pool (|d|^p) each image's patch
    descriptors and take the cosine-nearest domain centroid (the HF space's
    domain picker, hf_imgs_vlad_clusters.py:257-356). [B, N, D], [E, D] ->
    [B] int32 on the descriptors' device."""
    g = l2_normalize(gem_pool(descs, p=p, use_abs=True))
    c = l2_normalize(torch.as_tensor(domain_centroids).to(g.device, torch.float32))
    return torch.argmax(g @ c.T, dim=-1).to(torch.int32)
