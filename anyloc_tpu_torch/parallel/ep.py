"""Expert parallelism (counterpart of ``anyloc_tpu/parallel/ep.py``):
domain vocabularies sharded over the mesh, images routed to them by a
capacity-bounded ``all_to_all`` dispatch.

AnyLoc's domain vocabularies are separate VLAD center banks per
deployment domain (indoor / urban / aerial; the demo's
``vocabulary/.../{domain}/c_centers.pt``), and the HF-space demo picks one
for a user image by projecting its GeM descriptor against cached
per-dataset descriptors (hf_imgs_vlad_clusters.py:257-356). A bank of E
experts [E, C, D] shards over the ``model`` axis; a router gives each
image an expert; each image's patch descriptors go to the rank holding its
expert, are aggregated there (``vlad_aggregate``: K1 on the card) and come
back: one ``all_to_all`` each way, as the MoE exchange.

``route_by_domain`` is the single-device router the demo's ``--domain
auto`` uses.

Descriptors or experts that require a gradient get one (F25), as through
the JAX package's: the exchanges are ``all_to_all_grad`` (backward, the
inverse exchange), the final gather ``tp_gather`` (a loss replicated over
every rank), and ``sum_grads`` sums each rank's part of the inputs'
gradients (its images, its experts) over the mesh. Dropped images (over
capacity, or routed outside [0, E)) take zero gradient. The aggregation
then needs its plain version (``vlad_kw`` ``impl="xla"`` on a card): K1
has no gradient and refuses one (F18), as the JAX kernel has none (F19).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from anyloc_tpu_torch.ops.common import l2_normalize, resolve_device
from anyloc_tpu_torch.ops.gem import gem_pool
from anyloc_tpu_torch.parallel.mesh import (
    all_to_all,
    anchor,
    all_to_all_grad,
    axis_index,
    axis_size,
    sum_grads,
    tp_gather,
)


def route_by_domain(descs: torch.Tensor, domain_centroids: torch.Tensor,
                    p: float = 3.0) -> torch.Tensor:
    """Nearest-domain router: GeM-pool (|d|^p) each image's patch
    descriptors and take the cosine-nearest domain centroid (the HF space's
    domain picker, hf_imgs_vlad_clusters.py:257-356). [B, N, D], [E, D] ->
    [B] int32 on the descriptors' device."""
    g = l2_normalize(gem_pool(descs, p=p, use_abs=True))
    c = l2_normalize(torch.as_tensor(domain_centroids).to(g.device, torch.float32))
    return torch.argmax(g @ c.T, dim=-1).to(torch.int32)


def _tensor(x, device) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x)).to(device)


def ep_vlad_aggregate(
    descs,
    route,
    experts,
    mesh,
    *,
    capacity_factor: float = 1.25,
    data_axis: str = "data",
    expert_axis: str = "model",
    **vlad_kw,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed VLAD: image ``i`` aggregated against expert ``route[i]``.

    Every rank passes the whole ``descs`` [B, T, D], ``route`` [B] and
    ``experts`` [E, C, D] (tensors stay on their device; numpy goes to the
    card) and takes its block: B / (n_data · n_exp) images (chip order,
    data-major) and E / n_exp experts along ``expert_axis``. Each rank
    fills a [n_exp, capacity, T, D] dispatch buffer (capacity =
    ceil(B_loc · capacity_factor / n_exp) slots per target),
    ``all_to_all``s it along its expert row, aggregates the images it
    receives against its experts (``vlad_aggregate`` with ``vlad_kw``),
    and ``all_to_all``s the [capacity, C·D] results back.

    Returns ``(vlads [B, C·D], kept [B] bool)``, the same on every rank:
    images beyond a target's capacity, and routes outside [0, E), come back
    as zeros with kept=False (the MoE overflow contract; a zero descriptor
    is never marked valid). ``capacity_factor`` >= n_exp makes dropping
    impossible."""
    from anyloc_tpu_torch.ops.vlad import vlad_aggregate

    dev = descs.device if isinstance(descs, torch.Tensor) else resolve_device(None)
    descs, route, experts = (_tensor(a, dev) for a in (descs, route, experts))
    grad = torch.is_grad_enabled() and (descs.requires_grad or experts.requires_grad)
    if grad:
        descs, experts = sum_grads([descs, experts], mesh, None)
    n_exp, n_data = axis_size(mesh, expert_axis), axis_size(mesh, data_axis)
    e_total, n_clusters, d = experts.shape
    if e_total % n_exp:
        raise ValueError(f"experts ({e_total}) must divide the {expert_axis!r} axis ({n_exp})")
    e_loc = e_total // n_exp
    b = descs.shape[0]
    n_chips = n_data * n_exp
    if b % n_chips:
        raise ValueError(f"batch ({b}) must divide the mesh ({n_chips})")
    b_loc = b // n_chips
    capacity = max(1, int(math.ceil(b_loc * capacity_factor / n_exp)))
    chip = axis_index(mesh, data_axis) * n_exp + axis_index(mesh, expert_axis)
    x = descs[chip * b_loc:(chip + 1) * b_loc]
    r = route[chip * b_loc:(chip + 1) * b_loc].long()
    mine = experts[axis_index(mesh, expert_axis) * e_loc:][:e_loc]

    # the dispatch plan: each image's target rank and its slot there
    in_range = (r >= 0) & (r < e_total)
    target = torch.where(in_range, r // e_loc, 0)
    onehot = F.one_hot(target, n_exp) * in_range[:, None]
    pos = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
    kept = (pos < capacity) & in_range
    sel = kept.nonzero()[:, 0]
    buf = x.new_zeros((n_exp, capacity) + tuple(x.shape[1:]))
    slot_e = torch.full((n_exp, capacity), -1, dtype=torch.int64, device=dev)
    buf[target[sel], pos[sel]] = x[sel]
    slot_e[target[sel], pos[sel]] = r[sel] % e_loc
    got = all_to_all_grad(buf.flatten(0, 1), mesh, expert_axis)      # [n_src · cap, T, D]
    got_e = all_to_all(slot_e.flatten(), mesh, expert_axis)

    # aggregate what came in against the local experts (empty slots stay 0)
    y = torch.zeros((n_exp * capacity, n_clusters * d), dtype=torch.float32, device=dev)
    for j in range(e_loc):
        rows = (got_e == j).nonzero()[:, 0]
        if rows.numel():
            y[rows] = vlad_aggregate(got[rows], mine[j], **vlad_kw).float()
    if grad:   # every rank builds the return exchange's backward, even with no image here
        y = y + anchor(got, mine)
    back = all_to_all_grad(y, mesh, expert_axis).view(n_exp, capacity, -1)   # at the source
    out = torch.zeros((b_loc, n_clusters * d), dtype=torch.float32, device=dev)
    out[sel] = back[target[sel], pos[sel]]
    if grad:
        out = out + anchor(back)
    return (tp_gather(out, mesh, None),
            tp_gather(kept.to(torch.uint8), mesh, None).bool())
