"""K1 — VLAD aggregation, descs [B, N, D] -> [B, C·D] (cluster-major).

Hand-written Hopper kernel (``csrc/vlad.cu``: one pass of thread block
clusters that reads the facets once, plus a finishing pass when a small
batch splits its tokens) replacing
``anyloc_tpu/ops/pallas/vlad_kernel.py::vlad_aggregate_fused`` (:140).
Per image: optional L2 norm of the tokens; hard cosine argmax (ties to the
lowest index), hard euclidean ``2x·c - |c|²`` or soft ``softmax(T·cos)``;
``wsum = aᵀx``, ``counts = Σa``; residual ``wsum - counts·c`` (hard) or
``C·wsum - counts·Σc`` (soft); intra-cluster L2, then global L2.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch

from anyloc_tpu_torch import _build
from anyloc_tpu_torch.ops.common import l2_normalize
from anyloc_tpu_torch.ops.kernels import _launch

MAX_CLUSTERS = 64
CLUSTER = 8             # blocks per thread block cluster, one D slice each
TILE = 32               # tokens a step
SMEM_LIMIT = 232_448    # dynamic shared memory a block may use (227 KB)
_MODES = {("hard", "cosine"): 0, ("hard", "euclidean"): 1}


def _mode(vlad_mode: str, dist_mode: str) -> int:
    if vlad_mode == "soft":
        return 2  # the reference's soft mode is cosine whatever dist_mode
    if (vlad_mode, dist_mode) not in _MODES:
        raise ValueError(f"unknown vlad_mode/dist_mode {vlad_mode!r}/{dist_mode!r}")
    return _MODES[(vlad_mode, dist_mode)]


def _scores(x: torch.Tensor, centers: torch.Tensor, mode: int) -> torch.Tensor:
    """The assignment scores of (normalized or raw) tokens x: 2x·c - |c|²
    (euclidean) or x·ĉ (cosine)."""
    if mode == 1:
        return 2.0 * (x @ centers.T) - (centers * centers).sum(-1)
    return x @ l2_normalize(centers).T


def hard_label_agreement(got: torch.Tensor, descs: torch.Tensor, centers: torch.Tensor, *,
                         dist_mode: str = "cosine"):
    """Hold a hard-mode result ``got`` [B, C·D] (default ``norm_descs`` and
    ``intra_norm``) to the plain version up to near ties. The kernel and
    the plain version take the argmax of f32 dots summed in other orders,
    so they may pick different labels where a token's top two scores (in
    f64) lie within the worst-case f32 rounding of a D-term dot, D·2^-24
    times the scores' scale: such a token may take either label. Per
    image, each near tie's other label is kept where it brings the plain
    version nearer ``got`` (one token at a time). Returns the per-image
    cosine to the plain version [B], the cosine to the nearest such
    labelling [B], that labelling's label flips [B] and the near ties
    [B]."""
    mode = _mode("hard", dist_mode)
    b, n, d = descs.shape
    x = descs.float()
    x = x * torch.rsqrt(torch.clamp_min((x * x).sum(-1, keepdim=True), 1e-24))
    labels = _scores(x, centers.float(), mode).argmax(-1)          # the plain version's
    c64 = centers.double()
    top = _scores(x.double(), c64, mode).topk(min(2, centers.shape[0]), dim=-1)
    scale = 1.0                                                    # unit tokens
    if mode == 1:
        cn = c64.norm(dim=-1).max()
        scale = 2 * cn + cn * cn
    if centers.shape[0] > 1:
        tie = top.values[..., 0] - top.values[..., 1] <= d * 2.0 ** -24 * scale
        other = torch.where(labels == top.indices[..., 0], top.indices[..., 1], top.indices[..., 0])
    else:
        tie = torch.zeros_like(labels, dtype=torch.bool)

    def cosine(i, lab):
        want = vlad_aggregate_fused_ref(descs[i:i + 1], centers, dist_mode=dist_mode,
                                        labels=lab[None])
        return torch.nn.functional.cosine_similarity(got[i:i + 1].double(), want.double())[0]

    raw = torch.nn.functional.cosine_similarity(
        got.double(), vlad_aggregate_fused_ref(descs, centers, dist_mode=dist_mode).double(),
        dim=-1)
    best, flips = raw.clone(), torch.zeros(b, dtype=torch.long)
    for i in tie.any(-1).nonzero().flatten().tolist():
        lab = labels[i].clone()
        for t in tie[i].nonzero().flatten().tolist():
            keep = lab[t].item()
            lab[t] = other[i, t]
            cos = cosine(i, lab)
            if cos > best[i]:
                best[i] = cos
                flips[i] += 1
            else:
                lab[t] = keep
    return raw.cpu(), best.cpu(), flips, tie.sum(-1).cpu()


class VladPlan(NamedTuple):
    """How ``csrc/vlad.cu`` cuts one call: ``CLUSTER``-block clusters, each
    block a ``slice``-wide D slice; each image's tokens in ``splits`` ranges
    of ``tokens_per_split`` (one cluster each; a finishing launch adds them
    up when splits > 1); ``smem_bytes`` of shared memory a block."""
    slice: int
    splits: int
    tokens_per_split: int
    smem_bytes: int


def _smem_floats(slice_: int, c: int) -> int:
    """csrc/vlad.cu's shared-memory layout (VladSmem) of the main pass, in
    floats: rows of centers rounded up to 8, 16, 32 or 64 (whole 8-center
    units)."""
    dsp, cr = slice_ + 4, 8
    while cr < c:
        cr *= 2
    return (2 * TILE * dsp + (2 * cr + 1) * dsp + TILE * cr + 2 * TILE * (cr + 4) + 2 * TILE
            + 7 * cr + 4)


def vlad_plan(b: int, n: int, d: int, c: int, resident: Callable[[int], int]) -> VladPlan:
    """The kernel's cut of [B, N, D] facets over C centers: 8-block
    clusters, each block a D slice, 32-token tiles. A batch too small to
    fill the clusters the card holds at once (``resident(smem_bytes)``)
    splits its tokens, at least four tiles a split. Raises on shapes the
    kernel does not take."""
    if not 1 <= c <= MAX_CLUSTERS:
        raise ValueError(f"vlad_aggregate_fused: {c} clusters; the kernel takes 1..{MAX_CLUSTERS}")
    if d < 1:
        raise ValueError(f"vlad_aggregate_fused: descriptor width {d}")
    slice_ = -(-(-(-d // CLUSTER)) // 4) * 4
    smem = 4 * _smem_floats(slice_, c)
    if smem > SMEM_LIMIT:
        raise ValueError(f"vlad_aggregate_fused: D={d}, C={c} needs {smem} bytes of shared "
                         f"memory a block (limit {SMEM_LIMIT})")
    held = max(1, resident(smem))
    tiles = max(1, -(-n // TILE))
    splits = 1
    if 2 * b < held:
        splits = max(1, min(-(-held // max(b, 1)), tiles // 4))
    tps = -(-tiles // splits) * TILE
    splits = max(1, -(-n // tps))
    return VladPlan(slice_, splits, tps, smem)


def vlad_aggregate_fused_ref(
    descs: torch.Tensor,
    centers: torch.Tensor,
    *,
    dist_mode: str = "cosine",
    intra_norm: bool = True,
    norm_descs: bool = True,
    vlad_mode: str = "hard",
    soft_temp: float = 1.0,
    labels: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel's math. ``labels`` [B, N] (hard
    modes) stand in for the argmax: a check holds a result to another
    labelling with them (``hard_label_agreement``)."""
    mode = _mode(vlad_mode, dist_mode)
    b, n, d = descs.shape
    c = centers.shape[0]
    x = descs.float()
    centers = centers.float()
    inv = torch.rsqrt(torch.clamp_min((x * x).sum(-1, keepdim=True), 1e-24))
    if norm_descs:
        x = x * inv
    if mode == 2:
        sim = _scores(x, centers, mode)
        if not norm_descs:
            sim = sim * inv
        a = torch.softmax(soft_temp * sim, dim=-1)
    else:
        if labels is None:
            labels = _scores(x, centers, mode).argmax(-1)
        a = torch.nn.functional.one_hot(labels, c).float()
    wsum = a.transpose(1, 2) @ x                      # [B, C, D]
    counts = a.sum(1)                                 # [B, C]
    if mode == 2:
        v = c * wsum - counts[..., None] * centers.sum(0)
    else:
        v = wsum - counts[..., None] * centers
    if intra_norm:
        v = l2_normalize(v, dim=-1)
    return l2_normalize(v.reshape(b, c * d), dim=-1)


def vlad_aggregate_fused(
    descs: torch.Tensor,
    centers: torch.Tensor,
    *,
    dist_mode: str = "cosine",
    intra_norm: bool = True,
    norm_descs: bool = True,
    vlad_mode: str = "hard",
    soft_temp: float = 1.0,
) -> torch.Tensor:
    """descs [B, N, D] float32, centers [C, D] -> [B, C·D] float32. CPU
    tensors take ``vlad_aggregate_fused_ref``; CUDA tensors launch the
    kernels or raise."""
    mode = _mode(vlad_mode, dist_mode)
    if descs.dim() != 3 or centers.dim() != 2 or centers.shape[1] != descs.shape[2]:
        raise ValueError(f"descs [B, N, D] and centers [C, D] expected, got "
                         f"{tuple(descs.shape)} and {tuple(centers.shape)}")
    if descs.device.type == "cpu" and centers.device.type == "cpu":
        return vlad_aggregate_fused_ref(
            descs, centers, dist_mode=dist_mode, intra_norm=intra_norm,
            norm_descs=norm_descs, vlad_mode=vlad_mode, soft_temp=soft_temp)
    _launch.require_cuda("vlad_aggregate_fused", descs, centers)
    if descs.dtype != torch.float32 or not descs.is_contiguous():
        raise ValueError("vlad_aggregate_fused: descs must be contiguous float32")
    b, n, d = descs.shape
    c = centers.shape[0]
    plan = vlad_plan(b, n, d, c, resident=_resident_clusters)
    if b * plan.splits * CLUSTER > 2 ** 31 - 1:
        raise ValueError(f"vlad_aggregate_fused: batch {b} too large; split it")
    centers = centers.float().contiguous()
    out = torch.empty((b, c, d), dtype=torch.float32, device=descs.device)
    # the token splits' [C, D] sums and counts (a small batch only)
    rows = b * plan.splits if plan.splits > 1 else 0
    ws = torch.empty((rows, c, d), dtype=torch.float32, device=descs.device)
    wc = torch.empty((rows, c), dtype=torch.float32, device=descs.device)
    vec = int(d % 4 == 0 and descs.data_ptr() % 16 == 0)
    rc = _build.load_library().anyloc_vlad_aggregate(
        descs.data_ptr(), centers.data_ptr(), ws.data_ptr(), wc.data_ptr(), out.data_ptr(),
        b, n, d, c, mode, int(norm_descs), int(intra_norm), float(soft_temp), plan.splits,
        plan.tokens_per_split, plan.slice, vec, _launch.stream(descs))
    _build.check(rc, "vlad_aggregate_fused")
    vlad_aggregate_fused.launches += 1
    vlad_aggregate_fused.last_plan = plan
    return out.view(b, c * d)


vlad_aggregate_fused.launches = 0
vlad_aggregate_fused.last_plan = None   # the cut of the last launch (VladPlan)


@functools.lru_cache(maxsize=None)
def _resident_clusters(smem_bytes: int) -> int:
    """The main pass's clusters that the current card holds at once
    (cudaOccupancyMaxActiveClusters)."""
    n = _build.load_library().anyloc_vlad_resident_clusters(smem_bytes)
    if n < 0:
        _build.check(-n, "vlad_aggregate_fused (occupancy query)")
    return n
