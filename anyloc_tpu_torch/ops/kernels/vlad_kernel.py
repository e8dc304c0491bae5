"""K1 — VLAD aggregation, descs [B, N, D] -> [B, C·D] (cluster-major).

Hand-written Hopper kernels (``csrc/vlad.cu``: assignment, residual sums,
finalize) replacing
``anyloc_tpu/ops/pallas/vlad_kernel.py::vlad_aggregate_fused`` (:140).
Per image: optional L2 norm of the tokens; hard cosine argmax (ties to the
lowest index), hard euclidean ``2x·c - |c|²`` or soft ``softmax(T·cos)``;
``wsum = aᵀx``, ``counts = Σa``; residual ``wsum - counts·c`` (hard) or
``C·wsum - counts·Σc`` (soft); intra-cluster L2, then global L2.
"""

from __future__ import annotations

import torch

from anyloc_tpu_torch import _build
from anyloc_tpu_torch.ops.common import l2_normalize
from anyloc_tpu_torch.ops.kernels import _launch

MAX_CLUSTERS = 64
_MODES = {("hard", "cosine"): 0, ("hard", "euclidean"): 1}


def _mode(vlad_mode: str, dist_mode: str) -> int:
    if vlad_mode == "soft":
        return 2  # the reference's soft mode is cosine whatever dist_mode
    if (vlad_mode, dist_mode) not in _MODES:
        raise ValueError(f"unknown vlad_mode/dist_mode {vlad_mode!r}/{dist_mode!r}")
    return _MODES[(vlad_mode, dist_mode)]


def vlad_aggregate_fused_ref(
    descs: torch.Tensor,
    centers: torch.Tensor,
    *,
    dist_mode: str = "cosine",
    intra_norm: bool = True,
    norm_descs: bool = True,
    vlad_mode: str = "hard",
    soft_temp: float = 1.0,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel's math."""
    mode = _mode(vlad_mode, dist_mode)
    b, n, d = descs.shape
    c = centers.shape[0]
    x = descs.float()
    centers = centers.float()
    inv = torch.rsqrt(torch.clamp_min((x * x).sum(-1, keepdim=True), 1e-24))
    if norm_descs:
        x = x * inv
    if mode == 1:
        sim = 2.0 * (x @ centers.T) - (centers * centers).sum(-1)
    else:
        sim = x @ l2_normalize(centers).T
        if mode == 2 and not norm_descs:
            sim = sim * inv
    if mode == 2:
        a = torch.softmax(soft_temp * sim, dim=-1)
    else:
        a = torch.nn.functional.one_hot(sim.argmax(-1), c).float()
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
    if not 1 <= c <= MAX_CLUSTERS:
        raise ValueError(f"vlad_aggregate_fused: {c} clusters; the kernel "
                         f"takes 1..{MAX_CLUSTERS}")
    if b > 65535:  # the residual pass puts images on the grid's y axis
        raise ValueError(f"vlad_aggregate_fused: batch {b} > 65535; split it")
    centers = centers.float().contiguous()
    csim = centers if mode == 1 else l2_normalize(centers).contiguous()
    c2 = (centers * centers).sum(-1).contiguous()
    csum = centers.sum(0).contiguous()
    a = torch.empty((b, n, c), dtype=torch.float32, device=descs.device)
    s = torch.empty((b, n), dtype=torch.float32, device=descs.device)
    out = torch.empty((b, c, d), dtype=torch.float32, device=descs.device)
    rc = _build.load_library().anyloc_vlad_aggregate(
        descs.data_ptr(), csim.data_ptr(), c2.data_ptr(), centers.data_ptr(),
        csum.data_ptr(), a.data_ptr(), s.data_ptr(), out.data_ptr(),
        b, n, d, c, mode, int(norm_descs), int(intra_norm), float(soft_temp),
        _launch.stream(descs))
    _build.check(rc, "vlad_aggregate_fused")
    vlad_aggregate_fused.launches += 1
    return out.view(b, c * d)


vlad_aggregate_fused.launches = 0
