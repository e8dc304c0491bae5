"""K2 — flash attention over head-split [B, H, N, hd] tensors.

Hand-written Hopper kernel (``csrc/flash_attention.cu``) replacing the
three TPU tilings of one function in
``anyloc_tpu/ops/pallas/flash_attention.py``: ``flash_attention`` (:62),
``flash_attention_heads`` (:139) and ``flash_attention_blocked`` (:241).
The trunk calls it for sequences longer than ``MAX_FUSED_TOKENS`` (the
1022-px demo shape, 5330 tokens); shorter ones take K5.

Math: ``s = (q·kᵀ with f32 sums) * scale`` in f32, padded/ragged keys
never contribute, softmax in f32, P rounded to v's dtype before the PV
product, output in q's dtype.

Under autograd (a tensor-parallel trunk in training) the launch runs
inside ``FlashAttentionGrad``: the kernel forward, which also saves each
query row's log-sum-exp, and the attention backward kernel
(``csrc/flash_attention_bwd.cu``, ``flash_attention_bwd``) on CUDA tensors;
on CPU tensors the plain version's autograd. No Pallas kernel has a
backward (F19): the gradient is that of the JAX package's XLA attention
route, which ``flash_attention_bwd_ref`` writes out with the kernel's
arguments.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from anyloc_tpu_torch import _build
from anyloc_tpu_torch.ops.kernels import _launch

# every kernel on the shared attention core (K2, K4-K7, K9, T3) takes these;
# hd 80 is MAE-H, ImageBind-H and SAM-H
SUPPORTED_HEAD_DIMS = (16, 32, 64, 80, 128)
# keys per block of the attention backward, and the grid it should give
# the card at least (csrc/flash_attention_bwd.cuh)
BWD_KEYS = 64
BWD_MIN_GRID = 512
# bytes of shared memory a block may use on the H100
BLOCK_SMEM = 232448
# the attention backward's route table (``attention_bwd_route`` of
# csrc/flash_attention_bwd.cuh, which refuses a launch whose route differs):
# the (head dim, dtype) pairs of the split route (the wgmma kernel without
# dQ, then the query-major dQ kernel), hd 128 in float32, where the wgmma
# kernel's tiles do not fit a block; every other pair runs the wgmma kernel
BWD_SPLIT_ROUTES = frozenset({(128, torch.float32)})
BWD_ROUTE_CODES = {"wgmma": 1, "split": 2}


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel's math (materializes the
    [B, H, N, N] scores)."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    o = p.to(v.dtype).float() @ v.float()
    return o.to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q kᵀ · scale) v over [B, H, N, hd] -> [B, H, N, hd].

    q/k/v may be strided views (for example head-split views of a fused
    [B, N, 3D] tensor) as long as the head dim is contiguous. CPU tensors
    take ``flash_attention_ref``; CUDA tensors launch the kernel or raise.
    """
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash_attention: q/k/v must share one [B, H, N, hd] "
                         f"shape, got {q.shape} {k.shape} {v.shape}")
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale=scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionGrad.apply(_flash_launch, scale, q, k, v)
    return _flash_launch(q, k, v, scale=scale)


class FlashAttentionGrad(torch.autograd.Function):
    """K2 with a gradient: ``forward`` runs ``kernel`` (the launch; the
    tests fill the slot with the plain version on the CPU) on q, k, v as
    given. On CUDA tensors the launch also writes each query row's
    log-sum-exp, and ``backward`` launches the attention backward kernel
    (``flash_attention_bwd``) on q, k, v, the output and the log-sum-exp;
    on CPU tensors it recomputes ``flash_attention_ref`` under autograd on
    detached copies of q, k, v. Both give the JAX XLA attention route's
    gradient."""

    @staticmethod
    def forward(ctx, kernel, scale, q, k, v):
        ctx.scale = scale
        ctx.on_card = q.device.type == "cuda"
        if ctx.on_card:
            lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
            out = kernel(q, k, v, scale=scale, lse=lse)
            ctx.save_for_backward(q, k, v, out, lse)
            return out
        ctx.save_for_backward(q, k, v)
        return kernel(q, k, v, scale=scale)

    @staticmethod
    def backward(ctx, grad):
        need = ctx.needs_input_grad[2:]
        if ctx.on_card:
            q, k, v, out, lse = ctx.saved_tensors
            grads = flash_attention_bwd(q, k, v, out, lse, grad, scale=ctx.scale)
            return (None, None) + tuple(g if n else None for g, n in zip(grads, need))
        inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = flash_attention_ref(*inputs, scale=ctx.scale)
        grads = iter(torch.autograd.grad(out, wanted, grad))
        return (None, None) + tuple(next(grads) if t.requires_grad else None for t in inputs)


def attention_bwd_math(q, k, v, o, lse, do, *, scale: float, prescale_q: bool):
    """The attention backward's plain math with the kernel's arguments and
    rounding points (``csrc/flash_attention_bwd.cuh``): P from the saved
    log-sum-exp, D = rowsum(dO ∘ O) in f32; in bf16 dP rounded to bf16, D =
    rowsum(P ∘ dP) on the f32 P, dV from P rounded to bf16; ``prescale_q``
    (K5): q · scale rounded to q's dtype before the scores, dq =
    round(dS K) · scale. Returns (dq, dk, dv) in q's dtype."""
    dt = q.dtype
    narrow = dt not in (torch.float32, torch.float64)
    wide = torch.float64 if dt == torch.float64 else torch.float32
    qf, kf, vf, dof = (t.to(wide) for t in (q, k, v, do))
    if prescale_q:
        qf = (qf * scale).to(dt).to(wide)
        s = qf @ kf.transpose(-1, -2)
    else:
        s = (qf @ kf.transpose(-1, -2)) * scale
    p = torch.exp(s - lse.to(wide)[..., None])
    dp = dof @ vf.transpose(-1, -2)
    if narrow:
        dp = dp.to(dt).to(wide)
        delta = (p * dp).sum(-1)
        pv = p.to(dt).to(wide)
    else:
        delta = (dof * o.to(wide)).sum(-1)
        pv = p
    ds = p * (dp - delta[..., None])
    dv = pv.transpose(-1, -2) @ dof
    dk = ds.transpose(-1, -2) @ qf
    dq = ds @ kf
    if prescale_q:
        dq = dq.to(dt).to(wide) * scale
    else:
        dq, dk = dq * scale, dk * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, scale: Optional[float] = None):
    """Plain PyTorch version of K2's backward kernel, with its arguments:
    q, k, v, the output o, each query row's log-sum-exp ``lse`` [B, H, N]
    of the scaled scores and the output gradient ``do`` -> (dq, dk, dv)."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    return attention_bwd_math(q, k, v, o, lse, do, scale=scale, prescale_q=False)


def flash_attention_bwd(q, k, v, o, lse, do, *, scale: Optional[float] = None):
    """K2's backward: (dq, dk, dv) of ``flash_attention`` from q, k, v
    [B, H, N, hd], its output o, the saved log-sum-exp ``lse`` [B, H, N]
    f32 and the output gradient ``do``. CPU tensors take
    ``flash_attention_bwd_ref``; CUDA tensors launch the kernel or raise."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if all(t.device.type == "cpu" for t in (q, k, v, o, lse, do)):
        return flash_attention_bwd_ref(q, k, v, o, lse, do, scale=scale)
    if do.stride(-1) != 1 or not _launch.aligned(do, 8):
        do = do.contiguous()   # a gradient of any layout: the kernel reads rows of hd
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3))
    attention_bwd_launch(q, k, v, o, lse, do, dq, dk, dv, scale=scale, prescale_q=False,
                         name="flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def attention_bwd_slices(b: int, h: int, n: int) -> int:
    """The backward's scratch slices (``attention_bwd_slices`` of
    ``csrc/flash_attention_bwd.cuh``): one per key block of ``BWD_KEYS`` up
    to four, then one per group of key blocks, four groups, unless b·h
    blocks alone would give the card a grid under ``BWD_MIN_GRID``."""
    blocks = -(-n // BWD_KEYS)
    slices = min(max(4, -(-BWD_MIN_GRID // max(b * h, 1))), blocks)
    if slices <= 0:
        return 0
    per = -(-blocks // slices)
    return -(-blocks // per)


def attention_bwd_route(hd: int, dtype: torch.dtype) -> str:
    """The kernels the attention backward runs at head dim ``hd`` and
    ``dtype``: "wgmma" (``attn_bwd_wgmma_kernel``) or "split"
    (``attn_bwd_wgmma_kernel`` without dQ, then ``attn_bwd_dq_wgmma_kernel``),
    the route table of csrc/flash_attention_bwd.cuh."""
    return "split" if (hd, dtype) in BWD_SPLIT_ROUTES else "wgmma"


def attention_bwd_smem(hd: int, dtype: torch.dtype, route: str) -> dict:
    """Bytes of shared memory a block of each kernel of ``route`` takes
    (``BwgTile::SMEM``, ``BwqTile::SMEM`` of csrc/flash_attention_bwd.cuh),
    by kernel name. The wgmma kernel keeps K, V, K^T [64 x hd] and Q, dO,
    Q^T, dO^T [a step of 32 queries, 16 at hd 128, x hd] in f32 (hi and lo
    for f32 operands), dS's hi and lo, two TMA landing stages of Q and dO,
    the step's LSE and D, ten mbarriers and 1 KB to align the base; where
    the landing stages would outgrow a block (f32 at hd 80) Q and dO land in
    place, and one barrier pair goes with the stages. On the split route it
    keeps no K^T and no dS; the query-major dQ kernel keeps Q and dO [64 x
    hd], K, V and K^T [16 keys x hd] in hi and lo, two landing stages of K
    and V, nine mbarriers and 1 KB to align."""
    lo = dtype == torch.float32
    copies = 2 if lo else 1
    bkv, bq = BWD_KEYS, 16 if hd == 128 else 32
    dq = route == "wgmma"
    tiles = (copies * ((3 if dq else 2) * bkv + 4 * bq) * hd * 4
             + (2 * bq * bkv * 4 if dq else 0))
    land = 2 * 2 * bq * hd * (4 if lo else 2)
    staged = tiles + land + 2 * bq * 4 + 10 * 8 + 1024
    smem = {"attn_bwd_wgmma_kernel": staged if staged <= BLOCK_SMEM
            else tiles + 2 * bq * 4 + 8 * 8 + 1024}
    if route == "split":
        bqm, bks = 64, 16
        smem["attn_bwd_dq_wgmma_kernel"] = (2 * 2 * bqm * hd * 4 + 3 * 2 * bks * hd * 4
                                            + 2 * 2 * bks * hd * 4 + 9 * 8 + 1024)
    return smem


def attention_bwd_launch(q, k, v, o, lse, do, dq, dk, dv, *, scale: float, prescale_q: bool,
                         name: str) -> None:
    """The attention backward on CUDA tensors (K2's and K5's), on the kernels
    the route table names for its head dim and dtype (``attention_bwd_route``),
    counted on that route's wrapper: every operand a [B, H, N, hd] view with a
    contiguous head dim, the outputs dq, dk, dv written in place."""
    route = attention_bwd_route(q.shape[-1], q.dtype)
    launch = attention_bwd_wgmma if route == "wgmma" else attention_bwd_split
    launch(q, k, v, o, lse, do, dq, dk, dv, scale=scale, prescale_q=prescale_q, name=name)


def attention_bwd_wgmma(q, k, v, o, lse, do, dq, dk, dv, *, scale: float, prescale_q: bool,
                        name: str) -> None:
    """The attention backward's wgmma kernel (``attn_bwd_wgmma_kernel``;
    every head dim in bf16, all but 128 in float32): see
    ``_attention_bwd``."""
    _attention_bwd(q, k, v, o, lse, do, dq, dk, dv, scale=scale, prescale_q=prescale_q,
                   name=name, route="wgmma")
    attention_bwd_wgmma.launches += 1


def attention_bwd_split(q, k, v, o, lse, do, dq, dk, dv, *, scale: float, prescale_q: bool,
                        name: str) -> None:
    """The attention backward's split route (hd 128 in float32): the wgmma
    kernel without dQ writes dk and dv, the query-major
    ``attn_bwd_dq_wgmma_kernel`` dq; see ``_attention_bwd``."""
    _attention_bwd(q, k, v, o, lse, do, dq, dk, dv, scale=scale, prescale_q=prescale_q,
                   name=name, route="split")
    attention_bwd_split.launches += 1


def _attention_bwd(q, k, v, o, lse, do, dq, dk, dv, *, scale: float, prescale_q: bool,
                   name: str, route: str) -> None:
    """One launch of the attention backward on ``route`` (the C entry refuses
    a route the table does not give this head dim and dtype). On the wgmma
    route its f32 scratch holds ``attention_bwd_slices`` slices (each group
    of key blocks' share of dq, and of D in bf16): dq's size times at most
    four beyond small B·H, so the memory grows as N, summed in a fixed
    order: the gradients are reproducible bit for bit. The split route
    writes dq once and takes only D's f32 rows."""
    b, h, n, hd = q.shape
    ops = (q, k, v, o, do, dq, dk, dv)
    _launch.require_cuda(name, *ops, lse)
    code = _launch.dtype_code(q, name)
    if any(t.dtype != q.dtype for t in ops) or lse.dtype != torch.float32:
        raise TypeError(f"{name}: q, k, v, o, the gradients and their outputs must share one "
                        f"dtype, and lse must be float32")
    if any(tuple(t.shape) != (b, h, n, hd) for t in ops) or tuple(lse.shape) != (b, h, n):
        raise ValueError(f"{name}: operands must be [B, H, N, hd] = {(b, h, n, hd)} and lse "
                         f"[B, H, N], got {[tuple(t.shape) for t in ops]} {tuple(lse.shape)}")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} not supported (kernel takes "
                         f"{SUPPORTED_HEAD_DIMS})")
    for label, t in zip(("q", "k", "v", "o", "do", "dq", "dk", "dv"), ops):
        if t.stride(-1) != 1 or not _launch.aligned(t, 8):
            raise ValueError(f"{name}: {label} needs a contiguous head dim, a 16-byte aligned "
                             f"base and strides that are multiples of 8 (strides {t.stride()})")
    if not lse.is_contiguous():
        raise ValueError(f"{name}: lse must be contiguous")
    slices = attention_bwd_slices(b, h, n)
    f32 = dict(dtype=torch.float32, device=q.device)
    delta = torch.empty((slices if q.dtype == torch.bfloat16 else 1, b, h, n), **f32)
    dq_part = torch.empty((slices if route == "wgmma" else 0, b, h, n, hd), **f32)
    strides = (ctypes.c_longlong * 24)(*[s for t in ops for s in t.stride()[:3]])
    rc = _build.load_library().anyloc_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq_part.data_ptr(),
        code, b, h, n, hd, int(prescale_q), slices, BWD_ROUTE_CODES[route], strides, scale,
        _launch.stream(q))
    _build.check(rc, name)


def _flash_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2's launch on CUDA tensors (shapes checked by the caller); ``lse``
    ([B, H, N] f32, contiguous) receives each query row's log-sum-exp."""
    b, h, n, hd = q.shape
    _launch.require_cuda("flash_attention", q, k, v)
    code = _launch.dtype_code(q, "flash_attention")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share one dtype")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not supported "
                         f"(kernel takes {SUPPORTED_HEAD_DIMS})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or not _launch.aligned(t, 8):
            raise ValueError(
                f"flash_attention: {name} needs a contiguous head dim, a "
                f"16-byte aligned base and strides that are multiples of 8 "
                f"(strides {t.stride()})")
    # [B, N, H, hd] storage: the caller's merge back to [B, N, H*hd] is free
    out = torch.empty((b, n, h, hd), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    rc = _build.load_library().anyloc_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _launch.ptr(lse), code,
        b, h, n, hd,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        scale, _launch.stream(q))
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
flash_attention_bwd.launches = 0
attention_bwd_wgmma.launches = 0
attention_bwd_split.launches = 0

