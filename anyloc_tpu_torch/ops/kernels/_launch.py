"""Launch helpers shared by the kernel wrappers."""

from __future__ import annotations

import torch

# dtype codes of csrc/common.cuh (DT_F32, DT_BF16, DT_I8, DT_I32). The float
# kernels take only the first two (``dtype_code`` refuses the rest); T1 and
# T2 take the integer codes too.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
INT_DTYPE_CODES = {torch.int8: 2, torch.int32: 3}


def dtype_code(t: torch.Tensor, name: str) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t.dtype} not supported "
                        f"(kernel takes {sorted(map(str, DTYPE_CODES))})")
    return DTYPE_CODES[t.dtype]


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every tensor on one CUDA device — a CUDA call never takes the plain
    path — and no gradient asked of it (``refuse_grad``). Every wrapper
    calls it after its CPU branch."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"{name}: tensors must share one CUDA device "
                f"(got {[str(x.device) for x in tensors]})")
    refuse_grad(name, *tensors)


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """The kernels write through raw pointers into fresh tensors, which
    carry no ``grad_fn``: with grad mode on and an input that requires a
    gradient, a launch would cut the graph without a word, so it raises
    instead (F18). K2 and K5 are the kernels with a gradient: their
    wrappers run the launch inside an ``autograd.Function``
    (``FlashAttentionGrad``, ``QkvProjGrad``: the kernel forward, the plain
    version's gradient backward), whose forward has grad mode off."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires a gradient and this kernel has none (its output "
            "would be detached); call it under torch.no_grad() / torch.inference_mode(), "
            "or use its plain version")


def aligned(t: torch.Tensor, elems: int) -> bool:
    """Base pointer on a 16-byte boundary and every non-unit stride a
    multiple of ``elems`` elements (16-byte vector loads)."""
    return (t.data_ptr() % 16 == 0
            and all(s % elems == 0 for s, n in zip(t.stride(), t.shape)
                    if n > 1 and s != 1))


def ptr(t):
    return None if t is None else t.data_ptr()


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_gemm_rows(m: int, dtype: torch.dtype, name: str) -> None:
    """The GEMMs put their row tiles on the grid's y axis, at most 65535 of
    them: 128 rows for int8 and bf16 operands (both run the TMA GEMM of
    csrc/int8_common.cuh), 64 for the f32 FMA GEMM (csrc/bf16_gemm.cuh).
    ``dtype`` is the GEMM's operand type."""
    tile = 64 if dtype == torch.float32 else 128
    if -(-m // tile) > 65535:
        raise ValueError(f"{name}: {m} rows > {tile * 65535}; split the batch")


def nk_weight(w: torch.Tensor, name: str) -> torch.Tensor:
    """A JAX-layout weight [in, out] as the kernels' [out, in] rows: a
    Linear weight's .t() view is exactly that, so the usual caller pays no
    copy. The rows must be 16-byte aligned, with an input width that is a
    multiple of 8 elements and of 16 bytes."""
    w_nk = w.t().contiguous()
    if w_nk.data_ptr() % 16 or w_nk.shape[1] % max(8, 16 // w_nk.element_size()):
        raise ValueError(f"{name}: weights must be 16-byte aligned with an input "
                         f"width % 8 == 0 and rows of whole 16 bytes, got {tuple(w.shape)}")
    return w_nk
