"""Launch helpers shared by the kernel wrappers."""

from __future__ import annotations

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor, name: str) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t.dtype} not supported "
                        f"(kernel takes {sorted(map(str, DTYPE_CODES))})")
    return DTYPE_CODES[t.dtype]


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every tensor on one CUDA device — a CUDA call never takes the plain
    path."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"{name}: tensors must share one CUDA device "
                f"(got {[str(x.device) for x in tensors]})")


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
