"""T1 and T2 — the tiled products of the int8 micro-benchmark.

Hand-written Hopper kernels (``csrc/matmul.cu`` on the GEMMs of
``csrc/int8_common.cuh`` and ``csrc/bf16_gemm.cuh``) replacing
``tools/bench_int8_matmul.py::pallas_matmul`` (:48, T1) and
``::pallas_matmul_dequant`` (:91, T2). Not wired into the trunk, as in the
JAX package; ``anyloc_tpu_torch/tools/bench_int8_matmul.py`` drives them.

Math:
* T1 ``matmul``: int8 operands give the exact int32 sums, returned as int32
  (the default) or converted once to ``out_dtype`` f32 or bf16 (through
  f32, as XLA's ``astype`` and PyTorch's ``.to()`` convert an integer);
  bf16 or f32 operands give f32 sums, returned as f32 (the default) or
  rounded once to bf16;
* T2 ``matmul_dequant``: int8 operands, ``(float(a @ b) · sa) · sb`` in f32
  (the int32 sum rounded to f32, then two f32 products), rounded once to
  ``out_dtype`` (bf16 by default).

The tiles ``bm``, ``bn``, ``bk`` are TPU tilings. They are accepted and do
not change the result (int32 sums are exact in any order; f32 sums only
change order), with one exception, F8: the TPU kernel's grid is
``(m // bm, n // bn, k // bk)`` with each tile cut to its dimension, so
when ``min(tile, dim)`` does not divide ``dim`` it leaves the output rows
or columns past the last whole tile unwritten and drops the last partial K
block from the sum. There is no answer to match, so the wrappers raise
``ValueError``.
"""

from __future__ import annotations

from typing import Optional

import torch

from anyloc_tpu_torch import _build
from anyloc_tpu_torch.ops.kernels import _launch

_CODES = {**_launch.DTYPE_CODES, **_launch.INT_DTYPE_CODES}
_FLOAT_OUT = (torch.float32, torch.bfloat16)


def _dims(a: torch.Tensor, b: torch.Tensor, name: str):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{name}: a must be [M, K] and b [K, N], got "
                         f"{tuple(a.shape)} {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if 0 in (m, k, n):
        raise ValueError(f"{name}: empty product [{m}, {k}] x [{k}, {n}]")
    return m, k, n


def _check_tiles(name: str, m: int, n: int, k: int, bm: int, bn: int,
                 bk: Optional[int]) -> None:
    """F8: refuse the tiles with which the TPU kernel leaves part of the
    output unwritten."""
    for label, dim, tile in (("bm", m, bm), ("bn", n, bn), ("bk", k, k if bk is None else bk)):
        if tile < 1:
            raise ValueError(f"{name}: {label} must be >= 1, got {tile}")
        t = min(tile, dim)
        if dim % t:
            raise ValueError(
                f"{name}: {label}={tile} does not divide {dim} (F8: the TPU kernel's grid "
                f"of {dim} // {t} tiles leaves part of the output unwritten)")


def _exact_int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> int32, exact and independent of
    cuBLASLt: a float64 product (every partial sum is an integer below
    2^53) cast to int32."""
    return (a.double() @ b.double()).to(torch.int32)


def _gemm_operands(a: torch.Tensor, b: torch.Tensor, k: int, n: int, name: str):
    """The kernels' operands: a row-major and 16-byte aligned, b as [N, K]
    rows (``_launch.nk_weight``: no copy for the .t() view of [N, K]
    storage, any other layout is copied); K % 32 == 0 for int8 (the int8
    GEMM's K step), and N even (outputs are stored in pairs)."""
    if a.dtype == torch.int8 and k % 32:
        raise ValueError(f"{name}: int8 operands need K % 32 == 0, got K={k}")
    if n % 2:
        raise ValueError(f"{name}: N={n} must be even")
    a = a.contiguous()
    if a.data_ptr() % 16:
        raise ValueError(f"{name}: a must be 16-byte aligned")
    _launch.check_gemm_rows(a.shape[0], name)
    return a, _launch.nk_weight(b, name)


def matmul_ref(a: torch.Tensor, b: torch.Tensor, *, bm: int = 512, bn: int = 1024,
               bk: Optional[int] = None, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel's math (int8: exact)."""
    m, k, n = _dims(a, b, "matmul")
    _check_tiles("matmul", m, n, k, bm, bn, bk)
    if a.dtype == torch.int8:
        acc = _exact_int8_mm(a, b)
    else:
        acc = a.float() @ b.float()
    return acc if out_dtype is None else acc.to(out_dtype)


def matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 512, bn: int = 1024,
           bk: Optional[int] = None, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """T1, the counterpart of ``pallas_matmul``: a [M, K] @ b [K, N].

    int8 operands -> int32 (or ``out_dtype`` f32 / bf16); bf16 or f32
    operands -> f32 (or ``out_dtype`` bf16). ``bm``/``bn``/``bk`` are the
    TPU's tiles: accepted, refused only where the TPU kernel would leave
    the output partly unwritten (F8). b in the JAX layout; the kernel reads
    [N, K] rows, so the .t() view of [N, K] storage costs no copy (any other
    layout is copied). CPU tensors take ``matmul_ref``; CUDA tensors launch
    the kernel or raise."""
    m, k, n = _dims(a, b, "matmul")
    _check_tiles("matmul", m, n, k, bm, bn, bk)
    if a.dtype != b.dtype or a.dtype not in (torch.int8, torch.bfloat16, torch.float32):
        raise TypeError(f"matmul: a and b must share int8, bfloat16 or float32, got "
                        f"{a.dtype} {b.dtype}")
    int8 = a.dtype == torch.int8
    out_dtype = out_dtype or (torch.int32 if int8 else torch.float32)
    allowed = (torch.int32,) + _FLOAT_OUT if int8 else _FLOAT_OUT
    if out_dtype not in allowed:
        raise TypeError(f"matmul: out_dtype {out_dtype} not supported for {a.dtype} operands "
                        f"(kernel takes {[str(t) for t in allowed]})")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_ref(a, b, bm=bm, bn=bn, bk=bk, out_dtype=out_dtype)
    _launch.require_cuda("matmul", a, b)
    a, b_nk = _gemm_operands(a, b, k, n, "matmul")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    rc = _build.load_library().anyloc_matmul(
        a.data_ptr(), b_nk.data_ptr(), out.data_ptr(), _CODES[a.dtype], _CODES[out_dtype],
        m, n, k, _launch.stream(a))
    _build.check(rc, "matmul")
    matmul.launches += 1
    return out


matmul.launches = 0


def _check_scales(sa: torch.Tensor, sb: torch.Tensor, m: int, n: int) -> None:
    if sa.numel() != m or sb.numel() != n:
        raise ValueError(f"matmul_dequant: sa must be [M={m}, 1] and sb [1, N={n}], got "
                         f"{tuple(sa.shape)} {tuple(sb.shape)}")


def matmul_dequant_ref(a: torch.Tensor, b: torch.Tensor, sa: torch.Tensor, sb: torch.Tensor, *,
                       bm: int = 512, bn: int = 1024, bk: Optional[int] = None,
                       out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of the kernel's math."""
    m, k, n = _dims(a, b, "matmul_dequant")
    _check_tiles("matmul_dequant", m, n, k, bm, bn, bk)
    _check_scales(sa, sb, m, n)
    acc = _exact_int8_mm(a, b).float()
    return (acc * sa.reshape(m, 1).float() * sb.reshape(1, n).float()).to(out_dtype)


def matmul_dequant(a: torch.Tensor, b: torch.Tensor, sa: torch.Tensor, sb: torch.Tensor, *,
                   bm: int = 512, bn: int = 1024, bk: Optional[int] = None,
                   out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """T2, the counterpart of ``pallas_matmul_dequant``:
    ``(a @ b) · sa · sb`` with a [M, K] and b [K, N] int8, sa [M, 1] and
    sb [1, N] (used in f32) -> [M, N] ``out_dtype`` (bf16 or f32). Tiles
    and b's layout as for ``matmul``. CPU tensors take
    ``matmul_dequant_ref``; CUDA tensors launch the kernel or raise."""
    m, k, n = _dims(a, b, "matmul_dequant")
    _check_tiles("matmul_dequant", m, n, k, bm, bn, bk)
    _check_scales(sa, sb, m, n)
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"matmul_dequant: a and b must be int8, got {a.dtype} {b.dtype}")
    if out_dtype not in _FLOAT_OUT:
        raise TypeError(f"matmul_dequant: out_dtype must be float32 or bfloat16, got {out_dtype}")
    if all(t.device.type == "cpu" for t in (a, b, sa, sb)):
        return matmul_dequant_ref(a, b, sa, sb, bm=bm, bn=bn, bk=bk, out_dtype=out_dtype)
    _launch.require_cuda("matmul_dequant", a, b, sa, sb)
    a, b_nk = _gemm_operands(a, b, k, n, "matmul_dequant")
    sa = sa.reshape(m).float().contiguous()
    sb = sb.reshape(n).float().contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    rc = _build.load_library().anyloc_matmul_dequant(
        a.data_ptr(), b_nk.data_ptr(), sa.data_ptr(), sb.data_ptr(), out.data_ptr(),
        _CODES[out_dtype], m, n, k, _launch.stream(a))
    _build.check(rc, "matmul_dequant")
    matmul_dequant.launches += 1
    return out


matmul_dequant.launches = 0
