"""T1 and T2 (tiled int8 and bf16 products) against PyTorch's library
products at the DINOv2-G block's shapes (port of tools/bench_int8_matmul.py).

M = 8704 rows (batch 32 x 257 tokens = 8224, padded to a multiple of 512
as the JAX tool pads for its tiles); K -> N: w12 1536 -> 8192, qkv 1536 ->
4608, w3 4096 -> 1536, proj 1536 -> 1536. For each shape it times cuBLAS's
bf16 product (f32 out where this PyTorch has ``aten::mm.dtype``, else bf16
out; the output says which), T1 on bf16, T1 on int8, T2 (T1 + dequantize,
unit scales) and ``torch._int_mm`` (the JAX tool's "int8 XLA"), as ms and
TFLOP/s (TOPS for int8). Tiles: the tool's bk 512 and bm 512; its bn 1024
does not divide N 4608 or 1536, where the TPU kernel leaves the columns
past 4096 or 1024 unwritten (F8: there the JAX tool timed 8/9 or 2/3 of
the product), so the port takes the largest divisor of N up to 1024 and
times the whole product (the tiles change nothing on this card). Operands
come from a numpy seed; b is the .t() view of [N, K] storage, so no
transpose is timed. Time per call is the CUDA event mean over ``iters``
calls, best of 3.

    python -m anyloc_tpu_torch.tools.bench_int8_matmul [--iters I]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from anyloc_tpu_torch.ops.kernels import matmul, matmul_dequant
from anyloc_tpu_torch.tools._timing import as_linear_t, card_line, require_card, time_ms

M = 8704
SHAPES = (("w12", 1536, 8192), ("qkv", 1536, 4608), ("w3", 4096, 1536), ("proj", 1536, 1536))
PATHS = (("bf16_cublas", "bf16 cuBLAS"), ("bf16_t1", "bf16 T1"), ("int8_t1", "int8 T1"),
         ("int8_t2", "int8 T2 (T1 + dequant)"), ("int8_int_mm", "int8 torch._int_mm"))


def cublas_bf16():
    """PyTorch's bf16 product and its name: f32 output where this PyTorch
    has the ``aten::mm.dtype`` overload (the JAX tool's
    ``preferred_element_type=f32``), else bf16 output."""
    if "dtype" in torch.ops.aten.mm.overloads():
        return "torch.mm(out_dtype=float32)", lambda a, b: torch.mm(a, b, out_dtype=torch.float32)
    return "torch.mm (bf16 out)", torch.mm


def run(shapes=SHAPES, m: int = M, iters: int = 10, seed: int = 0) -> dict:
    dev = require_card("bench_int8_matmul")
    rng = np.random.default_rng(seed)
    lib_name, lib_mm = cublas_bf16()
    out = {"card": card_line(), "m": m, "cublas_bf16": lib_name, "shapes": {}}
    for name, k, n in shapes:
        a8 = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8)).to(dev)
        b8 = as_linear_t(rng.integers(-127, 128, (k, n), dtype=np.int8), dev)
        abf = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).to(dev, torch.bfloat16)
        bbf = as_linear_t(rng.standard_normal((k, n), dtype=np.float32), dev, torch.bfloat16)
        sa = torch.ones((m, 1), device=dev)
        sb = torch.ones((1, n), device=dev)
        tiles = dict(bk=512, bn=next(t for t in range(min(1024, n), 0, -1) if n % t == 0))
        calls = {
            "bf16_cublas": lambda: lib_mm(abf, bbf),
            "bf16_t1": lambda: matmul(abf, bbf, **tiles),
            "int8_t1": lambda: matmul(a8, b8, **tiles),
            "int8_t2": lambda: matmul_dequant(a8, b8, sa, sb, **tiles),
            "int8_int_mm": lambda: torch._int_mm(a8, b8),
        }
        ops = 2 * m * k * n
        res = {"k": k, "n": n, "ops": ops, "bn": tiles["bn"]}
        for key, fn in calls.items():
            ms = time_ms(fn, iters=iters)
            res[f"{key}_ms"] = ms
            res[f"{key}_tops"] = ops / ms / 1e9
        out["shapes"][name] = res
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    res = run(iters=args.iters)
    for name, r in res["shapes"].items():
        print(f"[{res['card']}] {name} [{res['m']}x{r['k']}]x[{r['k']}x{r['n']}]", flush=True)
        for key, label in PATHS:
            unit = "TOPS" if key.startswith("int8") else "TFLOP/s"
            extra = f" ({res['cublas_bf16']})" if key == "bf16_cublas" else ""
            print(f"   {label}{extra}: {r[key + '_ms']:.3f} ms, {r[key + '_tops']:.1f} {unit}",
                  flush=True)


if __name__ == "__main__":
    main()
