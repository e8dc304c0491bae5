"""K6 (attention + output projection in one call) against K2 then a
cuBLAS projection (port of tools/bench_attn_proj.py).

DINOv2-G width: q/k/v [32, 24, N, 64] bf16 for N 257 (224 px) and 530
(320 px), W_O 1536 x 1536; random inputs from a numpy seed. Time per call
is the CUDA event mean over ``iters`` calls, best of 3.

    python -m anyloc_tpu_torch.tools.bench_attn_proj [N ...] [--iters I]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from anyloc_tpu_torch.ops.kernels import attention_proj, flash_attention
from anyloc_tpu_torch.tools._timing import as_linear_t, card_line, require_card, time_ms

B, H, HD, D = 32, 24, 64, 1536


def unfused(q, k, v, wp):
    b, h, n, hd = q.shape
    o = flash_attention(q, k, v).transpose(1, 2).reshape(b, n, h * hd)
    return o @ wp


def run(ns=(257, 530), iters: int = 10, seed: int = 0) -> dict:
    dev = require_card("bench_attn_proj")
    rng = np.random.default_rng(seed)
    out = {"card": card_line(), "shapes": {}}
    for n in ns:
        q, k, v = (torch.from_numpy(rng.standard_normal((B, H, n, HD)).astype(np.float32))
                   .to(dev, torch.bfloat16) for _ in range(3))
        wp = as_linear_t((rng.standard_normal((D, D)) * 0.02).astype(np.float32), dev,
                         torch.bfloat16)
        t0 = time_ms(lambda: unfused(q, k, v, wp), iters=iters)
        t1 = time_ms(lambda: attention_proj(q, k, v, wp), iters=iters)
        out["shapes"][n] = {"unfused_ms": t0, "fused_ms": t1}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ns", nargs="*", type=int, default=[257, 530])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    res = run(args.ns, args.iters)
    for n, r in res["shapes"].items():
        print(f"[{res['card']}] N={n}: unfused (K2 + cuBLAS proj) {r['unfused_ms']:.3f} ms | "
              f"fused (K6) {r['fused_ms']:.3f} ms", flush=True)


if __name__ == "__main__":
    main()
