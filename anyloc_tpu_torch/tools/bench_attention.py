"""K2's flash-attention kernel at the main path's shapes beside PyTorch's
SDPA.

DINOv2-G heads (24 of 64), q/k/v read as strided column views of a fused
[B, N, 3 * 1536] bf16 tensor as the trunk hands them over: N 257 (224 px,
batch 32), 485 (308 px, batch 32) and 5330 (1022 px, batch 1); random
inputs from a numpy seed. Time per call is the CUDA event mean over
``iters`` calls, best of 3; TFLOP/s counts the two products, 4·B·H·N²·hd.

    python -m anyloc_tpu_torch.tools.bench_attention [N ...] [--iters I]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from anyloc_tpu_torch.ops.kernels.flash_attention import flash_attention
from anyloc_tpu_torch.tools._timing import card_line, require_card, time_ms

H, HD = 24, 64
BATCH = {257: 32, 485: 32, 5330: 1}
PATHS = ("k2", "sdpa")


def run(ns=(257, 485, 5330), iters: int = 10, seed: int = 0) -> dict:
    dev = require_card("bench_attention")
    rng = np.random.default_rng(seed)
    out = {"card": card_line(), "shapes": {}}
    d = H * HD
    for n in ns:
        b = BATCH.get(n, 1)
        qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * d)).astype(np.float32)).to(
            dev, torch.bfloat16)
        q, k, v = (qkv[..., i * d:(i + 1) * d].view(b, n, H, HD).transpose(1, 2) for i in range(3))
        flops = 4 * b * H * n * n * HD
        r = {"b": b,
             "k2_ms": time_ms(lambda: flash_attention(q, k, v), iters=iters),
             "sdpa_ms": time_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=iters)}
        for key in PATHS:
            r[key + "_tflops"] = flops / (r[key + "_ms"] * 1e-3) / 1e12
        out["shapes"][n] = r
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ns", nargs="*", type=int, default=[257, 485, 5330])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    res = run(args.ns, args.iters)
    for n, r in res["shapes"].items():
        cols = " | ".join(f"{key} {r[key + '_ms']:.3f} ms ({r[key + '_tflops']:.1f} TFLOP/s)"
                          for key in PATHS)
        print(f"[{res['card']}] B={r['b']} N={n}: {cols}", flush=True)


if __name__ == "__main__":
    main()
