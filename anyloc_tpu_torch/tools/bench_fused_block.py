"""K9 (the whole int8 block in one call) against the trunk's two-kernel
route, K4 then K3, at DINOv2-G width (port of tools/bench_fused_block.py).

Batch 32, 24 heads of 64, D 1536, SwiGLU 4096, N 257 and 485; random int8
weights from a numpy seed. Each route runs a stack of ``layers`` blocks,
each block's output feeding the next; time per block is the stack's CUDA
event time over ``layers``, best of 3.

    python -m anyloc_tpu_torch.tools.bench_fused_block [N ...] [--layers L]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from anyloc_tpu_torch.ops.kernels import fused_attn_half_int8, fused_block_int8, fused_mlp_int8
from anyloc_tpu_torch.tools._timing import (
    as_linear_t, card_line, chain, require_card, time_ms)

B, H, D, HID = 32, 24, 1536, 4096


def run(ns=(257, 485), layers: int = 31, seed: int = 0) -> dict:
    dev = require_card("bench_fused_block")
    rng = np.random.default_rng(seed)

    def qw(shape):
        w = rng.standard_normal(shape).astype(np.float32) * 0.02
        s = np.abs(w).max(axis=0) / 127.0
        q = np.round(w / s).clip(-127, 127).astype(np.int8)
        return as_linear_t(q, dev), torch.from_numpy(s).to(dev)

    wqkv, sqkv = qw((D, 3 * D))
    wp, sp = qw((D, D))
    w12, s12 = qw((D, 2 * HID))
    w3, s3 = qw((HID, D))
    ln = (torch.ones(D, device=dev), torch.zeros(D, device=dev))
    gamma = torch.full((D,), 0.02, device=dev)
    attn_p = (wqkv, sqkv, None, wp, sp, None)
    mlp_p = (w12, s12, None, w3, s3, None)

    def two_kernel(h):
        h = fused_attn_half_int8(h, *attn_p, num_heads=H, ln_params=ln, layerscale=gamma)
        return fused_mlp_int8(h, *mlp_p, mlp_type="swiglu_fused", ln_params=ln,
                              layerscale=gamma, residual=True)

    def one_kernel(h):
        return fused_block_int8(h, attn_p, mlp_p, num_heads=H, ln1=ln, ln2=ln,
                                gamma1=gamma, gamma2=gamma)

    out = {"card": card_line(), "layers": layers, "shapes": {}}
    for n in ns:
        x = torch.from_numpy(rng.standard_normal((B, n, D)).astype(np.float32)).to(dev, torch.bfloat16)
        t2 = time_ms(chain(two_kernel, x, layers), iters=1, warmup=1) / layers
        t1 = time_ms(chain(one_kernel, x, layers), iters=1, warmup=1) / layers
        out["shapes"][n] = {"two_kernel_ms": t2, "merged_ms": t1, "speedup": t2 / t1}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ns", nargs="*", type=int, default=[257, 485])
    ap.add_argument("--layers", type=int, default=31)
    args = ap.parse_args(argv)
    res = run(args.ns, args.layers)
    for n, r in res["shapes"].items():
        print(f"[{res['card']}] N={n}: two-kernel {r['two_kernel_ms']:.3f} ms/block | merged "
              f"{r['merged_ms']:.3f} ms/block ({r['speedup']:.3f}x)", flush=True)


if __name__ == "__main__":
    main()
