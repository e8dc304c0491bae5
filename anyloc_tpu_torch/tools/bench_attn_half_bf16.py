"""K7 (the bf16 attention half in one call) against the trunk's split route:
LayerNorm and the qkv product in plain torch (cuBLAS), then K5 (port of
tools/bench_attn_half_bf16.py).

DINOv2-G width: batch 32, N 257, D 1536, 24 heads; random bf16 weights
from a numpy seed. Each route runs ``iters`` layers, each output feeding
the next; time per layer is the CUDA event time over ``iters``, best of 3.

    python -m anyloc_tpu_torch.tools.bench_attn_half_bf16 [--iters I]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from anyloc_tpu_torch.ops.kernels import flash_attention_qkv_proj, fused_attn_half_bf16
from anyloc_tpu_torch.ops.kernels.fused_mlp import ln_rows
from anyloc_tpu_torch.tools._timing import (
    as_linear_t, card_line, chain, require_card, time_ms)

B, N, D, H = 32, 257, 1536, 24


def run(iters: int = 100, seed: int = 0) -> dict:
    dev = require_card("bench_attn_half_bf16")
    rng = np.random.default_rng(seed)

    def f32(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    x = torch.from_numpy(f32(B, N, D, scale=0.1)).to(dev, torch.bfloat16)
    wqkv = as_linear_t(f32(D, 3 * D, scale=0.02), dev, torch.bfloat16)
    bqkv = torch.from_numpy(f32(3 * D, scale=0.01)).to(dev)
    wp = as_linear_t(f32(D, D, scale=0.02), dev, torch.bfloat16)
    bp = torch.from_numpy(f32(D, scale=0.01)).to(dev)
    ln = (torch.ones(D, device=dev), torch.zeros(D, device=dev))
    gamma = torch.from_numpy(f32(D, scale=0.1)).to(dev)
    bqkv16 = bqkv.to(torch.bfloat16)

    def split(h):
        hn = ln_rows(h.float(), *ln, 1e-6).to(torch.bfloat16)
        qkv = hn @ wqkv + bqkv16
        return flash_attention_qkv_proj(qkv, wp, bp, num_heads=H, layerscale=gamma, residual=h)

    def fused(h):
        return fused_attn_half_bf16(h, wqkv, bqkv, wp, bp, num_heads=H, ln_params=ln,
                                    layerscale=gamma)

    ms_split = time_ms(chain(split, x, iters), iters=1, warmup=1) / iters
    ms_fused = time_ms(chain(fused, x, iters), iters=1, warmup=1) / iters
    s1, s2 = (float(chain(f, x, iters)().float().max()) for f in (split, fused))
    return {"card": card_line(), "iters": iters, "split_ms": ms_split, "fused_ms": ms_fused,
            "split_max": s1, "fused_max": s2}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args(argv)
    r = run(args.iters)
    print(f"[{r['card']}] split (LN + cuBLAS qkv -> K5): {r['split_ms']:.3f} ms/layer", flush=True)
    print(f"[{r['card']}] fused bf16 attention half (K7): {r['fused_ms']:.3f} ms/layer", flush=True)
    print(f"outputs after {r['iters']} layers: max {r['split_max']:.4f} vs {r['fused_max']:.4f}")


if __name__ == "__main__":
    main()
