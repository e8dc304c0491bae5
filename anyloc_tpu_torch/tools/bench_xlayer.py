"""T3 (the int8 attention half with two experiment knobs) against the
production K4 (port of tools/bench_xlayer.py).

Batch 32 at DINOv2-G width (D 1536, 24 heads of 64), N 257 and 485. Per
layer it times the production kernel (K4, no biases), the variant's base
(T3, the same function), A, the prologue stub (T3 reading pre-quantized
rows instead of LN1 + quantize), and B, batched dots (T3 keeping each
head's attention output in f32), and prints lever (a) = base - stub, the
most that folding a layer's LN1 + quantize under the previous layer's MLP
half could gain, and lever (c) = base - batched. Weights and inputs come
from a numpy seed with the JAX tool's distributions. Time per call is the
CUDA event mean over ``iters`` calls, best of 3.

    python -m anyloc_tpu_torch.tools.bench_xlayer [N ...] [--iters I]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from anyloc_tpu_torch.ops.common import round_up
from anyloc_tpu_torch.ops.kernels import attn_half_variant, fused_attn_half_int8
from anyloc_tpu_torch.tools._timing import as_linear_t, card_line, require_card, time_ms

B, H, HD, D = 32, 24, 64, 1536


def run(ns=(257, 485), iters: int = 20, seed: int = 0) -> dict:
    dev = require_card("bench_xlayer")
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(dev)

    out = {"card": card_line(), "shapes": {}}
    for n in ns:
        x = f32(rng.standard_normal((B, n, D)) * 0.5).to(torch.bfloat16)
        np_pad = round_up(n, 8)
        wqkv_q = as_linear_t(rng.integers(-127, 128, (D, 3 * D)).astype(np.int8), dev)
        wqkv_s = f32(rng.random(3 * D) * 0.01 + 0.001)
        wp_q = as_linear_t(rng.integers(-127, 128, (D, D)).astype(np.int8), dev)
        wp_s = f32(rng.random(D) * 0.01 + 0.001)
        ln = (torch.ones((1, D), device=dev), torch.zeros((1, D), device=dev))
        gamma = f32(rng.random((1, D)) * 1e-3)
        # pre-quantized rows for the stub (their values do not matter to the time)
        xq_in = torch.from_numpy(rng.integers(-127, 128, (B, np_pad, D)).astype(np.int8)).to(dev)
        xs_in = f32(rng.random((B, np_pad, 1)) * 0.01 + 1e-3)

        def variant(pre_quant, batched_dots):
            return lambda: attn_half_variant(x, xq_in, xs_in, wqkv_q, wqkv_s, wp_q, wp_s, ln,
                                             gamma, pre_quant=pre_quant, batched_dots=batched_dots)

        prod = time_ms(lambda: fused_attn_half_int8(
            x, wqkv_q, wqkv_s, None, wp_q, wp_s, None, num_heads=H,
            ln_params=(ln[0].ravel(), ln[1].ravel()), layerscale=gamma.ravel()), iters=iters)
        base = time_ms(variant(False, False), iters=iters)
        stub = time_ms(variant(True, False), iters=iters)
        bat = time_ms(variant(False, True), iters=iters)
        out["shapes"][n] = dict(production_ms=prod, base_ms=base, stub_ms=stub, batched_ms=bat,
                                lever_a_ms=base - stub, lever_c_ms=base - bat)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ns", nargs="*", type=int, default=[257, 485])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    res = run(args.ns, args.iters)
    for n, r in res["shapes"].items():
        print(f"[{res['card']}] N={n}: production {r['production_ms']:.3f}  variant-base "
              f"{r['base_ms']:.3f}  A:prologue-stub {r['stub_ms']:.3f}  B:batched-dots "
              f"{r['batched_ms']:.3f}  ms/layer", flush=True)
        print(f"      lever-a max gain {r['lever_a_ms']:+.3f} ms; lever-c "
              f"{r['lever_c_ms']:+.3f} ms", flush=True)


if __name__ == "__main__":
    main()
