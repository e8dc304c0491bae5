"""Images/s of extract + VLAD on the card, with the host's share.

DINOv2-G/14 (layer 31 value facet, random weights from seed 42) in bf16
and in int8_full, then VLAD-32 hard assignment (centers from the first
database batch's facets), at 224 px and 308 px (batch 32) and 1022 px
(batch 1) with uint8 images already on the card: the throughput phase of
``chip_smoke.py``. Device time per batch is the CUDA event mean over
``iters`` steps, best of ``reps``. Beside it, the host's time to enqueue
one step, the card idle before it: where that time stays well below the
device time, the host does not hold the card back and a host-side cost
cannot move the rate. Runs against whichever ``anyloc_tpu_torch`` is
first on the path, so two trees can be compared in one call on one card.

    python -m anyloc_tpu_torch.tools.bench_throughput [--iters I] [--reps R]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from anyloc_tpu_torch.tools._timing import card_line, require_card, time_ms

SHAPES = ((224, 32), (308, 32), (1022, 1))


def host_ms(step, reps: int = 5) -> float:
    """Least host time to enqueue one step, the card idle before it."""
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        best = min(best, (time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return best


def run(iters: int = 10, reps: int = 3) -> dict:
    dev = require_card("bench_throughput")
    from anyloc_tpu_torch import VLAD
    from anyloc_tpu_torch.models.extractor import DinoV2ExtractFeatures
    from anyloc_tpu_torch.pipelines.engine import DescriptorEngine

    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"card": card_line(), "paths": {}}
    for path in ("bf16", "int8_full"):
        if path == "bf16":
            ext = DinoV2ExtractFeatures("dinov2_vitg14", 31, "value", device=dev, seed=42)
        else:
            ext = DescriptorEngine("dinov2_vitg14", 31, "value", batch_size=16, quant="int8_full",
                                   transfer_dtype="uint8").extractor
        rows = {}
        vlad = None
        for px, bsz in SHAPES:
            x = torch.randint(0, 256, (bsz, px, px, 3), dtype=torch.uint8, device=dev,
                              generator=gen)
            if vlad is None:
                f = ext(x)
                vlad = VLAD(32)
                vlad.fit(f.reshape(-1, f.shape[-1]))

            def step():
                return vlad.aggregate(ext(x))

            ms = time_ms(step, iters=iters, reps=reps)
            rows[px] = {"batch": bsz, "ms": ms, "images_per_s": bsz * 1000 / ms,
                        "host_enqueue_ms": host_ms(step)}
        out["paths"][path] = rows
        del ext, vlad
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    res = run(args.iters, args.reps)
    for path, rows in res["paths"].items():
        for px, r in rows.items():
            print(f"[{res['card']}] {path} extract+VLAD {px} px batch {r['batch']}: "
                  f"{r['ms']:.2f} ms/batch, {r['images_per_s']:.2f} images/s; host enqueue "
                  f"{r['host_enqueue_ms']:.2f} ms", flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
