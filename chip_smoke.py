#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py [--profile DIR]

Phases, each of which must pass or the script exits non-zero:
  1. device: a CUDA card is required; prints its name and power limit;
  2. build: compiles the CUDA kernels from anyloc_tpu_torch/csrc;
  3. kernels: K1 (VLAD), K2 (flash attention) and K5 (qkv attention +
     out-projection) against their plain PyTorch versions at the main
     path's shapes, with the bound stated on each line, and timed;
  4. end to end: DINOv2-G/14 (random weights from a seed, bf16, blocks
     0..31) value facet of layer 31 -> VLAD-32 fitted on the fixture's
     database -> exact top-k -> Recall@1/5/10 on tests/fixtures/e2e at
     308 px, then one image at 1022 px (5330 tokens); launch counts of
     every kernel must rise during this run; plus a small-input check of
     the card against the plain path;
  5. timing: images/s of extract + VLAD at 224 px and 308 px (batch 32)
     and 1022 px (batch 1). ``--profile DIR`` also writes torch.profiler
     tables of the three shapes to DIR.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "fixtures" / "e2e"

KERNEL_INFO = {
    "K1_vlad_aggregate_fused": dict(
        source="anyloc_tpu_torch/csrc/vlad.cu",
        replaces="anyloc_tpu/ops/pallas/vlad_kernel.py:140"),
    "K2_flash_attention": dict(
        source="anyloc_tpu_torch/csrc/flash_attention.cu",
        replaces="anyloc_tpu/ops/pallas/flash_attention.py:241"),
    "K5_flash_attention_qkv_proj": dict(
        source="anyloc_tpu_torch/csrc/attn_qkv_proj.cu",
        replaces="anyloc_tpu/ops/pallas/attn_proj.py:327"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, reps: int = 3, warmup: int = 2) -> float:
    """Best of ``reps`` means over ``iters`` launches, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def run(profile_dir) -> dict:
    import numpy as np
    import torch
    from PIL import Image

    from anyloc_tpu_torch import _build
    from anyloc_tpu_torch import (
        VLAD, DescriptorEngine, DinoV2ExtractFeatures, VPRDataset,
        ViTConfig, ViTFacetExtractor, get_top_k_recall, listdir_abs)
    from anyloc_tpu_torch.data.transforms import preprocess_image
    from anyloc_tpu_torch.models import vit as vit_module
    from anyloc_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    tag = f"[{card}]"

    # float32 products that decide rankings must not run in TF32
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is enabled")
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is not 'highest'")
    torch.backends.cudnn.allow_tf32 = False   # the f32 patch-embed conv

    t0 = time.perf_counter()
    lib_path = _build.build(verbose=True)
    _build.load_library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 0:.1f} s)",
          flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    results = {name: dict(max_abs_err=0.0) for name in KERNEL_INFO}

    # ---------------------------------------------------------------- K2
    k2_bound = dict(atol=2e-2, rtol=1e-2)
    for label, (b, h, n, hd, dtype), bound in [
        ("1022px", (1, 24, 5330, 64, torch.bfloat16), k2_bound),
        ("ragged-f32", (2, 4, 77, 64, torch.float32), dict(atol=2e-5, rtol=0)),
    ]:
        qkv = randn(b, n, 3 * h * hd, dtype=dtype)
        d = h * hd
        q, k, v = (qkv[..., i * d:(i + 1) * d].view(b, n, h, hd).transpose(1, 2) for i in range(3))
        got = K.flash_attention(q, k, v)
        want = K.flash_attention_ref(q, k, v)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), **bound)
        print(f"K2 flash_attention {label} [{b},{h},{n},{hd}] {str(dtype)[6:]}: "
              f"max_abs_err {err:.3e} (bound atol {bound['atol']} rtol {bound['rtol']}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"K2 {label} disagrees with its plain version")
        r = results["K2_flash_attention"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if label == "1022px":
            r["ms"] = time_ms(lambda: K.flash_attention(q, k, v))
            r["plain_ms"] = time_ms(lambda: K.flash_attention_ref(q, k, v), iters=3)
            r["shape"] = f"[{b},{h},{n},{hd}] bf16"
            print(f"K2 time {tag}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms", flush=True)

    # ---------------------------------------------------------------- K5
    def k5_inputs(b, n):
        d = 1536
        qkv = randn(b, n, 3 * d, dtype=torch.bfloat16)
        w = randn(d, d, dtype=torch.bfloat16, scale=d ** -0.5).t()   # Linear layout
        return qkv, w, dict(b_proj=randn(d, scale=0.1), layerscale=randn(d, scale=0.5),
                            residual=randn(b, n, d, dtype=torch.bfloat16), num_heads=24)

    for b, n in [(8, 257), (4, 485), (32, 485)]:
        qkv, w, kw = k5_inputs(b, n)
        got = K.flash_attention_qkv_proj(qkv, w, **kw)
        want = K.flash_attention_qkv_proj_ref(qkv, w, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), **k2_bound)
        print(f"K5 flash_attention_qkv_proj B={b} N={n} bf16: max_abs_err {err:.3e} "
              f"(bound atol 2e-2 rtol 1e-2) {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"K5 B={b} N={n} disagrees with its plain version")
        r = results["K5_flash_attention_qkv_proj"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if b == 32:
            r["ms"] = time_ms(lambda: K.flash_attention_qkv_proj(qkv, w, **kw))
            r["plain_ms"] = time_ms(lambda: K.flash_attention_qkv_proj_ref(qkv, w, **kw), iters=3)
            r["shape"] = f"qkv [{b},{n},4608] bf16"
            print(f"K5 time {tag}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms", flush=True)

    # ---------------------------------------------------------------- K1
    def facets(b, n, d=1536):
        x = randn(b, n, d)
        return x / x.norm(dim=-1, keepdim=True)

    min_cos_bound = 0.9999
    for b, n, mode in [(8, 256, "hard"), (4, 484, "hard"), (1, 5329, "hard"),
                       (4, 484, "soft"), (32, 484, "hard")]:
        x = facets(b, n)
        centers = x.reshape(-1, x.shape[-1])[torch.randperm(b * n, generator=gen, device=dev)[:32]]
        got = K.vlad_aggregate_fused(x, centers, vlad_mode=mode)
        want = K.vlad_aggregate_fused_ref(x, centers, vlad_mode=mode)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        cos = torch.nn.functional.cosine_similarity(got, want, dim=-1).min().item()
        ok = cos >= min_cos_bound
        print(f"K1 vlad_aggregate_fused [{b},{n},1536] C=32 {mode}: max_abs_err {err:.3e}, "
              f"min per-image cosine {cos:.7f} (bound >= {min_cos_bound}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"K1 [{b},{n}] {mode} disagrees with its plain version")
        r = results["K1_vlad_aggregate_fused"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if b == 32:
            r["ms"] = time_ms(lambda: K.vlad_aggregate_fused(x, centers))
            r["plain_ms"] = time_ms(lambda: K.vlad_aggregate_fused_ref(x, centers))
            r["shape"] = f"[{b},{n},1536] C=32 hard"
            print(f"K1 time {tag}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms", flush=True)

    # ---------------------------------------------------------------- small-input reference check
    # the card's path (kernels) against the plain path (CPU) on a small
    # float32 trunk: d=128, 2 heads of 64, 2 blocks; 224 px -> K5, 504 px -> K2
    cfg = ViTConfig(img_size=56, embed_dim=128, depth=2, num_heads=2, dtype=torch.float32)
    small = ViTFacetExtractor(cfg, None, 1, "token", device="cpu", seed=3)
    small_sd = small.model.state_dict()
    # LayerScale 0.5 instead of 1e-5, so the attention halves matter
    small_sd = {k: (torch.full_like(v, 0.5) if k.endswith("gamma") else v) for k, v in small_sd.items()}
    cpu_ext = ViTFacetExtractor(cfg, small_sd, 1, "token", device="cpu")
    gpu_ext = ViTFacetExtractor(cfg, small_sd, 1, "token", device=dev)
    cpu_centers = None
    for px in (224, 504):
        imgs = np.random.default_rng(px).standard_normal((2, px, px, 3)).astype(np.float32)
        want = cpu_ext(imgs)
        got = gpu_ext(imgs).cpu()
        err = (got - want).abs().max().item()
        if cpu_centers is None:
            cpu_centers = want.reshape(-1, 128)[::37][:8].clone()
        v_want = VLAD(8)
        v_want.c_centers = cpu_centers
        vw = v_want.aggregate(want)
        vg = v_want.aggregate(gpu_ext(imgs)).cpu()
        vcos = torch.nn.functional.cosine_similarity(vg, vw, dim=-1).min().item()
        print(f"small-input check {px} px: facet max_abs_err card vs CPU {err:.3e} (bound 1e-4), "
              f"VLAD min cosine {vcos:.7f} (bound >= 0.9999)", flush=True)
        check(err <= 1e-4 and vcos >= 0.9999, f"card and plain path disagree at {px} px")

    # ---------------------------------------------------------------- end to end (the main path)
    db = listdir_abs(str(FIXTURE), "db")
    qu = listdir_abs(str(FIXTURE), "queries")
    gt = list(np.load(FIXTURE / "gt.npy", allow_pickle=True))
    t0 = time.perf_counter()
    ext = DinoV2ExtractFeatures("dinov2_vitg14", 31, "value", device=dev, seed=42)
    torch.cuda.synchronize()
    print(f"model: dinov2_vitg14 bf16, {len(ext.model.blocks)} blocks materialized, "
          f"{sum(p.numel() for p in ext.model.parameters()) / 1e9:.3f} B params, "
          f"random init {time.perf_counter() - t0:.1f} s", flush=True)
    check(len(ext.model.blocks) == 32, "blocks 0..31 must be materialized")

    K.reset_launch_counts()
    t0 = time.perf_counter()
    ds = VPRDataset(db, qu, soft_positives_per_query=gt, img_size=(320, 320))
    engine = DescriptorEngine(extractor=ext, batch_size=16)
    vocab = engine.extract_dataset(ds, "db", verbose=False, keep_on_device=True)
    check(tuple(vocab.shape) == (16, 484, 1536), f"vocab facets shape {tuple(vocab.shape)}")
    vlad = VLAD(32)
    vlad.fit(vocab.reshape(-1, vocab.shape[-1]))
    dbv = engine.extract_vlads_dataset(ds, vlad, "db", verbose=False)
    quv = engine.extract_vlads_dataset(ds, vlad, "queries", verbose=False)
    dists, idx, recalls = get_top_k_recall(
        [1, 5, 10], torch.from_numpy(dbv).to(dev), torch.from_numpy(quv).to(dev), gt)
    e2e_s = time.perf_counter() - t0
    check(dbv.shape == (16, 32 * 1536) and quv.shape == (8, 32 * 1536),
          f"VLAD shapes {dbv.shape} {quv.shape}")
    allv = np.concatenate([dbv, quv])
    norms = np.linalg.norm(allv, axis=1)
    check(bool(np.isfinite(allv).all()), "non-finite VLAD values")
    check(bool(np.all(np.abs(norms - 1) <= 1e-3)), f"VLAD norms {norms.min()}..{norms.max()}")
    check(idx.shape == (8, 10) and bool(np.isfinite(dists).all()), "retrieval output")
    print(f"e2e 308 px: 24 images (fixture), vocabulary k-means on {vocab.shape[0] * vocab.shape[1]} "
          f"facets, {e2e_s:.1f} s; VLAD norms {norms.min():.6f}..{norms.max():.6f}; "
          f"recall (random weights, not asserted) {recalls}", flush=True)

    big = Image.open(db[0]).convert("RGB").resize((1536, 1536), Image.BILINEAR)
    arr = preprocess_image(big, max_edge=1024)
    check(arr.shape == (1022, 1022, 3), f"1022-px input shape {arr.shape}")
    f1022 = ext(arr[None])
    v1022 = vlad.aggregate(f1022)
    torch.cuda.synchronize()
    check(tuple(f1022.shape) == (1, 5329, 1536), f"1022-px facets {tuple(f1022.shape)}")
    check(bool(torch.isfinite(v1022).all()) and abs(v1022.norm().item() - 1) <= 1e-3,
          "1022-px VLAD not finite or not unit-norm")
    counts = K.launch_counts()
    print(f"e2e 1022 px: facets {tuple(f1022.shape)}, VLAD {tuple(v1022.shape)}; "
          f"launch counts over the main path {counts}", flush=True)
    for name, c in counts.items():
        check(c > 0, f"{name} never launched on the main path")
        results[name]["launches"] = c

    # the same small input through the kernels and through the plain
    # versions, on the card, at full width (bf16 G, 2 images at 224 px)
    imgs = torch.from_numpy(np.stack([preprocess_image(Image.open(p).convert("RGB"), (224, 224))
                                      for p in db[:2]])).to(dev)
    got_f = ext(imgs)
    saved = (vit_module.flash_attention_qkv_proj, vit_module.flash_attention)
    vit_module.flash_attention_qkv_proj = K.flash_attention_qkv_proj_ref
    vit_module.flash_attention = K.flash_attention_ref
    try:
        want_f = ext(imgs)
    finally:
        vit_module.flash_attention_qkv_proj, vit_module.flash_attention = saved
    fcos = torch.nn.functional.cosine_similarity(got_f, want_f, dim=-1).min().item()
    vcos = torch.nn.functional.cosine_similarity(
        vlad.aggregate(got_f), K.vlad_aggregate_fused_ref(want_f, vlad.c_centers.to(dev)), dim=-1).min().item()
    print(f"G bf16 224 px, kernels vs plain versions on the card: min facet cosine {fcos:.6f} "
          f"(bound >= 0.999), min VLAD cosine {vcos:.6f} (bound >= 0.99)", flush=True)
    check(fcos >= 0.999 and vcos >= 0.99, "main path disagrees with its plain version")

    # ---------------------------------------------------------------- throughput
    for px, bsz in [(224, 32), (308, 32), (1022, 1)]:
        x = torch.randint(0, 256, (bsz, px, px, 3), dtype=torch.uint8, generator=None).to(dev)

        def step():
            return vlad.aggregate(ext(x))

        ms = time_ms(step, iters=10, reps=3)
        n_tok = (px // 14) ** 2 + 1
        print(f"throughput {tag}: extract+VLAD {px} px ({n_tok} tokens) batch {bsz}: "
              f"{ms:.2f} ms/batch, {bsz * 1000 / ms:.2f} images/s", flush=True)
        if profile_dir is not None:
            profile(step, Path(profile_dir) / f"profile_{px}px_b{bsz}.txt", f"{px} px batch {bsz} {tag}")

    print(f"card: {card}", flush=True)
    return {name: {"name": name, "route": "cuda", **KERNEL_INFO[name], **r}
            for name, r in results.items()}


def profile(step, out_path: Path, label: str) -> None:
    """torch.profiler over three steps: device time by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    step()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=25)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(f"{label}, 3 steps\n{table}\n")
    print(f"profile {label}: written to {out_path}", flush=True)
    print("\n".join(table.splitlines()[:14]), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also write torch.profiler tables of the throughput shapes to DIR")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path needs one card",
              file=sys.stderr)
        return 2
    try:
        kernels = run(args.profile)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
