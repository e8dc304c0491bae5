#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py [--profile DIR]

Phases, each of which must pass or the script exits non-zero:
  1. device: a CUDA card is required; prints its name and power limit;
  2. build: compiles the CUDA kernels from anyloc_tpu_torch/csrc (one nvcc
     per source, in parallel);
  3. kernels: K2 (flash attention; at 5330 tokens within a bound scaled
     to its output, with faults planted in the plain version beyond it),
     K5 (qkv attention + out-projection), K2 and K5 at head dim 80 (ViT-H
     width, F10), K1 (VLAD, at the main path's three shapes in its three
     modes, hard labels up to near ties, two launches bit-equal; then
     draws that count label flips on near ties, tools/vlad_near_ties.py),
     K4 (int8 attention half), K3 (int8 MLP half), the block variants
     K9 (whole int8 block), K7 (bf16 attention half), K8 (bf16 MLP
     half) and K6 (attention + projection), and the
     micro-benchmarks' kernels T1 (tiled int8 / bf16 product; int8
     bit-exact, also with sums past 2^24), T2 (int8 product with a
     dequantize epilogue) and T3 (the int8 attention half with its
     pre_quant / batched_dots knobs; its base bit-equal to K4, its heads'
     outputs f32 with batched_dots), then K4, K6, K7, K9 and T3 at head
     dim 80 (ViT-H width, F10),
     against their plain PyTorch versions at the main paths' and the tools'
     shapes, with the error bound stated on each line, timed beside the
     plain version, the least time the card could take (bound_ms), a
     PyTorch library call as a yardstick where one computes the same
     (library_ms: SDPA for K2, torch._int_mm / cuBLAS for T1), for
     K6-K9, T2 and T3 the route the port wires instead (wired_ms), and for
     K2, K3, K5-K8, T1 on bf16 and T2 the rate their products reach
     (TFLOP/s or TOPS) and their share of the bound (bound_ms / ms);
  4. the bf16 path: DINOv2-G/14 (random weights from a seed, blocks 0..31)
     value facet of layer 31 -> VLAD-32 fitted on the fixture's database
     -> exact top-k -> Recall@1/5/10 on tests/fixtures/e2e at 308 px, then
     one image at 1022 px (5330 tokens); K1, K2 and K5 must launch during
     this run; plus a small-input check of the card against the plain path
     and of G's facets through the kernels against the plain versions;
  5. the int8_full path (the serving mode): the same run through
     DescriptorEngine(quant="int8_full", transfer_dtype="uint8"), weights
     quantized on the card; K1, K2, K3 and K4 must launch during it; then
     G int8_full facets through the kernels against the plain versions,
     and against the bf16 trunk on the same weights;
  6. block variants at DINOv2-G width: K9 on block 0 of the int8_full
     trunk against the trunk's K4 -> K3, K7 -> K8 on block 0 of the bf16
     trunk against the trunk's block, then the three block-variant tools
     (anyloc_tpu_torch/tools/) with short stacks; K6-K9 must launch in
     the tools' run; then the T1-T3 tools (bench_int8_matmul,
     bench_xlayer) with few iterations, in which T1-T3 must launch;
  7. the entry point: dataset roots written to a temporary directory
     (17places in the vpr_bench layout from the fixture's JPEGs, gardens
     from data/synthetic.py at 640x480), then ``python -m anyloc_tpu_torch
     global-vocab-vlad`` through ``cli.main`` at DINOv2-G/14 layer 31
     value, 320 -> 308 px, VLAD-32, in bf16 (K1 and K5 must launch) and in
     int8_full with uint8 transfer (K1, K3 and K4 must launch), then the
     ``vlad`` subcommand in bf16; each writes its results JSON and runs its
     top-k on the card; then the descriptor cache (a second engine launches
     nothing and reads bit-equal VLADs; a truncated shard is recomputed);
     then ingest: images/s of host decode alone (PIL and the native pipe,
     float32 and uint8) and of decode + extract + VLAD through the engine
     on a 384-image database, best of 3; then the retrieval engines
     (``retrieval_phase``): "device", "blocked" (f32, bf16, int8 streams)
     and "native" at 10,000 x 49152, "ivf", "pq" and "ivf_pq" fitted at
     1,000,000 x 512, each timed with its recall against exact search, the
     exact ones (and full probe / decode()) held to exact search;
  8. timing: images/s of extract + VLAD at 224 px and 308 px (batch 32)
     and 1022 px (batch 1), bf16 and int8_full, images already on the
     card, then the ingest rates beside them. ``--profile DIR`` also
     writes torch.profiler tables of the shapes to DIR.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import sys
import tempfile
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
    "K3_fused_mlp_int8": dict(
        source="anyloc_tpu_torch/csrc/fused_mlp_int8.cu",
        replaces="anyloc_tpu/ops/pallas/fused_mlp.py:250"),
    "K4_fused_attn_half_int8": dict(
        source="anyloc_tpu_torch/csrc/attn_half_int8.cu",
        replaces="anyloc_tpu/ops/pallas/attn_proj.py:501"),
    "K5_flash_attention_qkv_proj": dict(
        source="anyloc_tpu_torch/csrc/attn_qkv_proj.cu",
        replaces="anyloc_tpu/ops/pallas/attn_proj.py:327"),
    "K6_attention_proj": dict(
        source="anyloc_tpu_torch/csrc/attention_proj.cu",
        replaces="anyloc_tpu/ops/pallas/attn_proj.py:822"),
    "K7_fused_attn_half_bf16": dict(
        source="anyloc_tpu_torch/csrc/attn_half_bf16.cu",
        replaces="anyloc_tpu/ops/pallas/attn_proj.py:709"),
    "K8_fused_mlp_bf16": dict(
        source="anyloc_tpu_torch/csrc/fused_mlp_bf16.cu",
        replaces="anyloc_tpu/ops/pallas/fused_mlp.py:414"),
    "K9_fused_block_int8": dict(
        source="anyloc_tpu_torch/csrc/fused_block_int8.cu",
        replaces="anyloc_tpu/ops/pallas/fused_block.py:128"),
    "T1_matmul": dict(
        source="anyloc_tpu_torch/csrc/matmul.cu",
        replaces="tools/bench_int8_matmul.py:48"),
    "T2_matmul_dequant": dict(
        source="anyloc_tpu_torch/csrc/matmul.cu",
        replaces="tools/bench_int8_matmul.py:91"),
    "T3_attn_half_variant": dict(
        source="anyloc_tpu_torch/csrc/attn_half_variant.cu",
        replaces="tools/bench_xlayer.py:150"),
}
# kernels each path must launch
PATH_KERNELS = {
    "bf16": ("K1_vlad_aggregate_fused", "K2_flash_attention", "K5_flash_attention_qkv_proj"),
    "int8_full": ("K1_vlad_aggregate_fused", "K2_flash_attention", "K3_fused_mlp_int8",
                  "K4_fused_attn_half_int8"),
    # the block-variant tools (the JAX trunk does not wire K6-K9 either)
    "variants": ("K6_attention_proj", "K7_fused_attn_half_bf16", "K8_fused_mlp_bf16",
                 "K9_fused_block_int8"),
    # the micro-benchmark tools (T1-T3 drive nothing else, as in the JAX package)
    "tools": ("T1_matmul", "T2_matmul_dequant", "T3_attn_half_variant"),
    # python -m anyloc_tpu_torch global-vocab-vlad / vlad at 308 px
    "entry bf16": ("K1_vlad_aggregate_fused", "K5_flash_attention_qkv_proj"),
    "entry int8_full": ("K1_vlad_aggregate_fused", "K3_fused_mlp_int8", "K4_fused_attn_half_int8"),
}
# the trunk's kernels: a read from the descriptor cache launches none of them
TRUNK_KERNELS = ("K1_vlad_aggregate_fused", "K2_flash_attention", "K3_fused_mlp_int8",
                 "K4_fused_attn_half_int8", "K5_flash_attention_qkv_proj")
INGEST_DB = 384   # the fixture's 24 JPEGs (640x480), 16 times
# the entry point's flags, as a user runs AnyLoc-VLAD-DINOv2 at 320 -> 308 px
ENTRY_ARGS = ["--prog.vg-dataset-name", "17places", "--db-samples", "17places=1", "gardens=1",
              "--extractor.model-type", "dinov2_vitg14", "--extractor.desc-layer", "31",
              "--extractor.desc-facet", "value", "--bd-args.resize", "320", "320",
              "--top-k-vals", "1", "5", "10"]
# One H100 SXM's published dense peaks at its 700 W limit (NVIDIA's data
# sheet; f32 outside the tensor cores): operations/s by type, bytes/s.
PEAK = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "hbm": 3.35e12}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def bound(ops: dict, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations
    over their type's peak (summed over types) and the bytes over the
    memory rate."""
    t_ops = sum(n / PEAK[kind] for kind, n in ops.items())
    t_bytes = nbytes / PEAK["hbm"]
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def rms_rel(got, want) -> float:
    got, want = got.double(), want.double()
    return (((got - want) ** 2).mean() / (want ** 2).mean()).sqrt().item()


def outside_share(got, want, atol: float, rtol: float) -> float:
    """Share of elements beyond atol + rtol·|want|: the int8 kernels may
    differ from their plain versions by a flipped code (one quantization
    step; a flipped input code moves its whole row), a rare discrete
    event, so their bound is a small share, not none."""
    got, want = got.float(), want.float()
    return ((got - want).abs() > atol + rtol * want.abs()).float().mean().item()


def run(profile_dir) -> dict:
    import numpy as np
    import torch
    from PIL import Image

    from anyloc_tpu_torch import _build
    from anyloc_tpu_torch import (
        VLAD, DescriptorEngine, DinoV2ExtractFeatures, VPRDataset,
        ViTConfig, ViTFacetExtractor, get_top_k_recall, listdir_abs)
    import torch.nn.functional as F

    from anyloc_tpu_torch.data import synthetic
    from anyloc_tpu_torch.data.transforms import preprocess_image
    from anyloc_tpu_torch.models import vit as vit_module
    from anyloc_tpu_torch.ops import kernels as K
    from anyloc_tpu_torch.ops.common import round_up
    from anyloc_tpu_torch.ops.kernels.attn_proj import _pick_int8_head_chunk
    from anyloc_tpu_torch.ops.kernels.fused_mlp import ln_rows
    from anyloc_tpu_torch.ops.kernels.vlad_kernel import hard_label_agreement
    from anyloc_tpu_torch.ops.quant import int8_matmul, quantize_weight_cols
    from anyloc_tpu_torch.tools import (
        bench_attn_half_bf16, bench_attn_proj, bench_fused_block, bench_int8_matmul, bench_xlayer,
        vlad_near_ties)
    from anyloc_tpu_torch.tools._timing import card_line, time_ms

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
    lib_path = _build.build()
    _build.load_library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 0:.1f} s, "
          f"one process per source)", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    results = {name: dict(max_abs_err=0.0, library_ms=None) for name in KERNEL_INFO}

    def record(name, err, **kw):
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r.update(kw)

    def timing_line(name, label):
        r = results[name]
        lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.3f} ms"
        if "wired_ms" in r:
            lib += f", wired route {r['wired_ms']:.3f} ms"
        rate = ""
        if "rate" in r:
            rate = (f"; {r['rate']:.1f} {r['rate_unit']}, {100 * r['bound_share']:.1f} % of the "
                    f"bound")
        print(f"{name} time {tag} at {label}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms"
              f"{lib}; bound {r['bound_ms']:.4f} ms ({r['bound_by']}){rate}", flush=True)

    def achieved(name, ops, unit):
        """The kernel's rate (operations of its products over its time) and
        its share of the bound (bound_ms / ms), beside its times."""
        r = results[name]
        r.update(rate=ops / (r["ms"] * 1e-3) / 1e12, rate_unit=unit,
                 bound_share=r["bound_ms"] / r["ms"])

    # ---------------------------------------------------------------- K2
    # At N 5330 the outputs of unit-normal q/k/v are about sqrt(e/N) ~ 0.02,
    # under an atol of 2e-2: there the bound is scaled to the output, the
    # largest error within 1e-2 of the largest |value| (one bf16 rounding is
    # at most 2^-7 of a value). Faults planted in the plain version must
    # land beyond it
    k2_bound = dict(atol=2e-2, rtol=1e-2)
    k2_scaled = 1e-2

    def scaled_err(got, want):
        return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()

    def planted_faults(q, k, v, want):
        """scaled_err of the plain version with a fault planted: the last
        key tile (64 keys) dropped; two 16-byte chunks of K's rows swapped
        in every other 4-row group (a panel read with the wrong swizzle);
        the output never rescaled when a later key tile raises the running
        max."""
        n = k.shape[2]
        last = (n - 1) // 64 * 64
        dropped = K.flash_attention_ref(q, k[:, :, :last], v[:, :, :last])
        ks = k.clone()
        rows = (torch.arange(n, device=dev) // 4) % 2 == 1
        ks[:, :, rows, 0:8], ks[:, :, rows, 8:16] = k[:, :, rows, 8:16], k[:, :, rows, 0:8]
        swizzled = K.flash_attention_ref(q, ks, v)
        del ks
        s = (q.float() @ k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
        s = F.pad(s, (0, -n % 64), value=float("-inf")).unflatten(-1, (-1, 64))
        run = s.amax(-1, keepdim=True).cummax(-2).values   # the running max after each tile
        den = torch.exp(s - run[..., -1:, :]).sum((-2, -1), keepdim=True)[..., 0]
        stale = ((torch.exp(s - run).flatten(-2)[..., :n].to(v.dtype).float() @ v.float())
                 / den).to(q.dtype)
        del s, run
        faults = {"last key tile dropped": scaled_err(dropped, want),
                  "chunks swizzled wrongly": scaled_err(swizzled, want),
                  "no rescale": scaled_err(stale, want)}
        print(f"  planted faults in the plain version, scaled error each (must exceed "
              f"{k2_scaled}): " + ", ".join(f"{k_} {v_:.3e}" for k_, v_ in faults.items()),
              flush=True)
        check(min(faults.values()) > k2_scaled, "a planted K2 fault falls within the bound")

    for label, (b, h, n, hd, dtype) in [
        ("1022px", (1, 24, 5330, 64, torch.bfloat16)),
        ("ragged-f32", (2, 4, 77, 64, torch.float32)),
    ]:
        qkv = randn(b, n, 3 * h * hd, dtype=dtype)
        d = h * hd
        q, k, v = (qkv[..., i * d:(i + 1) * d].view(b, n, h, hd).transpose(1, 2) for i in range(3))
        got = K.flash_attention(q, k, v)
        want = K.flash_attention_ref(q, k, v)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if dtype == torch.bfloat16:
            ok = scaled_err(got, want) <= k2_scaled
            bound_txt = (f"scaled {scaled_err(got, want):.3e} (bound: max error <= {k2_scaled} "
                         f"max|want|, max|want| {want.float().abs().max().item():.3e})")
        else:
            ok = torch.allclose(got.float(), want.float(), atol=2e-5, rtol=0)
            bound_txt = "(bound atol 2e-5 rtol 0)"
        print(f"K2 flash_attention {label} [{b},{h},{n},{hd}] {str(dtype)[6:]}: "
              f"max_abs_err {err:.3e} {bound_txt} {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"K2 {label} disagrees with its plain version")
        record("K2_flash_attention", err)
        if label == "1022px":
            planted_faults(q, k, v, want)
            record("K2_flash_attention", 0.0,
                   ms=time_ms(lambda: K.flash_attention(q, k, v)),
                   plain_ms=time_ms(lambda: K.flash_attention_ref(q, k, v), iters=3),
                   library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
                   shape=f"[{b},{h},{n},{hd}] bf16",
                   **bound({"bf16": 4 * b * h * n * n * hd}, 4 * b * h * n * hd * 2))
            achieved("K2_flash_attention", 4 * b * h * n * n * hd, "TFLOP/s")
            timing_line("K2_flash_attention", "[1,24,5330,64] bf16")

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
        record("K5_flash_attention_qkv_proj", err)
        if b == 32:
            m, d = b * n, 1536
            record("K5_flash_attention_qkv_proj", 0.0,
                   ms=time_ms(lambda: K.flash_attention_qkv_proj(qkv, w, **kw)),
                   plain_ms=time_ms(lambda: K.flash_attention_qkv_proj_ref(qkv, w, **kw), iters=3),
                   shape=f"qkv [{b},{n},4608] bf16",
                   **bound({"bf16": 4 * b * 24 * n * n * 64 + 2 * m * d * d},
                           m * 3 * d * 2 + d * d * 2 + 2 * m * d * 2 + 2 * d * 4))
            achieved("K5_flash_attention_qkv_proj", 4 * b * 24 * n * n * 64 + 2 * m * d * d,
                     "TFLOP/s")
            timing_line("K5_flash_attention_qkv_proj", "qkv [32,485,4608] bf16")

    # ---------------------------------------------------------------- F10: head dim 80
    # MAE-H / ImageBind-H width (D 1280, 16 heads of 80): K2 at the 1022-px
    # sequence (the scaled bound, planted faults beyond it) and K5 at the
    # 224-px batch at K5's bound, each against its plain version
    b, h, n, hd = 1, 16, 5330, 80
    qkv = randn(b, n, 3 * h * hd, dtype=torch.bfloat16)
    q, k, v = (qkv[..., i * h * hd:(i + 1) * h * hd].view(b, n, h, hd).transpose(1, 2)
               for i in range(3))
    got = K.flash_attention(q, k, v)
    want = K.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ok = scaled_err(got, want) <= k2_scaled
    line = dict(ms=time_ms(lambda: K.flash_attention(q, k, v)),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
                **bound({"bf16": 4 * b * h * n * n * hd}, 4 * b * h * n * hd * 2))
    print(f"F10 K2 flash_attention hd 80 [{b},{h},{n},{hd}] bf16 (qkv views): max_abs_err "
          f"{err:.3e}, scaled {scaled_err(got, want):.3e} (bound: max error <= {k2_scaled} "
          f"max|want|, max|want| {want.float().abs().max().item():.3e}) {'ok' if ok else 'FAIL'}; "
          f"time {tag}: kernel {line['ms']:.3f} ms, SDPA {line['library_ms']:.3f} ms; bound "
          f"{line['bound_ms']:.4f} ms ({line['bound_by']}), "
          f"{100 * line['bound_ms'] / line['ms']:.1f} % of the bound", flush=True)
    check(ok, "K2 at head dim 80 disagrees with its plain version")
    planted_faults(q, k, v, want)
    record("K2_flash_attention", err, hd80=dict(shape=f"[{b},{h},{n},{hd}] bf16", **line))
    del qkv, q, k, v, got, want
    b, n, d = 32, 257, 1280
    qkv = randn(b, n, 3 * d, dtype=torch.bfloat16)
    w = randn(d, d, dtype=torch.bfloat16, scale=d ** -0.5).t()
    kw = dict(b_proj=randn(d, scale=0.1), layerscale=randn(d, scale=0.5),
              residual=randn(b, n, d, dtype=torch.bfloat16), num_heads=16)
    got = K.flash_attention_qkv_proj(qkv, w, **kw)
    want = K.flash_attention_qkv_proj_ref(qkv, w, **kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), **k2_bound)
    m = b * n
    line = dict(ms=time_ms(lambda: K.flash_attention_qkv_proj(qkv, w, **kw)),
                **bound({"bf16": 4 * b * 16 * n * n * 80 + 2 * m * d * d},
                        m * 3 * d * 2 + d * d * 2 + 2 * m * d * 2 + 2 * d * 4))
    print(f"F10 K5 flash_attention_qkv_proj hd 80 qkv [{b},{n},{3 * d}] bf16 (16 heads): max_abs_err "
          f"{err:.3e} (bound atol 2e-2 rtol 1e-2) {'ok' if ok else 'FAIL'}; time {tag}: kernel "
          f"{line['ms']:.3f} ms; bound {line['bound_ms']:.4f} ms ({line['bound_by']}), "
          f"{100 * line['bound_ms'] / line['ms']:.1f} % of the bound", flush=True)
    check(ok, "K5 at head dim 80 disagrees with its plain version")
    record("K5_flash_attention_qkv_proj", err, hd80=dict(shape=f"qkv [{b},{n},{3 * d}] bf16", **line))
    del qkv, w, kw, got, want

    # ---------------------------------------------------------------- K1
    # the main path's three shapes (224-px and 308-px database batches, the
    # 1022-px query, whose tokens the kernel splits over clusters), each in
    # the three modes against the plain version, two launches bit-equal,
    # and timed (hard cosine, the main path's mode) beside the bound. Hard
    # labels are the argmax of f32 dots that the kernel and the plain
    # version sum in other orders, so a token whose top two scores lie
    # within their f32 rounding may take either label, and one such flip
    # can take a 308-px image past the bound. The hard modes are held to
    # the plain version after those near ties are explained
    # (hard_label_agreement: every other disagreement still fails)
    def facets(b, n, d=1536):
        x = randn(b, n, d)
        return x / x.norm(dim=-1, keepdim=True)

    def k1_compare(got, x, centers, vlad_mode, dist_mode):
        """min per-image cosine to the plain version (after near ties in
        hard modes), and the text that says how it was reached"""
        if vlad_mode == "soft":
            want = K.vlad_aggregate_fused_ref(x, centers, vlad_mode="soft")
            return F.cosine_similarity(got, want, dim=-1).min().item(), ""
        raw, cos_i, flips, ties = hard_label_agreement(got, x, centers, dist_mode=dist_mode)
        return cos_i.min().item(), (f" after {flips.sum().item()} label flip(s) on "
                                    f"{ties.sum().item()} near ties (before them "
                                    f"{raw.min().item():.7f})")

    min_cos_bound = 0.9999
    k1_modes = [("hard", "cosine"), ("hard", "euclidean"), ("soft", "cosine")]
    k1_shapes = {}
    for label, b, n in [("224px", 32, 256), ("308px", 32, 484), ("1022px", 1, 5329)]:
        x = facets(b, n)
        c, d = 32, 1536
        centers = x.reshape(-1, d)[torch.randperm(b * n, generator=gen, device=dev)[:c]]
        for vlad_mode, dist_mode in k1_modes:
            kw = dict(vlad_mode=vlad_mode, dist_mode=dist_mode)
            got = K.vlad_aggregate_fused(x, centers, **kw)
            want = K.vlad_aggregate_fused_ref(x, centers, **kw)
            again = K.vlad_aggregate_fused(x, centers, **kw)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            cos, how = k1_compare(got, x, centers, vlad_mode, dist_mode)
            same = torch.equal(got, again)
            ok = cos >= min_cos_bound and same and bool(torch.isfinite(got).all())
            print(f"K1 vlad_aggregate_fused {label} [{b},{n},{d}] C={c} {vlad_mode} {dist_mode}: "
                  f"max_abs_err {err:.3e}, min per-image cosine {cos:.7f}{how} (bound >= "
                  f"{min_cos_bound}); two launches {'bit-equal' if same else 'DIFFER'} (bound: "
                  f"bit-equal) {'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"K1 {label} {vlad_mode} {dist_mode} disagrees with its plain version "
                      f"or is not bit-equal across launches")
            record("K1_vlad_aggregate_fused", err)
        # hard assignment: the cosine products, then each token added to
        # one cluster's residual sum
        line = dict(ms=time_ms(lambda: K.vlad_aggregate_fused(x, centers)),
                    plain_ms=time_ms(lambda: K.vlad_aggregate_fused_ref(x, centers)),
                    shape=f"[{b},{n},{d}] C={c} hard, {K.vlad_aggregate_fused.last_plan.splits} "
                          f"token split(s)",
                    **bound({"f32": 2 * b * n * c * d + b * n * d}, (b * n * d + c * d + b * c * d) * 4))
        print(f"K1_vlad_aggregate_fused time {tag} at {line['shape']}: kernel {line['ms']:.4f} ms, "
              f"plain {line['plain_ms']:.3f} ms; bound {line['bound_ms']:.4f} ms ({line['bound_by']}), "
              f"{100 * line['bound_ms'] / line['ms']:.1f} % of the bound", flush=True)
        k1_shapes[label] = line
    record("K1_vlad_aggregate_fused", 0.0, **k1_shapes["308px"], other_shapes={
        label: line for label, line in k1_shapes.items() if label != "308px"})

    # how often near ties flip, and what a flip costs: 16 more draws of the
    # 308-px batch, then 2 with 16 tokens an image planted on exact ties
    for draws, planted in ((16, 0), (2, 16)):
        res = vlad_near_ties.run(draws, planted)
        ok = res["min_cos"] >= min_cos_bound and res["bit_equal"]
        print(f"{vlad_near_ties.summary(res)} (bound >= {min_cos_bound}, bit-equal) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, "K1 near-tie draws: a disagreement that no near tie explains, or launches differ")
    del x, centers, got, want, again

    # ---------------------------------------------------------------- K4
    # int8 codes are held in nn.Linear's [out, in] storage and passed as
    # .t() views, as the trunk does. An int8 code flips where the kernel's
    # online softmax rounds P (unnormalized) to bf16 at another point than
    # the plain version (normalized P): rms_rel over the output, and a small
    # share of flip-sized outliers (outside_share)
    def int8_weight(k, n):
        q, s = quantize_weight_cols(randn(k, n, scale=k ** -0.5))
        return q.t().contiguous().t(), s

    def k4_inputs(b, n, dtype, d=1536, h=24):
        wqkv, sqkv = int8_weight(d, 3 * d)
        wp, sp = int8_weight(d, d)
        args = (randn(b, n, d, dtype=dtype), wqkv, sqkv, randn(3 * d, scale=0.1), wp, sp,
                randn(d, scale=0.1))
        kw = dict(num_heads=h, ln_params=(1 + randn(d, scale=0.1), randn(d, scale=0.1)),
                  layerscale=randn(d, scale=0.5))
        return args, kw

    int8_tol = dict(atol=2e-2, rtol=1e-2)
    for label, b, n, dtype in [("224px", 8, 257, torch.bfloat16), ("308px", 32, 485, torch.bfloat16),
                               ("ragged-f32", 2, 77, torch.float32)]:
        args, kw = k4_inputs(b, n, dtype)
        hc = _pick_int8_head_chunk(n, 24, 64, None)
        got = K.fused_attn_half_int8(*args, **kw)
        want = K.fused_attn_half_int8_ref(*args, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rr = rms_rel(got, want)
        out = outside_share(got, want, **int8_tol)
        ok = out <= 1e-3 and rr <= 1e-2
        print(f"K4 fused_attn_half_int8 {label} B={b} N={n} D=1536 H=24 head chunk {hc} "
              f"{str(dtype)[6:]}: max_abs_err {err:.3e}, rms_rel {rr:.2e}, share beyond atol "
              f"2e-2 rtol 1e-2 {out:.2e} (bound: rms_rel <= 1e-2, share <= 1e-3) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"K4 {label} disagrees with its plain version")
        record("K4_fused_attn_half_int8", err)
        if b == 32:
            m, d = b * n, 1536
            record("K4_fused_attn_half_int8", 0.0,
                   ms=time_ms(lambda: K.fused_attn_half_int8(*args, **kw)),
                   plain_ms=time_ms(lambda: K.fused_attn_half_int8_ref(*args, **kw), iters=3),
                   shape=f"x [{b},{n},1536] bf16, head chunk {hc}",
                   **bound({"int8": 2 * m * d * 4 * d, "bf16": 4 * b * 24 * n * n * 64},
                           2 * m * d * 2 + 4 * d * d + 11 * d * 4))
            timing_line("K4_fused_attn_half_int8", "x [32,485,1536] bf16")

    # ---------------------------------------------------------------- K3
    def k3_inputs(m, d, hid, dtype, mlp_type):
        two = 2 if mlp_type == "swiglu_fused" else 1
        w12, s12 = int8_weight(d, two * hid)
        w3, s3 = int8_weight(hid, d)
        args = (randn(m, d, dtype=dtype), w12, s12, randn(two * hid, scale=0.1), w3, s3,
                randn(d, scale=0.1))
        kw = dict(mlp_type=mlp_type, ln_params=(1 + randn(d, scale=0.1), randn(d, scale=0.1)),
                  layerscale=randn(d, scale=0.5), residual=True)
        return args, kw

    for label, m, d, hid, dtype, mlp_type, tol, rr_max in [
        ("308px", 32 * 485, 1536, 4096, torch.bfloat16, "swiglu_fused", int8_tol, 1e-2),
        ("gelu-f32", 333, 256, 1024, torch.float32, "mlp", dict(atol=1e-3, rtol=1e-4), 1e-3),
    ]:
        args, kw = k3_inputs(m, d, hid, dtype, mlp_type)
        got = K.fused_mlp_int8(*args, **kw)
        want = K.fused_mlp_int8_ref(*args, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rr = rms_rel(got, want)
        out = outside_share(got, want, **tol)
        ok = out <= 1e-3 and rr <= rr_max
        print(f"K3 fused_mlp_int8 {label} M={m} D={d} HID={hid} {mlp_type} {str(dtype)[6:]}: "
              f"max_abs_err {err:.3e}, rms_rel {rr:.2e}, share beyond atol {tol['atol']} rtol "
              f"{tol['rtol']} {out:.2e} (bound: rms_rel <= {rr_max}, share <= 1e-3) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"K3 {label} disagrees with its plain version")
        record("K3_fused_mlp_int8", err)
        if label == "308px":
            record("K3_fused_mlp_int8", 0.0,
                   ms=time_ms(lambda: K.fused_mlp_int8(*args, **kw)),
                   plain_ms=time_ms(lambda: K.fused_mlp_int8_ref(*args, **kw), iters=3),
                   shape=f"x [{m},1536] bf16, SwiGLU 4096, hidden chunk 512",
                   **bound({"int8": 2 * m * d * 3 * hid}, 2 * m * d * 2 + 3 * hid * d + (2 * hid + 4 * d) * 4))
            achieved("K3_fused_mlp_int8", 2 * m * d * 3 * hid, "TOPS")
            timing_line("K3_fused_mlp_int8", "x [15520,1536] bf16")

    # ---------------------------------------------------------------- K9
    # the whole int8 block: K4's and K3's arithmetic with x2 kept in f32,
    # so K4's form of bound; the wired route is K4 then K3 (bf16 x2). The
    # output's bound cannot tell an f32 x2 from a bf16 one (flipped codes
    # move it more than x2's rounding does), so the kernel's x2 is held to
    # the plain version's f32 x2 at K4's bound and must not be bf16 values,
    # and for a bf16 x the output must sit clearly nearer the plain version
    # than the plain K4 -> K3 (x2 rounded to bf16). The share of elements
    # beyond atol/rtol falls as N grows (K4's attention error in x2 does):
    # the ragged case takes N 201, not 77, where the share reads ~1e-3
    def k9_inputs(b, n, dtype, d=1536, h=24, hid=4096):
        wqkv, sqkv = int8_weight(d, 3 * d)
        wp, sp = int8_weight(d, d)
        w12, s12 = int8_weight(d, 2 * hid)
        w3, s3 = int8_weight(hid, d)
        attn_p = (wqkv, sqkv, randn(3 * d, scale=0.1), wp, sp, randn(d, scale=0.1))
        mlp_p = (w12, s12, randn(2 * hid, scale=0.1), w3, s3, randn(d, scale=0.1))
        kw = dict(num_heads=h, ln1=(1 + randn(d, scale=0.1), randn(d, scale=0.1)),
                  ln2=(1 + randn(d, scale=0.1), randn(d, scale=0.1)),
                  gamma1=randn(d, scale=0.5), gamma2=randn(d, scale=0.5))
        return randn(b, n, d, dtype=dtype), attn_p, mlp_p, kw

    for label, b, n, dtype in [("224px", 32, 257, torch.bfloat16), ("308px", 32, 485, torch.bfloat16),
                               ("ragged-f32", 4, 201, torch.float32)]:
        x, attn_p, mlp_p, kw = k9_inputs(b, n, dtype)
        hc = _pick_int8_head_chunk(n, 24, 64, None)
        got, x2 = K.fused_block_int8(x, attn_p, mlp_p, return_x2=True, **kw)
        want, x2_want = K.fused_block_int8_ref(x, attn_p, mlp_p, return_x2=True, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rr = rms_rel(got, want)
        out = outside_share(got, want, **int8_tol)
        x2_rr = rms_rel(x2, x2_want)
        x2_out = outside_share(x2, x2_want, **int8_tol)
        x2_bf16 = (x2 == x2.to(torch.bfloat16).float()).float().mean().item()
        ok = out <= 1e-3 and rr <= 1e-2 and x2_out <= 1e-3 and x2_rr <= 1e-2 and x2_bf16 <= 1e-2
        vs_bf16_x2 = ""
        if dtype == torch.bfloat16:
            rr_b = rms_rel(got, K.fused_mlp_int8_ref(
                x2_want.to(dtype), *mlp_p, ln_params=kw["ln2"], layerscale=kw["gamma2"],
                residual=True))
            ok = ok and rr <= 0.9 * rr_b
            vs_bf16_x2 = (f"; out vs the plain K4 -> K3 (bf16 x2) rms_rel {rr_b:.2e}, "
                          f"ratio {rr / rr_b:.3f} (bound <= 0.9)")
        print(f"K9 fused_block_int8 {label} B={b} N={n} D=1536 H=24 head chunk {hc} SwiGLU 4096 "
              f"{str(dtype)[6:]}: max_abs_err {err:.3e}, rms_rel {rr:.2e}, share beyond atol "
              f"2e-2 rtol 1e-2 {out:.2e}; x2 rms_rel {x2_rr:.2e}, share {x2_out:.2e}, share of "
              f"bf16 values {x2_bf16:.2e} (bound: rms_rel <= 1e-2 and share <= 1e-3 for out and "
              f"x2, bf16 share <= 1e-2){vs_bf16_x2} {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"K9 {label} disagrees with its plain version")
        record("K9_fused_block_int8", err)
        if n == 485:
            m, d, hid = b * n, 1536, 4096

            def wired():
                h1 = K.fused_attn_half_int8(x, *attn_p, num_heads=24, ln_params=kw["ln1"],
                                            layerscale=kw["gamma1"])
                return K.fused_mlp_int8(h1, *mlp_p, ln_params=kw["ln2"], layerscale=kw["gamma2"],
                                        residual=True)

            record("K9_fused_block_int8", 0.0,
                   ms=time_ms(lambda: K.fused_block_int8(x, attn_p, mlp_p, **kw)),
                   plain_ms=time_ms(lambda: K.fused_block_int8_ref(x, attn_p, mlp_p, **kw), iters=3),
                   wired_ms=time_ms(wired),
                   shape=f"x [{b},{n},1536] bf16, SwiGLU 4096, head chunk {hc}, hidden chunk 512",
                   **bound({"int8": 2 * m * d * (4 * d + 3 * hid), "bf16": 4 * b * 24 * n * n * 64},
                           2 * m * d * 2 + (4 * d + 3 * hid) * d + (16 * d + 4 * hid) * 4))
            timing_line("K9_fused_block_int8", "x [32,485,1536] bf16")

    # ---------------------------------------------------------------- K7
    # bf16 attention half: the kernel rounds at the plain version's points
    # (its online softmax rounds the unnormalized P, as K5's does), so K5's
    # bound; the wired route is LN + the cuBLAS qkv product + K5
    def linear_weight(k, n, dtype):
        return randn(n, k, dtype=dtype, scale=k ** -0.5).t()   # JAX layout, Linear storage

    def k7_inputs(b, n, dtype, d=1536, h=24):
        args = (randn(b, n, d, dtype=dtype), linear_weight(d, 3 * d, dtype), randn(3 * d, scale=0.1),
                linear_weight(d, d, dtype), randn(d, scale=0.1))
        kw = dict(num_heads=h, ln_params=(1 + randn(d, scale=0.1), randn(d, scale=0.1)),
                  layerscale=randn(d, scale=0.5))
        return args, kw

    f32_tol = dict(atol=1e-4, rtol=1e-5)   # f32 FMA sums over K = 1536-4096 in another order
    for label, b, n, dtype, tol in [("224px", 32, 257, torch.bfloat16, k2_bound),
                                    ("ragged-f32", 2, 77, torch.float32, f32_tol)]:
        args, kw = k7_inputs(b, n, dtype)
        got = K.fused_attn_half_bf16(*args, **kw)
        want = K.fused_attn_half_bf16_ref(*args, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), **tol)
        print(f"K7 fused_attn_half_bf16 {label} B={b} N={n} D=1536 H=24 {str(dtype)[6:]}: "
              f"max_abs_err {err:.3e} (bound atol {tol['atol']} rtol {tol['rtol']}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"K7 {label} disagrees with its plain version")
        record("K7_fused_attn_half_bf16", err)
        if b == 32:
            m, d = b * n, 1536
            x, wqkv, bqkv, wp, bp = args
            bqkv16 = bqkv.to(torch.bfloat16)

            def wired():
                xn = ln_rows(x.float(), *kw["ln_params"], 1e-6).to(torch.bfloat16)
                return K.flash_attention_qkv_proj(xn @ wqkv + bqkv16, wp, bp, num_heads=24,
                                                  layerscale=kw["layerscale"], residual=x)

            record("K7_fused_attn_half_bf16", 0.0,
                   ms=time_ms(lambda: K.fused_attn_half_bf16(*args, **kw)),
                   plain_ms=time_ms(lambda: K.fused_attn_half_bf16_ref(*args, **kw), iters=3),
                   wired_ms=time_ms(wired),
                   shape=f"x [{b},{n},1536] bf16",
                   **bound({"bf16": 2 * m * d * 4 * d + 4 * b * 24 * n * n * 64},
                           2 * m * d * 2 + 4 * d * d * 2 + 7 * d * 4))
            achieved("K7_fused_attn_half_bf16", 2 * m * d * 4 * d + 4 * b * 24 * n * n * 64,
                     "TFLOP/s")
            timing_line("K7_fused_attn_half_bf16", "x [32,257,1536] bf16")

    # ---------------------------------------------------------------- K8
    # bf16 MLP half: the same rounding points as the plain version; the
    # wired route is the bf16 trunk's plain MLP half (LayerNorm, cuBLAS
    # w12, SiLU, cuBLAS w3, LayerScale and residual, each in bf16)
    def k8_inputs(m, d, hid, dtype, mlp_type):
        two = 2 if mlp_type == "swiglu_fused" else 1
        args = (randn(m, d, dtype=dtype), linear_weight(d, two * hid, dtype),
                randn(two * hid, scale=0.1), linear_weight(hid, d, dtype), randn(d, scale=0.1))
        kw = dict(mlp_type=mlp_type, ln_params=(1 + randn(d, scale=0.1), randn(d, scale=0.1)),
                  layerscale=randn(d, scale=0.5), residual=True)
        return args, kw

    for label, m, d, hid, dtype, mlp_type, tol in [
        ("224px", 32 * 257, 1536, 4096, torch.bfloat16, "swiglu_fused", k2_bound),
        ("gelu-f32", 333, 256, 1024, torch.float32, "mlp", f32_tol),
    ]:
        args, kw = k8_inputs(m, d, hid, dtype, mlp_type)
        got = K.fused_mlp_bf16(*args, **kw)
        want = K.fused_mlp_bf16_ref(*args, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), **tol)
        print(f"K8 fused_mlp_bf16 {label} M={m} D={d} HID={hid} {mlp_type} {str(dtype)[6:]}: "
              f"max_abs_err {err:.3e} (bound atol {tol['atol']} rtol {tol['rtol']}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"K8 {label} disagrees with its plain version")
        record("K8_fused_mlp_bf16", err)
        if label == "224px":
            x, w12, b12, w3, b3 = args
            lin12, lin3 = w12.t(), w3.t()
            b12h, b3h = b12.to(torch.bfloat16), b3.to(torch.bfloat16)
            lnw, lnb = (t.to(torch.bfloat16) for t in kw["ln_params"])
            g16 = kw["layerscale"].to(torch.bfloat16)

            def wired():
                h1, h2 = F.linear(F.layer_norm(x, (d,), lnw, lnb, 1e-6), lin12, b12h).chunk(2, dim=-1)
                return x + F.linear(F.silu(h1) * h2, lin3, b3h) * g16

            record("K8_fused_mlp_bf16", 0.0,
                   ms=time_ms(lambda: K.fused_mlp_bf16(*args, **kw)),
                   plain_ms=time_ms(lambda: K.fused_mlp_bf16_ref(*args, **kw), iters=3),
                   wired_ms=time_ms(wired),
                   shape=f"x [{m},1536] bf16, SwiGLU 4096",
                   **bound({"bf16": 2 * m * d * 3 * hid},
                           2 * m * d * 2 + 3 * hid * d * 2 + (2 * hid + 4 * d) * 4))
            achieved("K8_fused_mlp_bf16", 2 * m * d * 3 * hid, "TFLOP/s")
            timing_line("K8_fused_mlp_bf16", f"x [{m},1536] bf16")

    # ---------------------------------------------------------------- K6
    # attention + projection over head-split q/k/v: K5's rounding and
    # bound; the wired route is K2 then a cuBLAS projection
    for label, b, h, n, dtype, tol in [("224px", 32, 24, 257, torch.bfloat16, k2_bound),
                                       ("320px", 32, 24, 530, torch.bfloat16, k2_bound),
                                       ("ragged-f32", 2, 4, 77, torch.float32, f32_tol)]:
        d = h * 64
        q, k, v = (randn(b, h, n, 64, dtype=dtype) for _ in range(3))
        wp = linear_weight(d, 1536, dtype)
        got = K.attention_proj(q, k, v, wp)
        want = K.attention_proj_ref(q, k, v, wp)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), **tol)
        print(f"K6 attention_proj {label} [{b},{h},{n},64] -> 1536 {str(dtype)[6:]}: "
              f"max_abs_err {err:.3e} (bound atol {tol['atol']} rtol {tol['rtol']}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"K6 {label} disagrees with its plain version")
        record("K6_attention_proj", err)
        if b == 32:
            m = b * n
            line = dict(ms=time_ms(lambda: K.attention_proj(q, k, v, wp)),
                        plain_ms=time_ms(lambda: K.attention_proj_ref(q, k, v, wp), iters=3),
                        wired_ms=time_ms(lambda: bench_attn_proj.unfused(q, k, v, wp)),
                        shape=f"q/k/v [{b},{h},{n},64] bf16",
                        **bound({"bf16": 4 * b * h * n * n * 64 + 2 * m * d * 1536},
                                4 * m * d * 2 + d * 1536 * 2))
            if n == 257:   # the JSON line keeps the 224-px shape; 320 px is printed
                record("K6_attention_proj", 0.0, **line)
                achieved("K6_attention_proj", 4 * b * h * n * n * 64 + 2 * m * d * 1536, "TFLOP/s")
                timing_line("K6_attention_proj", f"q/k/v [{b},{h},{n},64] bf16")
            else:
                lib = f"wired route {line['wired_ms']:.3f} ms"
                print(f"K6_attention_proj time {tag} at q/k/v [{b},{h},{n},64] bf16: kernel "
                      f"{line['ms']:.3f} ms, plain {line['plain_ms']:.3f} ms, {lib}; bound "
                      f"{line['bound_ms']:.4f} ms ({line['bound_by']})", flush=True)

    # ---------------------------------------------------------------- T1, T2
    # the int8 micro-benchmark's products at its w12 shape (M 8704: 8224
    # rows padded to 512; K 1536, N 8192; the tool's bk 512) and a ragged
    # one (M 200, so the TPU tile is M itself; K 160, N 1000 against the
    # card's 128-wide tiles). T1 on int8 and T2 repeat their plain versions'
    # arithmetic (exact int32 sums, then the same f32 conversion and
    # products): T1 bit-exact, T2 within one bf16 ulp (at most 2^-7 of the
    # value). T1 on floats sums
    # exact products in f32 in another order than the plain version's full
    # f32 product
    def int8_operands(m, k, n):
        a = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        b = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8).t()
        return a, b

    lib_name, lib_mm = bench_int8_matmul.cublas_bf16()
    float_tol = {torch.bfloat16: dict(atol=2e-3, rtol=1e-4), torch.float32: dict(atol=1e-4, rtol=1e-5)}
    for label, m, k, n in [("w12", 8704, 1536, 8192), ("ragged", 200, 160, 1000)]:
        shape = f"[{m}x{k}]x[{k}x{n}]"
        a8, b8 = int8_operands(m, k, n)
        got = K.matmul(a8, b8, bk=512)
        want = K.matmul_ref(a8, b8, bk=512)
        torch.cuda.synchronize()
        exact = torch.equal(got, want)
        print(f"T1 matmul {label} {shape} int8 -> int32: {'bit-exact' if exact else 'DIFFERS'} "
              f"(bound: bit-exact) {'ok' if exact else 'FAIL'}", flush=True)
        check(exact, f"T1 int8 {label} is not bit-exact")
        record("T1_matmul", 0.0)
        for dtype in (torch.bfloat16, torch.float32) if label == "ragged" else (torch.bfloat16,):
            af, bf = randn(m, k, dtype=dtype), randn(n, k, dtype=dtype).t()
            gotf = K.matmul(af, bf, bk=512)
            wantf = K.matmul_ref(af, bf, bk=512)
            torch.cuda.synchronize()
            err = (gotf - wantf).abs().max().item()
            tol = float_tol[dtype]
            ok = torch.allclose(gotf, wantf, **tol)
            print(f"T1 matmul {label} {shape} {str(dtype)[6:]} -> float32: max_abs_err {err:.3e} "
                  f"(bound atol {tol['atol']} rtol {tol['rtol']}: f32 sums over K {k} in another "
                  f"order) {'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"T1 {label} {dtype} disagrees with its plain version")
            record("T1_matmul", err)
        sa = randn(m, 1).abs() * 0.01 + 1e-3
        sb = randn(1, n).abs() * 0.01 + 1e-3
        got2 = K.matmul_dequant(a8, b8, sa, sb, bk=512)
        want2 = K.matmul_dequant_ref(a8, b8, sa, sb, bk=512)
        torch.cuda.synchronize()
        diff = (got2.float() - want2.float()).abs()
        err2 = diff.max().item()
        ok = bool((diff <= 2.0 ** -7 * want2.float().abs()).all())
        print(f"T2 matmul_dequant {label} {shape} int8 -> bfloat16: max_abs_err {err2:.3e}, "
              f"{'bit-exact' if torch.equal(got2, want2) else 'not bit-exact'} (bound: one bf16 "
              f"ulp, |err| <= 2^-7 |want|) {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"T2 {label} disagrees with its plain version")
        record("T2_matmul_dequant", err2)
        if label == "w12":
            ops = {"int8": 2 * m * k * n}
            record("T1_matmul", 0.0,
                   ms=time_ms(lambda: K.matmul(a8, b8, bk=512)),
                   plain_ms=time_ms(lambda: K.matmul_ref(a8, b8, bk=512), iters=3),
                   library_ms=time_ms(lambda: torch._int_mm(a8, b8)),
                   shape=f"{shape} int8 -> int32, bk 512",
                   **bound(ops, m * k + k * n + 4 * m * n))
            timing_line("T1_matmul", f"{shape} int8 (library: torch._int_mm)")
            bf_line = dict(ms=time_ms(lambda: K.matmul(af, bf, bk=512)),
                           plain_ms=time_ms(lambda: K.matmul_ref(af, bf, bk=512), iters=3),
                           library_ms=time_ms(lambda: lib_mm(af, bf)),
                           **bound({"bf16": 2 * m * k * n}, 2 * (m * k + k * n) + 4 * m * n))
            print(f"T1_matmul time {tag} at {shape} bf16 -> float32: kernel {bf_line['ms']:.3f} ms, "
                  f"plain {bf_line['plain_ms']:.3f} ms, library {bf_line['library_ms']:.3f} ms "
                  f"({lib_name}); bound {bf_line['bound_ms']:.4f} ms ({bf_line['bound_by']}); "
                  f"{2 * m * k * n / (bf_line['ms'] * 1e-3) / 1e12:.1f} TFLOP/s, "
                  f"{100 * bf_line['bound_ms'] / bf_line['ms']:.1f} % of the bound", flush=True)
            sbn = sb.reshape(n)
            record("T2_matmul_dequant", 0.0,
                   ms=time_ms(lambda: K.matmul_dequant(a8, b8, sa, sb, bk=512)),
                   plain_ms=time_ms(lambda: K.matmul_dequant_ref(a8, b8, sa, sb, bk=512), iters=3),
                   wired_ms=time_ms(lambda: int8_matmul(a8, b8, sa, sbn)),
                   shape=f"{shape} int8 -> bf16, bk 512",
                   **bound(ops, m * k + k * n + 4 * (m + n) + 2 * m * n))
            achieved("T2_matmul_dequant", ops["int8"], "TOPS")
            timing_line("T2_matmul_dequant", f"{shape} int8 -> bf16 (wired: ops/quant.int8_matmul)")

    # T1's sums past 2^24, the reason for its int32 epilogue: at the tool's
    # w3 shape, codes of magnitude 100..127 with one sign per row of a and
    # per column of b, so every sum passes 2^24 and most are no f32 value
    # (4 apart there): a product folded through f32 would round them; the
    # tool's tiles there (bn 768, the largest that divides 1536 up to 1024)
    m, k, n = 8704, 4096, 1536
    tiles = dict(bk=512, bn=768)
    shape = f"[{m}x{k}]x[{k}x{n}]"

    def signs(*size):
        return torch.randint(0, 2, size, generator=gen, device=dev) * 2 - 1

    def big_codes(rows, cols):
        codes = torch.randint(100, 128, (rows, cols), generator=gen, device=dev)
        return (codes * signs(rows, 1)).to(torch.int8)

    a8, b8 = big_codes(m, k), big_codes(n, k).t()
    exact = K.matmul_ref(a8, b8, **tiles).double()
    past = exact.abs().min().item() > 2 ** 24
    no_f32 = (exact.float().double() != exact).double().mean().item()
    same = [torch.equal(K.matmul(a8, b8, out_dtype=od, **tiles),
                        K.matmul_ref(a8, b8, out_dtype=od, **tiles))
            for od in (None, torch.float32, torch.bfloat16)]
    ok = all(same) and past and no_f32 > 0.5
    print(f"T1 matmul w3 sums past 2^24 {shape} int8 -> int32 / float32 / bfloat16: "
          f"{'/'.join('bit-exact' if e else 'DIFFERS' for e in same)}; min |sum| "
          f"{exact.abs().min().item():.4g}, share of sums that are no f32 value {no_f32:.3f} "
          f"(bound: bit-exact, min |sum| > 2^24, share > 0.5) {'ok' if ok else 'FAIL'}", flush=True)
    check(ok, "T1 int8 is not bit-exact past 2^24")
    record("T1_matmul", 0.0)
    del a8, b8, exact

    # ---------------------------------------------------------------- T3
    # K4 with zero biases and the tool's two knobs, K4's bound; its base
    # must be bit-equal to the K4 kernel on the same inputs with no biases
    # (the two share K4's stages, csrc/attn_half_int8.cuh). batched_dots
    # only keeps the heads' outputs o in f32, which moves the output by
    # less than the bound: so o itself is held to the plain version's o and
    # must not be bf16 values, and the output must sit far nearer the
    # stages after the attention applied to the kernel's own o than to them
    # applied to that o rounded to bf16
    def t3_inputs(b, n, dtype, d=1536):
        np_pad = round_up(n, 8)
        wqkv, sqkv = int8_weight(d, 3 * d)
        wp, sp = int8_weight(d, d)
        xq_in = torch.randint(-127, 128, (b, np_pad, d), generator=gen, device=dev, dtype=torch.int8)
        xs_in = randn(b, np_pad, 1).abs() * 0.01 + 1e-3
        ln = (1 + randn(1, d, scale=0.1), randn(1, d, scale=0.1))
        return (randn(b, n, d, dtype=dtype), xq_in, xs_in, wqkv, sqkv, wp, sp, ln,
                randn(1, d, scale=0.5))

    t3_modes = {"base": (False, False), "pre_quant": (True, False), "batched_dots": (False, True)}
    for label, b, n, dtype in [("224px", 32, 257, torch.bfloat16), ("308px", 32, 485, torch.bfloat16),
                               ("ragged-f32", 2, 77, torch.float32)]:
        args = t3_inputs(b, n, dtype)
        hc = _pick_int8_head_chunk(n, 24, 64, None)
        for mode, (pre_quant, batched_dots) in t3_modes.items():
            kw = dict(pre_quant=pre_quant, batched_dots=batched_dots)
            got, o = K.attn_half_variant(*args, return_o=True, **kw)
            want, o_want = K.attn_half_variant_ref(*args, return_o=True, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            rr = rms_rel(got, want)
            out = outside_share(got, want, **int8_tol)
            o_rr = rms_rel(o, o_want)
            o_out = outside_share(o, o_want, **int8_tol)
            o_bf16 = (o == o.to(torch.bfloat16).float()).float().mean().item()
            ok = (out <= 1e-3 and rr <= 1e-2 and o_out <= 1e-3 and o_rr <= 1e-2
                  and (o_bf16 <= 1e-2 if batched_dots else o_bf16 == 1.0))
            own = ""
            if batched_dots:
                x, wp, sp, gamma = args[0], args[5], args[6], args[8]
                rr_own = rms_rel(got, K.attn_half_variant_proj_ref(x, o, wp, sp, gamma))
                rr_rnd = rms_rel(got, K.attn_half_variant_proj_ref(
                    x, o.to(torch.bfloat16).float(), wp, sp, gamma))
                ok = ok and rr_own <= 0.5 * rr_rnd
                own = (f"; out vs the stages after the attention on its own o rms_rel {rr_own:.2e}, "
                       f"on that o in bf16 {rr_rnd:.2e}, ratio {rr_own / rr_rnd:.3f} (bound <= 0.5)")
            print(f"T3 attn_half_variant {mode} {label} B={b} N={n} D=1536 H=24 head chunk {hc} "
                  f"{str(dtype)[6:]}: max_abs_err {err:.3e}, rms_rel {rr:.2e}, share beyond atol "
                  f"2e-2 rtol 1e-2 {out:.2e}; o rms_rel {o_rr:.2e}, share {o_out:.2e}, share of "
                  f"bf16 values {o_bf16:.2e} (bound: rms_rel <= 1e-2 and share <= 1e-3 for out and "
                  f"o; o's bf16 share {'<= 1e-2' if batched_dots else '= 1'}){own} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"T3 {mode} {label} disagrees with its plain version")
            record("T3_attn_half_variant", err)
        x, _, _, wqkv, sqkv, wp, sp, ln, gamma = args

        def k4():
            return K.fused_attn_half_int8(x, wqkv, sqkv, None, wp, sp, None, num_heads=24,
                                          ln_params=(ln[0].ravel(), ln[1].ravel()),
                                          layerscale=gamma.ravel())

        same = torch.equal(K.attn_half_variant(*args, pre_quant=False, batched_dots=False), k4())
        print(f"T3 base {label} vs K4 (no biases) on the same inputs: "
              f"{'bit-equal' if same else 'DIFFERS'} (bound: bit-equal) {'ok' if same else 'FAIL'}",
              flush=True)
        check(same, f"T3 base {label} is not bit-equal to K4")
        if n == 485:
            m, d = b * n, 1536
            record("T3_attn_half_variant", 0.0,
                   ms=time_ms(lambda: K.attn_half_variant(*args, pre_quant=False, batched_dots=False)),
                   plain_ms=time_ms(lambda: K.attn_half_variant_ref(
                       *args, pre_quant=False, batched_dots=False), iters=3),
                   wired_ms=time_ms(k4),
                   shape=f"x [{b},{n},1536] bf16, base, head chunk {hc}",
                   **bound({"int8": 2 * m * d * 4 * d, "bf16": 4 * b * 24 * n * n * 64},
                           2 * m * d * 2 + 4 * d * d + 7 * d * 4))
            timing_line("T3_attn_half_variant", "x [32,485,1536] bf16, base (wired: K4)")

    # ---------------------------------------------------------------- F10: the block kernels at head dim 80
    # K4, K6, K7, K9 and T3 at the 224-px batch of a ViT-H trunk (D 1280, 16
    # heads of 80; the int8 head chunk is 8 or 16 heads, so the projection's
    # K groups are 640 or 1280 wide), each against its plain version within
    # its hd-64 bound above, timed beside the bound
    b, n, d, h, hd = 32, 257, 1280, 16, 80
    hc = _pick_int8_head_chunk(n, h, hd, None)
    x = randn(b, n, d, dtype=torch.bfloat16)
    qkv = randn(b, n, 3 * d, dtype=torch.bfloat16)
    q, k, v = (qkv[..., i * d:(i + 1) * d].view(b, n, h, hd).transpose(1, 2) for i in range(3))
    m = b * n
    attn_ops = 4 * b * h * n * n * hd
    a4, kw4 = k4_inputs(b, n, torch.bfloat16, d=d, h=h)
    a7, kw7 = k7_inputs(b, n, torch.bfloat16, d=d, h=h)
    x9, attn9, mlp9, kw9 = k9_inputs(b, n, torch.bfloat16, d=d, h=h)   # SwiGLU 4096
    a3 = t3_inputs(b, n, torch.bfloat16, d=d)
    wp6 = linear_weight(d, d, torch.bfloat16)
    cases = {
        "K4_fused_attn_half_int8": (
            lambda: K.fused_attn_half_int8(*a4, **kw4), lambda: K.fused_attn_half_int8_ref(*a4, **kw4),
            "int8", {"int8": 2 * m * d * 4 * d, "bf16": attn_ops}, 2 * m * d * 2 + 4 * d * d),
        "K6_attention_proj": (
            lambda: K.attention_proj(q, k, v, wp6), lambda: K.attention_proj_ref(q, k, v, wp6),
            "bf16", {"bf16": attn_ops + 2 * m * d * d}, 4 * m * d * 2 + 2 * d * d),
        "K7_fused_attn_half_bf16": (
            lambda: K.fused_attn_half_bf16(*a7, **kw7), lambda: K.fused_attn_half_bf16_ref(*a7, **kw7),
            "bf16", {"bf16": attn_ops + 2 * m * d * 4 * d}, 2 * m * d * 2 + 8 * d * d),
        "K9_fused_block_int8": (
            lambda: K.fused_block_int8(x9, attn9, mlp9, **kw9),
            lambda: K.fused_block_int8_ref(x9, attn9, mlp9, **kw9),
            "int8", {"int8": 2 * m * d * 4 * d + 2 * m * d * 3 * 4096, "bf16": attn_ops},
            2 * m * d * 2 + 4 * d * d + 3 * 4096 * d),
        "T3_attn_half_variant": (
            lambda: K.attn_half_variant(*a3, pre_quant=False, batched_dots=False, head_dim=hd),
            lambda: K.attn_half_variant_ref(*a3, pre_quant=False, batched_dots=False, head_dim=hd),
            "int8", {"int8": 2 * m * d * 4 * d, "bf16": attn_ops}, 2 * m * d * 2 + 4 * d * d),
    }
    for name, (fn, ref, kind, ops, nbytes) in cases.items():
        got, want = fn(), ref()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if kind == "bf16":
            ok = torch.allclose(got.float(), want.float(), **k2_bound)
            bound_txt = "bound atol 2e-2 rtol 1e-2"
        else:
            rr, out = rms_rel(got, want), outside_share(got, want, **int8_tol)
            ok = rr <= 1e-2 and out <= 1e-3
            bound_txt = (f"rms_rel {rr:.2e}, share beyond atol 2e-2 rtol 1e-2 {out:.2e}; bound: "
                         f"rms_rel <= 1e-2, share <= 1e-3")
        chunk = f", head chunk {hc}" if kind == "int8" else ""
        line = dict(ms=time_ms(fn), shape=f"x [{b},{n},{d}] bf16, 16 heads of 80{chunk}",
                    **bound(ops, nbytes))
        print(f"F10 {name} hd 80 x [{b},{n},{d}] bf16 (16 heads{chunk}): max_abs_err "
              f"{err:.3e} ({bound_txt}) {'ok' if ok else 'FAIL'}; time {tag}: kernel "
              f"{line['ms']:.3f} ms; bound {line['bound_ms']:.4f} ms ({line['bound_by']}), "
              f"{100 * line['bound_ms'] / line['ms']:.1f} % of the bound", flush=True)
        check(ok, f"{name} at head dim 80 disagrees with its plain version")
        record(name, err, hd80=line)
    del x, qkv, q, k, v, a4, a7, x9, attn9, mlp9, a3, cases

    # ---------------------------------------------------------------- small-input reference checks
    # the card's path (kernels) against the plain path (CPU) on small
    # float32 trunks: d=128, 2 heads of 64, 2 blocks; 224 px -> K5 (bf16
    # path) or K4 + K3 (int8_full, SwiGLU 1024 in two 512 chunks); 504 px -> K2
    for quant, mlp_type, ratio in [(None, "mlp", 4.0), ("int8_full", "swiglu_fused", 12.0)]:
        cfg = ViTConfig(img_size=56, embed_dim=128, depth=2, num_heads=2, mlp_type=mlp_type,
                        mlp_ratio=ratio, dtype=torch.float32, quant=quant)
        small = ViTFacetExtractor(cfg, None, 1, "token", device="cpu", seed=3)
        # LayerScale 0.5 instead of 1e-5, so the attention halves matter
        small_sd = {k: (torch.full_like(v, 0.5) if k.endswith("gamma") else v)
                    for k, v in small.model.state_dict().items()}
        cpu_ext = ViTFacetExtractor(cfg, small_sd, 1, "token", device="cpu")
        gpu_ext = ViTFacetExtractor(cfg, small_sd, 1, "token", device=dev)
        cpu_centers = None
        for px in (224, 504):
            imgs = np.random.default_rng(px).standard_normal((2, px, px, 3)).astype(np.float32)
            want = cpu_ext(imgs)
            got = gpu_ext(imgs).cpu()
            err = (got - want).abs().max().item()
            fcos = F.cosine_similarity(got, want, dim=-1).min().item()
            if cpu_centers is None:
                cpu_centers = want.reshape(-1, 128)[::37][:8].clone()
            v_want = VLAD(8)
            v_want.c_centers = cpu_centers
            vw = v_want.aggregate(want)
            vg = v_want.aggregate(gpu_ext(imgs)).cpu()
            vcos = F.cosine_similarity(vg, vw, dim=-1).min().item()
            if quant is None:
                print(f"small-input check bf16 path (f32 trunk) {px} px: facet max_abs_err card vs "
                      f"CPU {err:.3e} (bound 1e-4), VLAD min cosine {vcos:.7f} (bound >= 0.9999)",
                      flush=True)
                check(err <= 1e-4 and vcos >= 0.9999, f"card and plain path disagree at {px} px")
            else:
                # int8 codes flip where f32 sums of another order cross a
                # rounding midpoint: cosine bounds, not elementwise ones
                print(f"small-input check int8_full (f32 trunk) {px} px: facet max_abs_err card vs "
                      f"CPU {err:.3e}, min facet cosine {fcos:.7f} (bound >= 0.999), VLAD min "
                      f"cosine {vcos:.7f} (bound >= 0.999)", flush=True)
                check(fcos >= 0.999 and vcos >= 0.999,
                      f"int8_full card and plain path disagree at {px} px")

    # ---------------------------------------------------------------- the bf16 path
    db = listdir_abs(str(FIXTURE), "db")
    qu = listdir_abs(str(FIXTURE), "queries")
    gt = list(np.load(FIXTURE / "gt.npy", allow_pickle=True))
    ds = VPRDataset(db, qu, soft_positives_per_query=gt, img_size=(320, 320))
    big = Image.open(db[0]).convert("RGB").resize((1536, 1536), Image.BILINEAR)
    arr1022 = preprocess_image(big, max_edge=1024)
    check(arr1022.shape == (1022, 1022, 3), f"1022-px input shape {arr1022.shape}")

    def drive(path, engine):
        """One pass of a path: vocabulary, VLADs of the fixture at 308 px,
        retrieval, one image at 1022 px; counts reset just before, read
        just after."""
        ext = engine.extractor
        K.reset_launch_counts()
        t0 = time.perf_counter()
        vocab = engine.extract_dataset(ds, "db", verbose=False, keep_on_device=True)
        check(tuple(vocab.shape) == (16, 484, 1536), f"vocab facets shape {tuple(vocab.shape)}")
        vlad = VLAD(32)
        vlad.fit(vocab.reshape(-1, vocab.shape[-1]))
        dbv = engine.extract_vlads_dataset(ds, vlad, "db", verbose=False)
        quv = engine.extract_vlads_dataset(ds, vlad, "queries", verbose=False)
        dists, idx, recalls = get_top_k_recall([1, 5, 10], dbv, quv, gt)   # on the card (F11)
        e2e_s = time.perf_counter() - t0
        check(dbv.shape == (16, 32 * 1536) and quv.shape == (8, 32 * 1536),
              f"VLAD shapes {dbv.shape} {quv.shape}")
        allv = np.concatenate([dbv, quv])
        norms = np.linalg.norm(allv, axis=1)
        check(bool(np.isfinite(allv).all()), f"{path}: non-finite VLAD values")
        check(bool(np.all(np.abs(norms - 1) <= 1e-3)), f"{path}: VLAD norms {norms.min()}..{norms.max()}")
        check(idx.shape == (8, 10) and bool(np.isfinite(dists).all()), f"{path}: retrieval output")
        print(f"e2e {path} 308 px: 24 images (fixture), vocabulary k-means on "
              f"{vocab.shape[0] * vocab.shape[1]} facets, {e2e_s:.1f} s; VLAD norms "
              f"{norms.min():.6f}..{norms.max():.6f}; recall (random weights, not asserted) "
              f"{recalls}", flush=True)
        f1022 = ext(arr1022[None])
        v1022 = vlad.aggregate(f1022)
        torch.cuda.synchronize()
        check(tuple(f1022.shape) == (1, 5329, 1536), f"1022-px facets {tuple(f1022.shape)}")
        check(bool(torch.isfinite(v1022).all()) and abs(v1022.norm().item() - 1) <= 1e-3,
              f"{path}: 1022-px VLAD not finite or not unit-norm")
        counts = K.launch_counts()
        print(f"e2e {path} 1022 px: facets {tuple(f1022.shape)}, VLAD {tuple(v1022.shape)}; "
              f"launch counts over the {path} path {counts}", flush=True)
        for name in PATH_KERNELS[path]:
            check(counts[name] > 0, f"{name} never launched on the {path} path")
        return vlad, counts

    t0 = time.perf_counter()
    ext = DinoV2ExtractFeatures("dinov2_vitg14", 31, "value", device=dev, seed=42)
    torch.cuda.synchronize()
    print(f"model: dinov2_vitg14 bf16, {len(ext.model.blocks)} blocks materialized, "
          f"{sum(p.numel() for p in ext.model.parameters()) / 1e9:.3f} B params, "
          f"random init {time.perf_counter() - t0:.1f} s", flush=True)
    check(len(ext.model.blocks) == 32, "blocks 0..31 must be materialized")
    vlad, counts = drive("bf16", DescriptorEngine(extractor=ext, batch_size=16))
    for name in PATH_KERNELS["bf16"]:
        results[name]["launches"] = counts[name]

    # the same small input through the kernels and through the plain
    # versions, on the card, at full width (G, 2 images at 224 px)
    imgs224 = torch.from_numpy(np.stack([preprocess_image(Image.open(p).convert("RGB"), (224, 224))
                                         for p in db[:2]])).to(dev)
    plain = {"flash_attention_qkv_proj": K.flash_attention_qkv_proj_ref,
             "flash_attention": K.flash_attention_ref,
             "fused_attn_half_int8": K.fused_attn_half_int8_ref,
             "fused_mlp_int8": K.fused_mlp_int8_ref}

    def through_plain(extractor, imgs):
        saved = {name: getattr(vit_module, name) for name in plain}
        for name, fn in plain.items():
            setattr(vit_module, name, fn)
        try:
            return extractor(imgs)
        finally:
            for name, fn in saved.items():
                setattr(vit_module, name, fn)

    got_f = ext(imgs224)
    want_f = through_plain(ext, imgs224)
    fcos = F.cosine_similarity(got_f, want_f, dim=-1).min().item()
    vcos = F.cosine_similarity(
        vlad.aggregate(got_f), K.vlad_aggregate_fused_ref(want_f, vlad.c_centers.to(dev)), dim=-1).min().item()
    print(f"G bf16 224 px, kernels vs plain versions on the card: min facet cosine {fcos:.6f} "
          f"(bound >= 0.999), min VLAD cosine {vcos:.6f} (bound >= 0.99)", flush=True)
    check(fcos >= 0.999 and vcos >= 0.99, "bf16 path disagrees with its plain version")

    # ---------------------------------------------------------------- the int8_full path
    t0 = time.perf_counter()
    engine8 = DescriptorEngine("dinov2_vitg14", 31, "value", batch_size=16, quant="int8_full",
                               transfer_dtype="uint8")   # no device named: the card
    ext8 = engine8.extractor
    torch.cuda.synchronize()
    check(ext8.device.type == "cuda", f"int8_full extractor on {ext8.device}")
    n_int8 = sum(t.numel() for n_, t in ext8.model.state_dict().items() if n_.endswith("weight_q"))
    print(f"model: dinov2_vitg14 int8_full, {len(ext8.model.blocks)} blocks, {n_int8 / 1e9:.3f} B "
          f"int8 weights, random init + quantize on the card {time.perf_counter() - t0:.1f} s",
          flush=True)
    vlad8, counts8 = drive("int8_full", engine8)
    for name in ("K3_fused_mlp_int8", "K4_fused_attn_half_int8"):
        results[name]["launches"] = counts8[name]

    got8 = ext8(imgs224)
    want8 = through_plain(ext8, imgs224)
    fcos8 = F.cosine_similarity(got8, want8, dim=-1).min().item()
    vcos8 = F.cosine_similarity(
        vlad8.aggregate(got8), K.vlad_aggregate_fused_ref(want8, vlad8.c_centers.to(dev)),
        dim=-1).min().item()
    qcos = F.cosine_similarity(got8, got_f, dim=-1)
    print(f"G int8_full 224 px, kernels vs plain versions on the card: min facet cosine "
          f"{fcos8:.6f} (bound >= 0.99), min VLAD cosine {vcos8:.6f}; int8_full vs the bf16 trunk "
          f"on the same weights: facet cosine min {qcos.min().item():.6f} mean "
          f"{qcos.mean().item():.6f} (not asserted)", flush=True)
    check(fcos8 >= 0.99, "int8_full path disagrees with its plain version")

    # ---------------------------------------------------------------- block variants
    # Block 0 of each G trunk with LayerScale 0.5 (from 1e-5, so that both
    # residual branches matter), restored afterwards.
    @contextlib.contextmanager
    def layerscale(blk):
        gammas = (blk.ls1.gamma, blk.ls2.gamma)
        saved = [g.detach().clone() for g in gammas]
        with torch.no_grad():
            for g in gammas:
                g.copy_(randn(g.shape[0], scale=0.5))
        try:
            yield blk
        finally:
            with torch.no_grad():
                for g, s in zip(gammas, saved):
                    g.copy_(s)

    def k7_k8(blk, x):
        """A bf16 trunk block as K7 then K8, on the block's own parameters."""
        a, mlp = blk.attn, blk.mlp
        x = K.fused_attn_half_bf16(
            x, a.qkv.weight.t(), a.qkv.bias, a.proj.weight.t(), a.proj.bias, num_heads=24,
            ln_params=(blk.norm1.weight, blk.norm1.bias), layerscale=blk.ls1.gamma)
        return K.fused_mlp_bf16(
            x, mlp.w12.weight.t(), mlp.w12.bias, mlp.w3.weight.t(), mlp.w3.bias,
            ln_params=(blk.norm2.weight, blk.norm2.bias), layerscale=blk.ls2.gamma,
            residual=True)

    for n in (257, 485):   # head chunks 12 and 6
        xg = randn(32, n, 1536, dtype=torch.bfloat16)
        with layerscale(ext8.model.blocks[0]) as blk:
            a, m_ = blk.attn, blk.mlp
            got = K.fused_block_int8(
                xg, (a.qkv.weight_q.t(), a.qkv.weight_scale, a.qkv.bias, a.proj.weight_q.t(),
                     a.proj.weight_scale, a.proj.bias),
                (m_.w12.weight_q.t(), m_.w12.weight_scale, m_.w12.bias, m_.w3.weight_q.t(),
                 m_.w3.weight_scale, m_.w3.bias),
                num_heads=24, ln1=(blk.norm1.weight, blk.norm1.bias),
                ln2=(blk.norm2.weight, blk.norm2.bias), gamma1=blk.ls1.gamma,
                gamma2=blk.ls2.gamma)
            want = blk(xg)
        torch.cuda.synchronize()
        rr9 = rms_rel(got, want)
        br9 = rms_rel(got.float() - xg.float(), want.float() - xg.float())
        print(f"G int8_full block 0, K9 vs the trunk's K4 -> K3 on x [32,{n},1536] bf16, head "
              f"chunk {_pick_int8_head_chunk(n, 24, 64, None)} (LayerScale 0.5): rms_rel "
              f"{rr9:.2e} (bound <= 1e-2; x2 in f32 against bf16 is the only difference), "
              f"residual branches rms_rel {br9:.2e} (not asserted)", flush=True)
        check(rr9 <= 1e-2, f"K9 disagrees with the int8_full trunk's block at N={n}")

    xg = randn(32, 257, 1536, dtype=torch.bfloat16)
    with layerscale(ext.model.blocks[0]) as blk:
        got = k7_k8(blk, xg)
        want = blk(xg)
    torch.cuda.synchronize()
    rr78 = rms_rel(got, want)
    br78 = rms_rel(got.float() - xg.float(), want.float() - xg.float())
    print(f"G bf16 block 0, K7 -> K8 vs the trunk's block (LN + cuBLAS + K5, LN + cuBLAS MLP) on "
          f"x [32,257,1536] bf16 (LayerScale 0.5): rms_rel {rr78:.2e} (bound <= 2e-2: the trunk "
          f"rounds its biases, MLP activations and LayerScale products to bf16, the kernels "
          f"keep f32), residual branches rms_rel {br78:.2e} (not asserted)", flush=True)
    check(rr78 <= 2e-2, "K7 -> K8 disagrees with the bf16 trunk's block")

    K.reset_launch_counts()
    fb = bench_fused_block.run(layers=4)
    for n, r in fb["shapes"].items():
        print(f"tool bench_fused_block [{fb['card']}] N={n}, 4-block stack: two-kernel "
              f"{r['two_kernel_ms']:.3f} ms/block | merged {r['merged_ms']:.3f} ms/block "
              f"({r['speedup']:.3f}x)", flush=True)
    ah = bench_attn_half_bf16.run(iters=10)
    print(f"tool bench_attn_half_bf16 [{ah['card']}] B=32 N=257, 10 layers: split (LN + cuBLAS "
          f"qkv -> K5) {ah['split_ms']:.3f} ms/layer | fused (K7) {ah['fused_ms']:.3f} ms/layer; "
          f"outputs max {ah['split_max']:.4f} vs {ah['fused_max']:.4f}", flush=True)
    ap_ = bench_attn_proj.run(iters=5)
    for n, r in ap_["shapes"].items():
        print(f"tool bench_attn_proj [{ap_['card']}] N={n}: unfused (K2 + cuBLAS) "
              f"{r['unfused_ms']:.3f} ms | fused (K6) {r['fused_ms']:.3f} ms", flush=True)
    # K8 has no tool of its own (the JAX package drives it from its TPU-lane
    # test as K7 then K8): a 4-block stack of K7 -> K8 on bf16 block 0
    xv = randn(32, 257, 1536, dtype=torch.bfloat16)
    with layerscale(ext.model.blocks[0]) as blk:
        for _ in range(4):
            xv = k7_k8(blk, xv)
    torch.cuda.synchronize()
    counts_v = K.launch_counts()
    check(bool(torch.isfinite(xv).all()), "K7 -> K8 stack: non-finite output")
    check(all(r["two_kernel_ms"] > 0 and r["merged_ms"] > 0 for r in fb["shapes"].values()),
          "bench_fused_block gave no time")
    print(f"block variants: launch counts over the tools' run and the K7 -> K8 stack {counts_v}",
          flush=True)
    for name in PATH_KERNELS["variants"]:
        check(counts_v[name] > 0, f"{name} never launched in the block-variant run")
        results[name]["launches"] = counts_v[name]

    # ---------------------------------------------------------------- the T1-T3 tools
    K.reset_launch_counts()
    mm = bench_int8_matmul.run(iters=3)
    for name, r in mm["shapes"].items():
        paths = ", ".join(f"{label} {r[key + '_ms']:.3f} ms ({r[key + '_tops']:.1f} "
                          f"{'TOPS' if key.startswith('int8') else 'TFLOP/s'})"
                          for key, label in bench_int8_matmul.PATHS)
        print(f"tool bench_int8_matmul [{mm['card']}] {name} [{mm['m']}x{r['k']}]x[{r['k']}x"
              f"{r['n']}] (bk 512, bn {r['bn']}): {paths}; bf16 cuBLAS is {mm['cublas_bf16']}",
              flush=True)
        check(all(r[key + "_ms"] > 0 for key, _ in bench_int8_matmul.PATHS),
              "bench_int8_matmul gave no time")
    xl = bench_xlayer.run(iters=5)
    for n, r in xl["shapes"].items():
        print(f"tool bench_xlayer [{xl['card']}] B=32 N={n}: production (K4) "
              f"{r['production_ms']:.3f}, variant base {r['base_ms']:.3f}, A prologue stub "
              f"{r['stub_ms']:.3f}, B batched dots {r['batched_ms']:.3f} ms/layer; lever (a) "
              f"{r['lever_a_ms']:+.3f} ms, lever (c) {r['lever_c_ms']:+.3f} ms", flush=True)
    counts_t = K.launch_counts()
    print(f"tools: launch counts over the T1-T3 tools' run {counts_t}", flush=True)
    for name in PATH_KERNELS["tools"]:
        check(counts_t[name] > 0, f"{name} never launched in the tools' run")
        results[name]["launches"] = counts_t[name]

    # ---------------------------------------------------------------- the entry point
    with tempfile.TemporaryDirectory(prefix="anyloc_smoke_") as work:
        work = Path(work)
        root = work / "datasets"
        write_vpr_bench(root / "17places", db, qu, gt)
        synthetic.build_gardens(str(root), size=(480, 640))
        for label, cmd, extra, path in (
                ("gvv_bf16", "global-vocab-vlad", [], "entry bf16"),
                ("gvv_int8_full", "global-vocab-vlad",
                 ["--extractor.quant", "int8_full", "--extractor.transfer-dtype", "uint8"],
                 "entry int8_full"),
                ("vlad_bf16", "vlad", [], "entry bf16")):
            run_cli(label, cmd, root, extra, work / "results", path)
        cache_phase(ext, vlad, root, work / "descriptor_cache")
        ingest = ingest_phase(ext, vlad, ext8, vlad8, db + qu, qu, gt, work / "ingest", tag)

    # ---------------------------------------------------------------- the retrieval engines
    retrieval_phase(tag)
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- throughput
    device_rate = {}
    for path, extractor, vl in (("bf16", ext, vlad), ("int8_full", ext8, vlad8)):
        for px, bsz in [(224, 32), (308, 32), (1022, 1)]:
            x = torch.randint(0, 256, (bsz, px, px, 3), dtype=torch.uint8).to(dev)

            def step():
                return vl.aggregate(extractor(x))

            ms = time_ms(step, iters=10, reps=3)
            n_tok = (px // 14) ** 2 + 1
            print(f"throughput {tag}: {path} extract+VLAD {px} px ({n_tok} tokens) batch {bsz}: "
                  f"{ms:.2f} ms/batch, {bsz * 1000 / ms:.2f} images/s", flush=True)
            device_rate[path, px] = bsz * 1000 / ms
            if profile_dir is not None:
                profile(step, Path(profile_dir) / f"profile_{path}_{px}px_b{bsz}.txt",
                        f"{path} {px} px batch {bsz} {tag}")

    for (label, path), rate in ingest.items():
        dev_rate = device_rate[path, 308]
        print(f"ingest vs device-only {tag}: {label}: {rate:.2f} images/s with host decode, "
              f"{dev_rate:.2f} images/s with the images already on the card (throughput {path} "
              f"308 px above): {rate / dev_rate:.3f} of it", flush=True)
    print(f"card: {card}", flush=True)
    return {name: {"name": name, "route": "cuda", **KERNEL_INFO[name], **r}
            for name, r in results.items()}


# the narrow streams' top-20 recall against exact search at 10,000 x 49152
# (clustered rows whose neighbours lie ~1e-4 apart). int8 rounds each row's
# scale to bf16, as the JAX package does: up to 2^-9 of every score of the
# row, far above those gaps. First set from a 2,000-row proxy on the CPU
# (bf16 0.996, int8 0.901) at 0.95 / 0.80; the card read 0.9936 / 0.7759
# at 10,000 rows, and int8's bound now sits below that reading
STREAM_RECALL_BOUND = {"bfloat16": 0.95, "int8": 0.70}


def retrieval_phase(tag: str) -> None:
    """The retrieval engines at the main path's width and at the
    compressed engines' scale, each timed (CUDA events; native: the host
    clock) and checked against exact search on the card."""
    import numpy as np
    import torch

    from anyloc_tpu_torch import native
    from anyloc_tpu_torch.ops import ivf, ivf_pq, pq
    from anyloc_tpu_torch.ops import retrieval as R
    from anyloc_tpu_torch.tools._timing import time_ms
    from anyloc_tpu_torch.tools.bench_retrieval import index_bytes, make_db, overlap

    dev = torch.device("cuda")
    k = 20

    def queries(db_dev, nq, seed):
        """Database rows plus noise 0.02, unit-normalized."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        rows = torch.randperm(db_dev.shape[0], generator=gen, device=dev)[:nq]
        q = db_dev[rows] + 0.02 * torch.randn((nq, db_dev.shape[1]), generator=gen, device=dev)
        return q / torch.linalg.vector_norm(q, dim=1, keepdim=True)

    def same_as_exact(label, s, i, ex_s, ex_i):
        """Ids as sets and sorted scores within 1e-4 on every row whose
        20th / 21st exact margin exceeds 1e-4."""
        s, i = np.asarray(s), np.asarray(i)
        rows = np.nonzero(ex_s[:, k - 1] - ex_s[:, k] > 1e-4)[0]
        ids_ok = all(set(i[r].tolist()) == set(ex_i[r, :k].tolist()) for r in rows)
        score_err = float(np.abs(np.sort(s[rows], 1) - np.sort(ex_s[rows, :k], 1)).max()) \
            if rows.size else 0.0
        ok = ids_ok and score_err <= 1e-4
        print(f"  {label}: same ids as exact on {rows.size} of {len(s)} rows with a 20th/21st "
              f"margin > 1e-4: {ids_ok}; max score error there {score_err:.2e} (bound 1e-4) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"{label} disagrees with exact search")

    def qps(fn, nq, reps=3):
        """queries/s of ``fn`` (best of ``reps`` after a warm-up) and its
        last result."""
        out = []
        ms = time_ms(lambda: out.append(fn()), iters=1, reps=reps, warmup=1)
        return nq / (ms * 1e-3), out[-1]

    # ---- the main path's width: Pitts-30k's database of VLAD-32 over
    # DINOv2-G (10,000 x 49152, 1.97 GB f32), 1,000 queries
    n, d, nq = 10_000, 49152, 1_000
    db_dev = make_db(n, d, "clustered", seed=0, device=dev)
    qu_dev = queries(db_dev, nq, 1)
    db, qu = db_dev.cpu().numpy(), qu_dev.cpu().numpy()
    ex_s, ex_i = (t.cpu().numpy() for t in R.top_k_search(db_dev, qu_dev, k + 1))
    rate, _ = qps(lambda: R.top_k_search(db_dev, qu_dev, k), nq)
    print(f"retrieval {tag} [{n}x{d} clustered, {nq} queries, k {k}] device: fit 0 s, "
          f"{rate:.1f} queries/s (database resident, {db_dev.numel() * 4 / 2**30:.2f} GiB)",
          flush=True)
    for stream in ("float32", "bfloat16", "int8"):
        def blocked():
            return R.top_k_search_blocked(db, qu, k, db_block=2500, stream_dtype=stream,
                                          normalize_rows=True)
        rate, (s, i) = qps(blocked, nq, reps=2)
        rec = overlap(i, ex_i[:, :k])
        print(f"retrieval {tag} [{n}x{d}] blocked {stream} (4 shards of 2500 rows): fit 0 s, "
              f"{rate:.1f} queries/s ({4 * rate / nq:.2f} shards/s), top-{k} recall vs exact "
              f"{rec:.4f}", flush=True)
        if stream == "float32":
            same_as_exact("blocked float32", s, i, ex_s, ex_i)
        else:
            ok = rec >= STREAM_RECALL_BOUND[stream]
            print(f"  blocked {stream}: recall {rec:.4f} (bound >= {STREAM_RECALL_BOUND[stream]}) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"blocked {stream} recall below its bound")
    # the blocked step's parts at this width: the PCIe copy of one pinned
    # shard alone, the host's packing of it, the product, and the product
    # with the sort-based merge; then the sort alone at the default
    # 131072-row shard and a 1024-query block
    shard = R._prepare_shard(db, 0, 2500, "float32", True, pin=True)[0]
    copy_ms = time_ms(lambda: shard.to(dev, non_blocking=True), iters=4)
    t0 = time.perf_counter()
    for d0 in range(0, n, 2500):
        R._prepare_shard(db, d0, d0 + 2500, "float32", True, pin=True)
    prep_ms = (time.perf_counter() - t0) * 1e3 / 4
    shard_dev = shard.to(dev)
    best = (torch.full((nq, k), float("-inf"), device=dev),
            torch.zeros((nq, k), dtype=torch.int64, device=dev))
    merge_ms = time_ms(lambda: R._blocked_merge(*best, shard_dev, None, qu_dev, 0, k, "cosine", 1.0))
    prod_ms = time_ms(lambda: qu_dev @ shard_dev.T)
    wide = torch.randn((1024, 131072 + k), device=dev)
    sort_ms = time_ms(lambda: torch.sort(wide, dim=-1, descending=True, stable=True), iters=3)
    del wide, shard, shard_dev
    gbs = 2500 * d * 4
    print(f"retrieval {tag} blocked float32 step at [{nq} queries x 2500 rows x {d}]: PCIe copy "
          f"of one pinned shard alone {copy_ms:.2f} ms ({gbs / copy_ms / 1e6:.2f} GB/s, "
          f"{1e3 / copy_ms:.1f} shards/s); host packing {prep_ms:.1f} ms/shard; product "
          f"{prod_ms:.2f} ms, product + sort-based merge {merge_ms:.2f} ms (merge share "
          f"{(merge_ms - prod_ms) / merge_ms:.3f}); stable sort of [1024, {131072 + k}] f32 alone "
          f"{sort_ms:.2f} ms", flush=True)
    check(native.available(), f"native nnsearch did not build: {native.nnsearch_build_error}")
    t0 = time.perf_counter()
    s, i = native.nn_search(db, qu[:100], k)
    rate = 100 / (time.perf_counter() - t0)
    print(f"retrieval {tag} [{n}x{d}] native (host, {os.cpu_count()} cores, 100 queries): fit 0 s, "
          f"{rate:.1f} queries/s", flush=True)
    same_as_exact("native", s, i, ex_s[:100], ex_i[:100])
    del db_dev, qu_dev, db, qu

    # ---- the compressed engines' scale: 1,000,000 x 512 (PCA-512, 2.05 GB
    # f32), 1,000 queries, pq_m 64, n_probe 16
    n, d, nq, n_probe = 1_000_000, 512, 1_000, 16
    db_dev = make_db(n, d, "pca_spectrum", seed=2, device=dev)
    qu_dev = queries(db_dev, nq, 3)
    db, qu = db_dev.cpu().numpy(), qu_dev.cpu().numpy()
    ex_i = R.top_k_search(db_dev, qu_dev, k)[1].cpu().numpy()
    n_chk = 32                   # queries of the full-probe and decode checks

    def fitted(label, fit):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = fit()
        torch.cuda.synchronize()
        return index, time.perf_counter() - t0

    def report(label, index, fit_s, search):
        rate, (_, ids) = qps(search, nq)
        rec = overlap(ids.cpu().numpy(), ex_i)
        print(f"retrieval {tag} [{n}x{d} pca_spectrum, {nq} queries, k {k}] {label}: fit "
              f"{fit_s:.2f} s, {rate:.1f} queries/s, top-{k} recall vs exact {rec:.4f}, index "
              f"{index_bytes(index) / 2**20:.1f} MiB", flush=True)

    def exact_over(rows_dev, method_q, label, got):
        want_s, want_i = R.top_k_search(rows_dev, method_q, k + 1)
        same_as_exact(label, got[0].cpu().numpy(), got[1].cpu().numpy(),
                      want_s.cpu().numpy(), want_i.cpu().numpy())

    index, fit_s = fitted("ivf", lambda: ivf.ivf_fit(db, device=dev))
    report(f"ivf ({index.n_cells} cells) n_probe {n_probe}", index, fit_s,
           lambda: index.search(qu, k, n_probe=n_probe))
    exact_over(db_dev, qu_dev[:n_chk], "ivf at full probe vs exact",
               index.search(qu[:n_chk], k, n_probe=index.n_cells))
    del index
    index, fit_s = fitted("pq", lambda: pq.pq_fit(db, 64, method="cosine", device=dev))
    for scan in ("tables", "decode"):
        report(f"pq64 {scan} (f32 scores)", index, fit_s,
               lambda: index.search(qu, k, scan=scan))
    m = index.m
    xhat = index.codebooks[torch.arange(m, device=dev)[None], index.codes.long()].reshape(n, d)
    for scan in ("tables", "decode"):
        exact_over(xhat, qu_dev[:n_chk], f"pq {scan} vs exact over decode()",
                   index.search(qu[:n_chk], k, scan=scan))
    del index, xhat
    index, fit_s = fitted("ivf_pq", lambda: ivf_pq.ivf_pq_fit(db, m=64, device=dev))
    report(f"ivf_pq64 ({index.n_cells} cells) n_probe {n_probe}", index, fit_s,
           lambda: index.search(qu, k, n_probe=n_probe))
    recon = torch.from_numpy(index.decode()).to(dev)
    exact_over(recon, qu_dev[:n_chk], "ivf_pq at full probe vs exact over the reconstructions",
               index.search(qu[:n_chk], k, n_probe=index.n_cells))
    del index, recon, db_dev, qu_dev


def write_vpr_bench(ds_dir: Path, db_paths, query_paths, gt, copies: int = 1) -> None:
    """A vpr_bench dataset (ref/, query/, ground_truth_new.npy) of copies
    of existing JPEGs: ``db_paths`` ``copies`` times in ref/, each query's
    positives moved along with every copy."""
    import numpy as np

    (ds_dir / "ref").mkdir(parents=True)
    (ds_dir / "query").mkdir()
    n = len(db_paths)
    for c in range(copies):
        for i, src in enumerate(db_paths):
            shutil.copyfile(src, ds_dir / "ref" / f"{c * n + i}.jpg")
    rows = np.empty((len(query_paths), 2), object)
    for i, src in enumerate(query_paths):
        shutil.copyfile(src, ds_dir / "query" / f"{i}.jpg")
        rows[i] = (i, np.concatenate([np.asarray(gt[i]) + c * n for c in range(copies)]))
    np.save(ds_dir / "ground_truth_new.npy", rows, allow_pickle=True)


def run_cli(label: str, cmd: str, root: Path, extra, out: Path, path: str) -> None:
    """``python -m anyloc_tpu_torch <cmd> ENTRY_ARGS <extra>`` on the
    dataset root through ``cli.main`` with no device named, launch counts
    reset just before and read just after; the search must run on the card
    (F11) and the results JSON be complete."""
    from anyloc_tpu_torch import cli
    from anyloc_tpu_torch.ops import kernels as K
    from anyloc_tpu_torch.ops import retrieval

    searched = []
    search = retrieval.top_k_search

    def spy(db, qu, k, *a, **kw):
        searched.append(db.device.type)
        return search(db, qu, k, *a, **kw)

    argv = [cmd, *ENTRY_ARGS, *extra, "--prog.data-vg-dir", str(root),
            "--prog.cache-dir", str(out), "--exp-id", label]
    retrieval.top_k_search = spy
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()) as log:   # the pipeline's progress lines
            rc = cli.main(argv)
    finally:
        retrieval.top_k_search = search
    seconds = time.perf_counter() - t0
    counts = K.launch_counts()
    check(rc == 0, f"cli {label} returned {rc}")
    saved = sorted((out / "experiments" / label).glob("results_*.json"))
    check(len(saved) == 1, f"cli {label}: results JSON {saved}")
    res = json.loads(saved[0].read_text())
    check(res["VLAD-Dim"] == str(32 * 1536) and res["Num-DB"] == "16" and res["Num-QU"] == "8",
          f"cli {label}: {res}")
    check(all(0.0 <= res[f"R@{k}"] <= 1.0 for k in (1, 5, 10)), f"cli {label}: recalls {res}")
    check(searched == ["cuda"], f"cli {label}: top-k ran on {searched}, not the card")
    for name in PATH_KERNELS[path]:
        check(counts[name] > 0, f"{name} never launched in the cli {label} run")
    recalls = {k: res[f"R@{k}"] for k in (1, 5, 10)}
    print(f"entry point {label}: python -m anyloc_tpu_torch {cmd} {' '.join(ENTRY_ARGS + extra)} "
          f"(17places 16 db + 8 queries, vocabulary {res.get('Global-Vocab', '17places db')}): "
          f"rc 0 in {seconds:.1f} s (model build included), VLAD-Dim {res['VLAD-Dim']}, recall "
          f"(random weights, not asserted) {recalls}, top-k on {searched[0]}, results JSON "
          f"{saved[0].name}; {len(log.getvalue().splitlines())} progress lines; launch counts "
          f"{counts}", flush=True)


def cache_phase(ext, vlad, root: Path, cache_dir: Path) -> None:
    """Two engines over one descriptor cache on the 17places tree: the
    second launches no trunk kernel and reads bit-equal VLADs; a shard
    truncated on purpose is recomputed."""
    import numpy as np

    from anyloc_tpu_torch import DescriptorEngine, get_dataset
    from anyloc_tpu_torch.ops import kernels as K

    ds = get_dataset("17places", str(root), img_size=(320, 320))

    def vlads():
        K.reset_launch_counts()
        out = DescriptorEngine(extractor=ext, cache_dir=str(cache_dir)).extract_vlads_dataset(
            ds, vlad, "all", verbose=False)
        return out, K.launch_counts()

    first, counts1 = vlads()
    again, counts2 = vlads()
    check(counts1["K5_flash_attention_qkv_proj"] > 0, "cache: the first engine did not compute")
    launched = {n: counts2[n] for n in TRUNK_KERNELS if counts2[n]}
    same = np.array_equal(first, again)
    print(f"descriptor cache: first engine {first.shape} VLADs computed (launch counts {counts1}); "
          f"second engine launched {launched or 'no trunk kernel'} (bound: none) and read "
          f"{'bit-equal' if same else 'DIFFERENT'} VLADs (bound: bit-equal)", flush=True)
    check(not launched and same, "cache: the second engine computed or read other VLADs")
    shards = sorted(cache_dir.glob("descs_*/vlad32_*.npz"))
    check(len(shards) == 1, f"cache: shards {shards}")
    raw = shards[0].read_bytes()
    shards[0].write_bytes(raw[: len(raw) // 2])
    redo, counts3 = vlads()
    cos = (redo * first).sum(1) / (np.linalg.norm(redo, axis=1) * np.linalg.norm(first, axis=1))
    print(f"descriptor cache: shard truncated to {len(raw) // 2} of {len(raw)} bytes -> a miss, "
          f"recomputed (K5 launches {counts3['K5_flash_attention_qkv_proj']}), "
          f"{'bit-equal' if np.array_equal(redo, first) else 'not bit-equal'} to the first, "
          f"min cosine {cos.min():.7f} (bound >= 0.9999)", flush=True)
    check(counts3["K5_flash_attention_qkv_proj"] > 0 and cos.min() >= 0.9999,
          "cache: a truncated shard was not recomputed")


def ingest_phase(ext, vlad, ext8, vlad8, jpegs, queries, gt, work: Path, tag: str) -> dict:
    """Images/s with host decode on an INGEST_DB-image vpr_bench database at 320
    -> 308 px, batch 32, best of 3: decode alone (``dataset.batches``, no
    device work), then decode + extract + VLAD through the engine, wall
    clock from the call to the last VLAD on the host."""
    import numpy as np

    from anyloc_tpu_torch import DescriptorEngine, get_dataset, native

    write_vpr_bench(work / "17places", jpegs, queries, gt, copies=INGEST_DB // len(jpegs))
    ds = get_dataset("17places", str(work), img_size=(320, 320))
    check(ds.database_num == INGEST_DB, f"ingest database of {ds.database_num}")
    cores = os.cpu_count()
    decoders = ["PIL", "native"]
    if not native.imagepipe_available():
        decoders = ["PIL"]
        lines = (native.build_error or "no reason given").splitlines()
        reason = next((line for line in lines if "error" in line), lines[-1])
        print(f"ingest: the native image pipe did not build on this machine ({reason}): "
              "PIL only", flush=True)

    def best_of_3(fn):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return INGEST_DB / best

    def decode_only(output):
        n = sum(int((idx >= 0).sum()) for _, idx in ds.batches(32, "db", output=output))
        check(n == INGEST_DB, f"decode gave {n} images")

    for decoder in decoders:
        ds.use_native_loader = decoder == "native"
        check(ds.decoder() == decoder, f"dataset decodes with {ds.decoder()}, not {decoder}")
        for output in ("float32", "uint8"):
            rate = best_of_3(lambda: decode_only(output))
            print(f"ingest {tag}, {cores} cores: decode alone, {decoder} "
                  f"({'one prefetch thread' if decoder == 'PIL' else 'a thread per core'}), "
                  f"{output}, 640x480 JPEG -> 320x320: {rate:.2f} images/s", flush=True)
    rates = {}
    for path, extractor, vl, transfer in (("bf16", ext, vlad, "float32"),
                                          ("int8_full", ext8, vlad8, "uint8")):
        engine = DescriptorEngine(extractor=extractor, batch_size=32, transfer_dtype=transfer)
        for decoder in (decoders if path == "bf16" else decoders[-1:]):
            ds.use_native_loader = decoder == "native"
            out = []
            rate = best_of_3(lambda: out.append(engine.extract_vlads_dataset(
                ds, vl, "db", verbose=False)))
            check(out[-1].shape == (INGEST_DB, 32 * 1536) and bool(np.isfinite(out[-1]).all()),
                  f"ingest {path}: VLADs {out[-1].shape}")
            label = f"{path}, {transfer} transfer, {decoder} decode"
            rates[label, path] = rate
            print(f"ingest {tag}, {cores} cores: decode + extract + VLAD through the engine, "
                  f"{label}, {INGEST_DB} images at 320 -> 308 px, batch 32: {rate:.2f} images/s",
                  flush=True)
    return rates


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
