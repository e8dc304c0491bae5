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
     width, F10), K1 (VLAD, at the main path's three shapes and the family
     phase's two at D 768, in its three modes, hard labels up to near ties, two launches bit-equal; then
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
     then K5 with a bias and a residual but no LayerScale (every family
     but DINOv2) at CLIP-L/14@336px (float32) and MAE-H/14 (bf16) widths
     and at the family phase's other shapes (patch-CLIP crops in float32,
     HF ViT-B/16 and LSeg ViT-L/16 in bf16; the eval phase's dvgl
     ViT-B/16 at 224 px and ImageBind-H/14 in float32), and K2 at DINO v1 ViT-B/8's
     and ViT-S/8's stride-4 sequence beside SDPA,
     against their plain PyTorch versions at the main paths' and the tools'
     shapes, with the error bound stated on each line, timed beside the
     plain version, the least time the card could take (bound_ms), a
     PyTorch library call as a yardstick where one computes the same
     (library_ms: SDPA for K2, torch._int_mm / cuBLAS for T1), for
     K6-K9, T2 and T3 the route the port wires instead (wired_ms), and for
     K2, K3, K5-K8, T1 on bf16 and T2 the rate their products reach
     (TFLOP/s or TOPS) and their share of the bound (bound_ms / ms); a
     float32 route's bound counts its 3xTF32 products (three tf32 products
     an f32 one) at the tf32 peak, with the FMA-peak bound beside it;
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
  8. the other entry points (``other_entry_points_phase``), each through
     what a user calls with no device named, at DINOv2-G/14 layer 31
     value: ``python -m anyloc_tpu_torch demo`` on 4 JPEGs at 1024 px
     (1022 px, 5330 tokens) in bf16 (K1, K2 must launch) and int8_full
     (K1, K2, K3), each .npy held to extractor + aggregate, timed with
     the extractor built, then ``--domain auto`` with
     ``build_gem_centroids``; the serving daemon (``serve_http``,
     int8_full, uint8 transfer, --img-size 308): 16 concurrent /describe
     and /search requests held to the engine's VLADs and exact search,
     mean_batch > 1, K1, K3, K4 launching, a group's fetch returning
     while the next group runs, requests/s and p50 / p99 latency at
     concurrency 1 and 16, then --ivf and a 1-row --pq database (F3);
     ``gem`` (int8_full: K3, K4), ``gp`` and ``global-vpr`` (bf16: K5)
     through ``cli.main``; a 2-point ``run_sweep`` on one engine with no
     failed point;
  9. the other model families (``other_families_phase``), through what a
     user calls, no device named: ``global-vocab-vlad`` with DINO v1
     ViT-B/8 (layer 9 key, stride 4, 224 px: 3026 tokens; K1 and K2 must
     launch), ``clip-top-k`` (K5) and ``patch-clip`` (K1, K5) with CLIP
     ViT-L/14@336px in float32 at full depth, CLIP-L's images/s, a
     zero-shot call through the BPE fixture's tokenizer and
     ``trivial_clip_vpr`` over the fixture's JPEGs; one ``make_extractor``
     forward each of MAE-H/14, ImageBind-H, SAM-H (1024 px), LSeg, HF
     ViT-B and DINO v1 S/8 at full width and depth, weights drawn on the
     card, with the kernels each launched (K5; K2 for DINO v1; none for
     SAM); each family's 2-block float32 trunk on the card against the CPU;
     then the trained baselines (``eval_phase``): ``python -m
     anyloc_tpu_torch eval`` on the 17places tree for dvgl ResNet-18
     conv4 + NetVLAD-64 at 480x640, dvgl ViT-B/16 + NetVLAD-64 at 224 px
     (K5 in float32 must launch), MixVPR (ResNet-50 conv4, 1024 x 4 mixer,
     320 px) and CosPlace (ResNet-50, GeM + fc 512), each from its random
     init and again from a checkpoint in its release layout (descriptors
     bit-equal), the eval rate on the card and with PIL decode, and one
     float32 forward each of VGG-16, AlexNet, CCT-14/7x2, EfficientNet-b0
     and b7, SwinV2-B, CRN and RRM on ResNet-18 conv4 and ImageBind-H's
     five towers (K5), card against CPU within 1e-4 of the largest value,
     with cuDNN's TF32 flag at PyTorch's default (F17: the port's float32
     convolutions run in full float32 on their own; the script checks the
     flag and never sets it);
     then training (``train_phase``): ``python -m anyloc_tpu_torch train``
     on the 17places tree with dvgl's defaults (resnet18conv4 + NetVLAD-64
     at 480x640, batch 4 tuples of 1 + 1 + 10 images, Adam at 1e-5,
     partial mining), 2 epochs of 8 queries, NetVLAD's k-means init, then
     again with --resume (its starting parameters bit-equal to the saved
     ones); the same for the vit backbone at 224 px (K5 in every block of
     every step with its gradient, F18, through K5's backward kernels: the
     patch embedding and block 0's qkv get non-zero gradients); a few
     CosPlace CosFace steps (ResNet-50,
     GeM + fc 512, 512x512, batch 32); each path's step time, tuples/s and
     images/s, K5's forward and backward ms inside the vit step; one step's
     gradients card vs CPU for both dvgl models (vit: within 1e-4 of the
     largest |g| but rare flips; resnet18conv4: no farther from a CPU
     float64 run than 10x the CPU's float32 run), each convolution of
     resnet18conv4 at the step's shapes card vs CPU within 1e-4 of the
     largest |g| (F17b; a planted TF32 backward must fail it) and K5's
     gradient (its backward kernels) against its plain version's at
     [48, 197, 2304] float32 and bfloat16 with LayerScale
     (``train_checks.bf16_errors``), the backward timed beside the plain
     version's autograd and its 3xTF32 and FMA bounds, then its two halves
     alone (the projection backward and the attention backward on K5's
     views of qkv), each beside its own bound, and two backward calls
     bit-equal;
     then ``parallel/`` (``mesh_phase``): on a one-rank NCCL group in this
     process ``DescriptorEngine(mesh=local_mesh(1))`` in bf16 and
     int8_full (VLADs bit-equal to the engine's, both rates) and ``serve
     --mesh 1`` (replies equal to the daemon's), then two Gloo ranks on
     this card (``tools/mesh_checks.py``): sharded extraction, tensor,
     pipeline, sequence (1022 px) and expert parallelism, sharded k-means
     and exact search at DINOv2-G width against one rank, K1-K5 launching
     in the phase; then the training half (``train_mesh_phase``): K2
     under autograd at a tensor-parallel rank's [48, 6, 197, 64] float32
     (and bfloat16 at [2, 8, 257, 64]) against its plain version's
     gradient, its backward kernel timed beside the plain version's
     autograd, SDPA's backward and its bounds; on the
     one-rank NCCL group an FSDP step of dvgl's vit + NetVLAD-64 against
     the plain step and sync BatchNorm over an axis of one rank against
     local BatchNorm; then two Gloo ranks on this card: F24's
     collectives, FSDP over data 2 (dvgl vit: loss, averaged gradients
     and updated parameters), the tp_split vit over model 2 (K2 with its
     gradient), sync BatchNorm (resnet18conv4 at 480x640: outputs and
     statistics in float32, and gradients too in float64), the sharded
     restore, and (F25) the dp x pp step with dvgl vit's 12 blocks
     pipelined over model 2 (``pptrain``) and sequence-parallel facets'
     gradients (``sptrain``), each against one rank; then the attention
     backward's route table (``attention_bwd_routes_phase``): every (head
     dim, dtype) on the kernels the table names (wgmma everywhere but hd 128
     in f32, which takes the split route: the wgmma kernel without dQ, then
     the query-major dQ kernel) against its plain version, two launches
     bit-equal, and each timed alone beside its plain version, SDPA's
     backward and its bound (hd 64 at [48, 6, 197, 64], the other head dims
     at [8, 1280 / hd, 257, hd], f32 and bf16); the F27 line (K2's f32
     forward against float64 at N 257, 1370 and 2740, beside its plain
     version's); the F28 line (the attention backward's f32 dq, dk, dv
     against float64 at [2, 16, N, 80] for N 257, 1370, 2740 and at
     [2, 16, 1370, 128] on the split route, beside the plain version's);
     the F29 line (``f29_line``: K5's f32 projection backward's d_o, d_W,
     d_b, d_γ and K5's f32 gradient under autograd end to end, every
     input's, against float64 at the dvgl vit step's, ViT-H's and
     DINOv2-G's widths, and the forward GEMM's ``OpTF32x3`` at K 1024,
     1280 and 1536, each beside its plain version's);
     the ViT-H gradient (``vith_gradient_phase``): K5's
     backward under autograd at MAE-H/14's qkv [8, 257, 3840] and K2's at
     [8, 16, 257, 80], f32 and bf16, and at the same width cut into 10
     heads of 128 in f32 (the split route), held to the plain autograd and
     timed beside it, with the launches of the run; the K2 gradient and
     memory lines name the route they ran; then the tooling
     (``tooling_phase``): ``python -m anyloc_tpu_torch viz clusters``
     and ``viz report`` at DINOv2-G l31
     (K5 launching, the report's labels equal to a direct run); the
     retrieval phase then runs each sharded engine over the one-rank mesh
     beside its engine (results equal); then the repository's programs
     (``repo_programs_phase``): K3 beside the library MLP half
     (``tools/bench_mlp_xla_int8``), the daemon under 16 client processes
     coalesced and batch 1 (``tools/bench_serving``, G/14 l31 int8_full,
     replies equal), IVF against exact at 1,000,000 x 512
     (``tools/bench_ivf``), a ``tools/bench_pq_matrix`` point, the three
     examples, ``dryrun.entry()`` and ``dryrun_multichip(2)``;
 10. timing: images/s of extract + VLAD at 224 px and 308 px (batch 32)
     and 1022 px (batch 1), bf16 and int8_full, images already on the
     card, then the ingest rates beside them. ``--profile DIR`` also
     writes torch.profiler tables of the shapes to DIR.
Before them come one ``summary <phase>:`` line per phase (seconds,
verdict, readings); the line before the last is a JSON object with one
entry per kernel; the last line is {"ok": true, "device": {...}}. The
whole output, the ranks' included, also goes to
chiprun_out/chip_smoke.log.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
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
    # the gradients of K2 and K5 (no Pallas kernel has a backward, F19: the
    # function is the XLA route's gradient of the kernel named)
    "K2b_flash_attention_bwd": dict(
        source="anyloc_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="anyloc_tpu/ops/pallas/flash_attention.py:241"),
    "K5b_flash_attention_qkv_proj_bwd": dict(
        source="anyloc_tpu_torch/csrc/attn_qkv_proj_bwd.cu",
        replaces="anyloc_tpu/ops/pallas/attn_proj.py:327"),
    # the attention backward that K2b and K5b launch, one entry per route of
    # its route table (attention_bwd_route): wgmma everywhere but hd 128 in
    # float32, which takes the split route (the wgmma kernel without dQ,
    # then the query-major dQ kernel)
    "Kab_attention_bwd_wgmma": dict(
        source="anyloc_tpu_torch/csrc/flash_attention_bwd.cuh",
        replaces="anyloc_tpu/ops/pallas/flash_attention.py:241"),
    "Kab_attention_bwd_split": dict(
        source="anyloc_tpu_torch/csrc/flash_attention_bwd.cuh",
        replaces="anyloc_tpu/ops/pallas/flash_attention.py:241"),
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
    # the other entry points: demo at 1022 px, the daemon at 308 px, the
    # pooling pipelines at 308 px
    "demo bf16": ("K1_vlad_aggregate_fused", "K2_flash_attention"),
    "demo int8_full": ("K1_vlad_aggregate_fused", "K2_flash_attention", "K3_fused_mlp_int8"),
    "serve int8_full": ("K1_vlad_aggregate_fused", "K3_fused_mlp_int8", "K4_fused_attn_half_int8"),
    "gem int8_full": ("K3_fused_mlp_int8", "K4_fused_attn_half_int8"),
    "gp bf16": ("K5_flash_attention_qkv_proj",),
    "global-vpr bf16": ("K5_flash_attention_qkv_proj",),
    # the other model families: DINO v1 ViT-B/8 at stride 4 (3026 tokens),
    # CLIP ViT-L/14@336px in float32 (577 tokens; patch-clip's crops 145)
    "dino_v1 entry": ("K1_vlad_aggregate_fused", "K2_flash_attention"),
    "clip-top-k": ("K5_flash_attention_qkv_proj",),
    "patch-clip": ("K1_vlad_aggregate_fused", "K5_flash_attention_qkv_proj"),
    # python -m anyloc_tpu_torch eval: the dvgl ViT-B/16 backbone at 224 px
    # in float32 (197 tokens); the CNN baselines launch no kernel
    "eval dvgl vit": ("K5_flash_attention_qkv_proj",),
    "eval dvgl resnet18conv4": (),
    "eval mixvpr": (),
    "eval cosplace": (),
    # python -m anyloc_tpu_torch train: the vit backbone's K5 in every block of
    # every step (forward kernel, backward kernels) and in mining and
    # validation; resnet18conv4 + NetVLAD launches no kernel
    "train dvgl vit": ("K5_flash_attention_qkv_proj", "K5b_flash_attention_qkv_proj_bwd",
                       "Kab_attention_bwd_wgmma"),
    "train dvgl resnet18conv4": (),
    # ViT-H's attention gradient (MAE-H/14, ImageBind-H, SAM-H: 16 heads of
    # 80): K5 and K2 under autograd, the backward on the wgmma route; the
    # same width in 10 heads of 128, f32: the split route
    "vit-h gradient": ("K5_flash_attention_qkv_proj", "K5b_flash_attention_qkv_proj_bwd",
                       "K2_flash_attention", "K2b_flash_attention_bwd",
                       "Kab_attention_bwd_wgmma", "Kab_attention_bwd_split"),
    # imagebind_huge(full=True)'s five towers: K5 in the f32 vision tower
    "imagebind_huge": ("K5_flash_attention_qkv_proj",),
    # parallel/: DescriptorEngine(mesh=...) in bf16 (K1, K5) and int8_full
    # (K3, K4), serve --mesh 1, the two ranks' sharded extraction, tensor
    # parallelism (K2 on each rank's heads), pipeline stages (K5) and EP (K1)
    "mesh": ("K1_vlad_aggregate_fused", "K2_flash_attention", "K3_fused_mlp_int8",
             "K4_fused_attn_half_int8", "K5_flash_attention_qkv_proj"),
    # parallel/'s training half: K5 and its backward kernels in the dvgl
    # vit's FSDP steps, K2 and its backward on each tensor-parallel rank
    "train mesh": ("K2_flash_attention", "K5_flash_attention_qkv_proj",
                   "K2b_flash_attention_bwd", "K5b_flash_attention_qkv_proj_bwd",
                   "Kab_attention_bwd_wgmma"),
    # the repository's programs in this process: bench_mlp_xla_int8 (K3), the
    # quickstart (bf16: K1, K5) and serving (int8_full: K1, K3, K4) examples,
    # entry() (K1, K5)
    "programs": ("K1_vlad_aggregate_fused", "K3_fused_mlp_int8", "K4_fused_attn_half_int8",
                 "K5_flash_attention_qkv_proj"),
}
# the eval phase's runs: label -> the CLI's flags (17places, 16 db + 8
# queries), the descriptor width
EVAL_RUNS = {
    "eval dvgl resnet18conv4": (["--backbone", "resnet18conv4", "--aggregation", "netvlad"],
                                64 * 256),
    "eval dvgl vit": (["--backbone", "vit", "--aggregation", "netvlad", "--resize", "224", "224"],
                      64 * 768),
    "eval mixvpr": (["--model-family", "mixvpr"], 1024 * 4),
    "eval cosplace": (["--model-family", "cosplace", "--backbone", "resnet50"], 512),
}
# the file each run's weights are written to and read back from
EVAL_CHECKPOINTS = {"eval dvgl resnet18conv4": "dvgl.pth", "eval dvgl vit": "dvgl_vit_ckpt",
                    "eval mixvpr": "mixvpr.ckpt", "eval cosplace": "cosplace.pth"}
# the networks held card vs CPU at full width and depth, with their batch
EVAL_NETWORKS = {"vgg16": 2, "alexnet": 2, "cct384": 2, "efficientnet_b0": 2,
                 "efficientnet_b7": 2, "swinv2_base": 1, "crn": 2, "rrm": 2,
                 "imagebind_huge": 1}
# make_extractor of each other family at its published width: (images,
# pixels, the kernels its forward must launch; SAM's attention is plain)
FAMILY_FORWARDS = {
    "mae_vit_huge_patch14": (8, 224, ("K5_flash_attention_qkv_proj",)),
    "imagebind_huge": (8, 224, ("K5_flash_attention_qkv_proj",)),
    "sam_vit_h": (1, 1024, ()),
    "lseg": (2, 384, ("K5_flash_attention_qkv_proj",)),
    "hf_vit_base": (8, 224, ("K5_flash_attention_qkv_proj",)),
    "dino_vits8": (8, 224, ("K2_flash_attention",)),
}
DINO_V1_ARGS = ["--prog.vg-dataset-name", "17places", "--db-samples", "17places=1", "gardens=1",
                "--extractor.model-type", "dino_vitb8", "--extractor.desc-layer", "9",
                "--extractor.desc-facet", "key", "--bd-args.resize", "224", "224",
                "--top-k-vals", "1", "5", "10"]
CLIP_ARGS = ["--prog.vg-dataset-name", "17places", "--extractor.model-type",
             "clip_ViT-L/14@336px", "--bd-args.resize", "336", "336", "--top-k-vals", "1", "5", "10"]
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
# sheet; f32 outside the tensor cores): operations/s by type, bytes/s. The
# f32 routes of K2, K5-K8 and T1 run three tf32 products for each f32 one
# (3xTF32): their bound counts each f32 operation three times at "tf32"
# (TF32X3, below); "f32" is the FMA peak of the kernels without a tensor
# core route (K1), printed beside the f32 routes' 3xTF32 bounds.
PEAK = {"bf16": 989e12, "int8": 1979e12, "tf32": 494.7e12, "f32": 67e12, "hbm": 3.35e12}
TF32X3 = 3


class SmokeFailure(RuntimeError):
    pass


# the phases in order: name, start, readings noted, seconds; one summary line
# each is printed before the kernels line (the log file holds every line)
PHASES: list = []
LOG = ROOT / "chiprun_out" / "chip_smoke.log"


def mark(name: str) -> None:
    """Close the phase that runs and open ``name``."""
    now = time.perf_counter()
    if PHASES and PHASES[-1]["seconds"] is None:
        PHASES[-1]["seconds"] = now - PHASES[-1]["t0"]
    PHASES.append(dict(name=name, t0=now, notes=[], seconds=None))


def note(text: str) -> None:
    """A reading for the summary line of the phase that runs."""
    if PHASES:
        PHASES[-1]["notes"].append(text)


def summary_lines(failed: bool = False) -> list:
    """One line per phase: its seconds, verdict and readings (a failure
    ends the phase it happened in)."""
    mark("end")
    PHASES.pop()
    out = []
    for i, ph in enumerate(PHASES):
        verdict = "FAILED" if failed and i == len(PHASES) - 1 else "ok"
        text = "; ".join(ph["notes"])
        out.append(f"summary {ph['name']}: {verdict}, {ph['seconds']:.1f} s"
                   + (f"; {text}" if text else ""))
    return out


@contextlib.contextmanager
def tee_output(path: Path):
    """Everything written to this process's stdout and stderr, and to its
    children's (they inherit the descriptors), also goes to ``path``."""
    import threading

    path.parent.mkdir(parents=True, exist_ok=True)
    log = open(path, "wb")
    pumps, saved = [], []
    for fd in (1, 2):
        sys.stdout.flush()
        sys.stderr.flush()
        keep = os.dup(fd)
        r, w = os.pipe()

        def pump(r=r, keep=keep):
            while True:
                chunk = os.read(r, 1 << 16)
                if not chunk:
                    break
                os.write(keep, chunk)
                log.write(chunk)
                log.flush()

        t = threading.Thread(target=pump, daemon=True)
        t.start()
        os.dup2(w, fd)
        os.close(w)
        pumps.append((t, r))
        saved.append((fd, keep))
    try:
        yield
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        for fd, keep in saved:
            os.dup2(keep, fd)      # the pipe's last write end closes: its pump ends
        for t, r in pumps:
            t.join(timeout=30)
            os.close(r)
        for _, keep in saved:
            os.close(keep)
        log.close()


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


def turns(kernel, plain) -> tuple:
    """(kernel ms, plain ms): each the best of two ``time_ms`` runs taken
    in turns (plain, kernel, kernel, plain), so a drift of the card's clock
    during the measurement falls on both."""
    from anyloc_tpu_torch.tools._timing import time_ms

    p1 = time_ms(plain, iters=10, reps=2)
    k1 = time_ms(kernel, iters=10, reps=2)
    k2 = time_ms(kernel, iters=10, reps=2, warmup=0)
    p2 = time_ms(plain, iters=10, reps=2, warmup=0)
    return min(k1, k2), min(p1, p2)


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
    mark("device and build")
    card = card_line()
    print(f"card: {card}", flush=True)
    note(card)
    tag = f"[{card}]"

    # float32 products that decide rankings must not run in TF32
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is enabled")
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is not 'highest'")
    # cuDNN's TF32 flag stays at PyTorch's default (True): the port's f32
    # convolutions run in full float32 on their own (F17)
    check(torch.backends.cudnn.allow_tf32, "cuDNN's TF32 flag is not PyTorch's default")

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
    mark("K2")
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
    mark("K5")
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
    mark("F10: head dim 80")
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

    # ---------------------------------------------------------------- the other model families' shapes
    mark("the other model families' shapes")
    # K5 with a bias and a residual but no LayerScale (no family but DINOv2
    # has one): CLIP-L/14@336px in float32 (the CLIP pipelines' type) and
    # MAE-H/14 / ImageBind-H/14 at 224 px in bf16, each against its plain
    # version and timed beside it and the bound; then the other shapes the
    # family phase gives it: patch-CLIP's 168-px crops (f32, 145 tokens),
    # HF ViT-B/16 at 224 px and LSeg's ViT-L/16 at 384 px (bf16); and the
    # eval phase's two in float32: dvgl's ViT-B/16 backbone at 224 px (the
    # eval batch of 16) and ImageBind-H's vision tower (heads of 80)
    results["K5_flash_attention_qkv_proj"]["no_layerscale"] = []
    for label, (b, n, h, hd, dtype) in [("CLIP-L/14@336px", (8, 577, 16, 64, torch.float32)),
                                        ("MAE-H/14", (32, 257, 16, 80, torch.bfloat16)),
                                        ("patch-CLIP crops", (32, 145, 16, 64, torch.float32)),
                                        ("HF ViT-B/16", (8, 197, 12, 64, torch.bfloat16)),
                                        ("LSeg ViT-L/16", (2, 577, 16, 64, torch.bfloat16)),
                                        ("dvgl ViT-B/16 eval", (16, 197, 12, 64, torch.float32)),
                                        ("ImageBind-H/14 f32", (8, 257, 16, 80, torch.float32)),
                                        ("dvgl ViT-B/16 train", (48, 197, 12, 64, torch.float32))]:
        d = h * hd
        qkv = randn(b, n, 3 * d, dtype=dtype)
        w = randn(d, d, dtype=dtype, scale=d ** -0.5).t()
        kw = dict(b_proj=randn(d, scale=0.1), layerscale=None,
                  residual=randn(b, n, d, dtype=dtype), num_heads=h)
        got = K.flash_attention_qkv_proj(qkv, w, **kw)
        want = K.flash_attention_qkv_proj_ref(qkv, w, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        f32 = dtype == torch.float32
        tol = dict(atol=2e-5, rtol=0) if f32 else k2_bound
        ok = torch.allclose(got.float(), want.float(), **tol)
        m, size = b * n, 4 if f32 else 2
        ops = 4 * b * h * n * n * hd + 2 * m * d * d
        nbytes = m * 3 * d * size + d * d * size + 2 * m * d * size + d * 4
        line = dict(shape=f"qkv [{b},{n},{3 * d}] {str(dtype)[6:]}, {h} heads of {hd}",
                    ms=time_ms(lambda: K.flash_attention_qkv_proj(qkv, w, **kw)),
                    plain_ms=time_ms(lambda: K.flash_attention_qkv_proj_ref(qkv, w, **kw), iters=3),
                    **bound({"tf32": TF32X3 * ops} if f32 else {"bf16": ops}, nbytes))
        fma_txt = ""
        if f32:   # the FMA-peak bound of the routes before 3xTF32, to read rows across PRs
            line["fma_bound_ms"] = bound({"f32": ops}, nbytes)["bound_ms"]
            fma_txt = f", FMA bound {line['fma_bound_ms']:.4f} ms"
        print(f"K5 flash_attention_qkv_proj without LayerScale, {label} {line['shape']} (bias + "
              f"residual): max_abs_err {err:.3e} (bound atol {tol['atol']} rtol {tol['rtol']}) "
              f"{'ok' if ok else 'FAIL'}; time {tag}: kernel {line['ms']:.3f} ms, plain "
              f"{line['plain_ms']:.3f} ms; bound {line['bound_ms']:.4f} ms ({line['bound_by']}"
              f"{', 3xTF32' if f32 else ''}){fma_txt}, "
              f"{ops / (line['ms'] * 1e-3) / 1e12:.1f} TFLOP/s, "
              f"{100 * line['bound_ms'] / line['ms']:.1f} % of the bound", flush=True)
        check(ok, f"K5 without LayerScale at {label} width disagrees with its plain version")
        record("K5_flash_attention_qkv_proj", err)
        results["K5_flash_attention_qkv_proj"]["no_layerscale"].append(line)
        del qkv, w, kw, got, want
    # K2 at DINO v1's stride-4 sequence (224 px: 3026 tokens): ViT-B/8 (12
    # heads of 64) in a 32-image batch and ViT-S/8 (6 heads of 64) in the
    # family phase's batch of 8, the scaled bound, beside SDPA
    for label, (b, h) in (("ViT-B/8", (32, 12)), ("ViT-S/8", (8, 6))):
        n, hd = 3026, 64
        qkv = randn(b, n, 3 * h * hd, dtype=torch.bfloat16)
        q, k, v = (qkv[..., i * h * hd:(i + 1) * h * hd].view(b, n, h, hd).transpose(1, 2)
                   for i in range(3))
        got = K.flash_attention(q, k, v)
        want = K.flash_attention_ref(q, k, v)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = scaled_err(got, want) <= k2_scaled
        line = dict(shape=f"[{b},{h},{n},{hd}] bf16", ms=time_ms(lambda: K.flash_attention(q, k, v)),
                    library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
                    **bound({"bf16": 4 * b * h * n * n * hd}, 4 * b * h * n * hd * 2))
        print(f"K2 flash_attention at DINO v1 {label} stride 4, {line['shape']} (qkv views): "
              f"max_abs_err {err:.3e}, scaled {scaled_err(got, want):.3e} (bound: max error <= "
              f"{k2_scaled} max|want|) {'ok' if ok else 'FAIL'}; time {tag}: kernel "
              f"{line['ms']:.3f} ms, SDPA {line['library_ms']:.3f} ms "
              f"({line['ms'] / line['library_ms']:.2f}x); bound {line['bound_ms']:.4f} ms "
              f"({line['bound_by']}), {4 * b * h * n * n * hd / (line['ms'] * 1e-3) / 1e12:.1f} "
              f"TFLOP/s, {100 * line['bound_ms'] / line['ms']:.1f} % of the bound", flush=True)
        check(ok, f"K2 at DINO v1 {label}'s sequence disagrees with its plain version")
        record("K2_flash_attention", err, **{"dino_v1" if h == 12 else "dino_v1_s8": line})
        del qkv, q, k, v, got, want

    # ---------------------------------------------------------------- K1
    mark("K1")
    # the main path's three shapes (224-px and 308-px database batches, the
    # 1022-px query, whose tokens the kernel splits over clusters) and the
    # family phase's two at D 768 (DINO v1 ViT-B/8's 224-px key facets, 3025
    # patches; patch-CLIP's 16 database images of 4 crop descriptors), each in
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
    for label, b, n, d in [("224px", 32, 256, 1536), ("308px", 32, 484, 1536),
                           ("1022px", 1, 5329, 1536), ("dino_v1 224px", 32, 3025, 768),
                           ("patch-clip", 16, 4, 768)]:
        x = facets(b, n, d)
        c = 32
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
    mark("K4")
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
    mark("K3")
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
    mark("K9")
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
    mark("K7")
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

    f32_tol = dict(atol=1e-4, rtol=1e-5)   # f32 sums (3xTF32) over K = 1536-4096 in another order
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
    mark("K8")
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
    mark("K6")
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
    mark("T1, T2")
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
            # f32 operands (the 3xTF32 route K5-K8 share) with a Linear's
            # weight scale, so the bound is the ragged case's; drawn from a
            # generator of their own, so the later phases' draws stay as they were
            g32 = torch.Generator(device=dev).manual_seed(17)
            a32 = torch.randn((m, k), generator=g32, device=dev)
            b32 = (torch.randn((n, k), generator=g32, device=dev) * k ** -0.5).t()
            got32 = K.matmul(a32, b32, bk=512)
            want32 = K.matmul_ref(a32, b32, bk=512)
            torch.cuda.synchronize()
            err32 = (got32 - want32).abs().max().item()
            ok32 = torch.allclose(got32, want32, **float_tol[torch.float32])
            f32_line = dict(ms=time_ms(lambda: K.matmul(a32, b32, bk=512)),
                            library_ms=time_ms(lambda: torch.mm(a32, b32)),
                            **bound({"tf32": TF32X3 * 2 * m * k * n}, 4 * (m * k + k * n + m * n)))
            f32_fma = bound({"f32": 2 * m * k * n}, 4 * (m * k + k * n + m * n))["bound_ms"]
            print(f"T1_matmul {label} {shape} float32 -> float32: max_abs_err {err32:.3e} (bound "
                  f"atol 1e-4 rtol 1e-5) {'ok' if ok32 else 'FAIL'}; time {tag}: kernel "
                  f"{f32_line['ms']:.3f} ms, library (torch.mm, f32, the plain version's call) "
                  f"{f32_line['library_ms']:.3f} ms; bound {f32_line['bound_ms']:.4f} ms "
                  f"({f32_line['bound_by']}, 3xTF32), FMA bound {f32_fma:.4f} ms; "
                  f"{2 * m * k * n / (f32_line['ms'] * 1e-3) / 1e12:.1f} TFLOP/s, "
                  f"{100 * f32_line['bound_ms'] / f32_line['ms']:.1f} % of the bound", flush=True)
            check(ok32, f"T1 {label} float32 disagrees with its plain version")
            record("T1_matmul", err32)
            del a32, b32, got32, want32
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
    mark("T3")
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
    mark("F10: the block kernels at head dim 80")
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
    mark("small-input reference checks")
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
    mark("the bf16 path")
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
        note(f"{path}: recall {recalls}, launches "
             + ", ".join(f"{n.split('_')[0]} {c}" for n, c in counts.items() if c))
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
    note(f"G kernels vs plain: facet cos {fcos:.6f}, VLAD cos {vcos:.6f}")

    # ---------------------------------------------------------------- the int8_full path
    mark("the int8_full path")
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
    note(f"G kernels vs plain: facet cos {fcos8:.6f}, VLAD cos {vcos8:.6f}")

    # ---------------------------------------------------------------- block variants
    mark("block variants")
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
    mark("the T1-T3 tools")
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
    mark("the entry point")
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

        # ------------------------------------------------------------ the other entry points
        mark("the other entry points")
        other_entry_points_phase(ext, vlad, ext8, vlad8, db, qu, gt, root, work / "other", tag)

        # ------------------------------------------------------------ the other model families
        mark("the other model families")
        families = other_families_phase(db, qu, root, work / "families", tag)
        for path in ("dino_v1 entry", "clip-top-k", "patch-clip"):
            for name in PATH_KERNELS[path]:
                results[name].setdefault("family_launches", {})[path] = families[path][name]

        # ------------------------------------------------------------ the trained baselines' eval
        mark("the trained baselines' eval")
        evals = eval_phase(root, work / "eval", tag)
        for path, counts in evals.items():
            for name in PATH_KERNELS.get(path, ()):
                results[name].setdefault("eval_launches", {})[path] = counts[name]

        # ------------------------------------------------------------ training
        mark("training")
        # K5's launches under autograd in the train CLI's steps (each has one
        # backward call); its mining and validation launches are inference
        trained = train_phase(root, work / "train", tag)
        results["K5_flash_attention_qkv_proj"]["train_launches"] = trained["k5_train"]
        k5b = trained["k5_backward"]
        results["K5_flash_attention_qkv_proj"]["train_backward"] = dict(
            ms=k5b["ms"], forward_ms=k5b["forward_ms"], bound_ms=k5b["bound_ms"],
            bound_by=k5b["bound_by"])
        results["K5b_flash_attention_qkv_proj_bwd"].update(
            launches=trained["launches"]["train dvgl vit"]["K5b_flash_attention_qkv_proj_bwd"],
            **{k_: v_ for k_, v_ in k5b.items() if k_ != "forward_ms"})
        note(f"K5b {k5b['ms']:.3f} ms (plain {k5b['plain_ms']:.3f}, bound "
             f"{k5b['bound_ms']:.4f}), max err {k5b['max_abs_err']:.1e}")

        # ------------------------------------------------------------ parallel/: the mesh phase
        mark("parallel/: the mesh phase")
        import torch.distributed as dist

        from anyloc_tpu_torch.parallel.mesh import local_mesh

        mesh1 = local_mesh(1, backend="nccl")
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              "the smoke's mesh is not a one-rank NCCL group")
        meshed = mesh_phase(ext, vlad, ext8, vlad8, db, qu, mesh1, work / "mesh", tag)
        for name in PATH_KERNELS["mesh"]:
            check(meshed[name] > 0, f"{name} never launched in the mesh phase")
            results[name]["mesh_launches"] = meshed[name]
        note("launches " + ", ".join(f"{n.split('_')[0]} {meshed[n]}"
                                     for n in PATH_KERNELS["mesh"]))

        # ------------------------------------------------------------ parallel/: training
        mark("parallel/: training")
        trained_mesh = train_mesh_phase(mesh1, work / "train_mesh", tag)
        for name in PATH_KERNELS["train mesh"]:
            check(trained_mesh["counts"].get(name, 0) > 0,
                  f"{name} never launched in the training-mesh phase")
        results["K2_flash_attention"]["train_grad"] = dict(
            launches=trained_mesh["k2_tptrain"], **trained_mesh["k2_grad"])
        g2 = trained_mesh["k2_grad"]
        results["K2b_flash_attention_bwd"].update(
            launches=trained_mesh["counts"]["K2b_flash_attention_bwd"], shape=g2["shape"],
            ms=g2["backward_ms"], plain_ms=g2["plain_backward_ms"],
            library_ms=g2["library_backward_ms"], bound_ms=g2["backward_bound_ms"],
            bound_by=g2["backward_bound_by"], fma_bound_ms=g2["backward_fma_bound_ms"],
            max_abs_err=g2["max_abs_err"], spread=g2["backward_spread"],
            max_grad_err=dict(float32=g2["max_grad_err"]), memory=g2["memory"],
            library_route="torch.nn.functional.scaled_dot_product_attention's backward")
        note(f"K2b {g2['backward_ms']:.3f} ms (plain {g2['plain_backward_ms']:.3f}, SDPA "
             f"{g2['library_backward_ms']:.3f}, bound {g2['backward_bound_ms']:.4f})")
        results["K5_flash_attention_qkv_proj"]["fsdp_launches"] = trained_mesh["k5_fsdp"]
        results["K5_flash_attention_qkv_proj"]["pptrain_launches"] = trained_mesh["k5_pptrain"]

        # ------------------------------------------------------------ Kab: the attention backward
        mark("Kab, the attention backward's route table")
        routes = attention_bwd_routes_phase(tag)
        mark("F27, K2's f32 forward against float64")
        f27 = f27_line(tag)
        results["K2_flash_attention"]["f27"] = {str(n): e for n, e in f27.items()}
        mark("F28, the f32 attention backward against float64")
        f28 = f28_line(tag)
        for route in ("wgmma", "split"):
            results["Kab_attention_bwd_" + route]["f28"] = {
                k: e for k, e in f28.items() if e["route"] == route}
        mark("F29, K5's f32 projection backward and gradient against float64")
        f29 = f29_line(tag)
        results["K5b_flash_attention_qkv_proj_bwd"]["f29"] = f29["projection"]
        results["K5_flash_attention_qkv_proj"]["f29"] = dict(gradient=f29["gradient"],
                                                             optf32x3=f29["optf32x3"])
        mark("the ViT-H gradient")
        vith = vith_gradient_phase(tag)
        note("launches " + ", ".join(f"{k} {v}" for k, v in vith["counts"].items()))
        for route, r in routes["timed"].items():
            name = "Kab_attention_bwd_" + route
            # launches on the main paths: the train CLI's vit steps and the
            # training mesh (hd 64), ViT-H's gradient (hd 80)
            main = (trained["launches"]["train dvgl vit"].get(name, 0)
                    + trained_mesh["counts"].get(name, 0) + vith["counts"].get(name, 0))
            results[name].update(
                launches=main, shape=r["shape"], ms=r["ms"], plain_ms=r["plain_ms"],
                library_ms=r["library_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                max_abs_err=max(c["max_abs_err"] for c in routes["checks"] if c["route"] == route),
                checked=[c["shape"] for c in routes["checks"] if c["route"] == route],
                by_head_dim=[x for x in routes["by_head_dim"] if x["route"] == route],
                library_route="torch.nn.functional.scaled_dot_product_attention's backward")
            note(f"{route} {r['ms']:.4f} ms (plain {r['plain_ms']:.3f}, SDPA {r['library_ms']:.4f},"
                 f" bound {r['bound_ms']:.4f}), {main} launches on the main paths")
        results["Kab_attention_bwd_wgmma"]["k5_attention_half"] = k5b["halves"]["attention"]
        results["Kab_attention_bwd_wgmma"]["vit_h_gradient"] = vith["lines"]
        results["K5b_flash_attention_qkv_proj_bwd"]["projection_half"] = (
            k5b["halves"]["projection"])

        # ------------------------------------------------------------ tooling: viz
        mark("tooling: viz")
        viz_counts = tooling_phase(vlad, db + qu, work / "viz", tag)
        results["K5_flash_attention_qkv_proj"]["viz_launches"] = {
            sub: c.get("K5_flash_attention_qkv_proj", 0) for sub, c in viz_counts.items()}
        note(f"K5 launches {results['K5_flash_attention_qkv_proj']['viz_launches']}")

        # ------------------------------------------------------------ the repository's programs
        mark("the repository's programs")
        programs = repo_programs_phase(work / "programs", tag)
        k3 = results["K3_fused_mlp_int8"]
        k3["library_ms"] = programs["mlp"][485]["library_ms"]
        k3["library_route"] = ("LN, per-row quantize, torch._int_mm (w12), dequantize + SwiGLU + "
                               "requantize, torch._int_mm (w3), LayerScale + residual: a "
                               "composition of library calls (tools/bench_mlp_xla_int8.py, "
                               "[32,485,1536], its own weights)")
        for name in PATH_KERNELS["programs"]:
            check(programs["launches"].get(name, 0) > 0,
                  f"{name} never launched in the programs phase")
        for name, n in programs["launches"].items():
            results[name]["programs_launches"] = n

    # ---------------------------------------------------------------- the retrieval engines
    mark("the retrieval engines")
    retrieval_phase(tag, mesh1, profile_dir)
    dist.destroy_process_group()
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- throughput
    mark("throughput")
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
            note(f"{path} {px} px {bsz * 1000 / ms:.2f} im/s")
            if profile_dir is not None:
                profile(step, Path(profile_dir) / f"profile_{path}_{px}px_b{bsz}.txt",
                        f"{path} {px} px batch {bsz} {tag}")

    for (label, path), rate in ingest.items():
        dev_rate = device_rate[path, 308]
        print(f"ingest vs device-only {tag}: {label}: {rate:.2f} images/s with host decode, "
              f"{dev_rate:.2f} images/s with the images already on the card (throughput {path} "
              f"308 px above): {rate / dev_rate:.3f} of it", flush=True)
    print(f"card: {card}", flush=True)
    for ph in PHASES:   # each kernel's readings on its phase's summary line
        for name, r in results.items():
            if name.split("_")[0] in ph["name"].replace(",", "").split() and "ms" in r:
                ph["notes"].append(f"{name.split('_')[0]} {r['ms']:.3f} ms (plain "
                                   f"{r['plain_ms']:.3f}, bound {r['bound_ms']:.4f}), max err "
                                   f"{r['max_abs_err']:.1e}")
    return {name: {"name": name, "route": "cuda", **KERNEL_INFO[name], **r}
            for name, r in results.items()}


# the narrow streams' top-20 recall against exact search at 10,000 x 49152
# (clustered rows whose neighbours lie ~1e-4 apart). int8 rounds each row's
# scale to bf16, as the JAX package does: up to 2^-9 of every score of the
# row, far above those gaps. First set from a 2,000-row proxy on the CPU
# (bf16 0.996, int8 0.901) at 0.95 / 0.80; the card read 0.9936 / 0.7759
# at 10,000 rows, and int8's bound now sits below that reading
STREAM_RECALL_BOUND = {"bfloat16": 0.95, "int8": 0.70}


def retrieval_phase(tag: str, mesh, profile_dir=None) -> None:
    """The retrieval engines at the main path's width and at the
    compressed engines' scale, each timed (CUDA events; native: the host
    clock) and checked against exact search on the card; beside the
    device, ivf, pq and ivf_pq engines their sharded twins over the
    one-rank NCCL ``mesh``, whose results must equal theirs. With
    ``profile_dir``, torch.profiler tables of each compressed engine and
    its twin go there."""
    import numpy as np
    import torch

    from anyloc_tpu_torch import native
    from anyloc_tpu_torch.ops import ivf, ivf_pq, pq
    from anyloc_tpu_torch.ops import retrieval as R
    from anyloc_tpu_torch.parallel import distributed as sharded
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

    def same_as_single(label, search, twin, want, rate1):
        """The sharded twin's (scores, ids) against its engine's, and both
        rates, timed in the order engine (``rate1``), twin, twin, engine so
        that neither side gains from its place in the run."""
        rates = [qps(twin, nq)[0]]
        rate, got = qps(twin, nq)
        rates += [rate, qps(search, nq)[0]]
        gs, gi = (np.asarray(a) for a in got)
        ws, wi = (a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
                  for a in want)
        ids_ok = bool(np.array_equal(gi, wi))
        err = float(np.abs(gs - ws).max())
        ok = ids_ok and err <= 1e-5
        print(f"  {label} over the mesh of 1 (NCCL): {rates[0]:.1f} and {rates[1]:.1f} "
              f"queries/s against {rate1:.1f} and {rates[2]:.1f} for the engine (timed engine, "
              f"twin, twin, engine); ids equal {ids_ok}, max score difference {err:.2e} "
              f"(bound 1e-5) {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"{label}: the sharded engine disagrees with the single-device one")

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
    def search():
        return R.top_k_search(db_dev, qu_dev, k)

    rate, single = qps(search, nq)
    print(f"retrieval {tag} [{n}x{d} clustered, {nq} queries, k {k}] device: fit 0 s, "
          f"{rate:.1f} queries/s (database resident, {db_dev.numel() * 4 / 2**30:.2f} GiB)",
          flush=True)
    same_as_single("top_k_search_sharded (the resident shard)", search,
                   lambda: sharded.top_k_search_sharded(db_dev, qu_dev, k, mesh, n_valid=n),
                   single, rate)
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

    def report(label, index, fit_s, search, twin=None):
        rate, single = qps(search, nq)
        rec = overlap(single[1].cpu().numpy(), ex_i)
        print(f"retrieval {tag} [{n}x{d} pca_spectrum, {nq} queries, k {k}] {label}: fit "
              f"{fit_s:.2f} s, {rate:.1f} queries/s, top-{k} recall vs exact {rec:.4f}, index "
              f"{index_bytes(index) / 2**20:.1f} MiB", flush=True)
        if twin is not None:
            same_as_single(twin.__name__, search, twin, single, rate)
            if profile_dir is not None:
                for fn, name in ((search, "engine"), (twin, "twin")):
                    profile(fn, Path(profile_dir) / f"retrieval_{twin.__name__}_{name}.txt",
                            f"{label} {name} ({nq} queries)")

    def exact_over(rows_dev, method_q, label, got):
        want_s, want_i = R.top_k_search(rows_dev, method_q, k + 1)
        same_as_exact(label, got[0].cpu().numpy(), got[1].cpu().numpy(),
                      want_s.cpu().numpy(), want_i.cpu().numpy())

    index, fit_s = fitted("ivf", lambda: ivf.ivf_fit(db, device=dev))
    def ivf_search_sharded():
        return sharded.ivf_search_sharded(index, qu, k, mesh, n_probe=n_probe)

    report(f"ivf ({index.n_cells} cells) n_probe {n_probe}", index, fit_s,
           lambda: index.search(qu, k, n_probe=n_probe), ivf_search_sharded)
    exact_over(db_dev, qu_dev[:n_chk], "ivf at full probe vs exact",
               index.search(qu[:n_chk], k, n_probe=index.n_cells))
    del index
    index, fit_s = fitted("pq", lambda: pq.pq_fit(db, 64, method="cosine", device=dev))
    def pq_search_sharded():
        return sharded.pq_search_sharded(index, qu, k, mesh)

    for scan in ("tables", "decode"):
        report(f"pq64 {scan} (f32 scores)", index, fit_s,
               lambda: index.search(qu, k, scan=scan),
               pq_search_sharded if scan == "decode" else None)
    m = index.m
    xhat = index.codebooks[torch.arange(m, device=dev)[None], index.codes.long()].reshape(n, d)
    for scan in ("tables", "decode"):
        exact_over(xhat, qu_dev[:n_chk], f"pq {scan} vs exact over decode()",
                   index.search(qu[:n_chk], k, scan=scan))
    del index, xhat
    index, fit_s = fitted("ivf_pq", lambda: ivf_pq.ivf_pq_fit(db, m=64, device=dev))
    def ivf_pq_search_sharded():
        return sharded.ivf_pq_search_sharded(index, qu, k, mesh, n_probe=n_probe)

    report(f"ivf_pq64 ({index.n_cells} cells) n_probe {n_probe}", index, fit_s,
           lambda: index.search(qu, k, n_probe=n_probe), ivf_pq_search_sharded)
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


def run_cli(label: str, cmd: str, root: Path, extra, out: Path, path: str,
            dim: int = 32 * 1536, args=ENTRY_ARGS) -> dict:
    """``python -m anyloc_tpu_torch <cmd> <args> <extra>`` on the dataset
    root through ``cli.main`` with no device named, launch counts reset
    just before and read just after; the search must run on the card
    (F11) and the results JSON be complete, with ``dim``-wide
    descriptors. Returns the launch counts and the wall seconds."""
    from anyloc_tpu_torch import cli
    from anyloc_tpu_torch.ops import kernels as K
    from anyloc_tpu_torch.ops import retrieval

    searched = []
    search = retrieval.top_k_search

    def spy(db, qu, k, *a, **kw):
        searched.append(db.device.type)
        return search(db, qu, k, *a, **kw)

    argv = [cmd, *args, *extra, "--prog.data-vg-dir", str(root),
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
    check(res["VLAD-Dim"] == str(dim) and res["Num-DB"] == "16" and res["Num-QU"] == "8",
          f"cli {label}: {res}")
    check(all(0.0 <= res[f"R@{k}"] <= 1.0 for k in (1, 5, 10)), f"cli {label}: recalls {res}")
    check(searched == ["cuda"], f"cli {label}: top-k ran on {searched}, not the card")
    for name in PATH_KERNELS[path]:
        check(counts[name] > 0, f"{name} never launched in the cli {label} run")
    recalls = {k: res[f"R@{k}"] for k in (1, 5, 10)}
    print(f"entry point {label}: python -m anyloc_tpu_torch {cmd} {' '.join(list(args) + extra)} "
          f"(17places 16 db + 8 queries, {res['Agg-Method']}, vocabulary "
          f"{res.get('Global-Vocab', '17places db' if res['Agg-Method'] == 'VLAD' else 'none')}): "
          f"rc 0 in {seconds:.1f} s (model build included), VLAD-Dim {res['VLAD-Dim']}, recall "
          f"(random weights, not asserted) {recalls}, top-k on {searched[0]}, results JSON "
          f"{saved[0].name}; {len(log.getvalue().splitlines())} progress lines; launch counts "
          f"{counts}", flush=True)
    return dict(counts=counts, seconds=seconds)


def other_entry_points_phase(ext, vlad, ext8, vlad8, db, qu, gt, root: Path, work: Path,
                             tag: str) -> None:
    """The other entry points at DINOv2-G/14 layer 31 value, each through
    what a user calls, with no device named: the demo at 1022 px, the
    serving daemon at 308 px, the gem / gp / global-vpr pipelines and a
    sweep over the 17places tree at 320 -> 308 px. Each sub-phase prints
    its wall seconds."""
    t0 = time.perf_counter()
    demo_phase(ext, vlad, ext8, vlad8, db, work / "demo", tag)
    t1 = time.perf_counter()
    serve_phase(ext8, vlad8, db, qu, gt, work / "serve", tag)
    t2 = time.perf_counter()
    for label, cmd, extra, path in (
            ("gem_int8_full", "gem",
             ["--extractor.quant", "int8_full", "--extractor.transfer-dtype", "uint8"],
             "gem int8_full"),
            ("gp_bf16", "gp", [], "gp bf16"),
            ("global_vpr_bf16", "global-vpr", [], "global-vpr bf16")):
        run_cli(label, cmd, root, extra, work / "results", path, dim=1536)
    t3 = time.perf_counter()
    sweep_phase(root, work / "sweep")
    t4 = time.perf_counter()
    print(f"other entry points, wall seconds: demo {t1 - t0:.1f}, serve {t2 - t1:.1f}, "
          f"gem + gp + global-vpr {t3 - t2:.1f}, sweep {t4 - t3:.1f}, total {t4 - t0:.1f}",
          flush=True)


def other_families_phase(db, qu, root: Path, work: Path, tag: str) -> dict:
    """The other model families through what a user calls, no device
    named: ``global-vocab-vlad`` with DINO v1 ViT-B/8 (layer 9 key, stride
    4, 224 px: K1 + K2), ``clip-top-k`` and ``patch-clip`` with CLIP
    ViT-L/14@336px at full depth in float32 (K5; K1 + K5), CLIP-L's
    images/s, its zero-shot call, ``trivial_clip_vpr`` over the fixture's
    JPEGs; then one ``make_extractor`` forward of each other family at its
    published width and depth (random weights drawn on the card), and each
    family's small float32 trunk on the card (kernels) against the CPU
    (plain versions). Returns the CLI runs' launch counts by path."""
    import numpy as np
    import torch
    from PIL import Image

    from anyloc_tpu_torch import make_extractor
    from anyloc_tpu_torch.models.clip import ClipWrapper, SimpleTokenizer
    from anyloc_tpu_torch.ops import kernels as K
    from anyloc_tpu_torch.pipelines.extras import trivial_clip_vpr
    from anyloc_tpu_torch.tools import family_checks
    from anyloc_tpu_torch.tools._timing import time_ms

    dev = torch.device("cuda")
    check(torch.backends.cudnn.allow_tf32, "family phase: cuDNN's TF32 flag is not the default")
    t0 = time.perf_counter()
    launches = {}
    launches["dino_v1 entry"] = run_cli("dino_v1_vitb8", "global-vocab-vlad", root, [],
                                        work / "results", "dino_v1 entry", dim=32 * 768,
                                        args=DINO_V1_ARGS)["counts"]
    for label, cmd, dim in (("clip_top_k", "clip-top-k", 768), ("patch_clip", "patch-clip", 32 * 768)):
        launches[cmd] = run_cli(label, cmd, root, [], work / "results", cmd, dim=dim,
                                args=CLIP_ARGS)["counts"]
    # the first CLIP run pays the float32 route's first use on the card; a
    # second one is the steady wall time
    again = run_cli("clip_top_k_again", "clip-top-k", root, [], work / "results", "clip-top-k",
                    dim=768, args=CLIP_ARGS)
    print(f"clip-top-k again {tag}: 24 images (16 db + 8 queries, PIL decode, model build "
          f"included) in {again['seconds']:.2f} s: {24 / again['seconds']:.2f} images/s", flush=True)
    t1 = time.perf_counter()

    # CLIP-L/14@336px: images/s of the vision tower (f32, images on the
    # card), a zero-shot call through the tokenizer, trivial_clip_vpr
    m = ClipWrapper(ClipWrapper.IMPL_OPENAI, "ViT-L/14@336px", use_caching=False)
    x = torch.randn(32, 336, 336, 3, device=dev)
    ms = time_ms(lambda: m.encode_image(x), iters=5, reps=3)
    print(f"CLIP ViT-L/14@336px vision tower {tag}: float32, 24 blocks x 1024, 577 tokens, batch "
          f"32, images on the card: {ms:.2f} ms/batch, {32000 / ms:.2f} images/s", flush=True)
    m.tokenizer = SimpleTokenizer(str(ROOT / "tests" / "fixtures" / "bpe" / "merges.txt"),
                                  vocab=49408)
    check(bool(m.tokenizer.bpe), "the BPE fixture did not load into the CLIP-L tokenizer")
    prompts = ["a photo of a street", "a building at night", "the sea"]
    probs, imf, txf = m(x[:2], prompts, normalize=True)
    check(tuple(probs.shape) == (2, 3) and bool(torch.isfinite(probs).all())
          and abs(probs.sum(-1) - 1).max().item() <= 1e-5, f"zero-shot probs {probs}")
    print(f"CLIP zero-shot: tokenizer = the BPE fixture tests/fixtures/bpe "
          f"({len(m.tokenizer.bpe_ranks)} merges, SOT {m.tokenizer.SOT}, EOT {m.tokenizer.EOT}), "
          f"{len(prompts)} prompts x 2 images -> probs {tuple(probs.shape)}, rows sum to 1",
          flush=True)
    prep = m.get_preprocessing(disable_prep=False)
    files = list(db) + list(qu)
    descs, labels = trivial_clip_vpr(
        files, lambda f: m.encode_image(prep(Image.open(f).convert("RGB")), normalize=True),
        n_clusters=3, save_dir=str(work / "trivial_clip_vpr"))
    check(descs.shape == (len(files), 768) and len(labels) == len(files)
          and bool(np.isfinite(descs).all()), f"trivial_clip_vpr: {descs.shape} {len(labels)}")
    print(f"trivial_clip_vpr: {len(files)} fixture JPEGs -> descriptors {descs.shape}, cluster "
          f"sizes {np.bincount(labels).tolist()}, images copied per cluster", flush=True)
    del m, x
    torch.cuda.empty_cache()
    t2 = time.perf_counter()

    # one forward of each other family at its published width and depth
    for name, (b, px, want) in FAMILY_FORWARDS.items():
        tb = time.perf_counter()
        ext = make_extractor(name)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - tb
        x = torch.randn(b, px, px, 3, device=dev)
        K.reset_launch_counts()
        out = ext(x)
        torch.cuda.synchronize()
        counts = {k: v for k, v in K.launch_counts().items() if v}
        check(out.dim() == 3 and out.shape[0] == b and bool(torch.isfinite(out).all())
              and abs(out.norm(dim=-1) - 1).max().item() <= 1e-3, f"{name}: output {out.shape}")
        for kname in want:
            check(counts.get(kname, 0) > 0, f"{name}: {kname} never launched")
        if not want:
            check(not counts, f"{name}: launched {counts}, its attention is plain")
        ms = time_ms(lambda: ext(x))
        cfg = getattr(ext, "cfg", None)
        print(f"family {name} {tag}: full depth, batch {b} at {px} px, descriptors "
              f"{tuple(out.shape)}, random init on the card {build_s:.1f} s, forward {ms:.2f} ms "
              f"({b * 1000 / ms:.2f} images/s), dtype {getattr(cfg, 'dtype', '?')}, kernels "
              f"launched {counts or 'none (plain attention)'}", flush=True)
        del ext, x, out
        torch.cuda.empty_cache()
    t3 = time.perf_counter()
    for family in family_checks.FAMILIES:   # each family's small trunk, card vs CPU
        r = family_checks.compare(family)
        print(family_checks.line(r), flush=True)
        check(r["ok"], f"family card vs CPU: {r['what']}")
    t4 = time.perf_counter()
    print(f"other model families, wall seconds: entry points {t1 - t0:.1f}, CLIP-L rate + zero-shot "
          f"+ trivial_clip_vpr {t2 - t1:.1f}, family forwards {t3 - t2:.1f}, card vs CPU "
          f"{t4 - t3:.1f}, total {t4 - t0:.1f}", flush=True)
    return launches


def torchvision_resnet(sd: dict, prefix: str = "backbone.") -> dict:
    """The port's ResNet state dict (under ``prefix``) in torchvision's
    naming: BatchNorm out of its ``bn``, the downsample pair as
    ``downsample.0`` / ``.1``."""
    out = {}
    for k, v in sd.items():
        if k.startswith(prefix):
            k = (k[len(prefix):].replace(".bn.", ".").replace("downsample_conv", "downsample.0")
                 .replace("downsample_bn", "downsample.1"))
            out[k] = v.clone()
    return out


def release_checkpoint(label: str, model, path: Path) -> Path:
    """``model``'s weights as its release would hold them: dvgl a
    torchvision ResNet ``.pth`` (the CLI grafts it into its random init),
    MixVPR the lightning ``.ckpt`` (``backbone.model.*``, the mixer as
    ``aggregator.mix.{i}.mix.{0,1,3}``), CosPlace its Sequential ``.pth``
    (``backbone.{i}.*``, ``aggregation.1.p`` and ``.3``); the vit backbone
    the port's own ``save_checkpoint`` file."""
    import torch

    from anyloc_tpu_torch.utils.checkpoint import save_checkpoint

    sd = model.state_dict()
    if label == "eval dvgl vit":
        save_checkpoint(str(path.parent), {"params": sd}, False, path.name)
        return path
    if label == "eval dvgl resnet18conv4":
        torch.save(torchvision_resnet(sd), path)
    elif label == "eval mixvpr":
        rel = {f"backbone.model.{k}": v for k, v in torchvision_resnet(sd).items()}
        for k, v in sd.items():
            if k.startswith("aggregator.mixer."):
                _, _, i, name, kind = k.split(".")
                rel[f"aggregator.mix.{i}.mix.{dict(norm=0, mix1=1, mix2=3)[name]}.{kind}"] = v
            elif k.startswith("aggregator."):
                rel[k] = v
        torch.save({"state_dict": rel}, path)
    else:
        idx = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5", "layer3": "6",
               "layer4": "7"}
        rel = {}
        for k, v in torchvision_resnet(sd).items():
            head, rest = k.split(".", 1)
            rel[f"backbone.{idx[head]}.{rest}"] = v
        rel["aggregation.1.p"] = sd["aggregator.p"].reshape(1).clone()
        rel["aggregation.3.weight"] = sd["aggregator.fc.weight"].clone()
        rel["aggregation.3.bias"] = sd["aggregator.fc.bias"].clone()
        torch.save(rel, path)
    return path


def run_eval(label: str, root: Path, out: Path, extra=()) -> dict:
    """``python -m anyloc_tpu_torch eval`` on the 17places tree through
    ``cli.main`` with no device named, launch counts reset just before and
    read just after; the search must run on the card (F11). Returns the
    recalls, the saved descriptors, the launch counts and the wall
    seconds."""
    import numpy as np

    from anyloc_tpu_torch import cli
    from anyloc_tpu_torch.ops import kernels as K
    from anyloc_tpu_torch.ops import retrieval
    from anyloc_tpu_torch.training import evaluate

    flags, dim = EVAL_RUNS[label]
    descs = out / f"{label.replace(' ', '_')}{'_ckpt' if extra else ''}"
    argv = ["eval", *flags, "--dataset", "17places", "--datasets-folder", str(root),
            "--save-descs", str(descs), *extra]
    searched = []
    search = evaluate.top_k_search

    def spy(db, qu, k, *a, **kw):
        searched.append(db.device.type)
        return search(db, qu, k, *a, **kw)

    evaluate.top_k_search = spy
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()) as log:
            rc = cli.main(argv)
    finally:
        evaluate.top_k_search = search
    seconds = time.perf_counter() - t0
    counts = K.launch_counts()
    check(rc == 0, f"{label} returned {rc}")
    recalls = json.loads(log.getvalue().strip().splitlines()[-1])
    check(set(recalls) == {"R@1", "R@5", "R@10", "R@20"}
          and all(0.0 <= r <= 100.0 for r in recalls.values()), f"{label}: recalls {recalls}")
    check(searched == ["cuda"], f"{label}: top-k ran on {searched}, not the card")
    d = np.load(f"{descs}.npy")
    check(d.shape == (24, dim) and bool(np.isfinite(d).all())
          and float(np.abs(np.linalg.norm(d, axis=1) - 1).max()) <= 1e-4,
          f"{label}: descriptors {d.shape}")
    for name in PATH_KERNELS[label]:
        check(counts[name] > 0, f"{name} never launched in the {label} run")
    return dict(recalls=recalls, descs=d, counts=counts, seconds=seconds,
                line=f"python -m anyloc_tpu_torch {' '.join(argv[:1] + list(flags) + list(extra))}")


def eval_phase(root: Path, work: Path, tag: str) -> dict:
    """The trained baselines through what a user calls, no device named:
    ``python -m anyloc_tpu_torch eval`` for dvgl resnet18conv4 + NetVLAD-64
    at 480x640, dvgl vit + NetVLAD-64 at 224 px (K5), MixVPR (ResNet-50
    conv4, 1024 x 4 mixer, 320 px) and CosPlace (ResNet-50, GeM + fc 512),
    each from its random init, then again from a checkpoint of the same
    weights in its release layout (descriptors bit-equal); the eval rate
    on the card alone and with PIL decode; then one float32 forward of each
    network at full width and depth held card vs CPU (VGG-16, AlexNet,
    CCT-14/7x2, EfficientNet-b0 / b7, SwinV2-B, CRN and RRM on ResNet-18
    conv4, ImageBind-H's five towers: K5 in its vision tower), cuDNN's
    TF32 flag at PyTorch's default (F17). Returns the CLI runs' launch
    counts by path."""
    import numpy as np
    import torch

    from anyloc_tpu_torch.data.registry import get_dataset
    from anyloc_tpu_torch.tools import family_checks
    from anyloc_tpu_torch.tools._timing import time_ms
    from anyloc_tpu_torch.training.evaluate import extract_features

    check(torch.backends.cudnn.allow_tf32, "eval phase: cuDNN's TF32 flag is not the default")
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    launches = {}
    for label in EVAL_RUNS:
        r = run_eval(label, root, work)
        # the in-memory model of that run (the CLI's random init, seed 0),
        # written in the release layout, read back through --checkpoint
        model = eval_model(label)
        ckpt = release_checkpoint(label, model, work / EVAL_CHECKPOINTS[label])
        r2 = run_eval(label, root, work, ["--checkpoint", str(ckpt)])
        same = bool(np.array_equal(r["descs"], r2["descs"]))
        check(same and r2["recalls"] == r["recalls"],
              f"{label}: --checkpoint descriptors differ from the in-memory model's "
              f"(max {np.abs(r['descs'] - r2['descs']).max():.3e})")
        launches[label] = r["counts"]
        k5 = "K5_flash_attention_qkv_proj"
        print(f"eval {tag}: {r['line']} (17places 16 db + 8 queries, random init seed 0): rc 0 in "
              f"{r['seconds']:.2f} s wall (model build + PIL decode included), descriptors "
              f"{r['descs'].shape}, recalls (random weights, not asserted) {r['recalls']}, top-k "
              f"on cuda; K5 launches {r['counts'][k5]}; again from its release-layout checkpoint "
              f"{ckpt.name} in {r2['seconds']:.2f} s: descriptors bit-equal", flush=True)
    t1 = time.perf_counter()

    # the eval rate of dvgl resnet18conv4 + NetVLAD-64 at 480x640: the card
    # alone (a batch of 16 already on it) and with PIL decode (the
    # dataset's 24 images through extract_features)
    dev = torch.device("cuda")
    model = eval_model("eval dvgl resnet18conv4").to(dev)
    x = torch.randn(16, 480, 640, 3, device=dev)
    with torch.inference_mode():
        ms = time_ms(lambda: model(x), iters=5, reps=3)
    ds = get_dataset("17places", str(root), "test", img_size=(480, 640))

    @torch.inference_mode()
    def desc_fn(imgs):
        return model(torch.as_tensor(np.asarray(imgs, np.float32)).to(dev))

    extract_features(desc_fn, ds, batch_size=16)
    torch.cuda.synchronize()
    tb = time.perf_counter()
    extract_features(desc_fn, ds, batch_size=16)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - tb
    print(f"eval rate {tag}: dvgl resnet18conv4 + NetVLAD-64 at 480x640, float32: "
          f"{ms:.2f} ms per batch of 16 on the card, {16000 / ms:.2f} images/s (device only); "
          f"{24 / decode_s:.2f} images/s with PIL decode ({ds.decoder()}, 24 images through "
          f"extract_features, batch 16)", flush=True)
    del model, x
    torch.cuda.empty_cache()
    t2 = time.perf_counter()

    for name, batch in EVAL_NETWORKS.items():
        check(torch.backends.cudnn.allow_tf32, "cuDNN's TF32 flag changed during the phase")
        r = family_checks.compare_network(name, batch=batch)
        print(family_checks.network_line(r).replace("network card", f"network {tag} card"),
              flush=True)
        check(r["ok"], f"network card vs CPU: {r['what']}")
        if name == "imagebind_huge":
            launches["imagebind_huge"] = r["counts"]
    t3 = time.perf_counter()
    print(f"trained baselines' eval, wall seconds: eval CLI runs {t1 - t0:.1f}, eval rate "
          f"{t2 - t1:.1f}, networks card vs CPU {t3 - t2:.1f}, total {t3 - t0:.1f}", flush=True)
    return launches


# the train phase's runs: label -> the train CLI's flags beyond the shared
# ones (dvgl's defaults: batch 4 tuples of 1 + 1 + 10 images, Adam at lr
# 1e-5, partial mining, NetVLAD-64). The loss is dvgl's SARE-ind: the
# fixture's queries are near-copies of their positives, so at a random init
# every triplet clears the triplet loss's 0.1 margin, its loss is 0 and
# nothing would train; SARE-ind never vanishes
TRAIN_RUNS = {
    "train dvgl resnet18conv4": ["--netvlad-init-samples", "1024"],
    "train dvgl vit": ["--backbone", "vit", "--resize", "224", "224"],
}
TRAIN_ARGS = ["--dataset", "17places", "--queries-per-epoch", "8", "--cache-refresh-every", "8",
              "--epochs", "2", "--criterion", "sare_ind"]


def run_train(flags, root: Path, out: Path) -> dict:
    """``python -m anyloc_tpu_torch train`` on the 17places tree through
    ``cli.main`` with no device named, launch counts reset just before
    and read just after, K5's forward launches and backward calls timed
    inside (``train_checks.k5_step_times``); the loop's returned state
    and starting parameters kept. Root logging and sys.excepthook, which
    the CLI sets, are put back."""
    import logging

    from anyloc_tpu_torch import cli
    from anyloc_tpu_torch.ops import kernels as K
    from anyloc_tpu_torch.tools import train_checks
    from anyloc_tpu_torch.training import train_loop

    argv = ["train", *TRAIN_ARGS, *flags, "--datasets-folder", str(root), "--output-dir", str(out)]
    kept = {}
    real = train_loop.train_triplet

    def spy(descriptor_fn, init_params, *a, **kw):
        kept["start"] = {k: v.detach().clone() for k, v in init_params.items()}
        kept["state"], _, kept["history"] = result = real(descriptor_fn, init_params, *a, **kw)
        return result

    root_log = logging.getLogger()
    handlers, level, hook = list(root_log.handlers), root_log.level, sys.excepthook
    train_loop.train_triplet = spy
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with train_checks.k5_step_times() as k5:
            rc = cli.main(argv)
    finally:
        train_loop.train_triplet = real
        for h in root_log.handlers:
            h.close()
        root_log.handlers[:] = handlers
        root_log.setLevel(level)
        sys.excepthook = hook
    seconds = time.perf_counter() - t0
    counts = K.launch_counts()
    check(rc == 0, f"python -m anyloc_tpu_torch {' '.join(argv)} returned {rc}")
    return dict(counts=counts, seconds=seconds, k5=k5, argv=argv, **kept)


def train_phase(root: Path, work: Path, tag: str) -> dict:
    """Training through what a user calls, no device named: ``python -m
    anyloc_tpu_torch train`` for dvgl resnet18conv4 + NetVLAD-64 at
    480x640 (with NetVLAD's k-means init) and the vit backbone + NetVLAD-64
    at 224 px (K5 in every block of every step, with its gradient through
    its backward kernels, F18),
    each 2 epochs of 8 queries, then again with --resume (its starting
    parameters bit-equal to the saved ones); a few CosPlace CosFace steps
    (ResNet-50, GeM + fc 512, 512x512, batch 32, one group's head); each
    path's step time, tuples/s and images/s, and K5's forward and backward
    ms inside the vit step; one step's gradients card vs CPU for both dvgl
    models, resnet18conv4's convolutions' backward card vs CPU (and with
    F17b planted, which must fail), K5's gradient against its plain
    version's at [48, 197, 2304] float32 and bfloat16 (F18) and its
    backward kernels timed. Returns the launch counts by path, K5's
    training launches and its backward's record."""
    import functools

    import numpy as np
    import torch

    from anyloc_tpu_torch.models.convert import materialize
    from anyloc_tpu_torch.ops import kernels as K
    from anyloc_tpu_torch.tools import train_checks
    from anyloc_tpu_torch.tools._timing import time_ms
    from anyloc_tpu_torch.training import cosplace
    from anyloc_tpu_torch.training.mixvpr import VPRModel
    from anyloc_tpu_torch.training.network import GeoLocalizationNet
    from anyloc_tpu_torch.training.triplet import make_triplet_train_step
    from anyloc_tpu_torch.utils.checkpoint import load_checkpoint

    check(torch.backends.cudnn.allow_tf32, "train phase: cuDNN's TF32 flag is not the default")
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    launches, k5_train = {}, {}
    k5 = "K5_flash_attention_qkv_proj"
    for label in TRAIN_RUNS:
        out = work / label.replace(" ", "_")
        flags = TRAIN_RUNS[label]
        r = run_train(flags, root, out)
        losses = [h["loss"] for h in r["history"]]
        check(len(losses) == 2 and all(np.isfinite(x) for x in losses),
              f"{label}: losses {losses}")
        check((out / "best_checkpoint").is_file() and (out / "last_checkpoint").is_file(),
              f"{label}: checkpoints {sorted(p.name for p in out.iterdir())}")
        saved = load_checkpoint(str(out / "last_checkpoint"))
        moved = [k for k, v in saved["params"].items()
                 if not torch.equal(v, r["start"][k].cpu())]
        check(any(k.startswith("backbone.") for k in moved)
              and any(k.startswith("aggregation.") for k in moved),
              f"{label}: parameters that moved {moved[:5]}")
        params = r["state"].params
        grads = {}
        if "vit" in label:
            for name in ("backbone.patch_embed.proj.weight", "backbone.blocks.0.attn.qkv.weight"):
                g = params[name].grad
                grads[name] = 0.0 if g is None else g.abs().max().item()
            check(all(v > 0 for v in grads.values()), f"{label}: F18 gradients {grads}")
            check(r["k5"]["bwd"] > 0 and r["counts"][k5] > r["k5"]["bwd"],
                  f"{label}: K5 launches {r['counts'][k5]}, backward calls {r['k5']['bwd']}")
            k5_train[label] = r["k5"]["bwd"]
        for name in PATH_KERNELS[label]:
            check(r["counts"][name] > 0, f"{name} never launched in the {label} run")
        launches[label] = r["counts"]
        # --resume: the next run starts from the saved parameters, bit for bit
        # (without --netvlad-init-samples, which would k-means NetVLAD again, F20)
        resume = list(flags)
        if "--netvlad-init-samples" in resume:
            i = resume.index("--netvlad-init-samples")
            del resume[i:i + 2]
        r2 = run_train(resume + ["--resume", "--epochs", "1"], root, out)
        same = r2["start"].keys() == saved["params"].keys() and all(
            torch.equal(v.cpu(), saved["params"][k]) for k, v in r2["start"].items())
        check(same, f"{label}: the resumed run did not start from the saved parameters")
        print(f"train {tag}: python -m anyloc_tpu_torch {' '.join(r['argv'][:-4])} (17places "
              f"16 db + 8 queries, random init seed 42): rc 0 in {r['seconds']:.1f} s wall "
              f"(model build, mining, PIL decode and 2 validations included), epoch losses "
              f"{[round(x, 6) for x in losses]}, recalls (not asserted) "
              f"{[h['recalls'] for h in r['history']]}, {len(moved)} tensors moved, "
              f"best_checkpoint written; launch counts {r['counts']}"
              + (f"; K5 train launches {r['k5']['bwd']} (backward calls), |grad| max at the "
                 f"patch embedding and block 0 qkv {grads}" if grads else "")
              + f"; --resume run rc 0 in {r2['seconds']:.1f} s, its starting parameters "
              f"bit-equal to the saved ones", flush=True)
    t1 = time.perf_counter()

    # one step's time at full width on tensors already on the card
    dev = torch.device("cuda")
    rates = {}
    for label, (backbone, (h, w)) in {"dvgl resnet18conv4": ("resnet18conv4", (480, 640)),
                                      "dvgl vit": ("vit", (224, 224))}.items():
        model = materialize(lambda: GeoLocalizationNet(backbone, "netvlad", 64, img_size=h),
                            None, "cuda", seed=0)
        params = {**dict(model.named_parameters()), **dict(model.named_buffers())}
        step = make_triplet_train_step(
            train_checks.descriptor_fn(model),
            functools.partial(torch.optim.Adam, lr=1e-5, betas=(0.9, 0.999), eps=1e-8))
        state = step.init_state(params)
        tuples = torch.randn(4, 12, h, w, 3, device=dev)
        holder = [state]

        def one():
            holder[0], loss = step(holder[0], tuples)
            return loss

        ms = time_ms(one, iters=3, reps=2, warmup=1)
        with train_checks.k5_step_times() as k5t:
            one()
        loss = one().item()
        check(np.isfinite(loss), f"train step {label}: loss {loss}")
        extra = ""
        if backbone == "vit":
            extra = (f"; K5 inside the step: {k5t['fwd']} forward launches "
                     f"{k5t['fwd_ms']:.3f} ms, {k5t['bwd']} backward calls {k5t['bwd_ms']:.3f} ms "
                     f"(CUDA events around each)")
            rates["k5"] = k5t
        rates[label] = ms
        print(f"train step {tag}: {label} + NetVLAD-64 at {h}x{w}, float32, Adam, batch 4 "
              f"tuples of 1 + 1 + 10 images: {ms:.2f} ms/step, {4000 / ms:.2f} tuples/s, "
              f"{48000 / ms:.2f} images/s{extra}", flush=True)
        del model, params, state, holder, step
        torch.cuda.empty_cache()

    # CosPlace: a few CosFace steps at full width, one group's classifier
    rng = np.random.default_rng(0)
    groups, classes, labels_all = cosplace.assign_classes(rng.uniform(0, 60, 4096),
                                                          rng.uniform(0, 60, 4096),
                                                          rng.uniform(0, 360, 4096))
    g = int(np.argmax([len(x) for x in groups]))
    idx = groups[g][:32]
    labels = torch.from_numpy(labels_all[idx]).to(dev)
    model = materialize(lambda: VPRModel("resnet50", "cosplace", {"in_dim": 2048, "out_dim": 512},
                                         layers_to_crop=(), input_hw=(512, 512)), None, "cuda",
                        seed=0)
    head = materialize(lambda: cosplace.MarginCosineProduct(len(classes[g]), in_dim=512), None,
                       "cuda", seed=1)
    step = cosplace.make_cosplace_train_step(
        train_checks.descriptor_fn(model), head,
        functools.partial(torch.optim.Adam, lr=1e-5), functools.partial(torch.optim.Adam, lr=1e-2))
    cstate = [step.init_state({**dict(model.named_parameters()), **dict(model.named_buffers())},
                              dict(head.named_parameters()))]
    start = cstate[0].classifier_params["weight"].detach().clone()
    images = torch.randn(32, 512, 512, 3, device=dev)
    closses = []

    def cstep():
        cstate[0], loss = step(cstate[0], images, labels)
        closses.append(loss)

    cms = time_ms(cstep, iters=3, reps=2, warmup=1)
    closses = [x.item() for x in closses]
    check(all(np.isfinite(closses)) and cstate[0].step == len(closses)
          and not torch.equal(start, cstate[0].classifier_params["weight"].detach()),
          f"CosPlace steps: losses {closses}")
    print(f"train step {tag}: CosPlace ResNet-50 + GeM + fc 512 at 512x512, float32, batch 32, "
          f"one group's CosFace head ({len(classes[g])} classes, s 30, m 0.4), Adam 1e-5 / 1e-2: "
          f"{cms:.2f} ms/step, {32000 / cms:.2f} images/s; {len(closses)} steps, losses "
          f"{closses[0]:.4f} -> {closses[-1]:.4f}", flush=True)
    del model, head, step, cstate, images
    torch.cuda.empty_cache()
    t2 = time.perf_counter()

    # gradients card vs CPU, and K5's gradient against its plain version's
    for backbone in ("resnet18conv4", "vit"):
        r = train_checks.compare_step(backbone)
        print(train_checks.step_line(r).replace("train step card", f"train step {tag} card"),
              flush=True)
        check(r["ok"], f"train step card vs CPU: {backbone}")
        check(torch.backends.cudnn.allow_tf32, "cuDNN's TF32 flag changed during the phase")
    r = train_checks.compare_convs("resnet18conv4")
    print(train_checks.convs_line(r).replace("conv backward card", f"conv backward {tag} card"),
          flush=True)
    check(r["ok"], "F17b: a convolution's backward on the card disagrees with the CPU's")
    with train_checks.planted_tf32_backward():
        planted = train_checks.compare_convs("resnet18conv4")
    print(f"conv backward {tag}, F17b planted (the backward outside ieee_convolutions): "
          f"largest max|err| / max|g| {planted['worst']:.3e} ({planted['worst_name']}), "
          f"{planted['worst'] / max(r['worst'], 1e-30):.1f}x the real one's; must exceed the bound",
          flush=True)
    check(not planted["ok"], "the conv check does not see F17b's TF32 backward")
    grad_errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        r = train_checks.k5_gradient(48, 197, 12, 64, dtype, layerscale=dtype == torch.bfloat16)
        errs = ", ".join(f"{k} {v:.3e}" for k, v in r["grad_errs"].items())
        held = (f"bound {train_checks.BOUND:.0e}" if dtype == torch.float32 else
                f"beyond one bf16 step, bound {train_checks.BF16_BOUND:.1e} (without the step "
                + ", ".join(f"{k} {v:.3e}" for k, v in r["raws"].items())
                + "); L2 distance from float64 over the plain autograd's "
                + ", ".join(f"{k} {v:.3f}" for k, v in r["ratios"].items())
                + f", bound {train_checks.BF16_RATIO}; {' and '.join(train_checks.READ_O)} "
                "against the plain backward on the kept o, which with lse and pre is held to "
                "values from the inputs: " + ", ".join(f"{k} {v:.3e}" for k, v in
                                                       r["saved"].items())
                + f" (bounds lse {train_checks.LSE_BOUND:.0e}, o {train_checks.BF16_BOUND:.1e}, "
                f"pre {train_checks.BOUND:.0e})")
        print(f"K5 gradient {tag} qkv {list(r['shape'])} {r['dtype']} (forward kernel, backward "
              f"kernels{', LayerScale' if dtype == torch.bfloat16 else ''}): max|err| / max|g| "
              f"{errs} ({held}); output {r['out_err']:.3e}, bit-equal without autograd "
              f"{r['bit_equal']}; launches forward {r['launched']}, backward "
              f"{r['bwd_launched']}; grad_fn {r['grad_fn']}", flush=True)
        check(r["ok"], f"K5's {r['dtype']} gradient disagrees with its plain version's")
        grad_errs[r["dtype"]] = r["worst"]
    # K5's backward alone at the step's shape, the kernels beside the plain
    # version's autograd; bounds: five attention products (S, dP, dV, dK,
    # dQ) and two projection GEMMs (d_o, d_W), f32, as three tf32 products
    # each or at the FMA peak, or the bytes
    b, n, h, hd = 48, 197, 12, 64
    d, m = h * hd, 48 * 197
    inputs = train_checks.k5_inputs(b, n, h, hd)
    wanted = [t for t in inputs.values() if t is not None]
    out = K.flash_attention_qkv_proj(num_heads=h, **inputs)
    ref = K.flash_attention_qkv_proj_ref(num_heads=h, **inputs)
    gout = torch.randn_like(out)
    first = torch.autograd.grad(out, wanted, gout, retain_graph=True)
    again = torch.autograd.grad(out, wanted, gout, retain_graph=True)
    spread = max((a - c).abs().max().item() for a, c in zip(first, again))
    max_abs = max((a - w).abs().max().item() for a, w in zip(
        first, torch.autograd.grad(ref, wanted, gout, retain_graph=True)))
    bwd_ms, plain_ms = turns(
        lambda: torch.autograd.grad(out, wanted, gout, retain_graph=True),
        lambda: torch.autograd.grad(ref, wanted, gout, retain_graph=True))
    fwd_ms = time_ms(lambda: K.flash_attention_qkv_proj(num_heads=h, **inputs).detach(),
                     iters=5, reps=2)
    ops = 10 * b * h * n * n * hd + 4 * m * d * d
    nbytes = 4 * (2 * m * 3 * d + 2 * d * d + 2 * m * d + d)   # qkv, G, o in; dqkv, d_W out
    bwd = bound({"tf32": TF32X3 * ops}, nbytes)
    bwd_fma = bound({"f32": ops}, nbytes)
    # its two halves alone on the same tensors (what the forward keeps, from
    # the plain math): the projection backward (d_o, d_W, d_b; G, o, W read)
    # and the attention backward on K5's views of qkv (q, k, v, o, d_o read;
    # dqkv written), each beside its own bound
    halves = k5_backward_halves(inputs, gout, h)
    print(f"K5 backward {tag} qkv [{b},{n},{3 * d}] float32 (QkvProjGrad: the projection "
          f"backward and the attention backward kernels): {bwd_ms:.3f} ms, the plain version's "
          f"autograd {plain_ms:.3f} ms ({plain_ms / bwd_ms:.2f}x); bound {bwd['bound_ms']:.4f} ms "
          f"({bwd['bound_by']}, 3xTF32), {100 * bwd['bound_ms'] / bwd_ms:.1f} % of it; FMA bound "
          f"{bwd_fma['bound_ms']:.4f} ms; largest difference between two backward calls "
          f"{spread:.3e} (bound 0: no atomics); the forward under autograd (kernel + saved "
          f"tensors) {fwd_ms:.3f} ms; apart: the projection backward "
          f"{halves['projection']['ms']:.4f} ms (bound {halves['projection']['bound_ms']:.4f}, "
          f"{halves['projection']['bound_by']}; plain version "
          f"{halves['projection']['plain_ms']:.3f} ms, torch.mm x2 + column sum "
          f"{halves['projection']['library_ms']:.4f} ms; peak scratch "
          f"{halves['projection']['scratch_mib']:.1f} MiB; "
          f"{halves['projection']['kernels_per_call']} kernels + "
          f"{halves['projection']['memsets_per_call']} memset a call), the attention backward "
          f"{halves['attention']['ms']:.3f} ms on the {halves['attention']['route']} route "
          f"(bound {halves['attention']['bound_ms']:.4f}, {halves['attention']['bound_by']})",
          flush=True)
    check(spread == 0.0, "K5's backward differs between two calls on the same inputs")
    del inputs, wanted, out, ref, gout, first, again
    t3 = time.perf_counter()
    print(f"training, wall seconds: train CLI runs {t1 - t0:.1f}, step times {t2 - t1:.1f}, "
          f"card vs CPU and K5 gradient {t3 - t2:.1f}, total {t3 - t0:.1f}", flush=True)
    return dict(launches=launches, k5_train=k5_train, rates=rates,
                k5_backward=dict(ms=bwd_ms, plain_ms=plain_ms, forward_ms=fwd_ms, halves=halves,
                                 fma_bound_ms=bwd_fma["bound_ms"], spread=spread,
                                 max_abs_err=max_abs, max_grad_err=grad_errs,
                                 shape=f"qkv [{b},{n},{3 * d}] float32", **bwd))


def attention_bwd_alone(b: int, h: int, n: int, hd: int, dtype, timed: bool = False,
                        seed: int = 7) -> dict:
    """The attention backward kernel alone (``attention_bwd_launch``, on the
    kernel its route table gives hd and dtype) on q, k, v, dO [b, h, n, hd]
    with the forward's output and log-sum-exp from the plain math: held to
    its plain version (``flash_attention_bwd_ref``) on the same tensors
    (float32 within ``train_checks.BOUND`` of each gradient's largest
    |value|; bfloat16 by ``train_checks.bf16_errors`` with the float64
    gradient), two launches bit-equal, the route counted once a launch;
    ``timed``: the kernel, its plain version and SDPA's backward timed,
    beside the bound of the five products (f32 as three tf32 products each)
    and of q, k, v, O, dO read and dq, dk, dv written."""
    import torch
    import torch.nn.functional as F

    from anyloc_tpu_torch.ops import kernels as K
    from anyloc_tpu_torch.ops.kernels.flash_attention import (attention_bwd_launch,
                                                              attention_bwd_route)
    from anyloc_tpu_torch.tools import train_checks
    from anyloc_tpu_torch.tools._timing import time_ms

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((b, h, n, hd), generator=g, device="cuda").to(dtype)
                   for _ in range(4))
    scale = hd ** -0.5
    route = attention_bwd_route(hd, dtype)
    counter = K.KERNELS["Kab_attention_bwd_" + route]
    with torch.no_grad():
        o = K.flash_attention_ref(q, k, v, scale=scale)
        lse = torch.logsumexp((q.float() @ k.float().transpose(-1, -2)) * scale, -1).contiguous()
        outs = [torch.empty_like(q) for _ in range(3)]

        def call():
            attention_bwd_launch(q, k, v, o, lse, do, *outs, scale=scale, prescale_q=False,
                                 name="attention_bwd_alone")

        before = counter.launches
        call()
        launched = counter.launches - before
        first = [t.clone() for t in outs]
        call()
        spread = max((a.float() - c.float()).abs().max().item() for a, c in zip(first, outs))
        want = K.flash_attention_bwd_ref(q, k, v, o, lse, do, scale=scale)
        exact = None
        if dtype != torch.float32:
            exact = K.flash_attention_bwd_ref(*(t.double() for t in (q, k, v, o, lse, do)),
                                              scale=scale)
        torch.cuda.synchronize()
        r = train_checks._grad_report(("q", "k", "v"), first, want, exact)
        out = dict(shape=f"[{b},{h},{n},{hd}] {str(dtype).replace('torch.', '')}", route=route,
                   launched=launched, spread=spread, grad_errs=r["grad_errs"],
                   max_abs_err=max((a.double() - w.double()).abs().max().item()
                                   for a, w in zip(first, want)),
                   ok=r["grads_ok"] and spread == 0.0 and launched == 1)
        if timed:
            out["ms"] = time_ms(call, iters=10, reps=3)
            out["plain_ms"] = time_ms(lambda: K.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                                        scale=scale),
                                      iters=3, reps=2)
    if timed:
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
        sd = F.scaled_dot_product_attention(qs, ks, vs)
        out["library_ms"] = time_ms(lambda: torch.autograd.grad(sd, (qs, ks, vs), do,
                                                                retain_graph=True),
                                    iters=10, reps=3)
        ops = 10 * b * h * n * n * hd
        esz = 4 if dtype == torch.float32 else 2
        out.update(bound({"tf32": TF32X3 * ops} if dtype == torch.float32 else {"bf16": ops},
                         8 * esz * b * h * n * hd))
    return out


def attention_bwd_routes_phase(tag: str) -> dict:
    """Every (head dim, dtype) of the attention backward's route table on
    the kernel the table names, at [4, 4, 197, hd] (attention_bwd_alone:
    held to the plain version, two launches bit-equal, the route counted),
    then each (head dim, dtype) timed at a shape its route serves: hd 64 at
    a tensor-parallel rank's [48, 6, 197, 64] (dvgl ViT-B/16's heads), the
    others at [8, 1280 / hd, 257, hd] (ViT-H's width: 16 heads of 80), f32
    and bf16. ``timed`` gives each route its row of the kernels line: the
    wgmma kernel at [48, 6, 197, 64] f32, the split route at
    [8, 10, 257, 128] f32, its one pair."""
    import torch

    from anyloc_tpu_torch.ops.kernels.flash_attention import SUPPORTED_HEAD_DIMS

    checks = []
    for hd in SUPPORTED_HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            r = attention_bwd_alone(4, 4, 197, hd, dtype)
            errs = ", ".join(f"{k} {v:.2e}" for k, v in r["grad_errs"].items())
            print(f"attention backward route {tag} {r['shape']}: {r['route']}, launched "
                  f"{r['launched']}; against the plain version {errs}; two launches "
                  f"{r['spread']:.1e} apart", flush=True)
            check(r["ok"], f"the attention backward at {r['shape']} ({r['route']}) disagrees "
                           f"with its plain version, or two launches differ")
            checks.append(r)
    timed, by_head_dim = {}, []
    for hd in SUPPORTED_HEAD_DIMS:
        shape = (48, 6, 197, 64) if hd == 64 else (8, 1280 // hd, 257, hd)
        for dtype in (torch.float32, torch.bfloat16):
            r = attention_bwd_alone(*shape, dtype, timed=True)
            check(r["ok"], f"the timed case {r['shape']} failed: {r}")
            print(f"attention backward {r['route']} {tag} {r['shape']} (the kernels alone, "
                  f"their dq sum and D pass included): {r['ms']:.4f} ms, plain version "
                  f"{r['plain_ms']:.3f} ms, SDPA's backward {r['library_ms']:.4f} ms; bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}"
                  f"{', 3xTF32' if dtype == torch.float32 else ''}), "
                  f"{100 * r['bound_ms'] / r['ms']:.1f} % of it", flush=True)
            by_head_dim.append({k: r[k] for k in ("shape", "route", "ms", "plain_ms",
                                                  "library_ms", "bound_ms", "bound_by",
                                                  "max_abs_err")})
            if dtype == torch.float32 and hd in (64, 128):
                timed[r["route"]] = r
    check(set(timed) == {"wgmma", "split"}, f"a route was not timed: {sorted(timed)}")
    return dict(checks=checks, timed=timed, by_head_dim=by_head_dim)


def f27_line(tag: str) -> dict:
    """F27: K2's float32 forward against float64 (``attention64``) beside
    its plain version's, the largest |difference| over max|out|, at q/k/v
    [2, 16, N, 80] (ViT-H's heads) for N 257, 1370 and 2740: the kernel
    within twice the plain version's error plus 1e-6."""
    import torch

    from anyloc_tpu_torch.ops import kernels as K
    from anyloc_tpu_torch.tools import train_checks

    errs = {}
    with torch.no_grad():
        for n in (257, 1370, 2740):
            g = torch.Generator(device="cuda").manual_seed(n)
            q, k, v = (torch.randn((2, 16, n, 80), generator=g, device="cuda") for _ in range(3))
            got, plain = K.flash_attention(q, k, v), K.flash_attention_ref(q, k, v)
            kernel_err = plain_err = 0.0
            for i in range(q.shape[0]):
                exact = train_checks.attention64(q[i].double(), k[i].double(), v[i].double())
                top = exact.abs().max().item()
                kernel_err = max(kernel_err, (got[i].double() - exact).abs().max().item() / top)
                plain_err = max(plain_err, (plain[i].double() - exact).abs().max().item() / top)
            errs[n] = dict(kernel=kernel_err, plain=plain_err)
            del q, k, v, got, plain, exact
    print(f"F27 {tag} K2 float32 forward against float64, [2,16,N,80], max|diff| / max|out|: "
          + "; ".join(f"N {n} kernel {e['kernel']:.3e}, plain {e['plain']:.3e}"
                      for n, e in errs.items()), flush=True)
    for n, e in errs.items():
        check(e["kernel"] <= 2 * e["plain"] + 1e-6,
              f"F27: K2's f32 forward at N {n} is {e['kernel']:.3e} from float64, past twice "
              f"its plain version's {e['plain']:.3e}")
    return errs


def f28_line(tag: str) -> dict:
    """F28: the attention backward's float32 gradients against float64
    (``train_checks.k2_float64_errors``: K2 under autograd, dq, dk, dv,
    each the largest |difference| over max|g| of the float64 gradient,
    beside its plain version's in full float32) at q/k/v [2, 16, N, 80]
    (ViT-H's heads, the wgmma route) for N 257, 1370 and 2740, and at
    [2, 16, 1370, 128] (the split route): each within twice the plain
    version's error plus 1e-6."""
    import torch

    from anyloc_tpu_torch.ops.kernels.flash_attention import attention_bwd_route
    from anyloc_tpu_torch.tools import train_checks

    out = {}
    for n, hd in ((257, 80), (1370, 80), (2740, 80), (1370, 128)):
        errs = train_checks.k2_float64_errors(2, 16, n, hd, seed=n)
        shape = f"[2,16,{n},{hd}]"
        out[shape] = dict(route=attention_bwd_route(hd, torch.float32), **errs)
        print(f"F28 {tag} attention backward float32 against float64, {shape} "
              f"({out[shape]['route']}), max|diff| / max|g|: "
              + "; ".join(f"d{k} kernel {e['kernel']:.3e}, plain {e['plain']:.3e}"
                          for k, e in errs.items()), flush=True)
        for k, e in errs.items():
            check(e["ok"], f"F28: the f32 attention backward's d{k} at {shape} is "
                           f"{e['kernel']:.3e} from float64, past twice its plain version's "
                           f"{e['plain']:.3e} + 1e-6")
        torch.cuda.empty_cache()
    return out


def f29_line(tag: str) -> dict:
    """F29: K5's float32 projection backward alone (``qkv_proj_bwd``: d_o,
    d_W, d_b and, with LayerScale, d_γ; ``train_checks
    .proj_bwd_float64_errors``) at qkv [48, 197, 2304] (the dvgl vit step),
    [2, 1370, 3840] (ViT-H) and [32, 257, 4608] (DINOv2-G, also with
    LayerScale), and K5's float32 gradient under autograd end to end, every
    input's (``k5_gradient_float64_errors``), at [48, 197, 2304] (12 heads
    of 64), [2, 1370, 3840] (10 heads of 128, 16 of 80) and [32, 257, 4608]
    with LayerScale: each the largest |difference| over max|g| of the
    float64 result, beside the plain version's in full float32, within
    twice the plain version's plus 1e-6. Then ``OpTF32x3`` in the forward
    GEMM at the repo's longest float32 K, printed and held to the same
    bound: K5's forward at ImageBind-H's qkv [8, 257, 3840] (K 1280) and
    CLIP-L/14@336px's [8, 577, 3072] (K 1024), T1 at
    [8704x1536]x[1536x8192] (K 1536)."""
    import torch

    from anyloc_tpu_torch.tools import bench_attention_bwd, train_checks

    out = dict(projection={}, gradient={}, optf32x3={})

    def line(kind, shape, errs):
        print(f"F29 {tag} {kind} float32 against float64, {shape}, max|diff| / max|g|: "
              + "; ".join(f"{k} kernel {e['kernel']:.3e}, plain {e['plain']:.3e}"
                          for k, e in errs.items()), flush=True)
        for k, e in errs.items():
            check(e["ok"], f"F29: {kind} {k} at {shape} is {e['kernel']:.3e} from float64, past "
                           f"twice its plain version's {e['plain']:.3e} + 1e-6")
        torch.cuda.empty_cache()
        return errs

    for b, n, d, ls in bench_attention_bwd.F29_PROJ:
        shape = f"qkv [{b},{n},{3 * d}]{' layerscale' if ls else ''}"
        out["projection"][shape] = line(
            "K5 projection backward", shape,
            train_checks.proj_bwd_float64_errors(b, n, d, layerscale=ls, seed=29))
    for b, n, h, hd, ls in bench_attention_bwd.F29_K5:
        shape = f"qkv [{b},{n},{3 * h * hd}] {h} heads{' layerscale' if ls else ''}"
        out["gradient"][shape] = line(
            "K5 gradient end to end", shape,
            train_checks.k5_gradient_float64_errors(b, n, h, hd, layerscale=ls, seed=29))
    g = torch.Generator(device="cuda").manual_seed(29)
    for shape, fn in (("K5 forward qkv [8,257,3840] (K 1280)",
                       lambda: bench_attention_bwd.k5_forward_float64(8, 257, 16, 80, g)),
                      ("K5 forward qkv [8,577,3072] (K 1024)",
                       lambda: bench_attention_bwd.k5_forward_float64(8, 577, 16, 64, g)),
                      ("T1 [8704x1536]x[1536x8192] (K 1536)",
                       lambda: bench_attention_bwd.t1_float64(g))):
        out["optf32x3"][shape] = line("OpTF32x3", shape, fn())
    return out


def vith_gradient_phase(tag: str) -> dict:
    """ViT-H's attention gradient at its published geometry (MAE-H/14 at
    224 px: 16 heads of 80, D 1280; ImageBind-H's and SAM-H's heads too):
    K5's backward under autograd (``QkvProjGrad``) at qkv [8, 257, 3840]
    and K2's (``FlashAttentionGrad``) at q/k/v [8, 16, 257, 80], f32 and
    bf16, then the same width cut into 10 heads of 128 in f32 (the split
    route), each held to the plain version's autograd
    (``train_checks.k5_gradient`` / ``k2_gradient``: the bounds, one
    launch each way, the output bit-equal without autograd), then its
    backward timed beside the plain autograd's in turns; the launch
    counts are set to 0 before the phase and read after it, and each
    attention backward is counted on the route the table names."""
    import torch

    from anyloc_tpu_torch.ops import kernels as K
    from anyloc_tpu_torch.ops.kernels.flash_attention import attention_bwd_route
    from anyloc_tpu_torch.tools import train_checks

    b, n = 8, 257
    K.reset_launch_counts()
    lines = {}
    for h, hd, dtype in ((16, 80, torch.float32), (16, 80, torch.bfloat16),
                         (10, 128, torch.float32)):
        name = str(dtype).replace("torch.", "") + ("" if hd == 80 else f" hd {hd}")
        route = attention_bwd_route(hd, dtype)
        before = {r: K.KERNELS["Kab_attention_bwd_" + r].launches for r in ("wgmma", "split")}
        r5 = train_checks.k5_gradient(b, n, h, hd, dtype)
        r2 = train_checks.k2_gradient(b, h, n, hd, dtype)
        for what, r in (("K5", r5), ("K2", r2)):
            check(r["ok"], f"ViT-H's {what} gradient ({name}) disagrees with its plain version's: "
                           f"{r['grad_errs']}")
        inputs = train_checks.k5_inputs(b, n, h, hd, dtype)
        wanted = [t for t in inputs.values() if t is not None]
        out = K.flash_attention_qkv_proj(num_heads=h, **inputs)
        ref = K.flash_attention_qkv_proj_ref(num_heads=h, **inputs)
        gout = torch.randn_like(out)
        k5_ms, k5_plain = turns(lambda: torch.autograd.grad(out, wanted, gout, retain_graph=True),
                                lambda: torch.autograd.grad(ref, wanted, gout, retain_graph=True))
        del inputs, wanted, out, ref, gout
        g = torch.Generator(device="cuda").manual_seed(1)
        qkv = [torch.randn((b, h, n, hd), generator=g, device="cuda").to(dtype)
               .requires_grad_(True) for _ in range(3)]
        out, ref = K.flash_attention(*qkv), K.flash_attention_ref(*qkv)
        gout = torch.randn_like(out)
        k2_ms, k2_plain = turns(lambda: torch.autograd.grad(out, qkv, gout, retain_graph=True),
                                lambda: torch.autograd.grad(ref, qkv, gout, retain_graph=True))
        del qkv, out, ref, gout
        moved = {r: K.KERNELS["Kab_attention_bwd_" + r].launches - before[r]
                 for r in ("wgmma", "split")}
        check(moved[route] > 0 and sum(moved.values()) == moved[route],
              f"ViT-H's {name} backward ran off the {route} route its table names: {moved}")
        lines[name] = dict(route=route,
                           k5=dict(shape=f"qkv [{b},{n},{3 * h * hd}]", ms=k5_ms,
                                   plain_ms=k5_plain, grad_errs=r5["grad_errs"]),
                           k2=dict(shape=f"[{b},{h},{n},{hd}]", ms=k2_ms, plain_ms=k2_plain,
                                   grad_errs=r2["grad_errs"]))
        errs = {w: ", ".join(f"{k} {v:.2e}" for k, v in r["grad_errs"].items())
                for w, r in (("K5", r5), ("K2", r2))}
        print(f"ViT-H gradient {tag} {name} on the {route} route: K5 backward "
              f"qkv [{b},{n},{3 * h * hd}] {k5_ms:.3f} ms (plain autograd {k5_plain:.3f}), "
              f"errors {errs['K5']}; K2 backward [{b},{h},{n},{hd}] {k2_ms:.3f} ms (plain "
              f"autograd {k2_plain:.3f}), errors {errs['K2']}", flush=True)
    counts = K.launch_counts()
    for kernel in PATH_KERNELS["vit-h gradient"]:
        check(counts.get(kernel, 0) > 0, f"{kernel} never launched in the ViT-H gradient phase")
    return dict(lines=lines, counts={k: v for k, v in counts.items() if v})


def k5_backward_halves(inputs: dict, gout, h: int) -> dict:
    """K5's backward in its two halves on one card, each launched alone on
    the tensors ``QkvProjGrad`` hands it (the forward's o and log-sum-exp
    from the plain math; no LayerScale): the projection backward
    (``qkv_proj_bwd``: d_o, d_W, d_b) and the attention backward on strided
    views of qkv (``attention_bwd_launch``, pre-scaled q), each timed beside
    its 3xTF32 bound, the attention with the route it ran; the projection
    also beside its plain version (``qkv_proj_bwd_ref``) and the library's
    route (two ``torch.mm`` in full float32 and a column sum: not one call),
    with the memory a call allocates beyond its outputs (its scratch) and
    the launches it makes."""
    import torch

    from anyloc_tpu_torch.ops import kernels as K
    from anyloc_tpu_torch.ops.kernels import attn_proj
    from anyloc_tpu_torch.ops.kernels.flash_attention import (attention_bwd_launch,
                                                              attention_bwd_route)
    from anyloc_tpu_torch.tools._timing import time_ms

    with torch.no_grad():
        qkv = inputs["qkv"].detach()
        b, n, three_d = qkv.shape
        d = three_d // 3
        hd = d // h
        m, scale = b * n, hd ** -0.5
        q, k, v = attn_proj._split_heads(qkv, h)
        sc = (q * scale) @ k.transpose(-1, -2)
        lse = torch.logsumexp(sc, dim=-1).contiguous()
        o = (torch.softmax(sc, dim=-1) @ v).transpose(1, 2).reshape(b, n, d).contiguous()
        del sc
        d_o = torch.randn((b, n, d), device=qkv.device)
        d_qkv = torch.empty_like(qkv)
        dq, dk, dv = attn_proj._split_heads(d_qkv, h)
        w = inputs["w_proj"].detach()
        route = attention_bwd_route(hd, qkv.dtype)
        counter = K.KERNELS["Kab_attention_bwd_" + route]
        before = counter.launches

        def attention():
            attention_bwd_launch(q, k, v, attn_proj._heads(o, h), lse, attn_proj._heads(d_o, h),
                                 dq, dk, dv, scale=scale, prescale_q=True, name="k5 halves")

        att_ms = time_ms(attention, iters=10, reps=3)
        check(counter.launches > before, f"the attention backward did not run on {route}")
        args = (gout, w, inputs["b_proj"].detach(), None, o, None)
        proj_ms = time_ms(lambda: attn_proj.qkv_proj_bwd(*args), iters=10, reps=3)
        plain_ms = time_ms(lambda: attn_proj.qkv_proj_bwd_ref(*args), iters=5, reps=2)
        g2, o2 = gout.reshape(m, -1), o.reshape(m, d)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False   # full float32
        try:
            lib_ms = time_ms(lambda: (torch.mm(g2, w.t()), torch.mm(o2.t(), g2), g2.sum(0)),
                             iters=10, reps=3)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        outs = attn_proj.qkv_proj_bwd(*args)
        torch.cuda.synchronize()
        scratch = (torch.cuda.max_memory_allocated() - base
                   - sum(x.nbytes for x in outs if x is not None))
        call = attn_proj.qkv_proj_bwd.last_call
    return dict(
        attention=dict(ms=att_ms, route=route,
                       **bound({"tf32": TF32X3 * 10 * b * h * n * n * hd}, 4 * 8 * m * d)),
        projection=dict(ms=proj_ms, plain_ms=plain_ms, library_ms=lib_ms,
                        library_route="torch.mm x2 (full float32) + a column sum: not one call",
                        scratch_mib=scratch / 2 ** 20, workspace_bytes=call["workspace_bytes"],
                        kernels_per_call=call["kernels"], memsets_per_call=call["memsets"],
                        **bound({"tf32": TF32X3 * 4 * m * d * d},
                                4 * (3 * m * d + 2 * d * d + d))))


def eval_model(label: str):
    """The model ``eval`` builds for ``label`` with no checkpoint (its random
    init from ``eval_cli.SEED``, on the CPU)."""
    from anyloc_tpu_torch.models.convert import materialize
    from anyloc_tpu_torch.training import eval_cli
    from anyloc_tpu_torch.training.mixvpr import VPRModel
    from anyloc_tpu_torch.training.network import GeoLocalizationNet

    if label == "eval dvgl resnet18conv4":
        make = lambda: GeoLocalizationNet("resnet18conv4", "netvlad", img_size=480)  # noqa: E731
    elif label == "eval dvgl vit":
        make = lambda: GeoLocalizationNet("vit", "netvlad", img_size=224)  # noqa: E731
    elif label == "eval mixvpr":
        make = lambda: VPRModel("resnet50", "mixvpr", {  # noqa: E731
            "out_channels": 1024, "out_rows": 4, "mix_depth": 4}, input_hw=(320, 320))
    else:
        make = lambda: VPRModel("resnet50", "cosplace", {"in_dim": 2048, "out_dim": 512},  # noqa
                                layers_to_crop=(), input_hw=(480, 640))
    return materialize(make, None, "cpu", seed=eval_cli.SEED)


def cos_rows(a, b):
    import numpy as np

    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def demo_phase(ext, vlad, ext8, vlad8, db, work: Path, tag: str) -> None:
    """``python -m anyloc_tpu_torch demo`` over 4 square JPEGs at 1024 px
    (1022 px, 5330 tokens, one image a call), bf16 then int8_full, each
    .npy held to the smoke's own extractor + ``aggregate`` of the same
    preprocessed image (same seed, same weights); then the same run with
    the extractor already built, timed (images/s with decode); then
    ``--domain auto`` over two cached domains with centroids from
    ``build_gem_centroids``, each route held to ``route_by_domain``."""
    import numpy as np
    import torch
    from PIL import Image

    from anyloc_tpu_torch import cli
    from anyloc_tpu_torch.data.transforms import preprocess_image
    from anyloc_tpu_torch.models import extractor as extractor_module
    from anyloc_tpu_torch.ops import kernels as K
    from anyloc_tpu_torch.parallel.ep import route_by_domain
    from anyloc_tpu_torch.pipelines.demo import build_gem_centroids, vocab_dir

    imgs = work / "imgs"
    imgs.mkdir(parents=True)
    for i, src in enumerate(db[:4]):
        Image.open(src).convert("RGB").resize((1024, 1024), Image.BILINEAR).save(
            imgs / f"q{i}.jpg", quality=95)
    cache = work / "cache"
    for domain, vl in (("indoor", vlad), ("urban", vlad8)):
        vdir = Path(vocab_dir(str(cache), "dinov2_vitg14", 31, "value", 32, domain))
        vdir.mkdir(parents=True)
        np.savez(vdir / "c_centers.npz", centers=vl.c_centers.cpu().numpy())
    base = ["demo", "--in-dir", str(imgs), "--cache-dir", str(cache)]
    arrs = [preprocess_image(Image.open(imgs / f"q{i}.jpg").convert("RGB"), max_edge=1024)
            for i in range(4)]
    check(all(a.shape == (1022, 1022, 3) for a in arrs), "demo: 1024-px JPEGs not at 1022 px")

    def run(argv, prebuilt=None):
        """cli.main(argv), its stdout kept; ``prebuilt`` stands in for the
        demo's extractor (the timed run)."""
        real = extractor_module.DinoV2ExtractFeatures
        if prebuilt is not None:
            extractor_module.DinoV2ExtractFeatures = lambda *a, **kw: prebuilt
        try:
            with contextlib.redirect_stdout(io.StringIO()) as log:
                t0 = time.perf_counter()
                rc = cli.main(argv)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
        finally:
            extractor_module.DinoV2ExtractFeatures = real
        check(rc == 0, f"demo {argv} returned {rc}")
        return log.getvalue(), seconds

    for path, quant, extractor, vl in (("demo bf16", [], ext, vlad),
                                       ("demo int8_full", ["--quant", "int8_full"], ext8, vlad)):
        out = work / path.replace(" ", "_")
        K.reset_launch_counts()
        _, seconds = run(base + ["--out-dir", str(out)] + quant)
        counts = K.launch_counts()
        for name in PATH_KERNELS[path]:
            check(counts[name] > 0, f"{name} never launched on the {path} path")
        got = np.stack([np.load(out / f"q{i}.npy") for i in range(4)])
        want = np.stack([vl.aggregate(extractor(a[None]))[0].cpu().numpy() for a in arrs])
        err = float(np.abs(got - want).max())
        cos = float(cos_rows(got, want).min())
        print(f"{path}: python -m anyloc_tpu_torch {' '.join(base + quant)} (dinov2_vitg14 l31 "
              f"value, VLAD-32, --max-img-size 1024): 4 JPEGs 1024x1024 -> 1022 px, .npy "
              f"{got.shape[1]}-dim, {seconds:.1f} s with the model build; against extractor + "
              f"aggregate on the card: max_abs_err {err:.2e} (bound 1e-4), min cosine {cos:.7f} "
              f"(bound >= 0.9999); launch counts {counts}", flush=True)
        check(got.shape == (4, 32 * 1536) and bool(np.isfinite(got).all()),
              f"{path}: .npy {got.shape}")
        check(err <= 1e-4 and cos >= 0.9999, f"{path}: .npy disagrees with extractor + aggregate")
        _, seconds = run(base + ["--out-dir", str(out)] + quant, prebuilt=extractor)
        print(f"{path} {tag}: 4 images at 1022 px with decode (PIL, 1024x1024 JPEG) + resize + "
              f"trunk + VLAD + save, the extractor built: {seconds:.3f} s, {4 / seconds:.2f} "
              f"images/s", flush=True)

    # --domain auto: GeM centroids from two images a domain, at 448 px
    vroot = Path(vocab_dir(str(cache), "dinov2_vitg14", 31, "value", 32, "x")).parent
    doms = {"indoor": [str(imgs / "q0.jpg"), str(imgs / "q1.jpg")],
            "urban": [str(imgs / "q2.jpg"), str(imgs / "q3.jpg")]}
    cents = build_gem_centroids(ext, doms, str(vroot / "gem_centroids.npz"), max_edge=448)
    log, seconds = run(base + ["--out-dir", str(work / "auto"), "--domain", "auto",
                               "--max-img-size", "448"])
    got = dict(re.findall(r"^(q\d)\.jpg -> .*\[(\w+)\]$", log, re.M))
    order = sorted(doms)
    c = torch.from_numpy(np.stack([cents[d] for d in order])).cuda()
    a448 = [preprocess_image(Image.open(imgs / f"q{i}.jpg").convert("RGB"), max_edge=448)
            for i in range(4)]
    want = {f"q{i}": order[int(route_by_domain(ext(a[None]), c)[0])] for i, a in enumerate(a448)}
    print(f"demo --domain auto {order} at 448 px: routes {got} (route_by_domain on the smoke's "
          f"extractor: {want}), {seconds:.1f} s with the model build", flush=True)
    check(got == want, f"demo --domain auto routed {got}, route_by_domain {want}")


def serve_phase(ext8, vlad8, db, qu, gt, work: Path, tag: str) -> None:
    """The daemon as ``python -m anyloc_tpu_torch serve`` builds it, no
    device named: int8_full, uint8 transfer, --img-size 308, DINOv2-G l31,
    the int8_full path's vocabulary, a database of the fixture's 16
    database VLADs from the engine (the same seed's weights). 16 concurrent requests (8 /describe of
    database images, 8 /search of queries): all 200, descriptors within
    int8_full's bound of the engine's VLADs of the same images, ids those
    of the card's exact search of the engine's query VLADs; /stats
    mean_batch > 1; K1, K3, K4 launch. Then requests/s and latency at
    concurrency 1 and 16; then a group's fetch returning while the next
    group runs (each group's work led by ~50 ms of device spin); then
    --ivf (full probe = exact) and --pq over a 1-row database (F3)."""
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from anyloc_tpu_torch import DescriptorEngine, VPRDataset, top_k_search
    from anyloc_tpu_torch.ops import kernels as K
    from anyloc_tpu_torch.pipelines import serve_http

    work.mkdir(parents=True)
    vdir = work / "vocab"
    vdir.mkdir()
    np.savez(vdir / "c_centers.npz", centers=vlad8.c_centers.cpu().numpy())
    ds = VPRDataset(db, qu, soft_positives_per_query=gt, img_size=(308, 308))
    engine = DescriptorEngine(extractor=ext8, batch_size=16, transfer_dtype="uint8")
    dbv = engine.extract_vlads_dataset(ds, vlad8, "db", verbose=False)
    quv = engine.extract_vlads_dataset(ds, vlad8, "queries", verbose=False)
    np.save(work / "db.npy", dbv)
    np.save(work / "db1.npy", dbv[:1])
    raw = {p: Path(p).read_bytes() for p in db + qu}

    def start(*extra):
        args = serve_http._parser().parse_args(
            ["--model", "dinov2_vitg14", "--layer", "31", "--facet", "value",
             "--num-clusters", "32", "--vocab-dir", str(vdir), "--quant", "int8_full",
             "--transfer-dtype", "uint8", "--img-size", "308", "--port", "0", *extra])
        t0 = time.perf_counter()
        server = serve_http.build_server(args)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        return server, time.perf_counter() - t0

    def post(server, path, data):
        t0 = time.perf_counter()
        req = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}{path}",
                                     data=data, method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:   # a 4xx / 5xx raises
            check(r.status == 200, f"serve {path}: HTTP {r.status}")
            out = json.loads(r.read())
        return out, time.perf_counter() - t0

    def get(server, path):
        with urllib.request.urlopen(f"http://127.0.0.1:{server.server_address[1]}{path}",
                                    timeout=60) as r:
            return json.loads(r.read())

    def stop(server):
        server.shutdown()
        server.server_close()

    server, build_s = start("--db", str(work / "db.npy"))   # the default 5-ms window
    svc = server.service
    try:
        check(svc.device.type == "cuda" and get(server, "/health")["engine"] == "device",
              "serve: not on the card's exact engine")
        plan = [("/describe", raw[p]) for p in db[:8]] + [("/search?k=5", raw[p]) for p in qu]
        K.reset_launch_counts()
        with ThreadPoolExecutor(16) as ex:
            outs = list(ex.map(lambda pd: post(server, *pd)[0], plan))
        counts = K.launch_counts()
        stats = get(server, "/stats")
        desc = np.asarray([o["descriptor"] for o in outs[:8]], np.float32)
        err = float(np.abs(desc - dbv[:8]).max())
        cos = float(cos_rows(desc, dbv[:8]).min())
        compared = same_ids(outs[8:], dbv, quv, 5)
        print(f"serve int8_full {tag}: python -m anyloc_tpu_torch serve --model dinov2_vitg14 "
              f"--layer 31 --quant int8_full --transfer-dtype uint8 --img-size 308 (built and "
              f"warm in {build_s:.1f} s), 16 concurrent requests (8 /describe, 8 /search k=5): all "
              f"200; descriptors vs the engine's VLADs of the same images max_abs_err {err:.2e}, "
              f"min cosine {cos:.7f} (bound >= 0.999); /search ids equal the card's exact search "
              f"of the engine's query VLADs at {compared} of 40 ranks (the others past a score "
              f"gap <= 1e-3); /stats requests {stats['requests']}, batches {stats['batches']}, "
              f"mean_batch {stats['mean_batch']:.2f} (bound > 1); decoded by {svc.decoded}; "
              f"launch counts {counts}", flush=True)
        check(cos >= 0.999, "serve: /describe disagrees with the engine's VLADs")
        check(stats["mean_batch"] > 1, f"serve: no coalescing, {stats}")
        for name in PATH_KERNELS["serve int8_full"]:
            check(counts[name] > 0, f"{name} never launched while serving")

        def load(conc, n):
            imgs = [raw[qu[i % len(qu)]] for i in range(n)]
            t0 = time.perf_counter()
            with ThreadPoolExecutor(conc) as ex:
                lat = [s for _, s in ex.map(lambda d: post(server, "/search?k=5", d), imgs)]
            wall = time.perf_counter() - t0
            lat = np.sort(np.asarray(lat)) * 1e3
            return n / wall, np.percentile(lat, 50), np.percentile(lat, 99)

        for conc, n in ((1, 24), (16, 96)):
            before = get(server, "/stats")
            rps, p50, p99 = load(conc, n)
            after = get(server, "/stats")
            mb = (after["requests"] - before["requests"]) / max(1, after["batches"] - before["batches"])
            split = []
            for k, v in after["stages"].items():
                tot0, cnt0 = (before["stages"][k]["total_ms"], before["stages"][k]["count"]) \
                    if k in before["stages"] else (0.0, 0)
                if v["count"] > cnt0:
                    split.append(f"{k} {(v['total_ms'] - tot0) / (v['count'] - cnt0):.2f} ms "
                                 f"x{v['count'] - cnt0}")
            print(f"serve int8_full {tag}: concurrency {conc}, {n} /search requests of 640x480 "
                  f"JPEGs at 308 px: {rps:.2f} requests/s, latency p50 {p50:.1f} ms, p99 "
                  f"{p99:.1f} ms, mean batch {mb:.2f}; stages (mean, count): {', '.join(split)}",
                  flush=True)
        b = svc.batcher
        print(f"serve int8_full: under that load {b.n_pipelined} fetches were made with the "
              f"next group queued, {b.n_overlapped} of them returned while the next group still "
              f"ran on the card (not asserted: it hangs on the host's pace)", flush=True)
        # the ordering itself: each group's device work starts with ~50 ms of
        # spinning, far longer than the host's side of a fetch, so a fetch
        # that waits on its own group's event returns while the next group
        # runs; one that waited for all queued work would never do so
        trunk = svc.extractor

        def spinning(imgs):
            torch.cuda._sleep(100_000_000)
            return trunk(imgs)

        # groups of at most 2: the 8 requests make 4 or more groups, queued
        # behind each other's spin
        pipe0, over0, max_batch = b.n_pipelined, b.n_overlapped, b.max_batch
        svc.extractor, b.max_batch = spinning, 2
        try:
            with ThreadPoolExecutor(8) as ex:
                list(ex.map(lambda p: post(server, "/search?k=5", raw[p]), qu))
        finally:
            svc.extractor, b.max_batch = trunk, max_batch
        pipe, over = b.n_pipelined - pipe0, b.n_overlapped - over0
        print(f"serve int8_full: 8 concurrent /search in groups of at most 2 with ~50 ms of "
              f"device spin ahead of each group: {pipe} fetches made with the next group queued, "
              f"{over} of them returned while the next group still ran (bound: > 0)", flush=True)
        check(pipe > 0 and over > 0, "serve: the fetch of a group waited for the next group")
    finally:
        stop(server)
    for label, extra, want_engine, rows in (
            ("--ivf", ["--db", str(work / "db.npy"), "--ivf"], "ivf", 16),
            ("--pq, 1-row database (F3)", ["--db", str(work / "db1.npy"), "--pq"], "device", 1)):
        server, build_s = start(*extra)
        try:
            h = get(server, "/health")
            outs = [post(server, "/search?k=5", raw[p])[0] for p in qu[:4]]
        finally:
            stop(server)
        compared = same_ids(outs, dbv[:rows], quv[:4], min(5, rows))
        exact = top_k_search(torch.from_numpy(dbv[:rows]).cuda(),
                             torch.from_numpy(quv[:4]).cuda(), min(5, rows))[0].cpu().numpy()
        score_err = max(float(np.abs(np.asarray(o["scores"]) - exact[i]).max())
                        for i, o in enumerate(outs))
        print(f"serve {label}: engine {h['engine']}, {h['db_rows']} rows, built and warm in "
              f"{build_s:.1f} s; 4 /search of queries: ids equal exact search of the engine's "
              f"VLADs at {compared} of {4 * min(5, rows)} ranks, score max_abs_err "
              f"{score_err:.2e} (bound 2e-3: int8_full descriptors; IVF at full probe and a "
              f"1-row database are exact searches)", flush=True)
        check(h["engine"] == want_engine and h["db_rows"] == rows and score_err <= 2e-3,
              f"serve {label}: {h}, score error {score_err}")
    torch.cuda.empty_cache()


def same_ids(outs, dbv, quv, k: int) -> int:
    """Check each /search reply's ids against the card's exact search of
    the engine's query VLADs, up to the first rank whose score lies within
    1e-3 of the next (int8_full descriptors move scores by less); returns
    the number of ranks compared."""
    import numpy as np
    import torch

    from anyloc_tpu_torch import top_k_search

    n = min(k + 1, dbv.shape[0])
    s, i = top_k_search(torch.from_numpy(dbv).cuda(), torch.from_numpy(quv).cuda(), n)
    s, i = s.cpu().numpy(), i.cpu().numpy()
    compared = 0
    for row, o in enumerate(outs):
        gaps = -np.diff(s[row])
        keep = k if np.all(gaps[:k] > 1e-3) else int(np.argmax(gaps <= 1e-3))
        check(o["ids"][:keep] == i[row, :keep].tolist(),
              f"serve: /search ids {o['ids']} vs the engine's {i[row].tolist()}")
        compared += keep
    return compared


def sweep_phase(root: Path, work: Path) -> None:
    """``run_sweep`` over a 2-point vlad grid (num_clusters 8, 16) at
    DINOv2-G l31 on the 17places tree: one engine for both points, and no
    row with ``error`` (run_sweep catches a failing point by design)."""
    from anyloc_tpu_torch import config
    from anyloc_tpu_torch import sweeps
    from anyloc_tpu_torch.pipelines.engine import DescriptorEngine

    built = []
    init = DescriptorEngine.__init__

    def spy(self, *a, **kw):
        built.append(1)
        init(self, *a, **kw)

    base = config.parse_args(argv=[*ENTRY_ARGS, "--prog.data-vg-dir", str(root),
                                   "--prog.cache-dir", str(work)])
    DescriptorEngine.__init__ = spy
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(io.StringIO()) as err:
            rows = sweeps.run_sweep("vlad", {"num_clusters": [8, 16]}, base,
                                    str(work / "sweep.csv"), verbose=False)
    finally:
        DescriptorEngine.__init__ = init
    seconds = time.perf_counter() - t0
    print(f"sweep: run_sweep vlad over num_clusters [8, 16] at dinov2_vitg14 l31 value, 308 px: "
          f"{len(rows)} rows in {seconds:.1f} s, {len(built)} engine built (bound 1), R@1 "
          f"{[r.get('R@1') for r in rows]} (random weights, not asserted); errors "
          f"{[r for r in rows if r.get('error')] or 'none'}", flush=True)
    check(len(rows) == 2 and not any(r.get("error") for r in rows),
          f"sweep: a grid point failed: {err.getvalue()[-2000:]}")
    check(len(built) == 1 and [r["Num-Clusters"] for r in rows] == ["8", "16"],
          f"sweep: {len(built)} engines, rows {rows}")


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


def mesh_phase(ext, vlad, ext8, vlad8, db, qu, mesh, work: Path, tag: str) -> dict:
    """``parallel/`` at DINOv2-G width; returns the kernel launches of the
    phase's sharded calls alone: the counts are zeroed just before each
    sharded call of this process and read just after (the unsharded
    references run outside those windows), and the two ranks count only
    their sharded calls (``mesh_checks.Rank.sharded``).

    World 1, NCCL, in this process (``mesh``): ``DescriptorEngine(mesh=...)``
    in bf16 and int8_full with uint8 transfer at 308 px, batch 32, on 64
    of the fixture's images, VLADs bit-equal to the engine without a mesh,
    and both rates with the images on the card; ``serve --mesh 1``, each
    /search reply equal to the unsharded daemon's. World 2, Gloo, both
    ranks on this card (``tools/mesh_checks.py``, profile "full": G width,
    4 blocks): sharded extraction in bf16 and int8_full (224 px, batch 8)
    against one rank, per-image cosine >= 0.999; tensor parallelism over 2
    ranks (12 heads each) against the fused trunk, rms_rel <= 1e-2, K2 on
    each rank, a rank's bytes < 0.55 of the replicated trunk's; 2 pipeline
    stages and 2 sequence shards at 1022 px (5330 tokens) against one
    rank, rms_rel <= 1e-2; expert-parallel VLAD (4 experts of [32, 1536])
    against the direct VLAD, cosine >= 0.9999; sharded k-means (50,000 x
    1536, 32 centers) within 1e-4 of ``kmeans_fit``; sharded exact search
    (20,000 x 1536) ids equal to ``top_k_search``. The two ranks' times
    are Gloo through host memory on one card, not multi-GPU figures."""
    import threading
    import urllib.request

    import numpy as np
    import torch

    from anyloc_tpu_torch import DescriptorEngine, VPRDataset
    from anyloc_tpu_torch.ops import kernels as K
    from anyloc_tpu_torch.parallel import sharded_extract_fn
    from anyloc_tpu_torch.pipelines import serve_http
    from anyloc_tpu_torch.tools import mesh_checks
    from anyloc_tpu_torch.tools._timing import time_ms

    work.mkdir(parents=True)
    counts = {}

    def counted(fn):
        """``fn()``, its kernel launches added to ``counts``."""
        K.reset_launch_counts()
        out = fn()
        for name, n in K.launch_counts().items():
            if n:
                counts[name] = counts.get(name, 0) + n
        return out

    t_phase = time.perf_counter()
    paths = (db + qu) * (64 // len(db + qu) + 1)
    ds = VPRDataset(paths[:64], [], img_size=(308, 308))
    x = np.random.default_rng(0).integers(0, 256, (32, 308, 308, 3), dtype=np.uint8)
    dbv = None
    for label, extractor, vl in (("bf16", ext, vlad), ("int8_full", ext8, vlad8)):
        one = DescriptorEngine(extractor=extractor, batch_size=32, transfer_dtype="uint8")
        sharded = DescriptorEngine(extractor=extractor, batch_size=32, transfer_dtype="uint8",
                                   mesh=mesh)
        want = one.extract_vlads_dataset(ds, vl, "db", verbose=False)
        got = counted(lambda: sharded.extract_vlads_dataset(ds, vl, "db", verbose=False))
        same = bool(np.array_equal(got, want))
        run = sharded_extract_fn(lambda p, imgs: vl.aggregate(extractor._forward(p, imgs)), mesh,
                                 as_numpy=False)
        ms_one = time_ms(lambda: vl.aggregate(extractor(x)), iters=5, reps=3)
        ms_mesh = counted(lambda: time_ms(lambda: run(None, x), iters=5, reps=3))
        print(f"mesh {tag} world 1 (NCCL) DescriptorEngine(mesh=local_mesh(1)) {label}, uint8, "
              f"308 px, batch 32, 64 images: VLADs bit-equal to the unsharded engine: {same}; "
              f"extract+VLAD with the images on the host, {32e3 / ms_mesh:.2f} images/s sharded "
              f"vs {32e3 / ms_one:.2f} unsharded", flush=True)
        check(same, f"mesh engine {label}: VLADs differ from the unsharded engine's")
        if label == "int8_full":
            dbv = want

    # serve --mesh 1 against the daemon without a mesh
    vdir = work / "vocab"
    vdir.mkdir()
    np.savez(vdir / "c_centers.npz", centers=vlad8.c_centers.cpu().numpy())
    np.save(work / "db.npy", dbv)
    raw = [Path(p).read_bytes() for p in qu]

    def replies(*extra):
        args = serve_http._parser().parse_args(
            ["--model", "dinov2_vitg14", "--layer", "31", "--facet", "value",
             "--num-clusters", "32", "--vocab-dir", str(vdir), "--quant", "int8_full",
             "--transfer-dtype", "uint8", "--img-size", "308", "--port", "0",
             "--db", str(work / "db.npy"), *extra])
        server = serve_http.build_server(args)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            out = []
            for data in raw:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{server.server_address[1]}/search?k=5", data=data,
                    method="POST")
                with urllib.request.urlopen(req, timeout=300) as r:
                    out.append(json.loads(r.read()))
            return out, server.service.engine
        finally:
            server.shutdown()
            server.server_close()
            del server
            torch.cuda.empty_cache()

    got, engine = counted(lambda: replies("--mesh", "1"))
    want, _ = replies()
    same = got == want
    print(f"mesh {tag} serve --mesh 1 (engine {engine}): {len(raw)} /search replies equal to the "
          f"unsharded daemon's: {same}", flush=True)
    check(same and engine == "device+mesh1", "serve --mesh 1 disagrees with the daemon")
    world1 = dict(counts)
    t1 = time.perf_counter() - t_phase

    # world 2: Gloo, both ranks on this card
    t0 = time.perf_counter()
    report = mesh_checks.launch(work / "world2", 2, "gloo", "cuda", "full", timeout=500)
    launch_s = time.perf_counter() - t0
    for name, n in world2_checks(work / "world2", report, tag).items():
        counts[name] = counts.get(name, 0) + n
    world2 = {k: n - world1.get(k, 0) for k, n in counts.items()}
    print(f"mesh {tag}: world 1 {t1:.1f} s, world 2 {launch_s:.1f} s (the ranks' start "
          f"included); launches of the sharded calls: world 1 {world1}, world 2 (both ranks) "
          f"{world2}, together {counts}", flush=True)
    # world 1 at 308 px runs the fused block kernels, not K2 (the world-2
    # tensor-parallel trunk checks K2 on each rank)
    for name in ("K1_vlad_aggregate_fused", "K3_fused_mlp_int8", "K4_fused_attn_half_int8",
                 "K5_flash_attention_qkv_proj"):
        check(world1.get(name, 0) > 0, f"{name} never launched in world 1's sharded calls")
    return counts


def world2_checks(out: Path, report: dict, tag: str) -> dict:
    """The two ranks' results (``tools/mesh_checks.py``, profile "full")
    held to their bounds (``mesh_phase``); returns the launches of the
    ranks' sharded calls, summed."""
    import numpy as np

    from anyloc_tpu_torch.tools import mesh_checks

    counts = {}
    for cases in report.values():
        for r in cases.values():
            for name, n in r["launches"].items():
                counts[name] = counts.get(name, 0) + n
    res = {c: mesh_checks.results(out, c) for c in mesh_checks.CASES_FULL}

    def secs(case):
        return "/".join(f"{report[r][case]['seconds']:.2f}" for r in sorted(report))

    def rms(a, b):
        return float(np.sqrt(((a.astype(np.float64) - b) ** 2).mean() / (b.astype(np.float64) ** 2).mean()))

    ex = res["extract"]
    for mode in ("bfloat16", "int8_full"):
        vcos = float(cos_rows(ex[f"{mode}_vlads"], ex[f"{mode}_single_vlads"]).min())
        dcos = float(cos_rows(ex[f"{mode}_descs"], ex[f"{mode}_single_descs"]).min())
        diff = float(np.abs(ex[f"{mode}_vlads"] - ex[f"{mode}_single_vlads"]).max())
        cached = bool(np.array_equal(ex[f"{mode}_cached"], ex[f"{mode}_vlads"]))
        print(f"mesh {tag} world 2 (Gloo, one card) sharded extraction {mode} G/14 4 blocks, "
              f"224 px, 8 images: min VLAD cosine {vcos:.6f}, min facet cosine {dcos:.6f} vs one "
              f"rank (bound >= 0.999), max VLAD difference {diff:.2e}, cache read back equal "
              f"{cached}; {float(ex[f'{mode}_seconds']):.2f} s sharded vs "
              f"{float(ex[f'{mode}_single_seconds']):.2f} s one rank (with PIL decode)",
              flush=True)
        check(min(vcos, dcos) >= 0.999 and cached, f"sharded extraction {mode} disagrees")
    tp = res["tp"]
    rr = rms(tp["tp"], tp["single"])
    floor = rms(tp["single"], tp["single_f32"])
    share = float(tp["rank_bytes"]) / float(tp["replicated_bytes"])
    k2 = [report[r]["tp"]["launches"].get("K2_flash_attention", 0) for r in sorted(report)]
    print(f"mesh {tag} world 2 tensor parallelism (tp_split, 12 heads a rank) G/14 4 blocks, "
          f"224 px, 8 images, bf16: rms_rel {rr:.2e} vs the fused trunk (bound <= 1e-2; the "
          f"fused bf16 trunk itself is {floor:.2e} from float32 weights' float32 run), K2 "
          f"launches per rank {k2}, a rank holds {share:.3f} of the replicated bytes (bound "
          f"< 0.55); {secs('tp')} s per rank", flush=True)
    check(rr <= 1e-2 and min(k2) > 0 and share < 0.55, "tensor parallelism disagrees")
    pp = res["pp"]
    rr = rms(pp["3_value"], pp["3_value_single"])
    stage = float(pp["stage_bytes"]) / float(pp["stacked_bytes"])
    print(f"mesh {tag} world 2 pipeline (2 stages, blocks 0-2 + capture block 3) G/14, 224 px, "
          f"8 images, bf16: rms_rel {rr:.2e} vs the blocks in sequence (bound <= 1e-2), a stage "
          f"holds {stage:.3f} of the stacked blocks; {secs('pp')} s per rank", flush=True)
    check(rr <= 1e-2 and np.array_equal(pp["staged"], pp["3_value"]), "pipeline disagrees")
    sp = res["sp"]
    rr = rms(sp["extractor"], sp["extractor_single"])
    rr8 = rms(sp["extractor_u8"], sp["extractor_u8_single"])
    print(f"mesh {tag} world 2 sequence parallelism (2 shards of 2665 tokens, ring attention) "
          f"G/14 4 blocks, 1022 px, bf16: rms_rel {rr:.2e} (float32 input), {rr8:.2e} (uint8) vs "
          f"one rank (bound <= 1e-2); {secs('sp')} s per rank", flush=True)
    check(max(rr, rr8) <= 1e-2, "sequence parallelism disagrees")
    ep = res["ep"]
    ecos = float(cos_rows(ep["ample_vlads"], ep["single"]).min())
    print(f"mesh {tag} world 2 expert-parallel VLAD (4 experts of [32, 1536], 8 images of 256 "
          f"tokens): min cosine {ecos:.6f} vs the direct VLAD (bound >= 0.9999), all kept "
          f"{bool(ep['ample_kept'].all())}; {secs('ep')} s per rank", flush=True)
    check(ecos >= 0.9999 and ep["ample_kept"].all(), "expert-parallel VLAD disagrees")
    km = res["kmeans"]
    kerr = float(np.abs(km["cos_sharded"] - km["cos_single"]).max())
    se = res["search"]
    ids = {sd: bool(np.array_equal(se[f"{sd}_i"], se[f"{sd}_single_i"]))
           for sd in ("f32", "bf16")}
    serr = float(np.abs(se["f32_s"] - se["f32_single_s"]).max())
    print(f"mesh {tag} world 2 sharded k-means (50,000 x 1536, 32 centers, 10 iterations): max "
          f"center difference {kerr:.2e} vs kmeans_fit (bound 1e-4), {secs('kmeans')} s per "
          f"rank; sharded exact search (20,000 x 1536, 256 queries, k 20): ids equal to "
          f"top_k_search {ids}, max f32 score difference {serr:.2e} (bound 1e-5), "
          f"{secs('search')} s per rank", flush=True)
    check(kerr <= 1e-4 and ids["f32"] and serr <= 1e-5, "sharded k-means / search disagrees")
    return counts


def grads_err(got, prefix="grad.", ref="single_grad."):
    """(the largest error over its tensor's largest |g| among the gradients
    above 1e-3 of the model's largest, the largest error over the model's
    largest |g| among the others (they vanish in exact arithmetic, e.g. a
    key bias's: what is left is rounding noise), the gradients in each
    group) of the arrays ``got[prefix + name]`` against ``got[ref +
    name]``."""
    import numpy as np

    names = [k[len(prefix):] for k in got if k.startswith(prefix)]
    top = max(float(np.abs(got[ref + k]).max()) for k in names)
    live, vanishing = [0.0], [0.0]
    for k in names:
        mx = float(np.abs(got[ref + k]).max())
        err = float(np.abs(got[prefix + k] - got[ref + k]).max())
        (live if mx >= 1e-3 * top else vanishing).append(err / (mx if mx >= 1e-3 * top else top))
    return max(live), max(vanishing), len(live) - 1, len(vanishing) - 1


def dptrain_verdict(dp: dict, k5: list) -> tuple:
    """(ok, text) of ``mesh_checks``' "full" dptrain results ``dp`` (FSDP over
    data 2) with K5's launches per rank ``k5``: the loss within 1e-5
    relative of the one-rank step's; the averaged gradients (the first
    moments, gathered whole) within 1e-4 of each tensor's max|m| and the
    vanishing ones within 1e-6 of the largest; the parameters after the
    step within 0.5 lr of the one-rank step's where the update is lr times
    the gradient's sign (a slice that missed its update or its gather lies
    1 lr off); a rank 0.55 or less of the replicated Adam bytes; K5
    launched on every rank."""
    loss, single = float(dp["losses"][0]), float(dp["single_loss"])
    loss_rel = abs(loss - single) / abs(single)
    adam_share = float(dp["rank_adam_bytes"]) / float(dp["replicated_adam_bytes"])
    live, vanishing, update = (float(v) for v in dp["fsdp_vs_single"])
    s_live, s_vanishing, s_update = (float(v) for v in dp["single_spread"])
    ok = (loss_rel <= 1e-5 and live <= 1e-4 and vanishing <= 1e-6 and update <= 0.5
          and adam_share < 0.55 and min(k5) > 0)
    text = (f"dvgl vit + NetVLAD-64, FSDP over data 2, 224 px, 4 tuples of 12 (2 a rank), "
            f"Adam 1e-5, one step against the one-rank step on the same tuples: loss {loss:.6f} "
            f"vs {single:.6f} (rel {loss_rel:.2e}, bound 1e-5); the averaged gradients (first "
            f"moments, gathered) {live:.2e} of each max|m| (bound 1e-4), vanishing ones "
            f"{vanishing:.2e} of the largest (bound 1e-6); parameters after the step {update:.3f} "
            f"lr apart where the update is lr x sign(g) (bound 0.5); two one-rank steps: "
            f"{s_live:.2e} / {s_vanishing:.2e} / {s_update:.3f} lr; a rank holds "
            f"{adam_share:.3f} of the replicated Adam bytes; step "
            f"{float(dp['step_seconds']):.2f} s (Gloo) vs {float(dp['single_seconds']):.2f} s one "
            f"rank (first step, allocation included); K5 launches per rank {k5}")
    return ok, text


def syncbn_verdict(sb: dict) -> tuple:
    """(ok, text) of ``mesh_checks``' "full" syncbn results ``sb`` (4 images
    at 480x640 over data 2, against one rank on the whole batch):
    resnet18conv4 + NetVLAD-64 in float32, its outputs and statistics within
    1e-4 of their max|value| (its gradients are shown beside the one rank's
    own spread under a 1e-7 move of the images: a random init's float32
    gradients are ill-conditioned there); the resnet18conv4 trunk in
    float64, its outputs, statistics and gradients within 1e-4 (the
    vanishing gradients 1e-6 of the largest), which tests the backward of
    the statistics' reduction; the ranks' statistics equal."""
    import numpy as np

    def rel(prefix, ref):
        return max(float(np.abs(sb[k] - sb[ref + k[len(prefix):]]).max()
                         / (np.abs(sb[ref + k[len(prefix):]]).max() + 1e-30))
                   for k in sb if k.startswith(prefix))

    g32, v32, n32, _ = grads_err(sb)
    prel, pvan, _, _ = grads_err(sb, prefix="perturbed_grad.")
    g64, v64, n64, _ = grads_err(sb, prefix="f64_grad.", ref="f64_single_grad.")
    out32, stat32 = rel("out", "single_out"), rel("stat.", "single_stat.")
    out64, stat64 = rel("f64_out", "f64_single_out"), rel("f64_stat.", "f64_single_stat.")
    ok = (max(out32, stat32, out64, stat64, g64) <= 1e-4 and v64 <= 1e-6
          and float(sb["stat_spread"]) == 0.0)
    text = (f"sync_axis='data', train=True, 4 images at 480x640 over 2 ranks, vs one rank on the "
            f"whole batch (largest error / max|value|): resnet18conv4 + NetVLAD-64 in float32: "
            f"outputs {out32:.2e}, statistics {stat32:.2e} (bound 1e-4), {n32} gradients "
            f"{g32:.2e} of each max|g| (vanishing ones {v32:.2e}; not bounded: the one rank's "
            f"own spread when its images move by 1e-7 of themselves is {prel:.2e} ({pvan:.2e})); "
            f"the resnet18conv4 trunk in float64: outputs {out64:.2e}, statistics {stat64:.2e}, "
            f"{n64} gradients {g64:.2e} of each max|g| (bound 1e-4), vanishing ones {v64:.2e} "
            f"of the largest (bound 1e-6); ranks' statistics equal "
            f"{float(sb['stat_spread']) == 0.0}; {float(sb['seconds']):.2f} s (Gloo, float32)")
    return ok, text


def pptrain_verdict(pt: dict, k5: list) -> tuple:
    """(ok, text) of ``mesh_checks``' "full" pptrain results ``pt`` (dvgl's
    vit + NetVLAD-64, its 12 blocks pipelined over model 2, 4 tuples of 12
    at 224 px, Adam 1e-5) with K5's launches per rank ``k5``: the loss
    within 1e-5 relative of the one-rank step's; the first moments (every
    rank holds the whole gradient) within 1e-4 of each max|m|, the
    vanishing ones within 1e-6 of the largest; the parameters after the
    step within 0.5 lr where the update is lr times the gradient's sign
    (a stage whose gradient went missing, or counted twice, lies 1 lr
    off); both ranks' parameters equal; K5 launched on each stage for its
    blocks alone."""
    loss, single = float(pt["loss"]), float(pt["single_loss"])
    loss_rel = abs(loss - single) / abs(single)
    live, vanishing, update = (float(v) for v in pt["pp_vs_single"])
    s_live, s_vanishing, s_update = (float(v) for v in pt["single_spread"])
    spread = float(pt["rank_spread"])
    ok = (loss_rel <= 1e-5 and live <= 1e-4 and vanishing <= 1e-6 and update <= 0.5
          and spread == 0.0 and min(k5) > 0)
    text = (f"dvgl vit + NetVLAD-64, 12 blocks pipelined over model 2 (6 a stage), 224 px, 4 "
            f"tuples of 12, Adam 1e-5, one step against the one-rank step: loss {loss:.6f} vs "
            f"{single:.6f} (loss rel {loss_rel:.2e} (bound 1e-5)); first moments {live:.2e} of "
            f"each max|m| (bound 1e-4), vanishing ones {vanishing:.2e} (bound 1e-6); parameters "
            f"after the step {update:.3f} lr apart (bound 0.5); two one-rank steps: "
            f"{s_live:.2e} / {s_vanishing:.2e} / {s_update:.3f} lr; the ranks' parameters "
            f"{spread:.1e} apart; step {float(pt['seconds']):.2f} s (Gloo) vs "
            f"{float(pt['single_seconds']):.2f} s one rank; K5 launches per rank {k5}")
    return ok, text


def sptrain_verdict(sp: dict) -> tuple:
    """(ok, text) of ``mesh_checks``' "full" sptrain results ``sp`` (dvgl's
    ViT-B/16 float32, 8 images at 224 px, 197 tokens in 2 shards, block
    11's value facet): the gradients of sum(facets * w) within 1e-4 of
    their tensor's max|g| of the trunk's on one rank (the vanishing ones
    1e-6 of the largest), the facets within 1e-5 of their largest."""
    import numpy as np

    tag = "11_value"
    got = {k[len(tag) + 1:]: v for k, v in sp.items() if k.startswith(tag + "_")}
    rel, van, n, nv = grads_err(got)
    orel = float(np.abs(got["out"] - got["single_out"]).max() / np.abs(got["single_out"]).max())
    ok = rel <= 1e-4 and van <= 1e-6 and orel <= 1e-5
    text = (f"dvgl ViT-B/16 float32, 8 images at 224 px, 197 tokens in 2 ring shards, sum(value "
            f"facet of block 11 * w) against the trunk on one rank: {n} gradients {rel:.2e} of "
            f"their max|g| (bound 1e-4), {nv} vanishing {van:.2e} of the largest (bound 1e-6), "
            f"facets {orel:.2e} (bound 1e-5); forward + backward {float(got['seconds']):.2f} s "
            f"(Gloo) vs {float(got['single_seconds']):.2f} s one rank")
    return ok, text


def train_mesh_phase(mesh, work: Path, tag: str) -> dict:
    """The training half of ``parallel/`` at full width; returns K2's
    gradient record and the launches of the phase's sharded calls (zeroed
    just before each, read just after; the ranks count theirs inside
    ``mesh_checks.Rank.sharded``).

    K2 under autograd (``FlashAttentionGrad``) at a tensor-parallel rank's
    [48, 6, 197, 64] float32 against its plain version's gradient, timed.
    World 1, NCCL, in this process (``mesh``): one FSDP step of dvgl's vit
    + NetVLAD-64 (224 px, 4 tuples of 1 + 1 + 10) against the plain step
    from the same weights (a second plain step gives the card's own
    spread), and resnet18conv4 + NetVLAD-64 with ``sync_axis="data"``,
    ``train=True`` at 480x640 against local BatchNorm. World 2, Gloo, both
    ranks on this card (``tools/mesh_checks.py``, profile "full"): the F24
    collectives, ``dptrain`` (dvgl vit FSDP over data 2,
    ``dptrain_verdict``), ``tptrain`` (the tp_split vit over model 2, K2
    with its gradient), ``syncbn`` (resnet18conv4, 4 images at 480x640
    over 2 ranks, ``syncbn_verdict``) and ``restore`` against one
    rank; seconds per rank are Gloo through host memory."""
    import functools

    import numpy as np
    import torch

    from anyloc_tpu_torch.models.convert import materialize
    from anyloc_tpu_torch.ops import kernels as K
    from anyloc_tpu_torch.parallel.fsdp import fsdp_shardings, fsdp_train_step
    from anyloc_tpu_torch.parallel.mesh import use_mesh
    from anyloc_tpu_torch.tools import mesh_checks, train_checks
    from anyloc_tpu_torch.tools._timing import time_ms
    from anyloc_tpu_torch.training.network import GeoLocalizationNet
    from anyloc_tpu_torch.training.triplet import make_triplet_train_step

    work.mkdir(parents=True)
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    counts = {}

    def counted(fn):
        K.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        for name, n in K.launch_counts().items():
            if n:
                counts[name] = counts.get(name, 0) + n
        return out

    # K2's gradient at a TP rank's shape
    from anyloc_tpu_torch.ops.kernels.flash_attention import attention_bwd_route

    b, h, n, hd = 48, 6, 197, 64
    route = attention_bwd_route(hd, torch.float32)
    route_name = "Kab_attention_bwd_" + route
    before_route = K.KERNELS[route_name].launches
    r = train_checks.k2_gradient(b, h, n, hd, torch.float32)
    check(K.KERNELS[route_name].launches == before_route + 1,
          f"K2's gradient did not run the {route} attention backward")
    errs = ", ".join(f"{k} {v:.3e}" for k, v in r["grad_errs"].items())
    check(r["ok"], "K2's gradient disagrees with its plain version's")
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn((b, h, n, hd), generator=g, device=dev).requires_grad_(True)
               for _ in range(3))
    out = K.flash_attention(q, k, v)
    ref = K.flash_attention_ref(q, k, v)
    gout = torch.randn(out.shape, generator=g, device=dev)
    fwd_ms = time_ms(lambda: K.flash_attention(q, k, v), iters=5, reps=2)
    plain_ms = time_ms(lambda: K.flash_attention_ref(q, k, v), iters=5, reps=2)
    with torch.no_grad():   # the kernel alone, and the library's f32 forward
        kernel_ms = time_ms(lambda: K.flash_attention(q, k, v), iters=5, reps=2)
        lib_fwd_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v),
                             iters=5, reps=2)
    fwd_ops, fwd_bytes = 4 * b * h * n * n * hd, 4 * 4 * b * h * n * hd
    fwd = bound({"tf32": TF32X3 * fwd_ops}, fwd_bytes)
    fwd_fma = bound({"f32": fwd_ops}, fwd_bytes)
    first = torch.autograd.grad(out, (q, k, v), gout, retain_graph=True)
    again = torch.autograd.grad(out, (q, k, v), gout, retain_graph=True)
    spread = max((a - c).abs().max().item() for a, c in zip(first, again))
    bwd_ms, plain_bwd_ms = turns(
        lambda: torch.autograd.grad(out, (q, k, v), gout, retain_graph=True),
        lambda: torch.autograd.grad(ref, (q, k, v), gout, retain_graph=True))
    sdpa = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(sdpa, (q, k, v), gout, retain_graph=True),
                         iters=5, reps=2)
    # the backward's five products (S recomputed, dP, dV, dQ, dK) in f32 as
    # three tf32 products each, or at the FMA peak, or q, k, v, O, dO read and
    # dq, dk, dv written
    bwd_ops, bwd_bytes = 10 * b * h * n * n * hd, 8 * 4 * b * h * n * hd
    bwd = bound({"tf32": TF32X3 * bwd_ops}, bwd_bytes)
    bwd_fma = bound({"f32": bwd_ops}, bwd_bytes)
    grad_rec = dict(shape=f"[{b},{h},{n},{hd}] float32", forward_ms=fwd_ms, plain_forward_ms=plain_ms,
                    kernel_ms=kernel_ms, library_forward_ms=lib_fwd_ms, forward_bound_ms=fwd["bound_ms"],
                    forward_bound_by=fwd["bound_by"], forward_fma_bound_ms=fwd_fma["bound_ms"],
                    backward_ms=bwd_ms, plain_backward_ms=plain_bwd_ms,
                    library_backward_ms=lib_bwd_ms, max_grad_err=r["worst"],
                    backward_spread=spread,
                    max_abs_err=max((a - w).abs().max().item() for a, w in zip(
                        first, torch.autograd.grad(ref, (q, k, v), gout, retain_graph=True))),
                    backward_fma_bound_ms=bwd_fma["bound_ms"],
                    **{f"backward_{k_}": v_ for k_, v_ in bwd.items()})
    print(f"K2 gradient {tag} q/k/v [{b},{h},{n},{hd}] float32 (forward kernel, attention "
          f"backward kernel on its {route} route, FlashAttentionGrad): max|err| / max|g| {errs} "
          f"(bound "
          f"{train_checks.BOUND:.0e}); output {r['out_err']:.3e}, bit-equal without autograd "
          f"{r['bit_equal']}; grad_fn {r['grad_fn']}; forward under autograd "
          f"{fwd_ms:.3f} ms (without autograd {kernel_ms:.3f}; plain {plain_ms:.3f}, SDPA's "
          f"forward {lib_fwd_ms:.3f}, bound {fwd['bound_ms']:.4f} ms ({fwd['bound_by']}, 3xTF32), "
          f"FMA bound {fwd_fma['bound_ms']:.4f}), backward {bwd_ms:.3f} ms (the plain version's "
          f"autograd {plain_bwd_ms:.3f}, SDPA's backward {lib_bwd_ms:.3f}; bound "
          f"{bwd['bound_ms']:.4f} ms ({bwd['bound_by']}, 3xTF32), FMA bound "
          f"{bwd_fma['bound_ms']:.4f}); largest difference between two backward calls "
          f"{spread:.3e} (bound 0: no atomics)", flush=True)
    check(spread == 0.0, "K2's backward differs between two calls on the same inputs")
    del q, k, v, out, ref, gout, sdpa, first, again
    # the backward's memory at N 1370 (ViT-B/14 at 518 px, which the vit
    # trunk sends to K2 under grad): its peak above its inputs against its
    # outputs and its f32 scratch of attention_bwd_slices dq slices
    from anyloc_tpu_torch.ops.kernels.flash_attention import BWD_KEYS, attention_bwd_slices

    mb, mh, mn = 48, 12, 1370
    q, k, v = (torch.randn((mb, mh, mn, hd), generator=g, device=dev).requires_grad_(True)
               for _ in range(3))
    out = K.flash_attention(q, k, v)
    gout = torch.randn(out.shape, generator=g, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    mem_route = attention_bwd_route(hd, torch.float32)
    before_route = K.KERNELS["Kab_attention_bwd_" + mem_route].launches
    torch.autograd.grad(out, (q, k, v), gout)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    check(K.KERNELS["Kab_attention_bwd_" + mem_route].launches
          == before_route + 1, f"the memory line's backward did not run on {mem_route}")
    size = mb * mh * mn * hd * 4
    slices = attention_bwd_slices(mb, mh, mn)
    memory = dict(shape=f"[{mb},{mh},{mn},{hd}] float32", route=mem_route,
                  peak_mb=peak / 2 ** 20,
                  outputs_mb=3 * size / 2 ** 20, scratch_mb=slices * size / 2 ** 20,
                  slices=slices, per_key_block_mb=-(-mn // BWD_KEYS) * size / 2 ** 20)
    print(f"K2 backward memory {tag} q/k/v {memory['shape']} ({mem_route} route): peak above "
          f"its inputs {memory['peak_mb']:.1f} MB (outputs {memory['outputs_mb']:.1f} MB, dq scratch "
          f"{memory['scratch_mb']:.1f} MB in {slices} slices; a slice per key block would take "
          f"{memory['per_key_block_mb']:.1f} MB)", flush=True)
    check(peak <= 1.05 * (memory["outputs_mb"] + memory["scratch_mb"]) * 2 ** 20 + 2 ** 26,
          "K2's backward takes more memory than its outputs and its bounded scratch")
    grad_rec["memory"] = memory
    del q, k, v, out, gout

    # world 1 (NCCL): an FSDP step against the plain step
    model = materialize(lambda: GeoLocalizationNet("vit", "netvlad", 64, img_size=224), None,
                        "cuda", seed=0)
    params = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    step = make_triplet_train_step(train_checks.descriptor_fn(model),
                                   functools.partial(torch.optim.Adam, lr=1e-5), neg_num=10)
    tuples = torch.from_numpy(mesh_checks.dvgl_tuples("full")).to(dev)
    runs = {}
    fstep = fsdp_train_step(step, fsdp_shardings(params, mesh))
    for label in ("plain a", "plain b", "fsdp"):
        run = fstep if label == "fsdp" else step
        state = run.init_state(params)
        state, loss = counted(lambda: run(state, tuples)) if label == "fsdp" else run(state, tuples)
        torch.cuda.synchronize()
        after = {k_: v_.detach().clone() for k_, v_ in state.params.items()}
        ms = time_ms(lambda: run(state, tuples), iters=2, reps=2, warmup=0)   # further steps
        runs[label] = (loss.item(), after, ms)
        del state, after
    (la, pa, msa), (lb, pb, _), (lf, pf, msf) = runs["plain a"], runs["plain b"], runs["fsdp"]
    spread = max(float((pa[k_] - pb[k_]).abs().max()) for k_ in pa)
    fdiff = max(float((pa[k_] - pf[k_]).abs().max()) for k_ in pa)
    same = lf == la and fdiff == 0.0
    print(f"train mesh {tag} world 1 (NCCL) fsdp_train_step over local_mesh(1), dvgl vit + "
          f"NetVLAD-64, 224 px, 4 tuples of 12, Adam 1e-5: loss {lf:.6f} vs the plain step's "
          f"{la:.6f}, parameters after the step {fdiff:.3e} apart (two plain steps: "
          f"{spread:.3e}); bit-equal {same}; step {msf:.2f} ms (FSDP) vs {msa:.2f} ms (plain), "
          f"best of 2 means over 2 more steps each", flush=True)
    check(fdiff <= spread and abs(lf - la) <= abs(lb - la) + 0.0,
          "the world-1 FSDP step falls outside the spread of two plain steps")
    del runs, pa, pb, pf, model, params, step, fstep
    torch.cuda.empty_cache()

    # world 1: sync BatchNorm over an axis of one rank against local BatchNorm
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (4, 480, 640, 3)).astype(np.float32)).to(dev)
    outs = []
    for sync in ("data", None):
        net = materialize(lambda: GeoLocalizationNet("resnet18conv4", "netvlad", 64,
                                                     sync_axis=sync), None, "cuda", seed=0)
        with torch.no_grad(), use_mesh(mesh):
            o = net(x, train=True)
        stats = {k_: v_.clone() for k_, v_ in net.named_buffers()}
        outs.append((o, stats))
        del net
    (oa, sa), (ob, sb) = outs
    bn_same = torch.equal(oa, ob) and all(torch.equal(sa[k_], sb[k_]) for k_ in sa)
    print(f"train mesh {tag} world 1 (NCCL) sync BatchNorm over an axis of 1 rank, "
          f"resnet18conv4 + NetVLAD-64, train=True, 4 images at 480x640: outputs and statistics "
          f"bit-equal to local BatchNorm: {bn_same}", flush=True)
    check(bn_same, "sync BatchNorm over one rank differs from local BatchNorm")
    del outs, oa, ob, x
    torch.cuda.empty_cache()
    world1 = dict(counts)
    t1 = time.perf_counter() - t_phase

    # world 2: Gloo, both ranks on this card
    cases = ["collectives", "dptrain", "tptrain", "syncbn", "restore", "pptrain", "sptrain"]
    t0 = time.perf_counter()
    report = mesh_checks.launch(work / "world2", 2, "gloo", "cuda", "full", cases, timeout=600)
    launch_s = time.perf_counter() - t0
    res = {c: mesh_checks.results(work / "world2", c) for c in cases}

    def secs(case):
        return "/".join(f"{report[r_][case]['seconds']:.2f}" for r_ in sorted(report))

    def launches(case, name):
        return [report[r_][case]["launches"].get(name, 0) for r_ in sorted(report)]

    co = res["collectives"]
    print(f"train mesh {tag} world 2 (Gloo, one card) F24 collectives: every generic collective "
          f"raises under grad {bool(co['raised'].all())}, grad off runs the plain collective "
          f"{bool(co['grad_off'].all())}", flush=True)
    check(co["raised"].all() and co["grad_off"].all(), "F24: a collective without a backward")
    ok, text = dptrain_verdict(res["dptrain"], launches("dptrain", "K5_flash_attention_qkv_proj"))
    print(f"train mesh {tag} world 2 dptrain: {text}; {secs('dptrain')} s per rank", flush=True)
    check(ok, "dptrain disagrees")
    tp = res["tptrain"]
    trel, tvan, tn, tvn = grads_err(tp)
    orel = float(np.abs(tp["out"] - tp["single_out"]).max() / np.abs(tp["single_out"]).max())
    k2 = launches("tptrain", "K2_flash_attention")
    print(f"train mesh {tag} world 2 tptrain: dvgl vit (tp_split, 6 heads a rank) + NetVLAD-64, "
          f"48 images at 224 px, float32, vs the unsharded trunk on one rank: {tn} gradients, "
          f"largest error / their max|g| {trel:.2e} (bound 1e-4); {tvn} that vanish in exact "
          f"arithmetic (below 1e-3 of the largest |g|: the key biases), largest error / the "
          f"largest |g| {tvan:.2e} (bound 1e-6); outputs {orel:.2e}, replicated gradients equal "
          f"on both ranks {float(tp['replicated_spread']) == 0.0}; K2 launches per rank under "
          f"autograd {k2}; {float(tp['seconds']):.2f} s forward + backward (Gloo); "
          f"{secs('tptrain')} s per rank", flush=True)
    check(trel <= 1e-4 and tvan <= 1e-6 and min(k2) > 0, "tptrain disagrees")
    ok, text = syncbn_verdict(res["syncbn"])
    print(f"train mesh {tag} world 2 syncbn: {text}; {secs('syncbn')} s per rank", flush=True)
    check(ok, "syncbn disagrees")
    rs = res["restore"]
    rdiff, spread2 = float(rs["restore_resume_diff"][0]), float(rs["spread"])
    print(f"train mesh {tag} world 2 restore: dvgl vit FSDP state saved (rank 0 writes the whole "
          f"moments), load_checkpoint(target=) into each rank's slices, the next step "
          f"{rdiff:.3e} from the uninterrupted one (two uninterrupted runs: {spread2:.3e}), "
          f"moments {float(rs['restore_resume_diff'][1]):.3e}; {secs('restore')} s per rank",
          flush=True)
    check(rdiff <= spread2 and int(rs["restore_layout_mismatches"]) == 0,
          "the resumed step lies outside the spread of two uninterrupted steps")
    ok, text = pptrain_verdict(res["pptrain"], launches("pptrain", "K5_flash_attention_qkv_proj"))
    print(f"train mesh {tag} world 2 pptrain (F25): {text}; {secs('pptrain')} s per rank",
          flush=True)
    note(f"pptrain {text[text.index('loss rel'):text.index(' (bound 1e-5)')]}, "
         f"K5/rank {launches('pptrain', 'K5_flash_attention_qkv_proj')}, ok {ok}")
    check(ok, "pptrain disagrees")
    ok, text = sptrain_verdict(res["sptrain"])
    print(f"train mesh {tag} world 2 sptrain (F25): {text}; {secs('sptrain')} s per rank",
          flush=True)
    check(ok, "sptrain disagrees")
    note(f"sptrain ok {ok}; dptrain, tptrain, syncbn, restore ok")
    for rank in report.values():
        for case in rank.values():
            for name, n_ in case["launches"].items():
                counts[name] = counts.get(name, 0) + n_
    print(f"train mesh {tag}: world 1 {t1:.1f} s, world 2 {launch_s:.1f} s (the ranks' start "
          f"included); launches of the sharded calls: world 1 {world1}, together {counts}",
          flush=True)
    return dict(counts=counts, k2_grad=grad_rec,
                k2_tptrain=sum(launches("tptrain", "K2_flash_attention")),
                k5_fsdp=world1.get("K5_flash_attention_qkv_proj", 0)
                + sum(launches("dptrain", "K5_flash_attention_qkv_proj"))
                + sum(launches("restore", "K5_flash_attention_qkv_proj")),
                k5_pptrain=launches("pptrain", "K5_flash_attention_qkv_proj"))


def tooling_phase(vlad, jpegs, work: Path, tag: str) -> dict:
    """``python -m anyloc_tpu_torch viz clusters`` and ``viz report`` through
    ``cli.main`` at DINOv2-G/14 layer 31 value (bf16, random weights from
    the extractor's default seed, on the card), VLAD-32's vocabulary in
    the CLI's vocab_dir, 448-px images (K5's token range): an overlay per
    image, and the report's labels equal to the extractor +
    ``assign_labels`` run directly; K5 launches counted over each call."""
    import json as _json

    import numpy as np
    from PIL import Image

    from anyloc_tpu_torch import DinoV2ExtractFeatures, cli
    from anyloc_tpu_torch.data.base import natsorted
    from anyloc_tpu_torch.data.transforms import preprocess_image
    from anyloc_tpu_torch.ops import kernels as K
    from anyloc_tpu_torch.ops.kmeans import assign_labels
    from anyloc_tpu_torch.pipelines.demo import vocab_dir

    work.mkdir(parents=True)
    imgs = work / "imgs"
    imgs.mkdir()
    for p in jpegs[:8]:
        shutil.copy(p, imgs / Path(p).name)
    vdir = vocab_dir(str(work / "cache"), "dinov2_vitg14", 31, "value", 32, "indoor")
    os.makedirs(vdir)
    np.savez(os.path.join(vdir, "c_centers.npz"), centers=vlad.c_centers.cpu().numpy())
    common = ["--in-dir", str(imgs), "--cache-dir", str(work / "cache"), "--domain", "indoor",
              "--model", "dinov2_vitg14", "--layer", "31", "--facet", "value",
              "--num-clusters", "32", "--max-img-size", "448"]
    counts, secs = {}, {}
    for sub, extra in (("clusters", ["--out-dir", str(work / "clusters")]),
                       ("report", ["--out", str(work / "report.html")])):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["viz", sub, *common, *extra])
        secs[sub] = time.perf_counter() - t0
        counts[sub] = {k: n for k, n in K.launch_counts().items() if n}
        check(rc == 0, f"viz {sub}: rc {rc}")
        check(counts[sub].get("K5_flash_attention_qkv_proj", 0) > 0,
              f"K5 never launched in viz {sub}: {counts[sub]}")
    overlays = sorted((work / "clusters").glob("*_clusters.png"))
    check(len(overlays) == len(list(imgs.iterdir())), f"viz clusters wrote {len(overlays)} files")
    html_text = (work / "report.html").read_text()
    data = _json.loads(html_text.split('<script type="application/json" id="viz-data">')[1]
                       .split("</script>")[0])
    ext = DinoV2ExtractFeatures("dinov2_vitg14", 31, "value")
    centers = vlad.c_centers.to(ext.device)
    same = 0
    paths = natsorted([str(p) for p in imgs.iterdir()])
    for path, item in zip(paths, data["images"]):
        arr = preprocess_image(Image.open(path).convert("RGB"), max_edge=448, crop_multiple=14)
        labels = assign_labels(ext(arr[None])[0], centers).cpu().numpy()
        same += int(np.array_equal(labels, np.array(item["labels"])))
    print(f"viz {tag}: python -m anyloc_tpu_torch viz clusters / report (DINOv2-G/14 l31 value "
          f"bf16, VLAD-32 vocabulary, {len(paths)} fixture JPEGs at 448 px): {len(overlays)} "
          f"overlays in {secs['clusters']:.1f} s wall, the report ({len(html_text) / 1e6:.2f} MB) "
          f"in {secs['report']:.1f} s wall (each with the model build); report labels equal to "
          f"the extractor + assign_labels run directly on {same}/{len(paths)} images; launch "
          f"counts clusters {counts['clusters']}, report {counts['report']}", flush=True)
    check(same == len(paths) == len(data["images"]), "viz report's labels differ from a direct run")
    del ext
    return counts


def repo_programs_phase(work: Path, tag: str) -> dict:
    """The port's counterparts of the repository's JAX programs, on the card:
    ``tools/bench_mlp_xla_int8`` (K3 beside the library MLP half at the JAX
    default token counts), ``tools/bench_serving`` (DINOv2-G l31, 224 px,
    int8_full, 64 requests from 16 client processes, coalesced and batch
    1, every coalesced reply equal to its batch-1 reply),
    ``tools/bench_ivf`` (1,000,000 x 512 clustered, 1024 cells, n_probe
    16), one ``tools/bench_pq_matrix`` grid point, the three examples at
    small sizes (each checked on its printed result), ``dryrun.entry()`` and
    ``dryrun_multichip(2)`` (two Gloo ranks on this card). Returns the
    phase's kernel launches in this process and the library MLP half's
    times."""
    from anyloc_tpu_torch.examples import multichip_retrieval, quickstart, serving
    from anyloc_tpu_torch.ops import kernels as K
    from anyloc_tpu_torch.tools import (bench_ivf, bench_mlp_xla_int8, bench_pq_matrix,
                                        bench_serving, dryrun)

    import numpy as np
    import torch

    work.mkdir(parents=True)
    out = {}

    def timed(label, fn):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            res = fn()
        text = buf.getvalue()
        (work / f"{label}.log").write_text(text)
        return res, text, time.perf_counter() - t0

    # K3 beside the MLP half built from library calls
    K.reset_launch_counts()   # read at the end: the phase's launches in this process
    mlp = bench_mlp_xla_int8.run(iters=20)
    torch.cuda.synchronize()
    check(K.launch_counts()["K3_fused_mlp_int8"] > 0, "K3 never launched in bench_mlp_xla_int8")
    for n, r in mlp["shapes"].items():
        print(f"programs {tag} bench_mlp_xla_int8 N={n} (B 32, D 1536, SwiGLU 4096): library "
              f"MLP half (LN, per-row quantize, torch._int_mm x2, SwiGLU, requantize: a "
              f"composition of library calls) {r['library_ms']:.3f} ms ({r['library_tops']:.1f} "
              f"TOPS) | K3 {r['k3_ms']:.3f} ms ({r['k3_tops']:.1f} TOPS); cosine "
              f"{r['cosine']:.6f} (bound >= 0.999: K3 requantizes per 512 chunk, F1)", flush=True)
        check(r["cosine"] >= 0.999, f"bench_mlp_xla_int8 N={n}: cosine {r['cosine']}")
    out["mlp"] = mlp["shapes"]
    note("mlp " + ", ".join(f"N{n} lib {r['library_ms']:.3f} / K3 {r['k3_ms']:.3f} ms cos "
                            f"{r['cosine']:.5f}" for n, r in mlp["shapes"].items()))

    # the daemon under 16 client processes, coalesced against batch 1
    args = bench_serving.parser().parse_args(
        ["--model", "dinov2_vitg14", "--layer", "31", "--img-size", "224", "--quant",
         "int8_full", "--requests", "64", "--clients", "16"])
    srv, text, sec = timed("bench_serving", lambda: bench_serving.run(args))
    c1, c16 = srv["configs"][1], srv["configs"][16]
    eq = srv["equal"]
    print(f"programs {tag} bench_serving (G/14 l31, 224 px, int8_full, uint8, 64 requests from "
          f"16 client processes, 10,000-row database): batch 1 {c1['qps']:.2f} requests/s, p50 "
          f"{c1['p50_ms']:.1f} / p99 {c1['p99_ms']:.1f} ms; coalesced (max 16) "
          f"{c16['qps']:.2f} requests/s, p50 {c16['p50_ms']:.1f} / p99 {c16['p99_ms']:.1f} ms, "
          f"mean batch {c16['mean_batch']:.2f}; speedup {srv['speedup']:.2f}x; every coalesced "
          f"reply equal to its batch-1 reply: scores within {eq['max_score_diff']:.2e} (bound "
          f"{bench_serving.SCORE_TOL}), ids on {eq['ids_compared']}/{eq['ranks']} separated "
          f"ranks; {sec:.1f} s", flush=True)
    for line in text.splitlines():
        if line.startswith("    "):
            print(f"programs {tag} bench_serving stage{line}", flush=True)
    # the check's reach: the closest two images' batch-1 top-5 scores, and
    # a planted swap of two coalesced replies, which must fail the check
    b1 = srv["replies"][1]
    top5 = np.array([b1[i]["scores"] for i in sorted(b1)], np.float64)
    near = min(float(np.abs(top5[i] - top5[j]).max()) for i in range(len(top5))
               for j in range(i + 1, len(top5)))
    swapped = dict(srv["replies"][16])
    swapped[0], swapped[1] = swapped[1], swapped[0]
    try:
        bench_serving.compare(swapped, b1)
        caught = False
    except RuntimeError:
        caught = True
    print(f"programs {tag} bench_serving check: top-5 scores {top5.min():.5f}..{top5.max():.5f}, "
          f"closest two images' top-5 apart by {near:.2e} (bound {bench_serving.SCORE_TOL}); "
          f"the replies of images 0 and 1 swapped: {'raised' if caught else 'PASSED'}",
          flush=True)
    check(caught and near > bench_serving.SCORE_TOL,
          f"bench_serving: a swapped reply passed the check (closest images {near:.2e})")
    note(f"serving b1 {c1['qps']:.2f} r/s p99 {c1['p99_ms']:.0f} ms, b16 {c16['qps']:.2f} r/s "
         f"p99 {c16['p99_ms']:.0f} ms, replies equal (scores {eq['max_score_diff']:.1e} <= "
         f"{bench_serving.SCORE_TOL}), swap caught (closest images {near:.1e})")
    out["serving"] = dict(b1=c1["qps"], b16=c16["qps"], p99_1=c1["p99_ms"], p99_16=c16["p99_ms"])

    # IVF against exact search
    ivf, text, sec = timed("bench_ivf", lambda: bench_ivf.run(n_db=1_000_000, dim=512,
                                                             n_cells=1024, n_probe=16))
    p16 = ivf["probes"][16]
    print(f"programs {tag} bench_ivf (1,000,000 x 512 clustered, 1024 cells, fit "
          f"{ivf['fit_s']:.1f} s, bucket cap {ivf['cap']}, overflow {ivf['overflow']}): exact "
          f"{ivf['exact_qps']:.0f} queries/s; ivf n_probe 16 {p16['qps']:.0f} queries/s "
          f"({p16['qps'] / ivf['exact_qps']:.2f}x), R1 {p16['r1']:.3f}, recall@20 "
          f"{p16['recall']:.3f} against exact; {sec:.1f} s", flush=True)
    check(0.0 < p16["recall"] <= 1.0 and p16["qps"] > 0, "bench_ivf gave no reading")
    note(f"ivf 1M: exact {ivf['exact_qps']:.0f} q/s, p16 {p16['qps']:.0f} q/s R@20 "
         f"{p16['recall']:.3f}, fit {ivf['fit_s']:.1f} s")

    # one point of the PQ / IVF / IVF-PQ grid
    tag_pq, argv = next((t, a) for t, a in bench_pq_matrix.RUNS if t == "1M_pq_tables_bf16")
    lines, _, sec = timed("bench_pq_matrix", lambda: bench_pq_matrix.run(
        tag_pq, bench_pq_matrix.BASE + argv, str(work / "pq_matrix.jsonl")))
    eng = [json.loads(x) for x in lines if '"engine"' in x]
    check(len(eng) == 1 and eng[0]["qps"] > 0, f"bench_pq_matrix {tag_pq}: {lines}")
    print(f"programs {tag} bench_pq_matrix {tag_pq}: {eng[0]['engine']} {eng[0]['qps']:.0f} "
          f"queries/s, recall@20 vs exact {eng[0]['recall_vs_exact']:.4f}, fit "
          f"{eng[0]['fit_s']:.1f} s, index {eng[0]['index_bytes'] / 2**20:.1f} MB; {sec:.1f} s",
          flush=True)
    note(f"pq_matrix {tag_pq} {eng[0]['qps']:.0f} q/s R {eng[0]['recall_vs_exact']:.3f}")

    # the examples, small
    res, text, sec = timed("quickstart", lambda: quickstart.main([]))
    rec = {k: v for k, v in res.items() if k.startswith("R@")}
    check(set(rec) == {"R@1", "R@5", "R@10"} and all(0 <= v <= 1 for v in rec.values())
          and str(rec) in text, f"quickstart printed {text[-300:]}")
    print(f"programs {tag} examples.quickstart (synthetic gardens, ViT-S/14 l5, VLAD-8, on the "
          f"card): printed {rec}; {sec:.1f} s", flush=True)
    res, text, sec = timed("serving", lambda: serving.main(["--n-images", "32", "--batch", "16"]))
    check("self-retrieval R@1=1.00" in text and ("PIL fallback" in text or "decode=yes" in text),
          f"serving example printed {text[-400:]}")
    stages = [ln for ln in text.splitlines() if ln.startswith("[")]
    print(f"programs {tag} examples.serving (32 JPEGs, ViT-S/14 l11 int8_full, uint8, 224 px): "
          + " | ".join(stages) + f"; {sec:.1f} s", flush=True)
    res, text, sec = timed("multichip", lambda: multichip_retrieval.main(["--devices", "2"]))
    check("exact self-match rate 1.00" in text and "(4, 8192)" in text and "kept=4" in text
          and "(2, 16, 96)" in text, f"multichip example printed {text[-600:]}")
    print(f"programs {tag} examples.multichip_retrieval (2 Gloo ranks on this card, the JAX "
          f"example's sizes): " + " | ".join(text.strip().splitlines()[1:]) + f"; {sec:.1f} s",
          flush=True)
    note(f"examples ok: quickstart {rec}, serving R@1 1.00, multichip equalities")

    # __graft_entry__'s counterparts
    fn, ex_args = dryrun.entry()
    t0 = time.perf_counter()
    v = fn(*ex_args)
    torch.cuda.synchronize()
    check(tuple(v.shape) == (4, 32 * 1536) and bool(torch.isfinite(v).all()),
          f"entry(): {tuple(v.shape)}")
    print(f"programs {tag} dryrun.entry(): G/14 bf16 l31 value + VLAD-32 on 4 zero images of "
          f"224 px -> {tuple(v.shape)}, finite; {time.perf_counter() - t0:.2f} s", flush=True)
    del fn, ex_args, v
    torch.cuda.empty_cache()
    lines = []
    t0 = time.perf_counter()
    dryrun.dryrun_multichip(2, emit=lines.append)
    oks = [ln for ln in lines if " ok" in ln]
    for ln in lines:
        print(f"programs {tag} dryrun_multichip(2): {ln}", flush=True)
    check(len(oks) == 9, f"dryrun_multichip(2) printed {len(oks)} ok lines")
    print(f"programs {tag} dryrun_multichip(2): {len(oks)} ok lines (the JAX dryrun's at 2 "
          f"devices), {time.perf_counter() - t0:.1f} s", flush=True)
    out["launches"] = {n: c for n, c in K.launch_counts().items() if c}
    print(f"programs {tag}: launches in this process (bench_mlp_xla_int8, the quickstart and "
          f"serving examples, entry(); the daemons and ranks count in their own) "
          f"{out['launches']}", flush=True)
    note(f"entry ok; dryrun_multichip(2) {len(oks)}/9 ok lines; launches "
         + ", ".join(f"{n.split('_')[0]} {c}" for n, c in out["launches"].items()))
    return out


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
                    help="also write torch.profiler tables of the throughput shapes and of the "
                         "compressed engines beside their sharded twins to DIR")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path needs one card",
              file=sys.stderr)
        return 2
    with tee_output(LOG):
        print(f"chip_smoke: the whole output also goes to {LOG}", flush=True)
        try:
            kernels = run(args.profile)
        except BaseException as e:
            for line in summary_lines(failed=True):
                print(line, flush=True)
            if isinstance(e, SmokeFailure):
                print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
                return 1
            raise
        for line in summary_lines():
            print(line, flush=True)
        print(json.dumps({"kernels": list(kernels.values())}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
