// T3 — the int8 attention half with two experiment knobs.
//
// Replaces tools/bench_xlayer.py::attn_half_variant (:150; body
// _attn_half_variant_kernel :62), K4's dataflow (attn_half_int8.cu) with
// zero biases (:160-165; + 0 is exact, so the base variant is K4 with no
// biases) and:
//   * pre_quant: the LayerNorm + per-token quantize prologue is skipped and
//     pre-quantized rows are read instead, xq_in [B, np_pad, D] int8 and
//     xs_in [B, np_pad, 1] f32 with np_pad = round_up(N, 8) (:79-81); only
//     the first N rows of each image reach the output;
//   * batched_dots: the per-head scores and PV as batched products (:111-129);
//     on this card the attention is one kernel either way, and what the knob
//     changes in the function is that each head's output stays f32 (no
//     rounding to bf16, unlike _heads_attention), so the requantize reads
//     f32 o. Scores, softmax and P are as in K4: bf16 operands, f32 sums,
//     P in bf16.
//
// What bounds it on the H100: K4's products (at 308 px, batch 32 of
// DINOv2-G, 292.9 G int8 ops and 46.2 GFLOP of bf16 attention): tensor-core
// issue. The design is K4's stages (attn_half_int8.cuh): with pre_quant
// the qkv GEMM maps its A rows onto the padded input in place (row r reads
// image r / N, row r % N), so the stub removes stage (a) and adds nothing
// (the GEMM maps each load slot's row once, before its K loop: mapped at
// every K step, the divisions made the stub ~0.1 ms slower than the base
// at B 32, N 485 on an H100 at 700 W); with batched_dots the attention
// stage writes f32 o (the bf16 o of K4 becomes 4 bytes a value) and the
// requantize reads it.
#include "attn_half_int8.cuh"

// x [B, N, D] (dtype), ln_w / ln_b [D] f32, wqkv [3D, D] int8, sqkv [3D]
// f32, wp [D, D] int8 ([out, in]), sp [D] f32, gamma [D] f32 or null;
// pre_quant: xq_in [B, np_pad, D] int8 and xs_in [B, np_pad] f32, else both
// null. Scratch: xq [M, D] int8 and xs [M] f32 (null with pre_quant), qkv
// [M, 3D] bf16, o [M, D] (f32 with batched_dots, else bf16), oq [M, D] int8,
// os [M, H / hc] f32. out [B, N, D] in x's dtype.
extern "C" int anyloc_attn_half_variant(
    const void* x, const void* ln_w, const void* ln_b, const void* wqkv,
    const void* sqkv, const void* wp, const void* sp, const void* gamma,
    const void* xq_in, const void* xs_in, void* xq, void* xs, void* qkv, void* o,
    void* oq, void* os, void* out, int dtype, int B, int N, int np_pad, int H, int hd,
    int hc, int batched_dots, float eps, float scale, void* stream) {
  return anyloc::attn_half_int8_stages(
      x, ln_w, ln_b, wqkv, sqkv, /*bqkv=*/nullptr, wp, sp, /*bp=*/nullptr, gamma, xq_in,
      xs_in, xq, xs, qkv, o, oq, os, out, dtype, dtype, batched_dots, B, N, np_pad, H, hd,
      hc, eps, scale, static_cast<cudaStream_t>(stream));
}
