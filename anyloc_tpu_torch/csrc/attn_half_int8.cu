// K4 — the int8 W8A8 attention half of a ViT block.
//
// Replaces anyloc_tpu/ops/pallas/attn_proj.py::fused_attn_half_int8 (:501;
// body _attn_half_int8_kernel :415, _heads_attention :117): LN1 ->
// per-token int8 quantize -> int8 qkv product, dequantized + bias, q * scale
// -> per-head softmax attention with bf16 operands and f32 sums ->
// requantize per (row, head chunk) -> int8 out-projection accumulated per
// chunk -> + bias, * LayerScale, + x. The head chunk is the quantization
// group of the projection, so it changes the numbers and is kept.
//
// What bounds it on the H100: at 308 px, batch 32 of DINOv2-G (M = 15520
// rows, D 1536, 24 heads of 64, N 485) the qkv and projection products are
// 219.7 + 73.2 G int8 ops (0.148 ms at 1,979 TOPS) and the attention 46.2
// GFLOP of bf16 (0.047 ms at 989 TFLOP/s), against ~0.1 GB of activations
// and weights: tensor-core bound. The design is five launches:
//   (a) LN1 + quantize the rows (int8_common.cuh);
//   (b) the qkv GEMM with the epilogue ((acc * xs) * col_scale + bias),
//       q columns times the softmax scale, written as bf16 q | k | v
//       [B, N, 3D] — the Pallas kernel's rounding points (:470-472);
//   (c) flash attention (flash_attention.cuh) over strided column views of
//       that tensor, q taken as already scaled (scale 1, no second scaling);
//       P and each head's output rounded to bf16; ragged N is masked there,
//       so no padded rows exist;
//   (d) requantize o per (row, head chunk);
//   (e) the projection GEMM with the head chunk as its K group, then
//       + b_proj, * gamma, + x in f32, cast to x's dtype.
// The TPU kernel keeps qkv and o in VMEM; here they go through device
// memory (bf16 qkv, bf16 o, int8 o codes): the first things a faster
// version removes by fusing (b)-(e) per head chunk.
#include "attn_half_int8.cuh"

// x [B, N, D] (dtype), ln_w / ln_b [D] f32, wqkv [3D, D] int8, sqkv [3D]
// f32, bqkv [3D] f32 or null, wp [D, D] int8 ([out, in]), sp [D], bp [D] or
// null, gamma [D] or null. Scratch: xq [M, D] int8, xs [M] f32, qkv [M, 3D]
// bf16, o [M, D] bf16, oq [M, D] int8, os [M, H / hc] f32. out [B, N, D] in
// out_dtype: x's dtype for K4, f32 for K9's x2 (fused_block_int8.cu). The
// stages are in attn_half_int8.cuh.
extern "C" int anyloc_attn_half_int8(
    const void* x, const void* ln_w, const void* ln_b, const void* wqkv,
    const void* sqkv, const void* bqkv, const void* wp, const void* sp,
    const void* bp, const void* gamma, void* xq, void* xs, void* qkv, void* o,
    void* oq, void* os, void* out, int dtype, int out_dtype, int B, int N, int H,
    int hd, int hc, float eps, float scale, void* stream) {
  return anyloc::attn_half_int8_stages(
      x, ln_w, ln_b, wqkv, sqkv, bqkv, wp, sp, bp, gamma, nullptr, nullptr, xq, xs, qkv, o,
      oq, os, out, dtype, out_dtype, /*o_f32=*/0, B, N, /*np_pad=*/N, H, hd, hc, eps, scale,
      static_cast<cudaStream_t>(stream));
}
