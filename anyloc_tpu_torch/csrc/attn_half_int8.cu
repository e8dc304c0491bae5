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
#include "flash_attention.cuh"
#include "int8_common.cuh"

// x [B, N, D] (dtype), ln_w / ln_b [D] f32, wqkv [3D, D] int8, sqkv [3D]
// f32, bqkv [3D] f32 or null, wp [D, D] int8 ([out, in]), sp [D], bp [D] or
// null, gamma [D] or null. Scratch: xq [M, D] int8, xs [M] f32, qkv [M, 3D]
// bf16, o [M, D] bf16, oq [M, D] int8, os [M, H / hc] f32. out [B, N, D] in
// out_dtype: x's dtype for K4, f32 for K9's x2 (fused_block_int8.cu).
extern "C" int anyloc_attn_half_int8(
    const void* x, const void* ln_w, const void* ln_b, const void* wqkv,
    const void* sqkv, const void* bqkv, const void* wp, const void* sp,
    const void* bp, const void* gamma, void* xq, void* xs, void* qkv, void* o,
    void* oq, void* os, void* out, int dtype, int out_dtype, int B, int N, int H,
    int hd, int hc, float eps, float scale, void* stream) {
  using namespace anyloc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int D = H * hd;
  const int M = B * N;
  if (M == 0) return cudaSuccess;
  if ((dtype != DT_BF16 && dtype != DT_F32) || (out_dtype != DT_BF16 && out_dtype != DT_F32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = launch_ln_quant(x, dtype, static_cast<const float*>(ln_w),
                                  static_cast<const float*>(ln_b),
                                  static_cast<int8_t*>(xq), static_cast<float*>(xs),
                                  M, D, eps, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  I8GemmArgs pq = {};
  pq.A = static_cast<const int8_t*>(xq);
  pq.B = static_cast<const int8_t*>(wqkv);
  pq.row_scale = static_cast<const float*>(xs);
  pq.col_scale = static_cast<const float*>(sqkv);
  pq.bias = static_cast<const float*>(bqkv);
  pq.out = qkv;
  pq.M = M;
  pq.N = 3 * D;
  pq.K = D;
  pq.group = D;
  pq.q_cols = D;
  pq.q_scale = scale;
  e = launch_gemm_i8<EPI_QKV, bf16>(pq, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  AttnArgs a;
  const bf16* base = static_cast<const bf16*>(qkv);
  a.q = base;
  a.k = base + D;
  a.v = base + 2 * D;
  a.o = o;
  a.B = B;
  a.H = H;
  a.N = N;
  const long long rs = 3LL * D;
  a.q_sb = a.k_sb = a.v_sb = (long long)N * rs;
  a.q_sh = a.k_sh = a.v_sh = hd;
  a.q_sn = a.k_sn = a.v_sn = rs;
  a.o_sb = (long long)N * D;
  a.o_sh = hd;
  a.o_sn = D;
  a.scale = 1.f;      // q carries the softmax scale already
  a.prescale_q = 1;   // no scaling of the scores; q * 1 is exact
  e = launch_attention(a, DT_BF16, hd, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  const int group = hc * hd;
  e = launch_requant(static_cast<const bf16*>(o), static_cast<int8_t*>(oq),
                     static_cast<float*>(os), M, D, group, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  I8GemmArgs pp = {};
  pp.A = static_cast<const int8_t*>(oq);
  pp.B = static_cast<const int8_t*>(wp);
  pp.row_scale = static_cast<const float*>(os);
  pp.col_scale = static_cast<const float*>(sp);
  pp.bias = static_cast<const float*>(bp);
  pp.gamma = static_cast<const float*>(gamma);
  pp.res = x;
  pp.out = out;
  pp.M = M;
  pp.N = D;
  pp.K = D;
  pp.group = group;
  return static_cast<int>(launch_gemm_i8_resid(pp, out_dtype, dtype, st));
}
