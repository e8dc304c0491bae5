// K3 — the int8 W8A8 MLP half of a ViT block.
//
// Replaces anyloc_tpu/ops/pallas/fused_mlp.py::fused_mlp_int8 (:250; the
// pallas_calls at :366 SwiGLU and :391 GELU): optional LayerNorm ->
// per-row int8 quantize -> int8 x @ W1|W2 (or fc1), dequantized -> SwiGLU
// (or exact GELU through the Abramowitz-Stegun erf polynomial) ->
// requantize per (row, hidden chunk) -> int8 @ W3, accumulated per chunk ->
// + b3, * LayerScale, + residual. The hidden chunk is the quantization
// group of the second product, so it changes the numbers and is kept.
//
// What bounds it on the H100: at the 308-px batch-32 shape of DINOv2-G
// (M = 15520 rows, D 1536, HID 4096) the two products are 390.6 + 195.3 G
// int8 ops, about 0.30 ms at the card's 1,979 TOPS, against ~0.1 GB of
// activations and weights (0.03 ms at 3.35 TB/s): tensor-core bound.
// The design is four launches of int8_common.cuh's kernels:
//   (a) LN + quantize the rows (xq int8, xs f32);
//   (b) the w12 GEMM; one block owns 64 hidden columns of W1 and the same
//       64 of W2, so g = silu(g1) * g2 is formed in registers and written
//       once, in f32 [M, HID];
//   (c) requantize g per (row, chunk);
//   (d) the w3 GEMM with the chunk as its K group: each chunk's int32
//       partial is scaled by that row's chunk scale and added in f32, then
//       + b3, * gamma, + x, cast to x's dtype.
// The TPU kernel keeps g in VMEM; here g makes one f32 round trip through
// device memory (M * HID * 4 bytes each way), and the int8 codes another:
// the first things a faster version removes.
#include "int8_common.cuh"

// x [M, D] (dtype), ln_w / ln_b [D] f32 or null (no LayerNorm),
// w12 [2*HID, D] int8 (swiglu: W1 rows then W2 rows) or [HID, D] (GELU fc1),
// s12 / b12 per w12 row f32 (b12 may be null), w3 [D, HID] int8, s3 [D],
// b3 [D] or null, gamma [D] or null, residual: add x.
// Scratch: xq [M, D] int8, xs [M] f32, g [M, HID] f32, gq [M, HID] int8,
// gs [M, HID / hc] f32. out [M, D] in out_dtype: x's dtype for K3; for
// K9 (fused_block_int8.cu) x is the f32 x2 and out the block's dtype.
extern "C" int anyloc_fused_mlp_int8(
    const void* x, const void* ln_w, const void* ln_b, const void* w12,
    const void* s12, const void* b12, const void* w3, const void* s3,
    const void* b3, const void* gamma, void* xq, void* xs, void* g, void* gq,
    void* gs, void* out, int dtype, int out_dtype, int M, int D, int HID, int hc,
    int swiglu, int residual, float eps, void* stream) {
  using namespace anyloc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 0) return cudaSuccess;
  if ((dtype != DT_BF16 && dtype != DT_F32) || (out_dtype != DT_BF16 && out_dtype != DT_F32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = launch_ln_quant(x, dtype, static_cast<const float*>(ln_w),
                                  static_cast<const float*>(ln_b),
                                  static_cast<int8_t*>(xq), static_cast<float*>(xs),
                                  M, D, eps, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  I8GemmArgs p1 = {};
  p1.A = static_cast<const int8_t*>(xq);
  p1.B = static_cast<const int8_t*>(w12);
  p1.row_scale = static_cast<const float*>(xs);
  p1.col_scale = static_cast<const float*>(s12);
  p1.bias = static_cast<const float*>(b12);
  p1.out = g;
  p1.M = M;
  p1.N = HID;
  p1.K = D;
  p1.group = D;
  p1.hid = HID;
  e = swiglu ? launch_gemm_i8<EPI_SWIGLU, float>(p1, st)
             : launch_gemm_i8<EPI_GELU, float>(p1, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  e = launch_requant(static_cast<const float*>(g), static_cast<int8_t*>(gq),
                     static_cast<float*>(gs), M, HID, hc, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  I8GemmArgs p3 = {};
  p3.A = static_cast<const int8_t*>(gq);
  p3.B = static_cast<const int8_t*>(w3);
  p3.row_scale = static_cast<const float*>(gs);
  p3.col_scale = static_cast<const float*>(s3);
  p3.bias = static_cast<const float*>(b3);
  p3.gamma = static_cast<const float*>(gamma);
  p3.res = residual ? x : nullptr;
  p3.out = out;
  p3.M = M;
  p3.N = D;
  p3.K = HID;
  p3.group = hc;
  return static_cast<int>(launch_gemm_i8_resid(p3, out_dtype, dtype, st));
}
