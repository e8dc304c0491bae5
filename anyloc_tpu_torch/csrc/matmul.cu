// T1 and T2 — the tiled products of the int8 micro-benchmark.
//
// Replaces tools/bench_int8_matmul.py::pallas_matmul (:48; body _mm_kernel
// :30) and ::pallas_matmul_dequant (:91; body _mm_dequant_kernel :71):
//   * T1 on int8 operands: a [M, K] @ b [K, N] with int32 sums, returned as
//     int32 (:40, :45), or converted once to f32 or bf16 (out_dtype);
//   * T1 on bf16 or f32 operands: f32 sums, written as f32 (the default) or
//     bf16;
//   * T2: o = (float(a @ b) * sa[:, None]) * sb[None, :] on int8 operands,
//     rounded once to out_dtype, bf16 by default (:86-88).
// The TPU's (bm, bn, bk) tiles have no counterpart: int32 sums are exact in
// any order, and f32 sums of exact bf16 products only change order.
//
// What bounds them on the H100: at the tool's shapes (M 8704 rows; K -> N
// 1536 -> 8192, 1536 -> 4608, 4096 -> 1536, 1536 -> 1536) each product is
// 41-219 G operations against at most ~0.3 GB of operands and output (the
// int32 or f32 output dominates), far above the card's balance points:
// tensor-core issue. The design is the repository's TMA GEMM
// (int8_common.cuh: wgmma fed by TMA through an mbarrier ring), B read
// K-contiguous ([N, K] rows, the .t() of nn.Linear-style storage):
//   * int8: wgmma m64n256k32 .s32.s8.s8; T1 with EPI_I32 (the int32 sums
//     over the whole of K, never folded into f32, which is not exact above
//     2^24), T2 with one K group of width K and EPI_RESID with no bias,
//     LayerScale or residual, so the dequantize is the fold
//     (__fmul_rn(__fmul_rn(float(acc), sa), sb)), then one rounding;
//   * bf16: wgmma m64n256k16 .f32.bf16.bf16 (bf16_gemm.cuh), f32 sums with
//     an output type of their own and the plain EPI_RESID epilogue;
//   * f32: the same pipeline with bf16_gemm.cuh's OpTF32x3 (three tf32
//     wgmmas a product, f32-accurate), the same way.
#include "bf16_gemm.cuh"

// a [M, K] and b [N, K], both of dtype (DT_I8, DT_BF16 or DT_F32), row-major
// and 16-byte aligned; out [M, N] of out_dtype: DT_I32, DT_F32 or DT_BF16
// for int8 operands, DT_F32 or DT_BF16 for float ones.
extern "C" int anyloc_matmul(const void* a, const void* b, void* out, int dtype, int out_dtype,
                             int M, int N, int K, void* stream) {
  using namespace anyloc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_I8) {
    I8GemmArgs p = {};
    p.A = static_cast<const int8_t*>(a);
    p.B = static_cast<const int8_t*>(b);
    p.out = out;
    p.M = M;
    p.N = N;
    p.K = K;
    p.group = K;
    switch (out_dtype) {
      case DT_I32: return static_cast<int>(launch_gemm_i8<EPI_I32, int>(p, st));
      case DT_F32: return static_cast<int>(launch_gemm_i8<EPI_I32, float>(p, st));
      case DT_BF16: return static_cast<int>(launch_gemm_i8<EPI_I32, bf16>(p, st));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype != DT_BF16 && dtype != DT_F32) return static_cast<int>(cudaErrorInvalidValue);
  GemmArgs p = {};
  p.A = a;
  p.B = b;
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  switch (out_dtype) {
    case DT_F32: return static_cast<int>(launch_gemm<EPI_RESID, float>(p, dtype, st));
    case DT_BF16: return static_cast<int>(launch_gemm<EPI_RESID, bf16>(p, dtype, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// a [M, K] and b [N, K] int8, sa [M] and sb [N] f32; out [M, N] of
// out_dtype (DT_BF16 or DT_F32).
extern "C" int anyloc_matmul_dequant(const void* a, const void* b, const void* sa,
                                     const void* sb, void* out, int out_dtype, int M, int N,
                                     int K, void* stream) {
  using namespace anyloc;
  if (out_dtype != DT_BF16 && out_dtype != DT_F32) return static_cast<int>(cudaErrorInvalidValue);
  I8GemmArgs p = {};
  p.A = static_cast<const int8_t*>(a);
  p.B = static_cast<const int8_t*>(b);
  p.row_scale = static_cast<const float*>(sa);
  p.col_scale = static_cast<const float*>(sb);
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  p.group = K;
  return static_cast<int>(
      launch_gemm_i8_resid(p, out_dtype, out_dtype, static_cast<cudaStream_t>(stream)));
}
