// The float GEMMs of the bf16 block kernels K6 (attention_proj.cu), K7
// (attn_half_bf16.cu) and K8 (fused_mlp_bf16.cu), of K5's projection
// (attn_qkv_proj.cu) and of the float product T1 (matmul.cu), and their
// LayerNorm. They stand for the products inside the TPU kernels
// attn_proj.py::flash_attention_qkv_proj, ::fused_attn_half_bf16 and
// ::attention_proj, fused_mlp.py::fused_mlp_bf16 and, on float operands,
// tools/bench_int8_matmul.py::pallas_matmul:
//   * bf16 operands: the TMA GEMM of int8_common.cuh (gemm_tma_kernel) with
//     OpBF16 — wgmma m64n256k16 .f32.bf16.bf16 with both operands K-major
//     in shared memory, fed by TMA (128-byte swizzle, boxes of 64 K
//     elements) into four 48 KB stages guarded by full / empty mbarriers;
//     the first thread of a producer warpgroup issues the loads, two
//     consumer warpgroups of 64 rows each hold a 64 x 256 f32 tile (128
//     registers of sums), setmaxnreg moves registers 40 / 232, and one
//     stage's products stay in flight while the next stage lands. The
//     int8 GEMM runs the same pipeline; EPI_SWIGLU loads B as two boxes,
//     128 W1 rows and the same 128 rows of W2, so g1 and g2 of one hidden
//     column sit in one thread (accumulator entries e and e + 64);
//   * f32 operands: the same pipeline with OpTF32x3 — each f32 product as
//     three tf32 wgmma products (m64n128k8 .f32.tf32.tf32, both operands
//     K-major, 32 f32 of K a stage row), lo·hi + hi·lo + hi·hi of the split
//     x = hi + lo (hopper.cuh's tf32_split: hi rounded to tf32, lo exact).
//     One tf32 product alone errs by ~3e-3 at K5's f32 projections,
//     far beyond its 2e-5 f32 bound; the three keep the error at f32
//     FMA's level (tests/test_torch_tf32_split.py), at a third of the
//     495 TFLOP/s dense tf32 rate, ~2.5x the 67 TFLOP/s of f32 FMA. The
//     producer warpgroup's warps 1-3 write the split (GemmTile<ONE,
//     true>: 128 x 128 block tiles, three 64 KB stages of hi and lo);
//     the epilogues are the bf16 ones. It ignores
//     torch.backends.cuda.matmul.allow_tf32: the split is f32-accurate by
//     construction;
//   * ln_rows_kernel: LayerNorm in f32 (int8_common.cuh's ln_row), written
//     in the activations' dtype.
// Both operands are K-contiguous: A the activations, B the nn.Linear weight
// layout [out, in]. The epilogue works in f32 with __fmul_rn / __fadd_rn, so
// no FMA contraction moves a rounding, and rounds once to the output dtype:
// the operands' dtype, or OutT where a caller names it (T1 writes f32 sums
// of bf16 operands, or bf16 from f32 operands; a residual is then read in
// OutT). Ragged M and N are masked in the epilogue, ragged K is TMA's zero
// fill; the wrappers' K % 8 == 0 and 16-byte alignment give TMA's rule of
// row strides in whole 16 bytes.
//
// What bounds these GEMMs on the H100: at the bench shapes (M 8224-15520,
// D 1536, HID 4096) each is 39-206 GFLOP against tens of MB, far above the
// card's ~295 FLOP/byte balance point: tensor-core issue, at most 989
// TFLOP/s of bf16 wgmma. On one H100 80GB HBM3 at 700 W (chip_smoke.py;
// PERF.md) T1 bf16 runs at ~487 TFLOP/s at w12 [8704x1536]x[1536x8192]
// and K8's two products at ~460.
#pragma once

#include <type_traits>

#include "int8_common.cuh"

namespace anyloc {
namespace {

struct GemmArgs {
  const void* A;       // [M, K]
  const void* B;       // [rows, K]
  const float* bias;   // [rows] or null
  const float* gamma;  // [N] or null (EPI_RESID)
  const void* res;     // [M, N] or null (EPI_RESID)
  void* out;           // [M, N]
  int M, N, K;
  int hid;             // EPI_SWIGLU: first B row of W2
  int q_cols;          // EPI_QKV
  float q_scale;       // EPI_QKV
  float* pre;          // EPI_RESID_PRE: [M, N] f32, the value before LayerScale
};

// Output columns col, col + 1 of row `row` from their f32 sums (v0, v1) and,
// for EPI_SWIGLU, the W2 sums of the same hidden columns (u0, u1).
template <int EPI, typename T>
__device__ __forceinline__ void epi_store(const GemmArgs& p, int row, int col, float v0,
                                          float v1, float u0, float u1) {
  if (p.bias) {
    v0 = __fadd_rn(v0, p.bias[col]);
    v1 = __fadd_rn(v1, p.bias[col + 1]);
  }
  const long long off = (long long)row * p.N + col;
  if (EPI == EPI_QKV) {
    if (col < p.q_cols) {
      v0 = __fmul_rn(v0, p.q_scale);
      v1 = __fmul_rn(v1, p.q_scale);
    }
  } else if (EPI == EPI_SWIGLU) {
    if (p.bias) {
      u0 = __fadd_rn(u0, p.bias[p.hid + col]);
      u1 = __fadd_rn(u1, p.bias[p.hid + col + 1]);
    }
    v0 = __fmul_rn(v0 / (1.f + expf(-v0)), u0);
    v1 = __fmul_rn(v1 / (1.f + expf(-v1)), u1);
  } else if (EPI == EPI_GELU) {
    v0 = gelu_poly(v0);
    v1 = gelu_poly(v1);
  } else {  // EPI_RESID, EPI_RESID_PRE
    if constexpr (EPI == EPI_RESID_PRE)
      store_pair(p.pre + off, v0, v1);  // K5 under autograd: d LayerScale reads it
    if (p.gamma) {
      v0 = __fmul_rn(v0, p.gamma[col]);
      v1 = __fmul_rn(v1, p.gamma[col + 1]);
    }
    if (p.res) {
      const T* r = static_cast<const T*>(p.res) + off;
      v0 = __fadd_rn(v0, to_float(r[0]));
      v1 = __fadd_rn(v1, to_float(r[1]));
    }
  }
  store_pair(static_cast<T*>(p.out) + off, from_float<T>(v0), from_float<T>(v1));
}

// The bf16 operands of the TMA GEMM (int8_common.cuh's OpS8 for the other
// members): f32 sums, no scales, the epi_store epilogue.
struct OpBF16 {
  using Elem = bf16;
  using Acc = float;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr bool SPLIT = false;

  __device__ static __forceinline__ void mma(float (&d)[128], float (&)[128], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d, uint32_t) {
    wgmma_bf16_ss(d, desc_a, desc_b, scale_d);
  }

  // Each thread holds columns c0 + 8j + 2t, + 1 of rows row0 and row0 + 8;
  // EPI_SWIGLU: W2's sums of the same hidden columns NACC / 2 entries on.
  template <int EPI, typename OutT, typename ResT, bool ONE, int NACC>
  __device__ static __forceinline__ void epilogue(const GemmArgs& p, const float (&acc)[NACC],
                                                  const float (&)[NACC], int row0, long long,
                                                  long long, int c0, int t) {
    const bool in0 = row0 < p.M, in1 = row0 + 8 < p.M;
#pragma unroll
    for (int j = 0; j < (EPI == EPI_SWIGLU ? NACC / 8 : NACC / 4); ++j) {
      const int col = c0 + j * 8 + 2 * t;  // N is even: the pair is valid together
      if (col >= p.N) continue;
      float u[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (EPI == EPI_SWIGLU) {
#pragma unroll
        for (int e = 0; e < 4; ++e) u[e] = acc[4 * j + e + NACC / 2];
      }
      if (in0) epi_store<EPI, OutT>(p, row0, col, acc[4 * j], acc[4 * j + 1], u[0], u[1]);
      if (in1) epi_store<EPI, OutT>(p, row0 + 8, col, acc[4 * j + 2], acc[4 * j + 3], u[2], u[3]);
    }
  }
};

// The f32 operands: split stages (hi in place, lo `lo` descriptor steps
// on), three tf32 products a K step, lo·hi + hi·lo into e (scale_d 0: e =
// the first product), then hi·hi into d (scale_hi). wgmma's f32 sums are
// not rounded to nearest: each add errs toward zero by a share of the
// accumulator's size (F27, F29), so no accumulator takes a long sum:
// gemm_tma_kernel passes one accumulator as d and e, the small products
// first, starts it afresh every GemmTile::FOLD tiles (8 K steps) and joins
// it to the f32 sums by __fadd_rn; attn_qkv_proj_bwd.cu keeps the small
// products apart and hi·hi afresh every few stages. OpBF16's epilogue on
// the joined sums.
struct OpTF32x3 : OpBF16 {
  using Elem = float;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static constexpr bool SPLIT = true;

  __device__ static __forceinline__ void mma(float (&d)[64], float (&e)[64], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d, uint32_t lo,
                                             int scale_hi) {
    wgmma_tf32_ss(e, desc_a + lo, desc_b, scale_d);
    wgmma_tf32_ss(e, desc_a, desc_b + lo, 1);
    wgmma_tf32_ss(d, desc_a, desc_b, scale_hi);
  }
};

// Launch the GEMM for the operand dtype code (DT_BF16 or DT_F32); the output
// and the residual have the operands' dtype, or OutT when it is given.
template <int EPI, typename OutT = void>
cudaError_t launch_gemm(const GemmArgs& p, int dtype, cudaStream_t st) {
  if (p.M == 0 || p.N == 0) return cudaSuccess;
  if (dtype == DT_BF16) {
    using O = std::conditional_t<std::is_void_v<OutT>, bf16, OutT>;
    return launch_gemm_tiles<OpBF16, EPI, O, O, false, true>(p, st);
  }
  if (dtype == DT_F32) {
    using O = std::conditional_t<std::is_void_v<OutT>, float, OutT>;
    return launch_gemm_tiles<OpTF32x3, EPI, O, O, false, true>(p, st);
  }
  return cudaErrorInvalidValue;
}

// One block per row of x [M, D]: LayerNorm in f32, out [M, D] in T.
template <typename T>
__global__ void __launch_bounds__(LNQ_THREADS)
    ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ ln_w,
                   const float* __restrict__ ln_b, T* __restrict__ out, int D, float eps) {
  extern __shared__ float row_buf[];
  __shared__ float red[LNQ_THREADS / 32];
  const long long row = blockIdx.x;
  ln_row(x, ln_w, ln_b, row_buf, red, row, D, eps);
  for (int i = threadIdx.x; i < D; i += LNQ_THREADS) out[row * D + i] = from_float<T>(row_buf[i]);
}

inline cudaError_t launch_ln_rows(const void* x, int dtype, const float* ln_w, const float* ln_b,
                                  void* out, long long M, int D, float eps, cudaStream_t st) {
  if (M == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * D;
  if (dtype == DT_BF16)
    ln_rows_kernel<bf16><<<(unsigned)M, LNQ_THREADS, smem, st>>>(
        static_cast<const bf16*>(x), ln_w, ln_b, static_cast<bf16*>(out), D, eps);
  else if (dtype == DT_F32)
    ln_rows_kernel<float><<<(unsigned)M, LNQ_THREADS, smem, st>>>(
        static_cast<const float*>(x), ln_w, ln_b, static_cast<float*>(out), D, eps);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace
}  // namespace anyloc
