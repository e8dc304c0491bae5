// The float GEMMs of the bf16 block kernels K6 (attention_proj.cu), K7
// (attn_half_bf16.cu) and K8 (fused_mlp_bf16.cu), of K5's projection
// (attn_qkv_proj.cu) and of the float product T1 (matmul.cu), and their
// LayerNorm:
//   * gemm_bf16_kernel: out[M, N] = epilogue(A[M, K] @ B[rows, K]^T), bf16
//     operands on mma.sync m16n8k16 with f32 sums — the bf16 twin of
//     int8_common.cuh's int8 GEMM: 128x128 block tiles, 8 warps of 64x32, K
//     steps of 32 elements through a three-stage cp.async ring (80-byte row
//     pitch: the 32-bit fragment loads hit 32 distinct banks), the same
//     EPI_* epilogues and the same W1 | W2 pairing for SwiGLU; no row or
//     column scales, no K groups;
//   * gemm_f32_kernel: the same function and epilogues for f32 operands, FMA
//     on 64x64 tiles (K5's gemm_scalar_epilogue_kernel, attn_qkv_proj.cu);
//   * ln_rows_kernel: LayerNorm in f32 (int8_common.cuh's ln_row), written
//     in the activations' dtype.
// Both operands are K-contiguous: A the activations, B the nn.Linear weight
// layout [out, in]. The epilogue works in f32 with __fmul_rn / __fadd_rn, so
// no FMA contraction moves a rounding, and rounds once to the output dtype:
// the operands' dtype, or OutT where a caller names it (T1 writes f32 sums
// of bf16 operands, or bf16 from f32 operands; a residual is then read in
// OutT).
//
// What bounds these GEMMs on the H100: at the bench shapes (M 8224-15520,
// D 1536, HID 4096) each is 39-206 GFLOP against tens of MB, far above the
// card's ~295 FLOP/byte balance point: tensor-core issue. This mma.sync
// design reaches a fraction of the 989 TFLOP/s that wgmma with TMA-fed
// tiles can; this file is the one place a later version redesigns.
#pragma once

#include <type_traits>

#include "int8_common.cuh"

namespace anyloc {
namespace {

constexpr int BBM = 128, BBN = 128, BBK = 32;
constexpr int BSTAGES = 3;
constexpr int BTHREADS = 256;
constexpr int BPITCH = BBK + 8;  // smem row pitch in bf16 (80 bytes)
constexpr int B_STAGE_ELEMS = (BBM + BBN) * BPITCH;
constexpr int B_SMEM_BYTES = BSTAGES * B_STAGE_ELEMS * 2;  // 61,440: dynamic

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
};

// The B row that tile row r (0..127) of column block bn reads, or -1, in a
// GEMM of N output columns (EPI_SWIGLU: N = HID, W2 from B row hid on).
// EPI_SWIGLU: each warp's 32 rows are 16 hidden columns of W1 then the
// same 16 of W2, so one thread holds g1 (n-tiles 0, 1) and g2 (2, 3) of
// the same hidden column; a block covers 64 hidden columns.
template <int EPI>
__device__ __forceinline__ int b_row(int N, int hid, int bn, int r) {
  if (EPI == EPI_SWIGLU) {
    const int j = r & 31;
    const int hcol = bn * 64 + (r >> 5) * 16 + (j & 15);
    if (hcol >= N) return -1;
    return j < 16 ? hcol : hid + hcol;
  }
  const int c = bn * 128 + r;
  return c < N ? c : -1;
}

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
  } else {  // EPI_RESID
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
  T* o = static_cast<T*>(p.out) + off;
  o[0] = from_float<T>(v0);
  o[1] = from_float<T>(v1);
}

template <int EPI, typename OutT>
__global__ void __launch_bounds__(BTHREADS)
    gemm_bf16_kernel(GemmArgs p) {
  extern __shared__ __align__(16) bf16 b_smem[];
  const bf16* A = static_cast<const bf16*>(p.A);
  const bf16* B = static_cast<const bf16*>(p.B);
  const int bn = blockIdx.x, m0 = blockIdx.y * BBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int g = lane >> 2, t = lane & 3;

  // this thread's two load slots per operand and stage (8 bf16 each)
  int a_row[2], b_src[2], ld_r[2], ld_k[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * BTHREADS;
    ld_r[i] = c >> 2;
    ld_k[i] = (c & 3) * 8;
    a_row[i] = m0 + ld_r[i];
    b_src[i] = b_row<EPI>(p.N, p.hid, bn, ld_r[i]);
  }
  auto load_stage = [&](int stage, int k0) {
    bf16* As = b_smem + stage * B_STAGE_ELEMS;
    bf16* Bs = As + BBM * BPITCH;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = k0 + ld_k[i];  // K % 8 == 0 (the wrappers check): whole vectors
      const bool ka = a_row[i] < p.M && k < p.K;
      const bool kb = b_src[i] >= 0 && k < p.K;
      cp_async16(As + ld_r[i] * BPITCH + ld_k[i], ka ? A + (long long)a_row[i] * p.K + k : A, ka);
      cp_async16(Bs + ld_r[i] * BPITCH + ld_k[i], kb ? B + (long long)b_src[i] * p.K + k : B, kb);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = cdiv(p.K, BBK);
#pragma unroll
  for (int s = 0; s < BSTAGES - 1; ++s) {
    if (s < nk) load_stage(s, s * BBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<BSTAGES - 2>();
    __syncthreads();  // tile kt landed; tile kt-1's stage is free again
    if (kt + BSTAGES - 1 < nk) load_stage((kt + BSTAGES - 1) % BSTAGES, (kt + BSTAGES - 1) * BBK);
    cp_async_commit();
    const bf16* As = b_smem + (kt % BSTAGES) * B_STAGE_ELEMS;
    const bf16* Bs = As + BBM * BPITCH;
#pragma unroll
    for (int ks = 0; ks < BBK / 16; ++ks) {  // past K the tiles are zero-filled
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const bf16* ar = As + (wm + mt * 16 + g) * BPITCH + ks * 16 + t * 2;
        a[mt][0] = lds32(ar);
        a[mt][1] = lds32(ar + 8 * BPITCH);
        a[mt][2] = lds32(ar + 8);
        a[mt][3] = lds32(ar + 8 * BPITCH + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bf16* br = Bs + (wn + nt * 8 + g) * BPITCH + ks * 16 + t * 2;
        const uint32_t b0 = lds32(br), b1 = lds32(br + 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          mma_bf16_16816(acc[mt][nt], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + mt * 16 + g + half * 8;
      if (row >= p.M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (EPI == EPI_SWIGLU && nt >= 2) continue;
        const int col = b_row<EPI>(p.N, p.hid, bn, wn + nt * 8 + 2 * t);
        if (col < 0) continue;  // N is even: the pair is valid together
        const float u0 = EPI == EPI_SWIGLU ? acc[mt][(nt + 2) & 3][2 * half] : 0.f;
        const float u1 = EPI == EPI_SWIGLU ? acc[mt][(nt + 2) & 3][2 * half + 1] : 0.f;
        epi_store<EPI, OutT>(p, row, col, acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1],
                             u0, u1);
      }
    }
  }
}

// The B row that tile row r (0..63) of column block bn reads in the FMA
// GEMM, or -1. EPI_SWIGLU: rows 0..31 are 32 hidden columns of W1, rows
// 32..63 the same 32 of W2, so a thread's column pairs (2tx, 2tx + 1) and
// (32 + 2tx, 33 + 2tx) hold g1 and g2 of the same hidden columns.
template <int EPI>
__device__ __forceinline__ int fma_b_row(int N, int hid, int bn, int r) {
  if (EPI == EPI_SWIGLU) {
    const int hcol = bn * 32 + (r & 31);
    if (hcol >= N) return -1;
    return r < 32 ? hcol : hid + hcol;
  }
  const int c = bn * 64 + r;
  return c < N ? c : -1;
}

// f32 operands: 64x64 tile, 16x16 threads of 4 rows x 2 column pairs, FMA.
template <int EPI, typename OutT>
__global__ void __launch_bounds__(256)
    gemm_f32_kernel(GemmArgs p) {
  __shared__ float As[16][65];
  __shared__ float Bs[16][65];
  const float* A = static_cast<const float*>(p.A);
  const float* B = static_cast<const float*>(p.B);
  const int bn = blockIdx.x, m0 = blockIdx.y * 64;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int tc[4] = {2 * tx, 2 * tx + 1, 32 + 2 * tx, 33 + 2 * tx};  // tile columns
  float acc[4][4] = {};
  for (int k0 = 0; k0 < p.K; k0 += 16) {
    __syncthreads();
    for (int i = threadIdx.x; i < 64 * 16; i += 256) {
      const int r = i / 16, kk = i % 16;
      const bool kin = k0 + kk < p.K;
      const int br = fma_b_row<EPI>(p.N, p.hid, bn, r);
      As[kk][r] = (kin && m0 + r < p.M) ? A[(long long)(m0 + r) * p.K + k0 + kk] : 0.f;
      Bs[kk][r] = (kin && br >= 0) ? B[(long long)br * p.K + k0 + kk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[kk][ty + 16 * i];
        w[i] = Bs[kk][tc[i]];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= p.M) continue;
    // SwiGLU: one pair of hidden columns, g1 in acc[i][0..1], g2 in [2..3]
#pragma unroll
    for (int q = 0; q < (EPI == EPI_SWIGLU ? 1 : 2); ++q) {
      const int col = fma_b_row<EPI>(p.N, p.hid, bn, tc[2 * q]);
      if (col < 0) continue;
      if (EPI == EPI_SWIGLU)
        epi_store<EPI, OutT>(p, row, col, acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      else
        epi_store<EPI, OutT>(p, row, col, acc[i][2 * q], acc[i][2 * q + 1], 0.f, 0.f);
    }
  }
}

// Launch the GEMM for the operand dtype code (DT_BF16 or DT_F32); the output
// and the residual have the operands' dtype, or OutT when it is given.
template <int EPI, typename OutT = void>
cudaError_t launch_gemm(const GemmArgs& p, int dtype, cudaStream_t st) {
  if (p.M == 0 || p.N == 0) return cudaSuccess;
  if (dtype == DT_BF16) {
    using O = std::conditional_t<std::is_void_v<OutT>, bf16, OutT>;
    cudaError_t e = cudaFuncSetAttribute(gemm_bf16_kernel<EPI, O>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         B_SMEM_BYTES);
    if (e != cudaSuccess) return e;
    const dim3 grid(cdiv(p.N, EPI == EPI_SWIGLU ? 64 : BBN), cdiv(p.M, BBM));
    gemm_bf16_kernel<EPI, O><<<grid, BTHREADS, B_SMEM_BYTES, st>>>(p);
  } else if (dtype == DT_F32) {
    using O = std::conditional_t<std::is_void_v<OutT>, float, OutT>;
    const dim3 grid(cdiv(p.N, EPI == EPI_SWIGLU ? 32 : 64), cdiv(p.M, 64));
    gemm_f32_kernel<EPI, O><<<grid, 256, 0, st>>>(p);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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
