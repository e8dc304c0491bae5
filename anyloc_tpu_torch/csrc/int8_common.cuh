// Device code shared by the int8 W8A8 kernels K3 (fused_mlp_int8.cu), K4
// (attn_half_int8.cu), K9 (fused_block_int8.cu, through K4's and K3's
// entry points), T3 (attn_half_variant.cu, on K4's stages) and the int8
// products T1 and T2 (matmul.cu); the LayerNorm, the erf polynomial, the
// cp.async helpers and the EPI_* epilogue codes also serve the bf16 GEMM
// (bf16_gemm.cuh):
//   * ln_quant_rows_kernel: optional LayerNorm (f32, two-pass mean and
//     variance, 1 / sqrtf — not the approximate rsqrtf) and a per-row int8
//     quantize, scale = max(amax, 1e-6) / 127, codes rintf(x / scale)
//     (half to even, as jnp.round) clamped to +-127;
//   * requant_groups_kernel: the same quantize per (row, column group);
//   * gemm_i8_kernel: int8 x int8 -> int32 on mma.sync m16n8k32, both
//     operands K-contiguous (A [M, K] activations, B [rows, K] = the
//     nn.Linear weight layout). At each group's edge of the K loop the int32
//     partial turns into f32 (__int2float_rn) and is added as
//     (partial * row_scale[row, group]) * col_scale[col] — the JAX order —
//     to an f32 accumulator; the epilogue (EPI_*) finishes the tile.
//     EPI_I32 skips the fold: it keeps the exact int32 sums over the whole
//     of K (f32 holds integers exactly only up to 2^24, and a sum over K
//     4096 of int8 products reaches 4096 * 127^2 ~ 6.6e7).
//
// What bounds the GEMMs on the H100: at the 308-px batch-32 shape
// (M = 15520 rows, D = 1536) each one is 73-391 G int8 ops against tens of
// MB of operands, far above the card's 590 ops/byte balance point, so they
// are bound by tensor-core issue. This design is the simple one: 128x128
// block tiles, 8 warps of 64x32, K steps of 64 bytes through a three-stage
// cp.async ring in shared memory (80-byte row pitch: the 32-bit fragment
// loads hit 32 distinct banks). wgmma with TMA-fed tiles is later work.
#pragma once

#include "common.cuh"

namespace anyloc {
namespace {

constexpr int LNQ_THREADS = 256;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffff, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, o));
  return x;
}

// Sum or max over the block; every thread gets the result.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  x = MAX ? warp_max(x) : warp_sum(x);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  __syncthreads();  // red[] may still be read by a previous reduction
  if (l == 0) red[w] = x;
  __syncthreads();
  const float t = l < (int)(blockDim.x >> 5) ? red[l] : 0.f;  // max is of |x| >= 0
  return MAX ? warp_max(t) : warp_sum(t);
}

__device__ __forceinline__ float quant_scale(float amax) {
  return fmaxf(amax, 1e-6f) / 127.f;
}

__device__ __forceinline__ int8_t quant_code(float x, float scale) {
  const float q = fminf(fmaxf(rintf(x / scale), -127.f), 127.f);
  return static_cast<int8_t>(__float2int_rn(q));
}

// Row `row` of x [M, D] as f32 into row_buf[D], LayerNormed when ln_w is
// not null. Each thread only ever touches its own entries of row_buf.
template <typename T>
__device__ __forceinline__ void ln_row(const T* __restrict__ x, const float* __restrict__ ln_w,
                                       const float* __restrict__ ln_b, float* row_buf,
                                       float* red, long long row, int D, float eps) {
  const T* xr = x + row * D;
  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += LNQ_THREADS) {
    const float v = to_float(xr[i]);
    row_buf[i] = v;
    s += v;
  }
  if (ln_w == nullptr) return;
  const float mean = block_reduce<false>(s, red) / D;
  float s2 = 0.f;
  for (int i = threadIdx.x; i < D; i += LNQ_THREADS) {
    const float dv = row_buf[i] - mean;
    s2 += dv * dv;
  }
  const float var = block_reduce<false>(s2, red) / D;
  const float r = 1.f / sqrtf(var + eps);
  for (int i = threadIdx.x; i < D; i += LNQ_THREADS)  // ((x - mean) * r) * w + b
    row_buf[i] = __fadd_rn(__fmul_rn(__fmul_rn(row_buf[i] - mean, r), ln_w[i]), ln_b[i]);
}

// One block per row of x [M, D]: (LN) -> int8 codes xq [M, D] + scale xs [M].
// ln_w == nullptr skips the LayerNorm. Dynamic shared memory: D floats.
template <typename T>
__global__ void __launch_bounds__(LNQ_THREADS)
    ln_quant_rows_kernel(const T* __restrict__ x, const float* __restrict__ ln_w,
                         const float* __restrict__ ln_b, int8_t* __restrict__ xq,
                         float* __restrict__ xs, int D, float eps) {
  extern __shared__ float row_buf[];
  __shared__ float red[LNQ_THREADS / 32];
  const long long row = blockIdx.x;
  ln_row(x, ln_w, ln_b, row_buf, red, row, D, eps);
  float am = 0.f;
  for (int i = threadIdx.x; i < D; i += LNQ_THREADS) am = fmaxf(am, fabsf(row_buf[i]));
  const float sc = quant_scale(block_reduce<true>(am, red));
  for (int i = threadIdx.x; i < D; i += LNQ_THREADS) xq[row * D + i] = quant_code(row_buf[i], sc);
  if (threadIdx.x == 0) xs[row] = sc;
}

// One warp per (row, group) of in [rows, cols]: int8 codes q [rows, cols]
// and scales sc [rows, cols / group].
template <typename T>
__global__ void __launch_bounds__(256)
    requant_groups_kernel(const T* __restrict__ in, int8_t* __restrict__ q,
                          float* __restrict__ sc, long long rows, int cols, int group) {
  const int ng = cols / group;
  const long long w = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= rows * ng) return;
  const long long row = w / ng;
  const int gi = static_cast<int>(w % ng);
  const long long off = row * cols + (long long)gi * group;
  float am = 0.f;
  for (int i = lane; i < group; i += 32) am = fmaxf(am, fabsf(to_float(in[off + i])));
  const float s = quant_scale(warp_max(am));
  for (int i = lane; i < group; i += 32) q[off + i] = quant_code(to_float(in[off + i]), s);
  if (lane == 0) sc[row * ng + gi] = s;
}

inline cudaError_t launch_ln_quant(const void* x, int dtype, const float* ln_w,
                                   const float* ln_b, int8_t* xq, float* xs,
                                   long long M, int D, float eps, cudaStream_t st) {
  if (M == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * D;
  if (dtype == DT_BF16)
    ln_quant_rows_kernel<bf16><<<(unsigned)M, LNQ_THREADS, smem, st>>>(
        static_cast<const bf16*>(x), ln_w, ln_b, xq, xs, D, eps);
  else if (dtype == DT_F32)
    ln_quant_rows_kernel<float><<<(unsigned)M, LNQ_THREADS, smem, st>>>(
        static_cast<const float*>(x), ln_w, ln_b, xq, xs, D, eps);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_requant(const T* in, int8_t* q, float* sc, long long rows,
                           int cols, int group, cudaStream_t st) {
  const long long warps = rows * (cols / group);
  if (warps == 0) return cudaSuccess;
  requant_groups_kernel<T><<<(unsigned)((warps + 7) / 8), 256, 0, st>>>(
      in, q, sc, rows, cols, group);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- int8 GEMM

constexpr int QBM = 128, QBN = 128, QBK = 64;
constexpr int QSTAGES = 3;
constexpr int QTHREADS = 256;
constexpr int QP = QBK + 16;  // smem row pitch in bytes
constexpr int Q_STAGE_BYTES = (QBM + QBN) * QP;
constexpr int Q_SMEM_BYTES = QSTAGES * Q_STAGE_BYTES;  // 61,440: dynamic

// GEMM epilogues (int8: bf16 qkv, f32 hidden; bf16_gemm.cuh: the operand
// dtype throughout)
enum {
  EPI_QKV = 0,     // + bias, columns < q_cols times q_scale -> OutT [M, N]
  EPI_SWIGLU = 1,  // silu(g1 + b1) * (g2 + b2) -> OutT [M, N = HID]
  EPI_GELU = 2,    // gelu(g + b), erf polynomial -> OutT [M, N = HID]
  EPI_RESID = 3,   // (+ bias) (* gamma) (+ res in ResT) -> OutT [M, N]
  EPI_I32 = 4,     // int8 only: the int32 sums, no scales -> OutT [M, N]
};

struct I8GemmArgs {
  const int8_t* A;          // [M, K]
  const int8_t* B;          // [rows, K]
  const float* row_scale;   // [M, K / group]
  const float* col_scale;   // [rows]
  const float* bias;        // [rows] or null
  const float* gamma;       // [N] or null (EPI_RESID)
  const void* res;          // [M, N] in ResT or null (EPI_RESID)
  void* out;                // [M, N]
  int M, N, K, group;
  int hid;                  // EPI_SWIGLU: first B row of W2
  int q_cols;               // EPI_QKV
  float q_scale;            // EPI_QKV
  int a_n, a_pad;           // A_MAP: A rows (and row scales) in images of
                            // a_pad rows, of which the first a_n are read
};

// A_MAP: where row r of the product reads its A row and row scales, row
// r % a_n of image r / a_n (T3's padded pre-quantized rows).
__device__ __forceinline__ long long a_src_row(const I8GemmArgs& p, int r) {
  return (long long)(r / p.a_n) * p.a_pad + r % p.a_n;
}

// An exact int32 sum in the output type: f32 rounds once (exact below
// 2^24), bf16 rounds that f32 value — the order of XLA's astype and
// PyTorch's .to(), which both convert an integer through f32.
template <typename T> __device__ __forceinline__ T from_int(int x);
template <> __device__ __forceinline__ int from_int<int>(int x) { return x; }
template <> __device__ __forceinline__ float from_int<float>(int x) { return __int2float_rn(x); }
template <> __device__ __forceinline__ bf16 from_int<bf16>(int x) {
  return __float2bfloat16_rn(__int2float_rn(x));
}

// D = A(16x32 s8, row) * B(32x8 s8, col) + D in s32. Fragments (g = lane/4,
// t = lane%4; four int8 per register): a0 (row g, k 4t..4t+3), a1 (row g+8),
// a2 (row g, k 16+4t..), a3 (row g+8, k 16+4t..); b0 (k 4t.., col g),
// b1 (k 16+4t.., col g); c0,c1 (row g, cols 2t, 2t+1), c2,c3 (row g+8).
__device__ __forceinline__ void mma_s8_16832(int (&c)[4], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// erf by Abramowitz & Stegun 7.1.26, the polynomial of the TPU kernel
// (anyloc_tpu/ops/pallas/fused_mlp.py:54-73), not erff.
__device__ __forceinline__ float erf_poly(float x) {
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f;
  const float a4 = -1.453152027f, a5 = 1.061405429f, p = 0.3275911f;
  const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float ax = fabsf(x);
  const float t = 1.f / (1.f + p * ax);
  const float poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t;
  return s * (1.f - poly * expf(-ax * ax));
}

__device__ __forceinline__ float gelu_poly(float x) {
  return 0.5f * x * (1.f + erf_poly(x * 0.70710677f));
}

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

// A_MAP reads A through a_src_row; the other instances read row r itself
// and compile without the mapping (it costs K3 and K4 ~1-3 % where it is
// only a runtime branch, on an H100 at 700 W).
template <int EPI, typename OutT, typename ResT, bool A_MAP>
__global__ void __launch_bounds__(QTHREADS)
    gemm_i8_kernel(I8GemmArgs p) {
  extern __shared__ __align__(16) int8_t q_smem[];
  const int bn = blockIdx.x, m0 = blockIdx.y * QBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int g = lane >> 2, t = lane & 3;
  const int ng = p.K / p.group;

  // this thread's two load slots per operand and stage (16 bytes each);
  // with A_MAP, A's row starts are mapped once here, not at every K step
  int a_row[2], b_src[2], ld_r[2], ld_k[2];
  const int8_t* a_map[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * QTHREADS;
    ld_r[i] = c >> 2;
    ld_k[i] = (c & 3) * 16;
    a_row[i] = m0 + ld_r[i];
    if (A_MAP) a_map[i] = a_row[i] < p.M ? p.A + a_src_row(p, a_row[i]) * p.K : p.A;
    b_src[i] = b_row<EPI>(p.N, p.hid, bn, ld_r[i]);
  }
  auto load_stage = [&](int stage, int k0) {
    int8_t* As = q_smem + stage * Q_STAGE_BYTES;
    int8_t* Bs = As + QBM * QP;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = k0 + ld_k[i];
      const bool ka = a_row[i] < p.M && k < p.K;
      const bool kb = b_src[i] >= 0 && k < p.K;
      if constexpr (A_MAP)
        cp_async16(As + ld_r[i] * QP + ld_k[i], ka ? a_map[i] + k : p.A, ka);
      else
        cp_async16(As + ld_r[i] * QP + ld_k[i],
                   ka ? p.A + (long long)a_row[i] * p.K + k : p.A, ka);
      cp_async16(Bs + ld_r[i] * QP + ld_k[i],
                 kb ? p.B + (long long)b_src[i] * p.K + k : p.B, kb);
    }
  };

  // column scales of this thread's 8 output columns
  float cs[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int br = b_row<EPI>(p.N, p.hid, bn, wn + nt * 8 + 2 * t + h);
      cs[nt][h] = EPI != EPI_I32 && br >= 0 ? p.col_scale[br] : 0.f;
    }

  int iacc[4][4][4];
  float facc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        iacc[i][j][e] = 0;
        facc[i][j][e] = 0.f;
      }

  const int nk = cdiv(p.K, QBK);
#pragma unroll
  for (int s = 0; s < QSTAGES - 1; ++s) {
    if (s < nk) load_stage(s, s * QBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<QSTAGES - 2>();
    __syncthreads();  // tile kt landed; tile kt-1's stage is free again
    if (kt + QSTAGES - 1 < nk) load_stage((kt + QSTAGES - 1) % QSTAGES, (kt + QSTAGES - 1) * QBK);
    cp_async_commit();
    const int8_t* As = q_smem + (kt % QSTAGES) * Q_STAGE_BYTES;
    const int8_t* Bs = As + QBM * QP;
#pragma unroll
    for (int ks = 0; ks < QBK / 32; ++ks) {
      const int kg = kt * QBK + ks * 32;
      if (kg >= p.K) break;  // K % 32 == 0 (the wrappers check)
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int8_t* ar = As + (wm + mt * 16 + g) * QP + ks * 32 + t * 4;
        a[mt][0] = lds32(ar);
        a[mt][1] = lds32(ar + 8 * QP);
        a[mt][2] = lds32(ar + 16);
        a[mt][3] = lds32(ar + 8 * QP + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* br = Bs + (wn + nt * 8 + g) * QP + ks * 32 + t * 4;
        const uint32_t b0 = lds32(br), b1 = lds32(br + 16);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          mma_s8_16832(iacc[mt][nt], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b0, b1);
      }
      if (EPI != EPI_I32 && (kg + 32) % p.group == 0) {  // the group ends: fold it into f32
        const int gi = (kg + 32) / p.group - 1;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const int r0 = m0 + wm + mt * 16 + g;
          const long long s0 = A_MAP ? a_src_row(p, r0) : r0;
          const long long s1 = A_MAP ? a_src_row(p, r0 + 8) : r0 + 8;
          const float rs0 = r0 < p.M ? p.row_scale[s0 * ng + gi] : 0.f;
          const float rs1 = r0 + 8 < p.M ? p.row_scale[s1 * ng + gi] : 0.f;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float v = __fmul_rn(__fmul_rn(__int2float_rn(iacc[mt][nt][e]),
                                                  e < 2 ? rs0 : rs1),
                                        cs[nt][e & 1]);
              facc[mt][nt][e] = __fadd_rn(facc[mt][nt][e], v);
              iacc[mt][nt][e] = 0;
            }
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + mt * 16 + g + half * 8;
      if (row >= p.M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (EPI == EPI_SWIGLU && nt >= 2) continue;
        const int tr = wn + nt * 8 + 2 * t;  // tile row of the first column
        const int br = b_row<EPI>(p.N, p.hid, bn, tr);
        if (br < 0) continue;  // N is even: the pair is valid together
        float v0 = facc[mt][nt][2 * half], v1 = facc[mt][nt][2 * half + 1];
        if (p.bias) {
          v0 = __fadd_rn(v0, p.bias[br]);
          v1 = __fadd_rn(v1, p.bias[br + 1]);
        }
        if (EPI == EPI_QKV) {
          if (br < p.q_cols) {
            v0 = __fmul_rn(v0, p.q_scale);
            v1 = __fmul_rn(v1, p.q_scale);
          }
          *reinterpret_cast<uint32_t*>(static_cast<bf16*>(p.out) + (long long)row * p.N + br) =
              pack_bf16(v0, v1);
        } else if (EPI == EPI_SWIGLU) {
          float u0 = facc[mt][nt + 2][2 * half], u1 = facc[mt][nt + 2][2 * half + 1];
          if (p.bias) {
            u0 = __fadd_rn(u0, p.bias[p.hid + br]);
            u1 = __fadd_rn(u1, p.bias[p.hid + br + 1]);
          }
          const float g0 = __fmul_rn(v0 / (1.f + expf(-v0)), u0);
          const float g1 = __fmul_rn(v1 / (1.f + expf(-v1)), u1);
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + (long long)row * p.N + br) =
              make_float2(g0, g1);
        } else if (EPI == EPI_GELU) {
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + (long long)row * p.N + br) =
              make_float2(gelu_poly(v0), gelu_poly(v1));
        } else if constexpr (EPI == EPI_RESID) {
          if (p.gamma) {
            v0 = __fmul_rn(v0, p.gamma[br]);
            v1 = __fmul_rn(v1, p.gamma[br + 1]);
          }
          const long long off = (long long)row * p.N + br;
          if (p.res) {
            const ResT* r = static_cast<const ResT*>(p.res) + off;
            v0 = __fadd_rn(v0, to_float(r[0]));
            v1 = __fadd_rn(v1, to_float(r[1]));
          }
          OutT* o = static_cast<OutT*>(p.out) + off;
          o[0] = from_float<OutT>(v0);
          o[1] = from_float<OutT>(v1);
        } else {  // EPI_I32: the int32 sums themselves, converted once
          OutT* o = static_cast<OutT*>(p.out) + (long long)row * p.N + br;
          o[0] = from_int<OutT>(iacc[mt][nt][2 * half]);
          o[1] = from_int<OutT>(iacc[mt][nt][2 * half + 1]);
        }
      }
    }
  }
}

template <int EPI, typename OutT, typename ResT = OutT, bool A_MAP = false>
cudaError_t launch_gemm_i8(const I8GemmArgs& p, cudaStream_t st) {
  if (p.M == 0 || p.N == 0) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(gemm_i8_kernel<EPI, OutT, ResT, A_MAP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       Q_SMEM_BYTES);
  if (e != cudaSuccess) return e;
  const int cols_per_block = EPI == EPI_SWIGLU ? 64 : QBN;
  const dim3 grid(cdiv(p.N, cols_per_block), cdiv(p.M, QBM));
  gemm_i8_kernel<EPI, OutT, ResT, A_MAP><<<grid, QTHREADS, Q_SMEM_BYTES, st>>>(p);
  return cudaGetLastError();
}

// The EPI_RESID GEMM for output and residual dtype codes (DT_*): K3 and K4
// write x's dtype over x; K9 writes its f32 x2 over a bf16 x, then a bf16
// output over that f32 x2.
inline cudaError_t launch_gemm_i8_resid(const I8GemmArgs& p, int out_dt, int res_dt,
                                        cudaStream_t st) {
  if (out_dt == DT_BF16)
    return res_dt == DT_BF16 ? launch_gemm_i8<EPI_RESID, bf16, bf16>(p, st)
                             : launch_gemm_i8<EPI_RESID, bf16, float>(p, st);
  return res_dt == DT_BF16 ? launch_gemm_i8<EPI_RESID, float, bf16>(p, st)
                           : launch_gemm_i8<EPI_RESID, float, float>(p, st);
}

}  // namespace
}  // namespace anyloc
