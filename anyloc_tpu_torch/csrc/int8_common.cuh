// Device code shared by the int8 W8A8 kernels K3 (fused_mlp_int8.cu), K4
// (attn_half_int8.cu), K9 (fused_block_int8.cu, through K4's and K3's
// entry points), T3 (attn_half_variant.cu, on K4's stages) and the int8
// products T1 and T2 (matmul.cu); the GEMM pipeline, the LayerNorm, the
// erf polynomial and the EPI_* epilogue codes also serve the bf16 GEMM
// (bf16_gemm.cuh):
//   * ln_quant_rows_kernel: optional LayerNorm (f32, two-pass mean and
//     variance, 1 / sqrtf — not the approximate rsqrtf) and a per-row int8
//     quantize, scale = max(amax, 1e-6) / 127, codes rintf(x / scale)
//     (half to even, as jnp.round) clamped to +-127;
//   * requant_groups_kernel: the same quantize per (row, column group);
//   * gemm_tma_kernel<OpS8>: int8 x int8 -> int32, both operands
//     K-contiguous (A [M, K] activations, B [rows, K] = the nn.Linear
//     weight layout). At each group's edge of the K loop the int32 partial
//     turns into f32 (__int2float_rn) and is added as (partial *
//     row_scale[row, group]) * col_scale[col] — the JAX order — to an f32
//     accumulator; the epilogue (EPI_*) finishes the tile. EPI_I32 skips
//     the fold: it keeps the exact int32 sums over the whole of K (f32
//     holds integers exactly only up to 2^24, and a sum over K 4096 of int8
//     products reaches 4096 * 127^2 ~ 6.6e7).
//
// What bounds the GEMMs on the H100: at the 308-px batch-32 shape
// (M = 15520 rows, D = 1536) each one is 73-391 G int8 ops against tens of
// MB of operands, far above the card's 590 ops/byte balance point, so they
// are bound by tensor-core issue: 2·M·N·K operations at 1,979 TOPS. The
// design is Hopper's: wgmma.mma_async m64nNk32 .s32.s8.s8 with both
// operands K-major in shared memory (the only layout int8 wgmma takes, and
// the port's), fed by TMA into a ring of 128-byte-swizzled stages (128 K
// bytes each) guarded by mbarriers; two consumer warpgroups of 64 rows
// each issue the wgmmas, keep one tile's products in flight while the
// next tile lands, and free a stage when its products are done; the first
// warp of a producer warpgroup issues the loads. setmaxnreg moves the
// producer's registers to the consumers (40 / 232; nvcc -Xptxas -v reports
// the 168 of the launch, no spills), which is why the producer is a whole
// warpgroup. The pipeline is one template over the operand type (Op:
// OpS8 below, OpBF16 and OpTF32x3 in bf16_gemm.cuh): the ring, the boxes
// and the descriptors count bytes (a stage holds one 128-byte swizzled row
// of K, 128 int8, 64 bf16 or 32 f32 elements; a wgmma step is 32 bytes),
// and Op names the element, the accumulator, the tensor-map type, the
// wgmma and the epilogue. f32 stages are split (SPLIT: the producer
// warpgroup's other three warps write each landed tile's tf32 hi and lo).
// Two instances of the int8 tiles (GemmTile, below):
//   * one K group (w12, qkv, T1, T2): int32 sums only, folded once in the
//     epilogue; 128 x 256 block tiles, four 48 KB stages; EPI_SWIGLU loads
//     its B tile as two TMA boxes, 128 W1 rows and the same 128 rows of W2,
//     so g1 and g2 of one hidden column sit in one thread (columns j and
//     j + 128 of the m64n256 accumulator);
//   * groups (w3 with the hidden chunk 512, the projection with head
//     chunks of 384 or 768, groups down to 32 in the tests): f32 sums
//     beside the int32 ones, folded after wgmma.wait_group 0 at the 32-byte
//     wgmma step where a group ends; 128 x 128 tiles, six 32 KB stages.
// Ragged M, N and K are left to TMA's zero fill; the epilogue masks rows
// and columns past the edge. A_MAP (T3's pre_quant) gathers its A rows
// with cp.async into the same swizzled layout. On one H100 80GB HBM3 at
// 700 W (chip_smoke.py; PERF.md) T1 int8 runs at ~1000 TOPS at w12
// [8704x1536]x[1536x8192] and T2 at ~670; the grouped instance reaches
// about half the one-group rate (PERF.md §5). Without setmaxnreg (154-168
// registers), with a producer warpgroup or with a producer warp (288
// threads), T2 took 0.366 ms for 0.327, K3 1.44 for 1.27 and K4 1.08
// for 1.00 (chip_smoke.py, same call), so setmaxnreg and the warpgroup
// stay.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

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

// ---------------------------------------------------------------- the TMA GEMM

constexpr int QBM = 128;       // rows per block: two consumer warpgroups of 64
constexpr int QBK = 128;       // K bytes per stage: one 128-byte swizzled row
constexpr int QTHREADS = 384;  // two consumer warpgroups, then the producer warpgroup

// GEMM epilogues (int8: bf16 qkv, f32 hidden; bf16_gemm.cuh: the operand
// dtype throughout)
enum {
  EPI_QKV = 0,     // + bias, columns < q_cols times q_scale -> OutT [M, N]
  EPI_SWIGLU = 1,  // silu(g1 + b1) * (g2 + b2) -> OutT [M, N = HID]
  EPI_GELU = 2,    // gelu(g + b), erf polynomial -> OutT [M, N = HID]
  EPI_RESID = 3,   // (+ bias) (* gamma) (+ res in ResT) -> OutT [M, N]
  EPI_I32 = 4,     // int8 only: the int32 sums, no scales -> OutT [M, N]
  // float only: EPI_RESID that also stores the sum before LayerScale in
  // f32 (K5 under autograd); an instance of its own, so that no other
  // epilogue carries the store's branch (it cost K5's bf16 projection
  // ~16 % on the H100)
  EPI_RESID_PRE = 5,
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
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

// Tiles of the GEMM instances. ONE: the product has one K group (group ==
// K: K3's w12, K4's qkv, T2; EPI_I32, which never folds; every float
// product): only the wgmma's accumulators live in the K loop, folded
// (int8) once in the epilogue, so a consumer warpgroup holds a 64 x 256
// tile (128 registers of sums). Otherwise (K3's w3, K4's projection: one
// group per hidden or head chunk) f32 accumulators sit beside the int32
// ones and the tile is 64 x 128 per consumer. SPLIT (f32 operands,
// bf16_gemm.cuh's OpTF32x3): a stage holds the tiles as TMA lands them
// (RAW bytes, each element then replaced by its tf32 hi) and their lo
// parts right after, so a stage is twice as large: 64 x 128 per consumer
// and three stages of 64 KB.
template <bool ONE, bool SPLIT = false>
struct GemmTile {
  static constexpr int BN = ONE && !SPLIT ? 256 : 128;  // columns per block (B rows)
  static constexpr int STAGES = SPLIT ? 3 : (ONE ? 4 : 6);
  static constexpr int A_BYTES = QBM * QBK;       // 16 KB
  static constexpr int B_BYTES = BN * QBK;        // 32 or 16 KB
  static constexpr int RAW = A_BYTES + B_BYTES;   // what TMA loads into a stage
  static constexpr int STAGE = SPLIT ? 2 * RAW : RAW;
  static constexpr int BARRIERS = SPLIT ? 3 : 2;  // full, empty (, ready) per stage
  static constexpr int FOLD = 2;                  // SPLIT: K tiles an accumulator sums
  static constexpr int SMEM = STAGES * STAGE + BARRIERS * STAGES * 8 + 1024;  // + alignment
};

// SPLIT: the producer warpgroup's warps 1-3 replace each landed stage's
// elements by their tf32 hi in place and write their lo RAW bytes on, then
// arrive on `ready` (96 arrivals) for the consumers; warp 0 keeps issuing
// the loads meanwhile.
template <class T>
__device__ __forceinline__ void split_stages(uint8_t* smem, uint64_t* full, uint64_t* ready,
                                             int nk, int tid) {
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % T::STAGES;
    mbar_wait(&full[s], (kt / T::STAGES) & 1);
    uint8_t* st = smem + s * T::STAGE;
    for (int i = tid; i < T::RAW / 16; i += 96) {
      float4* x = reinterpret_cast<float4*>(st + 16 * i);
      const float4 v = *x;
      uint4 hi, lo;
      tf32_split(v.x, hi.x, lo.x);
      tf32_split(v.y, hi.y, lo.y);
      tf32_split(v.z, hi.z, lo.z);
      tf32_split(v.w, hi.w, lo.w);
      *reinterpret_cast<uint4*>(x) = hi;
      *reinterpret_cast<uint4*>(st + T::RAW + 16 * i) = lo;
    }
    fence_proxy_async();  // the writes, visible to the consumers' wgmma
    mbar_arrive(&ready[s]);
  }
}

// (partial * row_scale) * col_scale, the JAX order
__device__ __forceinline__ float dequant(int partial, float rs, float cs) {
  return __fmul_rn(__fmul_rn(__int2float_rn(partial), rs), cs);
}

// Two neighbouring outputs in one store (col is even and N is even, so
// the pair is aligned to its size).
__device__ __forceinline__ void store_pair(int* o, int a, int b) {
  *reinterpret_cast<int2*>(o) = make_int2(a, b);
}
__device__ __forceinline__ void store_pair(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* o, bf16 a, bf16 b) {
  __nv_bfloat162 v;
  v.x = a;
  v.y = b;
  *reinterpret_cast<__nv_bfloat162*>(o) = v;
}

// Per-column constants of the epilogue of columns col, col + 1, read once
// for both rows a thread holds: column scales (one group), bias, SwiGLU's
// W2 scales and bias, LayerScale.
struct EpiCols {
  float cs0, cs1, b0, b1, cu0, cu1, bu0, bu1, g0, g1;
};

template <int EPI, bool ONE>
__device__ __forceinline__ EpiCols epi_cols(const I8GemmArgs& p, int col) {
  EpiCols c = {};
  if (ONE) {
    c.cs0 = p.col_scale[col];
    c.cs1 = p.col_scale[col + 1];
  }
  if (p.bias) {
    c.b0 = p.bias[col];
    c.b1 = p.bias[col + 1];
  }
  if (EPI == EPI_SWIGLU) {
    const int w2 = p.hid + col;
    c.cu0 = p.col_scale[w2];
    c.cu1 = p.col_scale[w2 + 1];
    if (p.bias) {
      c.bu0 = p.bias[w2];
      c.bu1 = p.bias[w2 + 1];
    }
  }
  if (EPI == EPI_RESID && p.gamma) {
    c.g0 = p.gamma[col];
    c.g1 = p.gamma[col + 1];
  }
  return c;
}

// The epilogue of output columns col, col + 1 of one row (off = row * N +
// col) from accumulator entries e, e + 1: the one-group fold with the row
// scale rs (or the folded f32 sums), + bias, then the EPI_* step, rounded
// once.
template <int EPI, typename OutT, typename ResT, bool ONE, int NACC>
__device__ __forceinline__ void epilogue2(const I8GemmArgs& p, const int (&acc)[NACC],
                                          const float (&facc)[NACC], int e, float rs,
                                          long long off, int col, const EpiCols& c) {
  float v0, v1;
  if constexpr (ONE) {
    v0 = __fadd_rn(0.f, dequant(acc[e], rs, c.cs0));
    v1 = __fadd_rn(0.f, dequant(acc[e + 1], rs, c.cs1));
  } else {
    v0 = facc[e];
    v1 = facc[e + 1];
  }
  if (p.bias) {
    v0 = __fadd_rn(v0, c.b0);
    v1 = __fadd_rn(v1, c.b1);
  }
  if constexpr (EPI == EPI_QKV) {
    if (col < p.q_cols) {
      v0 = __fmul_rn(v0, p.q_scale);
      v1 = __fmul_rn(v1, p.q_scale);
    }
    *reinterpret_cast<uint32_t*>(static_cast<bf16*>(p.out) + off) = pack_bf16(v0, v1);
  } else if constexpr (EPI == EPI_SWIGLU) {  // W2's sums of the same columns, BN / 2 on
    float u0 = __fadd_rn(0.f, dequant(acc[e + NACC / 2], rs, c.cu0));
    float u1 = __fadd_rn(0.f, dequant(acc[e + NACC / 2 + 1], rs, c.cu1));
    if (p.bias) {
      u0 = __fadd_rn(u0, c.bu0);
      u1 = __fadd_rn(u1, c.bu1);
    }
    const float g0 = __fmul_rn(v0 / (1.f + expf(-v0)), u0);
    const float g1 = __fmul_rn(v1 / (1.f + expf(-v1)), u1);
    *reinterpret_cast<float2*>(static_cast<float*>(p.out) + off) = make_float2(g0, g1);
  } else if constexpr (EPI == EPI_GELU) {
    *reinterpret_cast<float2*>(static_cast<float*>(p.out) + off) =
        make_float2(gelu_poly(v0), gelu_poly(v1));
  } else {  // EPI_RESID
    if (p.gamma) {
      v0 = __fmul_rn(v0, c.g0);
      v1 = __fmul_rn(v1, c.g1);
    }
    if (p.res) {
      const ResT* r = static_cast<const ResT*>(p.res) + off;
      v0 = __fadd_rn(v0, to_float(r[0]));
      v1 = __fadd_rn(v1, to_float(r[1]));
    }
    store_pair(static_cast<OutT*>(p.out) + off, from_float<OutT>(v0), from_float<OutT>(v1));
  }
}

// The int8 operands of the TMA GEMM. An operand type names the element,
// the accumulator, the tensor-map type, whether a stage is split (SPLIT,
// GemmTile), the wgmma of one 32-byte K step (lo: the descriptor step from
// a split stage's hi to its lo) and the epilogue of a consumer's tile
// (OpBF16, OpTF32x3: bf16_gemm.cuh).
struct OpS8 {
  using Elem = int8_t;
  using Acc = int;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr bool SPLIT = false;

  template <int N>
  __device__ static __forceinline__ void mma(int (&d)[N], float (&)[N], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d, uint32_t) {
    wgmma_s8(d, desc_a, desc_b, scale_d);
  }

  // Each thread holds columns c0 + 8j + 2t, + 1 of rows row0 and row0 + 8,
  // whose A rows (and row scales) are src0 and src1.
  template <int EPI, typename OutT, typename ResT, bool ONE, int NACC>
  __device__ static __forceinline__ void epilogue(const I8GemmArgs& p, const int (&acc)[NACC],
                                                  const float (&facc)[NACC], int row0,
                                                  long long src0, long long src1, int c0, int t) {
    constexpr int BN = 2 * NACC;
    const bool in0 = row0 < p.M, in1 = row0 + 8 < p.M;
    float rs0 = 0.f, rs1 = 0.f;  // one group: the row scales (ng == 1)
    if (ONE && EPI != EPI_I32) {
      if (in0) rs0 = p.row_scale[src0];
      if (in1) rs1 = p.row_scale[src1];
    }
#pragma unroll
    for (int j = 0; j < (EPI == EPI_SWIGLU ? BN / 16 : BN / 8); ++j) {
      const int col = c0 + j * 8 + 2 * t;  // N is even: the pair is valid together
      if (col >= p.N) continue;
      const long long off0 = (long long)row0 * p.N + col, off1 = off0 + 8LL * p.N;
      if constexpr (EPI == EPI_I32) {  // the int32 sums themselves, converted once
        OutT* o = static_cast<OutT*>(p.out);
        if (in0) store_pair(o + off0, from_int<OutT>(acc[4 * j]), from_int<OutT>(acc[4 * j + 1]));
        if (in1) store_pair(o + off1, from_int<OutT>(acc[4 * j + 2]), from_int<OutT>(acc[4 * j + 3]));
      } else {
        const EpiCols c = epi_cols<EPI, ONE>(p, col);
        if (in0) epilogue2<EPI, OutT, ResT, ONE>(p, acc, facc, 4 * j, rs0, off0, col, c);
        if (in1) epilogue2<EPI, OutT, ResT, ONE>(p, acc, facc, 4 * j + 2, rs1, off1, col, c);
      }
    }
  }
};

// out = epilogue(A[M, K] @ B[rows, K]^T) over the operand type Op, with the
// arguments Args (I8GemmArgs, or bf16_gemm.cuh's GemmArgs). Warpgroups 0
// and 1 are the consumers of rows 0-63 and 64-127, warpgroup 2 the
// producer (its first warp loads). A_MAP (int8 only) reads A through
// a_src_row with cp.async (a row gather, which a tensor map cannot
// express), into the layout TMA's 128-byte swizzle gives; the other
// instances load A by TMA and compile without the mapping (a runtime
// branch in every GEMM cost K3 and K4 ~1-3 %, on an H100 at 700 W).
template <class Op, int EPI, typename OutT, typename ResT, bool A_MAP, bool ONE, class Args>
__global__ void __launch_bounds__(QTHREADS, 1)
    gemm_tma_kernel(const __grid_constant__ CUtensorMap amap,
                    const __grid_constant__ CUtensorMap bmap, Args p) {
  using T = GemmTile<ONE, Op::SPLIT>;
  constexpr int BN = T::BN;
  constexpr int NACC = BN / 2;                           // sums per thread
  constexpr int KE = QBK / sizeof(typename Op::Elem);    // K elements per stage
  constexpr int KS = KE / 4;                             // K elements per 32-byte wgmma step
  static_assert(!A_MAP || KE == QBK, "A_MAP gathers int8 rows");
  extern __shared__ uint8_t q_smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(q_smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::STAGES * T::STAGE);
  uint64_t* empty = full + T::STAGES;
  uint64_t* ready = empty + T::STAGES;  // SPLIT: the stage's hi and lo are written

  const int m0 = blockIdx.y * QBM;
  // first output column; EPI_SWIGLU: the B tile is BN / 2 W1 rows (hidden
  // columns c0..) over the same BN / 2 rows of W2
  const int c0 = blockIdx.x * (EPI == EPI_SWIGLU ? BN / 2 : BN);
  const int nk = cdiv(p.K, KE);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], A_MAP ? 33 : 1);  // + the producer warp's cp.async
      mbar_init(&empty[s], 8);              // one arrival per consumer warp
      if (Op::SPLIT) mbar_init(&ready[s], 96);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // ---------------------------------------- producer
    regs_shrink<40>();
    const int lane = threadIdx.x - 256;
    if constexpr (Op::SPLIT) {
      if (lane >= 32) split_stages<T>(smem, full, ready, nk, lane - 32);
    }
    if (lane >= (A_MAP ? 32 : 1)) return;
    if (!A_MAP) tma_prefetch_map(&amap);
    tma_prefetch_map(&bmap);
    const int8_t* arow[4];  // A_MAP: rows lane + 32 i of the tile, null past M
    if constexpr (A_MAP) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = m0 + lane + 32 * i;
        arow[i] = r < p.M ? p.A + a_src_row(p, r) * (long long)p.K : nullptr;
      }
    }
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % T::STAGES;
      if (kt >= T::STAGES) mbar_wait(&empty[s], (kt / T::STAGES - 1) & 1);
      uint8_t* As = smem + s * T::STAGE;
      uint8_t* Bs = As + T::A_BYTES;
      const int k0 = kt * KE;
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], A_MAP ? T::B_BYTES : T::RAW);
        if (!A_MAP) tma_load_2d(As, &amap, &full[s], k0, m0);
        if (EPI == EPI_SWIGLU) {
          tma_load_2d(Bs, &bmap, &full[s], k0, c0);
          tma_load_2d(Bs + BN / 2 * QBK, &bmap, &full[s], k0, p.hid + c0);
        } else {
          tma_load_2d(Bs, &bmap, &full[s], k0, c0);
        }
      }
      if constexpr (A_MAP) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = lane + 32 * i;
#pragma unroll
          for (int ch = 0; ch < 8; ++ch) {
            const int k = k0 + ch * 16;
            const bool ok = arow[i] != nullptr && k < p.K;
            cp_async16(As + r * QBK + ((ch ^ (r & 7)) << 4), ok ? arow[i] + k : p.A, ok);
          }
        }
        mbar_arrive_cp_async(&full[s]);
      }
    }
    if (A_MAP) cp_async_wait<0>();
    return;
  }
  // ------------------------------------------------------------ consumers
  regs_grow<232>();
  const int cw = wg;
  const int tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = m0 + cw * 64 + warp * 16 + g;  // and row0 + 8
  int ng = 1;                                     // K groups
  if constexpr (!ONE) ng = p.K / p.group;
  long long src0 = row0, src1 = row0 + 8;  // the rows of A (and row scales) they read
  if constexpr (A_MAP) {
    src0 = row0 < p.M ? a_src_row(p, row0) : 0;
    src1 = row0 + 8 < p.M ? a_src_row(p, row0 + 8) : 0;
  }

  typename Op::Acc acc[NACC];
  // the folded f32 sums (unused, so not kept, with one group); SPLIT: the
  // f32 sums that every T::FOLD tiles' products join by __fadd_rn (F29:
  // wgmma rounds each add toward zero by a share of the accumulator, so
  // no accumulator sums more than T::FOLD tiles)
  float facc[NACC];
  if constexpr (!ONE || Op::SPLIT) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) facc[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0;

  int pending = -1;  // the stage of the last tile whose wgmmas may still read it
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % T::STAGES;
    mbar_wait(Op::SPLIT ? &ready[s] : &full[s], (kt / T::STAGES) & 1);
    if (A_MAP) fence_proxy_async();  // cp.async wrote A through the generic proxy
    const uint8_t* As = smem + s * T::STAGE + cw * 64 * QBK;
    const uint8_t* Bs = smem + s * T::STAGE + T::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int kg = kt * KE + ks * KS;
      // int8: K % 32 == 0 (the wrappers check); bf16: K % 8 == 0, and the
      // last step's columns past K are TMA's zero fill
      if (kg < p.K) {
        const uint64_t da = smem_desc<128>(As + ks * 32, 16, 1024);
        const uint64_t db = smem_desc<128>(Bs + ks * 32, 16, 1024);
        if constexpr (Op::SPLIT) {  // lo·hi, hi·lo, hi·hi into acc, afresh every FOLD tiles
          Op::mma(acc, acc, da, db, ks > 0 || kt % T::FOLD > 0, T::RAW >> 4, 1);
        } else if constexpr (ONE) {
          Op::mma(acc, facc, da, db, kg, T::RAW >> 4);  // 0: the first step, D = A * B
        } else {
          Op::mma(acc, facc, da, db, kg % p.group, T::RAW >> 4);  // 0: a group starts
          if ((kg + KS) % p.group == 0) {      // the group ends: fold it into f32
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(acc);
            const int gi = (kg + KS) / p.group - 1;
            const float rs0 = row0 < p.M ? p.row_scale[src0 * ng + gi] : 0.f;
            const float rs1 = row0 + 8 < p.M ? p.row_scale[src1 * ng + gi] : 0.f;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
              const int col = c0 + j * 8 + 2 * t;  // column scales from L1: no registers held
              const float cs0 = col < p.N ? __ldg(p.col_scale + col) : 0.f;
              const float cs1 = col < p.N ? __ldg(p.col_scale + col + 1) : 0.f;
#pragma unroll
              for (int e = 0; e < 4; ++e)
                facc[4 * j + e] = __fadd_rn(
                    facc[4 * j + e], dequant(acc[4 * j + e], e < 2 ? rs0 : rs1, e & 1 ? cs1 : cs0));
            }
            wgmma_fence();
          }
        }
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous tile's products are done: free its stage
    if (pending >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[pending]);
    }
    pending = s;
    if constexpr (Op::SPLIT) {
      if ((kt + 1) % T::FOLD == 0 || kt + 1 == nk) {  // the tiles' sums join facc
        wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int i = 0; i < NACC; ++i) facc[i] = __fadd_rn(facc[i], acc[i]);
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if constexpr (Op::SPLIT)
    Op::template epilogue<EPI, OutT, ResT, ONE>(p, facc, facc, row0, src0, src1, c0, t);
  else
    Op::template epilogue<EPI, OutT, ResT, ONE>(p, acc, facc, row0, src0, src1, c0, t);
}

// Encode the two tensor maps (A [M, K], B [rows, K], boxes of one 128-byte
// row of K by 128 rows of A and BN rows of B, or two boxes of BN / 2 for
// EPI_SWIGLU) and launch one block per 128 x BN output tile.
template <class Op, int EPI, typename OutT, typename ResT, bool A_MAP, bool ONE, class Args>
cudaError_t launch_gemm_tiles(const Args& p, cudaStream_t st) {
  using T = GemmTile<ONE, Op::SPLIT>;
  constexpr cuuint32_t KE = QBK / sizeof(typename Op::Elem);  // K elements of a box row
  CUtensorMap amap = {}, bmap;
  cudaError_t e = cudaSuccess;
  const cuuint64_t kb = (cuuint64_t)p.K * sizeof(typename Op::Elem);  // bytes per row of A and B
  if (!A_MAP) {
    const cuuint64_t dims[2] = {(cuuint64_t)p.K, (cuuint64_t)p.M};
    const cuuint32_t box[2] = {KE, QBM};
    e = make_tma_map(&amap, Op::TMA_TYPE, 2, p.A, dims, &kb, box, 128);
  }
  if (e != cudaSuccess) return e;
  const cuuint64_t b_rows = EPI == EPI_SWIGLU ? (cuuint64_t)(p.hid + p.N) : (cuuint64_t)p.N;
  const cuuint64_t bdims[2] = {(cuuint64_t)p.K, b_rows};
  const cuuint32_t bbox[2] = {KE, (cuuint32_t)(EPI == EPI_SWIGLU ? T::BN / 2 : T::BN)};
  e = make_tma_map(&bmap, Op::TMA_TYPE, 2, p.B, bdims, &kb, bbox, 128);
  if (e != cudaSuccess) return e;
  auto kernel = gemm_tma_kernel<Op, EPI, OutT, ResT, A_MAP, ONE, Args>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return e;
  const int cols_per_block = EPI == EPI_SWIGLU ? T::BN / 2 : T::BN;
  const dim3 grid(cdiv(p.N, cols_per_block), cdiv(p.M, QBM));
  kernel<<<grid, QTHREADS, T::SMEM, st>>>(amap, bmap, p);
  return cudaGetLastError();
}

template <int EPI, typename OutT, typename ResT = OutT, bool A_MAP = false>
cudaError_t launch_gemm_i8(const I8GemmArgs& p, cudaStream_t st) {
  if (p.M == 0 || p.N == 0) return cudaSuccess;
  if (EPI == EPI_I32 || p.group == p.K)
    return launch_gemm_tiles<OpS8, EPI, OutT, ResT, A_MAP, true>(p, st);
  if constexpr (EPI == EPI_RESID && !A_MAP)  // only the residual products take K groups
    return launch_gemm_tiles<OpS8, EPI, OutT, ResT, false, false>(p, st);
  return cudaErrorInvalidValue;
}

// The EPI_RESID GEMM for output and residual dtype codes (DT_*): K3 and K4
// write x's dtype over x; K9 writes its f32 x2 over a bf16 x, then a bf16
// output over that f32 x2.
// (A template, so that a source that never calls it compiles none of its
// four instances.)
template <int EPI = EPI_RESID>
cudaError_t launch_gemm_i8_resid(const I8GemmArgs& p, int out_dt, int res_dt, cudaStream_t st) {
  if (out_dt == DT_BF16)
    return res_dt == DT_BF16 ? launch_gemm_i8<EPI, bf16, bf16>(p, st)
                             : launch_gemm_i8<EPI, bf16, float>(p, st);
  return res_dt == DT_BF16 ? launch_gemm_i8<EPI, float, bf16>(p, st)
                           : launch_gemm_i8<EPI, float, float>(p, st);
}

}  // namespace
}  // namespace anyloc
