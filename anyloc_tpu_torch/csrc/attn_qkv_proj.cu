// K5 — attention read straight from the fused qkv tensor, then the output
// projection with bias, LayerScale and residual.
//
// Replaces anyloc_tpu/ops/pallas/attn_proj.py::flash_attention_qkv_proj
// (pallas_call at :399; body _attn_qkv_proj_kernel :280, _heads_attention
// :117): the attention half of every DINOv2 block up to the captured layer
// when N <= 1216 tokens.
//
// What bounds it on the H100: at the 308-px shape (B = 32, N = 485,
// D = 1536, 24 heads of 64) the out-projection is 2·B·N·D² ≈ 73 GFLOP and
// the attention 4·B·H·N²·hd ≈ 46 GFLOP, against ~0.1 GB of qkv/residual
// traffic: both halves are bound by tensor-core issue. The design is two
// launches of this file's kernels:
//   1. the flash-attention kernel of flash_attention.cuh over strided
//      column views of qkv [B, N, 3D] (q at column 0 + h·hd, k at D + h·hd,
//      v at 2D + h·hd, row stride 3D) — no head-split copy — writing each
//      head's output, rounded to qkv's dtype, into o [B, N, D];
//   2. a tiled mma.sync GEMM o[M, D] @ W_O with the epilogue
//      (+ bias) * gamma + residual in f32, cast to qkv's dtype.
// The TPU kernel keeps o in VMEM; here o makes one round trip through
// device memory (B·N·D·2 bytes each way), the first thing a later version
// removes by fusing the projection into the attention block.
//
// Rounding follows the TPU kernel: q * scale in f32 rounded to the input
// dtype before the score product (attn_proj.py:307), f32 scores, P in v's
// dtype, each head's output rounded to v's dtype (:152), f32 projection.
#include "flash_attention.cuh"

namespace anyloc {
namespace {

constexpr int GM = 64, GN = 64, GK = 32;
constexpr int GP = GK + 8;  // smem pitch (bf16): 80-byte rows, no bank clash

// out[M, N] = epilogue(A[M, K] @ W[N, K]^T); bf16 operands, f32 sums.
// Block tile 64x64, four warps of 32x32 (2 x 4 mma tiles), K step 32.
__global__ void __launch_bounds__(128)
    gemm_bf16_epilogue_kernel(const bf16* __restrict__ A,
                              const bf16* __restrict__ W,
                              const float* __restrict__ bias,
                              const float* __restrict__ gamma,
                              const bf16* __restrict__ res,
                              bf16* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) bf16 As[GM * GP];
  __shared__ __align__(16) bf16 Ws[GN * GP];
  const int n0 = blockIdx.x * GN, m0 = blockIdx.y * GM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t = lane & 3;

  float c[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[i][j][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GK) {
    __syncthreads();
    for (int i = threadIdx.x; i < GM * (GK / 8); i += 128) {
      const int r = i / (GK / 8), cv = (i % (GK / 8)) * 8;
      const bool kin = k0 + cv < K;  // K % 8 == 0: whole vectors
      uint4 av = make_uint4(0, 0, 0, 0), wv = make_uint4(0, 0, 0, 0);
      if (kin && m0 + r < M)
        av = *reinterpret_cast<const uint4*>(A + (long long)(m0 + r) * K + k0 + cv);
      if (kin && n0 + r < N)
        wv = *reinterpret_cast<const uint4*>(W + (long long)(n0 + r) * K + k0 + cv);
      *reinterpret_cast<uint4*>(&As[r * GP + cv]) = av;
      *reinterpret_cast<uint4*>(&Ws[r * GP + cv]) = wv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const bf16* ar = &As[(wm + mt * 16 + g) * GP + kk * 16 + t * 2];
        a[mt][0] = lds32(ar);
        a[mt][1] = lds32(ar + 8 * GP);
        a[mt][2] = lds32(ar + 8);
        a[mt][3] = lds32(ar + 8 * GP + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bf16* br = &Ws[(wn + nt * 8 + g) * GP + kk * 16 + t * 2];
        const uint32_t b0 = lds32(br), b1 = lds32(br + 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma_bf16_16816(c[mt][nt], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b0, b1);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn + nt * 8 + t * 2;  // N is even: col + 1 < N too
      if (col >= N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + mt * 16 + g + half * 8;
        if (row >= M) continue;
        float v0 = c[mt][nt][2 * half], v1 = c[mt][nt][2 * half + 1];
        if (bias) { v0 += bias[col]; v1 += bias[col + 1]; }
        if (gamma) { v0 *= gamma[col]; v1 *= gamma[col + 1]; }
        const long long off = (long long)row * N + col;
        if (res) {
          const float2 r = unpack_bf16(*reinterpret_cast<const uint32_t*>(res + off));
          v0 += r.x;
          v1 += r.y;
        }
        *reinterpret_cast<uint32_t*>(out + off) = pack_bf16(v0, v1);
      }
    }
  }
}

// Any dtype (f32): 64x64 tile, 16x16 threads of 4x4 outputs, FMA.
template <typename T>
__global__ void __launch_bounds__(256)
    gemm_scalar_epilogue_kernel(const T* __restrict__ A, const T* __restrict__ W,
                                const float* __restrict__ bias,
                                const float* __restrict__ gamma,
                                const T* __restrict__ res, T* __restrict__ out,
                                int M, int N, int K) {
  __shared__ float As[16][65];
  __shared__ float Ws[16][65];
  const int n0 = blockIdx.x * 64, m0 = blockIdx.y * 64;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += 16) {
    __syncthreads();
    for (int i = threadIdx.x; i < 64 * 16; i += 256) {
      const int r = i / 16, kk = i % 16;
      const bool kin = k0 + kk < K;
      As[kk][r] = (kin && m0 + r < M) ? to_float(A[(long long)(m0 + r) * K + k0 + kk]) : 0.f;
      Ws[kk][r] = (kin && n0 + r < N) ? to_float(W[(long long)(n0 + r) * K + k0 + kk]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[kk][ty + 16 * i];
        w[i] = Ws[kk][tx + 16 * i];
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
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= N) continue;
      float v = acc[i][j];
      if (bias) v += bias[col];
      if (gamma) v *= gamma[col];
      const long long off = (long long)row * N + col;
      if (res) v += to_float(res[off]);
      out[off] = from_float<T>(v);
    }
  }
}

}  // namespace
}  // namespace anyloc

// qkv [B, N, 3D] contiguous, w_nk [d_out, D] contiguous (W_O transposed),
// bias / gamma [d_out] f32 or null, res [B, N, d_out] or null,
// o [B, N, D] scratch, out [B, N, d_out].
extern "C" int anyloc_attn_qkv_proj(const void* qkv, const void* w_nk,
                                    const void* bias, const void* gamma,
                                    const void* res, void* o, void* out,
                                    int dtype, int B, int N, int H, int hd,
                                    int d_out, float scale, void* stream) {
  using namespace anyloc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int D = H * hd;
  const size_t esz = dtype == DT_BF16 ? 2 : 4;
  const char* base = static_cast<const char*>(qkv);
  AttnArgs p;
  p.q = base;
  p.k = base + esz * D;
  p.v = base + esz * 2 * D;
  p.o = o;
  p.B = B;
  p.H = H;
  p.N = N;
  const long long rs = 3LL * D;
  p.q_sb = p.k_sb = p.v_sb = (long long)N * rs;
  p.q_sh = p.k_sh = p.v_sh = hd;
  p.q_sn = p.k_sn = p.v_sn = rs;
  p.o_sb = (long long)N * D;
  p.o_sh = hd;
  p.o_sn = D;
  p.scale = scale;
  p.prescale_q = 1;
  cudaError_t e = launch_attention(p, dtype, hd, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  const int M = B * N;
  if (M == 0) return cudaSuccess;
  const dim3 grid(cdiv(d_out, 64), cdiv(M, 64));
  const float* bp = static_cast<const float*>(bias);
  const float* gp = static_cast<const float*>(gamma);
  if (dtype == DT_BF16) {
    gemm_bf16_epilogue_kernel<<<grid, 128, 0, st>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(w_nk), bp, gp,
        static_cast<const bf16*>(res), static_cast<bf16*>(out), M, d_out, D);
  } else if (dtype == DT_F32) {
    gemm_scalar_epilogue_kernel<float><<<grid, 256, 0, st>>>(
        static_cast<const float*>(o), static_cast<const float*>(w_nk), bp, gp,
        static_cast<const float*>(res), static_cast<float*>(out), M, d_out, D);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
