// Flash attention device code shared by K2 (flash_attention.cu) and K5
// (attn_qkv_proj.cu): softmax(q k^T * scale) v for one (batch, head) per
// block row, read through element strides so that K5 can hand it strided
// column views of the fused [B, N, 3D] qkv tensor without a copy.
//
// Online softmax (running max m, denominator l, f32 accumulator) over
// 64-key tiles: the TPU kernels carried m/l/acc across sequential grid
// steps in VMEM scratch; on Hopper blocks run in no order, so each block
// walks all key tiles of its query rows itself.
#pragma once

#include "common.cuh"

namespace anyloc {

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, N;
  // element strides (batch, head, token); the head dim is contiguous
  long long q_sb, q_sh, q_sn;
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  long long o_sb, o_sh, o_sn;
  float scale;
  // 0 (K2): scores = (q k^T) * scale in f32.
  // 1 (K5): q * scale in f32, rounded to the input dtype, then q k^T.
  int prescale_q;
};

namespace {

constexpr int FA_BQ = 64;  // query rows per block: 4 warps x 16 rows
constexpr int FA_BK = 64;  // keys per shared-memory tile
constexpr int FA_THREADS = 128;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffff, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffff, x, 1);
  return x + __shfl_xor_sync(0xffffffff, x, 2);
}

// bf16 inputs: tensor-core (mma.sync m16n8k16) products with f32 sums.
template <int HD>
__global__ void __launch_bounds__(FA_THREADS)
    flash_attn_bf16_kernel(AttnArgs p, int n_qt) {
  constexpr int KP = HD + 8;     // K tile pitch (bf16), keeps rows 16B aligned
  constexpr int VP = FA_BK + 8;  // transposed V tile pitch
  __shared__ __align__(16) bf16 Ks[FA_BK * KP];
  __shared__ __align__(16) bf16 Vt[HD * VP];

  const int qt = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int b = bh / p.H, h = bh % p.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int N = p.N;

  const bf16* Q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* K = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* V = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  bf16* O = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;

  const int r0 = qt * FA_BQ + warp * 16 + g;
  const int r1 = r0 + 8;

  // this warp's 16 query rows as A fragments, kept in registers
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = (e & 1) ? r1 : r0;
      const int col = kk * 16 + t * 2 + ((e & 2) ? 8 : 0);
      uint32_t u = 0;
      if (row < N) {
        u = lds32(Q + row * p.q_sn + col);
        if (p.prescale_q) {
          const float2 f = unpack_bf16(u);
          u = pack_bf16(f.x * p.scale, f.y * p.scale);
        }
      }
      qa[kk][e] = u;
    }
  }

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  constexpr int VEC = HD / 8;  // 16-byte vectors per key row
  for (int k0 = 0; k0 < N; k0 += FA_BK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < FA_BK * VEC; i += FA_THREADS) {
      const int r = i / VEC, c = (i % VEC) * 8;
      const int key = k0 + r;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (key < N) {  // ragged tail: zeros, so masked keys add exact zeros
        kv = *reinterpret_cast<const uint4*>(K + key * p.k_sn + c);
        vv = *reinterpret_cast<const uint4*>(V + key * p.v_sn + c);
      }
      *reinterpret_cast<uint4*>(&Ks[r * KP + c]) = kv;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(c + j) * VP + r] = ve[j];
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys for this warp
    float s[FA_BK / 8][4];
#pragma unroll
    for (int j = 0; j < FA_BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const bf16* kr = &Ks[(j * 8 + g) * KP + kk * 16 + t * 2];
        mma_bf16_16816(s[j], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3],
                       lds32(kr), lds32(kr + 8));
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < FA_BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + t * 2 + (e & 1);
        float x = p.prescale_q ? s[j][e] : s[j][e] * p.scale;
        if (col >= N) x = -INFINITY;
        s[j][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    // key 0 is valid in the first tile, so the running max is finite
    const float mn0 = fmaxf(m[0], quad_max(mx0));
    const float mn1 = fmaxf(m[1], quad_max(mx1));
    const float al0 = expf(m[0] - mn0);
    const float al1 = expf(m[1] - mn1);
    m[0] = mn0;
    m[1] = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < FA_BK / 8; ++j) {
      s[j][0] = expf(s[j][0] - mn0);
      s[j][1] = expf(s[j][1] - mn0);
      s[j][2] = expf(s[j][2] - mn1);
      s[j][3] = expf(s[j][3] - mn1);
      ls0 += s[j][0] + s[j][1];
      ls1 += s[j][2] + s[j][3];
    }
    l[0] = l[0] * al0 + ls0;  // per-thread partial; quad-summed at the end
    l[1] = l[1] * al1 + ls1;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      acc[j][0] *= al0;
      acc[j][1] *= al0;
      acc[j][2] *= al1;
      acc[j][3] *= al1;
    }
    // O += P V with P rounded to bf16 (v's dtype), as the TPU kernel does;
    // the S accumulator layout of two key n-tiles is the A fragment of P
#pragma unroll
    for (int kt = 0; kt < FA_BK / 16; ++kt) {
      const uint32_t a0 = pack_bf16(s[2 * kt][0], s[2 * kt][1]);
      const uint32_t a1 = pack_bf16(s[2 * kt][2], s[2 * kt][3]);
      const uint32_t a2 = pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const bf16* vr = &Vt[(j * 8 + g) * VP + kt * 16 + t * 2];
        mma_bf16_16816(acc[j], a0, a1, a2, a3, lds32(vr), lds32(vr + 8));
      }
    }
  }

  const float l0 = quad_sum(l[0]);
  const float l1 = quad_sum(l[1]);
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = j * 8 + t * 2;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(O + r0 * p.o_sn + col) =
          pack_bf16(acc[j][0] / l0, acc[j][1] / l0);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(O + r1 * p.o_sn + col) =
          pack_bf16(acc[j][2] / l1, acc[j][3] / l1);
  }
}

constexpr int FS_ROWS = 128;  // query rows per block, one per thread
constexpr int FS_TK = 32;     // keys per shared-memory tile

// Any dtype (f32 on the main path's test shapes): one query row per thread,
// FMA products in f32, P rounded to v's dtype before PV.
template <typename T, int HD>
__global__ void __launch_bounds__(FS_ROWS)
    flash_attn_scalar_kernel(AttnArgs p, int n_qt) {
  __shared__ float Ks[FS_TK][HD];
  __shared__ float Vs[FS_TK][HD];
  const int qt = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int b = bh / p.H, h = bh % p.H;
  const int N = p.N;
  const int row = qt * FS_ROWS + threadIdx.x;
  const bool valid = row < N;

  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* O = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  float q[HD], acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    float x = valid ? to_float(Q[row * p.q_sn + d]) : 0.f;
    if (p.prescale_q) x = to_float(from_float<T>(x * p.scale));
    q[d] = x;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < N; k0 += FS_TK) {
    __syncthreads();
    for (int i = threadIdx.x; i < FS_TK * HD; i += FS_ROWS) {
      const int r = i / HD, d = i % HD;
      const bool in = k0 + r < N;
      Ks[r][d] = in ? to_float(K[(k0 + r) * p.k_sn + d]) : 0.f;
      Vs[r][d] = in ? to_float(V[(k0 + r) * p.v_sn + d]) : 0.f;
    }
    __syncthreads();
    const int kn = min(FS_TK, N - k0);
    for (int j = 0; j < kn; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) s = fmaf(q[d], Ks[j][d], s);
      if (!p.prescale_q) s *= p.scale;
      const float mn = fmaxf(m, s);
      const float al = expf(m - mn);
      const float pj = expf(s - mn);
      l = l * al + pj;
      const float pc = to_float(from_float<T>(pj));
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = fmaf(pc, Vs[j][d], acc[d] * al);
      m = mn;
    }
  }
  if (valid) {
#pragma unroll
    for (int d = 0; d < HD; ++d) O[row * p.o_sn + d] = from_float<T>(acc[d] / l);
  }
}

template <int HD>
cudaError_t launch_attention_hd(const AttnArgs& p, int dtype, cudaStream_t st) {
  const int bh = p.B * p.H;
  if (dtype == DT_BF16) {
    const int n_qt = cdiv(p.N, FA_BQ);
    flash_attn_bf16_kernel<HD><<<bh * n_qt, FA_THREADS, 0, st>>>(p, n_qt);
  } else if (dtype == DT_F32) {
    const int n_qt = cdiv(p.N, FS_ROWS);
    flash_attn_scalar_kernel<float, HD><<<bh * n_qt, FS_ROWS, 0, st>>>(p, n_qt);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Launch attention over head dims 16, 32, 64 or 128 (the wrappers refuse
// others before they get here).
static inline cudaError_t launch_attention(const AttnArgs& p, int dtype, int hd,
                                    cudaStream_t st) {
  if (p.B * p.H == 0 || p.N == 0) return cudaSuccess;
  switch (hd) {
    case 16: return launch_attention_hd<16>(p, dtype, st);
    case 32: return launch_attention_hd<32>(p, dtype, st);
    case 64: return launch_attention_hd<64>(p, dtype, st);
    case 128: return launch_attention_hd<128>(p, dtype, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace anyloc
