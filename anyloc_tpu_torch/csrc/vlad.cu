// K1 — VLAD aggregation, descs [B, N, D] f32 -> [B, C, D] f32.
//
// Replaces anyloc_tpu/ops/pallas/vlad_kernel.py::vlad_aggregate_fused
// (pallas_call at :179; body _vlad_kernel :81, _assignment :47). Hard
// cosine, hard euclidean and the reference's soft assignment; norm_descs
// and intra_norm on or off.
//
// What bounds it on the H100: per image it reads the N x D f32 facets
// (3 MB at 308 px, 33 MB at 1022 px) and does 2·N·C·D FLOP twice (the
// assignment dots and the residual sums) — about 2·C = 64 FLOP per byte,
// under the f32 FMA ridge, so it is memory- and latency-bound. The TPU
// kernel carried the [C, D] sums across sequential token blocks in VMEM;
// Hopper blocks run in no order and [C, D] = 196 KB f32 at C = 32,
// D = 1536 does not sit comfortably in one block's shared memory, so the
// work is split into three launches:
//   (a) assignment, 16 tokens per block, D streamed in 64-wide chunks
//       through shared memory with the C center chunks: f32 dots (near
//       ties decide labels), then per token the argmax (ties to the lowest
//       index) or the softmax, and the token's normalization scale;
//   (b) residual sums, one block per (64-wide D tile, image) looping over
//       all tokens: wsum = sum_n a·s·x, counts = sum_n a, then
//       wsum - counts·c (hard) or C·wsum - counts·sum_c c (soft);
//   (c) finalize, one block per image: intra-cluster norms and the global
//       norm over the whole [C, D].
#include "common.cuh"

namespace anyloc {
namespace {

constexpr int MAX_C = 64;
constexpr int VA_TOK = 16, VA_DCH = 64, VA_THREADS = 256;
constexpr int VR_DT = 64, VR_NT = 32, VR_THREADS = 256;
constexpr int VF_THREADS = 1024;

// mode: 0 hard cosine, 1 hard euclidean, 2 soft (cosine similarity).
// csim: the centers the similarity uses (unit centers for 0 and 2, raw for
// 1); c2: squared center norms (mode 1 only).
__global__ void __launch_bounds__(VA_THREADS)
    vlad_assign_kernel(const float* __restrict__ x,
                       const float* __restrict__ csim,
                       const float* __restrict__ c2, float* __restrict__ a,
                       float* __restrict__ s, int T, int D, int C, int mode,
                       int norm_descs, float temp) {
  __shared__ float xs[VA_TOK][VA_DCH + 1];
  __shared__ float cs[MAX_C][VA_DCH + 1];
  __shared__ float dots[VA_TOK][MAX_C];
  __shared__ float ssq[VA_TOK];
  const int t0 = blockIdx.x * VA_TOK;
  const int tid = threadIdx.x;
  const int pairs = VA_TOK * C;  // (token, center) dot products
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float sq[4] = {0.f, 0.f, 0.f, 0.f};
  for (int d0 = 0; d0 < D; d0 += VA_DCH) {
    __syncthreads();
    for (int i = tid; i < VA_TOK * VA_DCH; i += VA_THREADS) {
      const int tok = i / VA_DCH, dd = i % VA_DCH;
      xs[tok][dd] = (t0 + tok < T && d0 + dd < D)
                        ? x[(long long)(t0 + tok) * D + d0 + dd] : 0.f;
    }
    for (int i = tid; i < C * VA_DCH; i += VA_THREADS) {
      const int c = i / VA_DCH, dd = i % VA_DCH;
      cs[c][dd] = d0 + dd < D ? csim[(long long)c * D + d0 + dd] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int pr = tid + k * VA_THREADS;
      if (pr >= pairs) break;
      const int tok = pr / C, c = pr % C;
      float dsum = acc[k], ssum = sq[k];
#pragma unroll 8
      for (int dd = 0; dd < VA_DCH; ++dd) {
        const float xv = xs[tok][dd];
        dsum = fmaf(xv, cs[c][dd], dsum);
        ssum = fmaf(xv, xv, ssum);
      }
      acc[k] = dsum;
      sq[k] = ssum;
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int pr = tid + k * VA_THREADS;
    if (pr >= pairs) break;
    const int tok = pr / C, c = pr % C;
    dots[tok][c] = acc[k];
    if (c == 0) ssq[tok] = sq[k];
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  for (int tok = warp; tok < VA_TOK; tok += VA_THREADS / 32) {
    const int gt = t0 + tok;
    if (gt >= T) break;
    const float inv = rsqrtf(fmaxf(ssq[tok], 1e-24f));
    const float sc = norm_descs ? inv : 1.f;
    float v[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = lane + 32 * j;
      float val = -INFINITY;
      if (c < C) {
        const float dt = dots[tok][c];
        if (mode == 0) val = dt;  // argmax of x·ĉ is the cosine argmax
        else if (mode == 1) val = 2.f * dt * sc - c2[c];
        else val = temp * dt * inv;
      }
      v[j] = val;
    }
    float* arow = a + (long long)gt * C;
    if (mode < 2) {
      float bv = v[0];
      int bi = lane < C ? lane : MAX_C;
      if (lane + 32 < C && v[1] > bv) { bv = v[1]; bi = lane + 32; }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffff, bv, off);
        const int oi = __shfl_xor_sync(0xffffffff, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
      }
      if (lane < C) arow[lane] = lane == bi ? 1.f : 0.f;
      if (lane + 32 < C) arow[lane + 32] = lane + 32 == bi ? 1.f : 0.f;
    } else {
      float mx = fmaxf(v[0], v[1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, off));
      const float e0 = lane < C ? expf(v[0] - mx) : 0.f;
      const float e1 = lane + 32 < C ? expf(v[1] - mx) : 0.f;
      float sum = e0 + e1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffff, sum, off);
      if (lane < C) arow[lane] = e0 / sum;
      if (lane + 32 < C) arow[lane + 32] = e1 / sum;
    }
    if (lane == 0) s[gt] = sc;
  }
}

__global__ void __launch_bounds__(VR_THREADS)
    vlad_residual_kernel(const float* __restrict__ x,
                         const float* __restrict__ a,
                         const float* __restrict__ s,
                         const float* __restrict__ centers,
                         const float* __restrict__ csum,
                         float* __restrict__ out, int N, int D, int C,
                         int soft) {
  __shared__ float xs[VR_NT][VR_DT];
  __shared__ float ar[VR_NT][MAX_C];  // assignment weights
  __shared__ float aw[VR_NT][MAX_C];  // weights times the token's scale
  __shared__ float cnt_s[MAX_C];
  const int b = blockIdx.y, d0 = blockIdx.x * VR_DT;
  const int tid = threadIdx.x;
  const int dl = tid % VR_DT, cg = tid / VR_DT;  // 4 cluster groups
  constexpr int CG = VR_THREADS / VR_DT;
  float acc[MAX_C / CG];
#pragma unroll
  for (int i = 0; i < MAX_C / CG; ++i) acc[i] = 0.f;
  float cnt = 0.f;
  const long long base = (long long)b * N;
  for (int n0 = 0; n0 < N; n0 += VR_NT) {
    __syncthreads();
    for (int i = tid; i < VR_NT * VR_DT; i += VR_THREADS) {
      const int n = i / VR_DT, dd = i % VR_DT;
      xs[n][dd] = (n0 + n < N && d0 + dd < D)
                      ? x[(base + n0 + n) * D + d0 + dd] : 0.f;
    }
    for (int i = tid; i < VR_NT * C; i += VR_THREADS) {
      const int n = i / C, c = i % C;
      const bool in = n0 + n < N;
      const float av = in ? a[(base + n0 + n) * C + c] : 0.f;
      ar[n][c] = av;
      aw[n][c] = in ? av * s[base + n0 + n] : 0.f;
    }
    __syncthreads();
    if (tid < C)
      for (int n = 0; n < VR_NT; ++n) cnt += ar[n][tid];
    for (int n = 0; n < VR_NT; ++n) {
      const float xv = xs[n][dl];
#pragma unroll
      for (int i = 0; i < MAX_C / CG; ++i) {
        const int c = cg + CG * i;
        if (c < C) acc[i] = fmaf(aw[n][c], xv, acc[i]);
      }
    }
  }
  if (tid < C) cnt_s[tid] = cnt;
  __syncthreads();
  const int d = d0 + dl;
  if (d >= D) return;
#pragma unroll
  for (int i = 0; i < MAX_C / CG; ++i) {
    const int c = cg + CG * i;
    if (c >= C) break;
    const float v = soft ? C * acc[i] - cnt_s[c] * csum[d]
                         : acc[i] - cnt_s[c] * centers[(long long)c * D + d];
    out[((long long)b * C + c) * D + d] = v;
  }
}

__global__ void __launch_bounds__(VF_THREADS)
    vlad_finalize_kernel(float* __restrict__ v, int D, int C, int intra) {
  __shared__ float div_c[MAX_C];  // per-row divisor (intra norm, or 1)
  __shared__ float div_total;
  float* vb = v + (long long)blockIdx.x * C * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __shared__ float rows[MAX_C];  // row norm after the intra norm
  for (int c = warp; c < C; c += VF_THREADS / 32) {
    const float* row = vb + (long long)c * D;
    float ss = 0.f;
    for (int d = lane; d < D; d += 32) ss = fmaf(row[d], row[d], ss);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffff, ss, off);
    if (lane == 0) {
      const float nrm = sqrtf(ss);
      const float dv = intra ? fmaxf(nrm, 1e-12f) : 1.f;
      div_c[c] = dv;
      rows[c] = nrm / dv;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
    for (int c = 0; c < C; ++c) tot = fmaf(rows[c], rows[c], tot);
    div_total = fmaxf(sqrtf(tot), 1e-12f);
  }
  __syncthreads();
  const float dt = div_total;
  for (long long i = threadIdx.x; i < (long long)C * D; i += VF_THREADS)
    vb[i] = vb[i] / div_c[i / D] / dt;
}

}  // namespace
}  // namespace anyloc

// x [B, N, D], csim / centers [C, D], c2 [C], csum [D] (all f32,
// contiguous); scratch a [B, N, C], s [B, N]; out [B, C, D].
extern "C" int anyloc_vlad_aggregate(const float* x, const float* csim,
                                     const float* c2, const float* centers,
                                     const float* csum, float* a, float* s,
                                     float* out, int B, int N, int D, int C,
                                     int mode, int norm_descs, int intra_norm,
                                     float temp, void* stream) {
  using namespace anyloc;
  if (C < 1 || C > MAX_C || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = B * N;
  if (T > 0) {
    vlad_assign_kernel<<<cdiv(T, VA_TOK), VA_THREADS, 0, st>>>(
        x, csim, c2, a, s, T, D, C, mode, norm_descs, temp);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  vlad_residual_kernel<<<dim3(cdiv(D, VR_DT), B), VR_THREADS, 0, st>>>(
      x, a, s, centers, csum, out, N, D, C, mode == 2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  vlad_finalize_kernel<<<B, VF_THREADS, 0, st>>>(out, D, C, intra_norm);
  return static_cast<int>(cudaGetLastError());
}
