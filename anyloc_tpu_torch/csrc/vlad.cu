// K1 — VLAD aggregation, descs [B, N, D] f32 -> [B, C, D] f32.
//
// Replaces anyloc_tpu/ops/pallas/vlad_kernel.py::vlad_aggregate_fused
// (pallas_call at :179; body _vlad_kernel :81, _assignment :47). Hard
// cosine, hard euclidean and the reference's soft assignment; norm_descs
// and intra_norm on or off; 1..64 clusters.
//
// What bounds it on the H100: bytes. It must read the N x D f32 facets once
// (95 MB at [32, 484, 1536], 30 µs at 3.35 TB/s); the assignment dots,
// N·C·D FMA (0.76 G at C = 32, 23 µs at the f32 FMA rate), sit just under
// that. The TPU kernel kept [C, D] sums in VMEM across a sequential token
// axis and read x once; Hopper blocks run in no order and [C, D] is 196 KB
// at C = 32, D = 1536. The design reads x once all the same:
//   * a thread block cluster of 8 blocks owns an image, or at small
//     batch a range of its tokens; block r owns the D slice
//     [r·DS, (r+1)·DS), DS = 192 at D = 1536, and brings its slice of each
//     32-token tile into shared memory by cp.async, double-buffered;
//   * each block computes partial dots of the tile against its slice of
//     the centers, register-tiled 4 tokens x 8 centers a thread over
//     interleaved parts of the slice summed by shuffles (a 128-bit shared
//     load costs four wavefronts whatever its addresses, so loads per FMA
//     set the pace), and the tokens' partial |x|²;
//   * one cluster barrier a tile: then every block sums the partials of
//     the whole tile over the cluster through distributed shared memory,
//     in rank order (the same values in every block), and labels the
//     tokens itself (argmax, ties to the lowest index; cosine through the
//     centers' inverse norms) or weighs them (softmax), eight threads a
//     token;
//   * each block adds its slice into its own [C, DS] f32 accumulator in
//     shared memory: hard mode adds s·x to the one labelled row (D adds a
//     token, not C·D FMA), soft mode the dense aᵀx, register-tiled 4
//     centers x 4 columns a thread;
//   * the epilogue forms wsum - counts·c (hard) or C·wsum - counts·Σc
//     (soft), reduces the row norms across the cluster, and writes [C, D]
//     once. A hard residual within counts·2^-19·|c| is rounding noise (its
//     tokens equal its center up to the last bits of their normalization,
//     as a k-means singleton's do) and is written as zero, as the plain
//     versions do, where the intra norm would blow it up to a unit vector
//     that depends on the order of the sums. When a batch splits its
//     tokens (the 1022-px query) the splits write their [C, D] sums and
//     counts, and a finishing launch, one 8-block cluster per image, adds
//     them in split order and runs the same epilogue.
// Every sum runs in a fixed order and the counts are integers, so two
// launches give bit-equal outputs; no float atomics. The centers' prep
// (norms, inverse norms, Σc) runs in the kernel. The token splits come
// from the wrapper's plan (ops/kernels/vlad_kernel.py::vlad_plan).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace anyloc {
namespace {

constexpr int MAX_C = 64;
constexpr int VL_CL = 8;  // blocks per cluster, one D slice each (portable size)
constexpr int VL_TT = 32;  // tokens a tile
constexpr int VL_THREADS = 256;
constexpr float VL_RESIDUAL_FLOOR = 0x1p-19f;  // ops/kernels/vlad_kernel.py's RESIDUAL_FLOOR

struct VladArgs {
  const float* x;    // [B, N, D]
  const float* cen;  // [C, D] raw centers
  float* ws;         // [B, S, C, D] split sums (S > 1 only)
  float* wc;         // [B, S, C] split counts (S > 1 only)
  float* out;        // [B, C, D]
  int B, N, D, C, mode, norm_descs, intra, vec;
  float temp;
  int S, TPS;         // token splits, tokens per split
  int DS;             // the D slice of a block
};

__host__ __device__ inline int vlad_center_rows(int C) {
  int r = 8;
  while (r < C) r *= 2;
  return r;
}

// Shared-memory layout in floats (the wrapper's plan computes the same
// size): DSP = DS + 4 (rows of float4s, padded against bank conflicts),
// CR = C rounded up to 8, 16, 32 or 64 (rows of centers: whole 8-center
// units, a power of two of them), CQ = CR + 4 (a token's dots, then its
// |x|² in a float4 of its own).
struct VladSmem {
  int DSP, CR, CQ;
  float *xs, *cs, *acc, *csum, *wl, *part, *sl, *cnt, *c2, *cinv, *cpart, *rowpart, *rowdiv,
      *misc;
  int *labl, *icnt;
  __device__ VladSmem(float* base, int TT, int DS, int C) {
    DSP = DS + 4;
    CR = vlad_center_rows(C);
    CQ = CR + 4;
    float* p = base;
    xs = p;      p += 2 * TT * DSP;   // two token tiles of the slice
    cs = p;      p += CR * DSP;       // the centers' slice
    acc = p;     p += CR * DSP;       // [C, DS] sums
    csum = p;    p += DSP;            // soft: Σ_c c of the slice
    wl = p;      p += TT * CR;        // the tile's soft weights
    part = p;    p += 2 * TT * CQ;    // partial dots and |x|², two tiles
    sl = p;      p += TT;             // the tile's token scales
    labl = reinterpret_cast<int*>(p); p += TT;
    icnt = reinterpret_cast<int*>(p); p += CR;  // hard counts
    cnt = p;     p += CR;
    c2 = p;      p += CR;
    cinv = p;    p += CR;
    cpart = p;   p += CR;
    rowpart = p; p += CR;
    rowdiv = p;  p += CR;
    misc = p;
  }
};

__host__ __device__ inline int vlad_smem_floats(int TT, int DS, int C) {
  const int DSP = DS + 4, CR = vlad_center_rows(C), CQ = CR + 4;
  return 2 * TT * DSP + (2 * CR + 1) * DSP + TT * CR + 2 * TT * CQ + 2 * TT + 7 * CR + 4;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the two halves of a cluster barrier (cluster.sync() is both): writes to
// shared memory before the arrival are seen by every block after the wait
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffff, x, off);
  return x;
}

// rows x width floats of a row-major source (row stride ld) into dst rows
// of DSP floats, by cp.async (not committed)
__device__ void load_rows(float* dst, const float* src, int rows, long long ld, int width,
                          int DSP, int vec) {
  const int w = vec ? width / 4 : width;  // chunks of 16 or 4 bytes a row
  if (w == 0) return;
  const int dr = VL_THREADS / w, dq = VL_THREADS - dr * w;  // one stride in rows, chunks
  int r = threadIdx.x / w, q = threadIdx.x - r * w;
  for (; r < rows; r += dr, q += dq) {
    if (q >= w) { q -= w; ++r; if (r >= rows) break; }
    if (vec) cp_async16(dst + r * DSP + 4 * q, src + r * ld + 4 * q);
    else cp_async4(dst + r * DSP + q, src + r * ld + q);
  }
}

// Sum of one float over the cluster's blocks, in rank order: the same
// value in every block.
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cluster, float* local, int i) {
  float v[VL_CL];
#pragma unroll
  for (int r = 0; r < VL_CL; ++r) v[r] = cluster.map_shared_rank(local, r)[i];
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < VL_CL; ++r) s += v[r];
  return s;
}

// acc holds this block's [C, width] slice of wsum, cnt the counts (the same
// in every block) and cs the raw centers' slice: residuals, intra-cluster
// and global L2 across the cluster, then out. Ends with a cluster barrier,
// so no block leaves while another still reads its shared memory.
__device__ void vlad_epilogue(const VladArgs& p, cg::cluster_group& cluster, const VladSmem& L,
                              int b, int dlo, int width) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int C = p.C, D = p.D, DSP = L.DSP;
  const bool soft = p.mode == 2;
  if (soft) {
    for (int d = tid; d < width; d += VL_THREADS) {
      float s = 0.f;
      for (int c = 0; c < C; ++c) s += L.cs[c * DSP + d];
      L.csum[d] = s;
    }
  }
  __syncthreads();
  for (int c = warp; c < C; c += VL_THREADS / 32) {
    const float n = L.cnt[c];
    float* row = L.acc + c * DSP;
    const float* crow = L.cs + c * DSP;
    float ss = 0.f;
    for (int d = lane; d < width; d += 32) {
      const float v = soft ? C * row[d] - n * L.csum[d] : row[d] - n * crow[d];
      row[d] = v;
      ss = fmaf(v, v, ss);
    }
    ss = warp_sum(ss);
    if (lane == 0) L.rowpart[c] = ss;
  }
  cluster.sync();
  if (tid < C) {
    const float nrm = sqrtf(cluster_sum(cluster, L.rowpart, tid));
    const bool noise = !soft && nrm <= VL_RESIDUAL_FLOOR * L.cnt[tid] * sqrtf(L.c2[tid]);
    const float dv = p.intra ? fmaxf(nrm, 1e-12f) : 1.f;
    L.rowdiv[tid] = noise ? 0.f : dv;  // 0: the row is written as zero
    L.cpart[tid] = noise ? 0.f : nrm / dv;  // the row's norm after the intra norm
  }
  __syncthreads();
  if (tid == 0) {
    float tot = 0.f;
    for (int c = 0; c < C; ++c) tot = fmaf(L.cpart[c], L.cpart[c], tot);
    L.misc[0] = fmaxf(sqrtf(tot), 1e-12f);
  }
  __syncthreads();
  if (tid < C) L.rowdiv[tid] = L.rowdiv[tid] == 0.f ? 0.f : 1.f / (L.rowdiv[tid] * L.misc[0]);
  __syncthreads();
  for (int c = warp; c < C; c += VL_THREADS / 32) {
    const float f = L.rowdiv[c];
    const float* row = L.acc + c * DSP;
    float* o = p.out + ((long long)b * C + c) * D + dlo;
    for (int d = lane; d < width; d += 32) o[d] = row[d] * f;
  }
  cluster.sync();
}

// the centers' squared and inverse norms, across the cluster (their slice
// in L.cs, loaded and synced)
__device__ void center_norms(const VladArgs& p, cg::cluster_group& cluster, const VladSmem& L,
                             int width) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, DSP = L.DSP;
  for (int c = warp; c < p.C; c += VL_THREADS / 32) {
    float ss = 0.f;
    for (int d = lane; d < width; d += 32) ss = fmaf(L.cs[c * DSP + d], L.cs[c * DSP + d], ss);
    ss = warp_sum(ss);
    if (lane == 0) L.cpart[c] = ss;
  }
  cluster.sync();
  if (tid < p.C) {
    const float n2 = cluster_sum(cluster, L.cpart, tid);
    L.c2[tid] = n2;
    L.cinv[tid] = 1.f / fmaxf(sqrtf(n2), 1e-12f);  // unit centers, for cosine
  }
}

// zeros where no load lands (the pad columns of the tiles and of the
// centers' rows, the rows past C), and the centers' slice by cp.async
__device__ void vlad_prologue(const VladArgs& p, const VladSmem& L, int TT, int dlo, int width) {
  const int tid = threadIdx.x, DSP = L.DSP, pad = DSP - width;
  for (int i = tid; i < 2 * TT * pad; i += VL_THREADS) {
    const int r = i / pad;
    L.xs[r * DSP + width + (i - r * pad)] = 0.f;
  }
  for (int i = tid; i < L.CR * pad; i += VL_THREADS) {
    const int r = i / pad;
    L.cs[r * DSP + width + (i - r * pad)] = 0.f;
  }
  for (int i = tid; i < (L.CR - p.C) * DSP; i += VL_THREADS) L.cs[p.C * DSP + i] = 0.f;
  for (int i = tid; i < TT * L.CR; i += VL_THREADS) L.wl[i] = 0.f;
  if (tid < L.CR) {
    L.cnt[tid] = 0.f;
    L.icnt[tid] = 0;
  }
  load_rows(L.cs, p.cen + dlo, p.C, p.D, width, DSP, p.vec);
}

__global__ void __cluster_dims__(VL_CL, 1, 1) __launch_bounds__(VL_THREADS)
    vlad_cluster_kernel(VladArgs p) {
  constexpr int TT = VL_TT;
  static_assert(TT * 8 == VL_THREADS, "eight threads a token label the tile");
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 vl_smem4[];
  const VladSmem L(reinterpret_cast<float*>(vl_smem4), TT, p.DS, p.C);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = static_cast<int>(cluster.block_rank());
  const int cid = blockIdx.x / VL_CL;
  const int b = cid / p.S, split = cid % p.S;
  const int C = p.C, D = p.D, DS = p.DS;
  const int DSP = L.DSP, CR = L.CR, CQ = L.CQ;
  const int dlo = rank * DS;
  const int width = max(0, min(DS, D - dlo));
  const int t_begin = split * p.TPS;
  const int t_end = min(p.N, t_begin + p.TPS);
  const int ntiles = t_end > t_begin ? cdiv(t_end - t_begin, TT) : 0;
  const float* xb = p.x + (long long)b * p.N * D + dlo;
  const bool soft = p.mode == 2;

  vlad_prologue(p, L, TT, dlo, width);
  for (int i = tid; i < CR * DSP; i += VL_THREADS) L.acc[i] = 0.f;
  cp_async_commit();  // the centers
  if (ntiles > 0) {
    load_rows(L.xs, xb + (long long)t_begin * D, min(TT, t_end - t_begin), D, width, DSP, p.vec);
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  center_norms(p, cluster, L, width);

  for (int t = 0; t < ntiles; ++t) {
    const int tok0 = t_begin + t * TT;
    const int nv = min(TT, t_end - tok0);
    const float* xs = L.xs + (t & 1) * TT * DSP;
    float* part = L.part + (t & 1) * TT * CQ;
    cp_async_wait<0>();  // this tile, issued one tile ahead
    __syncthreads();

    // partial dots over this slice and the tokens' partial |x|², register
    // tiled: a thread takes 4 tokens (tg + 8i) x 8 centers (a unit) over
    // one of kq interleaved parts of the slice's float4 columns, the kq
    // threads of a tile are neighbouring lanes and sum their parts by
    // shuffles. A 128-bit shared load costs four wavefronts whatever its
    // addresses, so the 12 loads a step feed 128 FMA
    {
      static_assert(TT == 32, "the dots take 8 groups of 4 tokens");
      const int units = CR / 8;                 // 1, 2, 4 or 8
      const int kq = VL_THREADS / (8 * units);  // 32, 16, 8 or 4 parts
      const int ti = tid / kq, kp = tid % kq;
      const int tg = ti / units, unit = ti % units;
      const float4* cr = reinterpret_cast<const float4*>(L.cs + unit * 8 * DSP);
      float a[4][8], ss[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ss[i] = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) a[i][j] = 0.f;
      }
      for (int k = kp; k < DS / 4; k += kq) {
        float4 u[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) u[i] = reinterpret_cast<const float4*>(xs + (tg + 8 * i) * DSP)[k];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 e = cr[j * (DSP / 4) + k];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[i][j] = fmaf(u[i].x, e.x, a[i][j]);
            a[i][j] = fmaf(u[i].y, e.y, a[i][j]);
            a[i][j] = fmaf(u[i].z, e.z, a[i][j]);
            a[i][j] = fmaf(u[i].w, e.w, a[i][j]);
          }
        }
        if (unit == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ss[i] = fmaf(u[i].x, u[i].x, ss[i]); ss[i] = fmaf(u[i].y, u[i].y, ss[i]);
            ss[i] = fmaf(u[i].z, u[i].z, ss[i]); ss[i] = fmaf(u[i].w, u[i].w, ss[i]);
          }
        }
      }
      for (int off = 1; off < kq; off *= 2) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) a[i][j] += __shfl_xor_sync(0xffffffff, a[i][j], off);
          ss[i] += __shfl_xor_sync(0xffffffff, ss[i], off);
        }
      }
      if (kp == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float4* o = reinterpret_cast<float4*>(part + (tg + 8 * i) * CQ + unit * 8);
          o[0] = make_float4(a[i][0], a[i][1], a[i][2], a[i][3]);
          o[1] = make_float4(a[i][4], a[i][5], a[i][6], a[i][7]);
          if (unit == 0) part[(tg + 8 * i) * CQ + CR] = ss[i];
        }
      }
    }
    // the cluster barrier, split: the next tile's loads (into the buffer
    // the last tile's sums have left) are issued while the blocks arrive
    cluster_arrive();
    if (t + 1 < ntiles) {
      load_rows(L.xs + ((t + 1) & 1) * TT * DSP, xb + (long long)(tok0 + TT) * D,
                min(TT, t_end - tok0 - TT), D, width, DSP, p.vec);
      cp_async_commit();
    }
    cluster_wait();

    // every block sums the whole tile's partials over the cluster in rank
    // order (the same values in every block) and labels or weighs the
    // tokens itself: one cluster barrier a tile. Eight threads a token,
    // each a float4 of centers (two at C > 32), float4 loads from the
    // eight blocks in flight together; argmax (ties to the lowest index)
    // or softmax across the eight by shuffles.
    if (tid < TT * 8) {
      const int tok = tid >> 3, q = tid & 7;
      const float4* rp[VL_CL];
#pragma unroll
      for (int r = 0; r < VL_CL; ++r)
        rp[r] = reinterpret_cast<const float4*>(cluster.map_shared_rank(part, r)) + tok * (CQ / 4);
      // chunk j: centers 4(q + 8j)..+3; thread q = 0 also the |x|² chunk
      const int nk = CR / 4;
      float4 dsum[2];
      float ssq = 0.f;
      {
        float4 v[2][VL_CL];
        float vs[VL_CL];
#pragma unroll
        for (int r = 0; r < VL_CL; ++r) {
          v[0][r] = q < nk ? rp[r][q] : make_float4(0.f, 0.f, 0.f, 0.f);
          v[1][r] = q + 8 < nk ? rp[r][q + 8] : make_float4(0.f, 0.f, 0.f, 0.f);
          vs[r] = q == 0 ? rp[r][nk].x : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int r = 0; r < VL_CL; ++r) {
            a.x += v[j][r].x; a.y += v[j][r].y; a.z += v[j][r].z; a.w += v[j][r].w;
          }
          dsum[j] = a;
        }
#pragma unroll
        for (int r = 0; r < VL_CL; ++r) ssq += vs[r];
      }
      ssq = __shfl_sync(0xffffffff, ssq, lane & ~7);  // from the token's thread q = 0
      const float inv = rsqrtf(fmaxf(ssq, 1e-24f));
      const float sc = p.norm_descs ? inv : 1.f;
      float val[8];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float e4[4] = {dsum[j].x, dsum[j].y, dsum[j].z, dsum[j].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 4 * (q + 8 * j) + e;
          float f = -INFINITY;
          if (c < C) {
            if (p.mode == 0) f = e4[e] * L.cinv[c];  // x·ĉ: the cosine argmax
            else if (p.mode == 1) f = 2.f * e4[e] * sc - L.c2[c];
            else f = p.temp * e4[e] * L.cinv[c] * inv;
          }
          val[4 * j + e] = f;
        }
      }
      const bool valid = tok < nv;
      if (!soft) {
        float bv = val[0];
        int bi = 4 * q;
#pragma unroll
        for (int i = 1; i < 8; ++i)
          if (val[i] > bv) { bv = val[i]; bi = 4 * (q + 8 * (i / 4)) + i % 4; }
#pragma unroll
        for (int off = 4; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffff, bv, off);
          const int oi = __shfl_xor_sync(0xffffffff, bi, off);
          if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
        }
        if (q == 0 && valid) {
          L.labl[tok] = bi;
          L.sl[tok] = sc;
          atomicAdd(&L.icnt[bi], 1);  // integer counts: exact in any order
        }
      } else {
        float mx = val[0];
#pragma unroll
        for (int i = 1; i < 8; ++i) mx = fmaxf(mx, val[i]);
#pragma unroll
        for (int off = 4; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, off));
        float ex[8], sum = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          ex[i] = val[i] == -INFINITY ? 0.f : expf(val[i] - mx);
          sum += ex[i];
        }
#pragma unroll
        for (int off = 4; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffff, sum, off);
        if (valid) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int k = q + 8 * j;
            if (k < CR / 4)
              reinterpret_cast<float4*>(L.wl + tok * CR)[k] =
                  make_float4(ex[4 * j] / sum, ex[4 * j + 1] / sum, ex[4 * j + 2] / sum,
                              ex[4 * j + 3] / sum);
          }
          if (q == 0) L.sl[tok] = sc;
        }
      }
    }
    __syncthreads();

    if (!soft) {
      // hard: s·x into the labelled row, tokens in order. Thread (g, dg)
      // owns float4 column dg of the rows c with c % 4 == g, so each
      // thread updates ~TT / 4 tokens, labels read eight at a time
      const int DG = DS / 4;
      for (int it = tid; it < 4 * DG; it += VL_THREADS) {
        const int g = it / DG, dg = it - g * DG;
#pragma unroll
        for (int t8 = 0; t8 < TT; t8 += 8) {
          const int4 la = reinterpret_cast<const int4*>(L.labl + t8)[0];
          const int4 lb = reinterpret_cast<const int4*>(L.labl + t8)[1];
          const int lab[8] = {la.x, la.y, la.z, la.w, lb.x, lb.y, lb.z, lb.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int tok = t8 + i;
            if (tok >= nv || (lab[i] & 3) != g) continue;
            float4* a = reinterpret_cast<float4*>(L.acc + lab[i] * DSP) + dg;
            const float4 x = reinterpret_cast<const float4*>(xs + tok * DSP)[dg];
            const float s = L.sl[tok];
            float4 u = *a;
            u.x = fmaf(s, x.x, u.x);
            u.y = fmaf(s, x.y, u.y);
            u.z = fmaf(s, x.z, u.z);
            u.w = fmaf(s, x.w, u.w);
            *a = u;
          }
        }
      }
    } else {  // soft: dense aᵀ(s·x), 4 centers x 4 columns a thread
      const int DG = DS / 4;
      for (int it = tid; it < (CR / 4) * DG; it += VL_THREADS) {
        const int c0 = 4 * (it / DG), dg = it % DG;
        float4 a[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j] = reinterpret_cast<const float4*>(L.acc + (c0 + j) * DSP)[dg];
        for (int tok = 0; tok < nv; ++tok) {
          const float s = L.sl[tok];
          const float4 w = reinterpret_cast<const float4*>(L.wl + tok * CR)[c0 / 4];
          const float4 x = reinterpret_cast<const float4*>(xs + tok * DSP)[dg];
          const float ws[4] = {w.x * s, w.y * s, w.z * s, w.w * s};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            a[j].x = fmaf(ws[j], x.x, a[j].x);
            a[j].y = fmaf(ws[j], x.y, a[j].y);
            a[j].z = fmaf(ws[j], x.z, a[j].z);
            a[j].w = fmaf(ws[j], x.w, a[j].w);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) reinterpret_cast<float4*>(L.acc + (c0 + j) * DSP)[dg] = a[j];
      }
      const int c = tid - (VL_THREADS - 64);  // the last two warps: the counts
      if (c >= 0 && c < C)
        for (int tok = 0; tok < nv; ++tok) L.cnt[c] += L.wl[tok * CR + c];
    }
    __syncthreads();  // this tile's buffer is the next load's target
  }

  if (!soft && tid < C) L.cnt[tid] = static_cast<float>(L.icnt[tid]);
  __syncthreads();
  if (p.S == 1) {
    vlad_epilogue(p, cluster, L, b, dlo, width);
    return;
  }
  // a token split: its sums and counts, added up by the finishing launch
  const long long sb = (long long)b * p.S + split;
  for (int c = warp; c < C; c += VL_THREADS / 32) {
    float* w = p.ws + (sb * C + c) * D + dlo;
    for (int d = lane; d < width; d += 32) w[d] = L.acc[c * DSP + d];
  }
  if (rank == 0 && tid < C) p.wc[sb * C + tid] = L.cnt[tid];
  cluster.sync();
}

// After the token splits: one cluster per image adds the splits' sums and
// counts in split order (eight independent loads in flight a thread), then
// the epilogue.
__global__ void __cluster_dims__(VL_CL, 1, 1) __launch_bounds__(VL_THREADS)
    vlad_finish_kernel(VladArgs p) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 vl_smem4[];
  const VladSmem L(reinterpret_cast<float*>(vl_smem4), 0, p.DS, p.C);
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / VL_CL;
  const int C = p.C, D = p.D;
  const int dlo = rank * p.DS;
  const int width = max(0, min(p.DS, D - dlo));
  vlad_prologue(p, L, 0, dlo, width);
  cp_async_commit();
  const long long split_stride = (long long)C * D;
  const float* base = p.ws + (long long)b * p.S * split_stride + dlo;
  constexpr int J = 8;
  for (int e0 = tid; e0 < C * width; e0 += J * VL_THREADS) {
    long long off[J];
    float s[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int e = min(e0 + j * VL_THREADS, C * width - 1);
      const int c = e / width;
      off[j] = (long long)c * D + (e - c * width);
      s[j] = 0.f;
    }
    for (int sp = 0; sp < p.S; ++sp) {
      float v[J];
#pragma unroll
      for (int j = 0; j < J; ++j) v[j] = base[sp * split_stride + off[j]];
#pragma unroll
      for (int j = 0; j < J; ++j) s[j] += v[j];
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int e = e0 + j * VL_THREADS;
      if (e < C * width) L.acc[e / width * L.DSP + e % width] = s[j];
    }
  }
  if (tid < C) {
    float s = 0.f;
    for (int sp = 0; sp < p.S; ++sp) s += p.wc[((long long)b * p.S + sp) * C + tid];
    L.cnt[tid] = s;
  }
  cp_async_wait<0>();
  __syncthreads();
  center_norms(p, cluster, L, width);  // the epilogue's floor reads |c|
  vlad_epilogue(p, cluster, L, b, dlo, width);
}

}  // namespace
}  // namespace anyloc

// How many clusters of the main pass the card holds at once with
// smem_bytes a block, or -(CUDA error): the plan's splits aim to fill them.
extern "C" int anyloc_vlad_resident_clusters(int smem_bytes) {
  using namespace anyloc;
  cudaError_t e = cudaFuncSetAttribute(vlad_cluster_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(VL_CL);
  cfg.blockDim = dim3(VL_THREADS);
  cfg.dynamicSmemBytes = smem_bytes;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, vlad_cluster_kernel, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// x [B, N, D] and centers [C, D] f32, contiguous; ws [B, S, C, D] and
// wc [B, S, C] (used when splits > 1); out [B, C, D]. The plan (splits,
// tokens_per_split, slice) comes from the wrapper; vec: x's rows load as
// 16-byte chunks (D % 4 == 0, 16-byte aligned base).
extern "C" int anyloc_vlad_aggregate(const float* x, const float* centers, float* ws, float* wc,
                                     float* out, int B, int N, int D, int C, int mode,
                                     int norm_descs, int intra_norm, float temp, int splits,
                                     int tokens_per_split, int slice, int vec, void* stream) {
  using namespace anyloc;
  if (C < 1 || C > MAX_C || mode < 0 || mode > 2 || slice % 4 != 0 ||
      (long long)slice * VL_CL < D || splits < 1 ||
      (splits > 1 && tokens_per_split % VL_TT != 0) || (long long)splits * tokens_per_split < N)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  VladArgs p;
  p.x = x; p.cen = centers; p.ws = ws; p.wc = wc; p.out = out;
  p.B = B; p.N = N; p.D = D; p.C = C; p.mode = mode;
  p.norm_descs = norm_descs; p.intra = intra_norm; p.vec = vec; p.temp = temp;
  p.S = splits; p.TPS = tokens_per_split; p.DS = slice;
  const int smem = vlad_smem_floats(VL_TT, slice, C) * 4;
  cudaError_t e = cudaFuncSetAttribute(vlad_cluster_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  vlad_cluster_kernel<<<B * splits * VL_CL, VL_THREADS, smem, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const int smem_f = vlad_smem_floats(0, slice, C) * 4;
  e = cudaFuncSetAttribute(vlad_finish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_f);
  if (e != cudaSuccess) return static_cast<int>(e);
  vlad_finish_kernel<<<B * VL_CL, VL_THREADS, smem_f, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
