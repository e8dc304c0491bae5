// Flash attention device code shared by K2 (flash_attention.cu), K5
// (attn_qkv_proj.cu) and the attention stage of K4, K6, K7, K9 and T3:
// softmax(q k^T * scale) v for one (batch, head) per block row, read
// through element strides so that K5 can hand it strided column views of
// the fused [B, N, 3D] qkv tensor without a copy. The output has the
// operands' dtype; with O_F32, bf16 operands write f32 (T3's batched_dots,
// whose per-head outputs are never rounded to bf16).
//
// Replaces the TPU kernels of anyloc_tpu/ops/pallas/flash_attention.py
// (flash_attention :62, flash_attention_heads :139, flash_attention_blocked
// :241) and the attention stages of attn_proj.py. The TPU kernels carried
// the online-softmax state across sequential grid steps in VMEM; on Hopper
// blocks run in no order, so each block walks all key tiles of its query
// rows itself.
//
// What bounds it on the H100: 4·B·H·N²·hd operations (the two products),
// 7.3 GFLOP per (batch, head) at N 5330, hd 64, against 2·4·N·hd bytes of
// q/k/v/o: tensor-core issue, and beside it the softmax's exp2 on the
// special-function units, which at hd 64 take about as many cycles per
// key tile as the two products. The bf16 design (flash_attn_wgmma_kernel):
//   * one producer warp issues TMA loads of 64-key K and V tiles into a
//     two-stage ring of mbarrier-guarded shared memory, through 4-D tensor
//     maps over the strided views (dims hd, N, H, B; keys >= N load as
//     zeros and are masked to -inf); the tile rows are swizzled by
//     min(2 hd, 128) bytes, hd 128 as two 64-column panels, hd 80 as five
//     16-column panels swizzled by 32 bytes;
//   * consumer warpgroups of 64 query rows each hold Q in registers as
//     wgmma A fragments (pre-scaled and rounded to bf16 where prescale_q
//     says so) and run S = Q K^T (wgmma, B = the K tile, K-major), the
//     online softmax in registers with log2(e) folded into the scale and
//     ex2.approx, then O += P V (wgmma, A = P rounded to bf16 in
//     registers, B = the V tile read MN-major through wgmma's transpose
//     bit: no transpose of V is ever stored);
//   * query rows per block, fixed per head dim at compile time: 64 (one
//     consumer; 160 threads, 124 registers at hd 64, 33 KB of shared
//     memory, three blocks per SM) up to hd 64, 128 (two consumers; 288
//     threads, one block per SM) at hd 128, where one consumer would
//     spill (nvcc -Xptxas -v). No setmaxnreg: the producer is one warp.
//     On one H100 80GB HBM3 at 700 W, DINOv2-G heads, 64 / 128 rows per
//     block at hd 64 took 0.098 / 0.147 ms at B 32, N 257 (where 128-row
//     tiles cover 384 rows for 257), 0.188 / 0.246 at B 32, N 485 and
//     0.487 / 0.555 at B 1, N 5330 (SDPA: 0.099, 0.155, 0.441); with a
//     producer warpgroup (two blocks of one consumer per SM) 64 rows took
//     0.115 / 0.239 / 0.544; a variant that issued the next tile's scores
//     before the current PV product, to overlap the softmax with it, took
//     0.657 ms at N 5330; none of these was kept (PERF.md).
// The f32 design (flash_attn_tf32x3_kernel), the route of every f32 model
// (CLIP-L/14@336px, dvgl ViT-B/16 in eval and training, ImageBind-H's f32
// towers, tensor-parallel training through K2): the same ring and online
// softmax (the first consumer thread issues the loads), each product as
// three tf32 wgmmas of the split
// x = hi + lo (hopper.cuh; lo·hi + hi·lo + hi·hi, f32-accurate, at a
// third of the 495 TFLOP/s dense tf32 rate). tf32 wgmma has no transpose
// bit, so V's tile cannot be read MN-major: a split warpgroup writes each
// landed stage's K lo (K's hi in place) and V^T's hi and lo; Q's hi and
// lo sit in shared memory (A from shared memory: in registers they would
// cost HD registers a thread), P is split in registers. 32-key tiles, two
// consumers (one at hd 128), 3 stages up to hd 64 and 2 above: at most
// 224 KB of shared memory, one block per SM. Each key tile's P V sums in
// an accumulator of its own before it joins O (F27: wgmma's sums round
// toward zero by a share of the accumulator). Every head dim the wrappers
// take (16, 32, 64, 80, 128) runs it; there is no other f32 kernel.
// Under autograd (K2's FlashAttentionGrad, K5's QkvProjGrad) both kernels
// also write each query row's log-sum-exp of the scaled scores (natural
// log, [B, H, N] f32) through AttnArgs::lse, which the backward
// (flash_attention_bwd.cuh) recomputes P from; K4, K6, K7, K9 and T3 leave
// it null, and the output's stores are the same either way.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

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
  // [B, H, N] f32: each row's log-sum-exp of the scaled scores, or null
  float* lse = nullptr;
};

namespace {

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffff, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffff, x, 1);
  return x + __shfl_xor_sync(0xffffffff, x, 2);
}

__device__ __forceinline__ float exp2_approx(float x) {  // exp2(-inf) = +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two neighbouring output columns
__device__ __forceinline__ void store2(bf16* o, float a, float b) {
  *reinterpret_cast<uint32_t*>(o) = pack_bf16(a, b);
}
__device__ __forceinline__ void store2(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}

// The K / V tiles of head dim HD, and the block: NWG consumer warpgroups
// (one, compiled for three blocks per SM, or two at hd 128, where one
// would spill), then the producer warp.
// A tile row is split into panels of SW bytes, the largest TMA swizzle
// (128, 64 or 32 bytes) that divides the row's 2·HD bytes: one panel up to
// hd 64, two 128-byte panels at hd 128, five 32-byte panels at hd 80 (its
// 160-byte row does not split into 64-column panels). At hd 80 the
// products take 5 k16 steps (QK^T) and N = 80 (PV); two blocks per SM,
// not three, so that the wider accumulator does not spill.
template <int HD>
struct FaTile {
  static constexpr int NWG = HD == 128 ? 2 : 1;
  static constexpr int THREADS = 128 * NWG + 32;
  static constexpr int BLOCKS_PER_SM = NWG == 2 ? 1 : (HD == 80 ? 2 : 3);
  static constexpr int SW = (HD * 2) % 128 == 0 ? 128 : ((HD * 2) % 64 == 0 ? 64 : 32);
  static constexpr int BOX = SW / 2;                       // head-dim columns per TMA box
  static constexpr int PANELS = HD / BOX;                  // 1; 2 at hd 128; 5 at hd 80
  static constexpr int BK = 64;                            // keys per tile
  static constexpr int TILE = BK * HD * 2;                 // bytes of one K or V tile
  static constexpr int STAGES = 2;
  static constexpr int SMEM = STAGES * 2 * TILE + 2 * STAGES * 8 + 1024;  // + barriers, alignment
};

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Row r's log-sum-exp of the scaled scores from the running max m (log2
// domain) and the row's denominator l: (m + log2 l) · ln 2, natural log.
__device__ __forceinline__ void store_lse(const AttnArgs& p, int b, int h, int r, float m,
                                          float l) {
  if (r < p.N) p.lse[(long long)(b * p.H + h) * p.N + r] = (m + log2f(l)) * LN2;
}

// bf16 operands: wgmma products with f32 sums, P rounded to bf16 before
// PV; the output in bf16, or in f32 with O_F32; with LSE (under autograd)
// each row's log-sum-exp too, an instance of its own (a runtime branch on
// p.lse cost K5's attention ~1.6 % on the H100). Warpgroups 0..NWG-1 are
// the consumers, the last warp the producer.
template <int HD, bool O_F32, bool LSE>
__global__ void __launch_bounds__(FaTile<HD>::THREADS, FaTile<HD>::BLOCKS_PER_SM)
    flash_attn_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap, AttnArgs p, int n_qt) {
  using T = FaTile<HD>;
  constexpr int NWG = T::NWG;
  using OutT = std::conditional_t<O_F32, float, bf16>;
  extern __shared__ uint8_t fa_smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(fa_smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::STAGES * 2 * T::TILE);
  uint64_t* empty = full + T::STAGES;

  const int qt = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int b = bh / p.H, h = bh % p.H;
  const int N = p.N;
  const int nk = cdiv(N, T::BK);
  const int wg = threadIdx.x / 128;  // NWG: the producer warp

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NWG);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NWG) {  // ---------------------------------------- producer
    if (threadIdx.x == 128 * NWG) {
      tma_prefetch_map(&kmap);
      tma_prefetch_map(&vmap);
      for (int j = 0; j < nk; ++j) {
        const int s = j % T::STAGES;
        if (j >= T::STAGES) mbar_wait(&empty[s], (j / T::STAGES - 1) & 1);
        uint8_t* kt = smem + s * 2 * T::TILE;
        uint8_t* vt = kt + T::TILE;
        mbar_arrive_expect_tx(&full[s], 2 * T::TILE);
#pragma unroll
        for (int pn = 0; pn < T::PANELS; ++pn) {
          tma_load_4d(kt + pn * T::BK * T::SW, &kmap, &full[s], pn * T::BOX, j * T::BK, h, b);
          tma_load_4d(vt + pn * T::BK * T::SW, &vmap, &full[s], pn * T::BOX, j * T::BK, h, b);
        }
      }
    }
    return;
  }
  // ------------------------------------------------------------ consumers
  const int tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (qt * NWG + wg) * 64 + warp * 16 + g;
  const int r1 = r0 + 8;

  const bf16* Q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  OutT* O = static_cast<OutT*>(p.o) + b * p.o_sb + h * p.o_sh;

  // this warp's 16 query rows as A fragments (k16 steps along hd)
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
  // exp(x) = exp2(x * log2 e): scores go to the log2 domain in one multiply
  const float c = p.prescale_q ? LOG2E : p.scale * LOG2E;

  float m0 = -INFINITY, m1 = -INFINITY;
  float l0 = 0.f, l1 = 0.f;
  float o[HD / 2], s[T::BK / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < T::BK / 2; ++i) s[i] = 0.f;

  for (int j = 0; j < nk; ++j) {
    const int st = j % T::STAGES;
    mbar_wait(&full[st], (j / T::STAGES) & 1);
    const uint8_t* kt = smem + st * 2 * T::TILE;
    const uint8_t* vt = kt + T::TILE;

    // S = Q K^T: 64 rows x BK keys for this warpgroup
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int off = kk * 32;  // bytes along hd
      const uint8_t* kp = kt + (off / T::SW) * (T::BK * T::SW) + off % T::SW;
      wgmma_bf16_rs<0>(s, qa[kk], smem_desc<T::SW>(kp, 16, 8 * T::SW), kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    const bool tail = (j + 1) * T::BK > N;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < T::BK / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * jj + e] * c;
        if (tail && j * T::BK + jj * 8 + t * 2 + (e & 1) >= N) x = -INFINITY;
        s[4 * jj + e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[4 * jj], s[4 * jj + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
    }
    // key 0 is valid in the first tile, so the running max is finite
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = exp2_approx(m0 - mn0);
    const float al1 = exp2_approx(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int jj = 0; jj < T::BK / 8; ++jj) {
      s[4 * jj] = exp2_approx(s[4 * jj] - mn0);
      s[4 * jj + 1] = exp2_approx(s[4 * jj + 1] - mn0);
      s[4 * jj + 2] = exp2_approx(s[4 * jj + 2] - mn1);
      s[4 * jj + 3] = exp2_approx(s[4 * jj + 3] - mn1);
      ls0 += s[4 * jj] + s[4 * jj + 1];
      ls1 += s[4 * jj + 2] + s[4 * jj + 3];
    }
    l0 = l0 * al0 + ls0;  // per-thread partial; quad-summed at the end
    l1 = l1 * al1 + ls1;
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj) {
      o[4 * jj] *= al0;
      o[4 * jj + 1] *= al0;
      o[4 * jj + 2] *= al1;
      o[4 * jj + 3] *= al1;
    }
    // O += P V with P rounded to bf16 (v's dtype), as the TPU kernel does;
    // the S accumulator of key n-tiles 2kt, 2kt + 1 is the A fragment of
    // P's k16 step kt
    uint32_t pa[T::BK / 16][4];
#pragma unroll
    for (int kt2 = 0; kt2 < T::BK / 16; ++kt2) {
      pa[kt2][0] = pack_bf16(s[8 * kt2], s[8 * kt2 + 1]);
      pa[kt2][1] = pack_bf16(s[8 * kt2 + 2], s[8 * kt2 + 3]);
      pa[kt2][2] = pack_bf16(s[8 * kt2 + 4], s[8 * kt2 + 5]);
      pa[kt2][3] = pack_bf16(s[8 * kt2 + 6], s[8 * kt2 + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int kt2 = 0; kt2 < T::BK / 16; ++kt2)
      wgmma_bf16_rs<1>(o, pa[kt2],
                       smem_desc<T::SW>(vt + kt2 * 16 * T::SW, T::BK * T::SW, 8 * T::SW), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int kt2 = 0; kt2 < T::BK / 16; ++kt2) fence_regs(pa[kt2]);  // P lives until the wait
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the stage
  }

  const float d0 = quad_sum(l0);
  const float d1 = quad_sum(l1);
#pragma unroll
  for (int jj = 0; jj < HD / 8; ++jj) {
    const int col = jj * 8 + t * 2;
    if (r0 < N) store2(O + r0 * p.o_sn + col, o[4 * jj] / d0, o[4 * jj + 1] / d0);
    if (r1 < N) store2(O + r1 * p.o_sn + col, o[4 * jj + 2] / d1, o[4 * jj + 3] / d1);
  }
  if (LSE && t == 0) {
    store_lse(p, b, h, r0, m0, d0);
    store_lse(p, b, h, r1, m1, d1);
  }
}

// The f32 kernel's tiles at head dim HD: NWG consumer warpgroups of 64
// query rows (two; one at hd 128, whose Q, stages and accumulators would
// not fit twice), then the split warpgroup; the first consumer thread
// issues the TMA loads. Keys go in tiles of BK = 32. Shared
// memory: Q's hi and lo per consumer (64 rows x HD, K-major, panels of SW
// bytes as the K tiles), then STAGES stages of five tiles of BK x HD f32:
// K as TMA lands it (swizzled panels as the bf16 kernel's, rounded to its
// tf32 hi in place), K's lo, V as TMA lands it (rows of HD, no swizzle;
// then V^T's rest in its place), and V^T's hi and lo ([HD rows x BK keys],
// one 128-byte swizzled panel: tf32 wgmma has no transpose bit, so PV's B
// operand must be K-major, keys along the rows).
template <int HD>
struct Fa32Tile {
  static constexpr int NWG = HD == 128 ? 1 : 2;
  static constexpr int THREADS = 128 * NWG + 128;
  static constexpr int SPLITTERS = 128;  // the split warpgroup
  // Two consumers: setmaxnreg moves the launch's 168 registers a thread
  // (65,536 over 384 threads) from the split warpgroup to the consumers,
  // whose O and each key tile's P V, in accumulators of their own, need
  // them; one consumer has 255 at launch. On the H100 at [8, 16, 1370, 80]
  // a producer's warpgroup of its own (512 threads, 128 registers at
  // launch) spilled and took 2.5 % longer, and the split on three warps
  // beside a producer warp 5 % longer than that.
  static constexpr int REGS_CONSUMER = 200, REGS_SPLIT = 104;
  static_assert(NWG == 1 || 2 * REGS_CONSUMER + REGS_SPLIT <= 3 * 168,
                "setmaxnreg moves the launch's registers, no more");
  static constexpr int SW = (HD * 4) % 128 == 0 ? 128 : 64;  // hd 16, 80: 64-byte panels
  static constexpr int BOX = SW / 4;                          // head-dim columns per panel
  static constexpr int PANELS = HD / BOX;
  static constexpr int BK = 32;
  static constexpr int TILE = BK * HD * 4;  // one tile's bytes; V^T's rows are BK * 4 = 128
  static constexpr int STAGES = HD <= 64 ? 3 : 2;
  static constexpr int STAGE = 5 * TILE;
  static constexpr int QBYTES = 64 * HD * 4;
  static constexpr int SMEM = STAGES * STAGE + NWG * 2 * QBYTES + 3 * STAGES * 8 + 1024;
};

// f32 operands (every f32 model: CLIP-L/14@336px, dvgl ViT-B/16, the f32
// towers of ImageBind-H): the bf16 kernel's dataflow with each product as
// three tf32 wgmmas of the split x = hi + lo (hopper.cuh's tf32_split,
// hi rounded): S = Q K^T from Q's and K's hi and lo in shared memory, P
// split in registers for P V^T, V in three pieces (four products: P V is
// then exact where P is exact, as at one key, where O = V). The split
// warpgroup writes each stage's K lo, rounds K in place and writes V^T,
// then arrives on `ready`; the consumers free a stage on `empty` once its
// products are done.
// wgmma's f32 sums are not rounded to nearest: each product added to an
// accumulator errs by a share of the accumulator's own size, always
// toward zero. Added into one running O, every key tile's sixteen P V
// products erred by a share of O, and the error grew with N (F27: 1.2-1.8e-5
// of max|out| at N 1370, 8-10x the plain version's). So each tile's P V
// goes into an accumulator of its own (scale-d 0 on its first product) and
// joins O in registers, O = O · alpha + PV, one rounded FMA a tile; S
// sums its hi·hi products in one accumulator and lo·hi + hi·lo in another,
// added once a tile (as K5's projection backward, attn_qkv_proj_bwd.cu).
// P's A fragment takes key 2t of each 8-key step as its column t and key
// 2t + 1 as column t + 4 (the S accumulator holds keys 2t, 2t + 1 of each
// 8), so V^T stores each 8 keys of a step in the order 0 2 4 6 1 3 5 7.
// Scores in f32 with f32 sums (~f32 FMA's error), P in f32, O in f32.
template <int HD>
__global__ void __launch_bounds__(Fa32Tile<HD>::THREADS, 1)
    flash_attn_tf32x3_kernel(const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap, AttnArgs p, int n_qt) {
  using T = Fa32Tile<HD>;
  constexpr int NWG = T::NWG;
  constexpr int BK = T::BK;
  extern __shared__ uint8_t fa_smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(fa_smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem + T::STAGES * T::STAGE;  // consumer w: hi at w * 2 QBYTES, lo QBYTES on
  uint64_t* full = reinterpret_cast<uint64_t*>(qs + NWG * 2 * T::QBYTES);
  uint64_t* ready = full + T::STAGES;
  uint64_t* empty = ready + T::STAGES;

  const int qt = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int b = bh / p.H, h = bh % p.H;
  const int N = p.N;
  const int nk = cdiv(N, BK);
  const int wg = threadIdx.x / 128;  // NWG: the split warpgroup

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], T::SPLITTERS);  // every split thread
      mbar_init(&empty[s], 4 * NWG);       // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // key tile j's K and V into its stage, by TMA (the first consumer thread)
  auto load = [&](int j) {
    const int s = j % T::STAGES;
    uint8_t* kt = smem + s * T::STAGE;
    mbar_arrive_expect_tx(&full[s], 2 * T::TILE);
#pragma unroll
    for (int pn = 0; pn < T::PANELS; ++pn)
      tma_load_4d(kt + pn * BK * T::SW, &kmap, &full[s], pn * T::BOX, j * BK, h, b);
    tma_load_4d(kt + 2 * T::TILE, &vmap, &full[s], 0, j * BK, h, b);
  };
  if (wg == NWG) {  // ---------------------------------------- split
    if constexpr (NWG == 2) regs_shrink<T::REGS_SPLIT>();
    const int st = threadIdx.x - 128 * NWG;
    constexpr int ITEMS = BK / 4 * HD;  // uint4 items of V^T
    constexpr int PER = (ITEMS + T::SPLITTERS - 1) / T::SPLITTERS;
    for (int j = 0; j < nk; ++j) {
      const int s = j % T::STAGES;
      mbar_wait(&full[s], (j / T::STAGES) & 1);
      uint8_t* kt = smem + s * T::STAGE;
      for (int i = st; i < T::TILE / 16; i += T::SPLITTERS) {  // K: hi in place, lo a tile on
        uint4* x = reinterpret_cast<uint4*>(kt + 16 * i);
        const float4 v = *reinterpret_cast<const float4*>(x);
        uint4 hi, lo;
        tf32_split(v.x, hi.x, lo.x);
        tf32_split(v.y, hi.y, lo.y);
        tf32_split(v.z, hi.z, lo.z);
        tf32_split(v.w, hi.w, lo.w);
        *x = hi;
        *reinterpret_cast<uint4*>(kt + T::TILE + 16 * i) = lo;
      }
      // V^T in three tf32 pieces, hi, lo and the rest (2 bits), so that P V
      // is exact where P is (one key: O = V): item (c, d) is head-dim row
      // d, key slots 4c..4c+3 of V^T's row, keys 8(c / 2) + c % 2 +
      // {0, 2, 4, 6} of the tile; the rest overwrites V's tile once every
      // split thread has read it
      const float* vr = reinterpret_cast<const float*>(kt + 2 * T::TILE);
      uint4 rest[PER];
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        const int i = st + T::SPLITTERS * m;
        if (i >= ITEMS) break;
        const int d = i % HD, c = i / HD;
        const int k0 = 8 * (c >> 1) + (c & 1);
        uint4 hi, lo;
        tf32_split3(vr[(k0 + 0) * HD + d], hi.x, lo.x, rest[m].x);
        tf32_split3(vr[(k0 + 2) * HD + d], hi.y, lo.y, rest[m].y);
        tf32_split3(vr[(k0 + 4) * HD + d], hi.z, lo.z, rest[m].z);
        tf32_split3(vr[(k0 + 6) * HD + d], hi.w, lo.w, rest[m].w);
        const int off = swizzle<128>(d * 128 + c * 16);
        *reinterpret_cast<uint4*>(kt + 3 * T::TILE + off) = hi;
        *reinterpret_cast<uint4*>(kt + 4 * T::TILE + off) = lo;
      }
      bar_sync(15, T::SPLITTERS);  // V's tile is read
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        const int i = st + T::SPLITTERS * m;
        if (i >= ITEMS) break;
        const int d = i % HD, c = i / HD;
        *reinterpret_cast<uint4*>(kt + 2 * T::TILE + swizzle<128>(d * 128 + c * 16)) = rest[m];
      }
      fence_proxy_async();  // the writes, visible to the consumers' wgmma
      mbar_arrive(&ready[s]);
    }
    return;
  }
  // ------------------------------------------------------------ consumers
  if constexpr (NWG == 2) regs_grow<T::REGS_CONSUMER>();
  const int tid = threadIdx.x % 128;
  const bool issuer = threadIdx.x == 0;  // loads each stage once every consumer warp freed it
  if (issuer) {
    tma_prefetch_map(&kmap);
    tma_prefetch_map(&vmap);
    for (int j = 0; j < nk && j < T::STAGES; ++j) load(j);
  }
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (qt * NWG + wg) * 64;
  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;

  const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  float* O = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  // Q's 64 rows of this warpgroup, split into hi and lo, K-major panels
  uint8_t* qh = qs + wg * 2 * T::QBYTES;
  for (int i = tid; i < 64 * HD / 4; i += 128) {
    const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < N) {
      v = *reinterpret_cast<const float4*>(Q + (q0 + r) * p.q_sn + c);
      if (p.prescale_q) {  // q * scale in f32, rounded to f32 (the input dtype)
        v.x = __fmul_rn(v.x, p.scale);
        v.y = __fmul_rn(v.y, p.scale);
        v.z = __fmul_rn(v.z, p.scale);
        v.w = __fmul_rn(v.w, p.scale);
      }
    }
    uint4 hi, lo;
    tf32_split(v.x, hi.x, lo.x);
    tf32_split(v.y, hi.y, lo.y);
    tf32_split(v.z, hi.z, lo.z);
    tf32_split(v.w, hi.w, lo.w);
    const int off = (c / T::BOX) * (64 * T::SW) + swizzle<T::SW>(r * T::SW + (c % T::BOX) * 4);
    *reinterpret_cast<uint4*>(qh + off) = hi;
    *reinterpret_cast<uint4*>(qh + T::QBYTES + off) = lo;
  }
  fence_proxy_async();
  bar_sync(1 + wg, 128);

  const float c = p.prescale_q ? LOG2E : p.scale * LOG2E;
  constexpr uint32_t QLO = T::QBYTES >> 4, TLO = T::TILE >> 4;  // descriptor steps hi -> lo

  float m0 = -INFINITY, m1 = -INFINITY;
  float l0 = 0.f, l1 = 0.f;
  float o[HD / 2], pv[HD / 2], s[BK / 2], se[BK / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = pv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = se[i] = 0.f;

  for (int j = 0; j < nk; ++j) {
    const int st = j % T::STAGES;
    mbar_wait(&ready[st], (j / T::STAGES) & 1);
    const uint8_t* kt = smem + st * T::STAGE;
    const uint8_t* vt = kt + 3 * T::TILE;

    // S = Q K^T: 64 rows x BK keys, HD / 8 k8 steps of three products
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      const int off = kk * 32;  // bytes along hd
      const uint64_t dq =
          smem_desc<T::SW>(qh + (off / T::SW) * (64 * T::SW) + off % T::SW, 16, 8 * T::SW);
      const uint64_t dk =
          smem_desc<T::SW>(kt + (off / T::SW) * (BK * T::SW) + off % T::SW, 16, 8 * T::SW);
      wgmma_tf32_ss(se, dq + QLO, dk, kk);  // 0: the tile's first product
      wgmma_tf32_ss(se, dq, dk + TLO, 1);
      wgmma_tf32_ss(s, dq, dk, kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(se);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = __fadd_rn(s[i], se[i]);

    const bool tail = (j + 1) * BK > N;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * jj + e] * c;
        if (tail && j * BK + jj * 8 + t * 2 + (e & 1) >= N) x = -INFINITY;
        s[4 * jj + e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[4 * jj], s[4 * jj + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
    }
    // key 0 is valid in the first tile, so the running max is finite
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = exp2_approx(m0 - mn0);
    const float al1 = exp2_approx(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
      s[4 * jj] = exp2_approx(s[4 * jj] - mn0);
      s[4 * jj + 1] = exp2_approx(s[4 * jj + 1] - mn0);
      s[4 * jj + 2] = exp2_approx(s[4 * jj + 2] - mn1);
      s[4 * jj + 3] = exp2_approx(s[4 * jj + 3] - mn1);
      ls0 += s[4 * jj] + s[4 * jj + 1];
      ls1 += s[4 * jj + 2] + s[4 * jj + 3];
    }
    l0 = l0 * al0 + ls0;  // per-thread partial; quad-summed at the end
    l1 = l1 * al1 + ls1;
    // this tile's P V, with P in f32 (v's dtype), split; step kt2's A
    // fragment is (row g key 2t, row g + 8 key 2t, row g key 2t + 1, row
    // g + 8 key 2t + 1)
    uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
    for (int kt2 = 0; kt2 < BK / 8; ++kt2) {
      tf32_split(s[4 * kt2], ph[kt2][0], pl[kt2][0]);
      tf32_split(s[4 * kt2 + 2], ph[kt2][1], pl[kt2][1]);
      tf32_split(s[4 * kt2 + 1], ph[kt2][2], pl[kt2][2]);
      tf32_split(s[4 * kt2 + 3], ph[kt2][3], pl[kt2][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kt2 = 0; kt2 < BK / 8; ++kt2) {
      const uint64_t dv = smem_desc<128>(vt + kt2 * 32, 16, 1024);  // V^T's hi
      wgmma_tf32_rs(pv, pl[kt2], dv, kt2);     // 0: the tile's first product, PV = P V
      wgmma_tf32_rs(pv, ph[kt2], dv - TLO, 1);  // V^T's rest, a tile before
      wgmma_tf32_rs(pv, ph[kt2], dv + TLO, 1);  // V^T's lo
      wgmma_tf32_rs(pv, ph[kt2], dv, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(pv);
#pragma unroll
    for (int kt2 = 0; kt2 < BK / 8; ++kt2) {  // P lives until the wait
      fence_regs(ph[kt2]);
      fence_regs(pl[kt2]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the stage
    if (issuer && j + T::STAGES < nk) {
      mbar_wait(&empty[st], (j / T::STAGES) & 1);
      load(j + T::STAGES);
    }
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj) {  // O = O · alpha + PV, rounded once
      o[4 * jj] = fmaf(o[4 * jj], al0, pv[4 * jj]);
      o[4 * jj + 1] = fmaf(o[4 * jj + 1], al0, pv[4 * jj + 1]);
      o[4 * jj + 2] = fmaf(o[4 * jj + 2], al1, pv[4 * jj + 2]);
      o[4 * jj + 3] = fmaf(o[4 * jj + 3], al1, pv[4 * jj + 3]);
    }
  }

  const float d0 = quad_sum(l0);
  const float d1 = quad_sum(l1);
#pragma unroll
  for (int jj = 0; jj < HD / 8; ++jj) {
    const int col = jj * 8 + t * 2;
    if (r0 < N) store2(O + r0 * p.o_sn + col, o[4 * jj] / d0, o[4 * jj + 1] / d0);
    if (r1 < N) store2(O + r1 * p.o_sn + col, o[4 * jj + 2] / d1, o[4 * jj + 3] / d1);
  }
  if (p.lse != nullptr && t == 0) {
    store_lse(p, b, h, r0, m0, d0);
    store_lse(p, b, h, r1, m1, d1);
  }
}

// The 4-D map (hd, N, H, B) of one operand of `esz` bytes, boxes of `box`
// head-dim columns by `rows` tokens swizzled by `sw` bytes (0: none); a
// dimension of extent 1 may carry any stride (the wrappers do not check
// it), so it gets one that TMA takes (a multiple of 16 bytes). The other
// strides are whole 16 bytes: the wrappers take strides of whole 8
// elements, and K5's qkv rows of 3D with D a multiple of 16.
template <int HD>
cudaError_t attention_map(CUtensorMap* map, const void* base, const AttnArgs& p, long long sb,
                          long long sh, long long sn, CUtensorMapDataType type, int esz,
                          int box, int rows, int sw) {
  const cuuint64_t bn = p.N == 1 ? HD * esz : sn * esz;
  const cuuint64_t bhs = p.H == 1 ? bn * p.N : sh * esz;
  const cuuint64_t bbs = p.B == 1 ? bhs * p.H : sb * esz;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)p.N, (cuuint64_t)p.H, (cuuint64_t)p.B};
  const cuuint64_t strides[3] = {bn, bhs, bbs};
  const cuuint32_t boxd[4] = {(cuuint32_t)box, (cuuint32_t)rows, 1, 1};
  return make_tma_map(map, type, 4, base, dims, strides, boxd, sw);
}

template <int HD, bool O_F32>
cudaError_t launch_attention_wgmma(const AttnArgs& p, cudaStream_t st) {
  using T = FaTile<HD>;
  constexpr auto BF = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap kmap, vmap;
  cudaError_t e = attention_map<HD>(&kmap, p.k, p, p.k_sb, p.k_sh, p.k_sn, BF, 2, T::BOX, T::BK,
                                    T::SW);
  if (e == cudaSuccess)
    e = attention_map<HD>(&vmap, p.v, p, p.v_sb, p.v_sh, p.v_sn, BF, 2, T::BOX, T::BK, T::SW);
  if (e != cudaSuccess) return e;
  auto kernel = p.lse != nullptr ? flash_attn_wgmma_kernel<HD, O_F32, true>
                                 : flash_attn_wgmma_kernel<HD, O_F32, false>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return e;
  const int n_qt = cdiv(p.N, 64 * T::NWG);
  kernel<<<p.B * p.H * n_qt, T::THREADS, T::SMEM, st>>>(kmap, vmap, p, n_qt);
  return cudaGetLastError();
}

// f32 operands: K in swizzled panels as the bf16 kernel's, V in plain rows
// of HD (the split warpgroup reads it by columns)
template <int HD>
cudaError_t launch_attention_tf32x3(const AttnArgs& p, cudaStream_t st) {
  using T = Fa32Tile<HD>;
  constexpr auto F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap kmap, vmap;
  cudaError_t e = attention_map<HD>(&kmap, p.k, p, p.k_sb, p.k_sh, p.k_sn, F32, 4, T::BOX, T::BK,
                                    T::SW);
  if (e == cudaSuccess)
    e = attention_map<HD>(&vmap, p.v, p, p.v_sb, p.v_sh, p.v_sn, F32, 4, HD, T::BK, 0);
  if (e != cudaSuccess) return e;
  auto kernel = flash_attn_tf32x3_kernel<HD>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return e;
  const int n_qt = cdiv(p.N, 64 * T::NWG);
  kernel<<<p.B * p.H * n_qt, T::THREADS, T::SMEM, st>>>(kmap, vmap, p, n_qt);
  return cudaGetLastError();
}

template <int HD, bool O_F32>
cudaError_t launch_attention_hd(const AttnArgs& p, int dtype, cudaStream_t st) {
  if (dtype == DT_F32) return launch_attention_tf32x3<HD>(p, st);
  if (dtype != DT_BF16) return cudaErrorInvalidValue;
  return launch_attention_wgmma<HD, O_F32>(p, st);
}

}  // namespace

// Launch attention over head dims 16, 32, 64, 80 or 128 (the wrappers
// refuse others before they get here); O_F32: bf16 operands write f32.
template <bool O_F32 = false>
static inline cudaError_t launch_attention(const AttnArgs& p, int dtype, int hd,
                                           cudaStream_t st) {
  if (p.B * p.H == 0 || p.N == 0) return cudaSuccess;
  switch (hd) {
    case 16: return launch_attention_hd<16, O_F32>(p, dtype, st);
    case 32: return launch_attention_hd<32, O_F32>(p, dtype, st);
    case 64: return launch_attention_hd<64, O_F32>(p, dtype, st);
    case 80: return launch_attention_hd<80, O_F32>(p, dtype, st);
    case 128: return launch_attention_hd<128, O_F32>(p, dtype, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace anyloc
