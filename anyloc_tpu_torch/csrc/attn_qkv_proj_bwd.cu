// K5's projection backward: the gradients of out = (o·W + b)·γ + residual
// (f32, rounded once to qkv's dtype; attn_qkv_proj.cu) for the output
// gradient G [M, Nc], M = B·N rows, Nc = d_out:
//   d_residual = G (the wrapper returns G itself);
//   G' = G ∘ γ (G without LayerScale), f32 (__fmul_rn, the plain version's
//   value);
//   d_b = Σ_rows G', d_γ = Σ_rows G ∘ pre, with pre = o·W + b saved by the
//   forward's epilogue under autograd, summed in f32;
//   d_o = G'·W^T [M, D], rounded once to qkv's dtype (the plain version
//   rounds it there: the backward of the heads' outputs' cast);
//   d_W = o^T·G' [D, Nc], rounded once to W's dtype.
// d_o then feeds the attention backward (flash_attention_bwd.cu) as dO.
//
// Replaces no TPU kernel: the Pallas K5 (anyloc_tpu/ops/pallas/attn_proj.py
// :327) has no backward (F19), and its gradient is the XLA route's; its
// projection GEMMs are part of that kernel's body, so here they are a
// hand-written Hopper kernel, never cuBLAS.
//
// What bounds it on the H100: two products of 2·M·D·Nc operations each
// (22.3 GFLOP together at qkv [48, 197, 2304]: M 9456, D = Nc = 768) as
// three tf32 products each (3xTF32, f32-accurate), 0.135 ms at 494.7
// TFLOP/s, against ~92 MB that the function must move (G, o, d_o once; W,
// d_W), 0.027 ms: tensor-core issue, with no scratch round trip of G, o^T
// or G'^T through device memory, no wave tail between products and no
// epilogue that loads cannot overlap. The design:
//   * proj_bwd_kernel: one persistent block per SM over a static list of
//     work units (proj_bwd_plan.cuh): d_W's (tile, row chunk) units, chunks
//     of about a d_o tile's stages, then d_o's 128 x 128 tiles, then the
//     reduction units that add d_W's chunks; block b takes units b,
//     b + grid, ...;
//   * operands read where they lie: one producer thread lands two boxes a
//     stage by TMA (no swizzle, rows as they lie) into three landing stages
//     of 32 KB: d_o's G [128 rows x 32 columns] and W [128 x 32] (both
//     K-major for G'·W^T); d_W's o [32 rows x 128 columns] and G [32 x 128];
//   * two consumer warpgroups of 64 rows run m64n128k8 tf32 wgmmas, three a
//     K step (bf16_gemm.cuh's OpTF32x3: lo·hi + hi·lo into their own sums
//     over the unit, hi·hi into sums that start afresh every PbTile::FOLD
//     stages and join the unit's f32 sums by __fadd_rn: wgmma's adds err
//     toward zero by a share of the accumulator, F29, and a d_o unit
//     reduces over all of Nc), from two split stages of 64 KB (A hi, B hi,
//     A lo, B lo, K-major and 128-byte swizzled); while a stage's wgmmas
//     run, the same 256 threads split the block's next stage (the next
//     unit's first at a unit's end) from its landing stage into the other
//     split stage: hopper.cuh's tf32_split, γ applied to G's columns first (__fmul_rn),
//     and for d_W o^T and G'^T written transposed (tf32 wgmma has no
//     transpose bit, and d_W reduces over the rows, where o and G are
//     MN-major). bf16 data is exact in tf32 (its lo is 0) and takes the
//     same path. 230,448 bytes of shared memory, one block per SM;
//   * d_W's chunks: with more than one, each unit writes its f32 partial
//     product to a workspace [chunks, D, Nc] and counts its tile's arrivals
//     (an integer atomic); the tile's four reduction units, last in the
//     order, wait for the count and add chunks 0..chunks - 1 in order, in
//     W's dtype. No float atomics and a fixed order: two calls are
//     bit-equal. Every unit a reduction waits for comes earlier in every
//     block's order, so the wait always ends (grid <= SMs, all resident);
//   * d_b and d_γ: proj_bwd_colsum_kernel, one small launch before it that
//     reads G (and pre) once, each (32 columns, row split) block's sums
//     added in order by the last block of its columns.
// Scratch at qkv [48, 197, 2304]: 13 chunks of 736 rows, 30.8 MB (the
// partials, 22 x 768 column-sum partials, counters). On one H100 at 700 W
// it reaches ~39 % of the bound (PERF.md): the split and the products
// share the consumers' issue slots and shared memory, and each alone takes
// most of the kernel's time.
#include "bf16_gemm.cuh"
#include "proj_bwd_plan.cuh"

namespace anyloc {
namespace {

// Shared memory: two split stages (A hi, B hi, A lo, B lo: 128 x 32 f32
// each, K-major, 128-byte swizzled, the stage layout OpTF32x3 reads with
// its lo descriptor step of LO bytes), three landing stages (the two boxes
// as TMA writes them) and their full and empty barriers.
struct PbTile {
  static constexpr int SPLIT_STAGES = 2, LAND_STAGES = 3;
  static constexpr int BOX = PB_TILE * PB_K * 4;  // 16 KB: one f32 tile of a stage
  static constexpr int LO = 2 * BOX;              // hi -> lo
  static constexpr int SPLIT = 4 * BOX;
  static constexpr int LAND = 2 * BOX;
  static constexpr int SPLIT_ = 0;
  static constexpr int LAND_ = SPLIT_ + SPLIT_STAGES * SPLIT;
  static constexpr int BAR_ = LAND_ + LAND_STAGES * LAND;
  static constexpr int NBAR = 2 * LAND_STAGES;
  static constexpr int SMEM = BAR_ + NBAR * 8 + 1024;  // + alignment of the base to 1024
  static constexpr int SPLITTERS = 256;           // the consumers' threads
  static constexpr int FOLD = 3;                  // stages of hi·hi between its joins
  static_assert(SMEM <= 232448, "a block's shared memory");
};

struct ProjBwdArgs {
  const float* gamma;  // [Nc] f32 or null
  void* d_o;           // [M, D] in T, or null
  void* dw;            // [D, Nc] in W's dtype, or null
  float* part;         // [chunks, D, Nc] f32 (chunks > 1)
  int* counters;       // [d_tiles · c_tiles] (chunks > 1)
  int M, D, Nc, w_bf16;
  ProjBwdPlan plan;
};

template <typename T>
__device__ __forceinline__ float4 pb_load4(const T* p);
template <>
__device__ __forceinline__ float4 pb_load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 pb_load4<bf16>(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = unpack_bf16(u.x), b = unpack_bf16(u.y);
  return make_float4(a.x, a.y, b.x, b.y);
}

// x's tf32 hi at tile + off and its lo LO bytes on (hopper.cuh's tf32_split)
__device__ __forceinline__ void pb_put4(uint8_t* tile, int off, float4 x) {
  uint4 h, l;
  tf32_split(x.x, h.x, l.x);
  tf32_split(x.y, h.y, l.y);
  tf32_split(x.z, h.z, l.z);
  tf32_split(x.w, h.w, l.w);
  *reinterpret_cast<uint4*>(tile + off) = h;
  *reinterpret_cast<uint4*>(tile + PbTile::LO + off) = l;
}

__device__ __forceinline__ float4 pb_scale4(float4 x, float4 g) {
  return make_float4(__fmul_rn(x.x, g.x), __fmul_rn(x.y, g.y), __fmul_rn(x.z, g.z),
                     __fmul_rn(x.w, g.w));
}

// A d_o stage: G [128 rows x 32 columns k0..] (T) times γ of its columns,
// and W [128 x 32] f32, as they landed (rows of 32), into the split stage.
// Item i: row i / 8, columns 4 (i % 8)..+3.
template <typename T>
__device__ __forceinline__ void split_do(const uint8_t* land, uint8_t* st, const float* gamma,
                                         int k0, int Nc, int tid) {
  const T* a = reinterpret_cast<const T*>(land);
  const float* b = reinterpret_cast<const float*>(land + PbTile::BOX);
#pragma unroll
  for (int j = 0; j < PB_TILE * PB_K / 4 / PbTile::SPLITTERS; ++j) {
    const int i = tid + PbTile::SPLITTERS * j;
    const int r = i >> 3, c = (i & 7) * 4;
    const int off = swizzle<128>(r * 128 + c * 4);
    float4 x = pb_load4(a + r * PB_K + c);
    if (gamma != nullptr && k0 + c < Nc)  // Nc % 8 == 0: the four are in together
      x = pb_scale4(x, __ldg(reinterpret_cast<const float4*>(gamma + k0 + c)));
    pb_put4(st, off, x);
    pb_put4(st + PbTile::BOX, off, pb_load4(b + r * PB_K + c));
  }
}

// A d_W stage: o [32 rows x 128 columns d0..] and G [32 x 128 columns c0..]
// (T, rows of 128 as they landed) into o^T and G'^T, rows d (c), K the 32
// rows of the stage. Item i: column i % 128, rows 4 (i / 128)..+3; a warp
// reads 32 neighbouring columns of a row and writes 32 tile rows.
template <typename T>
__device__ __forceinline__ void split_dw(const uint8_t* land, uint8_t* st, const float* gamma,
                                         int c0, int Nc, int tid) {
  const T* a = reinterpret_cast<const T*>(land);
  const T* b = reinterpret_cast<const T*>(land + PbTile::BOX);
#pragma unroll
  for (int j = 0; j < PB_TILE * PB_K / 4 / PbTile::SPLITTERS; ++j) {
    const int i = tid + PbTile::SPLITTERS * j;
    const int d = i & (PB_TILE - 1), m = (i >> 7) * 4;
    const int off = swizzle<128>(d * 128 + m * 4);
    const float4 x = make_float4(to_float(a[m * PB_TILE + d]), to_float(a[(m + 1) * PB_TILE + d]),
                                 to_float(a[(m + 2) * PB_TILE + d]),
                                 to_float(a[(m + 3) * PB_TILE + d]));
    float4 y = make_float4(to_float(b[m * PB_TILE + d]), to_float(b[(m + 1) * PB_TILE + d]),
                           to_float(b[(m + 2) * PB_TILE + d]), to_float(b[(m + 3) * PB_TILE + d]));
    if (gamma != nullptr && c0 + d < Nc) {
      const float g = __ldg(gamma + c0 + d);
      y = pb_scale4(y, make_float4(g, g, g, g));
    }
    pb_put4(st, off, x);
    pb_put4(st + PbTile::BOX, off, y);
  }
}

// The output columns col, col + 1 of one row from their sums
template <typename OutT>
__device__ __forceinline__ void pb_store(void* out, long long off, float a, float b) {
  store_pair(static_cast<OutT*>(out) + off, from_float<OutT>(a), from_float<OutT>(b));
}

// Four neighbouring outputs in one store (col % 4 == 0, Nc % 8 == 0)
__device__ __forceinline__ void pb_store4(float* out, float4 v) {
  *reinterpret_cast<float4*>(out) = v;
}
__device__ __forceinline__ void pb_store4(bf16* out, float4 v) {
  *reinterpret_cast<uint2*>(out) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

// Wait until *count reaches `want` (another block's atomicAdd); gives up
// with __trap() after ~2^34 cycles, as mbar_wait does
__device__ __forceinline__ void pb_wait_count(const int* count, int want) {
  long long t0 = 0;
  while (*reinterpret_cast<const volatile int*>(count) < want) {
    __nanosleep(64);
    const long long t = clock64();
    if (t0 == 0) t0 = t;
    else if (t - t0 > (1LL << 34)) __trap();
  }
}

// A reduction unit: rows k0..k1 - 1 of d_W tile (ti, tj) as the sum of the
// chunks' partials in chunk order, in W's dtype (WT). Thread i of the 256
// takes columns 4 (i % 32)..+3 of rows i / 32 + 8j.
template <typename WT>
__device__ __forceinline__ void pb_reduce(const ProjBwdArgs& p, const ProjBwdUnit& u) {
  const int D = p.D, Nc = p.Nc, chunks = p.plan.chunks;
  const long long plane = (long long)D * Nc;
  const int col = u.tj * PB_TILE + (threadIdx.x % 32) * 4;
#pragma unroll
  for (int j = 0; j < PB_RED_ROWS / 8; ++j) {
    const int row = u.ti * PB_TILE + u.k0 + threadIdx.x / 32 + 8 * j;
    if (row >= D || col >= Nc) continue;
    const float* src = p.part + (long long)row * Nc + col;
    float4 s = __ldcg(reinterpret_cast<const float4*>(src));
#pragma unroll 4
    for (int z = 1; z < chunks; ++z) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(src + z * plane));
      s = make_float4(__fadd_rn(s.x, v.x), __fadd_rn(s.y, v.y), __fadd_rn(s.z, v.z),
                      __fadd_rn(s.w, v.w));
    }
    pb_store4(static_cast<WT*>(p.dw) + (long long)row * Nc + col, s);
  }
}

// The persistent kernel (PbTile; proj_bwd_plan.cuh's units): warpgroups 0
// and 1 consume (rows 0-63 and 64-127 of a tile) and split, thread 256
// issues the TMA loads. The consumers issue a stage's wgmmas, then, while
// the tensor cores run them, split the block's next stage (the next unit's
// first at a unit's end) into the other split stage, once every wgmma of
// the stage before has read it (named barrier 1 between the two
// warpgroups before and after the split); the landing stage goes back to
// the producer once split. Every role walks the block's units in the same
// order, counting stages for the barriers' phases.
template <typename T>
__global__ void __launch_bounds__(QTHREADS, 1)
    proj_bwd_kernel(const __grid_constant__ CUtensorMap g_rows,  // G, boxes 32 cols x 128 rows
                    const __grid_constant__ CUtensorMap w_rows,  // W f32, 32 cols x 128 rows
                    const __grid_constant__ CUtensorMap o_cols,  // o, 128 cols x 32 rows
                    const __grid_constant__ CUtensorMap g_cols,  // G, 128 cols x 32 rows
                    ProjBwdArgs p) {
  using TL = PbTile;
  constexpr int SS = TL::SPLIT_STAGES, LS = TL::LAND_STAGES;
  extern __shared__ uint8_t pb_smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(pb_smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* lfull = reinterpret_cast<uint64_t*>(sm + TL::BAR_);  // a landing stage landed
  uint64_t* lempty = lfull + LS;                                 // ... and was split
  const ProjBwdPlan& pl = p.plan;
  const int M = p.M, D = p.D, Nc = p.Nc;
  const int n_units = proj_bwd_block_units(pl, blockIdx.x);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < LS; ++s) {
      mbar_init(&lfull[s], 1);
      mbar_init(&lempty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {  // ---------------------------------------- producer
    regs_shrink<40>();
    if (threadIdx.x != 256) return;
    if (pl.n_do > 0) {  // only the maps the host encoded
      tma_prefetch_map(&g_rows);
      tma_prefetch_map(&w_rows);
    }
    if (pl.n_dw > 0) {
      tma_prefetch_map(&o_cols);
      tma_prefetch_map(&g_cols);
    }
    int g = 0;
    for (int i = 0; i < n_units; ++i) {
      const ProjBwdUnit u = proj_bwd_unit(pl, M, Nc, blockIdx.x + i * gridDim.x);
      const int ns = proj_bwd_stages(u);
      for (int ks = 0; ks < ns; ++ks, ++g) {
        const int s = g % LS;
        if (g >= LS) mbar_wait(&lempty[s], (g / LS - 1) & 1);
        uint8_t* land = sm + TL::LAND_ + s * TL::LAND;
        const int k = u.k0 + ks * PB_K;
        if (u.kind == PB_DW) {  // rows k..k + 31 of o (D-tile columns), of G (Nc-tile's)
          mbar_arrive_expect_tx(&lfull[s], 2 * PB_TILE * PB_K * sizeof(T));
          tma_load_2d(land, &o_cols, &lfull[s], u.ti * PB_TILE, k);
          tma_load_2d(land + TL::BOX, &g_cols, &lfull[s], u.tj * PB_TILE, k);
        } else {  // columns k..k + 31 of G (M-tile rows) and of W (D-tile rows)
          mbar_arrive_expect_tx(&lfull[s], PB_TILE * PB_K * (sizeof(T) + 4));
          tma_load_2d(land, &g_rows, &lfull[s], k, u.ti * PB_TILE);
          tma_load_2d(land + TL::BOX, &w_rows, &lfull[s], k, u.tj * PB_TILE);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  regs_grow<232>();
  const int cw = wg;
  const int tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  // the split's cursor: the next stage to split is stage nks of unit ni
  // (nu, nns stages; units without stages skipped), the block's stage gs
  int ni = -1, nks = 0, gs = 0, nns = 0;
  ProjBwdUnit nu = {};
  auto next_unit = [&]() {
    nks = 0;
    nns = 0;
    while (nns == 0 && ++ni < n_units) {
      nu = proj_bwd_unit(pl, M, Nc, blockIdx.x + ni * gridDim.x);
      nns = proj_bwd_stages(nu);
    }
  };
  auto split_next = [&]() {
    const int ls = gs % LS;
    mbar_wait(&lfull[ls], (gs / LS) & 1);
    const uint8_t* land = sm + TL::LAND_ + ls * TL::LAND;
    uint8_t* st = sm + TL::SPLIT_ + (gs % SS) * TL::SPLIT;
    if (nu.kind == PB_DW)
      split_dw<T>(land, st, p.gamma, nu.tj * PB_TILE, Nc, threadIdx.x);
    else
      split_do<T>(land, st, p.gamma, nu.k0 + nks * PB_K, Nc, threadIdx.x);
    __syncwarp();
    if (lane == 0) mbar_arrive(&lempty[ls]);  // the landing stage is read
    ++gs;
    if (++nks == nns) next_unit();
  };
  next_unit();
  if (ni < n_units) {
    split_next();
    fence_proxy_async();  // the writes, visible to the wgmmas
    bar_sync(1, 256);
  }
  int g = 0;
  for (int i = 0; i < n_units; ++i) {
    const ProjBwdUnit u = proj_bwd_unit(pl, M, Nc, blockIdx.x + i * gridDim.x);
    if (u.kind == PB_RED) {  // once the tile's chunks have all arrived
      if (threadIdx.x == 0) pb_wait_count(p.counters + u.ti * pl.c_tiles + u.tj, pl.chunks);
      bar_sync(1, 256);
      __threadfence();
      if (p.w_bf16)
        pb_reduce<bf16>(p, u);
      else
        pb_reduce<float>(p, u);
      continue;
    }
    const int ns = proj_bwd_stages(u);
    // OpTF32x3's products: lo·hi + hi·lo in small over the unit; hi·hi in
    // hh, which starts afresh every FOLD stages and joins acc, the f32 sum,
    // by __fadd_rn (F29)
    float acc[64], hh[64], small[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;
    for (int ks = 0; ks < ns; ++ks, ++g) {
      const int s = g % SS;
      const uint8_t* As = sm + TL::SPLIT_ + s * TL::SPLIT + cw * 64 * 128;
      const uint8_t* Bs = sm + TL::SPLIT_ + s * TL::SPLIT + TL::BOX;
      const int fresh = ks % TL::FOLD == 0;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PB_K / 8; ++kk) {
        const uint64_t da = smem_desc<128>(As + kk * 32, 16, 1024);
        const uint64_t db = smem_desc<128>(Bs + kk * 32, 16, 1024);
        // 0: D = A * B, the unit's (small) or the fold's (hh) first step
        OpTF32x3::mma(hh, small, da, db, ks | kk, TL::LO >> 4, !(fresh && kk == 0));
      }
      wgmma_commit();
      // once every wgmma of stage g - 1 has read its split stage (this
      // warpgroup's, then the other's: named barrier 1), split stage g + 1
      // into it while stage g runs
      wgmma_wait<1>();
      bar_sync(1, 256);
      if (ni < n_units) split_next();
      fence_proxy_async();
      bar_sync(1, 256);
      if ((ks + 1) % TL::FOLD == 0 || ks + 1 == ns) {  // stage g's hi·hi joins acc
        wgmma_wait<0>();
        fence_regs(hh);
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[e] = __fadd_rn(acc[e], hh[e]);
      }
    }
    wgmma_wait<0>();
    fence_regs(small);
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = __fadd_rn(acc[e], small[e]);

    // this thread's sums: rows r0 and r0 + 8, columns cb + 8j and + 1
    const int r0 = u.ti * PB_TILE + cw * 64 + warp * 16 + gq;
    const int cb = u.tj * PB_TILE + 2 * t;
    if (u.kind == PB_DO) {  // d_o [M, D] in T
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = cb + 8 * j;
        if (col >= D) continue;
        const long long off = (long long)r0 * D + col;
        if (r0 < M) pb_store<T>(p.d_o, off, acc[4 * j], acc[4 * j + 1]);
        if (r0 + 8 < M) pb_store<T>(p.d_o, off + 8LL * D, acc[4 * j + 2], acc[4 * j + 3]);
      }
      continue;
    }
    // d_W [D, Nc]: one chunk writes W's dtype; more write their f32
    // partials and count the tile's arrivals for its reduction units
    const bool direct = pl.chunks == 1;
    float* part = p.part + (long long)u.chunk * D * Nc;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = cb + 8 * j;
      if (col >= Nc) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (r0 + 8 * h >= D) continue;
        const long long off = (long long)(r0 + 8 * h) * Nc + col;
        const float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
        if (!direct)
          store_pair(part + off, x, y);
        else if (p.w_bf16)
          pb_store<bf16>(p.dw, off, x, y);
        else
          pb_store<float>(p.dw, off, x, y);
      }
    }
    if (direct) continue;
    __threadfence();  // the partial, visible to the tile's reduction units
    bar_sync(1, 256);
    if (threadIdx.x == 0) atomicAdd(p.counters + u.ti * pl.c_tiles + u.tj, 1);
  }
}

// d_b = Σ_rows G' and d_γ = Σ_rows G ∘ pre (either null). Block (32, 8)
// over columns 32·blockIdx.x.. and rows split blockIdx.y (rows..): its sums
// to colpart [2, splits, Nc]; the last block of its columns to arrive adds
// the splits in order.
template <typename T>
__global__ void __launch_bounds__(256)
    proj_bwd_colsum_kernel(const T* __restrict__ grad, const float* __restrict__ pre,
                           const float* __restrict__ gamma, float* colpart, int* counters,
                           float* db, float* dgamma, int M, int Nc, int rows) {
  __shared__ float red[2][8][PB_COL];
  __shared__ int last;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * PB_COL + tx;
  const bool cin = c < Nc;
  const int splits = gridDim.y;
  const float gm = gamma != nullptr && cin ? gamma[c] : 1.f;
  const int r0 = blockIdx.y * rows, r1 = min(M, r0 + rows);
  float sb = 0.f, sg = 0.f;
  if (cin) {
#pragma unroll 4
    for (int m = r0 + ty; m < r1; m += 8) {
      const long long off = (long long)m * Nc + c;
      const float gv = to_float(grad[off]);
      sb = __fadd_rn(sb, gamma != nullptr ? __fmul_rn(gv, gm) : gv);
      if (pre != nullptr) sg = __fadd_rn(sg, __fmul_rn(gv, pre[off]));
    }
  }
  red[0][ty][tx] = sb;
  red[1][ty][tx] = sg;
  __syncthreads();
  if (ty == 0 && cin) {
    float a = red[0][0][tx], s = red[1][0][tx];
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      a = __fadd_rn(a, red[0][j][tx]);
      s = __fadd_rn(s, red[1][j][tx]);
    }
    colpart[(long long)blockIdx.y * Nc + c] = a;
    colpart[((long long)splits + blockIdx.y) * Nc + c] = s;
  }
  __threadfence();
  __syncthreads();
  if (tx == 0 && ty == 0) last = atomicAdd(counters + blockIdx.x, 1) == splits - 1;
  __syncthreads();
  if (!last || ty != 0 || !cin) return;
  __threadfence();
  float a = __ldcg(colpart + c), s = __ldcg(colpart + (long long)splits * Nc + c);
  for (int z = 1; z < splits; ++z) {
    a = __fadd_rn(a, __ldcg(colpart + (long long)z * Nc + c));
    s = __fadd_rn(s, __ldcg(colpart + ((long long)splits + z) * Nc + c));
  }
  if (db != nullptr) db[c] = a;
  if (dgamma != nullptr) dgamma[c] = s;
}

// A map of a row-major [rows, cols] matrix in boxes of bc columns x br
// rows, swizzled by sw bytes (0: rows as they are; the consumers lay the
// split tiles out)
cudaError_t pb_map(CUtensorMap* map, CUtensorMapDataType type, int esz, const void* base,
                   int rows, int cols, int bc, int br, int sw) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t stride = (cuuint64_t)cols * esz;
  const cuuint32_t box[2] = {(cuuint32_t)bc, (cuuint32_t)br};
  return make_tma_map(map, type, 2, base, dims, &stride, box, sw);
}

template <typename T>
cudaError_t launch_proj_bwd(const void* grad, const float* pre, const float* gamma,
                            const float* w, const void* o, uint8_t* work, void* d_o, void* dw,
                            float* db, float* dgamma, int w_bf16, int M, int D, int Nc,
                            const ProjBwdPlan& pl, cudaStream_t st) {
  const ProjBwdWorkspace ws = proj_bwd_workspace(pl, D, Nc);
  int* counters = reinterpret_cast<int*>(work + ws.counters);
  cudaError_t e = cudaSuccess;
  if (ws.part > ws.counters) e = cudaMemsetAsync(work + ws.counters, 0, ws.part - ws.counters, st);
  if (e != cudaSuccess) return e;
  if (pl.col_splits > 0) {
    const int col_blocks = cdiv(Nc, PB_COL);
    int* col_counters = counters + (pl.chunks > 1 ? pl.d_tiles * pl.c_tiles : 0);
    proj_bwd_colsum_kernel<T><<<dim3(col_blocks, pl.col_splits), dim3(PB_COL, 8), 0, st>>>(
        static_cast<const T*>(grad), pre, gamma, reinterpret_cast<float*>(work + ws.col),
        col_counters, db, dgamma, M, Nc, pl.col_rows);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (pl.units == 0) return cudaSuccess;
  constexpr CUtensorMapDataType TT = std::is_same_v<T, float> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                                              : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr int ESZ = sizeof(T);
  CUtensorMap g_rows = {}, w_rows = {}, o_cols = {}, g_cols = {};
  if (pl.n_do > 0) {
    e = pb_map(&g_rows, TT, ESZ, grad, M, Nc, PB_K, PB_TILE, 0);
    if (e == cudaSuccess)
      e = pb_map(&w_rows, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, w, D, Nc, PB_K, PB_TILE, 0);
  }
  if (e == cudaSuccess && pl.n_dw > 0) {
    e = pb_map(&o_cols, TT, ESZ, o, M, D, PB_TILE, PB_K, 0);
    if (e == cudaSuccess) e = pb_map(&g_cols, TT, ESZ, grad, M, Nc, PB_TILE, PB_K, 0);
  }
  if (e != cudaSuccess) return e;
  ProjBwdArgs a = {};
  a.gamma = gamma;
  a.d_o = d_o;
  a.dw = dw;
  a.part = reinterpret_cast<float*>(work + ws.part);
  a.counters = counters;
  a.M = M;
  a.D = D;
  a.Nc = Nc;
  a.w_bf16 = w_bf16;
  a.plan = pl;
  auto kernel = proj_bwd_kernel<T>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PbTile::SMEM);
  if (e != cudaSuccess) return e;
  kernel<<<pl.grid, QTHREADS, PbTile::SMEM, st>>>(g_rows, w_rows, o_cols, g_cols, a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace anyloc

// grad [M, Nc] in dtype; pre [M, Nc] f32 or null (no LayerScale); gamma [Nc]
// f32 or null; w [D, Nc] f32 (W_O); o [M, D] in dtype (read only for dw);
// work: proj_bwd_workspace's bytes of scratch; outputs (each null when not
// wanted) d_o [M, D] in dtype, dw [D, Nc] in w_dtype, db / dgamma [Nc] f32.
// sms, chunks, chunk_rows and col_splits are the Python mirror's plan
// (ops/kernels/attn_proj.py: proj_bwd_plan): a launch whose plan differs
// from proj_bwd_plan's is refused. Launches: a memset of the counters, the
// column sums when db or dgamma is wanted, the persistent kernel when d_o
// or dw is.
extern "C" int anyloc_qkv_proj_bwd(const void* grad, const float* pre, const float* gamma,
                                   const float* w, const void* o, void* work, void* d_o,
                                   void* dw, float* db, float* dgamma, int dtype, int w_dtype,
                                   int M, int D, int Nc, int sms, int chunks, int chunk_rows,
                                   int col_splits, void* stream) {
  using namespace anyloc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ProjBwdPlan pl = proj_bwd_plan(M, D, Nc, sms, d_o != nullptr, dw != nullptr,
                                       db != nullptr || dgamma != nullptr);
  if (pl.chunks != chunks || pl.chunk_rows != chunk_rows || pl.col_splits != col_splits ||
      Nc % 8 != 0 || D % 8 != 0 || (w_dtype != DT_F32 && w_dtype != DT_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  uint8_t* wk = static_cast<uint8_t*>(work);
  cudaError_t e;
  if (dtype == DT_BF16)
    e = launch_proj_bwd<bf16>(grad, pre, gamma, w, o, wk, d_o, dw, db, dgamma,
                              w_dtype == DT_BF16, M, D, Nc, pl, st);
  else if (dtype == DT_F32)
    e = launch_proj_bwd<float>(grad, pre, gamma, w, o, wk, d_o, dw, db, dgamma,
                               w_dtype == DT_BF16, M, D, Nc, pl, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
