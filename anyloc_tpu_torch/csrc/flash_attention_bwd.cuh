// The attention backward of K2 (flash_attention_bwd.cu) and of K5 (through
// the same entry, on strided column views of qkv and of its gradient):
// dq, dk, dv of softmax(q k^T · scale) v from q, k, v, the output O, its
// gradient dO and each query row's log-sum-exp of the scaled scores (LSE,
// saved by the forward kernels, flash_attention.cuh).
//
// Replaces no TPU kernel: no Pallas kernel of anyloc_tpu has a backward
// (F19); the function is the gradient of the JAX package's XLA attention
// route (anyloc_tpu/ops/pallas/flash_attention.py:299 xla_attention; K5's
// q pre-scaled and rounded as attn_proj.py:307), which the port's plain
// versions compute by autograd.
//
// What bounds it on the H100: five products (S recomputed, dP, dV, dK, dQ)
// = 10·B·H·N²·hd operations, 7.15 GFLOP at q/k/v [48, 6, 197, 64], against
// 4·8·B·H·N·hd bytes (q, k, v, O, dO read; dq, dk, dv written): f32 runs
// each product as three tf32 products (3xTF32), so tensor-core issue bounds
// it; bf16 needs one tf32 product where both operands are inputs (bf16 is
// exact in tf32) and two where one is the f32 dS.
//
// The wgmma kernel follows FlashAttention-2's dataflow: a block per (key
// group, head, batch) takes the group's key blocks of 64 in turn; for each
// it holds K_j and V_j in shared memory and dK_j, dV_j in registers, and
// walks the query steps: it recomputes S^T = K_j Q_i^T and P^T = exp(S^T −
// LSE), dP^T = V_j dO_i^T, dS^T = P^T ∘ (dP^T − D), adds P^T dO_i to dV
// and dS^T Q_i to dK, and this key block's share of dQ_i, dS K_j, to its
// group's f32 slice (each thread to the same elements, in key order); a
// last pass sums the slices in a fixed order, scales and rounds dq to q's
// dtype. No atomics: every gradient is reproducible bit for bit
// (chip_smoke.py prints two calls' largest difference), which the training
// checks that hold one step against two others rely on. The slices cost
// 4·S·B·H·N·hd bytes with S = attention_bwd_slices: one slice per key
// block up to four (58 MB at [48, 6, 197, 64]), and at most four beyond
// (0.81 GB at [48, 12, 1370, 64], where one slice per key block would
// take 4.4 GB): O(N), as flash attention's memory should be. Only a B·H
// under BWD_MIN_GRID / 4 keeps more slices, to fill the card.
//
// Two routes, chosen per (head dim, dtype) by a table fixed at build time
// (attention_bwd_route; ops/kernels/flash_attention.py mirrors it, and the
// entry refuses a caller whose mirror disagrees):
//   * the wgmma route, attn_bwd_wgmma_kernel (hd 16, 32, 64, 80 in f32 and
//     bf16, hd 128 in bf16: the dvgl ViT-B/16 step, tensor-parallel
//     training, DINOv2 at hd 64; MAE-H, ImageBind-H and SAM-H at hd 80):
//     every product a warpgroup wgmma (hopper.cuh), 3xTF32 for f32. A
//     producer thread lands each step's Q and dO by TMA (4-D maps over the
//     strided views, two stages, mbarriers); a split warpgroup splits every
//     tile into tf32 hi and lo once (K, V, K^T once per key block; Q, dO,
//     Q^T, dO^T once per step) into swizzled K-major tiles that the
//     descriptors name (128-byte panels of 32 columns, 64-byte panels of 16
//     where a row's bytes need them). tf32 wgmma has no transpose bit, so
//     the three products that reduce over tokens read K-major copies: dV +=
//     P^T dO and dK += dS^T Q take P^T and dS^T from the S^T / dP^T
//     accumulators in registers (RS) against dO^T and Q^T (each 8 queries
//     stored 0 2 4 6 1 3 5 7, the order of the accumulator's columns in an
//     A fragment, as the forward's V^T), and dQ is computed as dQ^T = K^T
//     dS^T (M = hd, in products of 64 rows; at hd 16, 32 and 80 the last
//     product's rows past hd read past K^T and are never stored) from K^T
//     and dS, which the consumer warpgroup writes to shared memory split
//     once. A step's tiles go over in two halves (Q, dO, LSE, D for S^T and
//     dP^T; Q^T, dO^T for dV and dK), so that the split warpgroup writes the
//     next step's first half while the consumers run this one's last
//     products. setmaxnreg gives the consumers 240 registers. A step is 32
//     queries, 16 at hd 128 (dK and dV hold 64 x hd each in registers).
//     Shared memory: 214,352 bytes at hd 64 f32 (hi and lo of nine tiles,
//     two landing stages), 116,048 at hd 64 bf16 (no lo but dS's); at hd 80
//     f32 the landing stages would not fit, so Q and dO land in place, in
//     their tiles' panels, and are split where they lie (222,528 bytes; at
//     hd 64, where both fit, landing in place was 9 % slower on the H100).
//     One block per SM, two at hd 16 (consumers at 136 registers), whose
//     short steps leave one block's chain of dependent products idle
//     without the other. bf16's D pass (attn_bwd_delta_kernel) needs only
//     S^T and dP^T, whose operands are all bf16 inputs: bf16 wgmma on the
//     tiles as TMA lands them, no split, 51 KB at hd 64, three blocks per
//     SM.
//   * the split route (hd 128 in f32), where K, V and K^T in hi and lo
//     alone would take 196,608 of a block's 232,448 bytes: two kernels,
//     each with what fits. The wgmma kernel without dQ (DQ false: no K^T,
//     no dS tile, 16-query steps; 230,608 bytes) writes dK and dV; the
//     query-major attn_bwd_dq_wgmma_kernel (BwqTile: Q and dO of 64 queries
//     resident, K, V and K^T per 16-key step; 214,088 bytes) recomputes S
//     and dP and writes dq once, so this route needs no dq slices and no
//     pass over them. Seven products in place of five.
// f32 splits (hopper.cuh's tf32_split) every operand into hi and lo, x = hi
// + lo, and sums lo·hi + hi·lo + hi·hi (f32-accurate). wgmma's f32 sums
// round toward zero by a share of the accumulator (F27), so f32 never runs
// a long sum in one accumulator (F28): S^T and dP^T sum hi·hi apart from
// the small products, and dK, dV, which reduce over every query, take
// each step's products in accumulators of their own joined by f32 adds
// (hd 16-80), or, at hd 128, where dK and dV fill the registers, join the
// outputs a quarter at a time, each quarter every four steps (BwgTile's
// DKV_TMP, FOLD). Their error from float64 is then flat in N, within twice
// the plain version's (tests/test_torch_gpu.py, the smoke's F28 line).
// bf16 keeps one accumulator: its rounding of dK and dV is 2-3 orders
// above the drift.
//
// D = rowsum(P ∘ dP), the softmax backward's row term. f32: D =
// rowsum(dO ∘ O) (equal in exact arithmetic; attn_bwd_dot_kernel). bf16
// mirrors the rounding points of the plain version's autograd
// (flash_attention_ref, attn_proj.py's _attention_ref):
//   * dP = dO V^T in f32, rounded to bf16 (the backward of .float() on
//     the bf16 P);
//   * D = rowsum(P ∘ dP) on the f32 P and that rounded dP, in a first pass
//     (attn_bwd_delta_kernel before the wgmma kernel: each key block's
//     share in its slice, summed in order by the second), since O came
//     from the rounded P;
//   * dS = P ∘ (dP − D) in f32;
//   * dV = P_bf16^T dO with P rounded to bf16 (the forward's PV operand);
//   * dK, dV, dq rounded to bf16 once at the end; K5's dq as its plain
//     version: round(round(dS K) · scale) (the backward of the bf16 cast
//     of q · scale, then of the multiply).
// Everything else is f32 in both dtypes. K2's dk and dq carry the scale
// (scores = (q k^T) · scale); K5's q is pre-scaled and rounded to the
// input dtype before the scores, so S is recomputed from that same
// rounded q · scale (or P would disagree with the saved LSE), dk = dS^T q'
// and dq = scale · (dS K).
#pragma once

#include <type_traits>

#include "flash_attention.cuh"

namespace anyloc {

// the tensors of the backward, in the order of AttnBwdArgs::st
enum { BW_Q = 0, BW_K, BW_V, BW_O, BW_DO, BW_DQ, BW_DK, BW_DV, BW_TENSORS };

struct AttnBwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;     // the forward's output (f32: D = rowsum(dO ∘ O))
  const void* dout;  // its gradient
  void* dq;
  void* dk;
  void* dv;
  const float* lse;  // [B, H, N] natural log-sum-exp of the scaled scores
  // scratch, one slice per key group (attention_bwd_slices; bf16's D) or
  // one (f32's D): written whole, then summed in a fixed order, so that
  // every gradient is reproducible bit for bit
  float* delta;      // [slices, B, H, N]: D, or each key group's share of it
  float* dq_part;    // [slices, B, H, N, hd]: each key group's dS K
  int B, H, N;
  long long st[BW_TENSORS][3];  // element strides (batch, head, token); hd contiguous
  float scale;
  int prescale_q;  // as AttnArgs: 0 K2, 1 K5
};

// Keys per block of the backward.
constexpr int BWD_KEYS = 64;
// Blocks of the backward the grid should give the card at least (132 SMs,
// up to four blocks on each).
constexpr int BWD_MIN_GRID = 512;

// Key blocks per block of the backward: at least ceil(ceil(N / 64) / 4), so
// that the scratch holds at most four slices of dq (the flash backward's
// memory stays O(N)), and fewer where B·H alone gives a grid under
// BWD_MIN_GRID; each block takes its group of key blocks in turn.
static inline int attention_bwd_group(int B, int H, int N) {
  const int n_kb = (N + BWD_KEYS - 1) / BWD_KEYS;
  const int bh = B * H > 0 ? B * H : 1;
  int slices = (BWD_MIN_GRID + bh - 1) / bh;
  if (slices < 4) slices = 4;
  if (slices > n_kb) slices = n_kb;
  return slices > 0 ? (n_kb + slices - 1) / slices : 1;
}

// The scratch slices of dq_part (and of bf16's delta): one per key group.
static inline int attention_bwd_slices(int B, int H, int N) {
  const int n_kb = (N + BWD_KEYS - 1) / BWD_KEYS;
  const int per = attention_bwd_group(B, H, N);
  return (n_kb + per - 1) / per;
}

// The route table: which kernels the backward runs at head dim hd and dtype
// (DT_F32, DT_BF16). The wgmma kernel wherever its tiles fit a block's
// shared memory (BwgTile); the split route at hd 128 in f32, where the
// resident K, V and K^T in hi and lo alone take 196,608 bytes: the wgmma
// kernel without dQ (no K^T, no dS tile) for dK and dV, and the query-major
// dQ kernel (BwqTile). Fixed at build time, never a fallback.
enum { BWD_WGMMA = 1, BWD_SPLIT = 2 };
constexpr int attention_bwd_route(int hd, int dtype) {
  return dtype == DT_F32 && hd == 128 ? BWD_SPLIT : BWD_WGMMA;
}

namespace {

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = unpack_bf16(u.x), b = unpack_bf16(u.y);
  return make_float4(a.x, a.y, b.x, b.y);
}

// x rounded to T's precision, as f32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// q · scale in f32, rounded to the input dtype (K5's pre-scaled q)
template <typename T>
__device__ __forceinline__ float prescale(float x, float scale) {
  return round_to<T>(__fmul_rn(x, scale));
}

__device__ __forceinline__ float sum_over_g(float x) {  // the 8 lanes of one t
  x += __shfl_xor_sync(0xffffffff, x, 4);
  x += __shfl_xor_sync(0xffffffff, x, 8);
  return x + __shfl_xor_sync(0xffffffff, x, 16);
}

// f32: D = rowsum(dO ∘ O), eight lanes per (batch, head, row), float4 reads
__global__ void __launch_bounds__(256) attn_bwd_dot_kernel(AttnBwdArgs p, int hd) {
  const long long w = (long long)blockIdx.x * 32 + (threadIdx.x >> 3);
  const int lane = threadIdx.x & 7;
  const bool in = w < (long long)p.B * p.H * p.N;
  float s = 0.f;
  if (in) {
    const int n = static_cast<int>(w % p.N);
    const int bh = static_cast<int>(w / p.N);
    const int b = bh / p.H, h = bh % p.H;
    const float* O = static_cast<const float*>(p.o) + b * p.st[BW_O][0] + h * p.st[BW_O][1] +
                     n * p.st[BW_O][2];
    const float* G = static_cast<const float*>(p.dout) + b * p.st[BW_DO][0] +
                     h * p.st[BW_DO][1] + n * p.st[BW_DO][2];
    for (int i = 4 * lane; i < hd; i += 32) {
      const float4 x = load4(O + i), y = load4(G + i);
      s += y.x * x.x + y.y * x.y + y.z * x.z + y.w * x.w;
    }
  }
#pragma unroll
  for (int o = 4; o; o >>= 1) s += __shfl_xor_sync(0xffffffff, s, o);
  if (in && lane == 0) p.delta[w] = s;
}

// dq from the key groups' shares, summed in order: K2 dq = sum · scale;
// K5 dq = round(sum) · scale (its plain version rounds dS K to q's dtype,
// then scales), in q's dtype
template <typename T>
__global__ void __launch_bounds__(256) attn_bwd_dq_kernel(AttnBwdArgs p, int hd, int n_slices) {
  const long long i = 2 * ((long long)blockIdx.x * 256 + threadIdx.x);  // a column pair
  const long long n_el = (long long)p.B * p.H * p.N * hd;
  if (i >= n_el) return;
  const int col = static_cast<int>(i % hd);
  const long long row = i / hd;
  const int n = static_cast<int>(row % p.N);
  const int bh = static_cast<int>(row / p.N);
  const int b = bh / p.H, h = bh % p.H;
  float2 a = *reinterpret_cast<const float2*>(p.dq_part + i);
  for (int z = 1; z < n_slices; ++z) {
    const float2 x = *reinterpret_cast<const float2*>(p.dq_part + z * n_el + i);
    a.x += x.x;
    a.y += x.y;
  }
  if (p.prescale_q) {
    a.x = round_to<T>(a.x);
    a.y = round_to<T>(a.y);
  }
  T* dq = static_cast<T*>(p.dq) + b * p.st[BW_DQ][0] + h * p.st[BW_DQ][1] + n * p.st[BW_DQ][2];
  store2(dq + col, __fmul_rn(a.x, p.scale), __fmul_rn(a.y, p.scale));
}

// ---------------------------------------------------------------- the wgmma kernel

// The wgmma kernel's tiles at head dim HD (16, 32, 64, 80; 128 in bf16): a
// block of one consumer warpgroup (the products; keys 16w..16w+15 of the key
// block in warp w), one split warpgroup and the producer's warpgroup. Every
// operand tile is f32 in swizzled K-major panels (kmaj), hi then, with LO
// (f32 operands), lo a tile on: K, V [64 keys x HD] and K^T [HD x 64 keys]
// for the key block; Q, dO [BQ x HD] and Q^T, dO^T [HD x BQ queries, each
// 8 as 0 2 4 6 1 3 5 7] for the step; dS [BQ queries x 64 keys] hi and lo
// in both dtypes (dS is f32); two landing stages of Q and dO as TMA writes
// them (rows of HD in the input dtype) where they fit; LSE · log2 e and D
// of the step's queries.
template <int HD, bool LO, bool DQ = true>
struct BwgTile {
  // queries per step: 32, but 16 at hd 128, where dK and dV hold 64 x 128
  // accumulators each
  static constexpr int BKV = 64, BQ = HD == 128 ? 16 : 32;
  // dQ^T = K^T dS^T has M = HD rows, in MQ / 64 warpgroup products of 64
  // rows; at hd 16, 32 and 80 the last product's rows past HD read what
  // follows K^T's rows in shared memory, and their sums are never stored
  static constexpr int MQ = (HD + 63) / 64 * 64;
  // three warpgroups (the producer's, of which one thread issues the TMA
  // loads): setmaxnreg works on whole warpgroups, and moves its registers
  // to the consumers, whose accumulators would not fit the even share
  static constexpr int THREADS = 3 * 128;
  // blocks an SM: two at hd 16, whose steps are a fifth of hd 80's work,
  // so that one block's chain of dependent products runs while the other's
  // waits; their accumulators fit the halved register share
  static constexpr int MIN_BLOCKS = HD == 16 ? 2 : 1;
  static constexpr int REGS_CONSUMER = MIN_BLOCKS == 2 ? 136 : 240;
  static constexpr int REGS_SPLIT = MIN_BLOCKS == 2 ? 80 : 168;  // the launch's share
  static constexpr int REGS_PRODUCER = MIN_BLOCKS == 2 ? 24 : 40;
  static_assert(REGS_SPLIT * THREADS * MIN_BLOCKS <= 65536, "the launch's registers");
  static_assert(REGS_CONSUMER + REGS_SPLIT + REGS_PRODUCER <= 3 * REGS_SPLIT,
                "setmaxnreg moves the launch's registers, no more");
  // f32 (F28): wgmma's sums round toward zero by a share of the
  // accumulator (F27), so no long sum runs in one accumulator. S^T and
  // dP^T keep hi·hi apart from lo·hi + hi·lo (without it dq, which runs no
  // long sum, erred by 2.5-4.9e-6 of max|g| on an H100, up to 5x the plain
  // version's). Each step's dV and dK
  // products start accumulators of their own that join dv and dk by f32
  // adds: DKV_TMP 2, two accumulators, joined while dQ^T's products run
  // (hd 16, 32, 80); DKV_TMP 1, one, dV's then dK's, each joined at once
  // (hd 64: no spills, and faster on the H100). Where dK and dV leave no
  // registers for that (hd 128: 64 x 128 each), FOLD: every step one
  // quarter of dv and dk joins the outputs and starts again from zeros,
  // so that each quarter sums four steps (each block owns its key rows:
  // no atomics, a fixed order); the quarter's output rows are loaded as
  // the step starts, behind S^T's and dP^T's products
  static constexpr int DKV_TMP = !LO ? 0 : HD == 64 ? 1 : HD <= 80 ? 2 : 0;
  static constexpr bool FOLD = LO && DKV_TMP == 0;
  static constexpr int COPIES = LO ? 2 : 1;
  static constexpr int KTILE = BKV * HD * 4;            // K, V, K^T
  static constexpr int QTILE = BQ * HD * 4;             // Q, dO, Q^T, dO^T
  static constexpr int STILE = BQ * BKV * 4;            // dS
  static constexpr int LAND = BQ * HD * (LO ? 4 : 2);   // one landed Q or dO tile
  // without DQ (the split route's dK / dV kernel) no K^T and no dS tile
  static constexpr int K_ = 0;
  static constexpr int V_ = K_ + COPIES * KTILE;
  static constexpr int KT_ = V_ + COPIES * KTILE;
  static constexpr int Q_ = KT_ + (DQ ? COPIES * KTILE : 0);
  static constexpr int G_ = Q_ + COPIES * QTILE;
  static constexpr int QT_ = G_ + COPIES * QTILE;
  static constexpr int GT_ = QT_ + COPIES * QTILE;
  static constexpr int S_ = GT_ + COPIES * QTILE;
  static constexpr int LAND_ = S_ + (DQ ? 2 * STILE : 0);
  // Q and dO land in two stages where those fit a block; else (f32 at hd 80)
  // in place: TMA writes their f32 rows into the Q and dO tiles' hi panels,
  // and the split warpgroup splits them where they lie
  static constexpr bool IN_PLACE = LAND_ + 4 * LAND + 2 * BQ * 4 + 10 * 8 + 1024 > 232448;
  static constexpr int STAGES = IN_PLACE ? 1 : 2;       // full / empty barrier pairs
  static constexpr int L_ = LAND_ + (IN_PLACE ? 0 : STAGES * 2 * LAND);  // Ls [BQ], Ds [BQ]
  static constexpr int BAR_ = L_ + 2 * BQ * 4;
  static constexpr int NBAR = 2 * STAGES + 6;
  static constexpr int SMEM = BAR_ + NBAR * 8 + 1024;   // + alignment of the base to 1024
  // f32 at hd 64: 214,352; 80: 222,528, in place; hd 128 f32 without DQ
  // 230,608 (with K^T, 196,608 for K, V and K^T alone, before any query
  // tile: the split route)
  static_assert(SMEM <= 232448, "a block's shared memory");
  static_assert(MIN_BLOCKS * (SMEM + 1024) <= 233472, "the blocks an SM");
  static_assert(!IN_PLACE || LO, "bf16 lands in stages: its tiles hold f32");
  static_assert(!DQ || KT_ + COPIES * KTILE + (MQ - HD) * 128 <= SMEM, "dQ^T's reads past K^T");
};

// An f32 K-major tile of C columns is cut into panels of SW bytes, the
// largest TMA swizzle (128 or 64) that divides a row's 4·C bytes: 32
// columns a panel, 16 where C is an odd multiple of 16 (hd 16 and 80, the
// 16-query steps of hd 128), as the forward's f32 K tiles (Fa32Tile)
template <int C>
constexpr int kmaj_sw = (C * 4) % 128 == 0 ? 128 : 64;

// Byte offset of element (r, c) of an f32 K-major tile of R rows and C
// columns: panels of R rows, each row swizzled as TMA's swizzle of the
// panel's width, the layout smem_desc<SW> names (c % 4 == 0 keeps a float4
// together)
template <int R, int C>
__device__ __forceinline__ int kmaj(int r, int c) {
  constexpr int SW = kmaj_sw<C>, BOX = SW / 4;
  return (c / BOX) * (R * SW) + swizzle<SW>(r * SW + (c % BOX) * 4);
}

// The descriptor of k8 step kk (32 bytes along K) of such a tile
template <int R, int C>
__device__ __forceinline__ uint64_t kdesc(const uint8_t* tile, int kk) {
  constexpr int SW = kmaj_sw<C>;
  const int off = kk * 32;
  return smem_desc<SW>(tile + (off / SW) * (R * SW) + off % SW, 16, 8 * SW);
}

// Four values into a tile at byte offset `off`: with LO their tf32 hi, and
// their lo `lo` bytes on; else as they are (bf16 data, exact in tf32)
template <bool LO>
__device__ __forceinline__ void put4(uint8_t* tile, int lo, int off, float4 x) {
  if (LO) {
    uint4 h, l;
    tf32_split(x.x, h.x, l.x);
    tf32_split(x.y, h.y, l.y);
    tf32_split(x.z, h.z, l.z);
    tf32_split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(tile + off) = h;
    *reinterpret_cast<uint4*>(tile + lo + off) = l;
  } else {
    *reinterpret_cast<float4*>(tile + off) = x;
  }
}

template <typename T>
__device__ __forceinline__ float4 prescale4(float4 x, float scale) {
  return make_float4(prescale<T>(x.x, scale), prescale<T>(x.y, scale), prescale<T>(x.z, scale),
                     prescale<T>(x.w, scale));
}

// Four accumulator values of one 8-query step of a 64 x 32 product, (row g,
// query 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1), as an A fragment of
// hi and lo (hopper.cuh's wgmma_tf32_rs): columns t and t + 4 are queries
// 2t and 2t + 1, the order Q^T and dO^T store. EXACT: one piece.
template <bool EXACT>
__device__ __forceinline__ void frag_of(const float* acc, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float x[4] = {acc[0], acc[2], acc[1], acc[3]};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (EXACT) {
      hi[e] = __float_as_uint(x[e]);
      lo[e] = 0u;
    } else {
      tf32_split(x[e], hi[e], lo[e]);
    }
  }
}

// acc = one step's products over its BQ / 8 k8 slices of 8 queries, A
// from registers (hi, lo), B the K-major tile bt (lo blo descriptor steps
// on), three tf32 wgmmas a slice; scale-d 0 on the first starts acc
template <int HD, int BQ, int N>
__device__ __forceinline__ void step_sum(float (&acc)[N], const uint32_t (&hi)[BQ / 8][4],
                                         const uint32_t (&lo)[BQ / 8][4], const uint8_t* bt,
                                         uint32_t blo) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const uint64_t b = kdesc<HD, BQ>(bt, j);
    wgmma_tf32_rs(acc, lo[j], b, j);
    wgmma_tf32_rs(acc, hi[j], b + blo, 1);
    wgmma_tf32_rs(acc, hi[j], b, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// dK and dV of this thread's key rows r0, r0 + 8 into the outputs (rows
// past N skipped), dk times ks. A thread's registers of dV and dK hold
// n-groups n = 0 .. HD / 8 - 1 (rows r0, r0 + 8, columns 8n + 2t, 8n + 2t
// + 1: registers 4n .. 4n + 3); BwgTile::FOLD folds them in quarters, dv's
// first and second half (quarters 0, 1), then dk's (2, 3). Bit c of `add`
// (f32 only): quarter c goes onto the partial sums an earlier fold left.
template <int HD, typename T>
__device__ __forceinline__ void put_dkdv(T* DK, T* DV, long long sdk, long long sdv, int r0,
                                         int N, int t, const float (&dk)[HD / 2],
                                         const float (&dv)[HD / 2], float ks, int add) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int col = 8 * n + 2 * t;
    const int quarter = n / (HD / 16);
    const bool addv = (add >> quarter) & 1, addk = (add >> (2 + quarter)) & 1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h, e = 4 * n + 2 * h;
      if (r >= N) continue;
      T* ok = DK + r * sdk + col;
      T* ov = DV + r * sdv + col;
      if constexpr (std::is_same_v<T, float>) {
        if (addk) {
          const float2 pk = *reinterpret_cast<const float2*>(ok);
          store2(ok, fmaf(dk[e], ks, pk.x), fmaf(dk[e + 1], ks, pk.y));
        } else {
          store2(ok, dk[e] * ks, dk[e + 1] * ks);
        }
        if (addv) {
          const float2 pv = *reinterpret_cast<const float2*>(ov);
          store2(ov, __fadd_rn(pv.x, dv[e]), __fadd_rn(pv.y, dv[e + 1]));
        } else {
          store2(ov, dv[e], dv[e + 1]);
        }
      } else {
        store2(ok, dk[e] * ks, dk[e + 1] * ks);
        store2(ov, dv[e], dv[e + 1]);
      }
    }
  }
}

// Quarter C's output values (put_dkdv's quarters) of rows r0, r0 + 8 into x
// (rows past N: zeros)
template <int HD, int C>
__device__ __forceinline__ void load_quarter(float (&x)[HD / 4], const float* out, long long st,
                                             int r0, int N, int t) {
  constexpr int QN = HD / 16;
#pragma unroll
  for (int m = 0; m < QN; ++m) {
    const int col = 8 * ((C & 1) * QN + m) + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      const float2 v = r < N ? *reinterpret_cast<const float2*>(out + r * st + col)
                             : make_float2(0.f, 0.f);
      x[4 * m + 2 * h] = v.x;
      x[4 * m + 2 * h + 1] = v.y;
    }
  }
}

// Quarter C of acc (dv for C 0, 1, dk for 2, 3) times `scale` into the
// outputs, onto x (load_quarter's) where `add`; then the quarter from zeros
template <int HD, int C>
__device__ __forceinline__ void fold_quarter(float (&acc)[HD / 2], const float (&x)[HD / 4],
                                             bool add, float* out, long long st, int r0, int N,
                                             int t, float scale) {
  constexpr int QN = HD / 16;
#pragma unroll
  for (int m = 0; m < QN; ++m) {
    const int n = (C & 1) * QN + m, col = 8 * n + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h, e = 4 * n + 2 * h, i = 4 * m + 2 * h;
      if (r < N)
        store2(out + r * st + col, add ? fmaf(acc[e], scale, x[i]) : acc[e] * scale,
               add ? fmaf(acc[e + 1], scale, x[i + 1]) : acc[e + 1] * scale);
      acc[e] = acc[e + 1] = 0.f;
    }
  }
}

// One block per (group of `per` consecutive key blocks, head, batch), which
// takes its key blocks in turn (bf16's D comes from attn_bwd_delta_kernel
// before it). Warpgroup 0 runs the products, warpgroup 1 splits, thread
// 256 issues the TMA loads.
// dS goes to shared memory before dV and dK are issued, and dQ^T after
// they are done, so that no two groups' operands and accumulators hold
// registers at once.
template <int HD, typename T, bool DQ = true>
__global__ void __launch_bounds__(BwgTile<HD, std::is_same_v<T, float>, DQ>::THREADS,
                                  BwgTile<HD, std::is_same_v<T, float>, DQ>::MIN_BLOCKS)
    attn_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap gmap, AttnBwdArgs p, int n_kb,
                          int per, int n_slices) {
  constexpr bool LO = std::is_same_v<T, float>;  // bf16 is exact in tf32: no lo
  using TL = BwgTile<HD, LO, DQ>;
  constexpr int BKV = TL::BKV, BQ = TL::BQ, MQ = TL::MQ;
  constexpr uint32_t KLO = TL::KTILE >> 4, QLO = TL::QTILE >> 4, SLO = TL::STILE >> 4;
  extern __shared__ uint8_t bw_smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(bw_smem_raw) + 1023) & ~uintptr_t(1023));
  float* Ls = reinterpret_cast<float*>(sm + TL::L_);  // LSE · log2 e per query row
  float* Ds = Ls + BQ;                                 // D per query row
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + TL::BAR_);  // a stage landed
  uint64_t* empty = full + TL::STAGES;                 // a stage read by the split warpgroup
  uint64_t* kv_ready = empty + TL::STAGES;             // K, V, K^T split
  uint64_t* kv_free = kv_ready + 1;                    // the key block's products are done
  // a step's tiles go over in two halves, each with its pair of barriers:
  // (a) Q, dO, LSE, D, read by S^T, dP^T and dS^T; (b) Q^T, dO^T, read by
  // dV and dK. The split warpgroup writes the next step's half (a) while
  // the consumers run this step's dV, dK and dQ^T products.
  uint64_t* ready_b = kv_free + 1;
  uint64_t* done_b = ready_b + 1;
  uint64_t* ready_a = done_b + 1;
  uint64_t* done_a = ready_a + 1;

  const int kg = blockIdx.x % n_slices;  // the key group: its scratch slice
  const int bh = blockIdx.x / n_slices;
  const int b = bh / p.H, h = bh % p.H;
  const int N = p.N;
  const int nq = cdiv(N, BQ);
  const int kb0 = kg * per, kb_end = min(kb0 + per, n_kb);
  const long long rows = (long long)bh * N;  // this (batch, head)'s first row of LSE, D, dq
  const long long slice = (long long)p.B * p.H * N;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < TL::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_init(kv_ready, 128);
    mbar_init(kv_free, 4);
    mbar_init(ready_a, 128);
    mbar_init(done_a, 4);
    mbar_init(ready_b, 128);
    mbar_init(done_b, 4);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // ---------------------------------------- producer
    regs_shrink<TL::REGS_PRODUCER>();
    if (threadIdx.x == 256) {
      tma_prefetch_map(&qmap);
      tma_prefetch_map(&gmap);
      const int steps = (kb_end - kb0) * nq;
      for (int it = 0; it < steps; ++it) {
        const int q0 = (it % nq) * BQ;
        if constexpr (TL::IN_PLACE) {
          // into the Q and dO tiles, a box a panel, once the last step's
          // readers are done: the consumers' S^T and dP^T, the split's
          // transposes
          if (it > 0) {
            mbar_wait(done_a, (it - 1) & 1);
            mbar_wait(&empty[0], (it - 1) & 1);
          }
          constexpr int SW = kmaj_sw<HD>;
          mbar_arrive_expect_tx(&full[0], 2 * TL::QTILE);
          for (int pn = 0; pn < HD * 4 / SW; ++pn) {
            tma_load_4d(sm + TL::Q_ + pn * BQ * SW, &qmap, &full[0], pn * SW / 4, q0, h, b);
            tma_load_4d(sm + TL::G_ + pn * BQ * SW, &gmap, &full[0], pn * SW / 4, q0, h, b);
          }
        } else {
          const int s = it % TL::STAGES;
          if (it >= TL::STAGES) mbar_wait(&empty[s], (it / TL::STAGES - 1) & 1);
          uint8_t* land = sm + TL::LAND_ + s * 2 * TL::LAND;
          mbar_arrive_expect_tx(&full[s], 2 * TL::LAND);
          tma_load_4d(land, &qmap, &full[s], 0, q0, h, b);
          tma_load_4d(land + TL::LAND, &gmap, &full[s], 0, q0, h, b);
        }
      }
    }
    return;
  }

  if (threadIdx.x >= 128) {  // ---------------------------------------- split
    const int tid = threadIdx.x - 128;
    const bool pre = p.prescale_q != 0;
    const T* Kg = static_cast<const T*>(p.k) + b * p.st[BW_K][0] + h * p.st[BW_K][1];
    const T* Vg = static_cast<const T*>(p.v) + b * p.st[BW_V][0] + h * p.st[BW_V][1];
    const long long skn = p.st[BW_K][2], svn = p.st[BW_V][2];
    constexpr int KV_ITEMS = BKV * HD / 4 / 128;  // float4 items of K (and V) per thread
    // in two chunks beyond hd 64, for the registers
    constexpr int CHUNK = KV_ITEMS > 8 ? KV_ITEMS / 2 : KV_ITEMS;
    static_assert(KV_ITEMS % CHUNK == 0, "whole chunks");
    int it = 0;
    for (int kb = kb0; kb < kb_end; ++kb) {
      const int k0 = kb * BKV;
      // K, V rows of keys (zeros past N): every load of a chunk issued
      // before its stores
#pragma unroll
      for (int m0 = 0; m0 < KV_ITEMS; m0 += CHUNK) {
        float4 kx[CHUNK], vx[CHUNK];
#pragma unroll
        for (int m = 0; m < CHUNK; ++m) {
          const int i = tid + 128 * (m0 + m), r = i / (HD / 4), c = (i % (HD / 4)) * 4;
          kx[m] = vx[m] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (k0 + r < N) {
            kx[m] = load4(Kg + (k0 + r) * skn + c);
            vx[m] = load4(Vg + (k0 + r) * svn + c);
          }
        }
        if (m0 == 0 && kb > kb0) mbar_wait(kv_free, (kb - kb0 - 1) & 1);
#pragma unroll
        for (int m = 0; m < CHUNK; ++m) {
          const int i = tid + 128 * (m0 + m), r = i / (HD / 4), c = (i % (HD / 4)) * 4;
          put4<LO>(sm + TL::K_, TL::KTILE, kmaj<BKV, HD>(r, c), kx[m]);
          put4<LO>(sm + TL::V_, TL::KTILE, kmaj<BKV, HD>(r, c), vx[m]);
        }
      }
      // K^T from K's tiles (hi and lo as they are): item (c, d) is head-dim
      // row d, keys 4c..4c+3 (panels of 32 keys)
      if constexpr (DQ) bar_sync(2, 128);
#pragma unroll
      for (int cp = 0; cp < (DQ ? TL::COPIES : 0); ++cp) {
        const uint8_t* kt = sm + TL::K_ + cp * TL::KTILE;
        for (int i = tid; i < HD * BKV / 4; i += 128) {
          const int d = i % HD, c = i / HD;
          uint4 x;
          x.x = *reinterpret_cast<const uint32_t*>(kt + kmaj<BKV, HD>(4 * c, d));
          x.y = *reinterpret_cast<const uint32_t*>(kt + kmaj<BKV, HD>(4 * c + 1, d));
          x.z = *reinterpret_cast<const uint32_t*>(kt + kmaj<BKV, HD>(4 * c + 2, d));
          x.w = *reinterpret_cast<const uint32_t*>(kt + kmaj<BKV, HD>(4 * c + 3, d));
          *reinterpret_cast<uint4*>(sm + TL::KT_ + cp * TL::KTILE + kmaj<HD, BKV>(d, 4 * c)) = x;
        }
      }
      fence_proxy_async();  // the writes, visible to the consumers' wgmma
      mbar_arrive(kv_ready);

      for (int qb = 0; qb < nq; ++qb, ++it) {
        const int s = it % TL::STAGES, q0 = qb * BQ;
        // the step's LSE and D, loaded before the waits
        float lse = INFINITY, dsum = 0.f;  // rows past N: LSE +inf, so P = 0
        if (tid < BQ && q0 + tid < N) {
          lse = p.lse[rows + q0 + tid] * LOG2E;
          // D: f32 one slice; bf16 the key groups' shares, summed in order
          for (int z = 0; z < (LO ? 1 : n_slices); ++z)
            dsum += p.delta[z * slice + rows + q0 + tid];
        }
        mbar_wait(&full[s], (it / TL::STAGES) & 1);
        const T* lq = reinterpret_cast<const T*>(sm + TL::LAND_ + s * 2 * TL::LAND);
        const T* lg = reinterpret_cast<const T*>(sm + TL::LAND_ + s * 2 * TL::LAND + TL::LAND);
        // half (a): Q (K5: pre-scaled), dO, LSE, D
        if (it > 0) mbar_wait(done_a, (it - 1) & 1);
        for (int i = tid; i < BQ * HD / 4; i += 128) {
          const int r = i / (HD / 4), c = (i % (HD / 4)) * 4, off = kmaj<BQ, HD>(r, c);
          float4 x, y;
          if constexpr (TL::IN_PLACE) {  // split where TMA put them
            x = *reinterpret_cast<const float4*>(sm + TL::Q_ + off);
            y = *reinterpret_cast<const float4*>(sm + TL::G_ + off);
          } else {
            x = load4(lq + r * HD + c);
            y = load4(lg + r * HD + c);
          }
          if (pre) x = prescale4<T>(x, p.scale);
          put4<LO>(sm + TL::Q_, TL::QTILE, off, x);
          put4<LO>(sm + TL::G_, TL::QTILE, off, y);
        }
        if (tid < BQ) {
          Ls[tid] = lse;
          Ds[tid] = dsum;
        }
        fence_proxy_async();
        mbar_arrive(ready_a);
        // half (b): Q^T, dO^T; item (c, d) is head-dim row d, slots 4c..4c+3,
        // queries 8(c / 2) + c % 2 + {0, 2, 4, 6}
        if (it > 0) mbar_wait(done_b, (it - 1) & 1);
        if constexpr (TL::IN_PLACE) {  // from the split Q and dO tiles, hi and lo as they are
          bar_sync(2, 128);            // every split thread's half (a) is written
#pragma unroll
          for (int cp = 0; cp < TL::COPIES; ++cp) {
            const uint8_t* qs = sm + TL::Q_ + cp * TL::QTILE;
            const uint8_t* gs = sm + TL::G_ + cp * TL::QTILE;
            for (int i = tid; i < HD * BQ / 4; i += 128) {
              const int d = i % HD, c = i / HD;
              const int r = 8 * (c >> 1) + (c & 1);
              uint4 x, y;
              x.x = lds32(qs + kmaj<BQ, HD>(r, d));
              x.y = lds32(qs + kmaj<BQ, HD>(r + 2, d));
              x.z = lds32(qs + kmaj<BQ, HD>(r + 4, d));
              x.w = lds32(qs + kmaj<BQ, HD>(r + 6, d));
              y.x = lds32(gs + kmaj<BQ, HD>(r, d));
              y.y = lds32(gs + kmaj<BQ, HD>(r + 2, d));
              y.z = lds32(gs + kmaj<BQ, HD>(r + 4, d));
              y.w = lds32(gs + kmaj<BQ, HD>(r + 6, d));
              const int off = kmaj<HD, BQ>(d, 4 * c);
              *reinterpret_cast<uint4*>(sm + TL::QT_ + cp * TL::QTILE + off) = x;
              *reinterpret_cast<uint4*>(sm + TL::GT_ + cp * TL::QTILE + off) = y;
            }
          }
        } else {  // from the landed rows, split again
          for (int i = tid; i < HD * BQ / 4; i += 128) {
            const int d = i % HD, c = i / HD;
            const int r = 8 * (c >> 1) + (c & 1);
            float4 x = make_float4(to_float(lq[r * HD + d]), to_float(lq[(r + 2) * HD + d]),
                                   to_float(lq[(r + 4) * HD + d]), to_float(lq[(r + 6) * HD + d]));
            if (pre) x = prescale4<T>(x, p.scale);
            const float4 y =
                make_float4(to_float(lg[r * HD + d]), to_float(lg[(r + 2) * HD + d]),
                            to_float(lg[(r + 4) * HD + d]), to_float(lg[(r + 6) * HD + d]));
            const int off = kmaj<HD, BQ>(d, 4 * c);
            put4<LO>(sm + TL::QT_, TL::QTILE, off, x);
            put4<LO>(sm + TL::GT_, TL::QTILE, off, y);
          }
        }
        mbar_arrive(&empty[s]);  // the landed stage (in place: the Q and dO tiles) is read
        fence_proxy_async();
        mbar_arrive(ready_b);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  regs_grow<TL::REGS_CONSUMER>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kr = warp * 16 + g;  // this thread's key rows kr, kr + 8 of the block
  const float c = p.prescale_q ? LOG2E : p.scale * LOG2E;  // scores -> log2 domain
  // K2's dk carries the scale (scores = (q k^T) · scale); K5's q was scaled
  const float ks = p.prescale_q ? 1.f : p.scale;
  T* const DK = static_cast<T*>(p.dk) + b * p.st[BW_DK][0] + h * p.st[BW_DK][1];
  T* const DV = static_cast<T*>(p.dv) + b * p.st[BW_DV][0] + h * p.st[BW_DV][1];
  const long long sdk = p.st[BW_DK][2], sdv = p.st[BW_DV][2];
  int it = 0;
  for (int kb = kb0; kb < kb_end; ++kb) {
    const bool first = kb == kb0;
    const int k0 = kb * BKV;
    const bool kin0 = k0 + kr < N, kin1 = k0 + kr + 8 < N;  // keys past N: P = 0
    mbar_wait(kv_ready, (kb - kb0) & 1);
    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;

    for (int qb = 0; qb < nq; ++qb, ++it) {
      const int q0 = qb * BQ;
      // DKV_TMP: the step's dV and dK products (1: both in dvs, in turn)
      float dvs[HD / 2], dks[HD / 2];
      // FOLD: this step's quarter of the outputs, as its last fold left it
      const bool fold = TL::FOLD && qb + 1 < nq;
      float x[HD / 4];
      if constexpr (TL::FOLD) {
        if (fold && qb >= 4) {
          const int r0 = k0 + kr;
          switch (qb & 3) {
            case 0: load_quarter<HD, 0>(x, DV, sdv, r0, N, t); break;
            case 1: load_quarter<HD, 1>(x, DV, sdv, r0, N, t); break;
            case 2: load_quarter<HD, 2>(x, DK, sdk, r0, N, t); break;
            default: load_quarter<HD, 3>(x, DK, sdk, r0, N, t); break;
          }
        }
      }
      mbar_wait(ready_a, it & 1);
      // S^T = K Q^T and dP^T = V dO^T: 64 keys x BQ queries, HD / 8 k8 steps.
      // The accumulators live in this scope only and are copied out: with
      // the products' registers free once they are done, ptxas keeps the
      // later groups' wgmmas in flight (otherwise it serializes the bf16
      // instance's for want of registers, nvcc -Xptxas -v, C7511)
      float s[BQ / 2], dp[BQ / 2];
      {
        // f32: hi·hi in sa, da; lo·hi + hi·lo in se, de (F28)
        float sa[BQ / 2], da[BQ / 2], se[BQ / 2], de[BQ / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 8; ++kk) {
          const uint64_t ak = kdesc<BKV, HD>(sm + TL::K_, kk), bq = kdesc<BQ, HD>(sm + TL::Q_, kk);
          const uint64_t av = kdesc<BKV, HD>(sm + TL::V_, kk), bg = kdesc<BQ, HD>(sm + TL::G_, kk);
          if constexpr (LO) {
            wgmma_tf32_ss(se, ak + KLO, bq, kk);
            wgmma_tf32_ss(de, av + KLO, bg, kk);
            wgmma_tf32_ss(se, ak, bq + QLO, 1);
            wgmma_tf32_ss(de, av, bg + QLO, 1);
            wgmma_tf32_ss(sa, ak, bq, kk);
            wgmma_tf32_ss(da, av, bg, kk);
          } else {
            wgmma_tf32_ss(sa, ak, bq, kk);
            wgmma_tf32_ss(da, av, bg, kk);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sa);
        fence_regs(da);
        if constexpr (LO) {
          fence_regs(se);
          fence_regs(de);
        }
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) {
          if constexpr (LO) {
            s[i] = __fadd_rn(sa[i], se[i]);
            dp[i] = __fadd_rn(da[i], de[i]);
          } else {
            s[i] = sa[i];
            dp[i] = da[i];
          }
        }
      }

      // P^T = exp(S^T − LSE) (log2 domain); bf16: dP rounded to bf16
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool kin = e < 2 ? kin0 : kin1;
          s[4 * j + e] = kin ? exp2_approx(s[4 * j + e] * c - Ls[8 * j + 2 * t + (e & 1)]) : 0.f;
          if (!LO) dp[4 * j + e] = round_to<T>(dp[4 * j + e]);
        }

      // dS^T = P^T ∘ (dP^T − D), in dp
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - Ds[8 * j + 2 * t + (e & 1)]);
      __syncwarp();
      if (lane == 0) mbar_arrive(done_a);  // Q, dO, LSE, D are read

      // dS to shared memory, [BQ queries x 64 keys] split once, for dQ^T
      if constexpr (DQ) {
        bar_sync(1, 128);  // the last step's dQ^T products are done with dS
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int off = kmaj<BQ, BKV>(8 * j + 2 * t + (e & 1), kr + (e & 2) * 4);
            uint32_t hi, lo;
            tf32_split(dp[4 * j + e], hi, lo);
            *reinterpret_cast<uint32_t*>(sm + TL::S_ + off) = hi;
            *reinterpret_cast<uint32_t*>(sm + TL::S_ + TL::STILE + off) = lo;
          }
        fence_proxy_async();
      }

      // dV += P^T dO (bf16: P rounded to bf16, the forward's PV operand) and
      // dK += dS^T Q: A from the accumulators, B the K-major dO^T and Q^T
      {
        uint32_t ph[BQ / 8][4], pl[BQ / 8][4], sh[BQ / 8][4], sl[BQ / 8][4];
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          if (!LO) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[4 * j + e] = round_to<T>(s[4 * j + e]);
          }
          frag_of<!LO>(s + 4 * j, ph[j], pl[j]);
          frag_of<false>(dp + 4 * j, sh[j], sl[j]);
        }
        mbar_wait(ready_b, it & 1);
        if constexpr (TL::DKV_TMP == 2) {  // the step's dV and dK apart
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j) {
            const uint64_t bgt = kdesc<HD, BQ>(sm + TL::GT_, j);
            const uint64_t bqt = kdesc<HD, BQ>(sm + TL::QT_, j);
            wgmma_tf32_rs(dvs, pl[j], bgt, j);  // 0: the step's first product
            wgmma_tf32_rs(dks, sl[j], bqt, j);
            wgmma_tf32_rs(dvs, ph[j], bgt + QLO, 1);
            wgmma_tf32_rs(dks, sh[j], bqt + QLO, 1);
            wgmma_tf32_rs(dvs, ph[j], bgt, 1);
            wgmma_tf32_rs(dks, sh[j], bqt, 1);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dvs);
          fence_regs(dks);
        } else if constexpr (TL::DKV_TMP == 1) {  // the same, dV's then dK's, joined here
          step_sum<HD, BQ>(dvs, ph, pl, sm + TL::GT_, QLO);
#pragma unroll
          for (int i = 0; i < HD / 2; ++i) dv[i] = __fadd_rn(dv[i], dvs[i]);
          step_sum<HD, BQ>(dvs, sh, sl, sm + TL::QT_, QLO);
#pragma unroll
          for (int i = 0; i < HD / 2; ++i) dk[i] = __fadd_rn(dk[i], dvs[i]);
        } else {
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j) {
            const uint64_t bgt = kdesc<HD, BQ>(sm + TL::GT_, j);
            const uint64_t bqt = kdesc<HD, BQ>(sm + TL::QT_, j);
            if (LO) {
              wgmma_tf32_rs(dv, pl[j], bgt, 1);
              wgmma_tf32_rs(dk, sl[j], bqt, 1);
              wgmma_tf32_rs(dv, ph[j], bgt + QLO, 1);
              wgmma_tf32_rs(dk, sh[j], bqt + QLO, 1);
              wgmma_tf32_rs(dv, ph[j], bgt, 1);
              wgmma_tf32_rs(dk, sh[j], bqt, 1);
            } else {
              wgmma_tf32_rs(dv, ph[j], bgt, 1);
              wgmma_tf32_rs(dk, sl[j], bqt, 1);
              wgmma_tf32_rs(dk, sh[j], bqt, 1);
            }
          }
          wgmma_commit();
          wgmma_wait<0>();
        }
        fence_regs(dv);
        fence_regs(dk);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {  // the A fragments live until the wait
          fence_regs(ph[j]);
          if (LO) fence_regs(pl[j]);
          fence_regs(sh[j]);
          fence_regs(sl[j]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(done_b);  // Q^T, dO^T are read
      if constexpr (TL::FOLD) {
        if (fold) {  // quarter qb % 4 joins the outputs
          const int r0 = k0 + kr;
          switch (qb & 3) {
            case 0: fold_quarter<HD, 0>(dv, x, qb >= 4, DV, sdv, r0, N, t, 1.f); break;
            case 1: fold_quarter<HD, 1>(dv, x, qb >= 4, DV, sdv, r0, N, t, 1.f); break;
            case 2: fold_quarter<HD, 2>(dk, x, qb >= 4, DK, sdk, r0, N, t, ks); break;
            default: fold_quarter<HD, 3>(dk, x, qb >= 4, DK, sdk, r0, N, t, ks); break;
          }
        }
      }
      if constexpr (!DQ) continue;         // the split route's dQ kernel takes dQ
      bar_sync(1, 128);                    // every warp's dS is in shared memory

      // dQ^T = K^T dS^T: MQ x BQ queries over the block's 64 keys, as
      // products of 64 head-dim rows, issued in turns (the accumulators
      // scoped as S^T's); this key block's share of dQ then goes into its
      // group's slice: rows (queries) q0 + 8j + 2t (+1), columns (head dim)
      // 64m + kr (+8), those under HD, added to what the group's earlier
      // key blocks left there (loaded while the products run)
      float* part = p.dq_part + (kg * slice + rows) * HD;
      float dq[MQ / 64][BQ / 2];
      {
        float qa[MQ / 64][BQ / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKV / 8; ++kk)
#pragma unroll
          for (int m = 0; m < MQ / 64; ++m) {
            const uint64_t a = kdesc<HD, BKV>(sm + TL::KT_ + m * 64 * 128, kk);
            const uint64_t bs = kdesc<BQ, BKV>(sm + TL::S_, kk);
            if (LO) wgmma_tf32_ss(qa[m], a + KLO, bs, kk);
            wgmma_tf32_ss(qa[m], a, bs + SLO, LO || kk > 0);
            wgmma_tf32_ss(qa[m], a, bs, 1);
          }
        wgmma_commit();
#pragma unroll
        for (int m = 0; m < MQ / 64; ++m)
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int q = q0 + 8 * j + 2 * t + (e & 1), col = 64 * m + kr + (e & 2) * 4;
              dq[m][4 * j + e] = !first && q < N && (HD % 64 == 0 || col < HD)
                                     ? part[(long long)q * HD + col] : 0.f;
            }
        if constexpr (TL::DKV_TMP == 2) {  // the step's dV and dK join dv and dk
#pragma unroll
          for (int i = 0; i < HD / 2; ++i) {
            dv[i] = __fadd_rn(dv[i], dvs[i]);
            dk[i] = __fadd_rn(dk[i], dks[i]);
          }
        }
        wgmma_wait<0>();
#pragma unroll
        for (int m = 0; m < MQ / 64; ++m) {
          fence_regs(qa[m]);
#pragma unroll
          for (int i = 0; i < BQ / 2; ++i) dq[m][i] = first ? qa[m][i] : dq[m][i] + qa[m][i];
        }
      }
#pragma unroll
      for (int m = 0; m < MQ / 64; ++m)
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = q0 + 8 * j + 2 * t + (e & 1), col = 64 * m + kr + (e & 2) * 4;
            if (q < N && (HD % 64 == 0 || col < HD)) part[(long long)q * HD + col] = dq[m][4 * j + e];
          }
    }

    __syncwarp();
    if (lane == 0) mbar_arrive(kv_free);  // the key block's tiles are read
    // FOLD: the quarters folded before (c < nq - 1) add onto the outputs
    put_dkdv<HD>(DK, DV, sdk, sdv, k0 + kr, N, t, dk, dv, ks,
                 TL::FOLD ? (1 << min(nq - 1, 4)) - 1 : 0);
  }
}

// ---------------------------------------------------------------- the split route's dQ kernel

// The query-major dQ kernel's tiles (f32 operands, the split route: hd 128,
// where K, V and K^T would not fit a key-major block beside its query
// tiles): a block of one consumer warpgroup (64 query rows, 16 a warp),
// one split warpgroup and the producer's warpgroup. Q and dO [64 x HD] stay
// for the whole block, hi then lo; each step of BKS keys has its K, V
// [BKS x HD] and K^T [HD x BKS keys, each 8 stored 0 2 4 6 1 3 5 7] split
// into hi and lo; two landing stages of K and V as TMA writes them (rows of
// HD f32). At hd 128: 131,072 + 49,152 + 32,768 + barriers.
template <int HD>
struct BwqTile {
  static constexpr int BQM = 64, BKS = 16;   // queries a block, keys a step
  static constexpr int THREADS = 3 * 128;
  static constexpr int REGS_CONSUMER = 240, REGS_SPLIT = 168, REGS_PRODUCER = 40;
  static_assert(REGS_CONSUMER + REGS_SPLIT + REGS_PRODUCER <= 3 * 168,
                "setmaxnreg moves the launch's registers, no more");
  static constexpr int QTILE = BQM * HD * 4;  // Q, dO
  static constexpr int KTILE = BKS * HD * 4;  // K, V, K^T; one landed K or V
  static constexpr int Q_ = 0;
  static constexpr int G_ = Q_ + 2 * QTILE;
  static constexpr int K_ = G_ + 2 * QTILE;
  static constexpr int V_ = K_ + 2 * KTILE;
  static constexpr int KT_ = V_ + 2 * KTILE;
  static constexpr int LAND_ = KT_ + 2 * KTILE;
  static constexpr int STAGES = 2;
  static constexpr int BAR_ = LAND_ + STAGES * 2 * KTILE;
  static constexpr int NBAR = 2 * STAGES + 5;
  static constexpr int SMEM = BAR_ + NBAR * 8 + 1024;  // + alignment of the base to 1024
  // hd 128: 214,088
  static_assert(SMEM <= 232448, "a block's shared memory");
};

// dq of one block of 64 queries (head, batch), over every key in steps of
// BKS: it recomputes S = Q K^T and dP = dO V^T (hi·hi and the small
// products in accumulators of their own, two chains each), P = exp(S −
// LSE) and dS = P ∘ (dP − D) in registers, and adds dS K, whose A operand
// is dS's accumulator (RS) and whose B is the K-major K^T. Each step's dS K
// sums in an accumulator of its own and joins dq by an f32 add in
// registers (wgmma's sums round toward zero by a share of the accumulator,
// F27), so dq is written once, scaled, with no scratch slices and no pass
// over them. Warpgroup 0 runs the products, warpgroup 1 splits, thread 256
// issues the TMA loads of K and V.
template <int HD>
__global__ void __launch_bounds__(BwqTile<HD>::THREADS, 1)
    attn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap, AttnBwdArgs p,
                             int n_qb) {
  using TL = BwqTile<HD>;
  constexpr int BKS = TL::BKS;
  constexpr uint32_t QLO = TL::QTILE >> 4, KLO = TL::KTILE >> 4;
  extern __shared__ uint8_t bq_smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(bq_smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + TL::BAR_);  // a stage landed
  uint64_t* empty = full + TL::STAGES;                          // a stage read by the split
  uint64_t* q_ready = empty + TL::STAGES;                       // Q, dO split
  // a step's tiles go over in two halves, as the key-major kernel's: (a) K,
  // V, read by S and dP; (b) K^T, read by dS K
  uint64_t* ready_a = q_ready + 1;
  uint64_t* done_a = ready_a + 1;
  uint64_t* ready_b = done_a + 1;
  uint64_t* done_b = ready_b + 1;

  const int qb = blockIdx.x % n_qb;
  const int bh = blockIdx.x / n_qb;
  const int b = bh / p.H, h = bh % p.H;
  const int N = p.N;
  const int q0 = qb * TL::BQM;
  const int steps = cdiv(N, BKS);
  const long long rows = (long long)bh * N;  // this (batch, head)'s first row of LSE, D

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < TL::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_init(q_ready, 128);
    mbar_init(ready_a, 128);
    mbar_init(done_a, 4);
    mbar_init(ready_b, 128);
    mbar_init(done_b, 4);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // ---------------------------------------- producer
    regs_shrink<TL::REGS_PRODUCER>();
    if (threadIdx.x == 256) {
      tma_prefetch_map(&kmap);
      tma_prefetch_map(&vmap);
      for (int i = 0; i < steps; ++i) {
        const int s = i % TL::STAGES;
        if (i >= TL::STAGES) mbar_wait(&empty[s], (i / TL::STAGES - 1) & 1);
        uint8_t* land = sm + TL::LAND_ + s * 2 * TL::KTILE;
        mbar_arrive_expect_tx(&full[s], 2 * TL::KTILE);
        tma_load_4d(land, &kmap, &full[s], 0, i * BKS, h, b);
        tma_load_4d(land + TL::KTILE, &vmap, &full[s], 0, i * BKS, h, b);
      }
    }
    return;
  }

  if (threadIdx.x >= 128) {  // ---------------------------------------- split
    const int tid = threadIdx.x - 128;
    const bool pre = p.prescale_q != 0;
    // Q (K5: pre-scaled) and dO of the block's queries (zeros past N), hi
    // and lo, once
    const float* Qg = static_cast<const float*>(p.q) + b * p.st[BW_Q][0] + h * p.st[BW_Q][1];
    const float* Gg = static_cast<const float*>(p.dout) + b * p.st[BW_DO][0] + h * p.st[BW_DO][1];
    for (int i = tid; i < TL::BQM * HD / 4; i += 128) {
      const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
      if (q0 + r < N) {
        x = load4(Qg + (q0 + r) * p.st[BW_Q][2] + c);
        y = load4(Gg + (q0 + r) * p.st[BW_DO][2] + c);
      }
      if (pre) x = prescale4<float>(x, p.scale);
      const int off = kmaj<TL::BQM, HD>(r, c);
      put4<true>(sm + TL::Q_, TL::QTILE, off, x);
      put4<true>(sm + TL::G_, TL::QTILE, off, y);
    }
    fence_proxy_async();
    mbar_arrive(q_ready);
    for (int i = 0; i < steps; ++i) {
      const int s = i % TL::STAGES;
      mbar_wait(&full[s], (i / TL::STAGES) & 1);
      const float* lk = reinterpret_cast<const float*>(sm + TL::LAND_ + s * 2 * TL::KTILE);
      const float* lv = lk + BKS * HD;
      // half (a): K, V (keys past N landed as zeros)
      if (i > 0) mbar_wait(done_a, (i - 1) & 1);
      for (int j = tid; j < BKS * HD / 4; j += 128) {
        const int r = j / (HD / 4), c = (j % (HD / 4)) * 4, off = kmaj<BKS, HD>(r, c);
        put4<true>(sm + TL::K_, TL::KTILE, off, load4(lk + r * HD + c));
        put4<true>(sm + TL::V_, TL::KTILE, off, load4(lv + r * HD + c));
      }
      fence_proxy_async();
      mbar_arrive(ready_a);
      // half (b): K^T; item (c, d) is head-dim row d, slots 4c..4c+3, keys
      // 8(c / 2) + c % 2 + {0, 2, 4, 6}
      if (i > 0) mbar_wait(done_b, (i - 1) & 1);
      for (int j = tid; j < HD * BKS / 4; j += 128) {
        const int d = j % HD, c = j / HD;
        const int r = 8 * (c >> 1) + (c & 1);
        const float4 x = make_float4(lk[r * HD + d], lk[(r + 2) * HD + d], lk[(r + 4) * HD + d],
                                     lk[(r + 6) * HD + d]);
        put4<true>(sm + TL::KT_, TL::KTILE, kmaj<HD, BKS>(d, 4 * c), x);
      }
      mbar_arrive(&empty[s]);  // the landed stage is read
      fence_proxy_async();
      mbar_arrive(ready_b);
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  regs_grow<TL::REGS_CONSUMER>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this thread's query rows
  const float c = p.prescale_q ? LOG2E : p.scale * LOG2E;  // scores -> log2 domain
  // rows past N: LSE +inf, so P = 0
  const float ls0 = r0 < N ? p.lse[rows + r0] * LOG2E : INFINITY;
  const float ls1 = r1 < N ? p.lse[rows + r1] * LOG2E : INFINITY;
  const float dd0 = r0 < N ? p.delta[rows + r0] : 0.f;  // D = rowsum(dO ∘ O)
  const float dd1 = r1 < N ? p.delta[rows + r1] : 0.f;
  float dq[HD / 2], part[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = part[i] = 0.f;
  mbar_wait(q_ready, 0);

  for (int i = 0; i < steps; ++i) {
    const int k0 = i * BKS;
    mbar_wait(ready_a, i & 1);
    // S = Q K^T and dP = dO V^T: 64 queries x BKS keys, HD / 8 k8 steps;
    // hi·hi and the small products in accumulators of their own
    float s[BKS / 2], dp[BKS / 2];
    {
      float sa[BKS / 2], se[BKS / 2], da[BKS / 2], de[BKS / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        const uint64_t aq = kdesc<TL::BQM, HD>(sm + TL::Q_, kk), bk = kdesc<BKS, HD>(sm + TL::K_, kk);
        const uint64_t ag = kdesc<TL::BQM, HD>(sm + TL::G_, kk), bv = kdesc<BKS, HD>(sm + TL::V_, kk);
        wgmma_tf32_ss(se, aq + QLO, bk, kk);
        wgmma_tf32_ss(de, ag + QLO, bv, kk);
        wgmma_tf32_ss(se, aq, bk + KLO, 1);
        wgmma_tf32_ss(de, ag, bv + KLO, 1);
        wgmma_tf32_ss(sa, aq, bk, kk);
        wgmma_tf32_ss(da, ag, bv, kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sa);
      fence_regs(se);
      fence_regs(da);
      fence_regs(de);
#pragma unroll
      for (int j = 0; j < BKS / 2; ++j) {
        s[j] = __fadd_rn(sa[j], se[j]);
        dp[j] = __fadd_rn(da[j], de[j]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(done_a);  // K, V are read

    // P = exp(S − LSE) (log2 domain), keys past N 0; dS = P ∘ (dP − D)
#pragma unroll
    for (int j = 0; j < BKS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * j + e;
        const bool kin = k0 + 8 * j + 2 * t + (e & 1) < N;
        const float pv = kin ? exp2_approx(s[x] * c - (e < 2 ? ls0 : ls1)) : 0.f;
        dp[x] = pv * (dp[x] - (e < 2 ? dd0 : dd1));
      }

    // dS K: A from dS's accumulator (k8 step j: keys 8j + 2t as column t,
    // 8j + 2t + 1 as t + 4, the order K^T stores), B the K-major K^T
    {
      uint32_t sh[BKS / 8][4], sl[BKS / 8][4];
#pragma unroll
      for (int j = 0; j < BKS / 8; ++j) frag_of<false>(dp + 4 * j, sh[j], sl[j]);
      mbar_wait(ready_b, i & 1);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BKS / 8; ++j) {
        const uint64_t bkt = kdesc<HD, BKS>(sm + TL::KT_, j);
        wgmma_tf32_rs(part, sl[j], bkt, j);  // 0: the step's first product
        wgmma_tf32_rs(part, sh[j], bkt + KLO, 1);
        wgmma_tf32_rs(part, sh[j], bkt, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int j = 0; j < BKS / 8; ++j) {  // the A fragments live until the wait
        fence_regs(sh[j]);
        fence_regs(sl[j]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(done_b);  // K^T is read
#pragma unroll
    for (int x = 0; x < HD / 2; ++x) dq[x] = __fadd_rn(dq[x], part[x]);
  }

  // K2: dq = (dS K) · scale; K5: round(dS K) · scale, the same in f32
  float* DQ = static_cast<float*>(p.dq) + b * p.st[BW_DQ][0] + h * p.st[BW_DQ][1];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int col = 8 * n + 2 * t;
    if (r0 < N)
      store2(DQ + r0 * p.st[BW_DQ][2] + col, __fmul_rn(dq[4 * n], p.scale),
             __fmul_rn(dq[4 * n + 1], p.scale));
    if (r1 < N)
      store2(DQ + r1 * p.st[BW_DQ][2] + col, __fmul_rn(dq[4 * n + 2], p.scale),
             __fmul_rn(dq[4 * n + 3], p.scale));
  }
}

// ---------------------------------------------------------------- bf16's D pass

// bf16's D pass on wgmma: D = rowsum(P ∘ round(dP)) needs only S^T and
// dP^T, whose operands are all bf16 inputs, so it multiplies them as they
// land: bf16 wgmma (exact products, f32 sums, as the tf32 products of the
// same values) on K, V, Q and dO tiles that TMA writes with the swizzle the
// descriptors name, no split warpgroup: each row of HD bf16 in panels of SW
// bytes, the largest TMA swizzle that divides it (as the forward's bf16
// tiles, FaTile: one panel up to hd 64, two of 128 bytes at hd 128, five of
// 32 bytes at hd 80), a TMA box each. K5's q is pre-scaled and rounded in
// place in its landed tile. One consumer warpgroup and a producer warp;
// 52 KB of shared memory at hd 64, so that several blocks share an SM.
template <int HD>
struct DeltaTile {
  static constexpr int BKV = 64, BQ = 32, STAGES = 4;
  static constexpr int THREADS = 128 + 32;
  static constexpr int SW = (HD * 2) % 128 == 0 ? 128 : ((HD * 2) % 64 == 0 ? 64 : 32);
  static constexpr int BOX = SW / 2;  // head-dim columns per TMA box (panel)
  static constexpr int PANELS = HD / BOX;
  static constexpr int KTILE = BKV * HD * 2, QTILE = BQ * HD * 2;
  static constexpr int K_ = 0, V_ = KTILE, LAND_ = 2 * KTILE;
  static constexpr int W_ = LAND_ + STAGES * 2 * QTILE;  // the warps' shares [2][4][BQ]
  static constexpr int BAR_ = W_ + 8 * BQ * 4;
  static constexpr int SMEM = BAR_ + (2 * STAGES + 2) * 8 + 1024;
};

// The descriptor of k16 step kk (32 bytes along K) of such a tile of R rows
template <int R, int SW>
__device__ __forceinline__ uint64_t pdesc(const uint8_t* tile, int kk) {
  const int off = kk * 32;
  return smem_desc<SW>(tile + (off / SW) * (R * SW) + off % SW, 16, 8 * SW);
}

template <int HD>
__global__ void __launch_bounds__(DeltaTile<HD>::THREADS, 3)
    attn_bwd_delta_kernel(const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap gmap, AttnBwdArgs p, int n_kb,
                          int per, int n_slices) {
  using TL = DeltaTile<HD>;
  constexpr int BKV = TL::BKV, BQ = TL::BQ;
  extern __shared__ uint8_t dl_smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(dl_smem_raw) + 1023) & ~uintptr_t(1023));
  float* Dw = reinterpret_cast<float*>(sm + TL::W_);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + TL::BAR_);  // a stage landed
  uint64_t* empty = full + TL::STAGES;                          // a stage read
  uint64_t* kv_full = empty + TL::STAGES;                       // K and V landed
  uint64_t* kv_free = kv_full + 1;                              // K and V read

  const int kg = blockIdx.x % n_slices;  // the key group: its scratch slice
  const int bh = blockIdx.x / n_slices;
  const int b = bh / p.H, h = bh % p.H;
  const int N = p.N;
  const int nq = cdiv(N, BQ);
  const int kb0 = kg * per, kb_end = min(kb0 + per, n_kb);
  const long long rows = (long long)bh * N;
  const long long slice = (long long)p.B * p.H * N;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < TL::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_init(kv_full, 1);
    mbar_init(kv_free, 4);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // ---------------------------------------- producer
    if (threadIdx.x == 128) {
      tma_prefetch_map(&qmap);
      tma_prefetch_map(&gmap);
      int it = 0;
      for (int kb = kb0; kb < kb_end; ++kb) {
        if (kb > kb0) mbar_wait(kv_free, (kb - kb0 - 1) & 1);
        mbar_arrive_expect_tx(kv_full, 2 * TL::KTILE);
        for (int pn = 0; pn < TL::PANELS; ++pn) {
          const int at = pn * BKV * TL::SW;
          tma_load_4d(sm + TL::K_ + at, &kmap, kv_full, pn * TL::BOX, kb * BKV, h, b);
          tma_load_4d(sm + TL::V_ + at, &vmap, kv_full, pn * TL::BOX, kb * BKV, h, b);
        }
        for (int qb = 0; qb < nq; ++qb, ++it) {
          const int s = it % TL::STAGES;
          if (it >= TL::STAGES) mbar_wait(&empty[s], (it / TL::STAGES - 1) & 1);
          uint8_t* land = sm + TL::LAND_ + s * 2 * TL::QTILE;
          mbar_arrive_expect_tx(&full[s], 2 * TL::QTILE);
          for (int pn = 0; pn < TL::PANELS; ++pn) {
            const int at = pn * BQ * TL::SW;
            tma_load_4d(land + at, &qmap, &full[s], pn * TL::BOX, qb * BQ, h, b);
            tma_load_4d(land + TL::QTILE + at, &gmap, &full[s], pn * TL::BOX, qb * BQ, h, b);
          }
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kr = warp * 16 + g;  // this thread's key rows kr, kr + 8 of the block
  const float c = p.prescale_q ? LOG2E : p.scale * LOG2E;  // scores -> log2 domain
  int it = 0;
  for (int kb = kb0; kb < kb_end; ++kb) {
    const bool first = kb == kb0;
    const int k0 = kb * BKV;
    const bool kin0 = k0 + kr < N, kin1 = k0 + kr + 8 < N;  // keys past N: P = 0
    mbar_wait(kv_full, (kb - kb0) & 1);
    for (int qb = 0; qb < nq; ++qb, ++it) {
      const int s = it % TL::STAGES, q0 = qb * BQ;
      // LSE · log2 e of this thread's queries 8j + 2t (+1); rows past N +inf
      float ls[BQ / 4];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = q0 + 8 * j + 2 * t + e;
          ls[2 * j + e] = q < N ? p.lse[rows + q] * LOG2E : INFINITY;
        }
      mbar_wait(&full[s], (it / TL::STAGES) & 1);
      uint8_t* lq = sm + TL::LAND_ + s * 2 * TL::QTILE;
      if (p.prescale_q) {  // K5: q · scale in f32, rounded to bf16, in place
        uint32_t* w = reinterpret_cast<uint32_t*>(lq);
        for (int i = threadIdx.x; i < TL::QTILE / 4; i += 128) {
          const float2 x = unpack_bf16(w[i]);
          w[i] = pack_bf16(__fmul_rn(x.x, p.scale), __fmul_rn(x.y, p.scale));
        }
        fence_proxy_async();
        bar_sync(1, 128);
      }
      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 32 queries, HD / 16 k16 steps
      float sc[BQ / 2], dc[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wgmma_bf16_ss(sc, pdesc<BKV, TL::SW>(sm + TL::K_, kk), pdesc<BQ, TL::SW>(lq, kk), kk);
        wgmma_bf16_ss(dc, pdesc<BKV, TL::SW>(sm + TL::V_, kk),
                      pdesc<BQ, TL::SW>(lq + TL::QTILE, kk), kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
      // P^T = exp(S^T − LSE), dP rounded to bf16; this key block's share of
      // D = rowsum(P ∘ dP), the warps' in order
      float x[BQ / 2];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const bool kin = e < 2 ? kin0 : kin1;
          const float pv = kin ? exp2_approx(sc[i] * c - ls[2 * j + (e & 1)]) : 0.f;
          x[i] = pv * round_to<bf16>(dc[i]);
        }
      float* share = Dw + (it & 1) * 4 * BQ;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float y = sum_over_g(x[4 * j + e] + x[4 * j + e + 2]);
          if (g == 0) share[warp * BQ + 8 * j + 2 * t + e] = y;
        }
      bar_sync(1, 128);
      if (threadIdx.x < BQ && q0 + static_cast<int>(threadIdx.x) < N) {
        const int i = threadIdx.x;
        float* d = p.delta + kg * slice + rows + q0 + i;
        const float y = ((share[i] + share[BQ + i]) + share[2 * BQ + i]) + share[3 * BQ + i];
        *d = first ? y : *d + y;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(kv_free);  // the key block's K and V are read
  }
}

// dq from the slices (attn_bwd_dq_kernel), after the gradients' pass
template <int HD, typename T>
cudaError_t launch_attention_bwd_dq(const AttnBwdArgs& p, int n_slices, cudaStream_t st) {
  const long long pairs = (long long)p.B * p.H * p.N * HD / 2;
  attn_bwd_dq_kernel<T><<<static_cast<unsigned>((pairs + 255) / 256), 256, 0, st>>>(p, HD,
                                                                                    n_slices);
  return cudaGetLastError();
}

// The split route's dQ kernel: TMA maps of k and v, boxes of BKS rows of
// hd, no swizzle, into the landing stages; a block per 64 queries
template <int HD>
cudaError_t launch_attention_bwd_dq_wgmma(const AttnBwdArgs& p, cudaStream_t st) {
  using TQ = BwqTile<HD>;
  constexpr auto F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  AttnArgs a;
  a.B = p.B;
  a.H = p.H;
  a.N = p.N;
  CUtensorMap kmap, vmap;
  cudaError_t e = attention_map<HD>(&kmap, p.k, a, p.st[BW_K][0], p.st[BW_K][1], p.st[BW_K][2],
                                    F32, 4, HD, TQ::BKS, 0);
  if (e == cudaSuccess)
    e = attention_map<HD>(&vmap, p.v, a, p.st[BW_V][0], p.st[BW_V][1], p.st[BW_V][2], F32, 4, HD,
                          TQ::BKS, 0);
  if (e != cudaSuccess) return e;
  auto kernel = attn_bwd_dq_wgmma_kernel<HD>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TQ::SMEM);
  if (e != cudaSuccess) return e;
  const int n_qb = cdiv(p.N, TQ::BQM);
  kernel<<<static_cast<unsigned>(p.B * p.H * n_qb), TQ::THREADS, TQ::SMEM, st>>>(kmap, vmap, p,
                                                                                n_qb);
  return cudaGetLastError();
}

// The wgmma kernel: TMA maps of q and dO over their strided [B, H, N, hd]
// views, boxes of BQ rows (rows past N land as zeros): of hd, no swizzle,
// into the landing stages; or (in place) of one panel, swizzled as the
// tiles' panels. Without DQ (the split route) the query-major kernel
// writes dq after it, and the scratch slices of dq are not used.
template <int HD, typename T, bool DQ = true>
cudaError_t launch_attention_bwd_wgmma(const AttnBwdArgs& p, cudaStream_t st) {
  constexpr bool LO = std::is_same_v<T, float>;
  using TL = BwgTile<HD, LO, DQ>;
  static_assert(TL::BKV == BWD_KEYS, "attention_bwd_slices counts blocks of BWD_KEYS keys");
  constexpr auto type = LO ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  AttnArgs a;
  a.B = p.B;
  a.H = p.H;
  a.N = p.N;
  constexpr int SW = TL::IN_PLACE ? kmaj_sw<HD> : 0, BOX = TL::IN_PLACE ? SW / 4 : HD;
  CUtensorMap qmap, gmap;
  cudaError_t e = attention_map<HD>(&qmap, p.q, a, p.st[BW_Q][0], p.st[BW_Q][1], p.st[BW_Q][2],
                                    type, sizeof(T), BOX, TL::BQ, SW);
  if (e == cudaSuccess)
    e = attention_map<HD>(&gmap, p.dout, a, p.st[BW_DO][0], p.st[BW_DO][1], p.st[BW_DO][2], type,
                          sizeof(T), BOX, TL::BQ, SW);
  if (e != cudaSuccess) return e;
  const long long rows = (long long)p.B * p.H * p.N;
  const int n_kb = cdiv(p.N, TL::BKV);
  const int per = attention_bwd_group(p.B, p.H, p.N);
  const int n_slices = cdiv(n_kb, per);
  const unsigned grid = static_cast<unsigned>(p.B * p.H * n_slices);
  if constexpr (LO) {
    attn_bwd_dot_kernel<<<static_cast<unsigned>((rows + 31) / 32), 256, 0, st>>>(p, HD);
  } else {  // D's pass on the inputs as they land: bf16 tiles, 128-byte swizzled
    using DL = DeltaTile<HD>;
    constexpr auto BF = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    CUtensorMap kmap, vmap, qsw, gsw;
    e = attention_map<HD>(&kmap, p.k, a, p.st[BW_K][0], p.st[BW_K][1], p.st[BW_K][2], BF, 2,
                          DL::BOX, DL::BKV, DL::SW);
    if (e == cudaSuccess)
      e = attention_map<HD>(&vmap, p.v, a, p.st[BW_V][0], p.st[BW_V][1], p.st[BW_V][2], BF, 2,
                            DL::BOX, DL::BKV, DL::SW);
    if (e == cudaSuccess)
      e = attention_map<HD>(&qsw, p.q, a, p.st[BW_Q][0], p.st[BW_Q][1], p.st[BW_Q][2], BF, 2,
                            DL::BOX, DL::BQ, DL::SW);
    if (e == cudaSuccess)
      e = attention_map<HD>(&gsw, p.dout, a, p.st[BW_DO][0], p.st[BW_DO][1], p.st[BW_DO][2], BF,
                            2, DL::BOX, DL::BQ, DL::SW);
    if (e != cudaSuccess) return e;
    auto delta = attn_bwd_delta_kernel<HD>;
    e = cudaFuncSetAttribute(delta, cudaFuncAttributeMaxDynamicSharedMemorySize, DL::SMEM);
    if (e != cudaSuccess) return e;
    delta<<<grid, DL::THREADS, DL::SMEM, st>>>(kmap, vmap, qsw, gsw, p, n_kb, per, n_slices);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto grads = attn_bwd_wgmma_kernel<HD, T, DQ>;
  e = cudaFuncSetAttribute(grads, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
  if (e != cudaSuccess) return e;
  grads<<<grid, TL::THREADS, TL::SMEM, st>>>(qmap, gmap, p, n_kb, per, n_slices);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if constexpr (DQ)
    return launch_attention_bwd_dq<HD, T>(p, n_slices, st);
  else
    return launch_attention_bwd_dq_wgmma<HD>(p, st);
}

// the route table's kernels for (HD, T)
template <int HD, typename T>
cudaError_t launch_attention_bwd_hd(const AttnBwdArgs& p, cudaStream_t st) {
  constexpr int dt = std::is_same_v<T, float> ? DT_F32 : DT_BF16;
  if constexpr (attention_bwd_route(HD, dt) == BWD_WGMMA) {
    return launch_attention_bwd_wgmma<HD, T>(p, st);
  } else {
    static_assert(std::is_same_v<T, float>, "the split route is f32's");
    return launch_attention_bwd_wgmma<HD, T, false>(p, st);
  }
}

template <typename T>
cudaError_t launch_attention_bwd_t(const AttnBwdArgs& p, int hd, cudaStream_t st) {
  switch (hd) {
    case 16: return launch_attention_bwd_hd<16, T>(p, st);
    case 32: return launch_attention_bwd_hd<32, T>(p, st);
    case 64: return launch_attention_bwd_hd<64, T>(p, st);
    case 80: return launch_attention_bwd_hd<80, T>(p, st);
    case 128: return launch_attention_bwd_hd<128, T>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch the backward (the wrappers check shapes, strides and head dims,
// and allocate the scratch for attention_bwd_slices(B, H, N) slices);
// `route` is the kernel the caller counts the launch under, which must be
// the table's (attention_bwd_route).
static inline cudaError_t launch_attention_bwd(const AttnBwdArgs& p, int dtype, int hd, int route,
                                               cudaStream_t st) {
  if (route != attention_bwd_route(hd, dtype)) return cudaErrorInvalidValue;
  if (p.B * p.H == 0 || p.N == 0) return cudaSuccess;
  if (dtype == DT_F32) return launch_attention_bwd_t<float>(p, hd, st);
  if (dtype == DT_BF16) return launch_attention_bwd_t<bf16>(p, hd, st);
  return cudaErrorInvalidValue;
}

}  // namespace anyloc
