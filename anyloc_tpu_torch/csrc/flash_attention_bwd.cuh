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
// The design is FlashAttention-2's: a block of four warps per (key group,
// head, batch) takes the group's key blocks of 64 in turn; for each it holds
// K_j and V_j in shared memory and dK_j, dV_j in registers (each warp 16
// keys; a warp whose keys all lie past N idles), and walks the query blocks
// of 32 rows: it loads Q_i, dO_i, LSE_i and
// D_i, recomputes S^T = K_j Q_i^T and P^T = exp(S^T − LSE) in registers,
// dP^T = V_j dO_i^T, dS^T = P^T ∘ (dP^T − D), adds P^T dO_i to dV and
// dS^T Q_i to dK (A from the S^T accumulators, rows = keys), writes dS^T
// to shared memory, and adds dS K_j, this key block's share of dQ_i, to
// its group's f32 slice (each thread to the same elements, in key order);
// a last pass sums the slices in a fixed order, scales and rounds dq to
// q's dtype. No atomics: every gradient is reproducible bit for bit
// (chip_smoke.py prints two calls' largest difference), which the training
// checks that hold one step against two others rely on. The slices cost
// 4·S·B·H·N·hd bytes with S = attention_bwd_slices: one slice per key
// block up to four (58 MB at [48, 6, 197, 64]), and at most four beyond
// (0.81 GB at [48, 12, 1370, 64], where one slice per key block would
// take 4.4 GB): O(N), as flash attention's memory should be. Only a B·H
// under BWD_MIN_GRID / 4 keeps more slices, to fill the card.
// The products are warp-level mma.sync m16n8k8 tf32, not wgmma: tf32
// wgmma has no transpose bit, and three of the five products read an
// operand transposed (dO^T, Q^T, K^T), so a wgmma design must store split
// (hi, lo) transposed copies of seven tiles, 224 KB at hd 64 and more than
// a block's 227 KB above it; mma.sync reads its fragments from one copy of
// each tile in any orientation (S^T's and dP^T's by ldmatrix), so every
// head dim (16, 32, 64, 80, 128) runs, in 33-140 KB of shared memory.
// f32 splits (hopper.cuh's tf32_split) Q and dO once a step into hi and lo
// tiles, which all four warps read for two products each; K, V and dS are
// split in registers where read. Tiles are f32 rows of a multiple of 32
// floats, columns XOR-swizzled per row (swz) so that every fragment read
// below is free of bank conflicts. In development runs on the H100, 64-query
// steps and volatile mma were no faster, and removing any one of the three
// product phases saved only 15-25 % of the kernel: it is bound by fragment
// reads and splits, not by the tensor cores (PERF.md, open questions).
//
// D = rowsum(P ∘ dP), the softmax backward's row term. f32: D =
// rowsum(dO ∘ O) (equal in exact arithmetic; attn_bwd_dot_kernel). bf16
// mirrors the rounding points of the plain version's autograd
// (flash_attention_ref, attn_proj.py's _attention_ref):
//   * dP = dO V^T in f32, rounded to bf16 (the backward of .float() on
//     the bf16 P);
//   * D = rowsum(P ∘ dP) on the f32 P and that rounded dP, in a first pass
//     of the same kernel (DELTA: each key block's share in its slice,
//     summed in order by the second), since O came from the rounded P;
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

namespace {

// LO (f32 operands): Q and dO are split once per step into tf32 hi and lo
// tiles, which every warp reads for two products, instead of each warp
// splitting each value it reads
template <int HD, bool LO>
struct BwdTile {
  static constexpr int BKV = 64;                   // keys per block, 16 per warp
  static constexpr int BQ = 32;                    // queries per step
  static constexpr int LDH = (HD + 31) / 32 * 32;  // floats per row of an hd-wide tile
  static constexpr int THREADS = 128;
  // blocks per SM the registers are cut for (chip runs: three at hd 32-64,
  // four at hd 16; at hd 80 and 128 a cut spills)
  static constexpr int MIN_BLOCKS = HD == 16 ? 4 : (HD <= 64 ? 3 : 1);
  // K, V [BKV][LDH]; Q, dO (and their lo) [BQ][LDH]; dS^T [BKV][BQ]; LSE and D [BQ]
  static constexpr int SMEM = 4 * ((2 * BKV + (LO ? 4 : 2) * BQ) * LDH + BKV * BQ + 2 * BQ);
};

// Column c of row r of a tile is stored at column swz(r, c): bits 2-4 of c
// XORed with a mask of r's low three bits, a bijection inside each 32-float
// chunk that keeps four neighbours together (float4 stores) and makes the
// fragment reads conflict-free: rows g = 0..7 by columns t = 0..3 (A
// fragments, K-major B fragments), rows t by columns g (B read along its
// rows) and rows 2t, 2t + 1 by columns g (the B operands of dV and dK).
__device__ __forceinline__ int swz(int r, int c) {
  return c ^ ((((r ^ (r >> 2)) & 1) << 3) | ((r & 2) << 3) | ((r & 1) << 2));
}

template <int LD>
__device__ __forceinline__ float tile_at(const float* x, int r, int c) {
  return x[r * LD + swz(r, c)];
}

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

// Rows row0 .. row0 + rows - 1 of a [N, HD] operand (row stride sn
// elements) into a swizzled f32 tile; rows past N as zeros. With lo, the
// tile gets each value's tf32 hi (hopper.cuh's tf32_split) and lo its lo.
template <typename T, int HD, int LD>
__device__ __forceinline__ void load_tile(float* tile, float* lo, const T* src, long long sn,
                                          int row0, int rows, int N, bool pre, float scale) {
  for (int i = threadIdx.x; i < rows * HD / 4; i += 128) {
    const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < N) {
      x = load4(src + (row0 + r) * sn + c);
      if (pre) {
        x.x = prescale<T>(x.x, scale);
        x.y = prescale<T>(x.y, scale);
        x.z = prescale<T>(x.z, scale);
        x.w = prescale<T>(x.w, scale);
      }
    }
    const int at = r * LD + swz(r, c);
    if (lo != nullptr) {
      uint4 h, l;
      tf32_split(x.x, h.x, l.x);
      tf32_split(x.y, h.y, l.y);
      tf32_split(x.z, h.z, l.z);
      tf32_split(x.w, h.w, l.w);
      *reinterpret_cast<uint4*>(tile + at) = h;
      *reinterpret_cast<uint4*>(lo + at) = l;
    } else {
      *reinterpret_cast<float4*>(tile + at) = x;
    }
  }
}

// mma.m16n8k8 tf32 fragments, split for 3xTF32 (hopper.cuh's tf32_split):
// EXACT operands (bf16 data, exact in tf32) keep their value as hi and have
// no lo product.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

template <bool EXACT>
__device__ __forceinline__ FragA split_a(float a0, float a1, float a2, float a3) {
  FragA f;
  const float a[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (EXACT) {
      f.hi[i] = __float_as_uint(a[i]);
      f.lo[i] = 0u;
    } else {
      tf32_split(a[i], f.hi[i], f.lo[i]);
    }
  }
  return f;
}

template <bool EXACT>
__device__ __forceinline__ FragB split_b(float b0, float b1) {
  FragB f;
  if (EXACT) {
    f.hi[0] = __float_as_uint(b0);
    f.hi[1] = __float_as_uint(b1);
    f.lo[0] = f.lo[1] = 0u;
  } else {
    tf32_split(b0, f.hi[0], f.lo[0]);
    tf32_split(b1, f.hi[1], f.lo[1]);
  }
  return f;
}

// d (16 x 8, f32) += a (16 x 8 tf32) * b (8 x 8 tf32). Fragments (g = lane
// / 4, t = lane % 4): a {(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)},
// b {(t, g), (t + 4, g)}, d {(g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8,
// 2t + 1)}. Not volatile: its only effect is d, so the compiler may
// interleave independent products, whose sums otherwise wait on each other.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ldmatrix.x4: lane l gives the row address of 8x8 b16 matrix l / 8 (one
// row of 16 bytes: four f32 values) and receives word (l / 4, l % 4) of
// each matrix, the layout of an m16n8k8 tf32 fragment's 8 x 4 pieces
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const float* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// The A fragment of rows r0..r0+15, columns c0..c0+7 (c0 % 8 == 0) of a
// row-major tile, split (EX: exact)
template <bool EX, int LD>
__device__ __forceinline__ FragA ld_frag_a(const float* x, int r0, int c0) {
  const int lane = threadIdx.x & 31, i = lane >> 3;
  const int r = r0 + (lane & 7) + ((i & 1) << 3), c = c0 + ((i & 2) << 1);
  uint32_t v[4];
  ldmatrix_x4(v, x + r * LD + swz(r, c));
  return split_a<EX>(__uint_as_float(v[0]), __uint_as_float(v[1]), __uint_as_float(v[2]),
                     __uint_as_float(v[3]));
}

// The B fragment B[k][n] = X[n][k] of rows n0..n0+7, columns c0..c0+7 of
// a split tile (hi, lo; EX: exact, lo not read)
template <bool EX, int LD>
__device__ __forceinline__ FragB ld_frag_b(const float* hi, const float* lo, int n0, int c0) {
  const int lane = threadIdx.x & 31, i = lane >> 3;
  const int r = n0 + (lane & 7), c = c0 + ((i & 1) << 2);
  uint32_t v[4];
  ldmatrix_x4(v, ((EX || i < 2) ? hi : lo) + r * LD + swz(r, c));
  FragB f;
  f.hi[0] = v[0];
  f.hi[1] = v[1];
  f.lo[0] = EX ? 0u : v[2];
  f.lo[1] = EX ? 0u : v[3];
  return f;
}

// A B fragment from a tile already split (hi, lo; EX: exact, no lo):
// values (r0, c0) and (r1, c1)
template <bool EX, int LD>
__device__ __forceinline__ FragB tile_b(const float* hi, const float* lo, int r0, int c0, int r1,
                                        int c1) {
  FragB f;
  f.hi[0] = __float_as_uint(tile_at<LD>(hi, r0, c0));
  f.hi[1] = __float_as_uint(tile_at<LD>(hi, r1, c1));
  f.lo[0] = EX ? 0u : __float_as_uint(tile_at<LD>(lo, r0, c0));
  f.lo[1] = EX ? 0u : __float_as_uint(tile_at<LD>(lo, r1, c1));
  return f;
}

// 3xTF32: lo·hi + hi·lo + hi·hi, less the products of an exact operand's lo
template <bool EA, bool EB>
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  if (!EA) mma_tf32(d, a.lo, b.hi);
  if (!EB) mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// The same for two independent products, d += a·b and e += c·f, issued in
// turns (lo·hi, hi·lo, hi·hi of each), less the products of an exact
// operand's lo (EA, EB: a's and b's; EC, EF: c's and f's)
template <bool EA, bool EB, bool EC, bool EF>
__device__ __forceinline__ void mma3x2(float (&d)[4], const FragA& a, const FragB& b,
                                       float (&e)[4], const FragA& c, const FragB& f) {
  if (!EA) mma_tf32(d, a.lo, b.hi);
  if (!EC) mma_tf32(e, c.lo, f.hi);
  if (!EB) mma_tf32(d, a.hi, b.lo);
  if (!EF) mma_tf32(e, c.hi, f.lo);
  mma_tf32(d, a.hi, b.hi);
  mma_tf32(e, c.hi, f.hi);
}

// (x, y) into two f32 of a scratch slice, or added to what they hold
__device__ __forceinline__ void add_or_store(float* at, float x, float y, bool store) {
  float2* p = reinterpret_cast<float2*>(at);
  if (!store) {
    const float2 a = *p;
    x = a.x + x;
    y = a.y + y;
  }
  *p = make_float2(x, y);
}

__device__ __forceinline__ float sum_over_g(float x) {  // the 8 lanes of one t
  x += __shfl_xor_sync(0xffffffff, x, 4);
  x += __shfl_xor_sync(0xffffffff, x, 8);
  return x + __shfl_xor_sync(0xffffffff, x, 16);
}

// One block per (group of `per` consecutive key blocks, head, batch), which
// takes its key blocks in turn; DELTA: only D's pass (bf16).
template <int HD, typename T, bool DELTA>
__global__ void __launch_bounds__(128, (BwdTile<HD, std::is_same_v<T, float>>::MIN_BLOCKS))
    attn_bwd_kernel(AttnBwdArgs p, int n_kb, int per, int n_slices) {
  constexpr bool EX = !std::is_same_v<T, float>;  // the inputs are exact in tf32
  using TL = BwdTile<HD, !EX>;
  constexpr int BKV = TL::BKV, BQ = TL::BQ, LD = TL::LDH;
  extern __shared__ float4 bw_smem4[];
  float* Ks = reinterpret_cast<float*>(bw_smem4);
  float* Vs = Ks + BKV * LD;
  float* Qs = Vs + BKV * LD;  // f32: Q's and dO's tf32 hi, then their lo
  float* Gs = Qs + BQ * LD;   // dO
  float* Ql = EX ? nullptr : Gs + BQ * LD;
  float* Gl = EX ? nullptr : Ql + BQ * LD;
  float* Ss = Gs + (EX ? 1 : 3) * BQ * LD;  // dS^T [BKV][BQ]
  float* Ls = Ss + BKV * BQ;  // LSE · log2 e per query row
  float* Ds = Ls + BQ;        // D per query row

  const int kg = blockIdx.x % n_slices;  // the key group: its scratch slice
  const int bh = blockIdx.x / n_slices;
  const int b = bh / p.H, h = bh % p.H;
  const int N = p.N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kr = warp * 16 + g;  // this thread's key rows kr, kr + 8 of the block

  const T* Qg = static_cast<const T*>(p.q) + b * p.st[BW_Q][0] + h * p.st[BW_Q][1];
  const T* Kg = static_cast<const T*>(p.k) + b * p.st[BW_K][0] + h * p.st[BW_K][1];
  const T* Vg = static_cast<const T*>(p.v) + b * p.st[BW_V][0] + h * p.st[BW_V][1];
  const T* Gg = static_cast<const T*>(p.dout) + b * p.st[BW_DO][0] + h * p.st[BW_DO][1];
  const long long rows = (long long)bh * N;  // this (batch, head)'s first row of LSE, D, dq
  const long long slice = (long long)p.B * p.H * N;  // rows of one key group's scratch slice
  const int kb_end = min((kg + 1) * per, n_kb);
  // each thread adds the shares of the group's later key blocks to the same
  // elements of the slice it wrote for the first: sums in a fixed order
  for (int kb = kg * per; kb < kb_end; ++kb) {
    const bool first = kb == kg * per;
    const int k0 = kb * BKV;
    __syncthreads();  // the last key block's reads of Ks and Vs are done
    load_tile<T, HD, LD>(Ks, nullptr, Kg, p.st[BW_K][2], k0, BKV, N, false, 0.f);
    load_tile<T, HD, LD>(Vs, nullptr, Vg, p.st[BW_V][2], k0, BKV, N, false, 0.f);
    const float c = p.prescale_q ? LOG2E : p.scale * LOG2E;  // scores -> log2 domain
    const bool kin0 = k0 + kr < N, kin1 = k0 + kr + 8 < N;   // keys past N: P = 0
    // a warp whose 16 keys all lie past N (the last block of a ragged N)
    // computes nothing; dQ reads dS^T's rows only up to the last valid key
    const bool active = k0 + warp * 16 < N;
    const int nkk = cdiv(N - k0 < BKV ? N - k0 : BKV, 8);

    float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

    const int nq = cdiv(N, BQ);
    for (int qb = 0; qb < nq; ++qb) {
      const int q0 = qb * BQ;
      __syncthreads();  // the last step's reads of Qs, Gs, Ss, Ls, Ds are done
      load_tile<T, HD, LD>(Qs, Ql, Qg, p.st[BW_Q][2], q0, BQ, N, p.prescale_q != 0, p.scale);
      load_tile<T, HD, LD>(Gs, Gl, Gg, p.st[BW_DO][2], q0, BQ, N, false, 0.f);
      for (int i = threadIdx.x; i < BQ; i += 128) {
        const bool in = q0 + i < N;  // rows past N: LSE +inf, so P = 0
        Ls[i] = in ? p.lse[rows + q0 + i] * LOG2E : INFINITY;
        if (!DELTA) {  // D: f32 one slice; bf16 the key blocks' shares, summed in order
          float d = 0.f;
          for (int z = 0; z < (EX ? n_slices : 1) && in; ++z)
            d += p.delta[z * slice + rows + q0 + i];
          Ds[i] = d;
        }
      }
      __syncthreads();

      if (active) {  // this warp's 16 keys x BQ queries
        // S^T = K Q^T and dP^T = V dO^T
        float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < HD / 8; ++kk) {  // fragments by ldmatrix
          const FragA ka = ld_frag_a<EX, LD>(Ks, 16 * warp, 8 * kk);
          const FragA va = ld_frag_a<EX, LD>(Vs, 16 * warp, 8 * kk);
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j) {  // B[k = hd][n = query] = X[query][hd]
            const FragB qb = ld_frag_b<EX, LD>(Qs, Ql, 8 * j, 8 * kk);
            const FragB gb = ld_frag_b<EX, LD>(Gs, Gl, 8 * j, 8 * kk);
            mma3x2<EX, EX, EX, EX>(s[j], ka, qb, dp[j], va, gb);
          }
        }

        // P^T = exp(S^T − LSE) (log2 domain); bf16: dP rounded to bf16
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool kin = e < 2 ? kin0 : kin1;
            s[j][e] = kin ? exp2_approx(s[j][e] * c - Ls[8 * j + 2 * t + (e & 1)]) : 0.f;
            if (EX) dp[j][e] = round_to<T>(dp[j][e]);
          }

        if constexpr (DELTA) {  // D = rowsum(P ∘ dP): this warp's 16 keys' share
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float x = sum_over_g(s[j][e] * dp[j][e] + s[j][e + 2] * dp[j][e + 2]);
              if (g == 0) Ss[warp * BQ + 8 * j + 2 * t + e] = x;
            }
        } else {
          // dS^T = P^T ∘ (dP^T − D), into dp, and to shared memory for dQ
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dp[j][e] = s[j][e] * (dp[j][e] - Ds[8 * j + 2 * t + (e & 1)]);
            const int q = 8 * j + 2 * t;
            *reinterpret_cast<float2*>(Ss + kr * BQ + swz(kr, q)) = make_float2(dp[j][0], dp[j][1]);
            *reinterpret_cast<float2*>(Ss + (kr + 8) * BQ + swz(kr + 8, q)) =
                make_float2(dp[j][2], dp[j][3]);
          }

          // dV += P^T dO and dK += dS^T Q: A from the accumulators (rows = keys);
          // a k8 step j takes query 8j + 2t as its column t and 8j + 2t + 1 as
          // t + 4, so B reads the same two rows of dO and Q
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j) {
            float p0 = s[j][0], p1 = s[j][2], p2 = s[j][1], p3 = s[j][3];
            if (EX) {  // the forward's PV operand: P rounded to bf16
              p0 = round_to<T>(p0);
              p1 = round_to<T>(p1);
              p2 = round_to<T>(p2);
              p3 = round_to<T>(p3);
            }
            const FragA pa = split_a<EX>(p0, p1, p2, p3);
            const FragA sa = split_a<false>(dp[j][0], dp[j][2], dp[j][1], dp[j][3]);
            const int qa = 8 * j + 2 * t, qz = qa + 1;
#pragma unroll
            for (int n = 0; n < HD / 8; ++n) {
              const int col = 8 * n + g;
              const FragB gb = tile_b<EX, LD>(Gs, Gl, qa, col, qz, col);
              const FragB qb = tile_b<EX, LD>(Qs, Ql, qa, col, qz, col);
              mma3x2<EX, EX, false, EX>(dv[n], pa, gb, dk[n], sa, qb);
            }
          }
        }
      }
      if constexpr (DELTA) {  // the key block's share of D: its warps' in order, into the slice
        if (!active)
          for (int i = lane; i < BQ; i += 32) Ss[warp * BQ + i] = 0.f;
        __syncthreads();
        for (int i = threadIdx.x; i < BQ; i += 128)
          if (q0 + i < N) {
            float* d = p.delta + kg * slice + rows + q0 + i;
            const float x = ((Ss[i] + Ss[BQ + i]) + Ss[2 * BQ + i]) + Ss[3 * BQ + i];
            *d = first ? x : *d + x;
          }
        continue;
      }
      __syncthreads();  // dS^T is in shared memory

      // dQ_i's share of this key block, dS K_j: warps split the [BQ x HD]
      // tile by 16-row m-tiles and 8-column n-tiles; stored in its slice
      constexpr int MT = BQ / 16, WPM = 4 / MT, NT = HD / 8 / WPM;
      const int mt = warp % MT, n0 = (warp / MT) * NT;
      float dq[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BKV / 8; ++kk) {
        if (kk == nkk) break;
        const int key = 8 * kk + t, qr = 16 * mt + g;  // A[m = query][k = key] = dS^T[key][query]
        const FragA a = split_a<false>(tile_at<BQ>(Ss, key, qr), tile_at<BQ>(Ss, key, qr + 8),
                                       tile_at<BQ>(Ss, key + 4, qr),
                                       tile_at<BQ>(Ss, key + 4, qr + 8));
#pragma unroll
        for (int n = 0; n < NT; n += 2) {  // n-tiles in pairs, an odd last one alone
          const int c0 = 8 * (n0 + n) + g;   // B[k = key][n = hd] = K[key][hd]
          const FragB b0 = split_b<EX>(tile_at<LD>(Ks, key, c0), tile_at<LD>(Ks, key + 4, c0));
          if (n + 1 < NT) {
            const int c1 = c0 + 8;
            const FragB b1 = split_b<EX>(tile_at<LD>(Ks, key, c1), tile_at<LD>(Ks, key + 4, c1));
            mma3x2<false, EX, false, EX>(dq[n], a, b0, dq[n + 1], a, b1);
          } else {
            mma3<false, EX>(dq[n], a, b0);
          }
        }
      }
      const int r0 = q0 + 16 * mt + g;
      float* part = p.dq_part + (kg * slice + rows) * HD;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = 8 * (n0 + n) + 2 * t;
        if (r0 < N) add_or_store(part + (long long)r0 * HD + col, dq[n][0], dq[n][1], first);
        if (r0 + 8 < N)
          add_or_store(part + (long long)(r0 + 8) * HD + col, dq[n][2], dq[n][3], first);
      }
    }

    if constexpr (!DELTA) {
      // K2's dk carries the scale (scores = (q k^T) · scale); K5's q was scaled
      const float ks = p.prescale_q ? 1.f : p.scale;
      T* DK = static_cast<T*>(p.dk) + b * p.st[BW_DK][0] + h * p.st[BW_DK][1];
      T* DV = static_cast<T*>(p.dv) + b * p.st[BW_DV][0] + h * p.st[BW_DV][1];
      const int r0 = k0 + kr, r1 = r0 + 8;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const int col = 8 * n + 2 * t;
        if (r0 < N) {
          store2(DK + r0 * p.st[BW_DK][2] + col, dk[n][0] * ks, dk[n][1] * ks);
          store2(DV + r0 * p.st[BW_DV][2] + col, dv[n][0], dv[n][1]);
        }
        if (r1 < N) {
          store2(DK + r1 * p.st[BW_DK][2] + col, dk[n][2] * ks, dk[n][3] * ks);
          store2(DV + r1 * p.st[BW_DV][2] + col, dv[n][2], dv[n][3]);
        }
      }
    }
  }
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

template <int HD, typename T>
cudaError_t launch_attention_bwd_hd(const AttnBwdArgs& p, cudaStream_t st) {
  using TL = BwdTile<HD, std::is_same_v<T, float>>;
  static_assert(TL::BKV == BWD_KEYS, "attention_bwd_slices counts blocks of BWD_KEYS keys");
  const long long rows = (long long)p.B * p.H * p.N;
  const int n_kb = cdiv(p.N, TL::BKV);
  const int per = attention_bwd_group(p.B, p.H, p.N);
  const int n_slices = cdiv(n_kb, per);
  const unsigned grid = static_cast<unsigned>(p.B * p.H * n_slices);
  cudaError_t e;
  if constexpr (std::is_same_v<T, float>) {
    attn_bwd_dot_kernel<<<static_cast<unsigned>((rows + 31) / 32), 256, 0, st>>>(p, HD);
  } else {
    auto delta = attn_bwd_kernel<HD, T, true>;
    e = cudaFuncSetAttribute(delta, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
    if (e != cudaSuccess) return e;
    delta<<<grid, TL::THREADS, TL::SMEM, st>>>(p, n_kb, per, n_slices);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto grads = attn_bwd_kernel<HD, T, false>;
  e = cudaFuncSetAttribute(grads, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
  if (e != cudaSuccess) return e;
  grads<<<grid, TL::THREADS, TL::SMEM, st>>>(p, n_kb, per, n_slices);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long pairs = rows * HD / 2;
  attn_bwd_dq_kernel<T><<<static_cast<unsigned>((pairs + 255) / 256), 256, 0, st>>>(p, HD,
                                                                                    n_slices);
  return cudaGetLastError();
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
// and allocate the scratch for attention_bwd_slices(B, H, N) slices).
static inline cudaError_t launch_attention_bwd(const AttnBwdArgs& p, int dtype, int hd,
                                               cudaStream_t st) {
  if (p.B * p.H == 0 || p.N == 0) return cudaSuccess;
  if (dtype == DT_F32) return launch_attention_bwd_t<float>(p, hd, st);
  if (dtype == DT_BF16) return launch_attention_bwd_t<bf16>(p, hd, st);
  return cudaErrorInvalidValue;
}

}  // namespace anyloc
