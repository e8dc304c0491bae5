// The work plan of K5's projection backward (attn_qkv_proj_bwd.cu): which
// output tiles and reduction chunks exist, which block of the persistent
// grid takes each, in what order, and where the scratch lies. Plain C++
// (no CUDA types), shared by the host entry and the kernel, so that a C++
// compiler without CUDA builds it too: tests/test_torch_proj_bwd_plan.py
// compiles it with g++ and holds it against its Python mirror
// (ops/kernels/attn_proj.py: proj_bwd_plan, proj_bwd_units).
//
// Two products share one list of work units:
//   * d_o = G'·W^T [M, D]: one unit per 128 x 128 output tile, reducing over
//     the Nc columns of G in stages of 32;
//   * d_W = o^T·G' [D, Nc]: 128 x 128 output tiles, each reducing over the M
//     rows cut into `chunks` chunks of `chunk_rows` rows (a multiple of 32),
//     one unit per (tile, chunk), so that a chunk has about as many stages
//     as a d_o unit (ceil(Nc / 32), at least 8).
// With more than one chunk, each d_W unit writes its f32 partial product,
// and reduction units add them up: one per 32-row slice of a d_W tile,
// chunks 0..chunks - 1 in order. Unit u: the d_W units first, chunk-major
// (u = chunk · dw_tiles + tile), then the d_o units, m-tile-major, then
// the reduction units, tile-major; block b of the grid (min(units, SMs)
// blocks) takes units b, b + grid, b + 2·grid, ... in that order. A
// reduction unit waits until its tile's chunks have arrived, and every
// unit it waits for comes earlier in the order, so the d_o units between
// them give the partials time to land.
#pragma once

#ifdef __CUDACC__
#define PB_FN __host__ __device__ __forceinline__
#else
#define PB_FN inline
#endif

namespace anyloc {

constexpr int PB_TILE = 128;  // rows and columns of an output tile
constexpr int PB_K = 32;      // reduction elements per pipeline stage
constexpr int PB_MIN_CHUNK = 8;    // stages of a d_W chunk at least
constexpr int PB_COL = 32;    // columns per block of the column sums (d_b, d_gamma)
constexpr int PB_COL_ROWS = 64;    // rows per split of the column sums at least
constexpr int PB_COUNTERS_ALIGN = 64;  // the counters' ints, rounded up (256 bytes)
constexpr int PB_RED_ROWS = 32;  // rows of a d_W tile per reduction unit

struct ProjBwdPlan {
  int m_tiles, d_tiles, c_tiles;  // ceil(M / 128), ceil(D / 128), ceil(Nc / 128)
  int chunks, chunk_rows;         // d_W's reduction over M (0, 0: no d_W)
  int n_dw, n_do, n_red, units, grid;  // work units and persistent blocks
  int col_splits, col_rows;       // the column sums' row splits (0, 0: none)
};

PB_FN int pb_cdiv(int a, int b) { return (a + b - 1) / b; }

PB_FN ProjBwdPlan proj_bwd_plan(int M, int D, int Nc, int sms, bool want_o, bool want_w,
                                bool want_sums) {
  ProjBwdPlan p = {};
  p.m_tiles = pb_cdiv(M, PB_TILE);
  p.d_tiles = pb_cdiv(D, PB_TILE);
  p.c_tiles = pb_cdiv(Nc, PB_TILE);
  if (want_w && M > 0) {
    const int stages = pb_cdiv(M, PB_K);
    int target = pb_cdiv(Nc, PB_K);  // a d_o unit's stages
    if (target < PB_MIN_CHUNK) target = PB_MIN_CHUNK;
    const int chunks = pb_cdiv(stages, target);
    p.chunk_rows = pb_cdiv(stages, chunks) * PB_K;
    p.chunks = pb_cdiv(M, p.chunk_rows);  // no empty chunk
    p.n_dw = p.d_tiles * p.c_tiles * p.chunks;
  }
  if (want_o && M > 0) p.n_do = p.m_tiles * p.d_tiles;
  if (p.chunks > 1) p.n_red = p.d_tiles * p.c_tiles * (PB_TILE / PB_RED_ROWS);
  p.units = p.n_dw + p.n_do + p.n_red;
  p.grid = p.units < sms ? p.units : sms;
  if (want_sums && M > 0) {
    const int col_blocks = pb_cdiv(Nc, PB_COL);
    int splits = pb_cdiv(4 * sms, col_blocks);  // about four blocks per SM
    const int most = pb_cdiv(M, PB_COL_ROWS);
    if (splits > most) splits = most;
    if (splits < 1) splits = 1;
    p.col_rows = pb_cdiv(M, splits);
    p.col_splits = pb_cdiv(M, p.col_rows);  // no empty split
  }
  return p;
}

// One unit: d_W (kind PB_DW: tile (ti, tj) = (D-tile, Nc-tile), reducing
// over rows k0..k1 - 1, chunk `chunk`), d_o (PB_DO: tile (ti, tj) = (M-tile,
// D-tile), reducing over columns k0..k1 - 1 = 0..Nc - 1) or a reduction
// (PB_RED: rows k0..k1 - 1 of d_W tile (ti, tj), no stages).
enum { PB_DO = 0, PB_DW = 1, PB_RED = 2 };

struct ProjBwdUnit {
  int kind, ti, tj, chunk, k0, k1;
};

PB_FN ProjBwdUnit proj_bwd_unit(const ProjBwdPlan& p, int M, int Nc, int u) {
  ProjBwdUnit r = {};
  const int tiles = p.d_tiles * p.c_tiles;
  if (u < p.n_dw) {
    const int tile = u % tiles;
    r.kind = PB_DW;
    r.chunk = u / tiles;
    r.ti = tile / p.c_tiles;
    r.tj = tile % p.c_tiles;
    r.k0 = r.chunk * p.chunk_rows;
    r.k1 = r.k0 + p.chunk_rows < M ? r.k0 + p.chunk_rows : M;
  } else if (u < p.n_dw + p.n_do) {
    const int v = u - p.n_dw;
    r.kind = PB_DO;
    r.ti = v / p.d_tiles;
    r.tj = v % p.d_tiles;
    r.k1 = Nc;
  } else {
    const int v = u - p.n_dw - p.n_do, slices = PB_TILE / PB_RED_ROWS;
    const int tile = v / slices;
    r.kind = PB_RED;
    r.ti = tile / p.c_tiles;
    r.tj = tile % p.c_tiles;
    r.k0 = (v % slices) * PB_RED_ROWS;
    r.k1 = r.k0 + PB_RED_ROWS;
  }
  return r;
}

// Pipeline stages of a unit (a reduction has none)
PB_FN int proj_bwd_stages(const ProjBwdUnit& u) {
  return u.kind == PB_RED ? 0 : pb_cdiv(u.k1 - u.k0, PB_K);
}

// Units of block b: b, b + grid, ... below p.units.
PB_FN int proj_bwd_block_units(const ProjBwdPlan& p, int b) {
  return b < p.units ? pb_cdiv(p.units - b, p.grid) : 0;
}

// The scratch, in bytes from its start: the tile and column-block arrival
// counters (ints, zeroed before each call), d_W's partial products
// [chunks, D, Nc] f32 when there is more than one chunk, the column sums'
// partials [2, col_splits, Nc] f32.
struct ProjBwdWorkspace {
  long long counters, part, col, bytes;
};

PB_FN ProjBwdWorkspace proj_bwd_workspace(const ProjBwdPlan& p, int D, int Nc) {
  ProjBwdWorkspace w = {};
  const int n_counters = (p.chunks > 1 ? p.d_tiles * p.c_tiles : 0) +
                         (p.col_splits > 0 ? pb_cdiv(Nc, PB_COL) : 0);
  const long long counter_bytes =
      4LL * pb_cdiv(n_counters, PB_COUNTERS_ALIGN) * PB_COUNTERS_ALIGN;
  w.counters = 0;
  w.part = counter_bytes;
  const long long part_bytes = p.chunks > 1 ? 4LL * p.chunks * D * Nc : 0;
  w.col = w.part + part_bytes;
  w.bytes = w.col + 4LL * 2 * p.col_splits * Nc;
  return w;
}

}  // namespace anyloc
