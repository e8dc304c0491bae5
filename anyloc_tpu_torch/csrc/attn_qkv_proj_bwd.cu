// K5's projection backward: the gradients of out = (o·W + b)·γ + residual
// (f32, rounded once to qkv's dtype; attn_qkv_proj.cu) for the output
// gradient G [M, d_out], M = B·N rows:
//   d_residual = G (the wrapper returns G itself);
//   G' = G ∘ γ (G without LayerScale), f32;
//   d_b = Σ_rows G', d_γ = Σ_rows G ∘ pre, with pre = o·W + b saved by the
//   forward's epilogue under autograd;
//   d_o = G'·W^T [M, D], rounded to qkv's dtype (the plain version rounds
//   it there: the backward of the heads' outputs' cast);
//   d_W = o^T·G' [D, d_out], in W's dtype.
// d_o then feeds the attention backward (flash_attention_bwd.cu) as dO.
//
// Replaces no TPU kernel: the Pallas K5 (anyloc_tpu/ops/pallas/attn_proj.py
// :327) has no backward (F19), and its gradient is the XLA route's; its
// projection GEMMs are part of that kernel's body, so here they are the
// port's TMA GEMM (int8_common.cuh's pipeline), never cuBLAS.
//
// What bounds it on the H100: two GEMMs of 2·M·D·d_out operations each
// (22.3 GFLOP together at qkv [48, 197, 2304]; the attention's share is
// flash_attention_bwd.cuh's) against ~M·(D + 3·d_out)·4 bytes, as three
// tf32 products each: tensor-core issue. The design:
//   * proj_bwd_prep_kernel: one pass over G (and pre) in 32 x 32 tiles: G'
//     row-major [M, d_out] f32, G'^T through shared memory (d_W's operand),
//     each 32-row block's column sums of G' and G ∘ pre, which
//     sum_rows_kernel adds in order (no atomics: the gradients are
//     reproducible bit for bit);
//   * transpose_f32_kernel: o^T f32 (d_W's other operand);
//   * d_o and d_W on the TMA GEMM with OpTF32x3 (3xTF32 on wgmma,
//     f32-accurate) for both dtypes: G' is f32 in the plain version
//     whatever the dtype (G times the f32 LayerScale), and bf16 data is
//     exact in tf32. tf32 wgmma has no transpose bit and d_W reduces over
//     the rows, where both o and G' are MN-major, so both are transposed
//     once into K-major rows. d_W is D x d_out (36 output tiles at ViT-B's
//     768) over a reduction of M rows (9456 at the step's batch): one tile
//     per block would leave most of the card idle, so the reduction is cut
//     into S chunks of Mc rows (Mc % 4 == 0 for TMA's 16-byte row pitch;
//     the transposes are written chunk by chunk, zeros past M), one batched
//     launch computes the S partial products (GemmBatch) and
//     sum_chunks_kernel adds them in W's dtype. Keeping pre costs the
//     forward one f32 store per output element (M·d_out·4 bytes) instead of
//     a third GEMM here.
#include "bf16_gemm.cuh"

namespace anyloc {
namespace {

// Column m of the transposed operands (0 <= m < S·Mc) lies in chunk m / Mc
// at column m % Mc: element (row r, column m) of a [rows, ·] transpose is
// at (chunk · rows + r) · Mc + m % Mc.
__device__ __forceinline__ long long chunked(int r, int m, int rows, int Mc) {
  return ((long long)(m / Mc) * rows + r) * Mc + m % Mc;
}

// Block (32, 8) over rows m0..m0 + 31 and columns c0..c0 + 31 of G.
// colsum [2, gridDim.y, Nc]: the block's column sums of G' and of G ∘ pre.
template <typename T>
__global__ void __launch_bounds__(256)
    proj_bwd_prep_kernel(const T* __restrict__ grad, const float* __restrict__ pre,
                         const float* __restrict__ gamma, float* __restrict__ gp,
                         float* __restrict__ gpt, float* __restrict__ colsum, int M, int Nc,
                         int Mc, int cols) {
  __shared__ float tile[32][33];
  __shared__ float red[2][8][32];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx;
  const int m0 = blockIdx.y * 32;
  const bool cin = c < Nc;
  const float gm = gamma != nullptr && cin ? gamma[c] : 1.f;
  float sb = 0.f, sg = 0.f;
  for (int i = ty; i < 32; i += 8) {
    const int m = m0 + i;
    float x = 0.f;
    if (cin && m < M) {
      const long long off = (long long)m * Nc + c;
      const float gv = to_float(grad[off]);
      x = gamma != nullptr ? __fmul_rn(gv, gm) : gv;
      gp[off] = x;
      sb += x;
      if (pre != nullptr) sg += gv * pre[off];
    }
    tile[i][tx] = x;
  }
  red[0][ty][tx] = sb;
  red[1][ty][tx] = sg;
  __syncthreads();
  if (ty == 0 && cin) {
    float a = 0.f, s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      a += red[0][j][tx];
      s += red[1][j][tx];
    }
    colsum[(long long)blockIdx.y * Nc + c] = a;
    colsum[((long long)gridDim.y + blockIdx.y) * Nc + c] = s;
  }
  if (gpt == nullptr) return;
  for (int i = ty; i < 32; i += 8) {  // G'^T: row c0 + i, columns m0 + tx (zeros past M)
    const int cc = blockIdx.x * 32 + i, m = m0 + tx;
    if (cc < Nc && m < cols) gpt[chunked(cc, m, Nc, Mc)] = tile[tx][i];
  }
}

// in [M, D] -> its transpose in chunks of Mc columns, f32, zeros past M
template <typename T>
__global__ void __launch_bounds__(256)
    transpose_f32_kernel(const T* __restrict__ in, float* __restrict__ out, int M, int D, int Mc,
                         int cols) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int d = blockIdx.x * 32 + tx, m0 = blockIdx.y * 32;
  for (int i = ty; i < 32; i += 8) {
    const int m = m0 + i;
    tile[i][tx] = d < D && m < M ? to_float(in[(long long)m * D + d]) : 0.f;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int dd = blockIdx.x * 32 + i, m = m0 + tx;
    if (dd < D && m < cols) out[chunked(dd, m, D, Mc)] = tile[tx][i];
  }
}

// d_b and d_gamma: the row blocks' column sums added in order (either null)
__global__ void __launch_bounds__(256)
    sum_rows_kernel(const float* __restrict__ colsum, float* db, float* dgamma, int blocks,
                    int Nc) {
  const int c = blockIdx.x * 256 + threadIdx.x;
  if (c >= Nc) return;
  float a = 0.f, s = 0.f;
  for (int z = 0; z < blocks; ++z) {
    a += colsum[(long long)z * Nc + c];
    s += colsum[((long long)blocks + z) * Nc + c];
  }
  if (db != nullptr) db[c] = a;
  if (dgamma != nullptr) dgamma[c] = s;
}

// d_W = the sum of the chunks' partial products, in W's dtype
template <typename T>
__global__ void __launch_bounds__(256)
    sum_chunks_kernel(const float* __restrict__ part, T* __restrict__ out, long long n, int S) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float x = part[i];
  for (int z = 1; z < S; ++z) x += part[(long long)z * n + i];
  out[i] = from_float<T>(x);
}

// The prep's rows (M, or the transposes' S·Mc) in blocks of 32: the row
// blocks of colsum.
static inline int prep_row_blocks(int M, int S, int Mc, bool transposes) {
  return cdiv(transposes ? S * Mc : M, 32);
}

template <typename T>
cudaError_t launch_prep(const void* grad, const float* pre, const float* gamma, float* gp,
                        float* gpt, float* colsum, float* db, float* dgamma, const void* o,
                        float* ot, int M, int D, int Nc, int S, int Mc, cudaStream_t st) {
  const dim3 block(32, 8);
  const int blocks = prep_row_blocks(M, S, Mc, gpt != nullptr);
  proj_bwd_prep_kernel<T><<<dim3(cdiv(Nc, 32), blocks), block, 0, st>>>(
      static_cast<const T*>(grad), pre, gamma, gp, gpt, colsum, M, Nc, Mc,
      gpt != nullptr ? S * Mc : M);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess && (db != nullptr || dgamma != nullptr)) {
    sum_rows_kernel<<<cdiv(Nc, 256), 256, 0, st>>>(colsum, db, dgamma, blocks, Nc);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess || ot == nullptr) return e;
  transpose_f32_kernel<T><<<dim3(cdiv(D, 32), cdiv(S * Mc, 32)), block, 0, st>>>(
      static_cast<const T*>(o), ot, M, D, Mc, S * Mc);
  return cudaGetLastError();
}

// out [count][M, N] = A [count][M, K] @ B [count][N, K]^T, f32 operands
// (3xTF32), out in dtype code out_dtype
cudaError_t gemm_f32_operands(const float* A, const float* B, void* out, int M, int N, int K,
                              int count, int out_dtype, cudaStream_t st) {
  GemmArgs g = {};
  g.A = A;
  g.B = B;
  g.out = out;
  g.M = M;
  g.N = N;
  g.K = K;
  g.batch.count = count;
  g.batch.a_rows = M;
  g.batch.b_rows = N;
  g.batch.out_elems = (long long)M * N;
  if (count > 1) {  // d_W's chunks: the one BATCH instance of the GEMM
    if (out_dtype == DT_F32) return launch_gemm<EPI_RESID, float, true>(g, DT_F32, st);
    return cudaErrorInvalidValue;
  }
  if (out_dtype == DT_BF16) return launch_gemm<EPI_RESID, bf16>(g, DT_F32, st);
  if (out_dtype == DT_F32) return launch_gemm<EPI_RESID, float>(g, DT_F32, st);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace anyloc

// grad [M, Nc] in dtype; pre [M, Nc] f32 or null (no LayerScale); gamma [Nc]
// f32 or null; w [D, Nc] f32 (W_O); o [M, D] in dtype (read only for dw);
// scratch gp [M, Nc] f32, colsum [2, row_blocks, Nc] f32 with row_blocks =
// ceil(S·Mc / 32) when dw is wanted, else ceil(M / 32) (the entry refuses
// another count), and, for dw, the transposes in S chunks of Mc rows of the
// reduction (Mc % 4 == 0, S·Mc >= M) gpt [S, Nc, Mc] and ot [S, D, Mc] and
// the chunks' products part [S, D, Nc], f32; outputs (each null when not
// wanted) d_o [M, D] in dtype, dw [D, Nc] in w_dtype, db / dgamma [Nc] f32.
extern "C" int anyloc_qkv_proj_bwd(const void* grad, const float* pre, const float* gamma,
                                   const float* w, const void* o, float* gp, float* colsum,
                                   float* gpt, float* ot, float* part, void* d_o, void* dw,
                                   float* db, float* dgamma, int dtype, int w_dtype, int M, int D,
                                   int Nc, int S, int Mc, int row_blocks, void* stream) {
  using namespace anyloc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 0) return 0;
  if (row_blocks != prep_row_blocks(M, S, Mc, dw != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSuccess;
  float* gpt_ = dw != nullptr ? gpt : nullptr;
  float* ot_ = dw != nullptr ? ot : nullptr;
  if (dtype == DT_BF16)
    e = launch_prep<bf16>(grad, pre, gamma, gp, gpt_, colsum, db, dgamma, o, ot_, M, D, Nc, S,
                          Mc, st);
  else if (dtype == DT_F32)
    e = launch_prep<float>(grad, pre, gamma, gp, gpt_, colsum, db, dgamma, o, ot_, M, D, Nc, S,
                           Mc, st);
  else
    e = cudaErrorInvalidValue;
  if (e == cudaSuccess && d_o != nullptr)
    e = gemm_f32_operands(gp, w, d_o, M, D, Nc, 1, dtype, st);
  if (e != cudaSuccess || dw == nullptr) return static_cast<int>(e);
  e = gemm_f32_operands(ot, gpt, part, D, Nc, Mc, S, DT_F32, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n = (long long)D * Nc;
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  if (w_dtype == DT_BF16)
    sum_chunks_kernel<bf16><<<blocks, 256, 0, st>>>(part, static_cast<bf16*>(dw), n, S);
  else if (w_dtype == DT_F32)
    sum_chunks_kernel<float><<<blocks, 256, 0, st>>>(part, static_cast<float*>(dw), n, S);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
