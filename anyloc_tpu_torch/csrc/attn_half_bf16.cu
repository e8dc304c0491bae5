// K7 — the bf16 attention half of a ViT block (K4's dataflow without
// quantization).
//
// Replaces anyloc_tpu/ops/pallas/attn_proj.py::fused_attn_half_bf16 (:709;
// body _attn_half_bf16_kernel :656): LN1 in f32, written in x's dtype
// (:677) -> qkv = xn @ Wqkv + b in f32, q times the softmax scale, each
// rounded once to x's dtype (:688, _heads_attention :142) -> per-head
// softmax attention with f32 sums, P and each head's output in x's dtype
// -> o_cat @ W_O in f32 -> + b_proj, * LayerScale, + x, cast to x's dtype.
//
// What bounds it on the H100: at B 32, N 257 of DINOv2-G (M = 8224 rows,
// D 1536, 24 heads of 64) the qkv and projection products are 116.4 + 38.8
// GFLOP and the attention 13.0 GFLOP of bf16 (0.170 ms at 989 TFLOP/s),
// against ~0.1 GB of activations and weights: tensor-core bound. The design
// is four launches:
//   (a) LN1 rows -> xn [M, D] in x's dtype (bf16_gemm.cuh);
//   (b) the qkv GEMM (bf16_gemm.cuh, EPI_QKV: wgmma fed by TMA, bf16 or
//       3xTF32 for f32) -> q | k | v [M, 3D];
//   (c) flash attention (flash_attention.cuh) over strided column views of
//       that tensor, q taken as already scaled (scale 1, no second
//       rounding, as K4 does; K5's route would round q twice);
//   (d) the projection GEMM (EPI_RESID) with + b_proj, * gamma, + x.
// The TPU kernel keeps xn, qkv and o in VMEM; here they go through device
// memory, the first thing a faster version removes by fusing (b)-(d) per
// head chunk. The head chunk and the TPU's skewed head loop only order f32
// sums, so they have no counterpart here.
#include "bf16_gemm.cuh"
#include "flash_attention.cuh"

// x [B, N, D] (dtype), ln_w / ln_b [D] f32, wqkv [3D, D] and wp [D, D]
// ([out, in]) in x's dtype, bqkv [3D] / bp [D] / gamma [D] f32 or null.
// Scratch: xn [M, D], qkv [M, 3D], o [M, D] in x's dtype. out [B, N, D].
extern "C" int anyloc_attn_half_bf16(
    const void* x, const void* ln_w, const void* ln_b, const void* wqkv,
    const void* bqkv, const void* wp, const void* bp, const void* gamma, void* xn,
    void* qkv, void* o, void* out, int dtype, int B, int N, int H, int hd, float eps,
    float scale, void* stream) {
  using namespace anyloc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int D = H * hd;
  const int M = B * N;
  if (M == 0) return cudaSuccess;
  if (dtype != DT_BF16 && dtype != DT_F32) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = launch_ln_rows(x, dtype, static_cast<const float*>(ln_w),
                                 static_cast<const float*>(ln_b), xn, M, D, eps, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  GemmArgs pq = {};
  pq.A = xn;
  pq.B = wqkv;
  pq.bias = static_cast<const float*>(bqkv);
  pq.out = qkv;
  pq.M = M;
  pq.N = 3 * D;
  pq.K = D;
  pq.q_cols = D;
  pq.q_scale = scale;
  e = launch_gemm<EPI_QKV>(pq, dtype, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  const size_t esz = dtype == DT_BF16 ? 2 : 4;
  const char* base = static_cast<const char*>(qkv);
  AttnArgs a;
  a.q = base;
  a.k = base + esz * D;
  a.v = base + esz * 2 * D;
  a.o = o;
  a.B = B;
  a.H = H;
  a.N = N;
  const long long rs = 3LL * D;
  a.q_sb = a.k_sb = a.v_sb = (long long)N * rs;
  a.q_sh = a.k_sh = a.v_sh = hd;
  a.q_sn = a.k_sn = a.v_sn = rs;
  a.o_sb = (long long)N * D;
  a.o_sh = hd;
  a.o_sn = D;
  a.scale = 1.f;      // q carries the softmax scale already
  a.prescale_q = 1;   // q * 1 rounded to its own dtype is q
  e = launch_attention(a, dtype, hd, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  GemmArgs pp = {};
  pp.A = o;
  pp.B = wp;
  pp.bias = static_cast<const float*>(bp);
  pp.gamma = static_cast<const float*>(gamma);
  pp.res = x;
  pp.out = out;
  pp.M = M;
  pp.N = D;
  pp.K = D;
  return static_cast<int>(launch_gemm<EPI_RESID>(pp, dtype, st));
}
