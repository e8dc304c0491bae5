// K4's five stages (attn_half_int8.cu), shared by K4, K9 (through K4's
// entry point) and T3 (attn_half_variant.cu), with T3's two knobs:
//   * pre-quantized rows: xq_in [B, np_pad, D] int8 and xs_in [B, np_pad]
//     f32 replace stage (a); the qkv GEMM reads the first N rows of each
//     image in place (its A-row mapping), so nothing is gathered;
//   * o_f32: the attention writes o in f32 (no rounding of the per-head
//     outputs to bf16) and the requantize reads f32.
// With neither, this is K4 exactly.
#pragma once

#include "flash_attention.cuh"
#include "int8_common.cuh"

namespace anyloc {
namespace {

// x [B, N, D] (dtype), ln_w / ln_b [D] f32, wqkv [3D, D] int8, sqkv [3D]
// f32, bqkv [3D] f32 or null, wp [D, D] int8 ([out, in]), sp [D], bp [D] or
// null, gamma [D] or null; xq_in / xs_in null, or the pre-quantized rows
// (images of np_pad rows). Scratch: xq [M, D] int8 and xs [M] f32 (unused
// with xq_in), qkv [M, 3D] bf16, o [M, D] bf16 (f32 with o_f32), oq [M, D]
// int8, os [M, H / hc] f32. out [B, N, D] in out_dtype.
inline int attn_half_int8_stages(
    const void* x, const void* ln_w, const void* ln_b, const void* wqkv,
    const void* sqkv, const void* bqkv, const void* wp, const void* sp,
    const void* bp, const void* gamma, const void* xq_in, const void* xs_in,
    void* xq, void* xs, void* qkv, void* o, void* oq, void* os, void* out, int dtype,
    int out_dtype, int o_f32, int B, int N, int np_pad, int H, int hd, int hc,
    float eps, float scale, cudaStream_t st) {
  const int D = H * hd;
  const int M = B * N;
  if (M == 0) return cudaSuccess;
  if ((dtype != DT_BF16 && dtype != DT_F32) || (out_dtype != DT_BF16 && out_dtype != DT_F32))
    return static_cast<int>(cudaErrorInvalidValue);
  I8GemmArgs pq = {};
  if (xq_in != nullptr) {
    pq.A = static_cast<const int8_t*>(xq_in);
    pq.row_scale = static_cast<const float*>(xs_in);
    pq.a_n = N;
    pq.a_pad = np_pad;
  } else {
    cudaError_t e = launch_ln_quant(x, dtype, static_cast<const float*>(ln_w),
                                    static_cast<const float*>(ln_b),
                                    static_cast<int8_t*>(xq), static_cast<float*>(xs),
                                    M, D, eps, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    pq.A = static_cast<const int8_t*>(xq);
    pq.row_scale = static_cast<const float*>(xs);
  }
  pq.B = static_cast<const int8_t*>(wqkv);
  pq.col_scale = static_cast<const float*>(sqkv);
  pq.bias = static_cast<const float*>(bqkv);
  pq.out = qkv;
  pq.M = M;
  pq.N = 3 * D;
  pq.K = D;
  pq.group = D;
  pq.q_cols = D;
  pq.q_scale = scale;
  cudaError_t e = xq_in != nullptr ? launch_gemm_i8<EPI_QKV, bf16, bf16, true>(pq, st)
                                    : launch_gemm_i8<EPI_QKV, bf16>(pq, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  AttnArgs a;
  const bf16* base = static_cast<const bf16*>(qkv);
  a.q = base;
  a.k = base + D;
  a.v = base + 2 * D;
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
  a.prescale_q = 1;   // no scaling of the scores; q * 1 is exact
  e = o_f32 ? launch_attention<true>(a, DT_BF16, hd, st) : launch_attention(a, DT_BF16, hd, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  const int group = hc * hd;
  e = o_f32 ? launch_requant(static_cast<const float*>(o), static_cast<int8_t*>(oq),
                             static_cast<float*>(os), M, D, group, st)
            : launch_requant(static_cast<const bf16*>(o), static_cast<int8_t*>(oq),
                             static_cast<float*>(os), M, D, group, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  I8GemmArgs pp = {};
  pp.A = static_cast<const int8_t*>(oq);
  pp.B = static_cast<const int8_t*>(wp);
  pp.row_scale = static_cast<const float*>(os);
  pp.col_scale = static_cast<const float*>(sp);
  pp.bias = static_cast<const float*>(bp);
  pp.gamma = static_cast<const float*>(gamma);
  pp.res = x;
  pp.out = out;
  pp.M = M;
  pp.N = D;
  pp.K = D;
  pp.group = group;
  return static_cast<int>(launch_gemm_i8_resid(pp, out_dtype, dtype, st));
}

}  // namespace
}  // namespace anyloc
