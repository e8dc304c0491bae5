// K6 — per-head attention over head-split q / k / v, heads concatenated,
// then the output projection (no bias, LayerScale or residual).
//
// Replaces anyloc_tpu/ops/pallas/attn_proj.py::attention_proj (:822;
// pallas_call :871, body _attn_proj_kernel :231): q * scale in f32 rounded
// to q's dtype (:254) -> f32-summed scores, softmax in f32, P in v's dtype,
// each head's output rounded to v's dtype -> o_cat @ W_O summed in f32,
// cast to q's dtype.
//
// What bounds it on the H100: at B 32, 24 heads of 64, N 257 (530) the
// attention is 13.0 (55.2) GFLOP and the projection 38.8 (80.0) GFLOP of
// bf16, 0.052 (0.137) ms at 989 TFLOP/s, against 3 x 25 (52) MB of q / k /
// v: tensor-core bound. The design is K5's two launches over head-split
// strides:
//   1. flash attention (flash_attention.cuh) on [B, H, N, hd] views of any
//      strides whose head dim is contiguous, q pre-scaled and rounded in
//      the kernel, writing o [B, N, H * hd]; the Pallas kernel pads N to 16
//      rows and masks the padded keys, here ragged key tiles are masked in
//      the kernel, so no padded copy exists;
//   2. the projection GEMM (bf16_gemm.cuh: wgmma fed by TMA, bf16 or
//      3xTF32 for f32; EPI_RESID with no bias, gamma or residual) o @ W_O ->
//      [B, N, D_out].
// The TPU kernel keeps o in VMEM; here it makes one round trip through
// device memory, which a later version removes by fusing the projection
// into the attention block.
#include "bf16_gemm.cuh"
#include "flash_attention.cuh"

// q / k / v [B, H, N, hd] (dtype) with element strides (batch, head,
// token), w_nk [D_out, H * hd] (W_O transposed, contiguous). Scratch: o
// [B, N, H * hd]. out [B, N, D_out] in q's dtype.
extern "C" int anyloc_attention_proj(
    const void* q, const void* k, const void* v, const void* w_nk, void* o, void* out,
    int dtype, int B, int H, int N, int hd, int d_out, long long q_sb, long long q_sh,
    long long q_sn, long long k_sb, long long k_sh, long long k_sn, long long v_sb,
    long long v_sh, long long v_sn, float scale, void* stream) {
  using namespace anyloc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int D = H * hd;
  AttnArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.B = B;
  a.H = H;
  a.N = N;
  a.q_sb = q_sb; a.q_sh = q_sh; a.q_sn = q_sn;
  a.k_sb = k_sb; a.k_sh = k_sh; a.k_sn = k_sn;
  a.v_sb = v_sb; a.v_sh = v_sh; a.v_sn = v_sn;
  a.o_sb = (long long)N * D;
  a.o_sh = hd;
  a.o_sn = D;
  a.scale = scale;
  a.prescale_q = 1;
  cudaError_t e = launch_attention(a, dtype, hd, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  GemmArgs p = {};
  p.A = o;
  p.B = w_nk;
  p.out = out;
  p.M = B * N;
  p.N = d_out;
  p.K = D;
  return static_cast<int>(launch_gemm<EPI_RESID>(p, dtype, st));
}
