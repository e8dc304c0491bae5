// K2 — flash attention over head-split [B, H, N, hd] tensors.
//
// Replaces the TPU kernels of anyloc_tpu/ops/pallas/flash_attention.py:
// flash_attention (per (batch, head) cell, :62), flash_attention_heads
// (heads per cell, :139) and flash_attention_blocked (k-blocked online
// softmax, :241) — three TPU tilings of one function. The trunk reaches it
// for sequences longer than 1216 tokens (the 1022-px demo: 5330 tokens).
//
// What bounds it on the H100: at N = 5330, hd = 64 the score products are
// 4·N²·hd ≈ 7.3 GFLOP per (batch, head) against 2·4·N·hd bytes of q/k/v/o,
// so it is bound by tensor-core issue and by the softmax's exp2 work
// between the two products, not by HBM. The [N, N] scores never exist in
// device memory. The design (flash_attention.cuh has the details): a
// producer warp feeds 64-key K/V tiles by TMA into a two-stage mbarrier
// ring; one consumer warpgroup of 64 query rows (two at hd 128) keeps Q in
// registers and runs both products on wgmma, with the online softmax
// (running max, denominator, f32 accumulator) in registers between them;
// three blocks share an SM. f32 operands take the same dataflow with each
// product as three tf32 wgmmas (3xTF32: f32-accurate on the tensor cores).
//
// Rounding follows the TPU kernel: scores = (q k^T with f32 sums) * scale
// in f32; P is rounded to v's dtype before the PV product; out = acc / l.
// lse (null outside autograd): each row's log-sum-exp of the scaled
// scores, [B, H, N] f32, saved for the backward (flash_attention_bwd.cu).
#include "flash_attention.cuh"

extern "C" int anyloc_flash_attention(
    const void* q, const void* k, const void* v, void* o, float* lse, int dtype, int B,
    int H, int N, int hd, long long q_sb, long long q_sh, long long q_sn,
    long long k_sb, long long k_sh, long long k_sn, long long v_sb,
    long long v_sh, long long v_sn, long long o_sb, long long o_sh,
    long long o_sn, float scale, void* stream) {
  anyloc::AttnArgs p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.B = B;
  p.H = H;
  p.N = N;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sn = q_sn;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sn = k_sn;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sn = v_sn;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sn = o_sn;
  p.scale = scale;
  p.prescale_q = 0;
  p.lse = lse;
  return static_cast<int>(anyloc::launch_attention(
      p, dtype, hd, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* anyloc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
