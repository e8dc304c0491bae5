// K2 — flash attention over head-split [B, H, N, hd] tensors.
//
// Replaces the TPU kernels of anyloc_tpu/ops/pallas/flash_attention.py:
// flash_attention (per (batch, head) cell, :62), flash_attention_heads
// (heads per cell, :139) and flash_attention_blocked (k-blocked online
// softmax, :241) — three TPU tilings of one function. The trunk reaches it
// for sequences longer than 1216 tokens (the 1022-px demo: 5330 tokens).
//
// What bounds it on the H100: at N = 5330, hd = 64 the score products are
// 4·N²·hd ≈ 7.3 GFLOP per (batch, head) against 2·3·N·hd bytes of q/k/v,
// so it is bound by tensor-core issue and by the softmax's exp/max work
// between the two products, not by HBM. The [N, N] scores never exist in
// device memory: each block keeps a 64-row query tile in registers, streams
// 64-key K/V tiles through shared memory and carries the online-softmax
// state (running max, denominator, f32 accumulator) in registers. The bf16
// path uses mma.sync m16n8k16 tensor-core products; the f32 path is plain
// FMA. A later version would use wgmma with TMA-fed K/V tiles.
//
// Rounding follows the TPU kernel: scores = (q k^T with f32 sums) * scale
// in f32; P is rounded to v's dtype before the PV product; out = acc / l.
#include "flash_attention.cuh"

extern "C" int anyloc_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
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
  return static_cast<int>(anyloc::launch_attention(
      p, dtype, hd, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* anyloc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
