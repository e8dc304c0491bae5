// K5 — attention read straight from the fused qkv tensor, then the output
// projection with bias, LayerScale and residual.
//
// Replaces anyloc_tpu/ops/pallas/attn_proj.py::flash_attention_qkv_proj
// (pallas_call at :399; body _attn_qkv_proj_kernel :280, _heads_attention
// :117): the attention half of every DINOv2 block up to the captured layer
// when N <= 1216 tokens.
//
// What bounds it on the H100: at the 308-px shape (B = 32, N = 485,
// D = 1536, 24 heads of 64) the out-projection is 2·B·N·D² ≈ 73 GFLOP and
// the attention 4·B·H·N²·hd ≈ 46 GFLOP, against ~0.1 GB of qkv/residual
// traffic: both halves are bound by tensor-core issue. The design is two
// launches:
//   1. the flash-attention kernel of flash_attention.cuh over strided
//      column views of qkv [B, N, 3D] (q at column 0 + h·hd, k at D + h·hd,
//      v at 2D + h·hd, row stride 3D) — no head-split copy — writing each
//      head's output, rounded to qkv's dtype, into o [B, N, D];
//   2. the projection GEMM of bf16_gemm.cuh (EPI_RESID, shared with K6-K8
//      and T1; wgmma fed by TMA, bf16 or 3xTF32 for f32) o[M, D] @ W_O with
//      the epilogue (+ bias) * gamma + residual in f32, cast to qkv's
//      dtype.
// The TPU kernel keeps o in VMEM; here o makes one round trip through
// device memory (B·N·D·2 bytes each way), the first thing a later version
// removes by fusing the projection into the attention block.
//
// Rounding follows the TPU kernel: q * scale in f32 rounded to the input
// dtype before the score product (attn_proj.py:307), f32 scores, P in v's
// dtype, each head's output rounded to v's dtype (:152), f32 projection.
//
// Under autograd (QkvProjGrad) the launch keeps what the backward
// (attn_qkv_proj_bwd.cu, flash_attention_bwd.cu) reads: o, the heads'
// outputs, stays as a saved tensor instead of scratch; lse receives each
// query row's log-sum-exp of the scores ([B, H, N] f32, from the attention
// kernel); pre receives o·W_O + bias before LayerScale ([B, N, d_out] f32,
// from the GEMM's epilogue, the EPI_RESID_PRE instance), which d
// LayerScale sums against the output gradient. Both are null outside
// autograd, and the output's stores are the same either way.
#include "bf16_gemm.cuh"
#include "flash_attention.cuh"

// qkv [B, N, 3D] contiguous, w_nk [d_out, D] contiguous (W_O transposed),
// bias / gamma [d_out] f32 or null, res [B, N, d_out] or null,
// o [B, N, D] scratch, out [B, N, d_out], lse [B, H, N] / pre [B, N, d_out]
// f32 or null.
extern "C" int anyloc_attn_qkv_proj(const void* qkv, const void* w_nk,
                                    const void* bias, const void* gamma,
                                    const void* res, void* o, void* out,
                                    float* lse, float* pre,
                                    int dtype, int B, int N, int H, int hd,
                                    int d_out, float scale, void* stream) {
  using namespace anyloc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int D = H * hd;
  const size_t esz = dtype == DT_BF16 ? 2 : 4;
  const char* base = static_cast<const char*>(qkv);
  AttnArgs p;
  p.q = base;
  p.k = base + esz * D;
  p.v = base + esz * 2 * D;
  p.o = o;
  p.B = B;
  p.H = H;
  p.N = N;
  const long long rs = 3LL * D;
  p.q_sb = p.k_sb = p.v_sb = (long long)N * rs;
  p.q_sh = p.k_sh = p.v_sh = hd;
  p.q_sn = p.k_sn = p.v_sn = rs;
  p.o_sb = (long long)N * D;
  p.o_sh = hd;
  p.o_sn = D;
  p.scale = scale;
  p.prescale_q = 1;
  p.lse = lse;
  cudaError_t e = launch_attention(p, dtype, hd, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  GemmArgs g = {};
  g.A = o;
  g.B = w_nk;
  g.bias = static_cast<const float*>(bias);
  g.gamma = static_cast<const float*>(gamma);
  g.res = res;
  g.out = out;
  g.pre = pre;
  g.M = B * N;
  g.N = d_out;
  g.K = D;
  return static_cast<int>(pre != nullptr ? launch_gemm<EPI_RESID_PRE>(g, dtype, st)
                                          : launch_gemm<EPI_RESID>(g, dtype, st));
}
