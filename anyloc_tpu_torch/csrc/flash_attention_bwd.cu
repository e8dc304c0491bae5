// K2's and K5's attention backward (flash_attention_bwd.cuh has the design,
// the bound and the rounding points): dq, dk, dv of softmax(q k^T · scale)
// v from q, k, v, the forward's output O, its gradient dO and the saved
// log-sum-exp of each query row. K2 (FlashAttentionGrad) passes [B, H, N,
// hd] views; K5 (QkvProjGrad) strided column views of qkv, of o and of the
// projection backward's d_o (attn_qkv_proj_bwd.cu), its outputs columns of
// the qkv gradient, with prescale_q = 1.
#include "flash_attention_bwd.cuh"

// strides: 8 tensors x (batch, head, token) element strides, in the order
// q, k, v, o, dout, dq, dk, dv; lse [B, H, N] f32; f32 scratch of
// slices = attention_bwd_slices(B, H, N) (the entry refuses another count):
// delta [slices (bf16) or 1 (f32), B, H, N], dq_part [slices, B, H, N, hd]
// (none on the split route, which writes dq without it); route: the kernels
// the caller counts (BWD_WGMMA 1, BWD_SPLIT 2), which must be the route
// table's for (hd, dtype).
extern "C" int anyloc_attention_bwd(const void* q, const void* k, const void* v,
                                    const void* o, const void* dout, void* dq, void* dk,
                                    void* dv, const float* lse, float* delta, float* dq_part,
                                    int dtype, int B, int H, int N, int hd, int prescale_q,
                                    int slices, int route, const long long* strides, float scale,
                                    void* stream) {
  if (slices != anyloc::attention_bwd_slices(B, H, N))
    return static_cast<int>(cudaErrorInvalidValue);
  anyloc::AttnBwdArgs p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.lse = lse;
  p.delta = delta;
  p.dq_part = dq_part;
  p.B = B;
  p.H = H;
  p.N = N;
  for (int i = 0; i < anyloc::BW_TENSORS; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
  p.scale = scale;
  p.prescale_q = prescale_q;
  return static_cast<int>(
      anyloc::launch_attention_bwd(p, dtype, hd, route, static_cast<cudaStream_t>(stream)));
}
