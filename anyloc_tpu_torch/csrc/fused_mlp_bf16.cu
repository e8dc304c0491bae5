// K8 — the bf16 MLP half of a ViT block (K3's dataflow without
// quantization).
//
// Replaces anyloc_tpu/ops/pallas/fused_mlp.py::fused_mlp_bf16 (:414; the
// pallas_calls at :519 SwiGLU and :540 GELU, bodies :160 and :194):
// optional LayerNorm in f32, written in x's dtype -> g = silu(xn @ W1 + b1)
// * (xn @ W2 + b2), or the exact GELU of xn @ fc1 + b1 through the erf
// polynomial, in f32 and rounded to x's dtype (:186, :216) -> g @ W3 in
// f32 -> + b3, * LayerScale, + x, cast to x's dtype.
//
// What bounds it on the H100: at M = 8224 rows of DINOv2-G (B 32, N 257;
// D 1536, SwiGLU 4096) the two products are 206.9 + 103.5 GFLOP of bf16
// (0.314 ms at 989 TFLOP/s) against ~0.1 GB of activations and weights:
// tensor-core bound. The design is three launches:
//   (a) LN rows -> xn [M, D] in x's dtype, when there is a LayerNorm;
//   (b) the w12 GEMM (bf16_gemm.cuh: wgmma fed by TMA, bf16 or 3xTF32 for
//       f32); for SwiGLU one block owns 128 hidden columns of W1 and the
//       same 128 of W2 (K3's pairing: two TMA boxes; 64 for f32 operands),
//       so g is formed in registers and written once, in x's dtype
//       [M, HID];
//   (c) the w3 GEMM (EPI_RESID) with + b3, * gamma, + x.
// The TPU kernel keeps g in VMEM; here g makes one round trip through
// device memory (M * HID * 2 bytes each way in bf16), the first thing a
// faster version removes. The TPU's hidden chunk and row tile only order
// f32 sums, so they have no counterpart here.
#include "bf16_gemm.cuh"

// x [M, D] (dtype), ln_w / ln_b [D] f32 or null (no LayerNorm), w12
// [2*HID, D] (swiglu: W1 rows then W2 rows) or [HID, D] (GELU fc1) and
// w3 [D, HID] ([out, in]) in x's dtype, b12 per w12 row / b3 [D] / gamma
// [D] f32 or null; residual: add x. Scratch: xn [M, D] (unused without a
// LayerNorm), g [M, HID], in x's dtype. out [M, D].
extern "C" int anyloc_fused_mlp_bf16(
    const void* x, const void* ln_w, const void* ln_b, const void* w12, const void* b12,
    const void* w3, const void* b3, const void* gamma, void* xn, void* g, void* out,
    int dtype, int M, int D, int HID, int swiglu, int residual, float eps, void* stream) {
  using namespace anyloc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 0) return cudaSuccess;
  if (dtype != DT_BF16 && dtype != DT_F32) return static_cast<int>(cudaErrorInvalidValue);
  const void* a = x;
  if (ln_w != nullptr) {
    cudaError_t e = launch_ln_rows(x, dtype, static_cast<const float*>(ln_w),
                                   static_cast<const float*>(ln_b), xn, M, D, eps, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    a = xn;
  }

  GemmArgs p1 = {};
  p1.A = a;
  p1.B = w12;
  p1.bias = static_cast<const float*>(b12);
  p1.out = g;
  p1.M = M;
  p1.N = HID;
  p1.K = D;
  p1.hid = HID;
  cudaError_t e = swiglu ? launch_gemm<EPI_SWIGLU>(p1, dtype, st)
                         : launch_gemm<EPI_GELU>(p1, dtype, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  GemmArgs p3 = {};
  p3.A = g;
  p3.B = w3;
  p3.bias = static_cast<const float*>(b3);
  p3.gamma = static_cast<const float*>(gamma);
  p3.res = residual ? x : nullptr;
  p3.out = out;
  p3.M = M;
  p3.N = D;
  p3.K = HID;
  return static_cast<int>(launch_gemm<EPI_RESID>(p3, dtype, st));
}
