// K9 — a whole pre-norm int8 W8A8 ViT block: K4's attention half, then
// K3's MLP half, with the first residual sum x2 kept in f32.
//
// Replaces anyloc_tpu/ops/pallas/fused_block.py::fused_block_int8 (:128;
// body _block_kernel :51): LN1 -> int8 qkv -> attention -> requantize per
// (row, head chunk) -> int8 projection -> x2 = x + gamma1 * (acc1 + b_proj)
// in f32 (:101, never rounded to x's dtype) -> LN2 of x2 -> int8 w12 ->
// SwiGLU / GELU -> requantize per (row, hidden chunk) -> int8 w3 ->
// out = x2 + gamma2 * (acc2 + b3), cast to x's dtype (:124).
//
// What bounds it on the H100: at 308 px, batch 32 of DINOv2-G (M = 15520
// rows, D 1536, SwiGLU 4096) the four int8 products are 878.8 G int8 ops
// and the attention 46.2 GFLOP of bf16 (0.491 ms at the card's peaks),
// against ~0.2 GB of activations and weights: tensor-core bound. The
// design is K4's five launches (attn_half_int8.cu) with the projection
// epilogue writing x2 in f32 over a bf16 x, then K3's four
// (fused_mlp_int8.cu) with x2 as the f32 input of LN2 and as the residual
// of the w3 epilogue, writing x's dtype.
//
// On the TPU the merge kept x2 in VMEM and saved 31 launches per batch; on
// this card the f32 x2 goes through device memory (M * D * 4 bytes each
// way, twice what K4 -> K3's bf16 x2 moves), so this simple form saves
// nothing over K4 then K3 and is a little slower. A persistent kernel that
// keeps a row block's x2 on chip between the halves is later work.
#include "common.cuh"

extern "C" int anyloc_attn_half_int8(
    const void* x, const void* ln_w, const void* ln_b, const void* wqkv,
    const void* sqkv, const void* bqkv, const void* wp, const void* sp,
    const void* bp, const void* gamma, void* xq, void* xs, void* qkv, void* o,
    void* oq, void* os, void* out, int dtype, int out_dtype, int B, int N, int H,
    int hd, int hc, float eps, float scale, void* stream);

extern "C" int anyloc_fused_mlp_int8(
    const void* x, const void* ln_w, const void* ln_b, const void* w12,
    const void* s12, const void* b12, const void* w3, const void* s3,
    const void* b3, const void* gamma, void* xq, void* xs, void* g, void* gq,
    void* gs, void* out, int dtype, int out_dtype, int M, int D, int HID, int hc,
    int swiglu, int residual, float eps, void* stream);

// x [B, N, D] (dtype); attention weights as K4's entry point takes them
// (ln1, wqkv [3D, D] int8, sqkv, bqkv, wp [D, D] int8, sp, bp, gamma1), MLP
// weights as K3's (ln2, w12 [2*HID or HID, D] int8, s12, b12, w3 [D, HID]
// int8, s3, b3, gamma2). Scratch: xq [M, D] int8 and xs [M] f32 (used by
// both halves), qkv [M, 3D] bf16, o [M, D] bf16, oq [M, D] int8,
// os [M, H / hc] f32, x2 [M, D] f32, g [M, HID] f32, gq [M, HID] int8,
// gs [M, HID / mc] f32. out [B, N, D] in x's dtype.
extern "C" int anyloc_fused_block_int8(
    const void* x, const void* ln1_w, const void* ln1_b, const void* wqkv,
    const void* sqkv, const void* bqkv, const void* wp, const void* sp,
    const void* bp, const void* gamma1, const void* ln2_w, const void* ln2_b,
    const void* w12, const void* s12, const void* b12, const void* w3,
    const void* s3, const void* b3, const void* gamma2, void* xq, void* xs,
    void* qkv, void* o, void* oq, void* os, void* x2, void* g, void* gq,
    void* gs, void* out, int dtype, int B, int N, int H, int hd, int hc, int HID,
    int mc, int swiglu, float eps, float scale, void* stream) {
  using namespace anyloc;
  int e = anyloc_attn_half_int8(x, ln1_w, ln1_b, wqkv, sqkv, bqkv, wp, sp, bp, gamma1,
                                xq, xs, qkv, o, oq, os, x2, dtype, DT_F32, B, N, H, hd,
                                hc, eps, scale, stream);
  if (e != 0) return e;
  return anyloc_fused_mlp_int8(x2, ln2_w, ln2_b, w12, s12, b12, w3, s3, b3, gamma2,
                               xq, xs, g, gq, gs, out, DT_F32, dtype, B * N, H * hd, HID,
                               mc, swiglu, 1, eps, stream);
}
