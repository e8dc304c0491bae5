// Shared helpers of the port's Hopper kernels: dtype codes, bf16 packing
// and the m16n8k16 bf16 tensor-core product (mma.sync, sm_80 and later).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace anyloc {

// dtype codes passed from the Python wrappers
constexpr int DT_F32 = 0;
constexpr int DT_BF16 = 1;

typedef __nv_bfloat16 bf16;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&u);
  return __bfloat1622float2(v);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// D = A(16x16, row-major) * B(16x8, k-major) + D, bf16 operands, f32 sums.
// Fragment layout (g = lane / 4, t = lane % 4):
//   a0 (row g, k 2t..2t+1)  a1 (row g+8, k 2t..)  a2 (row g, k 2t+8..)
//   a3 (row g+8, k 2t+8..)  b0 (k 2t..2t+1, col g)  b1 (k 2t+8.., col g)
//   c0,c1 (row g, cols 2t, 2t+1)  c2,c3 (row g+8, cols 2t, 2t+1)
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

}  // namespace anyloc
