// Helpers shared by the blend kernels (blend_fwd.cu, blend_bwd.cu).
#pragma once

#include <cuda_runtime.h>

namespace {

// entry rows per chunk of both kernels; the card check reads it through
// ht3dgs_blend_chunk() rather than keep a copy
constexpr int CHUNK = 32;

// decimal -> double -> float, the rounding the plain torch version sees
__device__ __forceinline__ float alpha_min() { return (float)(1.0 / 255.0); }
__device__ __forceinline__ float alpha_max() { return (float)0.99; }
__device__ __forceinline__ float t_eps() { return (float)1e-4; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies the first n (<= ROWS; none if n <= 0) 64-byte entry rows at src
// into shared memory with cp.async, one commit group, NT threads. The trip
// count is a compile-time constant, so the copy unrolls without a loop.
template <int NT, int ROWS>
__device__ __forceinline__ void stage_rows(float4* dst, const float4* src,
                                           int n, int tid) {
#pragma unroll
  for (int k = 0; k < (ROWS * 4 + NT - 1) / NT; ++k) {
    const int i = tid + k * NT;
    if (i < n * 4) cp_async16(dst + i, src + i);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

}  // namespace

extern "C" int ht3dgs_blend_chunk() { return CHUNK; }
