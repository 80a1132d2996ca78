// Small device helpers shared by the package's kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace slt {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

__device__ __forceinline__ void store_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// f32 -> nearest bf16 -> f32 (round to nearest even, as torch's .to(bf16))
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace slt
