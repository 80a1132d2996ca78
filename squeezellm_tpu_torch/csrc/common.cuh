// Small device helpers shared by the package's kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

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

// A lane's D adjacent elements of a cache row as one load of D *
// sizeof(TC) bytes, kept raw until used (2 registers a row for bf16 at hd
// 128, so 8 rows of k and v stay in flight). Used by the decode and paged
// attention kernels.
template <typename TC, int D>
struct Raw {
  static constexpr int BYTES = D * (int)sizeof(TC);
  using T = std::conditional_t<
      BYTES == 16, uint4,
      std::conditional_t<
          BYTES == 8, uint2,
          std::conditional_t<BYTES == 4, uint32_t,
                             std::conditional_t<BYTES == 2, uint16_t,
                                                uint8_t>>>>;
};

template <typename TC, int D>
__device__ __forceinline__ float raw_at(const typename Raw<TC, D>::T& r,
                                        int d) {
  return to_f32(reinterpret_cast<const TC*>(&r)[d]);
}

// ---------------------------------------------------------------------------
// Copies and tensor-core products shared by the mma.sync kernels
// (lut_matmul.cu, flash_attn.cu)
// ---------------------------------------------------------------------------

// Copies `nbytes` (0..UNIT) from gmem to smem with cp.async, zero-filling
// the rest of the UNIT (4 or 16) bytes.
template <int UNIT>
__device__ __forceinline__ void cp_async_part(void* smem, const void* gmem,
                                              int nbytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  if constexpr (UNIT == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(nbytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(nbytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix .trans: lane t receives rows 2 (t % 4) and 2 (t % 4) + 1 of
// column t / 4 of each 8 x 8 matrix, the B operand of an m16n8k16 product
// whose k runs along the rows in memory (P.V's V).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// Two f32 as the bf16 pair of one 32-bit operand register (lo in the low
// half), rounded to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Raises a kernel's dynamic shared memory limit once (`done` is the
// caller's static flag for that kernel).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = e == cudaSuccess;
  return e;
}

}  // namespace slt
