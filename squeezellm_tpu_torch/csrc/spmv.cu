// K12: standalone CSR sparse sum for B = 1..1023 rows.
//
//   y[b, r] = sum_{e in CSR row r} vals[e] * x[b, cols[e]]
//
// Replaces the separate sparse launch of the TPU decode path, `gather_spmv`
// (squeezellm_tpu/ops/pallas_ops.py:494): its grouped kernel
// `_spmv_kernel_grouped` (:462) and its classic `_spmv_kernel` (:427). Those
// route each entry's x value through two lane/sublane gathers of a slot
// plan, a TPU layout; the port keeps the sidecar as CSR and reads it as it
// is. quant_linear sends the transposed 4-bit decode's sidecar here (K11
// has no fold); every other row band folds the sidecar into K1, K4 or K10.
//
// Bound on the H100: the sidecar's bytes (rowptr, and 8 bytes an entry) plus
// x read once and y written once; at 0.45% of LLaMA-2-7B's fused q|k|v that
// is ~1.8 MB, ~0.5 us at 3.35 TB/s. The x reads are gathers, so the kernel
// is latency-bound long before that. Design: one thread per (CSR row, tile
// of up to 8 batch rows) walks its row's entries in CSR order and keeps the
// tile's sums in registers: neighbouring threads read neighbouring stretches
// of cols/vals, each entry is read once per tile, the order of the sum is
// fixed and no atomics are needed.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <int MT>
__global__ void __launch_bounds__(kThreads)
    spmv_kernel(const void* __restrict__ x, int x_bf16,
                const int* __restrict__ rowptr, const int* __restrict__ cols,
                const float* __restrict__ vals, float* __restrict__ y, int B,
                int in_f, int out_f) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const int b0 = blockIdx.y * MT;
  if (r >= out_f) return;
  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;
  const int e1 = rowptr[r + 1];
  for (int e = rowptr[r]; e < e1; ++e) {
    const size_t c = (size_t)cols[e];
    const float v = vals[e];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (b0 + m < B) {
        const size_t i = (size_t)(b0 + m) * in_f + c;
        const float xv =
            x_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i])
                   : static_cast<const float*>(x)[i];
        acc[m] = fmaf(v, xv, acc[m]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
    if (b0 + m < B) y[(size_t)(b0 + m) * out_f + r] = acc[m];
}

}  // namespace

// x (B, in) f32 or bf16; rowptr int32 (out + 1,), cols int32 (nnz,), vals f32
// (nnz,); y (B, out) f32, every element written. All contiguous. Returns
// cudaGetLastError().
extern "C" int slt_spmv(const void* x, int x_bf16, const void* rowptr,
                        const void* cols, const void* vals, void* y, int B,
                        int in_f, int out_f, void* stream) {
  if (B <= 0 || out_f <= 0) return (int)cudaSuccess;
  const int mt = B <= 1 ? 1 : B <= 2 ? 2 : B <= 4 ? 4 : 8;
  const dim3 grid((out_f + kThreads - 1) / kThreads, (B + mt - 1) / mt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* rp = static_cast<const int*>(rowptr);
  const auto* cl = static_cast<const int*>(cols);
  const auto* vl = static_cast<const float*>(vals);
  auto* yy = static_cast<float*>(y);
#define SLT_SPMV_CASE(MT_)                                                 \
  case MT_:                                                                \
    spmv_kernel<MT_><<<grid, kThreads, 0, s>>>(x, x_bf16, rp, cl, vl, yy, B, \
                                               in_f, out_f);               \
    break;
  switch (mt) {
    SLT_SPMV_CASE(1)
    SLT_SPMV_CASE(2)
    SLT_SPMV_CASE(4)
    SLT_SPMV_CASE(8)
  }
#undef SLT_SPMV_CASE
  return (int)cudaGetLastError();
}
