// K11: transposed 4-bit LUT GEMV for the decode path (at most 8 rows).
//
//   y[m, o] = sum_i x[m, i] * lut[o, code(i, o)],  code(i, o) the 4 bits
//   (i % 8) * 4 of qweight_t[o, i / 8]
//
// Replaces the TPU kernel `_lut_matmul_t_kernel` (squeezellm_tpu/ops/
// pallas_ops.py:613, launched by `lut_matmul_t`), which stores the packed
// words transposed, (out, n_words), so that output channels ride the
// sublanes and a 128-lane wrap-gather against a period-16 wide table
// dequantizes one plane at a time. The wide table is a TPU layout and is not
// ported: this kernel reads the (out, 16) LUT.
//
// Bound on the H100: the packed words (in / 2 bytes a channel; 25 MB for the
// fused 4-bit q|k|v of LLaMA-2-7B, ~7.5 us at 3.35 TB/s); the 2 * M * in * out
// products are f32 FMAs on the CUDA cores (bf16 mode rounds the operands
// first, as the TPU's one-pass MXU does, but still multiplies in f32), so
// from a few rows the operations bound it instead. Design:
//  * one warp per output channel: a channel's words are contiguous, so the
//    warp reads its row 128 bytes at a time, coalesced;
//  * the channel's 16 LUT entries live in the warp's registers, one per lane
//    (lanes 16-31 repeat them), and a code selects its entry by a shuffle;
//  * x is staged in shared memory one chunk of 128 words (1024 inputs) at a
//    time, plane-major ([code slot j][word w][row m]), so that the lanes,
//    which walk consecutive words, read consecutive addresses: 8 rows x
//    11008 inputs in f32 (352 KB) would not fit a block's 227 KB;
//  * the 32 lanes' partial sums meet in a fixed butterfly: no atomics, the
//    result does not depend on the run.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // output channels per block, one per warp
constexpr int kThreads = kWarps * 32;
constexpr int kCPW = 8;           // 4-bit codes per int32 word
constexpr int kChunkWords = 128;  // packed words staged per x chunk

__device__ __forceinline__ float load_act(const void* p, int is_bf16,
                                          size_t i) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
    lut_matmul_t_kernel(const void* __restrict__ x, int x_bf16,
                        const uint32_t* __restrict__ qwt,
                        const float* __restrict__ lut, float* __restrict__ y,
                        int M, int in_f, int out_f, int bf16_mode) {
  __shared__ __align__(16) float xs[kCPW * kChunkWords * MT];
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool live = o < out_f;  // uniform across the warp
  const int nw = (in_f + kCPW - 1) / kCPW;
  float lv = 0.f;
  if (live) {
    lv = lut[(size_t)o * 16 + (lane & 15)];
    if (bf16_mode) lv = slt::round_bf16(lv);
  }
  const uint32_t* row = qwt + (size_t)o * nw;
  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;

  for (int c0 = 0; c0 < nw; c0 += kChunkWords) {
    __syncthreads();  // xs of the previous chunk is no longer read
    // read x along its rows (coalesced), store plane-major; inputs past
    // in_f and rows past M are 0, so the last word's tail adds nothing
    for (int t = threadIdx.x; t < MT * kChunkWords * kCPW; t += kThreads) {
      const int m = t / (kChunkWords * kCPW), i = t % (kChunkWords * kCPW);
      const int gi = c0 * kCPW + i;
      float v = 0.f;
      if (m < M && gi < in_f) {
        v = load_act(x, x_bf16, (size_t)m * in_f + gi);
        if (bf16_mode) v = slt::round_bf16(v);
      }
      xs[((i % kCPW) * kChunkWords + i / kCPW) * MT + m] = v;
    }
    __syncthreads();
    if (!live) continue;
    const int nwc = min(kChunkWords, nw - c0);
#pragma unroll
    for (int w0 = 0; w0 < kChunkWords; w0 += 32) {
      const int w = w0 + lane;
      // every lane takes part in the shuffles; words past the chunk read 0
      const uint32_t word = w < nwc ? __ldg(row + c0 + w) : 0u;
#pragma unroll
      for (int j = 0; j < kCPW; ++j) {
        const float wv =
            __shfl_sync(0xffffffffu, lv, (int)((word >> (4 * j)) & 15u));
        const float* xp = &xs[(j * kChunkWords + w) * MT];
        if constexpr (MT % 4 == 0) {
#pragma unroll
          for (int m = 0; m < MT; m += 4) {
            const float4 xv = *reinterpret_cast<const float4*>(xp + m);
            acc[m] = fmaf(xv.x, wv, acc[m]);
            acc[m + 1] = fmaf(xv.y, wv, acc[m + 1]);
            acc[m + 2] = fmaf(xv.z, wv, acc[m + 2]);
            acc[m + 3] = fmaf(xv.w, wv, acc[m + 3]);
          }
        } else {
#pragma unroll
          for (int m = 0; m < MT; ++m) acc[m] = fmaf(xp[m], wv, acc[m]);
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const float total = slt::warp_sum(acc[m]);
    if (lane == 0 && m < M) y[(size_t)m * out_f + o] = total;
  }
}

}  // namespace

// x (M, in) f32 or bf16, M in 1..8; qweight_t int32 (out, n_words) with
// n_words = ceil(in / 8); lut f32 (out, 16); y (M, out) f32. All contiguous.
// Returns cudaGetLastError().
extern "C" int slt_lut_matmul_t(const void* x, int x_bf16,
                                const void* qweight_t, const void* lut,
                                void* y, int M, int in_f, int out_f,
                                int bf16_mode, void* stream) {
  if (M <= 0 || out_f <= 0) return (int)cudaSuccess;
  if (M > 8) return (int)cudaErrorInvalidValue;
  const dim3 grid((out_f + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qw = static_cast<const uint32_t*>(qweight_t);
  const auto* lt = static_cast<const float*>(lut);
  auto* yy = static_cast<float*>(y);
#define SLT_LUT_T_CASE(MT_)                                                \
  case MT_:                                                                \
    lut_matmul_t_kernel<MT_><<<grid, kThreads, 0, s>>>(                    \
        x, x_bf16, qw, lt, yy, M, in_f, out_f, bf16_mode);                 \
    break;
  switch (M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : 8) {
    SLT_LUT_T_CASE(1)
    SLT_LUT_T_CASE(2)
    SLT_LUT_T_CASE(4)
    SLT_LUT_T_CASE(8)
  }
#undef SLT_LUT_T_CASE
  return (int)cudaGetLastError();
}
