// K1: LUT-dequant matmul with the sparse sidecar and a y0 init folded in.
//
//   y[m, o] = y0[m, o] + sum_{e in CSR row o} vals[e] * x[m, cols[e]]
//                      + sum_i x[m, i] * lut[o, code(i, o)]
//
// Replaces the TPU kernels `_lut_matmul_sp_kernel` and `_lut_matmul_kernel`
// (squeezellm_tpu/ops/pallas_ops.py, launched by `lut_matmul`) and, for
// 17..1023 rows, the sparse add of `_spmv_kernel` (`gather_spmv`): the CSR
// fold below serves every row count, so no slot plans are needed.
//
// Bound on the H100: at decode (M = 1) the packed words are the bytes that
// matter (e.g. 25 MB for the fused 4-bit q|k|v of LLaMA-2-7B, ~7.5 us at
// 3.35 TB/s). The 2*M*in*out products bound it from M ~ 5 in exact mode
// (f32 operands, 67 TFLOP/s) but only from M ~ 80 in bf16 mode, whose bf16
// x bf16 products with f32 accumulation the tensor cores do at 989
// TFLOP/s. This kernel does every product as an f32 FMA on the CUDA
// cores, so at prefill row counts in bf16 mode it stays far from that
// bound (a tensor-core version is later work). Design for the byte bound:
//  * one lane per output column: qweight's `out` axis is contiguous, so a
//    warp reads 128 contiguous bytes per packed word row (the reference
//    CUDA kernel's layout);
//  * 8 warps per block split the packed words (k-slices) of the same 32
//    columns, so even a 4096-wide output gives 128 blocks x 8 warps; each
//    warp issues its 8 word loads of a chunk before it waits on any;
//  * the column's LUT lives in shared memory as lut_s[code][lane] (a
//    register array cannot be indexed by a run-time code), conflict-free;
//  * x is staged in shared memory one 64-word chunk at a time ([i][m]
//    layout, read as broadcast float4), so the 16-row down projection
//    (11008 inputs, 44 KB a row in f32) never needs the whole row at once;
//  * the k-slices are summed in a fixed order through shared memory and the
//    CSR row is walked by one thread: no atomics, so the result does not
//    depend on the run.
// mode bf16 rounds x and the LUT to bf16 before the products (f32
// accumulation); the sparse fold always reads x unrounded.
//
// K10 (slt_lut_matmul_struct) is the same template with a second table
// form, for 4-bit STRUCTURED codebooks lut[c] = A[c & 7] + (c >> 3) * d
// (quantize/kmeans.fit_structured_luts). It replaces the structured bodies
// of the TPU kernels (`_dequant_plane_struct_sel` and the structured branch
// of `_lut_matmul_body`, squeezellm_tpu/ops/pallas_ops.py:190-205,
// 311-342), which dequantize with one 8-entry gather plus a bit-3 select.
// Here the block builds its 16-entry shared table from A (out, 8) and d
// (out,) once, W = A[c & 7] + (c & 8 ? d : 0) in f32 (rounded to bf16 in
// bf16 mode, as the TPU's one-pass MXU rounds the dequantized operand), and
// the k loop is K1's. It reads 36 bytes of table a column instead of 64,
// which at the byte bound of the packed words changes nothing measurable:
// the structure saves VPU operations on a TPU, not bytes.
#include "common.cuh"

namespace {

constexpr int kCols = 32;        // output columns per block, one per lane
constexpr int kWarps = 8;        // k-slices per block, one per warp
constexpr int kThreads = kCols * kWarps;
constexpr int kChunkWords = 64;  // packed words staged per x chunk
constexpr int kWordsPerWarp = kChunkWords / kWarps;

__device__ __forceinline__ float load_act(const void* p, int is_bf16,
                                          size_t i) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

template <int BITS, int MT>
__global__ void __launch_bounds__(kThreads)
    lut_matmul_kernel(const void* __restrict__ x, int x_bf16,
                      const uint32_t* __restrict__ qw,
                      const float* __restrict__ lut,
                      const float* __restrict__ sd,
                      const int* __restrict__ rowptr,
                      const int* __restrict__ cols,
                      const float* __restrict__ vals,
                      const void* __restrict__ y0, int y0_bf16,
                      float* __restrict__ y, int M, int in_f, int out_f,
                      int bf16_mode) {
  constexpr int CPW = BITS == 4 ? 8 : 10;  // codes per int32 word
  constexpr int K = 1 << BITS;
  constexpr int CHUNK_IN = kChunkWords * CPW;
  static_assert(kWarps * kCols <= CHUNK_IN, "reduction reuses x_s");
  __shared__ float lut_s[K][kCols];
  // x chunk as [i][m]; after the k loop it holds the k-slice partials
  __shared__ __align__(16) float x_s[CHUNK_IN * MT];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * kCols;
  const int col = col0 + lane;
  const int m0 = blockIdx.y * MT;
  const int nw = (in_f + CPW - 1) / CPW;

  // the block's LUT rows are kCols * K contiguous floats of lut (out, K);
  // a structured table (sd set, 4-bit) is A (out, 8) and d (out,)
  for (int t = threadIdx.x; t < kCols * K; t += kThreads) {
    const int c = t / K, k = t % K;
    float v = 0.f;
    if (col0 + c < out_f) {
      if (sd) {
        v = lut[(size_t)(col0 + c) * 8 + (k & 7)];
        if (k & 8) v += sd[col0 + c];
      } else {
        v = lut[(size_t)(col0 + c) * K + k];
      }
    }
    lut_s[k][c] = bf16_mode ? slt::round_bf16(v) : v;
  }

  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;

  for (int c0 = 0; c0 < nw; c0 += kChunkWords) {
    // this warp's words of the chunk: w = c0 + u * kWarps + warp
    uint32_t q[kWordsPerWarp];
#pragma unroll
    for (int u = 0; u < kWordsPerWarp; ++u) {
      const int w = c0 + u * kWarps + warp;
      q[u] = (w < nw && col < out_f) ? __ldg(qw + (size_t)w * out_f + col)
                                     : 0u;
    }
    __syncthreads();  // x_s of the previous chunk is no longer read
    const int i0 = c0 * CPW;
    const int n_in = min(CHUNK_IN, in_f - i0);
    for (int t = threadIdx.x; t < MT * CHUNK_IN; t += kThreads) {
      const int m = t / CHUNK_IN, i = t % CHUNK_IN;
      float v = 0.f;
      if (m0 + m < M && i < n_in) {
        v = load_act(x, x_bf16, (size_t)(m0 + m) * in_f + i0 + i);
        if (bf16_mode) v = slt::round_bf16(v);
      }
      x_s[i * MT + m] = v;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kWordsPerWarp; ++u) {
      const int wl = u * kWarps + warp;
      if (c0 + wl >= nw) break;
      // codes at input index >= in_f (the last word's tail) are skipped
      const int valid = min(CPW, in_f - (c0 + wl) * CPW);
      const uint32_t word = q[u];
#pragma unroll
      for (int j = 0; j < CPW; ++j) {
        if (j < valid) {
          const uint32_t code = (word >> (BITS * j)) & (uint32_t)(K - 1);
          const float wv = lut_s[code][lane];
          const float* xp = &x_s[(wl * CPW + j) * MT];
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
  }

  // fixed-order sum of the k-slices, then y0 + sparse + dense per (row, col)
  __syncthreads();
  float* red = x_s;  // [warp][m][col]
#pragma unroll
  for (int m = 0; m < MT; ++m) red[(warp * MT + m) * kCols + lane] = acc[m];
  __syncthreads();
  for (int p = threadIdx.x; p < MT * kCols; p += kThreads) {
    const int m = p / kCols, c = p % kCols;
    const int row = m0 + m, oc = col0 + c;
    if (row >= M || oc >= out_f) continue;
    float dense = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) dense += red[(k * MT + m) * kCols + c];
    const size_t yi = (size_t)row * out_f + oc;
    float init = y0 ? load_act(y0, y0_bf16, yi) : 0.f;
    if (rowptr) {
      float sp = 0.f;
      const size_t xrow = (size_t)row * in_f;
      for (int e = rowptr[oc]; e < rowptr[oc + 1]; ++e)
        sp = fmaf(vals[e], load_act(x, x_bf16, xrow + cols[e]), sp);
      init += sp;
    }
    y[yi] = init + dense;
  }
}

template <int BITS>
void launch(int mt, dim3 grid, cudaStream_t s, const void* x, int x_bf16,
            const uint32_t* qw, const float* lut, const float* sd,
            const int* rowptr, const int* cols, const float* vals,
            const void* y0, int y0_bf16,
            float* y, int M, int in_f, int out_f, int bf16_mode) {
#define SLT_LUT_CASE(MT_)                                                   \
  case MT_:                                                                 \
    lut_matmul_kernel<BITS, MT_><<<grid, kThreads, 0, s>>>(                 \
        x, x_bf16, qw, lut, sd, rowptr, cols, vals, y0, y0_bf16, y, M,      \
        in_f, out_f, bf16_mode);                                            \
    break;
  switch (mt) {
    SLT_LUT_CASE(1)
    SLT_LUT_CASE(2)
    SLT_LUT_CASE(4)
    SLT_LUT_CASE(8)
    SLT_LUT_CASE(16)
  }
#undef SLT_LUT_CASE
}

}  // namespace

// x (M, in) f32 or bf16; qweight int32 (n_words, out); lut f32 (out, 2^bits);
// rowptr/cols/vals: CSR sidecar or all null; y0 (M, out) f32/bf16 or null;
// y (M, out) f32. All contiguous. Returns cudaGetLastError().
extern "C" int slt_lut_matmul(const void* x, int x_bf16, const void* qweight,
                              const void* lut, const void* rowptr,
                              const void* cols, const void* vals,
                              const void* y0, int y0_bf16, void* y, int M,
                              int in_f, int out_f, int bits, int bf16_mode,
                              void* stream) {
  if (M <= 0 || out_f <= 0) return (int)cudaSuccess;
  int mt = 1;
  while (mt < M && mt < 16) mt *= 2;
  const dim3 grid((out_f + kCols - 1) / kCols, (M + mt - 1) / mt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qw = static_cast<const uint32_t*>(qweight);
  const auto* lt = static_cast<const float*>(lut);
  const auto* rp = static_cast<const int*>(rowptr);
  const auto* cl = static_cast<const int*>(cols);
  const auto* vl = static_cast<const float*>(vals);
  auto* yy = static_cast<float*>(y);
  if (bits == 4) {
    launch<4>(mt, grid, s, x, x_bf16, qw, lt, nullptr, rp, cl, vl, y0,
              y0_bf16, yy, M, in_f, out_f, bf16_mode);
  } else if (bits == 3) {
    launch<3>(mt, grid, s, x, x_bf16, qw, lt, nullptr, rp, cl, vl, y0,
              y0_bf16, yy, M, in_f, out_f, bf16_mode);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K10: slt_lut_matmul's arguments with the structured table A (out, 8) f32
// and d (out,) f32 in place of lut, at 4 bits.
extern "C" int slt_lut_matmul_struct(const void* x, int x_bf16,
                                     const void* qweight, const void* a,
                                     const void* d, const void* rowptr,
                                     const void* cols, const void* vals,
                                     const void* y0, int y0_bf16, void* y,
                                     int M, int in_f, int out_f,
                                     int bf16_mode, void* stream) {
  if (M <= 0 || out_f <= 0) return (int)cudaSuccess;
  int mt = 1;
  while (mt < M && mt < 16) mt *= 2;
  const dim3 grid((out_f + kCols - 1) / kCols, (M + mt - 1) / mt);
  launch<4>(mt, grid, static_cast<cudaStream_t>(stream), x, x_bf16,
            static_cast<const uint32_t*>(qweight),
            static_cast<const float*>(a), static_cast<const float*>(d),
            static_cast<const int*>(rowptr), static_cast<const int*>(cols),
            static_cast<const float*>(vals), y0, y0_bf16,
            static_cast<float*>(y), M, in_f, out_f, bf16_mode);
  return (int)cudaGetLastError();
}

extern "C" const char* slt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
