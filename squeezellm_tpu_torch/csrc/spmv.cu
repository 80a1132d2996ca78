// K12: standalone CSR sparse sum for B = 1..1023 rows, with the transposed
// route's adds folded into the same launch.
//
//   s[b, r] = sum_{e in CSR row r} vals[e] * x[b, cols[e]]     (f32)
//   y[b, r] = s[b, r]                                  (no accumulator), or
//   y[b, r] = (y[b, r] + y0[b, r]) + s[b, r]           (in place; y0 optional)
//
// Replaces the separate sparse launch of the TPU decode path, `gather_spmv`
// (squeezellm_tpu/ops/pallas_ops.py:494): its grouped kernel
// `_spmv_kernel_grouped` (:462) and its classic `_spmv_kernel` (:427). Those
// route each entry's x value through two lane/sublane gathers of a slot
// plan, a TPU layout; the port keeps the sidecar as CSR and reads it as it
// is. quant_linear sends the transposed 4-bit decode's sidecar here, in
// place on K11's output with the residual y0 (the JAX package's `+ y0` and
// `+ sp` after `lut_matmul_t`, in that order); every other row band folds
// the sidecar into K1, K4 or K10.
//
// Bound on the H100: the sidecar's bytes (rowptr, and 8 bytes an entry)
// plus x read once and y written once (read too, with y0, when folding);
// at 0.45% of LLaMA-2-7B's fused q|k|v that is ~1.8 MB, ~0.5 us at 3.35
// TB/s. Each entry's x value is a gather behind a dependent load of its
// column, so the kernel is bound by latency and by the sectors its gathers
// touch long before that. Design:
// * G lanes (8, 16 or 32; the wrapper picks G from the shape's mean row
//   length, never from B) share a CSR row: consecutive lanes read
//   consecutive entries, so the loads of cols and vals are coalesced, and
//   a lane walks entries lane, lane + G, lane + 2G, ... of its row. The
//   grid fills the card at every LLaMA-2-7B shape (o at G = 8: 256 blocks
//   of 128), and a long row keeps its G lanes busy without holding back
//   the other rows of its block's warps.
// * Loads in flight: a lane issues kUnroll entries' cols and vals, then
//   all their x gathers (a column's MT values together), then the FMAs.
//   The fold's y and y0 are loaded before the walk, so their latency hides
//   behind it.
// * One row (a decode step) is a chain of dependent loads, rowptr -> cols
//   -> x, and its launches are a few microseconds each: blocks of 512
//   threads (fewer blocks to start than at 128) stage x in shared memory
//   while rowptr is on its way, so the gathers cost no round trip to L2.
// * x at B > 1: a small launch first copies x into the wrapper's scratch
//   `xt` as (tiles, in, MT), so an entry's MT values are one 16- or 32-byte
//   load (the layout `torch.sparse.mm` reads) where row-major x would cost
//   MT sectors; at MT = 1 that layout is x itself, read as it is.
// * Batch tiles of MT <= 8 rows over blockIdx.y. A lane's partial is one
//   FMA chain over its entries in CSR order, and a fixed butterfly over
//   the G lanes sums the partials, so a row's sum is the same whatever B,
//   MT or the rows beside it: bit-equal across M. No atomics.
#include "common.cuh"

namespace {

constexpr int kUnroll = 4;  // entries a lane has in flight
constexpr int kMaxStage = 96 * 1024;  // bytes of x a block stages at most

// MT consecutive values of type TX as one or two vector loads of raw bits
// (two 16-byte loads for 8 f32), widened only when used.
template <typename TX, int MT>
struct Col {
  static constexpr int BYTES = MT * (int)sizeof(TX);
  static constexpr int N = BYTES > 16 ? BYTES / 16 : 1;
  static constexpr int PER = MT / N;
  using T = typename slt::Raw<TX, PER>::T;
  T r[N];

  __device__ __forceinline__ void load(const TX* p) {
    const T* q = reinterpret_cast<const T*>(p);
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = __ldg(q + i);
  }
  __device__ __forceinline__ float at(int m) const {
    return slt::raw_at<TX, PER>(r[m / PER], m % PER);
  }
};

template <typename TX>
__device__ __forceinline__ TX zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

// xt[t, c, m] = x[t * MT + m, c], rows past B zero: one thread an element
// of xt, so its stores are coalesced.
template <typename TX>
__global__ void __launch_bounds__(256)
    spmv_interleave_kernel(const TX* __restrict__ x, TX* __restrict__ xt,
                           int B, int in_f, int mt) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t tiles = (B + mt - 1) / mt;
  if (i >= tiles * in_f * mt) return;
  const int m = (int)(i % mt);
  const size_t tc = i / mt;
  const int c = (int)(tc % in_f);
  const int b = (int)(tc / in_f) * mt + m;
  xt[i] = b < B ? x[(size_t)b * in_f + c] : zero<TX>();
}

// One group of G lanes a CSR row, kThreads / G rows a block, a tile of MT
// batch rows a blockIdx.y; x is (tiles, in, MT): the interleaved copy, or
// at MT = 1 x itself. SX (MT = 1): the tile's row of x is staged in the
// block's dynamic shared memory first.
template <typename TX, int MT, int G, int kThreads, bool SX>
__global__ void __launch_bounds__(kThreads)
    spmv_kernel(const TX* __restrict__ x, const int* __restrict__ rowptr,
                const int* __restrict__ cols, const float* __restrict__ vals,
                const void* __restrict__ y0, int y0_bf16, float* y,
                int accumulate, int B, int in_f, int out_f) {
  const int lane = threadIdx.x % G;
  const int r = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const int b0 = blockIdx.y * MT;
  const bool live = r < out_f;
  // lane m of the group folds and stores batch row b0 + m
  const bool writer = live && lane < MT && b0 + lane < B;
  const size_t yi = (size_t)(b0 + lane) * out_f + r;
  float yv = 0.f, y0v = 0.f;
  if (writer && accumulate) {
    yv = y[yi];
    if (y0 != nullptr)
      y0v = y0_bf16 ? __bfloat162float(
                          static_cast<const __nv_bfloat16*>(y0)[yi])
                    : static_cast<const float*>(y0)[yi];
  }
  // rows past out_f walk nothing but still meet the butterfly's shuffles
  int e = 0, e1 = 0;
  if (live) {
    e = __ldg(rowptr + r) + lane;
    e1 = __ldg(rowptr + r + 1);
  }
  const TX* xs = x + (size_t)blockIdx.y * in_f * MT;
  if constexpr (SX) {  // one row of x, staged in shared memory
    static_assert(MT == 1, "only a tile of one row is staged");
    extern __shared__ uint4 smem_x[];
    TX* sx = reinterpret_cast<TX*>(smem_x);
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(xs) & 15) == 0) {
      const int n16 = in_f * (int)sizeof(TX) / 16;
#pragma unroll 4
      for (int i = threadIdx.x; i < n16; i += kThreads)
        smem_x[i] = __ldg(reinterpret_cast<const uint4*>(xs) + i);
      done = n16 * 16 / (int)sizeof(TX);
    }
    for (int i = done + threadIdx.x; i < in_f; i += kThreads) sx[i] = xs[i];
    __syncthreads();
    xs = sx;
  }
  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;
  for (; e < e1; e += G * kUnroll) {
    int c[kUnroll];
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool ok = e + u * G < e1;
      c[u] = ok ? __ldg(cols + e + u * G) : -1;
      v[u] = ok ? __ldg(vals + e + u * G) : 0.f;
    }
    if constexpr (MT > 1) {
      Col<TX, MT> xv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (c[u] >= 0) xv[u].load(xs + (size_t)c[u] * MT);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (c[u] >= 0) {
#pragma unroll
          for (int m = 0; m < MT; ++m)
            acc[m] = fmaf(v[u], xv[u].at(m), acc[m]);
        }
    } else {  // a plain load: xs may be shared memory
      TX xv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        xv[u] = c[u] >= 0 ? xs[c[u]] : zero<TX>();
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (c[u] >= 0) acc[0] = fmaf(v[u], slt::to_f32(xv[u]), acc[0]);
    }
  }
  // the G lanes' partials: a fixed butterfly (every lane ends with the
  // same sums, as a + b == b + a)
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
#pragma unroll
    for (int m = 0; m < MT; ++m)
      acc[m] = __fadd_rn(acc[m], __shfl_xor_sync(0xffffffffu, acc[m], o));
  if (writer) {
    float s = acc[0];
#pragma unroll
    for (int m = 1; m < MT; ++m)
      if (lane == m) s = acc[m];
    y[yi] = accumulate ? __fadd_rn(__fadd_rn(yv, y0v), s) : s;
  }
}

template <typename TX, int MT, int G, int T, bool SX>
cudaError_t launch(const void* x, void* xt, const int* rowptr,
                   const int* cols, const float* vals, const void* y0,
                   int y0_bf16, float* y, int accumulate, int B, int in_f,
                   int out_f, cudaStream_t s) {
  const dim3 grid((out_f + T / G - 1) / (T / G), (B + MT - 1) / MT);
  const auto* xx = static_cast<const TX*>(x);
  if constexpr (MT > 1) {
    auto* t = static_cast<TX*>(xt);
    const size_t n = (size_t)grid.y * in_f * MT;
    spmv_interleave_kernel<TX><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        xx, t, B, in_f, MT);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    xx = t;
  }
  int smem = 0;
  if constexpr (SX) {
    static bool allowed = false;
    const cudaError_t e = slt::allow_smem(spmv_kernel<TX, MT, G, T, SX>,
                                          kMaxStage, allowed);
    if (e != cudaSuccess) return e;
    smem = (in_f * (int)sizeof(TX) + 15) / 16 * 16;
  }
  spmv_kernel<TX, MT, G, T, SX><<<grid, T, smem, s>>>(
      xx, rowptr, cols, vals, y0, y0_bf16, y, accumulate, B, in_f, out_f);
  return cudaGetLastError();
}

// Threads a block: 512 at one row (fewer, larger blocks, x staged once a
// block where it fits), 128 with a tile of 2-8 rows.
template <typename TX, int MT>
cudaError_t launch_g(int group, const void* x, void* xt, const int* rowptr,
                     const int* cols, const float* vals, const void* y0,
                     int y0_bf16, float* y, int accumulate, int B, int in_f,
                     int out_f, cudaStream_t s) {
#define SLT_SPMV_G(T_, SX_)                                                 \
  switch (group) {                                                          \
    case 8:                                                                 \
      return launch<TX, MT, 8, T_, SX_>(x, xt, rowptr, cols, vals, y0,      \
                                        y0_bf16, y, accumulate, B, in_f,    \
                                        out_f, s);                          \
    case 16:                                                                \
      return launch<TX, MT, 16, T_, SX_>(x, xt, rowptr, cols, vals, y0,     \
                                         y0_bf16, y, accumulate, B, in_f,   \
                                         out_f, s);                         \
    case 32:                                                                \
      return launch<TX, MT, 32, T_, SX_>(x, xt, rowptr, cols, vals, y0,     \
                                         y0_bf16, y, accumulate, B, in_f,   \
                                         out_f, s);                         \
  }
  if constexpr (MT == 1) {
    if (in_f * (int)sizeof(TX) <= kMaxStage) {
      SLT_SPMV_G(512, true)
    } else {
      SLT_SPMV_G(512, false)
    }
  } else {
    SLT_SPMV_G(128, false)
  }
#undef SLT_SPMV_G
  return cudaErrorInvalidValue;
}

template <typename TX>
cudaError_t launch_t(int mt, int group, const void* x, void* xt,
                     const int* rowptr, const int* cols, const float* vals,
                     const void* y0, int y0_bf16, float* y, int accumulate,
                     int B, int in_f, int out_f, cudaStream_t s) {
#define SLT_SPMV_MT(MT_)                                                    \
  case MT_:                                                                 \
    return launch_g<TX, MT_>(group, x, xt, rowptr, cols, vals, y0, y0_bf16, \
                             y, accumulate, B, in_f, out_f, s);
  switch (mt) {
    SLT_SPMV_MT(1)
    SLT_SPMV_MT(2)
    SLT_SPMV_MT(4)
    SLT_SPMV_MT(8)
  }
#undef SLT_SPMV_MT
  return cudaErrorInvalidValue;
}

}  // namespace

// x (B, in) f32 or bf16; mt: batch rows a tile, 1, 2, 4 or 8; xt: with
// mt > 1, scratch of xt_bytes >= ceil(B / mt) * in * mt elements of x's
// type for the interleaved copy (else unused); rowptr int32 (out + 1,),
// cols int32 (nnz,), vals f32 (nnz,); y (B, out) f32: written (accumulate
// 0) or folded in place (accumulate 1, with y0 (B, out) f32 or bf16, or
// null); group: lanes a CSR row, 8, 16 or 32. All contiguous. Returns
// cudaErrorInvalidValue for a tile or scratch it cannot use, else
// cudaGetLastError().
extern "C" int slt_spmv(const void* x, int x_bf16, int mt, void* xt,
                        size_t xt_bytes, const void* rowptr,
                        const void* cols, const void* vals, const void* y0,
                        int y0_bf16, void* y, int accumulate, int B,
                        int in_f, int out_f, int group, void* stream) {
  if (B <= 0 || out_f <= 0) return (int)cudaSuccess;
  if (mt != 1 && mt != 2 && mt != 4 && mt != 8)
    return (int)cudaErrorInvalidValue;
  const size_t need = (size_t)((B + mt - 1) / mt) * in_f * mt *
                      (x_bf16 ? sizeof(__nv_bfloat16) : sizeof(float));
  if (mt > 1 && (xt == nullptr || xt_bytes < need))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* rp = static_cast<const int*>(rowptr);
  const auto* cl = static_cast<const int*>(cols);
  const auto* vl = static_cast<const float*>(vals);
  auto* yy = static_cast<float*>(y);
  const cudaError_t e =
      x_bf16 ? launch_t<__nv_bfloat16>(mt, group, x, xt, rp, cl, vl, y0,
                                       y0_bf16, yy, accumulate, B, in_f,
                                       out_f, s)
             : launch_t<float>(mt, group, x, xt, rp, cl, vl, y0, y0_bf16, yy,
                               accumulate, B, in_f, out_f, s);
  return (int)e;
}
