// K4: dequantize packed words + per-channel LUT to a dense weight, with the
// sparse sidecar folded in.
//
//   W[i, o] = lut[o, code(i, o)]            (first launch)
//   W[cols[e], o] += vals[e]  for e in CSR row o, in CSR order (second launch)
//
// Replaces the TPU kernel `_dequant_dense_kernel`
// (squeezellm_tpu/ops/pallas_ops.py, launched by `_lut_matmul_bigbatch`) and
// the scatter-add of the COO sidecar into its scratch. The caller multiplies
// x by W with one dense matmul, as the JAX package does.
//
// W is plain row-major (in, out) with exactly `in` rows: the TPU scratch's
// block-plane-major row order and its padded tail rows are Mosaic's and are
// not carried over, so x needs no relayout.
//
// Bound on the H100: bytes. The packed words, the LUT and the CSR arrays are
// read once and W is written once (the fused 4-bit gate|up of LLaMA-2-7B:
// 45 MB read, 180 MB written in bf16, ~0.067 ms at 3.35 TB/s); the work per
// byte is a shift, a mask and a shared-memory read. Design:
//  * one thread per packed word: the `out` axis is contiguous in both the
//    words and W, so a warp reads 128 contiguous bytes and each of its 8 or
//    10 stores writes 32 contiguous elements of one row of W;
//  * a block covers 128 columns x 32 word rows, so the columns' LUT rows
//    (staged once in shared memory as lut_s[code][col], conflict-free) cost
//    1/16 of the bytes the block writes;
//  * the codes of the last word past `in` are skipped: W has no such rows;
//  * the fold runs as a second launch on the same stream, after every
//    column is written. One thread owns one output channel's CSR row and
//    walks it in order, so duplicates of a slot add one after the other and
//    no atomics are needed: the result is the same every run. Entries with
//    vals == 0 (padding) add nothing.
// bf16 mode rounds where the JAX package does: the LUT to bf16 before the
// gather (so W holds it exactly), each sidecar value to bf16, and their sum
// to bf16 again: a folded slot holds bf16(bf16(lut) + bf16(v)).
#include "common.cuh"

namespace {

constexpr int kCols = 128;        // output columns per block
constexpr int kWordLanes = 2;     // word rows in flight per block
constexpr int kThreads = kCols * kWordLanes;
constexpr int kWordsPerBlock = 32;

template <int BITS, typename TW>
__global__ void __launch_bounds__(kThreads)
    dequant_dense_kernel(const uint32_t* __restrict__ qw,
                         const float* __restrict__ lut, TW* __restrict__ w,
                         int in_f, int out_f, int nw, int round_lut) {
  constexpr int CPW = BITS == 4 ? 8 : 10;  // codes per int32 word
  constexpr int K = 1 << BITS;
  __shared__ float lut_s[K][kCols];

  const int c = threadIdx.x % kCols;
  const int wl = threadIdx.x / kCols;
  const int col0 = blockIdx.x * kCols;
  const int col = col0 + c;
  const int w0 = blockIdx.y * kWordsPerBlock;

  // the block's LUT rows are kCols * K contiguous floats of lut (out, K)
  for (int t = threadIdx.x; t < kCols * K; t += kThreads) {
    const int cc = t / K, k = t % K;
    const float v = (col0 + cc < out_f) ? lut[(size_t)(col0 + cc) * K + k]
                                        : 0.f;
    lut_s[k][cc] = round_lut ? slt::round_bf16(v) : v;
  }
  __syncthreads();
  if (col >= out_f) return;

  const int w_end = min(w0 + kWordsPerBlock, nw);
  for (int wi = w0 + wl; wi < w_end; wi += kWordLanes) {
    const uint32_t word = __ldg(qw + (size_t)wi * out_f + col);
    const int i0 = wi * CPW;
    const int valid = min(CPW, in_f - i0);  // the last word's tail is cut
#pragma unroll
    for (int j = 0; j < CPW; ++j) {
      if (j < valid) {
        const uint32_t code = (word >> (BITS * j)) & (uint32_t)(K - 1);
        slt::store_f32(lut_s[code][c], w + (size_t)(i0 + j) * out_f + col);
      }
    }
  }
}

template <typename TW>
__global__ void sparse_fold_kernel(const int* __restrict__ rowptr,
                                   const int* __restrict__ cols,
                                   const float* __restrict__ vals, TW* w,
                                   int in_f, int out_f) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= out_f) return;
  for (int e = rowptr[o]; e < rowptr[o + 1]; ++e) {
    const int i = cols[e];
    if (i < 0 || i >= in_f) continue;
    TW* p = w + (size_t)i * out_f + o;
    // both operands in W's type, the sum rounded to it (f32: a plain add)
    float v = vals[e];
    if (sizeof(TW) == 2) v = slt::round_bf16(v);
    slt::store_f32(__fadd_rn(slt::to_f32(*p), v), p);
  }
}

template <int BITS, typename TW>
void launch(cudaStream_t s, const uint32_t* qw, const float* lut,
            const int* rowptr, const int* cols, const float* vals, void* w,
            int in_f, int out_f, int nw, int round_lut) {
  const dim3 grid((out_f + kCols - 1) / kCols,
                  (nw + kWordsPerBlock - 1) / kWordsPerBlock);
  dequant_dense_kernel<BITS, TW><<<grid, kThreads, 0, s>>>(
      qw, lut, static_cast<TW*>(w), in_f, out_f, nw, round_lut);
  if (rowptr != nullptr) {
    constexpr int kFoldThreads = 128;
    sparse_fold_kernel<TW>
        <<<(out_f + kFoldThreads - 1) / kFoldThreads, kFoldThreads, 0, s>>>(
            rowptr, cols, vals, static_cast<TW*>(w), in_f, out_f);
  }
}

}  // namespace

// qweight int32 (n_words, out); lut f32 (out, 2^bits); rowptr/cols/vals: the
// CSR sidecar or all null; w (in, out) bf16 (w_bf16: the LUT is rounded to
// bf16 first) or f32, written in full. All contiguous. Returns
// cudaGetLastError().
extern "C" int slt_dequant_dense(const void* qweight, const void* lut,
                                 const void* rowptr, const void* cols,
                                 const void* vals, void* w, int in_f,
                                 int out_f, int bits, int w_bf16,
                                 void* stream) {
  if (in_f <= 0 || out_f <= 0) return (int)cudaSuccess;
  if (bits != 3 && bits != 4) return (int)cudaErrorInvalidValue;
  const int cpw = bits == 4 ? 8 : 10;
  const int nw = (in_f + cpw - 1) / cpw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qw = static_cast<const uint32_t*>(qweight);
  const auto* lt = static_cast<const float*>(lut);
  const auto* rp = static_cast<const int*>(rowptr);
  const auto* cl = static_cast<const int*>(cols);
  const auto* vl = static_cast<const float*>(vals);
  if (bits == 4 && w_bf16)
    launch<4, __nv_bfloat16>(s, qw, lt, rp, cl, vl, w, in_f, out_f, nw, 1);
  else if (bits == 4)
    launch<4, float>(s, qw, lt, rp, cl, vl, w, in_f, out_f, nw, 0);
  else if (w_bf16)
    launch<3, __nv_bfloat16>(s, qw, lt, rp, cl, vl, w, in_f, out_f, nw, 1);
  else
    launch<3, float>(s, qw, lt, rp, cl, vl, w, in_f, out_f, nw, 0);
  return (int)cudaGetLastError();
}
