// K13: K1's LUT-dequant matmul grouped over a layer's experts, routed from
// device memory, and the combine of the experts' outputs.
//
//   y[p, o] = sum_{e in CSR row o of expert x_p} vals[e] * x[p, cols[e]]
//           + sum_i x[p, i] * lut_x[o, code_x(i, o)]
//           + sum_j [o == tidx_x[j]] * sum_i x[p, i] * tw_x[j, i]
//
// for every row p of x, x_p the expert whose rows [offsets[x_p],
// offsets[x_p + 1]) hold p: the caller sorts a layer's (token, expert)
// pairs by expert (models/moe.py) and writes the offsets on the card. It
// replaces no TPU kernel: the JAX package has no sparse experts. It exists
// because a decode step is a CUDA graph and how many rows each expert gets
// changes from step to step: a host loop over experts cannot be captured,
// reading the counts on the host breaks the capture, and a masked pass over
// every expert reads all their words. So one launch serves every expert of
// a layer and each block finds its rows in device memory.
//
// Bound, like K1, by the words of the experts that rows chose (a Mellum2
// expert's gate|up: 2.1 MB of codes; at 16 slots about 56 of a layer's 64
// experts), and from ~80 rows an expert by the products. Design:
//  * the grid is (column tiles, k-split + folds, row tiles); row tile z
//    belongs to expert tiles[z] and starts at row tiles[ntiles + z], a map
//    that ops/moe_lut.tile_map writes on the card from the offsets. Its
//    size depends on the row count alone, so a graph captures the launch
//    once for every routing. A tile no expert owns (-1) leaves at once: an
//    expert that no row chose has no tile, and its words are never read;
//  * moe_dec_kernel runs K1's decode body (dec_body: mma.sync m16n8k16, the
//    x rows as N in 8- or 16-row tiles, any row count an expert) for bf16
//    mode's decode calls, moe_mma_kernel K1's prefill body (mma_body,
//    64-row tiles) for its other calls; each block takes its expert's
//    words, LUT and sidecar rows at that expert's place in the stacked
//    operands;
//  * the sidecar is folded as K1 folds it (fold blocks of their own, summed
//    into the tile by its last block), and the first fold block of a column
//    tile also adds the expert's top-X columns that lie in it (topx_tile),
//    from the rows of x and the expert's top-X rows stored transposed;
//  * the k-split and the folds follow the layer's shape and the experts a
//    row chooses (ops/moe_lut.plan), never the routing, and no sum depends
//    on the rows beside a row: a row's bits are the same whatever other
//    rows share its step or its expert.
//
// moe_combine_kernel: out[t, c] = res[t, c] + sum_{j < k} w[t, j] *
// d[inv[t, j], c], the sum in f32 in the order j = 0 .. k - 1, each product
// and add rounded on its own (no fused multiply-add, as the plain version's
// separate tensor operations round), the residual added last.
#include "lut_kernels.cuh"

namespace {

template <int BITS, int NT, typename XT>
__global__ void __launch_bounds__(kThreads, 2)
    moe_dec_kernel(const XT* __restrict__ x, const void* xt, int xalign,
                   const uint32_t* __restrict__ qw,
                   const float* __restrict__ lut,
                   const int* __restrict__ rowptr,
                   const int* __restrict__ cols,
                   const float* __restrict__ vals, float* __restrict__ y,
                   float* ws, int* counters, int M, int in_f, int out_f,
                   int vec, int splits, int words_per_split, int folds,
                   MoeTiles moe) {
  dec_body<BITS, NT, XT, true>(x, xt, xalign, qw, lut, nullptr, rowptr, cols,
                               vals, nullptr, 0, y, ws, counters, M, in_f,
                               out_f, vec, splits, words_per_split, folds,
                               moe);
}

template <int BITS, typename XT>
__global__ void __launch_bounds__(kThreads)
    moe_mma_kernel(const XT* __restrict__ x, const void* xt, int xalign,
                   const uint32_t* __restrict__ qw,
                   const float* __restrict__ lut,
                   const int* __restrict__ rowptr,
                   const int* __restrict__ cols,
                   const float* __restrict__ vals, float* __restrict__ y,
                   float* ws, int* counters, int M, int in_f, int out_f,
                   int vec, int splits, int words_per_split, int folds,
                   MoeTiles moe) {
  mma_body<BITS, XT, true>(x, xt, xalign, qw, lut, nullptr, rowptr, cols,
                           vals, nullptr, 0, y, ws, counters, M, in_f, out_f,
                           vec, splits, words_per_split, folds, moe);
}

struct MoeArgs {
  const void* x;
  int x_bf16;
  const void* xt;
  const uint32_t* qw;
  const float* lut;
  const int* rowptr;
  const int* cols;
  const float* vals;
  float* y;
  float* ws;
  int* counters;
  int P, in_f, out_f, variant, row_tile, splits, words_per_split, folds;
  MoeTiles moe;
};

using slt::allow_smem;

template <typename Kernel, typename XT>
cudaError_t launch_one(Kernel kernel, int smem, bool& done,
                       const MoeArgs& a, dim3 grid, int xalign, int vec,
                       cudaStream_t s) {
  const cudaError_t e = allow_smem(kernel, smem, done);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const XT*>(a.x), a.xt, xalign, a.qw, a.lut, a.rowptr,
      a.cols, a.vals, a.y, a.ws, a.counters, a.P, a.in_f, a.out_f, vec,
      a.splits, a.words_per_split, a.folds, a.moe);
  return cudaGetLastError();
}

template <int BITS, typename XT>
cudaError_t launch_x(const MoeArgs& a, dim3 grid, int xalign, int vec,
                     cudaStream_t s) {
  if (a.variant == 1) {  // prefill: 64-row tiles
    if (a.row_tile != kMmaRows) return cudaErrorInvalidValue;
    static bool done = false;
    return launch_one<decltype(&moe_mma_kernel<BITS, XT>), XT>(
        moe_mma_kernel<BITS, XT>, MmaShape<BITS>::SMEM, done, a, grid,
        xalign, vec, s);
  }
  if (a.variant == 2) {  // decode: 8- or 16-row tiles
    if (a.row_tile == 8) {
      static bool done = false;
      return launch_one<decltype(&moe_dec_kernel<BITS, 1, XT>), XT>(
          moe_dec_kernel<BITS, 1, XT>, DecShape<BITS, 1, XT>::SMEM, done, a,
          grid, xalign, vec, s);
    }
    if (a.row_tile == 16) {
      static bool done = false;
      return launch_one<decltype(&moe_dec_kernel<BITS, 2, XT>), XT>(
          moe_dec_kernel<BITS, 2, XT>, DecShape<BITS, 2, XT>::SMEM, done, a,
          grid, xalign, vec, s);
    }
  }
  return cudaErrorInvalidValue;
}

template <int BITS>
int launch(const MoeArgs& a, cudaStream_t s) {
  if (a.P <= 0 || a.out_f <= 0 || a.moe.ntiles <= 0)
    return (int)cudaSuccess;
  const int nw = (a.in_f + Pack<BITS>::CPW - 1) / Pack<BITS>::CPW;
  const bool extra = a.rowptr != nullptr || a.moe.topx > 0;
  if (a.splits < 1 || a.words_per_split < 1 || a.words_per_split % 8 ||
      (long long)a.splits * a.words_per_split < nw ||
      (a.folds > 0) != extra || (a.moe.topx > 0 && !a.moe.tw) ||
      (a.splits + a.folds > 1 && (!a.ws || !a.counters)))
    return (int)cudaErrorInvalidValue;
  const int vec = a.out_f % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(a.qw) % 16 == 0;
  const int e = a.x_bf16 ? 2 : 4;
  const uintptr_t xp = reinterpret_cast<uintptr_t>(a.x);
  const int xalign = (xp % 16 == 0 && a.in_f * e % 16 == 0)  ? 16
                     : (xp % 4 == 0 && a.in_f * e % 4 == 0) ? 4
                                                              : 2;
  const dim3 grid((a.out_f + kCols - 1) / kCols, a.splits + a.folds,
                  a.moe.ntiles);
  if (a.x_bf16) return (int)launch_x<BITS, __nv_bfloat16>(a, grid, xalign,
                                                           vec, s);
  return (int)launch_x<BITS, float>(a, grid, xalign, vec, s);
}

template <typename T>
__global__ void moe_combine_kernel(const float* __restrict__ d,
                                   const long long* __restrict__ inv,
                                   const float* __restrict__ w,
                                   const T* __restrict__ res,
                                   T* __restrict__ out, int rows, int k,
                                   int n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)rows * n) return;
  const int t = (int)(i / n), c = (int)(i % n);
  float s = 0.f;
  for (int j = 0; j < k; ++j)
    s = __fadd_rn(s, __fmul_rn(w[t * k + j], d[inv[t * k + j] * n + c]));
  const float r = res ? slt::to_f32(res[i]) : 0.f;
  slt::store_f32(__fadd_rn(r, s), out + i);
}

}  // namespace

// x (P, in) f32 or bf16, rows sorted by expert; xt: x transposed (in, P)
// for the sidecar's fold, or null without a sidecar; qweight int32
// (E, n_words, out); lut f32 (E, out, 2^bits); rowptr int32 (E, out + 1)
// into cols/vals (int32, f32), or all three null; topx_w f32 (E, topx, in)
// and topx_idx int32 (E, topx), or null with topx 0; offsets int32 (E + 1);
// tiles int32 (2, ntiles): each row tile's expert (-1: none) and first
// row; y (P, out) f32; ws f32 (splits + folds, P, out) when that is above
// 1, else null; counters int32, ntiles x column tiles, all 0 (each launch
// leaves them 0); variant 1 = prefill (row_tile 64), 2 = decode (row_tile
// 8/16); folds > 0 exactly when a sidecar or top-X rows are given. bf16
// mode only. All contiguous. Returns cudaGetLastError().
extern "C" int slt_moe_lut_matmul(
    const void* x, int x_bf16, const void* xt, const void* qweight,
    const void* lut, const void* rowptr, const void* cols, const void* vals,
    const void* topx_w, const void* topx_idx, int topx, const void* offsets,
    const void* tiles, int ntiles, void* y, void* ws, void* counters, int P,
    int in_f, int out_f, int bits, int variant, int row_tile, int splits,
    int words_per_split, int folds, void* stream) {
  const MoeTiles moe{static_cast<const int*>(offsets),
                     static_cast<const int*>(tiles), ntiles,
                     static_cast<const int*>(topx_idx),
                     static_cast<const float*>(topx_w), topx};
  const MoeArgs a{x, x_bf16, xt, static_cast<const uint32_t*>(qweight),
                  static_cast<const float*>(lut),
                  static_cast<const int*>(rowptr),
                  static_cast<const int*>(cols),
                  static_cast<const float*>(vals), static_cast<float*>(y),
                  static_cast<float*>(ws), static_cast<int*>(counters), P,
                  in_f, out_f, variant, row_tile, splits, words_per_split,
                  folds, moe};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 4) return launch<4>(a, s);
  if (bits == 3) return launch<3>(a, s);
  return (int)cudaErrorInvalidValue;
}

// d (P, n) f32, the experts' outputs in the pairs' order; inv int64
// (rows, k): where row t's j-th pair lies; w f32 (rows, k); res (rows, n)
// bf16 or f32 (bf16 set) or null; out (rows, n) of res's type.
extern "C" int slt_moe_combine(const void* d, const void* inv, const void* w,
                               const void* res, void* out, int rows, int k,
                               int n, int bf16, void* stream) {
  const long long total = (long long)rows * n;
  if (total <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* dp = static_cast<const float*>(d);
  const auto* ip = static_cast<const long long*>(inv);
  const auto* wp = static_cast<const float*>(w);
  if (bf16)
    moe_combine_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        dp, ip, wp, static_cast<const __nv_bfloat16*>(res),
        static_cast<__nv_bfloat16*>(out), rows, k, n);
  else
    moe_combine_kernel<float><<<blocks, threads, 0, s>>>(
        dp, ip, wp, static_cast<const float*>(res), static_cast<float*>(out),
        rows, k, n);
  return (int)cudaGetLastError();
}
