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
// K10 (slt_lut_matmul_struct) is the same three kernels with a second table
// form, for 4-bit STRUCTURED codebooks lut[c] = A[c & 7] + (c >> 3) * d
// (quantize/kmeans.fit_structured_luts). It replaces the structured bodies
// of the TPU kernels (`_dequant_plane_struct_sel` and the structured branch
// of `_lut_matmul_body`, squeezellm_tpu/ops/pallas_ops.py:161-205,
// 311-342). The block builds its 16-entry shared table from A (out, 8) and
// d (out,), W = A[c & 7] + (c & 8 ? d : 0) in f32 (rounded to bf16 in bf16
// mode, as the TPU's one-pass MXU rounds the dequantized operand); the
// rest is K1's.
//
// mode bf16 rounds x and the table to bf16 before the products (f32
// accumulation); the sparse fold always reads x unrounded, transposed
// (xt, made by the wrapper; x itself at one row) and from L2.
//
// Three kernels, picked per call by the caller and laid out by the wrapper
// (ops/lut_matmul.py `plan`, a pure function): the call site picks, never
// the row count, so a row's bits do not depend on its batch.
//
// gemv_kernel, exact mode's kernel at every row count (16 rows a tile).
// Bound by the packed words' bytes (25 MB for the fused 4-bit q|k|v of
// LLaMA-2-7B, 7.5 us at 3.35 TB/s). Design:
//  * a block owns 128 output columns; a lane owns 4 adjacent ones, so a
//    warp reads a word row's 512 contiguous bytes;
//  * the words are split across `splits` blocks of a column tile (the
//    k-split) as well as the block's 8 warps, so that a 4096-wide output
//    still fills every SM; the split is the one-row tile's at every row
//    count, so a row is summed in the same order whatever is batched with
//    it (exact mode's tokens then do not depend on the batch);
//  * a 4-stage cp.async ring brings 16-word stages (16-byte copies; 4-byte
//    ones for a ragged `out` or unaligned words) and the matching x rows,
//    so 3 stages are in flight while one is multiplied; x is read as
//    vectors of a word row's codes and converted (rounded in bf16 mode)
//    in registers;
//  * the table lives in shared memory as [code][column % 4][lane]: lane
//    l's entries all lie in bank l, so 32 lookups of any codes never
//    conflict, and an entry's address is the lane's base OR'd with the
//    code's bits (one shift, one LOP3, one load);
//  * the sidecar's fold runs in blocks of its own (`folds` a column tile,
//    launched first, so that its dependent gathers overlap the word
//    stream): 8 lanes a column, each an equal part of the column's
//    entries, summed by a fixed butterfly of shuffles, so no thread walks
//    a long row alone;
//  * the warps' partials are summed in a fixed tree through shared memory;
//    a tile's partials (its folds, then its splits) go to a workspace and
//    the LAST block of the tile to arrive (an atomic counter decides which
//    block; no value is summed by an atomic) adds them in order, then y0.
//    Same inputs, same bits, every launch.
//
// dec_mma_kernel, bf16 mode's decode calls (a decode step at any slot
// count, a verify window of at most 16 rows): the GEMV's products, bf16 x
// bf16 with f32 accumulation, on the tensor cores, so that 16 rows cost
// about what one does. Bound by the words' bytes at every decode row count.
// mma.sync m16n8k16 with the weights as A (16 output columns an m-tile)
// and the x rows as N (one n8 tile up to 8 rows, two up to 16; 16-row
// tiles beyond):
//  * k is permuted inside each group of 4 word rows, for A and x alike:
//    lane (g, t) of a warp takes all its A elements of a group's products
//    from word row t of the group (product h, h < ceil(codes / 4), takes
//    codes 4h .. 4h + 3; 3-bit words pad the last product with zeros), and
//    its x from those codes' inputs, one vector load a row;
//  * each A row is one column: lane (g, t) of column quarter p holds
//    columns 4g .. 4g + 3 of its 32 (m-tiles 2p, 2p + 1), so one 16-byte
//    load brings its four words; staged word rows are padded to 136 words,
//    so those loads never conflict;
//  * the words are dequantized straight into A fragments through the
//    block's bf16-rounded table, kept 4 times ([code][column % 4][column /
//    4][t]), so that the 4 lanes of a column read 4 banks and 32 lookups of
//    any codes never conflict (one shift, one LOP3, one load an element;
//    pairs joined by one PRMT);
//  * the GEMV's ring (16-word stages), its sidecar fold blocks and its
//    last-block sum of a tile's partials; warp w takes word group w % 4 of
//    a stage and column half w / 4, and the 4 warps of a half are summed in
//    a fixed tree. The fold blocks (`folds` a column tile) come after the
//    word blocks, whose partials come first in the sum: a fold block holds
//    one of an SM's two slots as a word block does, so fold blocks
//    launched first would keep the word stream waiting. The last block
//    loads each partial of its tile's values together (a trip to L2 a
//    partial, not one a value);
//  * the k-split is fixed per layer shape and no sum depends on the row
//    count, nor on whether a call runs one n8 tile or two: a row gets the
//    same bits at any M and any place in the batch.
//
// mma_kernel, bf16 mode's other calls (prompts, prefill chunks, verify
// windows of more than 16 rows, an eval forward below 1024 rows): bound by
// the products from ~80 rows, which are bf16 x bf16 with f32 accumulation,
// what the tensor cores do at 989 TFLOP/s. A block computes 64 rows x 128
// columns:
//  * a 4-stage cp.async ring brings 8-word tiles of qweight and the
//    matching bf16 x tile; a k-step ahead of the products, each stage's
//    words are dequantized through the bf16-rounded shared table into one
//    of two bf16 B tiles [column][k] (exact: W is the plain version's bit
//    for bit), so one barrier a k-step orders copies, dequantization and
//    products;
//  * 8 warps (2 x 4), each 32 x 32, run mma.sync m16n8k16 bf16 with f32
//    accumulators from ldmatrix fragments (rows padded by 16 bytes: no
//    bank conflicts);
//  * the sidecar's fold block and the k-split end as in the GEMV; the
//    k-split is fixed per layer shape, whatever the row count.
// f32 x in bf16 mode is rounded on its way into shared memory through
// registers (not cp.async), and into the decode kernel's B fragments in
// registers. Exact mode never takes either tensor-core kernel: TF32 or
// bf16 operands would change its numbers.
//
// The three kernels' bodies and helpers live in csrc/lut_kernels.cuh,
// which K13 (csrc/moe_lut.cu) includes too for its grouped decode and
// prefill kernels; this file launches K1 and K10.
#include "lut_kernels.cuh"

namespace {

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct Args {
  const void* x;
  int x_bf16;
  const void* xt;
  const uint32_t* qw;
  const float* lut;
  const float* sd;
  const int* rowptr;
  const int* cols;
  const float* vals;
  const void* y0;
  int y0_bf16;
  float* y;
  float* ws;
  int* counters;
  int M, in_f, out_f, bf16_mode, variant, row_tile, splits, words_per_split,
      folds;
};

using slt::allow_smem;

template <int BITS, int MT, typename XT>
cudaError_t launch_gemv(const Args& a, dim3 grid, int xalign, int vec,
                        cudaStream_t s) {
  constexpr int smem = GemvShape<BITS, MT, XT>::SMEM;
  static bool done = false;
  const cudaError_t e = allow_smem(gemv_kernel<BITS, MT, XT>, smem, done);
  if (e != cudaSuccess) return e;
  gemv_kernel<BITS, MT, XT><<<grid, kThreads, smem, s>>>(
      static_cast<const XT*>(a.x), a.xt, xalign, a.qw, a.lut, a.sd, a.rowptr,
      a.cols, a.vals, a.y0, a.y0_bf16, a.y, a.ws, a.counters, a.M, a.in_f,
      a.out_f, a.bf16_mode, vec, a.splits, a.words_per_split, a.folds);
  return cudaGetLastError();
}

template <int BITS, typename XT>
cudaError_t launch_mma(const Args& a, dim3 grid, int xalign, int vec,
                       cudaStream_t s) {
  constexpr int smem = MmaShape<BITS>::SMEM;
  static bool done = false;
  const cudaError_t e = allow_smem(mma_kernel<BITS, XT>, smem, done);
  if (e != cudaSuccess) return e;
  mma_kernel<BITS, XT><<<grid, kThreads, smem, s>>>(
      static_cast<const XT*>(a.x), a.xt, xalign, a.qw, a.lut, a.sd, a.rowptr,
      a.cols, a.vals, a.y0, a.y0_bf16, a.y, a.ws, a.counters, a.M, a.in_f,
      a.out_f, vec, a.splits, a.words_per_split, a.folds);
  return cudaGetLastError();
}

template <int BITS, int NT, typename XT>
cudaError_t launch_dec(const Args& a, dim3 grid, int xalign, int vec,
                       cudaStream_t s) {
  constexpr int smem = DecShape<BITS, NT, XT>::SMEM;
  static bool done = false;
  const cudaError_t e = allow_smem(dec_mma_kernel<BITS, NT, XT>, smem, done);
  if (e != cudaSuccess) return e;
  dec_mma_kernel<BITS, NT, XT><<<grid, kThreads, smem, s>>>(
      static_cast<const XT*>(a.x), a.xt, xalign, a.qw, a.lut, a.sd, a.rowptr,
      a.cols, a.vals, a.y0, a.y0_bf16, a.y, a.ws, a.counters, a.M, a.in_f,
      a.out_f, vec, a.splits, a.words_per_split, a.folds);
  return cudaGetLastError();
}

template <int BITS, typename XT>
cudaError_t launch_x(const Args& a, dim3 grid, int xalign, int vec,
                     cudaStream_t s) {
  if (a.variant == 1) {  // tensor cores, bf16 mode
    if (!a.bf16_mode || a.row_tile != kMmaRows) return cudaErrorInvalidValue;
    return launch_mma<BITS, XT>(a, grid, xalign, vec, s);
  }
  if (a.variant == 2) {  // the decode calls' tensor-core kernel, bf16 mode
    if (!a.bf16_mode) return cudaErrorInvalidValue;
    if (a.row_tile == 8)
      return launch_dec<BITS, 1, XT>(a, grid, xalign, vec, s);
    if (a.row_tile == 16)
      return launch_dec<BITS, 2, XT>(a, grid, xalign, vec, s);
    return cudaErrorInvalidValue;
  }
  if (a.variant != 0) return cudaErrorInvalidValue;
  switch (a.row_tile) {
    case 1: return launch_gemv<BITS, 1, XT>(a, grid, xalign, vec, s);
    case 2: return launch_gemv<BITS, 2, XT>(a, grid, xalign, vec, s);
    case 4: return launch_gemv<BITS, 4, XT>(a, grid, xalign, vec, s);
    case 8: return launch_gemv<BITS, 8, XT>(a, grid, xalign, vec, s);
    case 16: return launch_gemv<BITS, 16, XT>(a, grid, xalign, vec, s);
  }
  return cudaErrorInvalidValue;
}

template <int BITS>
int launch(const Args& a, cudaStream_t s) {
  if (a.M <= 0 || a.out_f <= 0) return (int)cudaSuccess;
  const int nw = (a.in_f + Pack<BITS>::CPW - 1) / Pack<BITS>::CPW;
  if (a.splits < 1 || a.words_per_split < 1 || a.words_per_split % 8 ||
      (long long)a.splits * a.words_per_split < nw ||
      (a.folds > 0) != (a.rowptr != nullptr) ||
      (a.splits + a.folds > 1 && (!a.ws || !a.counters)))
    return (int)cudaErrorInvalidValue;
  const int vec = a.out_f % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(a.qw) % 16 == 0;
  // the widest copy x's rows allow: 16 bytes, 4 (an f32, a bf16 pair), 2
  const int e = a.x_bf16 ? 2 : 4;
  const uintptr_t xp = reinterpret_cast<uintptr_t>(a.x);
  const int xalign = (xp % 16 == 0 && a.in_f * e % 16 == 0)  ? 16
                     : (xp % 4 == 0 && a.in_f * e % 4 == 0) ? 4
                                                              : 2;
  const dim3 grid((a.out_f + kCols - 1) / kCols, a.folds + a.splits,
                  (a.M + a.row_tile - 1) / a.row_tile);
  if (a.x_bf16)
    return (int)launch_x<BITS, __nv_bfloat16>(a, grid, xalign, vec, s);
  return (int)launch_x<BITS, float>(a, grid, xalign, vec, s);
}

}  // namespace

// x (M, in) f32 or bf16; xt: x transposed (in, M), the sidecar fold's
// copy (x itself at one row), or null without a sidecar; qweight int32
// (n_words, out); lut f32 (out, 2^bits); rowptr/cols/vals: CSR sidecar or
// all null; y0 (M, out) f32/bf16 or null; y (M, out) f32; folds: the
// sidecar's blocks a column tile (0 without one); ws: f32 (folds + splits,
// M, out) when that is above 1, else null; counters: int32, one per
// (row tile, column tile), all 0 (each launch leaves them 0). variant 0 =
// GEMV (row_tile 1/2/4/8/16), 1 = MMA (bf16 mode, row_tile 64), 2 = DEC
// (bf16 mode, row_tile 8/16);
// words_per_split a multiple of 8 covering the words in `splits` parts.
// All contiguous. Returns cudaGetLastError().
extern "C" int slt_lut_matmul(const void* x, int x_bf16, const void* xt,
                              const void* qweight, const void* lut,
                              const void* rowptr, const void* cols,
                              const void* vals, const void* y0, int y0_bf16,
                              void* y, void* ws, void* counters, int M,
                              int in_f, int out_f, int bits, int bf16_mode,
                              int variant, int row_tile, int splits,
                              int words_per_split, int folds, void* stream) {
  const Args a{x, x_bf16, xt, static_cast<const uint32_t*>(qweight),
               static_cast<const float*>(lut), nullptr,
               static_cast<const int*>(rowptr), static_cast<const int*>(cols),
               static_cast<const float*>(vals), y0, y0_bf16,
               static_cast<float*>(y), static_cast<float*>(ws),
               static_cast<int*>(counters), M, in_f, out_f, bf16_mode,
               variant, row_tile, splits, words_per_split, folds};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 4) return launch<4>(a, s);
  if (bits == 3) return launch<3>(a, s);
  return (int)cudaErrorInvalidValue;
}

// K10: slt_lut_matmul's arguments with the structured table A (out, 8) f32
// and d (out,) f32 in place of lut, at 4 bits.
extern "C" int slt_lut_matmul_struct(
    const void* x, int x_bf16, const void* xt, const void* qweight,
    const void* a_tab, const void* d, const void* rowptr, const void* cols,
    const void* vals, const void* y0, int y0_bf16, void* y, void* ws,
    void* counters, int M, int in_f, int out_f, int bf16_mode, int variant,
    int row_tile, int splits, int words_per_split, int folds,
    void* stream) {
  const Args a{x, x_bf16, xt, static_cast<const uint32_t*>(qweight),
               static_cast<const float*>(a_tab), static_cast<const float*>(d),
               static_cast<const int*>(rowptr), static_cast<const int*>(cols),
               static_cast<const float*>(vals), y0, y0_bf16,
               static_cast<float*>(y), static_cast<float*>(ws),
               static_cast<int*>(counters), M, in_f, out_f, bf16_mode,
               variant, row_tile, splits, words_per_split, folds};
  return launch<4>(a, static_cast<cudaStream_t>(stream));
}

extern "C" const char* slt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
