// K1's kernel bodies and their helpers, shared by csrc/lut_matmul.cu (K1
// and K10, whose design notes they are) and csrc/moe_lut.cu (K13, which
// runs the decode and prefill tensor-core bodies over a layer's stacked
// experts: ``MoeTiles``, ``block_rows``). Everything here lives in an
// anonymous namespace, so each source that includes it compiles its own
// copy of what it instantiates.
#pragma once

#include "common.cuh"

namespace {

constexpr int kCols = 128;  // output columns per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCsStride = kCols + 4;  // an f32 tile row in shared memory

template <int BITS>
struct Pack {
  static constexpr int CPW = BITS == 4 ? 8 : 10;  // codes per int32 word
  static constexpr int K = 1 << BITS;
};

__device__ __forceinline__ float load_act(const void* p, int is_bf16,
                                          size_t i) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

using slt::cp_async_commit;
using slt::cp_async_part;
using slt::cp_async_wait;

// Table value of code k for column col (0 past out_f): lut[col][k], or for
// a structured table (sd set, 4-bit) A (out, 8) and d (out,).
template <int K>
__device__ __forceinline__ float table_value(const float* lut,
                                             const float* sd, int col, int k,
                                             int out_f) {
  if (col >= out_f) return 0.f;
  if (sd) {
    float v = lut[(size_t)col * 8 + (k & 7)];
    if (k & 8) v += sd[col];
    return v;
  }
  return lut[(size_t)col * K + k];
}

// The block's table for the GEMV and the MMA kernel: tab[slot(c, k)] =
// table value of code k for column col0 + c, rounded in bf16 mode (the MMA
// kernel keeps it as bf16, ready for its B tiles).
template <int K, bool LANE_MAJOR, typename T>  // float; uint32_t
__device__ __forceinline__ void load_table(T* tab, const float* lut,
                                           const float* sd, int col0,
                                           int out_f, int bf16_mode) {
  for (int t = threadIdx.x; t < kCols * K; t += kThreads) {
    const int c = t / K, k = t % K;
    const float v = table_value<K>(lut, sd, col0 + c, k, out_f);
    // GEMV: [k][c % 4][c / 4]: lane l's entries (columns 4l..4l+3) all lie
    // in bank l, so 32 lookups of any codes never conflict, and an entry's
    // byte offset is the lane's base OR'd with k << 9 (lut_offsets);
    // MMA: [k][c] as 32-bit words, bf16 in the low half (bank c % 32)
    const int slot = LANE_MAJOR ? k * kCols + (c & 3) * 32 + (c >> 2)
                                : k * kCols + c;
    if constexpr (LANE_MAJOR)
      tab[slot] = bf16_mode ? slt::round_bf16(v) : v;
    else
      tab[slot] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
}

// Byte offsets of a lane's 4 columns in the GEMV's table (load_table's
// LANE_MAJOR layout): code k of column lane * 4 + q is at b[q] | (k << 9).
__device__ __forceinline__ void lut_offsets(uint32_t (&b)[4], int lane) {
#pragma unroll
  for (int q = 0; q < 4; ++q) b[q] = (q * 32 + lane) * 4;
}

// code j of word wd, shifted to its table row's byte offset (k << 9)
template <int BITS, int J>
__device__ __forceinline__ uint32_t code_offset(uint32_t wd) {
  constexpr int sh = BITS * J - 9;
  uint32_t v;
  if constexpr (sh >= 0)
    v = wd >> sh;
  else
    v = wd << -sh;
  return v & (((1u << BITS) - 1) << 9);
}

// Rows base .. base + R of xt (f32 or bf16) as f32 through 16-byte loads,
// those from row nr on left 0; base and nr are whole 16-byte vectors.
template <int R>
__device__ __forceinline__ void load_rows(float (&xv)[R], const void* xt,
                                          int x_bf16, size_t base, int nr) {
  if (x_bf16) {
    const uint4* p = reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(xt) + base);
#pragma unroll
    for (int k = 0; k < (R + 7) / 8; ++k) {
      const uint4 q = k * 8 < nr ? p[k] : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (8 * k + j < R)
          xv[8 * k + j] = __uint_as_float(
              j & 1 ? w[j / 2] & 0xffff0000u : w[j / 2] << 16);
    }
  } else {
    const float4* p = reinterpret_cast<const float4*>(
        static_cast<const float*>(xt) + base);
#pragma unroll
    for (int k = 0; k < (R + 3) / 4; ++k) {
      const float4 q = k * 4 < nr ? p[k] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * k + j < R) xv[4 * k + j] = w[j];
    }
  }
}

// The sidecar fold of a block's tile: Cs [rows][kCsStride] (f32, zeroed by
// the caller) += sparse(x) for rows m0.. and columns col0.. Warp w takes
// columns w * 16 .. + 15, 8 lanes a column (lane l: columns w * 16 + 4 cg
// + l / 8), each lane one of 8 equal parts of fold block f's share (f of
// `folds`) of the column's entries; the 8 parts are summed by a fixed
// butterfly of shuffles, R rows a pass. A lane
// fetches 2 entries of each of its 4 columns before it gathers x for any,
// so a round costs two memory latencies, a row of n entries n / (16 folds)
// rounds,
// and no value is summed by an atomic. Products are f32 on the unrounded
// x, read transposed, xt (in, M), so that an entry's rows share a sector.
// VEC (the decode kernel): where M and m0 are multiples of a 16-byte
// vector's rows, an entry's rows come in 16-byte loads, not one load a row
// (one trip to the entry's line for 8 bf16 rows, not 8); the products and
// their order are the same either way. M is xt's row stride, Mend the end
// of the tile's rows (M itself but in K13, whose experts' rows end apart).
template <int R, bool VEC = false>
__device__ __forceinline__ void fold_tile(float* Cs, int rows, const void* xt,
                                          int x_bf16,
                                          const int* __restrict__ rowptr,
                                          const int* __restrict__ cols,
                                          const float* __restrict__ vals,
                                          int M, int Mend, int out_f, int m0,
                                          int col0, int f, int folds) {
  constexpr int E = 2;  // entries a column a round
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = lane & 7;
  int e0[4], e1[4];
#pragma unroll
  for (int cg = 0; cg < 4; ++cg) {
    const int col = col0 + warp * 16 + cg * 4 + (lane >> 3);
    e0[cg] = e1[cg] = 0;
    if (col < out_f) {
      const int lo = rowptr[col], n = rowptr[col + 1] - lo;
      const int part = f * 8 + p, parts = folds * 8;
      e0[cg] = lo + (int)((long long)n * part / parts);
      e1[cg] = lo + (int)((long long)n * (part + 1) / parts);
    }
  }
  int most = 0;  // the lane's longest part: rounds of E entries
#pragma unroll
  for (int cg = 0; cg < 4; ++cg) most = max(most, e1[cg] - e0[cg]);
  // an entry's rows m0 + r0 .. start 16-byte aligned, and a tile's rows
  // are whole vectors (m0 is a multiple of R, but in K13)
  const bool vec = VEC && M % (x_bf16 ? 8 : 4) == 0 &&
                   m0 % (x_bf16 ? 8 : 4) == 0 &&
                   reinterpret_cast<uintptr_t>(xt) % 16 == 0;
  for (int r0 = 0; r0 < rows && m0 + r0 < Mend; r0 += R) {
    const int nr = min(R, min(rows, Mend - m0) - r0);
    float f[4][R];
#pragma unroll
    for (int cg = 0; cg < 4; ++cg)
#pragma unroll
      for (int m = 0; m < R; ++m) f[cg][m] = 0.f;
    for (int k = 0; k < most; k += E) {
      int c[4][E];
      float v[4][E];
#pragma unroll
      for (int cg = 0; cg < 4; ++cg)
#pragma unroll
        for (int u = 0; u < E; ++u) {
          const int e = e0[cg] + k + u;
          const bool ok = e < e1[cg];
          c[cg][u] = ok ? cols[e] : 0;
          v[cg][u] = ok ? vals[e] : 0.f;
        }
#pragma unroll
      for (int cg = 0; cg < 4; ++cg)
#pragma unroll
        for (int u = 0; u < E; ++u) {
          const size_t base = (size_t)c[cg][u] * M + m0 + r0;
          if constexpr (VEC) {
            if (vec) {
              float xv[R];
              load_rows<R>(xv, xt, x_bf16, base, nr);
#pragma unroll
              for (int m = 0; m < R; ++m)
                if (m < nr) f[cg][m] = fmaf(v[cg][u], xv[m], f[cg][m]);
              continue;
            }
          }
#pragma unroll
          for (int m = 0; m < R; ++m)
            if (m < nr)
              f[cg][m] = fmaf(v[cg][u], load_act(xt, x_bf16, base + m),
                              f[cg][m]);
        }
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
#pragma unroll
      for (int cg = 0; cg < 4; ++cg)
#pragma unroll
        for (int m = 0; m < R; ++m)
          f[cg][m] += __shfl_xor_sync(0xffffffffu, f[cg][m], o);
    // the 8 lanes hold the same sums; lane p adds the rows m % 8 == p
#pragma unroll
    for (int cg = 0; cg < 4; ++cg)
#pragma unroll
      for (int m = 0; m < R; ++m)
        if ((m & 7) == p && m < nr)
          Cs[(r0 + m) * kCsStride + warp * 16 + cg * 4 + (lane >> 3)] +=
              f[cg][m];
  }
}

// Sums the 8 warps' acc into warp 0's in a fixed tree through `red`
// (4 * R * kCols floats). The caller syncs before (red may alias buffers
// still read) and warp 0 holds the sum after.
template <int R>
__device__ __forceinline__ void tree_sum(float (&acc)[R][4], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int half = kWarps / 2; half >= 1; half /= 2) {
    if (warp >= half && warp < 2 * half) {
#pragma unroll
      for (int m = 0; m < R; ++m)
        *reinterpret_cast<float4*>(
            &red[((warp - half) * R + m) * kCols + lane * 4]) =
            make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    }
    __syncthreads();
    if (warp < half) {
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const float4 o = *reinterpret_cast<const float4*>(
            &red[(warp * R + m) * kCols + lane * 4]);
        acc[m][0] += o.x;
        acc[m][1] += o.y;
        acc[m][2] += o.z;
        acc[m][3] += o.w;
      }
    }
    __syncthreads();
  }
}

// Stores one value of the block's tile: the final y (y0 added) when the
// k-split is 1, else the block's partial in ws[split].
__device__ __forceinline__ void store_out(float v, int row, int col,
                                          float* __restrict__ y,
                                          float* __restrict__ ws,
                                          const void* y0, int y0_bf16, int M,
                                          int out_f, int splits) {
  const size_t yi = (size_t)row * out_f + col;
  if (splits == 1) {
    y[yi] = (y0 ? load_act(y0, y0_bf16, yi) : 0.f) + v;
  } else {
    ws[(size_t)blockIdx.y * M * out_f + yi] = v;
  }
}

// After every thread stored its partials: the last of the tile's `splits`
// blocks to get here sums the partials in split order, adds y0, writes y
// and resets the tile's counter for the next launch. E > 0 (the decode
// kernel, whose tile of `rows` x kCols is E values a thread): a thread's E
// values load each partial together, so that a partial costs one trip to
// L2, not E; the sums are the same. M is y's rows, Mend the end of the
// tile's (fold_tile).
template <int E = 0>
__device__ __forceinline__ void splitk_finish(
    float* __restrict__ y, const float* ws, int* counters, const void* y0,
    int y0_bf16, int M, int Mend, int out_f, int splits, int m0, int rows,
    int col0) {
  if (splits == 1) return;
  __shared__ int last;
  __threadfence();
  __syncthreads();
  int* cnt = counters + blockIdx.z * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) last = atomicAdd(cnt, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if constexpr (E == 0) {
    const int ncol = min(kCols, out_f - col0);
    const int nrow = min(rows, Mend - m0);
    for (int t = threadIdx.x; t < nrow * ncol; t += kThreads) {
      const int r = t / ncol, c = t % ncol;
      const size_t yi = (size_t)(m0 + r) * out_f + col0 + c;
      float v = y0 ? load_act(y0, y0_bf16, yi) : 0.f;
      float s = 0.f;
      for (int k = 0; k < splits; ++k)
        s += __ldcg(ws + (size_t)k * M * out_f + yi);
      y[yi] = v + s;
    }
  } else {
    float s[E];
    size_t yi[E];
    bool ok[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int t = threadIdx.x + e * kThreads;
      const int r = t / kCols, c = t % kCols;
      ok[e] = m0 + r < Mend && col0 + c < out_f;
      yi[e] = ok[e] ? (size_t)(m0 + r) * out_f + col0 + c : 0;
      s[e] = 0.f;
    }
    for (int k = 0; k < splits; ++k) {
      const float* p = ws + (size_t)k * M * out_f;
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (ok[e]) s[e] += __ldcg(p + yi[e]);
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (ok[e])
        y[yi[e]] = (y0 ? load_act(y0, y0_bf16, yi[e]) : 0.f) + s[e];
  }
  if (threadIdx.x == 0) *cnt = 0;
}

// A K13 expert's top-X rows, folded by its first fold block of a column
// tile: its x rows (M, in) row-major and its dense columns transposed, tw
// (topx, in), the j-th adding to output column tidx[j].
struct TopX {
  const void* x;
  int x_bf16, in_f, topx;
  const int* tidx;
  const float* tw;
};

// Cs[r][tidx[j] - col0] += x[m0 + r] . tw[j] for the top-X columns within
// the block's tile and its rows m0 .. Mend: warp w takes the (column, row)
// pairs q with q % 8 == w, its lanes every 32nd input, summed by a fixed
// butterfly, so that a row's sum takes one order whatever rows share its
// tile. The caller syncs before and after.
__device__ __forceinline__ void topx_tile(float* Cs, int rows, const TopX& t,
                                          int Mend, int m0, int col0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nr = min(rows, Mend - m0);
  int q = 0;
  for (int j = 0; j < t.topx; ++j) {
    const int c = t.tidx[j] - col0;
    if (c < 0 || c >= kCols) continue;
    const float* w = t.tw + (size_t)j * t.in_f;
    for (int r = 0; r < nr; ++r, ++q) {
      if (q % kWarps != warp) continue;
      const size_t xb = (size_t)(m0 + r) * t.in_f;
      float s = 0.f;
      for (int i = lane; i < t.in_f; i += 32)
        s = fmaf(load_act(t.x, t.x_bf16, xb + i), w[i], s);
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) Cs[r * kCsStride + c] += s;
    }
  }
}

// Fold block f of the `folds` sidecar blocks of a column tile: its share
// of the fold of rows m0.. into Cs (`rows` x kCsStride floats of shared
// memory), stored as partial blockIdx.y. In the GEMV and the MMA kernel
// the fold blocks come first (f = blockIdx.y): blocks start in blockIdx
// order, so the gathers run beside the word stream of the tile's other
// blocks, not after it. The decode kernel's come last (see there). TOPX
// (K13): fold block 0 adds the expert's top-X rows too.
template <int R, int E = 0, bool VEC = false, bool TOPX = false>
__device__ __forceinline__ void fold_block(
    float* Cs, int rows, const void* xt, int x_bf16, const int* rowptr,
    const int* cols, const float* vals, float* y, float* ws, int* counters,
    const void* y0, int y0_bf16, int M, int Mend, int out_f, int m0,
    int col0, int f, int folds, int parts, const TopX* topx = nullptr) {
  for (int t = threadIdx.x; t < rows * kCsStride; t += kThreads) Cs[t] = 0.f;
  __syncthreads();
  if (rowptr)
    fold_tile<R, VEC>(Cs, rows, xt, x_bf16, rowptr, cols, vals, M, Mend,
                      out_f, m0, col0, f, folds);
  if constexpr (TOPX) {
    if (f == 0 && topx->topx > 0) {
      __syncthreads();
      topx_tile(Cs, rows, *topx, Mend, m0, col0);
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < rows * kCols; t += kThreads) {
    const int r = t / kCols, c = t % kCols;
    if (m0 + r < Mend && col0 + c < out_f)
      store_out(Cs[r * kCsStride + c], m0 + r, col0 + c, y, ws, y0, y0_bf16,
                M, out_f, parts);
  }
  splitk_finish<E>(y, ws, counters, y0, y0_bf16, M, Mend, out_f, parts, m0,
                   rows, col0);
}

// ---------------------------------------------------------------------------
// GEMV: MT rows a tile (a power of two up to 16), x of type XT
// ---------------------------------------------------------------------------

constexpr int kGemvStages = 4;
constexpr int kGemvWords = 16;  // packed word rows a stage, 2 a warp

template <int BITS, int MT, typename XT>
struct GemvShape {
  static constexpr int CPW = Pack<BITS>::CPW, K = Pack<BITS>::K;
  static constexpr int SI = kGemvWords * CPW;  // inputs a stage
  // a stage: the words (16 x 128), then x's rows [m][SI] in XT, each row
  // padded to keep 16-byte alignment
  static constexpr int XROW = SI * (int)sizeof(XT) + 16;
  static constexpr int W_BYTES = kGemvWords * kCols * 4;
  static constexpr int STAGE = W_BYTES + MT * XROW;
  static constexpr int RED = 4 * MT * kCols * 4;
  static constexpr int PIPE = kGemvStages * STAGE;
  static constexpr int TAB = K * kCols * 4;
  static constexpr int SMEM = TAB + (PIPE > RED ? PIPE : RED);
};

// x rows m0.. of inputs [i0, i0 + n) into `dst` (rows of `row` bytes),
// zeros past i_end and past M: 16-byte copies when x's rows are 16-byte
// aligned (xalign 16), 4-byte ones (an f32 or a bf16 pair) when 4-byte
// aligned, else plain loads (bf16 x of odd width).
template <typename XT, int ROWS>
__device__ __forceinline__ void stage_rows(char* dst, int row, const XT* x,
                                           int xalign, int M, int in_f,
                                           int m0, int i0, int n, int i_end) {
  constexpr int E = sizeof(XT);
  if (xalign >= 4) {
    const int unit = xalign;  // bytes
    const int upr = n * E / unit;  // units a row
    for (int t = threadIdx.x; t < ROWS * upr; t += kThreads) {
      const int m = t / upr, u = t % upr;
      const int i = i0 + u * unit / E;
      int nb = 0;
      const XT* src = x;
      if (m0 + m < M && i < i_end) {
        nb = min(unit, (i_end - i) * E);
        src = x + (size_t)(m0 + m) * in_f + i;
      }
      if (unit == 16)
        cp_async_part<16>(dst + m * row + u * 16, src, nb);
      else
        cp_async_part<4>(dst + m * row + u * 4, src, nb);
    }
  } else {
    for (int t = threadIdx.x; t < ROWS * n; t += kThreads) {
      const int m = t / n, u = t % n;
      const int i = i0 + u;
      XT v = XT(0.f);
      if (m0 + m < M && i < i_end) v = x[(size_t)(m0 + m) * in_f + i];
      reinterpret_cast<XT*>(dst + m * row)[u] = v;
    }
  }
}

// The rows x 128 words of word rows [w0, w0 + rows) into `dst` (rows of
// `stride` words), zeros past w_end and out_f: 16-byte copies when `vec`,
// else 4-byte ones.
__device__ __forceinline__ void stage_words(uint32_t* dst,
                                            const uint32_t* __restrict__ qw,
                                            int rows, int w0, int w_end,
                                            int col0, int out_f, int vec,
                                            int stride = kCols) {
  if (vec) {
    for (int t = threadIdx.x; t < rows * kCols / 4; t += kThreads) {
      const int w = t / (kCols / 4), c = (t % (kCols / 4)) * 4;
      const bool ok = w0 + w < w_end && col0 + c < out_f;
      cp_async_part<16>(dst + w * stride + c,
                        ok ? qw + (size_t)(w0 + w) * out_f + col0 + c : qw,
                        ok ? 16 : 0);
    }
  } else {
    for (int t = threadIdx.x; t < rows * kCols; t += kThreads) {
      const int w = t / kCols, c = t % kCols;
      const bool ok = w0 + w < w_end && col0 + c < out_f;
      cp_async_part<4>(dst + w * stride + c,
                       ok ? qw + (size_t)(w0 + w) * out_f + col0 + c : qw,
                       ok ? 4 : 0);
    }
  }
}

// x[m][i0 .. i0 + CPW) of one word row from a staged row, as f32 (rounded
// to bf16 in bf16 mode when x is f32; bf16 x is already).
template <int CPW, typename XT>
__device__ __forceinline__ void read_x(float (&v)[CPW], const char* p,
                                       int round) {
  if constexpr (sizeof(XT) == 4) {
    if constexpr (CPW == 8) {
      const float4 a = reinterpret_cast<const float4*>(p)[0];
      const float4 b = reinterpret_cast<const float4*>(p)[1];
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < CPW; j += 2) {
        const float2 a = reinterpret_cast<const float2*>(p)[j / 2];
        v[j] = a.x;
        v[j + 1] = a.y;
      }
    }
    if (round) {
#pragma unroll
      for (int j = 0; j < CPW; ++j) v[j] = slt::round_bf16(v[j]);
    }
  } else {
    uint32_t u[CPW / 2];
    if constexpr (CPW == 8) {
      const uint4 a = *reinterpret_cast<const uint4*>(p);
      u[0] = a.x; u[1] = a.y; u[2] = a.z; u[3] = a.w;
    } else {
#pragma unroll
      for (int j = 0; j < CPW / 2; ++j)
        u[j] = reinterpret_cast<const uint32_t*>(p)[j];
    }
#pragma unroll
    for (int j = 0; j < CPW / 2; ++j) {
      v[2 * j] = __uint_as_float(u[j] << 16);
      v[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
    }
  }
}

// The table values of one word row's CPW codes for the lane's 4 columns.
template <int BITS, int J = 0>
__device__ __forceinline__ void lookup_row(
    float (&wv)[Pack<BITS>::CPW][4], const uint32_t (&wd)[4],
    const uint32_t (&lb)[4], const char* tabc) {
  if constexpr (J < Pack<BITS>::CPW) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      wv[J][q] = *reinterpret_cast<const float*>(
          tabc + (lb[q] | code_offset<BITS, J>(wd[q])));
    lookup_row<BITS, J + 1>(wv, wd, lb, tabc);
  }
}

template <int BITS, int MT, typename XT>
__global__ void __launch_bounds__(kThreads, MT <= 2 ? 4 : (MT <= 4 ? 3 : 2))
    gemv_kernel(const XT* __restrict__ x, const void* xt, int xalign,
                const uint32_t* __restrict__ qw, const float* __restrict__ lut,
                const float* __restrict__ sd, const int* __restrict__ rowptr,
                const int* __restrict__ cols, const float* __restrict__ vals,
                const void* __restrict__ y0, int y0_bf16,
                float* __restrict__ y, float* ws, int* counters, int M,
                int in_f, int out_f, int bf16_mode, int vec, int splits,
                int words_per_split, int folds) {
  using S = GemvShape<BITS, MT, XT>;
  constexpr int CPW = S::CPW, K = S::K;
  extern __shared__ __align__(16) unsigned char smem[];
  float* tab = reinterpret_cast<float*>(smem);
  char* pipe = reinterpret_cast<char*>(smem) + S::TAB;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * kCols;
  const int col = col0 + lane * 4;
  const int m0 = blockIdx.z * MT;
  const int nw = (in_f + CPW - 1) / CPW;
  const int wb = ((int)blockIdx.y - folds) * words_per_split;
  const int we = min(nw, wb + words_per_split);
  const int i_end = min(in_f, we * CPW);  // inputs past the split are 0
  const int ns = (we - wb + kGemvWords - 1) / kGemvWords;
  const int x_round = bf16_mode && sizeof(XT) == 4;
  const int parts = folds + splits;  // partials a tile
  if ((int)blockIdx.y < folds) {
    fold_block<MT>(reinterpret_cast<float*>(pipe), MT, xt, sizeof(XT) == 2,
                   rowptr, cols, vals, y, ws, counters, y0, y0_bf16, M, M,
                   out_f, m0, col0, blockIdx.y, folds, parts);
    return;
  }

  auto issue = [&](int s) {
    char* st = pipe + (s % kGemvStages) * S::STAGE;
    const int w0 = wb + s * kGemvWords;
    stage_words(reinterpret_cast<uint32_t*>(st), qw, kGemvWords, w0, we,
                col0, out_f, vec);
    stage_rows<XT, MT>(st + S::W_BYTES, S::XROW, x, xalign, M, in_f, m0,
                       w0 * CPW, S::SI, i_end);
  };
#pragma unroll
  for (int s = 0; s < kGemvStages - 1; ++s) {
    if (s < ns) issue(s);
    cp_async_commit();
  }
  load_table<K, true>(tab, lut, sd, col0, out_f, bf16_mode);
  uint32_t lb[4];
  lut_offsets(lb, lane);
  const char* tabc = reinterpret_cast<const char*>(tab);

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
    acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;

  for (int s = 0; s < ns; ++s) {
    cp_async_wait<kGemvStages - 2>();
    __syncthreads();  // stage s landed; every warp is past stage s - 1
    if (s + kGemvStages - 1 < ns) issue(s + kGemvStages - 1);
    cp_async_commit();
    const char* st = pipe + (s % kGemvStages) * S::STAGE;
    const uint32_t* W = reinterpret_cast<const uint32_t*>(st);
    const char* X = st + S::W_BYTES;
#pragma unroll
    for (int u = 0; u < kGemvWords / kWarps; ++u) {
      const int wl = u * kWarps + warp;
      const uint4 q4 = *reinterpret_cast<const uint4*>(W + wl * kCols +
                                                       lane * 4);
      const uint32_t wd[4] = {q4.x, q4.y, q4.z, q4.w};
      float wv[CPW][4];
      lookup_row<BITS>(wv, wd, lb, tabc);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float xv[CPW];
        read_x<CPW, XT>(xv, X + m * S::XROW + wl * CPW * sizeof(XT),
                        x_round);
#pragma unroll
        for (int j = 0; j < CPW; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[m][q] = fmaf(xv[j], wv[j][q], acc[m][q]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages are free for the warps' partials
  tree_sum<MT>(acc, reinterpret_cast<float*>(pipe));
  if (warp == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m0 + m >= M) break;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (col + q < out_f)
          store_out(acc[m][q], m0 + m, col + q, y, ws, y0, y0_bf16, M, out_f,
                    parts);
    }
  }
  splitk_finish(y, ws, counters, y0, y0_bf16, M, M, out_f, parts, m0, MT,
                col0);
}

// K13's grouping (csrc/moe_lut.cu): the rows of x are sorted by expert,
// expert e's are [offsets[e], offsets[e + 1]); row tile z of the launch
// belongs to expert tiles[z] (-1: none) and starts at row tiles[ntiles +
// z]; the weights of expert e follow those of e - 1 in every operand (the
// sidecar's row pointers index the concatenated entries); topx as TopX,
// its columns and rows at expert e's place.
struct MoeTiles {
  const int* offsets;
  const int* tiles;
  int ntiles;
  const int* tidx;
  const float* tw;
  int topx;
};

// The block's rows [m0, Mend) and its expert: K1's tile blockIdx.z of M
// rows (expert 0), or K13's (MoeTiles); -1 for a K13 tile that no row
// chose, whose block leaves before it reads a word.
template <bool MOE>
__device__ __forceinline__ int block_rows(const MoeTiles& moe, int rows,
                                          int M, int& m0, int& Mend) {
  if constexpr (MOE) {
    const int z = blockIdx.z;
    const int e = moe.tiles[z];
    if (e < 0) return -1;
    m0 = moe.tiles[moe.ntiles + z];
    Mend = moe.offsets[e + 1];
    return e;
  } else {
    m0 = blockIdx.z * rows;
    Mend = M;
    return 0;
  }
}

// Expert e's top-X operands (MoeTiles).
__device__ __forceinline__ TopX expert_topx(const MoeTiles& moe, int e,
                                            const void* x, int x_bf16,
                                            int in_f) {
  return TopX{x, x_bf16, in_f, moe.topx, moe.tidx + e * moe.topx,
              moe.tw + (size_t)e * moe.topx * in_f};
}

// ---------------------------------------------------------------------------
// MMA: 64 rows x 128 columns a block, bf16 mode
// ---------------------------------------------------------------------------

constexpr int kMmaRows = 64;
constexpr int kMmaWords = 8;  // packed word rows a k-step
constexpr int kStages = 4;

template <int BITS>
struct MmaShape {
  static constexpr int CPW = Pack<BITS>::CPW, K = Pack<BITS>::K;
  static constexpr int BK = kMmaWords * CPW;  // inputs a k-step: 64 or 80
  static constexpr int LD = BK + 8;  // bf16 a tile row: 16 bytes of pad
  static constexpr int A_BYTES = kMmaRows * LD * 2;
  static constexpr int W_BYTES = kMmaWords * kCols * 4;
  static constexpr int B_BYTES = kCols * LD * 2;
  static constexpr int PIPE_BYTES = kStages * (A_BYTES + W_BYTES) + 2 * B_BYTES;
  static constexpr int CS_BYTES = kMmaRows * kCsStride * 4;
  static constexpr int TAB_BYTES = K * kCols * 4;
  static constexpr int SMEM =
      TAB_BYTES + (PIPE_BYTES > CS_BYTES ? PIPE_BYTES : CS_BYTES);
};

using slt::ldmatrix_x4;
using slt::mma_bf16;

// Issues the copies of a k-step (word rows w0.. of the split) into one
// stage: x rows m0.. as bf16 (cp.async for bf16 x; f32 x rounded through
// registers; zeros past i_end and M) and the 8 x 128 words (zeros past
// w_end and out_f).
template <int BITS, typename XT>
__device__ __forceinline__ void mma_issue(
    __nv_bfloat16* As, uint32_t* Ws, const XT* x, int xalign,
    const uint32_t* __restrict__ qw, int M, int in_f, int out_f, int m0,
    int col0, int w0, int w_end, int i_end, int vec) {
  using S = MmaShape<BITS>;
  const int i0 = w0 * S::CPW;
  if (sizeof(XT) == 2) {
    stage_rows<XT, kMmaRows>(reinterpret_cast<char*>(As), S::LD * 2, x,
                             xalign, M, in_f, m0, i0, S::BK, i_end);
  } else {
    for (int t = threadIdx.x; t < kMmaRows * S::BK; t += kThreads) {
      const int m = t / S::BK, k = t % S::BK, i = i0 + k;
      float v = 0.f;
      if (m0 + m < M && i < i_end)
        v = slt::to_f32(x[(size_t)(m0 + m) * in_f + i]);
      As[m * S::LD + k] = __float2bfloat16_rn(v);
    }
  }
  stage_words(Ws, qw, kMmaWords, w0, w_end, col0, out_f, vec);
  cp_async_commit();
}

// One stage's 8 x 128 words into B [column][k] as bf16 pairs, through the
// bf16 table [code][column] (a 32-bit word an entry, so that a warp's
// lookups never conflict): a thread a column, 4 of the 8 word rows.
template <int BITS>
__device__ __forceinline__ void dequant_stage(__nv_bfloat16* Bs,
                                              const uint32_t* W,
                                              const uint32_t* tab) {
  using S = MmaShape<BITS>;
  constexpr int CPW = S::CPW, K = S::K;
  const int c = threadIdx.x & (kCols - 1);
  const uint32_t* tc = tab + c;
#pragma unroll
  for (int r = 0; r < kMmaWords / 2; ++r) {
    const int w = (threadIdx.x >> 7) + 2 * r;
    const uint32_t wd = W[w * kCols + c];
    uint32_t v[CPW / 2];  // bf16 pairs (code 2p low, 2p + 1 high)
#pragma unroll
    for (int p = 0; p < CPW / 2; ++p)
      v[p] = tc[((wd >> (BITS * 2 * p)) & (K - 1)) * kCols] |
             (tc[((wd >> (BITS * (2 * p + 1))) & (K - 1)) * kCols] << 16);
    uint32_t* dst = reinterpret_cast<uint32_t*>(Bs + c * S::LD + w * CPW);
    if constexpr (CPW == 8) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int p = 0; p < CPW / 2; ++p) dst[p] = v[p];
    }
  }
}

template <int BITS, typename XT, bool MOE>
__device__ __forceinline__ void mma_body(
    const XT* __restrict__ x, const void* xt, int xalign,
    const uint32_t* __restrict__ qw, const float* __restrict__ lut,
    const float* __restrict__ sd, const int* __restrict__ rowptr,
    const int* __restrict__ cols, const float* __restrict__ vals,
    const void* __restrict__ y0, int y0_bf16, float* __restrict__ y,
    float* ws, int* counters, int M, int in_f, int out_f, int vec,
    int splits, int words_per_split, int folds, const MoeTiles& moe) {
  using S = MmaShape<BITS>;
  constexpr int CPW = S::CPW, K = S::K, LD = S::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  auto* tab = reinterpret_cast<uint32_t*>(smem);
  unsigned char* pipe = smem + S::TAB_BYTES;
  auto As = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(pipe + st * S::A_BYTES);
  };
  auto Ws = [&](int st) {
    return reinterpret_cast<uint32_t*>(pipe + kStages * S::A_BYTES +
                                       st * S::W_BYTES);
  };
  auto Bs = [&](int b) {  // double-buffered: dequantized a k-step ahead
    return reinterpret_cast<__nv_bfloat16*>(
        pipe + kStages * (S::A_BYTES + S::W_BYTES) + b * S::B_BYTES);
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps of 32 x 32
  const int g = lane >> 2, tq = lane & 3;
  const int col0 = blockIdx.x * kCols;
  const int nw = (in_f + CPW - 1) / CPW;
  int m0, Mend;
  const int ex = block_rows<MOE>(moe, kMmaRows, M, m0, Mend);
  if (ex < 0) return;
  TopX tx{};
  if constexpr (MOE) {  // expert ex's operands
    qw += (size_t)ex * nw * out_f;
    lut += (size_t)ex * out_f * K;
    if (rowptr) rowptr += (size_t)ex * (out_f + 1);
    tx = expert_topx(moe, ex, x, sizeof(XT) == 2, in_f);
  }
  const int wb = ((int)blockIdx.y - folds) * words_per_split;
  const int we = min(nw, wb + words_per_split);
  const int i_end = min(in_f, we * CPW);
  const int nk = (we - wb + kMmaWords - 1) / kMmaWords;
  const int parts = folds + splits;  // partials a tile
  if ((int)blockIdx.y < folds) {
    fold_block<16, 0, false, MOE>(
        reinterpret_cast<float*>(pipe), kMmaRows, xt, sizeof(XT) == 2,
        rowptr, cols, vals, y, ws, counters, y0, y0_bf16, M, Mend, out_f,
        m0, col0, blockIdx.y, folds, parts, &tx);
    return;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      mma_issue<BITS, XT>(As(s), Ws(s), x, xalign, qw, Mend, in_f, out_f,
                          m0, col0, wb + s * kMmaWords, we, i_end, vec);
    else
      cp_async_commit();  // keep the group count
  }
  load_table<K, false>(tab, lut, sd, col0, out_f, 1);

  float acc[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      acc[a][b][0] = acc[a][b][1] = acc[a][b][2] = acc[a][b][3] = 0.f;

  cp_async_wait<kStages - 2>();
  __syncthreads();  // stage 0 and the table are in
  dequant_stage<BITS>(Bs(0), Ws(0), tab);
  for (int kt = 0; kt < nk; ++kt) {
    // stage kt + 1 landed, B of k-step kt is written, and every warp is
    // past k-step kt - 1, whose buffers the next copies reuse
    cp_async_wait<kStages - 3>();
    __syncthreads();
    const int kn = kt + kStages - 1;
    if (kn < nk)
      mma_issue<BITS, XT>(As(kn % kStages), Ws(kn % kStages), x, xalign, qw,
                          Mend, in_f, out_f, m0, col0, wb + kn * kMmaWords,
                          we, i_end, vec);
    else
      cp_async_commit();
    if (kt + 1 < nk)
      dequant_stage<BITS>(Bs((kt + 1) & 1), Ws((kt + 1) % kStages), tab);
    const __nv_bfloat16* A = As(kt % kStages);
    const __nv_bfloat16* B = Bs(kt & 1);
#pragma unroll
    for (int kk = 0; kk < S::BK / 16; ++kk) {
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], A + (wm * 32 + mi * 16 + (lane & 15)) * LD +
                               kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldmatrix_x4(b[nj], B + (wn * 32 + nj * 16 + (lane & 7) +
                                ((lane >> 4) << 3)) * LD +
                               kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], a[mi], b[ni >> 1][(ni & 1) * 2],
                   b[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the pipeline's buffers are free

  float* Cs = reinterpret_cast<float*>(pipe);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = wm * 32 + mi * 16 + g, c = wn * 32 + ni * 8 + 2 * tq;
      *reinterpret_cast<float2*>(&Cs[r * kCsStride + c]) =
          make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(&Cs[(r + 8) * kCsStride + c]) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  __syncthreads();
  for (int t = threadIdx.x; t < kMmaRows * kCols; t += kThreads) {
    const int r = t / kCols, c = t % kCols;
    if (m0 + r < Mend && col0 + c < out_f)
      store_out(Cs[r * kCsStride + c], m0 + r, col0 + c, y, ws, y0, y0_bf16,
                M, out_f, parts);
  }
  splitk_finish(y, ws, counters, y0, y0_bf16, M, Mend, out_f, parts, m0,
                kMmaRows, col0);
}

template <int BITS, typename XT>
__global__ void __launch_bounds__(kThreads)
    mma_kernel(const XT* __restrict__ x, const void* xt, int xalign,
               const uint32_t* __restrict__ qw, const float* __restrict__ lut,
               const float* __restrict__ sd, const int* __restrict__ rowptr,
               const int* __restrict__ cols, const float* __restrict__ vals,
               const void* __restrict__ y0, int y0_bf16,
               float* __restrict__ y, float* ws, int* counters, int M,
               int in_f, int out_f, int vec, int splits,
               int words_per_split, int folds) {
  mma_body<BITS, XT, false>(x, xt, xalign, qw, lut, sd, rowptr, cols, vals,
                            y0, y0_bf16, y, ws, counters, M, in_f, out_f, vec,
                            splits, words_per_split, folds, MoeTiles{});
}

// ---------------------------------------------------------------------------
// DEC: the decode calls' tensor-core kernel, 8 or 16 rows a tile, bf16 mode
// ---------------------------------------------------------------------------

constexpr int kDecStages = 4;
constexpr int kDecWords = 16;  // packed word rows a stage: 4 groups of 4
// a staged word row in words: 8 past a multiple of 32, so that the 4 rows
// of a group land on different banks (dec_mma_kernel's 16-byte loads)
constexpr int kDecWStride = kCols + 8;

template <int BITS, int NT, typename XT>
struct DecShape {
  static constexpr int CPW = Pack<BITS>::CPW, K = Pack<BITS>::K;
  static constexpr int H = (CPW + 3) / 4;  // products a word group
  static constexpr int ROWS = 8 * NT;
  static constexpr int SI = kDecWords * CPW;  // inputs a stage
  // a stage: the words (16 x kDecWStride), then x's rows [m][SI] in XT,
  // each row padded by 64 bytes, so that the B loads of rows g and g + 1
  // fall on different banks
  static constexpr int XROW = SI * (int)sizeof(XT) + 64;
  static constexpr int W_BYTES = kDecWords * kDecWStride * 4;
  static constexpr int STAGE = W_BYTES + ROWS * XROW;
  static constexpr int PIPE = kDecStages * STAGE;
  static constexpr int RED = 4 * 32 * 16 * NT * 4;  // 4 warps' partials
  static constexpr int FOLD = ROWS * kCsStride * 4;
  static constexpr int REST = PIPE > RED ? (PIPE > FOLD ? PIPE : FOLD)
                                         : (RED > FOLD ? RED : FOLD);
  static constexpr int TAB = K * kCols * 4 * 4;  // 4 copies of each entry
  static constexpr int SMEM = TAB + REST;
};

// The block's bf16 table for dec_mma_kernel: code k of column c at 32-bit
// word k * 512 + (c % 4) * 128 + (c / 4) * 4 + t, once for each t of 0..3
// (bf16 in the low half), so that lane (g, t), reading columns 4g + q of a
// quarter, finds its entries in bank 4g + t whatever the codes: byte offset
// k << 11 | q << 9 | (c / 4) << 4 | t << 2. A thread writes 4 codes of a
// column, the lanes of a warp consecutive c / 4, so that their 16-byte
// stores never conflict.
template <int K>
__device__ __forceinline__ void load_dec_table(uint32_t* tab,
                                               const float* lut,
                                               const float* sd, int col0,
                                               int out_f) {
  constexpr int N = kCols * K / 4 / kThreads;  // 2 (4-bit) or 1 (3-bit)
#pragma unroll
  for (int n = 0; n < N; ++n) {  // every load in flight together
    const int t = threadIdx.x + n * kThreads;
    const int c = ((t & 31) << 2) | ((t >> 5) & 3), j = t >> 7;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * j + i;
      const uint32_t v = __bfloat16_as_ushort(__float2bfloat16_rn(
          table_value<K>(lut, sd, col0 + c, k, out_f)));
      *reinterpret_cast<uint4*>(tab + k * 512 + (c & 3) * 128 +
                                (c >> 2) * 4) = make_uint4(v, v, v, v);
    }
  }
}

// code j of word wd at its table row's byte offset (k << 11)
template <int BITS>
__device__ __forceinline__ uint32_t dec_code(uint32_t wd, int j) {
  const int sh = BITS * j - 11;
  const uint32_t v = sh >= 0 ? wd >> sh : wd << -sh;
  return v & (((1u << BITS) - 1) << 11);
}

// The A fragments of product h for the lane's two m-tiles of a column
// quarter: a[i] for m-tile 2p + i, whose rows g and g + 8 are columns
// 4g + 2i and 4g + 2i + 1 (words wd[2i], wd[2i + 1]); slots 2t, 2t + 1,
// 2t + 8, 2t + 9 of the product hold codes 4h .. 4h + 3 of the word, zeros
// past its codes (3-bit words pad their last product).
template <int BITS>
__device__ __forceinline__ void dec_fragments(uint32_t (&a)[2][4],
                                              const uint32_t (&wd)[4],
                                              const uint32_t (&lb)[4],
                                              const char* tabc, int h) {
  constexpr int CPW = Pack<BITS>::CPW;
  uint32_t v[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[q][e] = 4 * h + e < CPW
                    ? *reinterpret_cast<const uint32_t*>(
                          tabc + (lb[q] | dec_code<BITS>(wd[q], 4 * h + e)))
                    : 0u;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    a[i][0] = __byte_perm(v[2 * i][0], v[2 * i][1], 0x5410);
    a[i][1] = __byte_perm(v[2 * i + 1][0], v[2 * i + 1][1], 0x5410);
    a[i][2] = __byte_perm(v[2 * i][2], v[2 * i][3], 0x5410);
    a[i][3] = __byte_perm(v[2 * i + 1][2], v[2 * i + 1][3], 0x5410);
  }
}

// The B fragments of one x row for the lane's word of a group: b[h] =
// inputs 4h .. 4h + 3 of the word's CPW as two bf16 pairs (f32 x rounded
// here; zeros past the word's inputs).
template <int CPW, typename XT>
__device__ __forceinline__ void dec_b(uint32_t (&b)[(CPW + 3) / 4][2],
                                      const char* p) {
  constexpr int NP = CPW / 2;                // bf16 pairs of the inputs
  constexpr int NU = (CPW + 3) / 4 * 2;      // pairs the products take
  uint32_t u[NU];
  if constexpr (sizeof(XT) == 2) {
    if constexpr (CPW == 8) {
      const uint4 q = *reinterpret_cast<const uint4*>(p);
      u[0] = q.x; u[1] = q.y; u[2] = q.z; u[3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < NP; ++j)
        u[j] = reinterpret_cast<const uint32_t*>(p)[j];
    }
  } else {
    if constexpr (CPW == 8) {
      const float4 q0 = reinterpret_cast<const float4*>(p)[0];
      const float4 q1 = reinterpret_cast<const float4*>(p)[1];
      u[0] = slt::pack_bf16(q0.x, q0.y);
      u[1] = slt::pack_bf16(q0.z, q0.w);
      u[2] = slt::pack_bf16(q1.x, q1.y);
      u[3] = slt::pack_bf16(q1.z, q1.w);
    } else {
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const float2 f = reinterpret_cast<const float2*>(p)[j];
        u[j] = slt::pack_bf16(f.x, f.y);
      }
    }
  }
#pragma unroll
  for (int j = NP; j < NU; ++j) u[j] = 0u;
#pragma unroll
  for (int h = 0; h < NU / 2; ++h) {
    b[h][0] = u[2 * h];
    b[h][1] = u[2 * h + 1];
  }
}

// Sums the 4 warps of each column half (grp 0..3) into grp 0's acc in a
// fixed tree, (0 + 2) + (1 + 3), through `red` (DecShape::RED bytes). The
// caller syncs before (red aliases the stages).
template <int NT>
__device__ __forceinline__ void dec_tree_sum(float (&acc)[4][NT][4],
                                             float* red, int grp, int half) {
  const int lane = threadIdx.x & 31;
  float4* r4 = reinterpret_cast<float4*>(red);
#pragma unroll
  for (int h = 2; h >= 1; h /= 2) {
    if (grp >= h && grp < 2 * h) {
      float4* dst = r4 + (half * 2 + grp - h) * (4 * NT) * 32 + lane;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          dst[(mt * NT + nt) * 32] =
              make_float4(acc[mt][nt][0], acc[mt][nt][1], acc[mt][nt][2],
                          acc[mt][nt][3]);
    }
    __syncthreads();
    if (grp < h) {
      const float4* src = r4 + (half * 2 + grp) * (4 * NT) * 32 + lane;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float4 o = src[(mt * NT + nt) * 32];
          acc[mt][nt][0] += o.x;
          acc[mt][nt][1] += o.y;
          acc[mt][nt][2] += o.z;
          acc[mt][nt][3] += o.w;
        }
    }
    __syncthreads();
  }
}

template <int BITS, int NT, typename XT, bool MOE>
__device__ __forceinline__ void dec_body(
    const XT* __restrict__ x, const void* xt, int xalign,
    const uint32_t* __restrict__ qw, const float* __restrict__ lut,
    const float* __restrict__ sd, const int* __restrict__ rowptr,
    const int* __restrict__ cols, const float* __restrict__ vals,
    const void* __restrict__ y0, int y0_bf16, float* __restrict__ y,
    float* ws, int* counters, int M, int in_f, int out_f, int vec,
    int splits, int words_per_split, int folds, const MoeTiles& moe) {
  using S = DecShape<BITS, NT, XT>;
  constexpr int CPW = S::CPW, K = S::K, H = S::H, ROWS = S::ROWS;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  char* pipe = reinterpret_cast<char*>(smem) + S::TAB;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int grp = warp & 3, half = warp >> 2;  // word group; column half
  const int col0 = blockIdx.x * kCols;
  constexpr int E = ROWS * kCols / kThreads;  // values a thread finishes
  const int nw = (in_f + CPW - 1) / CPW;
  int m0, Mend;
  const int ex = block_rows<MOE>(moe, ROWS, M, m0, Mend);
  if (ex < 0) return;
  TopX tx{};
  if constexpr (MOE) {  // expert ex's operands
    qw += (size_t)ex * nw * out_f;
    lut += (size_t)ex * out_f * K;
    if (rowptr) rowptr += (size_t)ex * (out_f + 1);
    tx = expert_topx(moe, ex, x, sizeof(XT) == 2, in_f);
  }
  const int wb = (int)blockIdx.y * words_per_split;
  const int we = min(nw, wb + words_per_split);
  const int i_end = min(in_f, we * CPW);  // inputs past the split are 0
  const int ns = (we - wb + kDecWords - 1) / kDecWords;
  const int parts = splits + folds;  // partials a tile
  // the word blocks first, the fold blocks after them: a fold block holds
  // a slot as a word block does, and the gathers of a wide layer's many
  // fold blocks would otherwise keep its word stream waiting
  if ((int)blockIdx.y >= splits) {
    fold_block<ROWS, E, true, MOE>(
        reinterpret_cast<float*>(pipe), ROWS, xt, sizeof(XT) == 2, rowptr,
        cols, vals, y, ws, counters, y0, y0_bf16, M, Mend, out_f, m0, col0,
        (int)blockIdx.y - splits, folds, parts, &tx);
    return;
  }

  auto issue = [&](int s) {
    char* st = pipe + (s % kDecStages) * S::STAGE;
    const int w0 = wb + s * kDecWords;
    stage_words(reinterpret_cast<uint32_t*>(st), qw, kDecWords, w0, we,
                col0, out_f, vec, kDecWStride);
    stage_rows<XT, ROWS>(st + S::W_BYTES, S::XROW, x, xalign, Mend, in_f,
                         m0, w0 * CPW, S::SI, i_end);
  };
#pragma unroll
  for (int s = 0; s < kDecStages - 1; ++s) {
    if (s < ns) issue(s);
    cp_async_commit();
  }
  load_dec_table<K>(tab, lut, sd, col0, out_f);
  // the lane's byte offsets in the table for columns 64 half + 32 p + 4g +
  // q: q << 9 | (16 half + 8p + g) << 4 | tq << 2 (p OR'd in per quarter)
  uint32_t lb[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    lb[q] = (q << 9) | ((16 * half + g) << 4) | (tq << 2);
  const char* tabc = reinterpret_cast<const char*>(tab);

  float acc[4][NT][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] =
          0.f;

  const int wr = grp * 4 + tq;  // the lane's word row of a stage
  for (int s = 0; s < ns; ++s) {
    cp_async_wait<kDecStages - 2>();
    __syncthreads();  // stage s landed; every warp is past stage s - 1
    if (s + kDecStages - 1 < ns) issue(s + kDecStages - 1);
    cp_async_commit();
    const char* st = pipe + (s % kDecStages) * S::STAGE;
    const uint32_t* W = reinterpret_cast<const uint32_t*>(st) +
                        wr * kDecWStride + 64 * half + 4 * g;
    const char* X = st + S::W_BYTES + wr * CPW * (int)sizeof(XT);
    uint32_t b[NT][H][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      dec_b<CPW, XT>(b[nt], X + (8 * nt + g) * S::XROW);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const uint4 q4 = *reinterpret_cast<const uint4*>(W + 32 * p);
      const uint32_t wd[4] = {q4.x, q4.y, q4.z, q4.w};
      const uint32_t lp[4] = {lb[0] | (p << 7), lb[1] | (p << 7),
                              lb[2] | (p << 7), lb[3] | (p << 7)};
#pragma unroll
      for (int h = 0; h < H; ++h) {
        uint32_t a[2][4];
        dec_fragments<BITS>(a, wd, lp, tabc, h);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_bf16(acc[2 * p][nt], a[0], b[nt][h][0], b[nt][h][1]);
          mma_bf16(acc[2 * p + 1][nt], a[1], b[nt][h][0], b[nt][h][1]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages are free for the warps' partials
  dec_tree_sum<NT>(acc, reinterpret_cast<float*>(pipe), grp, half);
  if (grp == 0) {
    // acc[2p + i][nt][r]: row 8 nt + 2 tq + r % 2 of the tile, column
    // 64 half + 32 p + 4g + 2i + r / 2
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = m0 + 8 * nt + 2 * tq + (r & 1);
          const int col = col0 + 64 * half + 32 * (mt >> 1) + 4 * g +
                          2 * (mt & 1) + (r >> 1);
          if (row < Mend && col < out_f)
            store_out(acc[mt][nt][r], row, col, y, ws, y0, y0_bf16, M,
                      out_f, parts);
        }
  }
  splitk_finish<E>(y, ws, counters, y0, y0_bf16, M, Mend, out_f, parts, m0,
                   ROWS, col0);
}

template <int BITS, int NT, typename XT>
__global__ void __launch_bounds__(kThreads, 2)
    dec_mma_kernel(const XT* __restrict__ x, const void* xt, int xalign,
                   const uint32_t* __restrict__ qw,
                   const float* __restrict__ lut,
                   const float* __restrict__ sd,
                   const int* __restrict__ rowptr,
                   const int* __restrict__ cols,
                   const float* __restrict__ vals,
                   const void* __restrict__ y0, int y0_bf16,
                   float* __restrict__ y, float* ws, int* counters, int M,
                   int in_f, int out_f, int vec, int splits,
                   int words_per_split, int folds) {
  dec_body<BITS, NT, XT, false>(x, xt, xalign, qw, lut, sd, rowptr, cols,
                                vals, y0, y0_bf16, y, ws, counters, M, in_f,
                                out_f, vec, splits, words_per_split, folds,
                                MoeTiles{});
}

}  // namespace
