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
// fused 4-bit q|k|v of LLaMA-2-7B, ~7.5 us at 3.35 TB/s). bf16 mode's
// products are bf16 x bf16 with f32 sums, what the tensor cores do; exact
// mode's are f32 FMAs on the CUDA cores (TF32 cannot hold f32 products).
// Design (k11_kernel, one body for both modes):
//  * a block owns 128 output channels, a warp 16 of them (an m16 tile: W's
//    rows are channels, so a channel's codes run along k, in A's row-major
//    order), and x is staged ONCE a block, for the block's share of k;
//  * lane (g, t) = (lane / 4, lane % 4) streams the words 4t..4t+3 of each
//    16-word span (128 inputs) of channels g and g + 8 through a ring of 4
//    spans in shared memory (cp.async, 16-byte copies), so 3 spans are in
//    flight while one is multiplied; a lane reads back only what it copied
//    itself, so the ring needs no barrier;
//  * the k order follows the words: in k-step 2u + s of a span, lane t's
//    A fragment holds the codes 4s..4s+3 of its word u of channels g and
//    g + 8, and x is staged in that same order ([span][k-step][row][t], 4
//    inputs of a row in 8 (bf16) or 16 (f32) bytes), so a lane's B
//    fragment (bf16) or x vector (f32) is one conflict-free shared load;
//  * a code's value comes from the warp's table [code][g or g + 8][lane],
//    one 32-bit entry a lane (bf16 in the low half in bf16 mode), so lane
//    l's entries all lie in bank l and 32 lookups of any codes never
//    conflict; the table starts on a 4 KB boundary, so a lookup is a
//    shift, a LOP3 and a load, no shuffle; bf16 mode looks up half a span
//    (32 codes a lane) before it multiplies, so the loads overlap;
//  * bf16 mode: mma.sync m16n8k16 bf16 with f32 accumulation, N = 8 = the
//    route's row limit; rows past M are zeros in B. bf16 x bf16 products
//    are exact in f32, so only the order of the sums differs from the
//    plain version. Exact mode: each lane's f32 FMAs over its words, its 4
//    lanes summed by a fixed butterfly;
//  * when 128-channel tiles are too few to fill the card (o, down: 32
//    tiles) the words are split over blocks (`splits`, fixed per layer
//    shape by the wrapper's plan), at most 128 words a block (its x chunk);
//    the partials go to a workspace and the LAST block of a tile to arrive
//    (an atomic counter decides which; no value is summed by an atomic)
//    adds them in split order.
// A row's result does not depend on the other rows: the tensor cores give
// each of N's columns its own sums, exact mode's MT variants do the same
// FMAs a row in the same order, and the split follows the shape only.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;              // output channels a warp
constexpr int kCols = kWarps * kTile;  // output channels a block
constexpr int kSpan = 16;              // packed words a channel a span
constexpr int kRing = 4;               // spans in the ring
constexpr int kMaxSplitWords = 128;    // packed words a block at most
constexpr int kMaxRows = 8;            // x rows: the mma's N
constexpr int kUnits = 8;              // x loads in flight a thread

constexpr int kTabBytes = kWarps * 16 * 2 * 32 * 4;  // [warp][code][h][lane]
constexpr uint32_t kAlign = 4096;  // the table's alignment in the window
constexpr int kStageBytes = kWarps * 2 * 32 * 16;    // [warp][h][lane] uint4
constexpr int kRingBytes = kRing * kStageBytes;

// x's bytes a span: [k-step 8][row][t 4] of 4 inputs
template <bool TC, int MT>
constexpr int x_span_bytes() {
  return TC ? 8 * kMaxRows * 4 * 8 : 8 * MT * 4 * 16;
}
template <bool TC, int MT>
constexpr int smem_bytes(int words) {
  return kAlign + kTabBytes + kRingBytes +
         words / kSpan * x_span_bytes<TC, MT>();
}

template <int N>
__device__ __forceinline__ void ring_wait() {
  // a compiler barrier too: the ring's reads stay after the wait
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The table entry of code (w >> 4j) & 15 for this lane, as raw bits. tb:
// the shared-window address of the lane's entry of code 0 for channel g
// (h 0) or g + 8 (h 1): lane * 4 + h * 128 on a 4 KB boundary, so the
// code's offset (code * 256, bits 8-11) joins it by one LOP3.
__device__ __forceinline__ uint32_t lookup(uint32_t tb, uint32_t w, int j) {
  const int sh = 4 * j - 8;
  const uint32_t off = (sh >= 0 ? w >> sh : w << -sh) & 0xf00u;
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(off | tb));
  return v;
}

// two bf16 table entries (low halves) as one A register, lo first
__device__ __forceinline__ uint32_t pair(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x5410);
}

template <bool TC, int MT, typename XT>
__global__ void __launch_bounds__(kThreads, 2)
    k11_kernel(const XT* __restrict__ x, const uint32_t* __restrict__ qwt,
               const float* __restrict__ lut, float* __restrict__ y,
               float* ws, int* counters, int M, int in_f, int out_f,
               int splits, int words_per_split, int vec_w, int vec_x) {
  constexpr int R = TC ? kMaxRows : MT;  // x rows staged
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the table starts on a 4 KB boundary of the shared window (lookup)
  unsigned char* smem =
      smem_raw + ((kAlign - static_cast<uint32_t>(__cvta_generic_to_shared(
                                smem_raw))) & (kAlign - 1));
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  uint4* ring = reinterpret_cast<uint4*>(smem + kTabBytes);
  unsigned char* xs = smem + kTabBytes + kRingBytes;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * kCols;
  const int o0 = col0 + warp * kTile;
  const int nw = (in_f + 7) / 8;
  const int wb = blockIdx.y * words_per_split;
  const int we = min(nw, wb + words_per_split);
  const int ns = (we - wb + kSpan - 1) / kSpan;
  const int i_end = min(in_f, we * 8);  // inputs past the split are 0

  // the ring: span s's words 4t..4t+3 of channels g (h 0) and g + 8 (h 1),
  // zeros past the split and past out_f
  auto issue = [&](int s) {
    uint4* st = ring + ((s % kRing) * kWarps + warp) * 64 + lane;
    const int w = wb + s * kSpan + 4 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ch = o0 + g + 8 * h;
      const uint32_t* src = qwt + (size_t)ch * nw + w;
      if (vec_w) {
        const int n = ch < out_f ? max(0, min(4, we - w)) * 4 : 0;
        slt::cp_async_part<16>(st + h * 32, n ? src : qwt, n);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok = ch < out_f && w + q < we;
          slt::cp_async_part<4>(reinterpret_cast<uint32_t*>(st + h * 32) + q,
                                ok ? src + q : qwt, ok ? 4 : 0);
        }
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < ns) issue(s);
    slt::cp_async_commit();
  }

  // the warp's table: code c of channel o0 + g2 + 8h at [c][h][g2 * 4 + t']
  // for each t', the 4 lanes of a channel holding a copy each; a lane's 8
  // loads are all issued before any is stored
  uint32_t* tw = tab + warp * (16 * 64);
  {
    float lv[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int idx = lane + 32 * k;  // h = idx / 128, g2 = idx / 16 % 8, c
      const int ch = o0 + ((idx >> 4) & 7) + 8 * (idx >> 7);
      lv[k] = ch < out_f ? lut[(size_t)ch * 16 + (idx & 15)] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int idx = lane + 32 * k;
      const uint32_t e = TC ? (uint32_t)__bfloat16_as_ushort(
                                  __float2bfloat16_rn(lv[k]))
                            : __float_as_uint(lv[k]);
      *reinterpret_cast<uint4*>(tw + (idx & 15) * 64 + (idx >> 7) * 32 +
                                ((idx >> 4) & 7) * 4) = make_uint4(e, e, e, e);
    }
  }

  // x rows 0..R-1 of the block's inputs, in the fragments' order: a unit is
  // 4 inputs of one row (rows past M and inputs past i_end are 0); a
  // thread's kUnits units are loaded before any is stored
  const int groups = ns * kSpan * 2;  // 4-input groups a row
  for (int u0 = threadIdx.x; u0 < groups * R; u0 += kThreads * kUnits) {
    float v[kUnits][4];
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const int u = u0 + k * kThreads;
      const int grp = u % groups, m = u / groups;
      const int i0 = wb * 8 + grp * 4;
      v[k][0] = v[k][1] = v[k][2] = v[k][3] = 0.f;
      if (u < groups * R && m < M) {
        const XT* src = x + (size_t)m * in_f + i0;
        if (vec_x && i0 + 3 < i_end) {
          if constexpr (sizeof(XT) == 4) {
            const float4 a = *reinterpret_cast<const float4*>(src);
            v[k][0] = a.x, v[k][1] = a.y, v[k][2] = a.z, v[k][3] = a.w;
          } else {
            const uint2 a = *reinterpret_cast<const uint2*>(src);
            v[k][0] = __uint_as_float(a.x << 16);
            v[k][1] = __uint_as_float(a.x & 0xffff0000u);
            v[k][2] = __uint_as_float(a.y << 16);
            v[k][3] = __uint_as_float(a.y & 0xffff0000u);
          }
        } else {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (i0 + r < i_end) v[k][r] = slt::to_f32(src[r]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const int u = u0 + k * kThreads;
      if (u >= groups * R) break;
      const int grp = u % groups, m = u / groups;
      const int lw = grp >> 1;  // the word in the split
      const int sp = lw / kSpan, wsp = lw % kSpan;
      const int ks = 2 * (wsp & 3) + (grp & 1);  // k-step 2u + s
      const int tt = wsp >> 2;                   // the lane's t
      if constexpr (TC) {
        reinterpret_cast<uint2*>(xs)[(sp * 8 + ks) * 32 + m * 4 + tt] =
            make_uint2(slt::pack_bf16(v[k][0], v[k][1]),
                       slt::pack_bf16(v[k][2], v[k][3]));
      } else {
        reinterpret_cast<float4*>(xs)[((sp * 8 + ks) * MT + m) * 4 + tt] =
            make_float4(v[k][0], v[k][1], v[k][2], v[k][3]);
      }
    }
  }
  __syncthreads();  // x is staged (and each warp's table written)

  const uint32_t tb0 =
      static_cast<uint32_t>(__cvta_generic_to_shared(tw + lane));
  const uint32_t tb1 = tb0 + 32 * 4;  // channel g + 8
  float acc[TC ? 4 : 2 * MT];
#pragma unroll
  for (int k = 0; k < (TC ? 4 : 2 * MT); ++k) acc[k] = 0.f;

  for (int sp = 0; sp < ns; ++sp) {
    ring_wait<kRing - 2>();  // this lane's copies of span sp landed
    const uint4* st = ring + ((sp % kRing) * kWarps + warp) * 64 + lane;
    const uint4 wa4 = st[0], wb4 = st[32];
    if (sp + kRing - 1 < ns) issue(sp + kRing - 1);
    slt::cp_async_commit();
    const uint32_t wa[4] = {wa4.x, wa4.y, wa4.z, wa4.w};
    const uint32_t wbw[4] = {wb4.x, wb4.y, wb4.z, wb4.w};
    if constexpr (TC) {
      // half a span at a time: its 32 lookups, then its 4 products
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t a[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int uu = half * 2 + (q >> 1), s = q & 1;
          // rows g (a0, a2) and g + 8 (a1, a3); k 2t, 2t+1 (a0, a1) and
          // 2t+8, 2t+9 (a2, a3) = codes 4s, 4s+1 and 4s+2, 4s+3
          a[q][0] = pair(lookup(tb0, wa[uu], 4 * s),
                         lookup(tb0, wa[uu], 4 * s + 1));
          a[q][1] = pair(lookup(tb1, wbw[uu], 4 * s),
                         lookup(tb1, wbw[uu], 4 * s + 1));
          a[q][2] = pair(lookup(tb0, wa[uu], 4 * s + 2),
                         lookup(tb0, wa[uu], 4 * s + 3));
          a[q][3] = pair(lookup(tb1, wbw[uu], 4 * s + 2),
                         lookup(tb1, wbw[uu], 4 * s + 3));
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint2 b = reinterpret_cast<const uint2*>(
              xs)[(sp * 8 + half * 4 + q) * 32 + lane];
          slt::mma_bf16(acc, a[q], b.x, b.y);
        }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const int uu = ks >> 1, s = ks & 1;
        float4 xv[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          xv[m] = reinterpret_cast<const float4*>(
              xs)[((sp * 8 + ks) * MT + m) * 4 + t];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float la = __uint_as_float(lookup(tb0, wa[uu], 4 * s + r));
          const float lb = __uint_as_float(lookup(tb1, wbw[uu], 4 * s + r));
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float xr = r == 0   ? xv[m].x
                             : r == 1 ? xv[m].y
                             : r == 2 ? xv[m].z
                                      : xv[m].w;
            acc[m] = fmaf(xr, la, acc[m]);
            acc[MT + m] = fmaf(xr, lb, acc[MT + m]);
          }
        }
      }
    }
  }
  slt::cp_async_wait<0>();

  // this block's sums: the final y when the split is 1, else its partial
  auto put = [&](int m, int ch, float v) {
    if (m >= M || ch >= out_f) return;
    const size_t yi = (size_t)m * out_f + ch;
    if (splits == 1)
      y[yi] = v;
    else
      ws[(size_t)blockIdx.y * M * out_f + yi] = v;
  };
  if constexpr (TC) {
    // C: rows g (acc 0, 1) and g + 8 (acc 2, 3), columns (x rows) 2t, 2t+1
    put(2 * t, o0 + g, acc[0]);
    put(2 * t + 1, o0 + g, acc[1]);
    put(2 * t, o0 + g + 8, acc[2]);
    put(2 * t + 1, o0 + g + 8, acc[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 2 * MT; ++k) {
      acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], 1);
      acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], 2);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
      if ((m & 3) == t) {
        put(m, o0 + g, acc[m]);
        put(m, o0 + g + 8, acc[MT + m]);
      }
  }
  if (splits == 1) return;

  // the last of the tile's blocks to get here sums the partials in split
  // order and resets the tile's counter for the next launch
  __shared__ int last;
  __threadfence();
  __syncthreads();
  int* cnt = counters + blockIdx.x;
  if (threadIdx.x == 0) last = atomicAdd(cnt, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int ncol = min(kCols, out_f - col0);
  for (int i = threadIdx.x; i < M * ncol; i += kThreads) {
    const int m = i / ncol, c = i % ncol;
    const size_t yi = (size_t)m * out_f + col0 + c;
    float s = 0.f;
    for (int k = 0; k < splits; ++k)
      s += __ldcg(ws + (size_t)k * M * out_f + yi);
    y[yi] = s;
  }
  if (threadIdx.x == 0) *cnt = 0;
}

template <bool TC, int MT, typename XT>
cudaError_t launch(const void* x, const uint32_t* qwt, const float* lut,
                   float* y, float* ws, int* counters, int M, int in_f,
                   int out_f, int splits, int words_per_split, int vec_w,
                   int vec_x, cudaStream_t s) {
  static bool done = false;
  const cudaError_t e = slt::allow_smem(
      k11_kernel<TC, MT, XT>, smem_bytes<TC, MT>(kMaxSplitWords), done);
  if (e != cudaSuccess) return e;
  const dim3 grid((out_f + kCols - 1) / kCols, splits);
  k11_kernel<TC, MT, XT>
      <<<grid, kThreads, smem_bytes<TC, MT>(words_per_split), s>>>(
          static_cast<const XT*>(x), qwt, lut, y, ws, counters, M, in_f,
          out_f, splits, words_per_split, vec_w, vec_x);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_x(const void* x, const uint32_t* qwt, const float* lut,
                     float* y, float* ws, int* counters, int M, int in_f,
                     int out_f, int bf16_mode, int splits,
                     int words_per_split, int vec_w, int vec_x,
                     cudaStream_t s) {
#define SLT_K11(TC_, MT_)                                                  \
  return launch<TC_, MT_, XT>(x, qwt, lut, y, ws, counters, M, in_f,       \
                              out_f, splits, words_per_split, vec_w, vec_x, \
                              s)
  if (bf16_mode) SLT_K11(true, kMaxRows);
  if (M <= 1) SLT_K11(false, 1);
  if (M <= 2) SLT_K11(false, 2);
  if (M <= 4) SLT_K11(false, 4);
  SLT_K11(false, 8);
#undef SLT_K11
}

}  // namespace

// x (M, in) f32 or bf16, M in 1..8; qweight_t int32 (out, n_words) with
// n_words = ceil(in / 8); lut f32 (out, 16); y (M, out) f32; splits blocks
// of words_per_split (a multiple of 16, at most 128) packed words a
// 128-channel tile, covering n_words; ws: f32 (splits, M, out) when splits
// > 1, else null; counters: int32, one per 128-channel tile, all 0 (each
// launch leaves them 0). All contiguous. Returns cudaGetLastError().
extern "C" int slt_lut_matmul_t(const void* x, int x_bf16,
                                const void* qweight_t, const void* lut,
                                void* y, void* ws, void* counters, int M,
                                int in_f, int out_f, int bf16_mode,
                                int splits, int words_per_split,
                                void* stream) {
  if (M <= 0 || out_f <= 0) return (int)cudaSuccess;
  const int nw = (in_f + 7) / 8;
  if (M > kMaxRows || in_f <= 0 || splits < 1 || words_per_split < kSpan ||
      words_per_split % kSpan || words_per_split > kMaxSplitWords ||
      (long long)splits * words_per_split < nw ||
      (splits > 1 && (!ws || !counters)))
    return (int)cudaErrorInvalidValue;
  const auto* qw = static_cast<const uint32_t*>(qweight_t);
  const int vec_w = nw % 4 == 0 && reinterpret_cast<uintptr_t>(qw) % 16 == 0;
  const int vec_x = in_f % 4 == 0 && reinterpret_cast<uintptr_t>(x) %
                                             (x_bf16 ? 8 : 16) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* lt = static_cast<const float*>(lut);
  auto* yy = static_cast<float*>(y);
  auto* wsp = static_cast<float*>(ws);
  auto* cnt = static_cast<int*>(counters);
  if (x_bf16)
    return (int)launch_x<__nv_bfloat16>(x, qw, lt, yy, wsp, cnt, M, in_f,
                                        out_f, bf16_mode, splits,
                                        words_per_split, vec_w, vec_x, s);
  return (int)launch_x<float>(x, qw, lt, yy, wsp, cnt, M, in_f, out_f,
                              bf16_mode, splits, words_per_split, vec_w,
                              vec_x, s);
}
