// K4: dequantize packed words + per-channel LUT to a dense weight, with the
// sparse sidecar folded in.
//
//   W[i, o] = lut[o, code(i, o)]
//   W[cols[e], o] += vals[e]  for e in CSR row o, in CSR order
//
// both in one launch (k4_dequant_kernel).
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
// 45 MB read, 180 MB written in bf16, ~0.069 ms at 3.35 TB/s); the work per
// element of W is a shift, a mask and a shared-memory read. W's bytes are
// 80% of the traffic (bf16) or more, so the design is about the stores:
//  * a lane owns 4 adjacent columns: it loads their words of a word row as
//    one 16-byte load and stores each of the word's 8 or 10 rows as one
//    8-byte (bf16) or 16-byte (f32) store, so a warp writes 256 or 512
//    contiguous bytes of a row of W, whole 128-byte lines;
//  * a warp loads all of its 8 word rows before it looks up any code (8
//    16-byte loads a lane in flight), and issues them before the block
//    stages its table, so the table's latency hides behind the words';
//  * a block covers 128 columns x 64 word rows (512 rows of W at 4 bits):
//    its table, staged once in shared memory as [code][column % 4][lane],
//    is 1/16 (bf16) or 1/32 (f32) of the bytes it writes, and lane l's
//    entries all lie in bank l, so 32 lookups of any codes never conflict;
//    o's 4096 x 4096 gives 256 such blocks, two an SM;
//  * with a sidecar and a bf16 W, a block takes two such runs of 64 word
//    rows in turn where the grid still gives every SM two blocks, so half
//    as many blocks walk each column's CSR row (below);
//  * the codes of the last word past `in` are skipped: W has no such rows.
// The fold runs in the same launch, on W's values before they are stored:
// applied to W once it is written, each entry is a random 32-byte
// read-modify-write of W in DRAM, where few bytes cost many row activations.
// Before its stores, thread c of a block walks the CSR row of column col0 + c
// (8 entries read ahead) and files the entries of the block's rows, in CSR
// order, under their word row (a shared-memory bucket of 24 a word row; ~4.6
// expected at 0.45%). A warp then writes each word row's values to its own
// staging rows in shared memory, takes the row's bucket a lane an entry (lanes
// whose entries share a slot find each other with __match_any_sync, and the
// lowest adds their values in bucket order), and copies the rows to W with the
// vector stores above. A slot's entries come from one thread, so bucket order
// is CSR order and duplicates add one after the other as in the plain version;
// no atomics on W, the same bits every run. A bucket that fills (a crowded
// sidecar) sends its block to the slow fold: the block stores unstaged, then
// thread c adds its column's entries one read-modify-write each. Entries with
// vals == 0 (padding) add nothing.
// bf16 mode rounds where the JAX package does: the LUT to bf16 before the
// gather (so W holds it exactly), each sidecar value to bf16, and their sum
// to bf16 again: a folded slot holds bf16(bf16(lut) + bf16(v)).
#include "common.cuh"

namespace {

constexpr int kCols = 128;  // output columns a block, 4 a lane
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWordsPerWarp = 8;  // word rows a warp, all loaded at once
constexpr int kWordsPerBlock = kWarps * kWordsPerWarp;
constexpr int kMaxPasses = 2;  // word-row blocks a block takes in turn
constexpr int kBucket = 24;  // sidecar entries a word row holds
static_assert(kBucket <= 32, "a word row's entries are one warp's batch");
constexpr int kAhead = 8;     // CSR entries a thread reads ahead

// 4 values as W's row elements at p: one 16-byte (f32) or 8-byte (bf16)
// store; bf16 values are already bf16 (the table is rounded), so packing
// keeps their high halves.
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(__byte_perm(__float_as_uint(v[0]), __float_as_uint(v[1]),
                             0x7632),
                 __byte_perm(__float_as_uint(v[2]), __float_as_uint(v[3]),
                             0x7632));
}

// Shared memory of a block: the table; with a sidecar also each warp's
// staged word row (CPW rows x kCols of W's type), then the entries filed
// by word row and their counts (the last count is the spill flag), both
// sized by the block's passes.
template <int BITS, typename TW>
struct Smem {
  static constexpr int CPW = BITS == 4 ? 8 : 10;  // codes per int32 word
  static constexpr int K = 1 << BITS;
  static constexpr int TAB = K * kCols * 4;
  static constexpr int STAGE = kWarps * CPW * kCols * (int)sizeof(TW);
  static constexpr int BKT = kWordsPerBlock * kBucket * 8;  // a pass's
  static constexpr int bytes(bool sparse, int passes) {
    return sparse ? TAB + STAGE + passes * (BKT + kWordsPerBlock * 4) + 4
                  : TAB;
  }
};

// 4 of W's elements as raw bits: 16 bytes (f32) or 8 (bf16)
template <typename TW>
using Raw4 = std::conditional_t<sizeof(TW) == 4, uint4, uint2>;

// VEC: out_f % 4 == 0 and the words 16-byte aligned, so a lane's 4 columns
// are all in range or all out, and its loads and stores are whole vectors.
template <int BITS, typename TW, bool VEC>
__global__ void __launch_bounds__(kThreads)
    k4_dequant_kernel(const uint32_t* __restrict__ qw,
                      const float* __restrict__ lut,
                      const int* __restrict__ rowptr,
                      const int* __restrict__ cols,
                      const float* __restrict__ vals, TW* w, int in_f,
                      int out_f, int nw, int round_lut, int passes) {
  using S = Smem<BITS, TW>;
  constexpr int CPW = S::CPW, K = S::K;
  extern __shared__ __align__(16) unsigned char smem[];
  float* tab = reinterpret_cast<float*>(smem);
  TW* stage = reinterpret_cast<TW*>(smem + S::TAB);
  int2* bkt = reinterpret_cast<int2*>(smem + S::TAB + S::STAGE);
  int* bcnt =
      reinterpret_cast<int*>(smem + S::TAB + S::STAGE + passes * S::BKT);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * kCols;
  const int col = col0 + lane * 4;
  // the block's word rows: `passes` runs of kWordsPerBlock, in turn
  const int wb0 = blockIdx.y * kWordsPerBlock * passes;
  const bool sparse = rowptr != nullptr;  // uniform

  // a pass's word rows of this warp, all in flight at once (the first
  // pass's before the table is staged)
  uint32_t wd[kWordsPerWarp][4];
  auto load_words = [&](int wi0) {
#pragma unroll
    for (int u = 0; u < kWordsPerWarp; ++u) {
      const int wi = wi0 + u;
      const uint32_t* src = qw + (size_t)wi * out_f + col;
      if (VEC) {
        uint4 q = make_uint4(0u, 0u, 0u, 0u);
        if (wi < nw && col < out_f)
          q = __ldg(reinterpret_cast<const uint4*>(src));
        wd[u][0] = q.x, wd[u][1] = q.y, wd[u][2] = q.z, wd[u][3] = q.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wd[u][q] = (wi < nw && col + q < out_f) ? __ldg(src + q) : 0u;
      }
    }
  };
  load_words(wb0 + warp * kWordsPerWarp);
  // the sidecar: thread c < kCols walks the CSR row of column col0 + c and
  // files each entry of the block's rows, in CSR order, under its word row
  // (key = row in the word * kCols + column in the block)
  const int r0 = wb0 * CPW;
  const int r1 = min(in_f, r0 + kWordsPerBlock * passes * CPW);
  const int nbkt = kWordsPerBlock * passes;  // bcnt[nbkt]: spill
  const int fcol = col0 + threadIdx.x;
  int e_lo = 0, e_hi = 0;
  if (sparse) {
    if (threadIdx.x < kCols && fcol < out_f) {
      e_lo = rowptr[fcol];
      e_hi = rowptr[fcol + 1];
    }
    for (int k = threadIdx.x; k <= nbkt; k += kThreads) bcnt[k] = 0;
    __syncthreads();
    for (int e0 = e_lo; e0 < e_hi; e0 += kAhead) {
      int i[kAhead];
      float v[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const bool ok = e0 + u < e_hi;
        i[u] = ok ? __ldg(cols + e0 + u) : -1;
        v[u] = ok ? __ldg(vals + e0 + u) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (i[u] < r0 || i[u] >= r1) continue;
        const int wr = (i[u] - r0) / CPW;
        const int pos = atomicAdd(&bcnt[wr], 1);
        if (pos < kBucket)
          bkt[wr * kBucket + pos] = make_int2(
              (i[u] - r0 - wr * CPW) * kCols + (int)threadIdx.x,
              __float_as_int(v[u]));
        else
          bcnt[nbkt] = 1;  // spill
      }
    }
  }
  // the block's LUT rows: kCols * K contiguous floats of lut (out, K);
  // column c's code k at [k][c % 4][c / 4]
  for (int t = threadIdx.x; t < kCols * K; t += kThreads) {
    const int c = t / K, k = t % K;
    const float v = col0 + c < out_f ? lut[(size_t)col0 * K + t] : 0.f;
    tab[k * kCols + (c & 3) * 32 + (c >> 2)] =
        round_lut ? slt::round_bf16(v) : v;
  }
  __syncthreads();
  const bool spill = sparse && bcnt[nbkt];  // uniform
  const bool staged = sparse && !spill;
  TW* st = stage + warp * CPW * kCols;  // the warp's staged word row

  const float* tl = tab + lane;  // + k * kCols + q * 32
  for (int pass = 0; pass < passes; ++pass) {
    const int wi0 = wb0 + pass * kWordsPerBlock + warp * kWordsPerWarp;
    if (pass > 0) load_words(wi0);
#pragma unroll
    for (int u = 0; u < kWordsPerWarp; ++u) {
      const int i0 = (wi0 + u) * CPW;
      const int valid = min(CPW, in_f - i0);  // warp-uniform; the tail is cut
      if (valid <= 0) break;
#pragma unroll
      for (int j = 0; j < CPW; ++j) {
        if (!staged && j >= valid) break;
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v[q] = tl[((wd[u][q] >> (BITS * j)) & (K - 1)) * kCols + q * 32];
        if (staged) {
          store4(st + j * kCols + lane * 4, v);
          continue;
        }
        TW* dst = w + (size_t)(i0 + j) * out_f + col;
        if (VEC) {
          if (col < out_f) store4(dst, v);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (col + q < out_f) slt::store_f32(v[q], dst + q);
        }
      }
      if (!staged) continue;
      // the word row's entries, a lane an entry: lanes of one slot find each
      // other and the lowest adds their values in bucket order (CSR order)
      __syncwarp();
      const int wr = (wi0 - wb0) + u;  // the word row in the block
      const int n = bcnt[wr];
      const int2 en = lane < n ? bkt[wr * kBucket + lane] : make_int2(-1, 0);
      const unsigned peers = __match_any_sync(0xffffffffu, en.x);
      if (en.x >= 0 && __ffs(peers) - 1 == lane) {
        float acc = slt::to_f32(st[en.x]);
        for (unsigned m = peers; m; m &= m - 1) {
          float v = __int_as_float(bkt[wr * kBucket + __ffs(m) - 1].y);
          // in W's type: bf16 mode adds the value rounded to bf16 and rounds
          // each sum
          if (sizeof(TW) == 2) v = slt::round_bf16(v);
          acc = __fadd_rn(acc, v);
          if (sizeof(TW) == 2) acc = slt::round_bf16(acc);
        }
        slt::store_f32(acc, st + en.x);
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < CPW; ++j) {
        if (j >= valid) break;
        const TW* src = st + j * kCols + lane * 4;
        TW* dst = w + (size_t)(i0 + j) * out_f + col;
        if (VEC) {
          if (col < out_f)
            *reinterpret_cast<Raw4<TW>*>(dst) =
                *reinterpret_cast<const Raw4<TW>*>(src);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (col + q < out_f) dst[q] = src[q];
        }
      }
    }
  }
  if (!spill) return;  // uniform

  // the slow fold (a crowded sidecar filled a bucket): after every store of
  // the block, thread c adds the entries of column col0 + c that lie in the
  // block's rows, in CSR order, one read-modify-write each
  __syncthreads();
  for (int e0 = e_lo; e0 < e_hi; e0 += kAhead) {
    int i[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      i[u] = e0 + u < e_hi ? __ldg(cols + e0 + u) : -1;
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (i[u] < r0 || i[u] >= r1) continue;
      float v = __ldg(vals + e0 + u);
      if (sizeof(TW) == 2) v = slt::round_bf16(v);
      TW* p = w + (size_t)i[u] * out_f + fcol;
      slt::store_f32(__fadd_rn(slt::to_f32(*p), v), p);
    }
  }
}

template <int BITS, typename TW, bool VEC>
cudaError_t launch_k(dim3 grid, cudaStream_t s, const uint32_t* qw,
                     const float* lut, const int* rowptr, const int* cols,
                     const float* vals, TW* w, int in_f, int out_f, int nw,
                     int round_lut, int passes) {
  using S = Smem<BITS, TW>;
  static bool done = false;
  const cudaError_t e =
      slt::allow_smem(k4_dequant_kernel<BITS, TW, VEC>,
                      S::bytes(true, kMaxPasses), done);
  if (e != cudaSuccess) return e;
  k4_dequant_kernel<BITS, TW, VEC>
      <<<grid, kThreads, S::bytes(rowptr != nullptr, passes), s>>>(
          qw, lut, rowptr, cols, vals, w, in_f, out_f, nw, round_lut,
          passes);
  return cudaGetLastError();
}

template <int BITS, typename TW>
cudaError_t launch(cudaStream_t s, const uint32_t* qw, const float* lut,
                   const int* rowptr, const int* cols, const float* vals,
                   void* w, int in_f, int out_f, int nw, int round_lut) {
  // with a sidecar and a bf16 W, two passes a block, which halves the
  // blocks that walk each column's CSR row, wherever that still leaves
  // every SM two blocks (an f32 W's stores already hide the walk: on the
  // H100 two passes were no faster there, nor without a sidecar)
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    const cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    const cudaError_t e2 =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e2 != cudaSuccess) return e2;
  }
  const int tiles = (out_f + kCols - 1) / kCols;
  const int per2 = kWordsPerBlock * kMaxPasses;
  const int passes = rowptr != nullptr && sizeof(TW) == 2 &&
                             tiles * ((nw + per2 - 1) / per2) >= 2 * sms
                         ? 2
                         : 1;
  const int per = kWordsPerBlock * passes;
  const dim3 grid(tiles, (nw + per - 1) / per);
  TW* wt = static_cast<TW*>(w);
  if (out_f % 4 == 0 && reinterpret_cast<uintptr_t>(qw) % 16 == 0)
    return launch_k<BITS, TW, true>(grid, s, qw, lut, rowptr, cols, vals, wt,
                                    in_f, out_f, nw, round_lut, passes);
  return launch_k<BITS, TW, false>(grid, s, qw, lut, rowptr, cols, vals, wt,
                                   in_f, out_f, nw, round_lut, passes);
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
  cudaError_t e;
  if (bits == 4 && w_bf16)
    e = launch<4, __nv_bfloat16>(s, qw, lt, rp, cl, vl, w, in_f, out_f, nw, 1);
  else if (bits == 4)
    e = launch<4, float>(s, qw, lt, rp, cl, vl, w, in_f, out_f, nw, 0);
  else if (w_bf16)
    e = launch<3, __nv_bfloat16>(s, qw, lt, rp, cl, vl, w, in_f, out_f, nw, 1);
  else
    e = launch<3, float>(s, qw, lt, rp, cl, vl, w, in_f, out_f, nw, 0);
  return (int)e;
}
