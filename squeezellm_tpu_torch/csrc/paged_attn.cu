// K6-K9: attention through a page table over a shared KV page pool, with
// rope and the pool write fused in: decode (one token a slot) over an
// f32/bf16 pool (K6) or an int8 pool with f32 row scales (K7), and the
// W-token speculative verify window over the same two (K8, K9).
//
// A layer's pool is token-major, (P, ps, Hkv*hd) for k and for v; position t
// of slot b lives in page table[b][t / ps] at row t % ps. For each slot and
// kv head: rope the W new k rows and the g*W query rows from the exact
// cos/sin rows, write the W new k/v rows at positions start..start+W-1
// through the page table (they may cross a page), then online softmax of
// each query row (head u, window offset w, at qpos = start + w) over the
// positions qpos - window < t <= qpos. An inactive slot (length 0, or
// start < 0) writes nothing and outputs zeros. Decode is the window of one
// token at start = length - 1.
//
// Replaces the TPU kernels `_paged_attn_kernel` (K6, launched by
// `paged_decode_attention`), `_paged_attn_kernel_q8` (K7,
// `paged_decode_attention_q8`), `_paged_verify_kernel` (K8,
// `paged_verify_attention`) and `_paged_verify_kernel_q8` (K9,
// `paged_verify_attention_q8`) of squeezellm_tpu/ops/paged_attn.py.
//
// Bound on the H100: bytes. A call reads the valid rows of k and v once
// (8 slots x 1024 rows of a bf16 LLaMA-2-7B layer: 134 MB, 0.040 ms; int8
// codes with their scales about half) and does ~4 flops a byte (~4 W for a
// window). Design (split-K, "flash decoding", as K2/K5 in decode_attn.cu):
//  * the grid is (kv head, slot, split): a block owns one kv head's g*W
//    query rows over the positions [split * chunk, (split + 1) * chunk) of
//    its slot, whatever pages hold them (chunk boundaries are positions,
//    not pages, so any page size works). The split count ceil(maxp * ps /
//    chunk) follows the table's capacity alone, and a chunk's positions do
//    not depend on the cohort, so a slot's bits do not depend on the other
//    slots' lengths or starts or on B. A block whose chunk holds no
//    position in [max(start + 1 - window, 0), n_end) exits at once;
//  * a new row at position pos is written (in int8 quantized) by the one
//    block whose chunk holds pos, and only that block reads it back, after
//    its __syncthreads, so no block depends on another block's write (no
//    ordering exists between blocks); a window that crosses a chunk has two
//    writers, each for its own rows. Prefix pages that several slots share
//    are read by all of them and written by none. The rows enter attention
//    as the pool holds them (bf16, or code times scale), as every other row;
//  * the chunk's positions are resolved through the page table once, into
//    pool rows in shared memory, so no row load waits on a table load;
//  * rope uses the caller's cos/sin rows, the multiply and the add rounded
//    separately as the plain version does;
//  * 8 warps split the chunk's positions, 8 keys a warp at a time; each
//    step issues all of its loads before it uses the first, and decode
//    over a bf16 or int8 pool issues the next step's too (two blocks of
//    256 threads an SM, 113-123 registers). For q.k, 4 lanes share a key,
//    each with a quarter of its head row (one 16-byte load per 8 bf16
//    elements; 8 keys' quarters lie in 8 lines), and the query rows come
//    from shared memory. For p.v a lane holds hd/32 ADJACENT elements of
//    each of the 8 keys' v rows (one 8-byte load for bf16 at hd 128, 4
//    bytes for int8, 16 for f32). One lane a key would touch the lines of
//    32 rows a load, four a key those of 8;
////  * the query rows' registers and shared memory are sized by RR: 1 where
//    g*W = 1 (every multi-head decode), 8 otherwise. No (key, query row)
//    pair pays a warp_sum: the 4 quarters' partial dot products of all of
//    a key's rows are summed in one butterfly of halving exchanges (two
//    shuffles for one row; six for eight, after which a lane holds two
//    rows' logits), a row's 8 logits need three more for their max, and a
//    lane takes one exp for each logit it holds; p and the rescale reach
//    p.v through shared memory. Rows past g*W are skipped by block-uniform
//    branches, so a W = 5 window pays for 5 rows' products. A GQA window
//    with g*W > 8 rows takes passes of 8 rows, each of which reads the
//    chunk's keys again (no timed case runs one). Products and softmax
//    stay in f32;
//  * a slot whose attended positions lie in one chunk writes out directly;
//    else each block stores (m, l, acc[g*W][hd]) in a workspace and the
//    LAST of the slot's blocks to arrive (an atomic counter picks it and is
//    reset by it; no value is summed by an atomic) merges the partials in
//    split order. The 8 warps' states are merged in a fixed order too. Same
//    inputs, same bits, every launch; still one launch a call;
//  * the int8 twins quantize each new row in the kernel, one warp a row:
//    scale = max(max|row| * f32(1/127), 1e-12), code = clip(rint(x / scale),
//    -127, 127) with a true f32 divide, bit-identical to
//    `kv_quant.quantize_rows`; scales are stored (P, Hkv, ps). The k scale
//    multiplies the logit after the dot product of q with the raw codes, the
//    v scale multiplies p before p.v;
//  * a position at or beyond the table's capacity (maxp * ps) is neither
//    written nor read.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLanes = 4;            // lanes that share a key in q.k
constexpr int kStep = 32 / kLanes;   // keys a warp takes at once
constexpr int kMaxW = 8;        // window tokens
constexpr int kMaxG = 8;        // query heads per kv head
constexpr int kMaxChunk = 1024;  // positions a block (the wrapper's CHUNK)

// A lane's N adjacent elements of a row, read in loads of up to 16 bytes.
template <typename TC, int N, int BYTES = N * (int)sizeof(TC)>
struct Chunk {
  using Word = std::conditional_t<(BYTES >= 16), uint4,
                                  typename slt::Raw<TC, N>::T>;
  static constexpr int kWords = BYTES >= 16 ? BYTES / 16 : 1;
  Word w[kWords];
  static __device__ __forceinline__ Chunk load(const TC* p) {
    Chunk c;
#pragma unroll
    for (int i = 0; i < kWords; ++i)
      c.w[i] = reinterpret_cast<const Word*>(p)[i];
    return c;
  }
  __device__ __forceinline__ float at(int i) const {
    return slt::to_f32(reinterpret_cast<const TC*>(w)[i]);
  }
};

// NW: new rows a block can stage (1 where RR = 1, which means W = 1).
// The query rows are kept by quarters of the head dims, each padded by 16
// bytes, so that the 4 quarters a warp reads at once lie in other banks.
template <int RR, int hd, int NW>
struct Smem {
  union {
    struct {
      float q[RR][kLanes][hd / kLanes + 4];  // this pass's query rows, roped
      float kv[2][NW][hd];  // the chunk's new k (roped) and v rows
    } in;
    float acc[kWarps][RR][hd];  // the warps' states, after the key loop
  } u;
  float m[kWarps][RR], l[kWarps][RR];
  float p[kWarps][RR][kStep];  // each row's p for the warp's 8 keys
  float a[kWarps][RR];         // and its rescale
  int rows[kMaxChunk];         // pool row of each position of the chunk
  int srows[kMaxChunk];        // int8: index of its row scale (kv head 0)
  int last;
};

template <typename TIN, typename TC, int D, int RR>
__global__ void __launch_bounds__(kThreads, 2)
    paged_attn_kernel(const TIN* __restrict__ q, const TIN* __restrict__ kn,
                      const TIN* __restrict__ vn, int q_bs, int q_hs, int q_ws,
                      int kv_bs, int kv_hs, int kv_ws,
                      const float* __restrict__ rope_cos,
                      const float* __restrict__ rope_sin, TC* pk, TC* pv,
                      float* sk, float* sv,
                      const int* __restrict__ page_tables,
                      const int* __restrict__ index, int index_is_length,
                      float* __restrict__ out, float* ws_acc, float* ws_ml,
                      int* counters, int W, int ps, int maxp, int Hkv, int g,
                      int window, float scale, int chunk) {
  static_assert(RR == 1 || RR == 8, "RR is 1 or 8");
  constexpr int hd = D * 32;
  constexpr bool kQ8 = sizeof(TC) == 1;  // int8 codes + row scales
  using RawT = typename slt::Raw<TC, D>::T;
  constexpr int KD = hd / kLanes;  // elements of a key a lane takes in q.k
  // query rows whose logit a lane holds after the reduction
  constexpr int kHeld = RR == 1 ? 1 : RR / kLanes;
  __shared__ __align__(16) Smem<RR, hd, RR == 1 ? 1 : kMaxW> sm;

  const int kvh = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int H = Hkv * g, R = g * W;
  const int start = index[b] - (index_is_length ? 1 : 0);
  const int cap = maxp * ps;
  const int n_end = start >= 0 ? min(start + W, cap) : 0;
  // the first position a query row attends (or the window writes)
  const int lo = max(min(start + 1 - window, start), 0);
  if (lo >= n_end) {  // inactive, or past the capacity: zeros, from split 0
    if (sp == 0)
      for (int t = threadIdx.x; t < R * hd; t += kThreads) {
        const int r = t / hd, d = t % hd, u = r / W, w = r - u * W;
        out[(((size_t)b * W + w) * H + (size_t)kvh * g + u) * hd + d] = 0.f;
      }
    return;
  }
  const int s_lo = lo / chunk, s_hi = (n_end - 1) / chunk;
  if (sp < s_lo || sp > s_hi) return;  // no position of this chunk is used
  const int c0 = sp * chunk;
  const int r_lo = max(lo, c0), r_hi = min(n_end, c0 + chunk);
  const int w_lo = max(start, c0);  // the new rows of this chunk: to r_hi
  const int nw = max(r_hi - w_lo, 0);
  const size_t row_stride = (size_t)Hkv * hd;
  const int* pt = page_tables + (size_t)b * maxp;

  for (int t = r_lo + threadIdx.x; t < r_hi; t += kThreads) {
    const int page = t / ps, off = t - page * ps;
    const int pid = pt[page];
    sm.rows[t - c0] = pid * ps + off;
    if constexpr (kQ8) sm.srows[t - c0] = pid * Hkv * ps + off;
  }
  // stage this chunk's new k rows (roped) and v rows of this kv head as f32
  const TIN* kb = kn + (size_t)b * kv_bs + (size_t)kvh * kv_hs;
  const TIN* vb = vn + (size_t)b * kv_bs + (size_t)kvh * kv_hs;
  for (int t = threadIdx.x; t < nw * hd; t += kThreads) {
    const int i = t / hd, d = t % hd, w = w_lo - start + i;
    const TIN* kr = kb + (size_t)w * kv_ws;
    float x = slt::to_f32(kr[d]);
    if (rope_cos != nullptr) {
      const float rot = d < hd / 2 ? -slt::to_f32(kr[d + hd / 2])
                                   : slt::to_f32(kr[d - hd / 2]);
      const size_t ro = ((size_t)b * W + w) * hd + d;
      x = __fadd_rn(__fmul_rn(x, rope_cos[ro]), __fmul_rn(rot, rope_sin[ro]));
    }
    sm.u.in.kv[0][i][d] = x;
    sm.u.in.kv[1][i][d] = slt::to_f32(vb[(size_t)w * kv_ws + d]);
  }
  // the query rows r0.. of a pass, roped: row r is head r / W at offset
  // r % W; rows past R are zeros
  const TIN* qb = q + (size_t)b * q_bs + (size_t)kvh * g * q_hs;
  auto stage_q = [&](int r0) {
    for (int t = threadIdx.x; t < RR * hd; t += kThreads) {
      const int i = t / hd, d = t % hd, r = r0 + i;
      float x = 0.f;
      if (r < R) {
        const int u = r / W, w = r - u * W;
        const TIN* qrow = qb + (size_t)u * q_hs + (size_t)w * q_ws;
        x = slt::to_f32(qrow[d]);
        if (rope_cos != nullptr) {
          const float rot = d < hd / 2 ? -slt::to_f32(qrow[d + hd / 2])
                                       : slt::to_f32(qrow[d - hd / 2]);
          const size_t ro = ((size_t)b * W + w) * hd + d;
          x = __fadd_rn(__fmul_rn(x, rope_cos[ro]),
                        __fmul_rn(rot, rope_sin[ro]));
        }
      }
      sm.u.in.q[i][d / KD][d % KD] = x;
    }
  };
  stage_q(0);
  __syncthreads();

  if (nw > 0) {
    if constexpr (kQ8) {
      // one warp a row: rows 0..nw-1 are k, nw..2nw-1 are v
      for (int row = warp; row < 2 * nw; row += kWarps) {
        const int which = row >= nw, i = row - which * nw;
        const int c = w_lo + i - c0;
        const float* src = sm.u.in.kv[which][i];
        float amax = 0.f;
#pragma unroll
        for (int e = 0; e < D; ++e)
          amax = fmaxf(amax, fabsf(src[lane + 32 * e]));
        amax = slt::warp_max(amax);
        const float s = fmaxf(__fmul_rn(amax, 1.0f / 127.0f), 1e-12f);
        TC* dst = (which ? pv : pk) + (size_t)sm.rows[c] * row_stride +
                  (size_t)kvh * hd;
#pragma unroll
        for (int e = 0; e < D; ++e) {
          const float r = rintf(__fdiv_rn(src[lane + 32 * e], s));
          dst[lane + 32 * e] = (TC)fminf(fmaxf(r, -127.f), 127.f);
        }
        if (lane == 0) (which ? sv : sk)[sm.srows[c] + kvh * ps] = s;
      }
    } else {
      for (int t = threadIdx.x; t < nw * hd; t += kThreads) {
        const int i = t / hd, d = t % hd;
        const size_t o = (size_t)sm.rows[w_lo + i - c0] * row_stride +
                         (size_t)kvh * hd + d;
        slt::store_f32(sm.u.in.kv[0][i][d], pk + o);
        slt::store_f32(sm.u.in.kv[1][i][d], pv + o);
      }
    }
    __syncthreads();  // the block's pool writes are visible to its reads
  }

  const int nsplit = s_hi - s_lo + 1;
  // this block's partials: R rows from ((b, kvh, sp) * R) on
  const size_t part = ((size_t)b * Hkv + kvh) * gridDim.z + sp;
  for (int r0 = 0; r0 < R; r0 += RR) {
    const int nr = min(RR, R - r0);
    if (r0 > 0) {
      stage_q(r0);
      __syncthreads();
    }
    // a lane's key for q.k (kg) and its quarter of the head dims (sl); the
    // query rows whose logit it holds after the reduction: row 0 (RR = 1,
    // on every lane), or rows sl * kHeld + i
    const int kg = lane / kLanes, sl = lane % kLanes;
    float acc[RR][D], m[kHeld], lp[kHeld];  // lp: this lane's part of l
    int qp[kHeld];                          // -1: no such row
#pragma unroll
    for (int i = 0; i < kHeld; ++i) {
      const int r = RR == 1 ? 0 : sl * kHeld + i;
      qp[i] = r < nr ? start + (r0 + r) % W : -1;
      m[i] = -CUDART_INF_F;
      lp[i] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < RR; ++r)
#pragma unroll
      for (int e = 0; e < D; ++e) acc[r][e] = 0.f;

    // a step's loads, issued together: the lane's quarter of its key's k
    // row (and scales), and D adjacent elements of each of the 8 keys' v
    // rows. Decode over a bf16 or int8 pool issues the next step's before
    // this step's arithmetic; a window, or an f32 pool's twice larger
    // steps, leave no registers for them (that prefetch spilled, and the
    // window's ran slower, on the H100)
    struct Step {
      Chunk<TC, KD> k;
      RawT v[kStep];
      float ksc, vsc;
    };
    auto load_step = [&](int t0) {
      Step st;
      const int c = min(t0 + kg, r_hi - 1) - c0;  // keys past r_hi unused
      st.k = Chunk<TC, KD>::load(pk + (size_t)sm.rows[c] * row_stride +
                                 (size_t)kvh * hd + sl * KD);
#pragma unroll
      for (int j = 0; j < kStep; ++j) {
        const int cj = min(t0 + j, r_hi - 1) - c0;
        st.v[j] = *reinterpret_cast<const RawT*>(
            pv + (size_t)sm.rows[cj] * row_stride + (size_t)kvh * hd +
            lane * D);
      }
      st.ksc = scale;
      st.vsc = 1.f;
      if constexpr (kQ8) {
        const int so = sm.srows[c] + kvh * ps;
        st.ksc = sk[so] * scale;
        st.vsc = sv[so];
      }
      return st;
    };
    constexpr int kStride = kWarps * kStep;
    constexpr bool kPrefetch = RR == 1 && sizeof(TC) < 4;
    Step next;
    if (kPrefetch && r_lo + warp * kStep < r_hi)
      next = load_step(r_lo + warp * kStep);
    for (int t0 = r_lo + warp * kStep; t0 < r_hi; t0 += kStride) {
      Step cur;
      if constexpr (kPrefetch) {
        cur = next;
        if (t0 + kStride < r_hi) next = load_step(t0 + kStride);
      } else {
        cur = load_step(t0);
      }
      const Chunk<TC, KD>& kq = cur.k;
      const RawT* vr = cur.v;
      const float ksc = cur.ksc, vsc = cur.vsc;
      const int t = t0 + kg;
      // q.k over the quarter, for each query row of the pass
      float kx[KD], dot[RR];
#pragma unroll
      for (int x = 0; x < KD; ++x) kx[x] = kq.at(x);
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        dot[r] = 0.f;
        if (r < nr) {
#pragma unroll
          for (int x = 0; x < KD; ++x)
            dot[r] = fmaf(sm.u.in.q[r][sl][x], kx[x], dot[r]);
        }
      }
      // the 4 quarters' partial sums of all rows in one butterfly: halving
      // exchanges leave each lane the sums of its kHeld rows
      if constexpr (RR == 1) {
        dot[0] += __shfl_xor_sync(0xffffffffu, dot[0], 2);
        dot[0] += __shfl_xor_sync(0xffffffffu, dot[0], 1);
      } else {
#pragma unroll
        for (int o = 2, n = RR / 2; o > 0; o >>= 1, n >>= 1) {
          const bool hi = lane & o;
#pragma unroll
          for (int i = 0; i < n; ++i) {
            const float send = hi ? dot[i] : dot[i + n];
            const float keep = hi ? dot[i + n] : dot[i];
            dot[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
          }
        }
      }
      // online softmax of each held row over the step's 8 keys (the lanes
      // of one quarter); p and the rescale reach p.v through shared memory
      __syncwarp();  // the previous step's p is read
#pragma unroll
      for (int i = 0; i < kHeld; ++i) {
        const int r = RR == 1 ? 0 : sl * kHeld + i;
        const bool on = t < r_hi && t <= qp[i] && t > qp[i] - window;
        const float x = on ? dot[i] * ksc : -CUDART_INF_F;
        float mx = x;
#pragma unroll
        for (int o = kLanes; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        mx = fmaxf(mx, m[i]);
        // exp(-inf) = 0 while the row has attended nothing
        const float base = mx == -CUDART_INF_F ? 0.f : mx;
        const float alpha = expf(m[i] - base);
        const float p = expf(x - base);
        lp[i] = lp[i] * alpha + p;
        m[i] = mx;
        if (RR > 1 || sl == 0) sm.p[warp][r][kg] = kQ8 ? p * vsc : p;
        if (kg == 0 && (RR > 1 || sl == 0)) sm.a[warp][r] = alpha;
      }
      __syncwarp();
      float vx[kStep][D];
#pragma unroll
      for (int j = 0; j < kStep; ++j)
#pragma unroll
        for (int e = 0; e < D; ++e) vx[j][e] = slt::raw_at<TC, D>(vr[j], e);
#pragma unroll
      for (int r = 0; r < RR; ++r)
        if (r < nr) {
          const float a = sm.a[warp][r];
#pragma unroll
          for (int e = 0; e < D; ++e) acc[r][e] *= a;
#pragma unroll
          for (int j = 0; j < kStep; ++j) {
            const float p = sm.p[warp][r][j];  // 0 past r_hi
#pragma unroll
            for (int e = 0; e < D; ++e)
              acc[r][e] = fmaf(p, vx[j][e], acc[r][e]);
          }
        }
    }
    // l of each held row: the parts of the 8 lanes of its quarter
#pragma unroll
    for (int i = 0; i < kHeld; ++i)
#pragma unroll
      for (int o = kLanes; o < 32; o <<= 1)
        lp[i] += __shfl_xor_sync(0xffffffffu, lp[i], o);

    __syncthreads();  // the query rows are read: acc reuses their memory
    if (kg == 0 && (RR > 1 || sl == 0)) {
#pragma unroll
      for (int i = 0; i < kHeld; ++i) {
        const int r = RR == 1 ? 0 : sl * kHeld + i;
        sm.m[warp][r] = m[i];
        sm.l[warp][r] = lp[i];
      }
    }
#pragma unroll
    for (int r = 0; r < RR; ++r)
#pragma unroll
      for (int e = 0; e < D; ++e) sm.u.acc[warp][r][lane * D + e] = acc[r][e];
    __syncthreads();
    // the block's state: the warps' merged in a fixed order
    for (int t = threadIdx.x; t < nr * hd; t += kThreads) {
      const int i = t / hd, d = t % hd, r = r0 + i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int x = 0; x < kWarps; ++x) mx = fmaxf(mx, sm.m[x][i]);
      float L = 0.f, O = 0.f;
      if (mx != -CUDART_INF_F) {
#pragma unroll
        for (int x = 0; x < kWarps; ++x) {
          const float f = expf(sm.m[x][i] - mx);
          L += sm.l[x][i] * f;
          O += sm.u.acc[x][i][d] * f;
        }
      }
      if (nsplit == 1) {
        const int u = r / W, w = r - u * W;
        out[(((size_t)b * W + w) * H + (size_t)kvh * g + u) * hd + d] =
            mx != -CUDART_INF_F ? O / fmaxf(L, 1e-30f) : 0.f;
      } else {
        ws_acc[(part * R + r) * hd + d] = O;
        if (d == 0) {
          ws_ml[(part * R + r) * 2] = mx;
          ws_ml[(part * R + r) * 2 + 1] = L;
        }
      }
    }
    __syncthreads();  // the shared state is reused by the next pass
  }
  if (nsplit == 1) return;

  // the last of the slot's blocks to arrive merges the partials in split
  // order and resets the counter for the next launch
  __threadfence();
  __syncthreads();
  int* cnt = counters + (size_t)b * Hkv + kvh;
  if (threadIdx.x == 0) sm.last = atomicAdd(cnt, 1) == nsplit - 1;
  __syncthreads();
  if (!sm.last) return;
  __threadfence();
  const size_t part0 = ((size_t)b * Hkv + kvh) * gridDim.z;  // split 0's
  for (int t = threadIdx.x; t < R * hd; t += kThreads) {
    const int r = t / hd, d = t % hd, u = r / W, w = r - u * W;
    float mx = -CUDART_INF_F;
    for (int k = s_lo; k <= s_hi; ++k)
      mx = fmaxf(mx, __ldcg(ws_ml + ((part0 + k) * R + r) * 2));
    float L = 0.f, O = 0.f;
    if (mx != -CUDART_INF_F) {
      for (int k = s_lo; k <= s_hi; ++k) {
        const size_t pr = (part0 + k) * R + r;
        const float f = expf(__ldcg(ws_ml + pr * 2) - mx);
        L += __ldcg(ws_ml + pr * 2 + 1) * f;
        O += __ldcg(ws_acc + pr * hd + d) * f;
      }
    }
    out[(((size_t)b * W + w) * H + (size_t)kvh * g + u) * hd + d] =
        mx != -CUDART_INF_F ? O / fmaxf(L, 1e-30f) : 0.f;
  }
  if (threadIdx.x == 0) *cnt = 0;
}

struct Args {
  const void *q, *kn, *vn;
  int q_bs, q_hs, q_ws, kv_bs, kv_hs, kv_ws;
  const float *rc, *rs;
  void *pk, *pv;
  float *sk, *sv;
  const int *pt, *index;
  int index_is_length;
  float* out;
  float *ws_acc, *ws_ml;
  int* counters;
  int B, W, ps, maxp, Hkv, g, hd, window;
  float scale;
  int chunk;
  cudaStream_t stream;
};

template <typename TIN, typename TC>
void launch_t(const Args& a) {
  const dim3 grid(a.Hkv, a.B, (a.maxp * a.ps + a.chunk - 1) / a.chunk);
  const int RR = a.g * a.W == 1 ? 1 : 8;
#define SLT_PA_CASE(D_, RR_)                                                 \
  if (a.hd == 32 * D_ && RR == RR_)                                          \
    paged_attn_kernel<TIN, TC, D_, RR_><<<grid, kThreads, 0, a.stream>>>(    \
        static_cast<const TIN*>(a.q), static_cast<const TIN*>(a.kn),         \
        static_cast<const TIN*>(a.vn), a.q_bs, a.q_hs, a.q_ws, a.kv_bs,      \
        a.kv_hs, a.kv_ws, a.rc, a.rs, static_cast<TC*>(a.pk),                \
        static_cast<TC*>(a.pv), a.sk, a.sv, a.pt, a.index,                   \
        a.index_is_length, a.out, a.ws_acc, a.ws_ml, a.counters, a.W, a.ps,  \
        a.maxp, a.Hkv, a.g, a.window, a.scale, a.chunk);
#define SLT_PA_RR(D_) SLT_PA_CASE(D_, 1) SLT_PA_CASE(D_, 8)
  SLT_PA_RR(1)
  SLT_PA_RR(2)
  SLT_PA_RR(4)
#undef SLT_PA_RR
#undef SLT_PA_CASE
}

// cache: 0 f32, 1 bf16, 2 int8 codes with f32 row scales
int launch(const Args& a, int in_bf16, int cache) {
  if (a.B <= 0 || a.Hkv <= 0) return (int)cudaSuccess;
  if (a.g < 1 || a.g > kMaxG || a.W < 1 || a.W > kMaxW || a.ps < 1 ||
      a.maxp < 1 || (a.hd != 32 && a.hd != 64 && a.hd != 128) ||
      a.chunk < 1 || a.chunk > kMaxChunk)
    return (int)cudaErrorInvalidValue;
  if (in_bf16) {
    if (cache == 2) launch_t<__nv_bfloat16, int8_t>(a);
    else if (cache == 1) launch_t<__nv_bfloat16, __nv_bfloat16>(a);
    else launch_t<__nv_bfloat16, float>(a);
  } else {
    if (cache == 2) launch_t<float, int8_t>(a);
    else if (cache == 1) launch_t<float, __nv_bfloat16>(a);
    else launch_t<float, float>(a);
  }
  return (int)cudaGetLastError();
}

Args make_args(const void* q, const void* k_new, const void* v_new, int q_bs,
               int q_hs, int q_ws, int kv_bs, int kv_hs, int kv_ws,
               const void* rope_cos, const void* rope_sin, void* pk, void* pv,
               void* sk, void* sv, const void* page_tables, const void* index,
               int index_is_length, void* out, void* ws_acc, void* ws_ml,
               void* counters, int B, int W, int ps, int maxp, int Hkv, int g,
               int hd, int window, float scale, int chunk, void* stream) {
  Args a;
  a.q = q; a.kn = k_new; a.vn = v_new;
  a.q_bs = q_bs; a.q_hs = q_hs; a.q_ws = q_ws;
  a.kv_bs = kv_bs; a.kv_hs = kv_hs; a.kv_ws = kv_ws;
  a.rc = static_cast<const float*>(rope_cos);
  a.rs = static_cast<const float*>(rope_sin);
  a.pk = pk; a.pv = pv;
  a.sk = static_cast<float*>(sk); a.sv = static_cast<float*>(sv);
  a.pt = static_cast<const int*>(page_tables);
  a.index = static_cast<const int*>(index);
  a.index_is_length = index_is_length;
  a.out = static_cast<float*>(out);
  a.ws_acc = static_cast<float*>(ws_acc);
  a.ws_ml = static_cast<float*>(ws_ml);
  a.counters = static_cast<int*>(counters);
  a.B = B; a.W = W; a.ps = ps; a.maxp = maxp; a.Hkv = Hkv; a.g = g;
  a.hd = hd; a.window = window; a.scale = scale; a.chunk = chunk;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// The four entry points share their arguments. q (B, H, W, hd) and
// k_new/v_new (B, Hkv, W, hd) through their batch, head and token strides
// (elements; rows contiguous); in_bf16 selects bf16 or f32 for all three.
// rope_cos/rope_sin (B, W, hd) f32 or null. pk/pv (P, ps, Hkv*hd), updated
// in place. page_tables (B, maxp) int32. out (B, W, H, hd) f32. chunk:
// positions a block (splits = ceil(maxp * ps / chunk)), at most 1024;
// ws_acc f32 (B, Hkv, splits, g*W, hd), ws_ml f32 (B, Hkv, splits, g*W, 2)
// and counters int32 (B, Hkv), zeros, left zero by every launch. hd in
// {32, 64, 128}, H / Hkv <= 8, W <= 8. Each returns cudaGetLastError().

// K6: decode over a bf16 (cache_bf16) or f32 pool; lengths (B,) int32, tokens
// per slot including the current one (0: inactive). W must be 1.
extern "C" int slt_paged_decode_attn(
    const void* q, const void* k_new, const void* v_new, int q_bs, int q_hs,
    int q_ws, int kv_bs, int kv_hs, int kv_ws, int in_bf16,
    const void* rope_cos, const void* rope_sin, void* pk, void* pv,
    int cache_bf16, const void* page_tables, const void* lengths, void* out,
    void* ws_acc, void* ws_ml, void* counters, int B, int W, int ps, int maxp,
    int Hkv, int g, int hd, int window, float scale, int chunk, void* stream) {
  if (W != 1) return (int)cudaErrorInvalidValue;
  return launch(make_args(q, k_new, v_new, q_bs, q_hs, q_ws, kv_bs, kv_hs,
                          kv_ws, rope_cos, rope_sin, pk, pv, nullptr, nullptr,
                          page_tables, lengths, 1, out, ws_acc, ws_ml,
                          counters, B, W, ps, maxp, Hkv, g, hd, window, scale,
                          chunk, stream),
                in_bf16, cache_bf16 ? 1 : 0);
}

// K7: decode over int8 pools with row scales sk/sv (P, Hkv, ps) f32.
extern "C" int slt_paged_decode_attn_q8(
    const void* q, const void* k_new, const void* v_new, int q_bs, int q_hs,
    int q_ws, int kv_bs, int kv_hs, int kv_ws, int in_bf16,
    const void* rope_cos, const void* rope_sin, void* pk, void* pv, void* sk,
    void* sv, const void* page_tables, const void* lengths, void* out,
    void* ws_acc, void* ws_ml, void* counters, int B, int W, int ps, int maxp,
    int Hkv, int g, int hd, int window, float scale, int chunk, void* stream) {
  if (W != 1) return (int)cudaErrorInvalidValue;
  return launch(make_args(q, k_new, v_new, q_bs, q_hs, q_ws, kv_bs, kv_hs,
                          kv_ws, rope_cos, rope_sin, pk, pv, sk, sv,
                          page_tables, lengths, 1, out, ws_acc, ws_ml,
                          counters, B, W, ps, maxp, Hkv, g, hd, window, scale,
                          chunk, stream),
                in_bf16, 2);
}

// K8: a W-token verify window per slot over a bf16 or f32 pool; starts (B,)
// int32, the position of each slot's first window token (< 0: inactive).
extern "C" int slt_paged_verify_attn(
    const void* q, const void* k_new, const void* v_new, int q_bs, int q_hs,
    int q_ws, int kv_bs, int kv_hs, int kv_ws, int in_bf16,
    const void* rope_cos, const void* rope_sin, void* pk, void* pv,
    int cache_bf16, const void* page_tables, const void* starts, void* out,
    void* ws_acc, void* ws_ml, void* counters, int B, int W, int ps, int maxp,
    int Hkv, int g, int hd, int window, float scale, int chunk, void* stream) {
  return launch(make_args(q, k_new, v_new, q_bs, q_hs, q_ws, kv_bs, kv_hs,
                          kv_ws, rope_cos, rope_sin, pk, pv, nullptr, nullptr,
                          page_tables, starts, 0, out, ws_acc, ws_ml,
                          counters, B, W, ps, maxp, Hkv, g, hd, window, scale,
                          chunk, stream),
                in_bf16, cache_bf16 ? 1 : 0);
}

// K9: the verify window over int8 pools with row scales.
extern "C" int slt_paged_verify_attn_q8(
    const void* q, const void* k_new, const void* v_new, int q_bs, int q_hs,
    int q_ws, int kv_bs, int kv_hs, int kv_ws, int in_bf16,
    const void* rope_cos, const void* rope_sin, void* pk, void* pv, void* sk,
    void* sv, const void* page_tables, const void* starts, void* out,
    void* ws_acc, void* ws_ml, void* counters, int B, int W, int ps, int maxp,
    int Hkv, int g, int hd, int window, float scale, int chunk, void* stream) {
  return launch(make_args(q, k_new, v_new, q_bs, q_hs, q_ws, kv_bs, kv_hs,
                          kv_ws, rope_cos, rope_sin, pk, pv, sk, sv,
                          page_tables, starts, 0, out, ws_acc, ws_ml,
                          counters, B, W, ps, maxp, Hkv, g, hd, window, scale,
                          chunk, stream),
                in_bf16, 2);
}
