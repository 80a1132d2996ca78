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
// window). Design:
//  * one block per (kv head, slot) with all g*W query rows of that kv head.
//    The block that writes the new rows' head slice is the only one that
//    reads it, so no block depends on another block's write (no ordering
//    exists between blocks). Prefix pages that several slots share are read
//    by all of them and written by none;
//  * the new rows are written first and read back from the pool after a
//    __syncthreads, so they enter attention rounded to the pool's type
//    (bf16, or code times scale), as every other row;
//  * rope uses the caller's cos/sin rows, the multiply and the add rounded
//    separately as the plain version does;
//  * 8 warps split the key rows; a lane holds hd/32 elements of a row, so a
//    warp reads a row's head slice as contiguous segments, wherever its page
//    lies. The query rows go 8 at a time (registers hold 8 rows' softmax
//    state): decode and LLaMA-2-7B windows take one pass, a GQA window of
//    g*W > 8 rows reads the slot's keys again for every 8 rows. The 8 warps'
//    states are merged in a fixed order;
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
constexpr int kRows = 8;     // query rows per pass
constexpr int kMaxW = 8;     // window tokens
constexpr int kMaxG = 8;     // query heads per kv head
constexpr int kMaxHd = 128;  // head dim

template <typename TIN, typename TC, int D>
__global__ void __launch_bounds__(kThreads)
    paged_attn_kernel(const TIN* __restrict__ q, const TIN* __restrict__ kn,
                      const TIN* __restrict__ vn, int q_bs, int q_hs, int q_ws,
                      int kv_bs, int kv_hs, int kv_ws,
                      const float* __restrict__ rope_cos,
                      const float* __restrict__ rope_sin, TC* pk, TC* pv,
                      float* sk, float* sv,
                      const int* __restrict__ page_tables,
                      const int* __restrict__ index, int index_is_length,
                      float* __restrict__ out, int W, int ps, int maxp,
                      int Hkv, int g, int window, float scale) {
  constexpr int hd = D * 32;
  constexpr bool kQ8 = sizeof(TC) == 1;  // int8 codes + row scales
  __shared__ float q_s[kRows][kMaxHd];
  __shared__ float kv_s[2][kMaxW][kMaxHd];
  __shared__ float red_m[kWarps][kRows];
  __shared__ float red_l[kWarps][kRows];
  __shared__ float red_acc[kWarps][kRows][kMaxHd];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* pt = page_tables + (size_t)b * maxp;
  const int start = index[b] - (index_is_length ? 1 : 0);
  const int cap = maxp * ps;
  const bool active = start >= 0;
  const int n_end = active ? min(start + W, cap) : 0;
  // the earliest position any row of the window attends (its first row's)
  const int lo0 = max(start + 1 - window, 0);
  const size_t row_stride = (size_t)Hkv * hd;
  const int H = Hkv * g;
  const int R = g * W;

  // stage the W new k rows (roped) and v rows of this kv head as f32
  const TIN* kb = kn + (size_t)b * kv_bs + (size_t)kvh * kv_hs;
  const TIN* vb = vn + (size_t)b * kv_bs + (size_t)kvh * kv_hs;
  for (int t = threadIdx.x; t < W * hd; t += kThreads) {
    const int w = t / hd, d = t % hd;
    const TIN* kr = kb + (size_t)w * kv_ws;
    float x = slt::to_f32(kr[d]);
    if (rope_cos != nullptr) {
      const float rot = d < hd / 2 ? -slt::to_f32(kr[d + hd / 2])
                                   : slt::to_f32(kr[d - hd / 2]);
      const size_t ro = ((size_t)b * W + w) * hd + d;
      x = __fadd_rn(__fmul_rn(x, rope_cos[ro]), __fmul_rn(rot, rope_sin[ro]));
    }
    kv_s[0][w][d] = x;
    kv_s[1][w][d] = slt::to_f32(vb[(size_t)w * kv_ws + d]);
  }
  __syncthreads();

  if (active) {
    if constexpr (kQ8) {
      // one warp a row: rows 0..W-1 are k, W..2W-1 are v
      for (int row = warp; row < 2 * W; row += kWarps) {
        const int which = row >= W, w = row - which * W;
        const int pos = start + w;
        if (pos >= cap) continue;
        const int page = pos / ps, off = pos - page * ps;
        const int pid = pt[page];
        const float* src = kv_s[which][w];
        float amax = 0.f;
#pragma unroll
        for (int e = 0; e < D; ++e)
          amax = fmaxf(amax, fabsf(src[lane + 32 * e]));
        amax = slt::warp_max(amax);
        const float s = fmaxf(__fmul_rn(amax, 1.0f / 127.0f), 1e-12f);
        TC* dst = (which ? pv : pk) + ((size_t)pid * ps + off) * row_stride +
                  (size_t)kvh * hd;
#pragma unroll
        for (int e = 0; e < D; ++e) {
          const float r = rintf(__fdiv_rn(src[lane + 32 * e], s));
          dst[lane + 32 * e] = (TC)fminf(fmaxf(r, -127.f), 127.f);
        }
        if (lane == 0)
          (which ? sv : sk)[((size_t)pid * Hkv + kvh) * ps + off] = s;
      }
    } else {
      for (int t = threadIdx.x; t < W * hd; t += kThreads) {
        const int w = t / hd, d = t % hd;
        const int pos = start + w;
        if (pos >= cap) continue;
        const int page = pos / ps, off = pos - page * ps;
        const size_t o = ((size_t)pt[page] * ps + off) * row_stride +
                         (size_t)kvh * hd + d;
        slt::store_f32(kv_s[0][w][d], pk + o);
        slt::store_f32(kv_s[1][w][d], pv + o);
      }
    }
  }
  __syncthreads();  // the block's pool writes are visible to its reads

  const TIN* qb = q + (size_t)b * q_bs + (size_t)kvh * g * q_hs;
  for (int r0 = 0; r0 < R; r0 += kRows) {
    const int nr = min(kRows, R - r0);
    // this pass's query rows, roped: row r is head r / W at offset r % W
    for (int t = threadIdx.x; t < nr * hd; t += kThreads) {
      const int i = t / hd, d = t % hd;
      const int u = (r0 + i) / W, w = (r0 + i) - u * W;
      const TIN* qrow = qb + (size_t)u * q_hs + (size_t)w * q_ws;
      float x = slt::to_f32(qrow[d]);
      if (rope_cos != nullptr) {
        const float rot = d < hd / 2 ? -slt::to_f32(qrow[d + hd / 2])
                                     : slt::to_f32(qrow[d - hd / 2]);
        const size_t ro = ((size_t)b * W + w) * hd + d;
        x = __fadd_rn(__fmul_rn(x, rope_cos[ro]),
                      __fmul_rn(rot, rope_sin[ro]));
      }
      q_s[i][d] = x;
    }
    __syncthreads();

    float qr[kRows][D], acc[kRows][D], m[kRows], l[kRows];
    int qp[kRows];  // each row's own position; -1: no such row
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      m[i] = -CUDART_INF_F;
      l[i] = 0.f;
      qp[i] = i < nr ? start + (r0 + i) % W : -1;
#pragma unroll
      for (int e = 0; e < D; ++e) {
        qr[i][e] = i < nr ? q_s[i][lane + 32 * e] : 0.f;
        acc[i][e] = 0.f;
      }
    }

    for (int t = lo0 + warp; t < n_end; t += kWarps) {
      const int page = t / ps, off = t - page * ps;
      const int pid = pt[page];
      const size_t base = ((size_t)pid * ps + off) * row_stride +
                          (size_t)kvh * hd;
      float kx[D], vx[D];
#pragma unroll
      for (int e = 0; e < D; ++e) {
        kx[e] = slt::to_f32(pk[base + lane + 32 * e]);
        vx[e] = slt::to_f32(pv[base + lane + 32 * e]);
      }
      float k_scale = scale, v_scale = 1.f;
      if constexpr (kQ8) {
        const size_t so = ((size_t)pid * Hkv + kvh) * ps + off;
        k_scale = sk[so] * scale;
        v_scale = sv[so];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (t <= qp[i] && t > qp[i] - window) {
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < D; ++e) s = fmaf(qr[i][e], kx[e], s);
          s = slt::warp_sum(s) * k_scale;
          const float mn = fmaxf(m[i], s);
          const float alpha = expf(m[i] - mn);
          const float p = expf(s - mn);
          l[i] = l[i] * alpha + p;
          const float pv_ = kQ8 ? p * v_scale : p;
#pragma unroll
          for (int e = 0; e < D; ++e)
            acc[i][e] = fmaf(pv_, vx[e], acc[i][e] * alpha);
          m[i] = mn;
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (i < nr) {
        if (lane == 0) {
          red_m[warp][i] = m[i];
          red_l[warp][i] = l[i];
        }
#pragma unroll
        for (int e = 0; e < D; ++e)
          red_acc[warp][i][lane + 32 * e] = acc[i][e];
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < nr * hd; t += kThreads) {
      const int i = t / hd, d = t % hd;
      const int u = (r0 + i) / W, w = (r0 + i) - u * W;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int x = 0; x < kWarps; ++x) mx = fmaxf(mx, red_m[x][i]);
      float res = 0.f;
      if (mx != -CUDART_INF_F) {
        float L = 0.f, O = 0.f;
#pragma unroll
        for (int x = 0; x < kWarps; ++x) {
          const float f = expf(red_m[x][i] - mx);
          L += red_l[x][i] * f;
          O += red_acc[x][i][d] * f;
        }
        res = O / fmaxf(L, 1e-30f);
      }
      // out is token-major: (B, W, H, hd)
      out[(((size_t)b * W + w) * H + (size_t)kvh * g + u) * hd + d] = res;
    }
    __syncthreads();  // q_s and red_* are reused by the next pass
  }
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
  int B, W, ps, maxp, Hkv, g, hd, window;
  float scale;
  cudaStream_t stream;
};

template <typename TIN, typename TC>
void launch_t(const Args& a) {
  const dim3 grid(a.Hkv, a.B);
#define SLT_PA_CASE(D_)                                                      \
  case D_:                                                                   \
    paged_attn_kernel<TIN, TC, D_><<<grid, kThreads, 0, a.stream>>>(         \
        static_cast<const TIN*>(a.q), static_cast<const TIN*>(a.kn),         \
        static_cast<const TIN*>(a.vn), a.q_bs, a.q_hs, a.q_ws, a.kv_bs,      \
        a.kv_hs, a.kv_ws, a.rc, a.rs, static_cast<TC*>(a.pk),                \
        static_cast<TC*>(a.pv), a.sk, a.sv, a.pt, a.index,                   \
        a.index_is_length, a.out, a.W, a.ps, a.maxp, a.Hkv, a.g, a.window,   \
        a.scale);                                                            \
    break;
  switch (a.hd / 32) {
    SLT_PA_CASE(1)
    SLT_PA_CASE(2)
    SLT_PA_CASE(4)
  }
#undef SLT_PA_CASE
}

// cache: 0 f32, 1 bf16, 2 int8 codes with f32 row scales
int launch(const Args& a, int in_bf16, int cache) {
  if (a.B <= 0 || a.Hkv <= 0) return (int)cudaSuccess;
  if (a.g < 1 || a.g > kMaxG || a.W < 1 || a.W > kMaxW || a.ps < 1 ||
      a.maxp < 1 || (a.hd != 32 && a.hd != 64 && a.hd != 128))
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
               int index_is_length, void* out, int B, int W, int ps, int maxp,
               int Hkv, int g, int hd, int window, float scale,
               void* stream) {
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
  a.B = B; a.W = W; a.ps = ps; a.maxp = maxp; a.Hkv = Hkv; a.g = g;
  a.hd = hd; a.window = window; a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// The four entry points share their arguments. q (B, H, W, hd) and
// k_new/v_new (B, Hkv, W, hd) through their batch, head and token strides
// (elements; rows contiguous); in_bf16 selects bf16 or f32 for all three.
// rope_cos/rope_sin (B, W, hd) f32 or null. pk/pv (P, ps, Hkv*hd), updated
// in place. page_tables (B, maxp) int32. out (B, W, H, hd) f32. hd in
// {32, 64, 128}, H / Hkv <= 8, W <= 8. Each returns cudaGetLastError().

// K6: decode over a bf16 (cache_bf16) or f32 pool; lengths (B,) int32, tokens
// per slot including the current one (0: inactive). W must be 1.
extern "C" int slt_paged_decode_attn(
    const void* q, const void* k_new, const void* v_new, int q_bs, int q_hs,
    int q_ws, int kv_bs, int kv_hs, int kv_ws, int in_bf16,
    const void* rope_cos, const void* rope_sin, void* pk, void* pv,
    int cache_bf16, const void* page_tables, const void* lengths, void* out,
    int B, int W, int ps, int maxp, int Hkv, int g, int hd, int window,
    float scale, void* stream) {
  if (W != 1) return (int)cudaErrorInvalidValue;
  return launch(make_args(q, k_new, v_new, q_bs, q_hs, q_ws, kv_bs, kv_hs,
                          kv_ws, rope_cos, rope_sin, pk, pv, nullptr, nullptr,
                          page_tables, lengths, 1, out, B, W, ps, maxp, Hkv,
                          g, hd, window, scale, stream),
                in_bf16, cache_bf16 ? 1 : 0);
}

// K7: decode over int8 pools with row scales sk/sv (P, Hkv, ps) f32.
extern "C" int slt_paged_decode_attn_q8(
    const void* q, const void* k_new, const void* v_new, int q_bs, int q_hs,
    int q_ws, int kv_bs, int kv_hs, int kv_ws, int in_bf16,
    const void* rope_cos, const void* rope_sin, void* pk, void* pv, void* sk,
    void* sv, const void* page_tables, const void* lengths, void* out, int B,
    int W, int ps, int maxp, int Hkv, int g, int hd, int window, float scale,
    void* stream) {
  if (W != 1) return (int)cudaErrorInvalidValue;
  return launch(make_args(q, k_new, v_new, q_bs, q_hs, q_ws, kv_bs, kv_hs,
                          kv_ws, rope_cos, rope_sin, pk, pv, sk, sv,
                          page_tables, lengths, 1, out, B, W, ps, maxp, Hkv,
                          g, hd, window, scale, stream),
                in_bf16, 2);
}

// K8: a W-token verify window per slot over a bf16 or f32 pool; starts (B,)
// int32, the position of each slot's first window token (< 0: inactive).
extern "C" int slt_paged_verify_attn(
    const void* q, const void* k_new, const void* v_new, int q_bs, int q_hs,
    int q_ws, int kv_bs, int kv_hs, int kv_ws, int in_bf16,
    const void* rope_cos, const void* rope_sin, void* pk, void* pv,
    int cache_bf16, const void* page_tables, const void* starts, void* out,
    int B, int W, int ps, int maxp, int Hkv, int g, int hd, int window,
    float scale, void* stream) {
  return launch(make_args(q, k_new, v_new, q_bs, q_hs, q_ws, kv_bs, kv_hs,
                          kv_ws, rope_cos, rope_sin, pk, pv, nullptr, nullptr,
                          page_tables, starts, 0, out, B, W, ps, maxp, Hkv, g,
                          hd, window, scale, stream),
                in_bf16, cache_bf16 ? 1 : 0);
}

// K9: the verify window over int8 pools with row scales.
extern "C" int slt_paged_verify_attn_q8(
    const void* q, const void* k_new, const void* v_new, int q_bs, int q_hs,
    int q_ws, int kv_bs, int kv_hs, int kv_ws, int in_bf16,
    const void* rope_cos, const void* rope_sin, void* pk, void* pv, void* sk,
    void* sv, const void* page_tables, const void* starts, void* out, int B,
    int W, int ps, int maxp, int Hkv, int g, int hd, int window, float scale,
    void* stream) {
  return launch(make_args(q, k_new, v_new, q_bs, q_hs, q_ws, kv_bs, kv_hs,
                          kv_ws, rope_cos, rope_sin, pk, pv, sk, sv,
                          page_tables, starts, 0, out, B, W, ps, maxp, Hkv, g,
                          hd, window, scale, stream),
                in_bf16, 2);
}
