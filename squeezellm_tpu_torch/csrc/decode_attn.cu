// K2 and K5: dense decode attention with rope and the cache write fused in,
// over an f32/bf16 cache (K2) or an int8 cache with f32 row scales (K5).
//
// For each slot b and kv head: rope q and the new k from the exact cos/sin
// rows, write the new k/v at cache row n-1 (n = min(len, S)), then online
// softmax over rows [max(n - window, 0), n) for the kv head's g query heads;
// a slot with n == 0 writes nothing and outputs zeros.
//
// Replaces the TPU kernels `_dense_attn_kernel` (K2, launched by
// `dense_decode_attention`) and `_dense_attn_kernel_q8` (K5, launched by
// `dense_decode_attention_q8`) of squeezellm_tpu/ops/decode_attn.py.
//
// Bound on the H100: bytes. One step reads the valid prefix of k and v
// (2 * n * Hkv * hd * 2 B in bf16: 1 MB a layer at n = 128 for LLaMA-2-7B,
// 16 MB at n = 2048) and does ~4 flops per byte. Design (split-K, "flash
// decoding"):
//  * the grid is (kv head, slot, split): a block owns one kv head's g query
//    heads over a fixed chunk of `chunk` cache rows (256), so a slot's
//    prefix is read by ceil(n / chunk) blocks at once (at batch 1 and 2048
//    rows, 8 blocks a kv head, 256 in all, not 32); blocks whose chunk
//    holds no row of [max(n - window, 0), n) exit at once. The split
//    count ceil(S / chunk) follows the cache's capacity alone, and a
//    chunk's rows do not depend on the batch, so a slot's bits do not
//    depend on its cohort;
//  * only the block whose chunk holds row n - 1 writes the new k/v row, and
//    it is the only block that reads that row's head slice, so no block
//    depends on another block's write (no ordering exists between blocks);
//    the row is written first and read back from the cache after a
//    __syncthreads, so the current token enters attention rounded to the
//    cache dtype, exactly as the TPU kernel's write-then-read does;
//  * rope uses the caller's cos/sin rows (the model's rope_cos_sin values;
//    rope recomputed from theta inside a kernel drifted on the TPU), with
//    the multiply and add rounded separately as the plain version does;
//  * 8 warps split the chunk's rows; a lane holds hd/32 ADJACENT elements
//    of a row (one 8-byte load a lane for bf16 at hd 128), and a warp
//    loads 8 rows of k and v, kept raw, before it uses the first, so 16
//    loads a lane are in flight; the heads' registers and shared memory are
//    sized for one head where g = 1 (74 registers at hd 128, so several
//    blocks share an SM), for kMaxG heads otherwise (two instantiations a
//    head dim and dtype pair, not one per g); the 8 warps' online softmax
//    states are merged in a fixed order;
//  * a slot whose rows lie in one chunk writes its output directly; else
//    each block stores (m, l, acc[g][hd]) in a workspace and the LAST of
//    the slot's blocks to arrive (an atomic counter picks it and is reset
//    by it; no value is summed by an atomic) merges the partials in split
//    order. Same inputs, same bits, every launch; still one launch a call.
// K5 is the same kernel over int8 codes (half the bytes of bf16 plus 4 B of
// scale per row and head: 2 * n * Hkv * (hd + 4) B a step):
//  * the new roped k row and the v row are quantized in the kernel, one
//    warp each: scale = max(max|row| * f32(1/127), 1e-12), code =
//    clip(rint(x / scale), -127, 127) with a true f32 divide, so the codes
//    and scales are bit-identical to `kv_quant.quantize_rows`; the scales
//    are stored (B, Hkv, S), a head's scales contiguous along the tokens;
//  * the current token is read back as written (code times scale), like
//    every other row;
//  * the k scale multiplies the logit after the dot product of q with the
//    raw codes, the v scale multiplies p before p.v, as the TPU kernel does.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;     // query heads per kv head
constexpr int kUnroll = 8;   // rows a warp loads before it uses them

// G: 1 when a kv head has one query head (every multi-head config), else
// kMaxG (g <= G); it sizes the registers and shared memory the heads take.
template <typename TIN, typename TC, int D, int G>
__global__ void __launch_bounds__(kThreads)
    decode_attn_kernel(const TIN* __restrict__ q, const TIN* __restrict__ kn,
                       const TIN* __restrict__ vn, int q_bstride,
                       int kv_bstride, const float* __restrict__ rope_cos,
                       const float* __restrict__ rope_sin, TC* ck, TC* cv,
                       float* sk, float* sv,
                       const int* __restrict__ lengths,
                       float* __restrict__ out, float* ws_acc, float* ws_ml,
                       int* counters, int S, int Hkv, int g, int window,
                       float scale, int chunk) {
  constexpr int hd = D * 32;
  constexpr bool kQ8 = sizeof(TC) == 1;  // int8 codes + row scales
  using RawT = typename slt::Raw<TC, D>::T;
  __shared__ __align__(16) float q_s[G][hd];
  __shared__ float kv_s[2][hd];
  __shared__ float red_m[kWarps][G];
  __shared__ float red_l[kWarps][G];
  __shared__ float red_acc[kWarps][G][hd];
  __shared__ int last;

  const int kvh = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = min(lengths[b], S);
  const int lo = max(n - window, 0);
  float* outb = out + ((size_t)b * Hkv * g + (size_t)kvh * g) * hd;
  if (n <= 0) {  // nothing to write or read: zeros, from the first split
    if (sp == 0)
      for (int t = threadIdx.x; t < g * hd; t += kThreads) outb[t] = 0.f;
    return;
  }
  const int s_lo = lo / chunk, s_hi = (n - 1) / chunk;
  if (sp < s_lo || sp > s_hi) return;  // no row of this chunk is attended
  const int r_lo = max(lo, sp * chunk), r_hi = min(n, (sp + 1) * chunk);
  const bool writer = sp == s_hi;  // its chunk holds row n - 1

  // stage this kv head's g query rows and the new k/v row as f32
  const TIN* qb = q + (size_t)b * q_bstride + (size_t)kvh * g * hd;
  const TIN* kb = kn + (size_t)b * kv_bstride + (size_t)kvh * hd;
  const TIN* vb = vn + (size_t)b * kv_bstride + (size_t)kvh * hd;
  for (int t = threadIdx.x; t < g * hd; t += kThreads)
    q_s[t / hd][t % hd] = slt::to_f32(qb[t]);
  if (writer)
    for (int t = threadIdx.x; t < hd; t += kThreads) {
      kv_s[0][t] = slt::to_f32(kb[t]);
      kv_s[1][t] = slt::to_f32(vb[t]);
    }
  __syncthreads();

  if (rope_cos != nullptr) {
    // rows 0..g-1 are q, row g is the new k: x * cos + rotate_half(x) * sin
    const float* cb = rope_cos + (size_t)b * hd;
    const float* sb = rope_sin + (size_t)b * hd;
    constexpr int kPer = ((G + 1) * hd + kThreads - 1) / kThreads;
    float tmp[kPer];
    const int total = (g + (writer ? 1 : 0)) * hd;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int t = threadIdx.x + c * kThreads;
      if (t < total) {
        const int r = t / hd, d = t % hd;
        const float* row = r < g ? q_s[r] : kv_s[0];
        const float rot = d < hd / 2 ? -row[d + hd / 2] : row[d - hd / 2];
        tmp[c] = __fadd_rn(__fmul_rn(row[d], cb[d]), __fmul_rn(rot, sb[d]));
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int t = threadIdx.x + c * kThreads;
      if (t < total) {
        const int r = t / hd, d = t % hd;
        (r < g ? q_s[r] : kv_s[0])[d] = tmp[c];
      }
    }
    __syncthreads();
  }

  const size_t row_stride = (size_t)Hkv * hd;
  const size_t head_base = (size_t)b * S * row_stride + (size_t)kvh * hd;
  // this head's row scales (K5 only): (B, Hkv, S)
  const size_t scale_base = ((size_t)b * Hkv + kvh) * S;
  if (writer) {
    const size_t off = head_base + (size_t)(n - 1) * row_stride;
    if constexpr (kQ8) {
      // warp 0 quantizes the k row, warp 1 the v row
      if (warp < 2) {
        const float* row = kv_s[warp];
        float amax = 0.f;
#pragma unroll
        for (int e = 0; e < D; ++e)
          amax = fmaxf(amax, fabsf(row[lane + 32 * e]));
        amax = slt::warp_max(amax);
        const float s = fmaxf(__fmul_rn(amax, 1.0f / 127.0f), 1e-12f);
        TC* dst = (warp == 0 ? ck : cv) + off;
#pragma unroll
        for (int e = 0; e < D; ++e) {
          const float r = rintf(__fdiv_rn(row[lane + 32 * e], s));
          dst[lane + 32 * e] = (TC)fminf(fmaxf(r, -127.f), 127.f);
        }
        if (lane == 0) (warp == 0 ? sk : sv)[scale_base + n - 1] = s;
      }
    } else {
      for (int t = threadIdx.x; t < hd; t += kThreads) {
        slt::store_f32(kv_s[0][t], ck + off + t);
        slt::store_f32(kv_s[1][t], cv + off + t);
      }
    }
    __syncthreads();  // the block's cache writes are visible to its reads
  }

  float qr[G][D], acc[G][D], m[G], l[G];
#pragma unroll
  for (int u = 0; u < G; ++u) {
    m[u] = -CUDART_INF_F;
    l[u] = 0.f;
#pragma unroll
    for (int e = 0; e < D; ++e) {
      qr[u][e] = u < g ? q_s[u][lane * D + e] : 0.f;
      acc[u][e] = 0.f;
    }
  }

  for (int t0 = r_lo + warp * kUnroll; t0 < r_hi; t0 += kWarps * kUnroll) {
    RawT kr[kUnroll], vr[kUnroll];
    float ksc[kUnroll], vsc[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int t = min(t0 + j, r_hi - 1);  // rows past r_hi are not used
      const size_t off = head_base + (size_t)t * row_stride + lane * D;
      kr[j] = *reinterpret_cast<const RawT*>(ck + off);
      vr[j] = *reinterpret_cast<const RawT*>(cv + off);
      ksc[j] = scale;
      vsc[j] = 1.f;
      if constexpr (kQ8) {
        ksc[j] = sk[scale_base + t] * scale;
        vsc[j] = sv[scale_base + t];
      }
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      if (u < g) {
        float s[kUnroll];
        float mx = m[u];
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < D; ++e)
            d = fmaf(qr[u][e], slt::raw_at<TC, D>(kr[j], e), d);
          s[j] = slt::warp_sum(d) * ksc[j];
          if (t0 + j < r_hi) mx = fmaxf(mx, s[j]);
        }
        const float alpha = expf(m[u] - mx);
        float lsum = l[u] * alpha;
#pragma unroll
        for (int e = 0; e < D; ++e) acc[u][e] *= alpha;
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          if (t0 + j < r_hi) {
            const float p = expf(s[j] - mx);
            lsum += p;
            const float pv = kQ8 ? p * vsc[j] : p;
#pragma unroll
            for (int e = 0; e < D; ++e)
              acc[u][e] =
                  fmaf(pv, slt::raw_at<TC, D>(vr[j], e), acc[u][e]);
          }
        }
        l[u] = lsum;
        m[u] = mx;
      }
    }
  }

#pragma unroll
  for (int u = 0; u < G; ++u) {
    if (u < g) {
      if (lane == 0) {
        red_m[warp][u] = m[u];
        red_l[warp][u] = l[u];
      }
#pragma unroll
      for (int e = 0; e < D; ++e) red_acc[warp][u][lane * D + e] = acc[u][e];
    }
  }
  __syncthreads();
  // the block's state: the warps' merged in a fixed order
  const int nsplit = s_hi - s_lo + 1;
  const size_t part = ((size_t)b * Hkv + kvh) * gridDim.z;  // split 0's
  for (int t = threadIdx.x; t < g * hd; t += kThreads) {
    const int u = t / hd, d = t % hd;
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w][u]);
    float L = 0.f, O = 0.f;
    if (mx != -CUDART_INF_F) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(red_m[w][u] - mx);
        L += red_l[w][u] * f;
        O += red_acc[w][u][d] * f;
      }
    }
    if (nsplit == 1) {
      outb[t] = mx != -CUDART_INF_F ? O / fmaxf(L, 1e-30f) : 0.f;
    } else {
      ws_acc[(part + sp) * g * hd + t] = O;
      if (d == 0) {
        ws_ml[((part + sp) * g + u) * 2] = mx;
        ws_ml[((part + sp) * g + u) * 2 + 1] = L;
      }
    }
  }
  if (nsplit == 1) return;

  // the last of the slot's blocks to arrive merges the partials in split
  // order and resets the counter for the next launch
  __threadfence();
  __syncthreads();
  int* cnt = counters + (size_t)b * Hkv + kvh;
  if (threadIdx.x == 0) last = atomicAdd(cnt, 1) == nsplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int t = threadIdx.x; t < g * hd; t += kThreads) {
    const int u = t / hd;
    float mx = -CUDART_INF_F;
    for (int k = s_lo; k <= s_hi; ++k)
      mx = fmaxf(mx, __ldcg(ws_ml + ((part + k) * g + u) * 2));
    float L = 0.f, O = 0.f;
    if (mx != -CUDART_INF_F) {
      for (int k = s_lo; k <= s_hi; ++k) {
        const float f = expf(__ldcg(ws_ml + ((part + k) * g + u) * 2) - mx);
        L += __ldcg(ws_ml + ((part + k) * g + u) * 2 + 1) * f;
        O += __ldcg(ws_acc + (part + k) * g * hd + t) * f;
      }
    }
    outb[t] = mx != -CUDART_INF_F ? O / fmaxf(L, 1e-30f) : 0.f;
  }
  if (threadIdx.x == 0) *cnt = 0;
}

template <typename TIN, typename TC>
void launch_t(int D, dim3 grid, cudaStream_t s, const void* q, const void* kn,
              const void* vn, int q_bstride, int kv_bstride,
              const float* rc, const float* rs, void* ck, void* cv,
              float* sk, float* sv, const int* lengths, float* out,
              float* ws_acc, float* ws_ml, int* counters, int S, int Hkv,
              int g, int window, float scale, int chunk) {
  const int G = g == 1 ? 1 : kMaxG;
#define SLT_DA_CASE(D_, G_)                                                 \
  if (D == D_ && G == G_)                                                   \
    decode_attn_kernel<TIN, TC, D_, G_><<<grid, kThreads, 0, s>>>(          \
        static_cast<const TIN*>(q), static_cast<const TIN*>(kn),            \
        static_cast<const TIN*>(vn), q_bstride, kv_bstride, rc, rs,         \
        static_cast<TC*>(ck), static_cast<TC*>(cv), sk, sv, lengths, out,   \
        ws_acc, ws_ml, counters, S, Hkv, g, window, scale, chunk);
#define SLT_DA_G(D_) SLT_DA_CASE(D_, 1) SLT_DA_CASE(D_, kMaxG)
  SLT_DA_G(1)
  SLT_DA_G(2)
  SLT_DA_G(4)
#undef SLT_DA_G
#undef SLT_DA_CASE
}

}  // namespace

// q (B, H, hd), k_new/v_new (B, Hkv, hd): rows contiguous, batch strides
// given; in_bf16 selects bf16 or f32 for all three. rope_cos/rope_sin
// (B, hd) f32 or null. ck/cv (B, S, Hkv*hd) bf16 (cache_bf16) or f32,
// updated in place. lengths (B,) int32. out (B, H, hd) f32. chunk: cache
// rows a block (splits = ceil(S / chunk)); ws_acc f32 (B, Hkv, splits, g,
// hd), ws_ml f32 (B, Hkv, splits, g, 2) and counters int32 (B, Hkv),
// zeros, left zero by every launch. hd in {32, 64, 128}, H / Hkv <= 8.
// Returns cudaGetLastError().
extern "C" int slt_decode_attn(const void* q, const void* k_new,
                               const void* v_new, int q_bstride,
                               int kv_bstride, int in_bf16,
                               const void* rope_cos, const void* rope_sin,
                               void* ck, void* cv, int cache_bf16,
                               const void* lengths, void* out, void* ws_acc,
                               void* ws_ml, void* counters, int B, int S,
                               int Hkv, int g, int hd, int window,
                               float scale, int chunk, void* stream) {
  if (B <= 0 || Hkv <= 0 || S <= 0) return (int)cudaSuccess;
  if (g < 1 || g > kMaxG || (hd != 32 && hd != 64 && hd != 128) ||
      chunk < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Hkv, B, (S + chunk - 1) / chunk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = hd / 32;
  const auto* rc = static_cast<const float*>(rope_cos);
  const auto* rs = static_cast<const float*>(rope_sin);
  const auto* len = static_cast<const int*>(lengths);
  auto* o = static_cast<float*>(out);
  auto* wa = static_cast<float*>(ws_acc);
  auto* wm = static_cast<float*>(ws_ml);
  auto* cnt = static_cast<int*>(counters);
  if (in_bf16 && cache_bf16)
    launch_t<__nv_bfloat16, __nv_bfloat16>(
        D, grid, s, q, k_new, v_new, q_bstride, kv_bstride, rc, rs, ck, cv,
        nullptr, nullptr, len, o, wa, wm, cnt, S, Hkv, g, window, scale,
        chunk);
  else if (in_bf16)
    launch_t<__nv_bfloat16, float>(D, grid, s, q, k_new, v_new, q_bstride,
                                   kv_bstride, rc, rs, ck, cv, nullptr,
                                   nullptr, len, o, wa, wm, cnt, S, Hkv, g,
                                   window, scale, chunk);
  else if (cache_bf16)
    launch_t<float, __nv_bfloat16>(D, grid, s, q, k_new, v_new, q_bstride,
                                   kv_bstride, rc, rs, ck, cv, nullptr,
                                   nullptr, len, o, wa, wm, cnt, S, Hkv, g,
                                   window, scale, chunk);
  else
    launch_t<float, float>(D, grid, s, q, k_new, v_new, q_bstride,
                           kv_bstride, rc, rs, ck, cv, nullptr, nullptr, len,
                           o, wa, wm, cnt, S, Hkv, g, window, scale, chunk);
  return (int)cudaGetLastError();
}

// K5: the same over int8 caches. ck/cv (B, S, Hkv*hd) int8 and sk/sv
// (B, Hkv, S) f32 row scales, all updated in place; the other arguments as
// slt_decode_attn's.
extern "C" int slt_decode_attn_q8(const void* q, const void* k_new,
                                  const void* v_new, int q_bstride,
                                  int kv_bstride, int in_bf16,
                                  const void* rope_cos, const void* rope_sin,
                                  void* ck, void* cv, void* sk, void* sv,
                                  const void* lengths, void* out,
                                  void* ws_acc, void* ws_ml, void* counters,
                                  int B, int S, int Hkv, int g, int hd,
                                  int window, float scale, int chunk,
                                  void* stream) {
  if (B <= 0 || Hkv <= 0 || S <= 0) return (int)cudaSuccess;
  if (g < 1 || g > kMaxG || (hd != 32 && hd != 64 && hd != 128) ||
      chunk < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Hkv, B, (S + chunk - 1) / chunk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = hd / 32;
  const auto* rc = static_cast<const float*>(rope_cos);
  const auto* rs = static_cast<const float*>(rope_sin);
  const auto* len = static_cast<const int*>(lengths);
  auto* o = static_cast<float*>(out);
  auto* ks = static_cast<float*>(sk);
  auto* vs = static_cast<float*>(sv);
  auto* wa = static_cast<float*>(ws_acc);
  auto* wm = static_cast<float*>(ws_ml);
  auto* cnt = static_cast<int*>(counters);
  if (in_bf16)
    launch_t<__nv_bfloat16, int8_t>(D, grid, s, q, k_new, v_new, q_bstride,
                                    kv_bstride, rc, rs, ck, cv, ks, vs, len,
                                    o, wa, wm, cnt, S, Hkv, g, window, scale,
                                    chunk);
  else
    launch_t<float, int8_t>(D, grid, s, q, k_new, v_new, q_bstride,
                            kv_bstride, rc, rs, ck, cv, ks, vs, len, o, wa,
                            wm, cnt, S, Hkv, g, window, scale, chunk);
  return (int)cudaGetLastError();
}
