// K3: causal flash attention for a prefill window.
//
// Query row i of head h sits at position offset + i and attends keys
// kpos <= qpos and kpos > qpos - window of kv head h / g, with an online
// softmax; only rows < min(offset + Sq, Sk) of k/v are read. q, k, v and
// out are addressed through strides, so k/v may be head-major views of the
// token-major cache and out may be a token-major buffer.
//
// Replaces the TPU kernel `_flash_kernel` (squeezellm_tpu/ops/flash_attn.py,
// launched by `flash_attention`).
//
// Bound on the H100: the bytes of q, k, v and out (Sq*hd per head for
// q/out, the valid k/v prefix per kv head) at short prompts; the products
// (2*Sq*Sk*hd/2 flops a head under the causal mask for each of q.k^T,
// bf16 x bf16 at 989 TFLOP/s on the tensor cores, and p.v, p in f32 at 67
// TFLOP/s) overtake them near Sq ~ 200. This kernel does both products as
// f32 FMAs on the CUDA cores. Design, simple first:
//  * one block per (16 query rows, head, slot), 8 warps with 2 rows each;
//  * k/v tiles of 4096 floats each (32 keys at hd = 128) are staged in
//    shared memory as f32 and shared by the block's 16 rows; the k tile is
//    padded by one column so lane j reading key j is conflict-free;
//  * a lane computes one key's logit per tile column for both of its
//    warp's rows, the warp keeps (m, l) per row and each lane hd/32 output
//    elements; masked keys (ragged edge, causal, window) get p = 0.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 2;                // query rows per warp
constexpr int kBQ = kWarps * kRows;     // query rows per block
constexpr int kTileFloats = 4096;       // k (and v) tile size in floats

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attn_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                      const TKV* __restrict__ v, float* __restrict__ out,
                      int qs_b, int qs_h, int qs_s, int ks_b, int ks_h,
                      int ks_s, int os_b, int os_h, int os_s, int g, int Sq,
                      int Sk, int offset, int window, float scale) {
  constexpr int hd = D * 32;
  constexpr int KC = kTileFloats / hd;  // keys per tile
  constexpr int KPL = KC / 32;          // keys per lane
  __shared__ float q_s[kBQ][hd];
  __shared__ float k_s[KC][hd + 1];
  __shared__ float v_s[KC][hd];
  __shared__ float p_s[kWarps][kRows][KC];

  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / g;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q_first = blockIdx.x * kBQ;
  const int q_last = min(q_first + kBQ, Sq) - 1;

  for (int t = threadIdx.x; t < kBQ * hd; t += kThreads) {
    const int r = t / hd, d = t % hd;
    const int qi = q_first + r;
    q_s[r][d] = qi < Sq ? slt::to_f32(q[(size_t)b * qs_b + (size_t)h * qs_h +
                                        (size_t)qi * qs_s + d])
                        : 0.f;
  }

  const int kv_lo = max(offset + q_first - window + 1, 0);
  const int kv_hi = min(offset + q_last + 1, Sk);
  const size_t kv_base = (size_t)b * ks_b + (size_t)kh * ks_h;

  float m[kRows], l[kRows], acc[kRows][D];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < D; ++e) acc[r][e] = 0.f;
  }

  for (int c = kv_lo; c < kv_hi; c += KC) {
    __syncthreads();  // the previous tile is consumed (q_s staged)
    for (int t = threadIdx.x; t < KC * hd; t += kThreads) {
      const int j = t / hd, d = t % hd;
      const int kp = c + j;
      float kx = 0.f, vx = 0.f;
      if (kp < kv_hi) {
        const size_t off = kv_base + (size_t)kp * ks_s + d;
        kx = slt::to_f32(k[off]);
        vx = slt::to_f32(v[off]);
      }
      k_s[j][d] = kx;
      v_s[j][d] = vx;
    }
    __syncthreads();

    float s[kRows][KPL];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int e = 0; e < KPL; ++e) s[r][e] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qd[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) qd[r] = q_s[warp * kRows + r][d];
#pragma unroll
      for (int e = 0; e < KPL; ++e) {
        const float kd = k_s[lane + 32 * e][d];
#pragma unroll
        for (int r = 0; r < kRows; ++r) s[r][e] = fmaf(qd[r], kd, s[r][e]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q_first + warp * kRows + r;
      const int qpos = offset + qi;
      float cmax = -CUDART_INF_F;
#pragma unroll
      for (int e = 0; e < KPL; ++e) {
        const int kp = c + lane + 32 * e;
        const bool ok = qi < Sq && kp < kv_hi && kp <= qpos &&
                        kp > qpos - window;
        s[r][e] = ok ? s[r][e] * scale : -CUDART_INF_F;
        cmax = fmaxf(cmax, s[r][e]);
      }
      cmax = slt::warp_max(cmax);
      const float mn = fmaxf(m[r], cmax);
      if (mn == -CUDART_INF_F) {
#pragma unroll
        for (int e = 0; e < KPL; ++e) p_s[warp][r][lane + 32 * e] = 0.f;
      } else {
        const float alpha = expf(m[r] - mn);
        float psum = 0.f;
#pragma unroll
        for (int e = 0; e < KPL; ++e) {
          const float p = s[r][e] == -CUDART_INF_F ? 0.f : expf(s[r][e] - mn);
          p_s[warp][r][lane + 32 * e] = p;
          psum += p;
        }
        l[r] = l[r] * alpha + slt::warp_sum(psum);
#pragma unroll
        for (int e = 0; e < D; ++e) acc[r][e] *= alpha;
        m[r] = mn;
      }
    }
    __syncwarp();
    for (int j = 0; j < KC; ++j) {
      float pj[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pj[r] = p_s[warp][r][j];
#pragma unroll
      for (int e = 0; e < D; ++e) {
        const float vd = v_s[j][lane + 32 * e];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][e] = fmaf(pj[r], vd, acc[r][e]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q_first + warp * kRows + r;
    if (qi >= Sq) continue;
    float* o = out + (size_t)b * os_b + (size_t)h * os_h + (size_t)qi * os_s;
#pragma unroll
    for (int e = 0; e < D; ++e)
      o[lane + 32 * e] = l[r] > 0.f ? acc[r][e] / fmaxf(l[r], 1e-30f) : 0.f;
  }
}

template <typename TQ, typename TKV>
void launch_t(int D, dim3 grid, cudaStream_t s, const void* q, const void* k,
              const void* v, float* out, const int* st, int g, int Sq,
              int Sk, int offset, int window, float scale) {
#define SLT_FA_CASE(D_)                                                     \
  case D_:                                                                  \
    flash_attn_kernel<TQ, TKV, D_><<<grid, kThreads, 0, s>>>(               \
        static_cast<const TQ*>(q), static_cast<const TKV*>(k),              \
        static_cast<const TKV*>(v), out, st[0], st[1], st[2], st[3], st[4], \
        st[5], st[6], st[7], st[8], g, Sq, Sk, offset, window, scale);      \
    break;
  switch (D) {
    SLT_FA_CASE(1)
    SLT_FA_CASE(2)
    SLT_FA_CASE(4)
  }
#undef SLT_FA_CASE
}

}  // namespace

// q (B, H, Sq, hd) bf16 (q_bf16) or f32; k/v (B, Hkv, Sk, hd) bf16
// (kv_bf16) or f32, sharing strides; out (B, H, Sq, hd) f32. Strides are
// in elements (batch, head, row); the last dim is contiguous. hd in
// {32, 64, 128}. Returns cudaGetLastError().
extern "C" int slt_flash_attn(const void* q, const void* k, const void* v,
                              void* out, int qs_b, int qs_h, int qs_s,
                              int ks_b, int ks_h, int ks_s, int os_b,
                              int os_h, int os_s, int q_bf16, int kv_bf16,
                              int B, int H, int Hkv, int Sq, int Sk, int hd,
                              int offset, int window, float scale,
                              void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return (int)cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || (hd != 32 && hd != 64 && hd != 128))
    return (int)cudaErrorInvalidValue;
  const int st[9] = {qs_b, qs_h, qs_s, ks_b, ks_h, ks_s, os_b, os_h, os_s};
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = hd / 32, g = H / Hkv;
  auto* o = static_cast<float*>(out);
  if (q_bf16 && kv_bf16)
    launch_t<__nv_bfloat16, __nv_bfloat16>(D, grid, s, q, k, v, o, st, g, Sq,
                                           Sk, offset, window, scale);
  else if (q_bf16)
    launch_t<__nv_bfloat16, float>(D, grid, s, q, k, v, o, st, g, Sq, Sk,
                                   offset, window, scale);
  else if (kv_bf16)
    launch_t<float, __nv_bfloat16>(D, grid, s, q, k, v, o, st, g, Sq, Sk,
                                   offset, window, scale);
  else
    launch_t<float, float>(D, grid, s, q, k, v, o, st, g, Sq, Sk, offset,
                           window, scale);
  return (int)cudaGetLastError();
}
