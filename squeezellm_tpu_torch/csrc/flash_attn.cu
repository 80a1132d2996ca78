// K3: causal flash attention for a prefill window.
//
// Query row i of head h sits at position offset + i and attends keys
// kpos <= qpos and kpos > qpos - window of kv head h / g, with an online
// softmax; only rows < min(offset + Sq, Sk) of k/v are read. q, k, v and
// out are addressed through strides, so k/v may be head-major views of the
// token-major cache and out may be a token-major buffer. Each block reads
// the offset from device memory (one int32, as the TPU kernel reads its
// scalar-prefetched offset), and the grid depends on Sq and Sk alone, so
// one launch captured in a CUDA graph serves every position.
//
// Replaces the TPU kernel `_flash_kernel` (squeezellm_tpu/ops/flash_attn.py,
// launched by `flash_attention`).
//
// Bound on the H100: the bytes of q, k, v and out (Sq*hd per head for
// q/out, the valid k/v prefix per kv head) at short prompts; the products
// (2*Sq*Sk*hd/2 flops a head under the causal mask for each of q.k^T and
// p.v) from Sq ~ 200 on. Two kernels, one per regime (the wrapper picks by
// `mode` and the operand types):
//
// flash_attn_mma_kernel, the bf16 regime (mode "bf16", q, k, v all bf16):
// both products on the tensor cores (bf16 x bf16, f32 accumulators, 989
// TFLOP/s), in the FlashAttention-2 form:
//  * one block per (64 query rows, head, slot), 4 warps of 16 rows; the
//    blocks of the last rows (the most keys under the causal mask) start
//    first;
//  * k/v tiles of 64 keys staged in shared memory as bf16 by a 2-stage
//    cp.async ring (rows past the prefix zero-filled), rows padded by 16
//    bytes so that ldmatrix reads them without bank conflicts;
//  * S = Q.K^T by mma.sync m16n8k16 with Q's fragments held in registers
//    for the whole block; the online softmax in registers (row max across
//    the quad of lanes holding a row, in the log2 domain); P rounded to
//    bf16 in registers is the A operand of P.V (the S accumulators are
//    already in its fragment layout), V's B fragments come from ldmatrix
//    .trans; l is summed from the f32 p. Rounding p to bf16 is the one
//    error the plain version (f32 products of the same bf16 inputs) does
//    not make: at most 2**-9 relative a weight;
//  * key tiles start at multiples of 64 from key 0, so a row's result does
//    not depend on which rows share its block (a prefix hit or a chunk
//    boundary moves the block's first row); tiles wholly above the block's
//    diagonal or below its window are never loaded; only tiles that cross
//    the diagonal, the window's edge or the prefix's end are masked element
//    by element (a masked tile adds exact zeros).
//
// flash_attn_kernel, the exact regime (every other mode or operand type):
// both products as f32 FMAs on the CUDA cores. Design, simple first:
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
                      int Sk, const int* __restrict__ offset_p, int window,
                      float scale) {
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
  // the offset's load is issued before q is staged, which hides its latency
  const int offset = *offset_p;

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


// ---------------------------------------------------------------------------
// bf16 regime: tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaRows = 64;   // query rows a block
constexpr int kMmaKeys = 64;   // keys a tile
constexpr int kMmaThreads = 128;  // 4 warps of 16 rows

template <int HD>
struct MmaShape {
  static constexpr int LD = HD + 8;  // bf16 a staged row: 16 bytes of pad
  static constexpr int TILE = kMmaKeys * LD;  // bf16 elements a tile
  // Q, then (K, V) for each of the 2 stages
  static constexpr int SMEM = 5 * TILE * 2;
};

// Stages rows [r0, r0 + 64) of one head (row r at base + r * rs) into a
// 64 x LD tile with 16-byte cp.async copies; rows at or past `rows` are
// zero-filled (nothing is read for them).
template <int HD>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* base,
                                           size_t rs, int r0, int rows) {
  constexpr int CPR = HD / 8;  // 16-byte chunks a row
#pragma unroll
  for (int c = 0; c < kMmaKeys * CPR / kMmaThreads; ++c) {
    const int t = threadIdx.x + c * kMmaThreads;
    const int r = t / CPR, u = t % CPR;
    const bool ok = r0 + r < rows;
    const __nv_bfloat16* src = ok ? base + (size_t)(r0 + r) * rs + u * 8 : base;
    slt::cp_async_part<16>(dst + r * MmaShape<HD>::LD + u * 8, src,
                           ok ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
    flash_attn_mma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          float* __restrict__ out, int qs_b, int qs_h,
                          int qs_s, int ks_b, int ks_h, int ks_s, int os_b,
                          int os_h, int os_s, int g, int Sq, int Sk,
                          const int* __restrict__ offset_p, int window,
                          float scale_log2) {
  using S = MmaShape<HD>;
  constexpr int LD = S::LD, KD = HD / 16, ND = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  auto Ks = [&](int st) { return Qs + (1 + 2 * st) * S::TILE; };
  auto Vs = [&](int st) { return Qs + (2 + 2 * st) * S::TILE; };

  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / g;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  // the last row tile first: under the causal mask it has the most keys
  const int q_first = (gridDim.x - 1 - blockIdx.x) * kMmaRows;
  const int q_last = min(q_first + kMmaRows, Sq) - 1;
  // Q's copies are issued first: they do not need the offset, so its
  // load's latency overlaps theirs
  stage_tile<HD>(Qs, q + (size_t)b * qs_b + (size_t)h * qs_h, qs_s, q_first,
                 Sq);
  const int offset = *offset_p;
  // tiles start at multiples of kMmaKeys from key 0, whatever the block's
  // first row: a row meets the same tiles, summed in the same order, in
  // every cohort (the keys of the first tile below the window are masked)
  const int kv_lo =
      max(offset + q_first - window + 1, 0) / kMmaKeys * kMmaKeys;
  const int kv_hi = min(offset + q_last + 1, Sk);
  const int nt = kv_hi > kv_lo ? (kv_hi - kv_lo + kMmaKeys - 1) / kMmaKeys
                               : 0;
  const __nv_bfloat16* kb = k + (size_t)b * ks_b + (size_t)kh * ks_h;
  const __nv_bfloat16* vb = v + (size_t)b * ks_b + (size_t)kh * ks_h;

  if (nt > 0) {
    stage_tile<HD>(Ks(0), kb, ks_s, kv_lo, kv_hi);
    stage_tile<HD>(Vs(0), vb, ks_s, kv_lo, kv_hi);
  }
  slt::cp_async_commit();
  slt::cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[KD][4];  // the warp's 16 rows of Q, all of hd, as A fragments
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    slt::ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                                 (lane >> 4) * 8);

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // rows gr and gr + 8 of the warp: running max (log2 domain) and this
  // lane's part of the running sum
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  const int qi0 = q_first + warp * 16 + gr;

  for (int t = 0; t < nt; ++t) {
    const int c0 = kv_lo + t * kMmaKeys;
    if (t + 1 < nt) {
      stage_tile<HD>(Ks((t + 1) & 1), kb, ks_s, c0 + kMmaKeys, kv_hi);
      stage_tile<HD>(Vs((t + 1) & 1), vb, ks_s, c0 + kMmaKeys, kv_hi);
    }
    slt::cp_async_commit();
    slt::cp_async_wait<1>();
    __syncthreads();  // tile t landed for every warp
    const __nv_bfloat16* K = Ks(t & 1);
    const __nv_bfloat16* V = Vs(t & 1);

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t bf[4];
        slt::ldmatrix_x4(bf, K + (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                     LD +
                                 kk * 16 + ((lane >> 3) & 1) * 8);
        slt::mma_bf16(s[2 * nj], qf[kk], bf[0], bf[1]);
        slt::mma_bf16(s[2 * nj + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // scale into the log2 domain; mask where the tile crosses the block's
    // diagonal, the window's edge or the prefix's end
    const bool edge = c0 + kMmaKeys > offset + q_first ||
                      c0 + kMmaKeys > kv_hi ||
                      c0 <= offset + q_last - window;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int kp = c0 + n * 8 + 2 * tq + (e & 1);
          const int qi = qi0 + (e >> 1) * 8;
          const int qpos = offset + qi;
          const bool ok = qi < Sq && kp < kv_hi && kp <= qpos &&
                          kp > qpos - window;
          x = ok ? x : -CUDART_INF_F;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float base[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], mx[r]);
      base[r] = mn == -CUDART_INF_F ? 0.f : mn;  // a row with no key yet
      alpha[r] = exp2f(m[r] - base[r]);
      m[r] = mn;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    uint32_t pa[4][4];  // P as the A fragments of 4 k-steps of 16 keys
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - base[e >> 1]);
        l[e >> 1] += s[n][e];
      }
      pa[n >> 1][(n & 1) * 2] = slt::pack_bf16(s[n][0], s[n][1]);
      pa[n >> 1][(n & 1) * 2 + 1] = slt::pack_bf16(s[n][2], s[n][3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int dn = 0; dn < HD / 16; ++dn) {
        uint32_t bf[4];
        slt::ldmatrix_x4_trans(
            bf, V + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                    dn * 16 + (lane >> 4) * 8);
        slt::mma_bf16(o[2 * dn], pa[j], bf[0], bf[1]);
        slt::mma_bf16(o[2 * dn + 1], pa[j], bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage's tiles
  }
  slt::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = qi0 + r * 8;
    if (qi >= Sq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    float* orow = out + (size_t)b * os_b + (size_t)h * os_h +
                  (size_t)qi * os_s + 2 * tq;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(orow + n * 8) =
          make_float2(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

template <int HD>
cudaError_t launch_mma(dim3 grid, cudaStream_t s, const void* q,
                       const void* k, const void* v, float* out,
                       const int* st, int g, int Sq, int Sk,
                       const int* offset, int window, float scale) {
  constexpr int smem = MmaShape<HD>::SMEM;
  static bool done = false;
  const cudaError_t e =
      slt::allow_smem(flash_attn_mma_kernel<HD>, smem, done);
  if (e != cudaSuccess) return e;
  flash_attn_mma_kernel<HD><<<grid, kMmaThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), out, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], g, Sq, Sk, offset, window,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
void launch_t(int D, dim3 grid, cudaStream_t s, const void* q, const void* k,
              const void* v, float* out, const int* st, int g, int Sq,
              int Sk, const int* offset, int window, float scale) {
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
// {32, 64, 128}. tensor_cores: the bf16 regime's kernel (q and k/v bf16,
// pointers 16-byte aligned, row strides multiples of 8), else the exact
// regime's. offset: one int32 in device memory, the position of query row
// 0 (>= 0). Returns cudaGetLastError().
extern "C" int slt_flash_attn(const void* q, const void* k, const void* v,
                              void* out, int qs_b, int qs_h, int qs_s,
                              int ks_b, int ks_h, int ks_s, int os_b,
                              int os_h, int os_s, int q_bf16, int kv_bf16,
                              int tensor_cores, int B, int H, int Hkv,
                              int Sq, int Sk, int hd, const int* offset,
                              int window, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return (int)cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || (hd != 32 && hd != 64 && hd != 128))
    return (int)cudaErrorInvalidValue;
  const int st[9] = {qs_b, qs_h, qs_s, ks_b, ks_h, ks_s, os_b, os_h, os_s};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = hd / 32, g = H / Hkv;
  auto* o = static_cast<float*>(out);
  if (tensor_cores) {
    if (!q_bf16 || !kv_bf16 || os_s % 2 || os_h % 2 || os_b % 2)
      return (int)cudaErrorInvalidValue;
    const dim3 grid((Sq + kMmaRows - 1) / kMmaRows, H, B);
    cudaError_t e = cudaErrorInvalidValue;
    switch (hd) {
      case 32: e = launch_mma<32>(grid, s, q, k, v, o, st, g, Sq, Sk, offset,
                                  window, scale); break;
      case 64: e = launch_mma<64>(grid, s, q, k, v, o, st, g, Sq, Sk, offset,
                                  window, scale); break;
      case 128: e = launch_mma<128>(grid, s, q, k, v, o, st, g, Sq, Sk,
                                    offset, window, scale); break;
    }
    return (int)e;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
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
