// Weighted 1-D k-means for NUQ codebook fitting, on the host: the solver
// behind `method="native"` (and "auto") of
// squeezellm_tpu_torch/quantize/kmeans.py `fit_module_luts`.
//
// The reference spends its offline quantization time in per-channel sklearn
// KMeans across a multiprocessing pool (reference quantization/nuq.py:50-58,
// 117,179). This is an O(N log N + iters * K log N) sorted-Lloyd solver
// (1-D nearest-centroid assignment is an interval partition, so each Lloyd
// step is K binary searches over prefix sums instead of an N*K distance
// matrix), OpenMP-parallel over output channels, with a deterministic
// seeded weighted k-means++ init per channel (std::mt19937(seed + c *
// 0x9E3779B9)). It is the JAX package's native solver (csrc/nuq_kmeans.cpp)
// line for line, so that both packages fit the same codebooks by default:
// built with squeezellm_tpu_torch/_build.py's HOST_FLAGS (no -march=native)
// it gives the JAX package's library's bits (tests/test_torch_quantize.py).
//
// Exposed as a C ABI for ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

struct SortedChannel {
  std::vector<double> x;    // sorted values
  std::vector<double> w;    // weights in sorted order
  std::vector<double> cw;   // prefix sum of w   (size N+1)
  std::vector<double> cwx;  // prefix sum of w*x (size N+1)
};

void build_sorted(const float* values, const float* weights, int n,
                  SortedChannel& s) {
  std::vector<int> idx(n);
  for (int i = 0; i < n; ++i) idx[i] = i;
  std::sort(idx.begin(), idx.end(),
            [&](int a, int b) { return values[a] < values[b]; });
  s.x.resize(n);
  s.w.resize(n);
  s.cw.assign(n + 1, 0.0);
  s.cwx.assign(n + 1, 0.0);
  for (int i = 0; i < n; ++i) {
    s.x[i] = values[idx[i]];
    s.w[i] = weights[idx[i]];
  }
  for (int i = 0; i < n; ++i) {
    s.cw[i + 1] = s.cw[i] + s.w[i];
    s.cwx[i + 1] = s.cwx[i] + s.w[i] * s.x[i];
  }
}

// Weighted k-means++ init on the sorted arrays.
void kmeanspp_init(const SortedChannel& s, int k, std::mt19937& rng,
                   std::vector<double>& cent) {
  const int n = static_cast<int>(s.x.size());
  std::uniform_real_distribution<double> uni(0.0, 1.0);
  std::vector<double> d2(n);
  // first centroid ~ weights
  {
    const double total = s.cw[n];
    double r = uni(rng) * total;
    int lo = 0;
    double acc = 0.0;
    for (; lo < n - 1; ++lo) {
      acc += s.w[lo];
      if (acc >= r) break;
    }
    cent[0] = s.x[lo];
  }
  for (int i = 0; i < n; ++i) {
    const double d = s.x[i] - cent[0];
    d2[i] = d * d;
  }
  for (int j = 1; j < k; ++j) {
    double total = 0.0;
    for (int i = 0; i < n; ++i) total += d2[i] * s.w[i];
    double r = uni(rng) * total;
    int pick = n - 1;
    double acc = 0.0;
    for (int i = 0; i < n; ++i) {
      acc += d2[i] * s.w[i];
      if (acc >= r) {
        pick = i;
        break;
      }
    }
    cent[j] = s.x[pick];
    for (int i = 0; i < n; ++i) {
      const double d = s.x[i] - cent[j];
      const double dd = d * d;
      if (dd < d2[i]) d2[i] = dd;
    }
  }
  std::sort(cent.begin(), cent.end());
}

// One channel: sorted Lloyd until convergence.
void solve_channel(const float* values, const float* weights, int n, int k,
                   int max_iter, uint32_t seed, double tol, float* cent_out,
                   uint8_t* labels_out) {
  SortedChannel s;
  build_sorted(values, weights, n, s);

  std::mt19937 rng(seed);
  std::vector<double> cent(k);
  kmeanspp_init(s, k, rng, cent);

  std::vector<int> bound(k + 1);  // bound[j]..bound[j+1] assigned to j
  bound[0] = 0;
  bound[k] = n;
  for (int it = 0; it < max_iter; ++it) {
    // interval boundaries at midpoints between adjacent centroids
    for (int j = 1; j < k; ++j) {
      const double mid = 0.5 * (cent[j - 1] + cent[j]);
      bound[j] = static_cast<int>(
          std::lower_bound(s.x.begin(), s.x.end(), mid) - s.x.begin());
      if (bound[j] < bound[j - 1]) bound[j] = bound[j - 1];
    }
    double moved = 0.0;
    for (int j = 0; j < k; ++j) {
      const int a = bound[j], b = bound[j + 1];
      const double wsum = s.cw[b] - s.cw[a];
      if (wsum > 0.0) {
        const double nc = (s.cwx[b] - s.cwx[a]) / wsum;
        moved = std::max(moved, std::fabs(nc - cent[j]));
        cent[j] = nc;
      }
    }
    std::sort(cent.begin(), cent.end());
    if (moved < tol) break;
  }

  // final assignment boundaries
  for (int j = 1; j < k; ++j) {
    const double mid = 0.5 * (cent[j - 1] + cent[j]);
    bound[j] = static_cast<int>(
        std::lower_bound(s.x.begin(), s.x.end(), mid) - s.x.begin());
    if (bound[j] < bound[j - 1]) bound[j] = bound[j - 1];
  }
  for (int j = 0; j < k; ++j) cent_out[j] = static_cast<float>(cent[j]);

  // labels in original order: nearest centroid == interval of sorted pos;
  // recompute directly per element via binary search over midpoints.
  std::vector<double> mids(k - 1);
  for (int j = 0; j < k - 1; ++j) mids[j] = 0.5 * (cent[j] + cent[j + 1]);
  for (int i = 0; i < n; ++i) {
    const double v = values[i];
    const int j = static_cast<int>(
        std::upper_bound(mids.begin(), mids.end(), v) - mids.begin());
    labels_out[i] = static_cast<uint8_t>(j);
  }
}

}  // namespace

extern "C" {

// values/weights: row-major (C, N). centroids_out: (C, K) sorted ascending.
// labels_out: (C, N). Deterministic for a fixed seed (per-channel seeding,
// independent of thread scheduling).
void nuq_weighted_kmeans_batched(const float* values, const float* weights,
                                 int channels, int n, int k, int max_iter,
                                 uint32_t seed, double tol,
                                 float* centroids_out, uint8_t* labels_out) {
#pragma omp parallel for schedule(dynamic)
  for (int c = 0; c < channels; ++c) {
    solve_channel(values + static_cast<int64_t>(c) * n,
                  weights + static_cast<int64_t>(c) * n, n, k, max_iter,
                  seed + static_cast<uint32_t>(c) * 0x9E3779B9u, tol,
                  centroids_out + static_cast<int64_t>(c) * k,
                  labels_out + static_cast<int64_t>(c) * n);
  }
}

int nuq_kmeans_version() { return 1; }

}  // extern "C"
