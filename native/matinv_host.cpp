// Host-side native utilities (C ABI).
//
// Counterpart of the reference's C++ host-side roles: test-matrix
// construction (reference main_file.cpp:41-52 builds hollow random matrices
// with mt19937) and the verification GEMM + residual (reference
// matrix_multiply.cpp:17-36 runs a naive O(N^3) GPU kernel). Here the
// generator is a xorshift128+ stream (deterministic across platforms, no
// <random> dependency) and the residual GEMM is cache-blocked on the host --
// the device never needs a verification kernel because verification is not
// on the hot path.
//
// Exposed via ctypes from gpu_matrix_inversion_tpu/utils/native.py, with a
// pure-NumPy fallback when the shared library has not been built.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Validate the flat-vector contract (reference mat_inv_32.cpp:206-215):
// order > 0 and len == order^2. Returns 1 if valid.
int matinv_validate(int order, long long len) {
  if (order <= 0) return 0;
  return len == (long long)order * (long long)order ? 1 : 0;
}

// Deterministic uniform [lo, hi) hollow matrix (zero diagonal), row-major.
// xorshift128+ keyed by `seed`.
void matinv_hollow_random(float* out, int n, uint64_t seed, float lo,
                          float hi) {
  uint64_t s0 = seed ^ 0x9E3779B97F4A7C15ull;
  uint64_t s1 = (seed << 1) | 1u;
  // warm up
  for (int i = 0; i < 8; ++i) {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
  }
  const float scale = (hi - lo) / 16777216.0f;  // 2^24
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) {
      uint64_t x = s0, y = s1;
      s0 = y;
      x ^= x << 23;
      s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
      uint32_t r = (uint32_t)((s1 + y) >> 40);  // 24 random bits
      out[(size_t)i * n + j] = (i == j) ? 0.0f : lo + scale * (float)r;
    }
  }
}

// Cache-blocked C = inv * a (both n x n, float64), accumulating the
// Frobenius norm of (inv @ a) and of (inv @ a - I).
static void gemm_norms(const double* inv, const double* a, int n,
                       double* frob_prod, double* frob_resid) {
  const int B = 64;
  double sum_prod = 0.0, sum_resid = 0.0;
  for (int ii = 0; ii < n; ii += B) {
    int imax = ii + B < n ? ii + B : n;
    for (int jj = 0; jj < n; jj += B) {
      int jmax = jj + B < n ? jj + B : n;
      for (int i = ii; i < imax; ++i) {
        double acc[64];
        int w = jmax - jj;
        std::memset(acc, 0, sizeof(double) * w);
        for (int k = 0; k < n; ++k) {
          const double v = inv[(size_t)i * n + k];
          const double* arow = a + (size_t)k * n + jj;
          for (int j = 0; j < w; ++j) acc[j] += v * arow[j];
        }
        for (int j = 0; j < w; ++j) {
          const double c = acc[j];
          sum_prod += c * c;
          const double r = c - ((i == jj + j) ? 1.0 : 0.0);
          sum_resid += r * r;
        }
      }
    }
  }
  *frob_prod = std::sqrt(sum_prod);
  *frob_resid = std::sqrt(sum_resid);
}

// The reference's error column: sqrt(N) - ||inv @ A||_F
// (matrix_multiply.cpp:193-204, matrix_inv_numpy.py:20-28).
double matinv_reference_error(const double* inv, const double* a, int n) {
  double fp, fr;
  gemm_norms(inv, a, n, &fp, &fr);
  return std::sqrt((double)n) - fp;
}

// Normalized residual ||inv @ A - I||_F / (||A||_F * ||inv||_F).
double matinv_relative_residual(const double* inv, const double* a, int n) {
  double fp, fr;
  gemm_norms(inv, a, n, &fp, &fr);
  double na = 0.0, ni = 0.0;
  const size_t total = (size_t)n * n;
  for (size_t i = 0; i < total; ++i) {
    na += a[i] * a[i];
    ni += inv[i] * inv[i];
  }
  double denom = std::sqrt(na) * std::sqrt(ni);
  if (denom < 1e-300) denom = 1e-300;
  return fr / denom;
}

}  // extern "C"
