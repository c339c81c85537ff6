// Native benchmark driver: the analog of the reference's C++ main()
// (reference main_file.cpp:13-126: sweep N with hollow random matrices,
// call a variant selected by #defines, log "N <times> <error>" rows).
//
// Usage:
//   matinv_bench <N>                 single-shot inversion of one N x N
//   matinv_bench <start> <stop> <step>   sweep, one row per size
//
// Variant selection is a runtime flag (--fp64), not a rebuild -- the
// reference required recompiling with different #defines (main_file.cpp:
// 14-18).

#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <cstdint>

extern "C" {
int matinv_tpu_init(void);
int matrix_inv_32(const float* data, int n, float* out);
int matrix_inv_64(const double* data, int n, double* out);
int matrix_solve_32(const float* a, const float* b, int n, int k, float* out);
void matinv_hollow_random(float* out, int n, uint64_t seed, float lo,
                          float hi);
double matinv_reference_error(const double* inv, const double* a, int n);
double matinv_relative_residual(const double* inv, const double* a, int n);
}

static double now_s() {
  using clock = std::chrono::steady_clock;
  return std::chrono::duration<double>(clock::now().time_since_epoch())
      .count();
}

static int run_one(int n, bool fp64) {
  std::vector<float> a32((size_t)n * n);
  matinv_hollow_random(a32.data(), n, (uint64_t)n, 0.0f, 100.0f);

  double t_inv;
  std::vector<double> a64((size_t)n * n), inv64((size_t)n * n);
  for (size_t i = 0; i < a32.size(); ++i) a64[i] = a32[i];

  int rc;
  if (fp64) {
    const double t0 = now_s();
    rc = matrix_inv_64(a64.data(), n, inv64.data());
    t_inv = now_s() - t0;
  } else {
    std::vector<float> inv32((size_t)n * n);
    const double t0 = now_s();
    rc = matrix_inv_32(a32.data(), n, inv32.data());
    t_inv = now_s() - t0;
    for (size_t i = 0; i < inv32.size(); ++i) inv64[i] = inv32[i];
  }
  if (rc != 0) {
    std::printf("%d FAILED rc=%d\n", n, rc);
    return rc;
  }
  const double err = matinv_reference_error(inv64.data(), a64.data(), n);
  const double res = matinv_relative_residual(inv64.data(), a64.data(), n);
  std::printf("%d %.6f %.6e %.3e\n", n, t_inv, err, res);
  std::fflush(stdout);
  return 0;
}

static int run_solve(int n) {
  std::vector<float> a((size_t)n * n), b((size_t)n), x((size_t)n);
  matinv_hollow_random(a.data(), n, (uint64_t)n, 0.0f, 100.0f);
  for (int i = 0; i < n; ++i) b[i] = (float)(i % 7) - 3.0f;
  int rc = matrix_solve_32(a.data(), b.data(), n, 1, x.data());
  if (rc != 0) {
    std::printf("%d SOLVE FAILED rc=%d\n", n, rc);
    return rc;
  }
  // residual ||A x - b||_inf
  double worst = 0.0;
  for (int i = 0; i < n; ++i) {
    double acc = 0.0;
    for (int j = 0; j < n; ++j) acc += (double)a[(size_t)i * n + j] * x[j];
    double d = acc - b[i];
    if (d < 0) d = -d;
    if (d > worst) worst = d;
  }
  std::printf("solve %d: max|Ax-b| = %.3e\n", n, worst);
  return worst < 1e-2 ? 0 : 4;
}

int main(int argc, char** argv) {
  bool fp64 = false;
  bool solve = false;
  std::vector<int> args;
  for (int i = 1; i < argc; ++i) {
    if (std::strcmp(argv[i], "--fp64") == 0)
      fp64 = true;
    else if (std::strcmp(argv[i], "--solve") == 0)
      solve = true;
    else
      args.push_back(std::atoi(argv[i]));
  }
  if (args.empty()) {
    std::fprintf(stderr,
                 "usage: %s [--fp64] <N> | <start> <stop> <step>\n", argv[0]);
    return 2;
  }
  if (matinv_tpu_init() != 0) {
    std::fprintf(stderr, "matinv_tpu_init failed\n");
    return 3;
  }
  if (solve) return run_solve(args[0]);
  if (args.size() == 1) return run_one(args[0], fp64);
  int start = args[0], stop = args[1], step = args.size() > 2 ? args[2] : 10;
  for (int n = start; n <= stop; n += step) {
    if (int rc = run_one(n, fp64)) return rc;
  }
  return 0;
}
