// CPU driver for celerite2-tpu: the native NumPy-backend tier.
//
// Role of the reference's pybind11 driver module (in-place NumPy entry
// points over the C++ core, /root/reference/python/celerite2/driver.cpp)
// — re-implemented from the recursion math as a dependency-free C file
// with a C ABI (bound via ctypes; no pybind11 in this image).
//
// Conventions: all matrices row-major; t sorted ascending; J is dynamic
// (the inner loops over J are trivially vectorizable; fixed-width
// specialization like the reference's UNWRAP_CASES is not needed at
// -O3 for the J <= 32 regime we target).
//
// Build: g++ -O3 -fPIC -shared -std=c++17 driver.cpp -o libcelerite2_cpu.so

#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// LDL^T factorization of the semiseparable system.
// Writes d (N) and W (N,J); returns 0 on success or the 1-based index
// of the first non-positive pivot (mirrors the reference's error
// contract, forward.hpp:128).
std::int64_t celerite2_factor(
    std::int64_t N, std::int64_t J,
    const double* t, const double* c, const double* a,
    const double* U, const double* V,
    double* d, double* W) {
  std::vector<double> S(J * J, 0.0), p(J), tmp(J);

  d[0] = a[0];
  if (d[0] <= 0.0) return 1;
  for (std::int64_t j = 0; j < J; ++j) W[j] = V[j] / d[0];

  for (std::int64_t n = 1; n < N; ++n) {
    const double dt = t[n - 1] - t[n];
    for (std::int64_t j = 0; j < J; ++j) p[j] = std::exp(c[j] * dt);

    const double dprev = d[n - 1];
    const double* wprev = W + (n - 1) * J;
    const double* un = U + n * J;
    const double* vn = V + n * J;

    // S += d_{n-1} w w^T, then two-sided transport
    for (std::int64_t i = 0; i < J; ++i) {
      const double wi = dprev * wprev[i];
      double* Si = S.data() + i * J;
      for (std::int64_t j = 0; j < J; ++j) Si[j] += wi * wprev[j];
    }
    for (std::int64_t i = 0; i < J; ++i) {
      double* Si = S.data() + i * J;
      const double pi = p[i];
      for (std::int64_t j = 0; j < J; ++j) Si[j] *= pi * p[j];
    }

    // tmp = S u_n ; d_n = a_n - u tmp ; w_n = (v - tmp)/d
    double dn = a[n];
    for (std::int64_t i = 0; i < J; ++i) {
      double acc = 0.0;
      const double* Si = S.data() + i * J;
      for (std::int64_t j = 0; j < J; ++j) acc += Si[j] * un[j];
      tmp[i] = acc;
      dn -= un[i] * acc;
    }
    d[n] = dn;
    if (dn <= 0.0) return n + 1;
    double* wn = W + n * J;
    for (std::int64_t i = 0; i < J; ++i) wn[i] = (vn[i] - tmp[i]) / dn;
  }
  return 0;
}

// Shared sweep: solves (feedback, subtract) and matmuls (add).
// lower: time-forward; upper: time-reversed.
static void sweep(
    std::int64_t N, std::int64_t J, std::int64_t K,
    const double* t, const double* c,
    const double* A, const double* B,
    const double* Y, double* Z,
    bool is_solve, bool upper) {
  std::vector<double> F(J * K, 0.0), p(J), prev_row(K);

  const std::int64_t step = upper ? -1 : 1;
  const std::int64_t start = upper ? N - 1 : 0;

  // first row: Z = Y (solve) or 0 (matmul)
  {
    const double* y0 = Y + start * K;
    double* z0 = Z + start * K;
    for (std::int64_t k = 0; k < K; ++k) {
      z0[k] = is_solve ? y0[k] : 0.0;
      prev_row[k] = is_solve ? z0[k] : y0[k];
    }
  }

  for (std::int64_t m = 1; m < N; ++m) {
    const std::int64_t n = start + m * step;
    const std::int64_t nprev = n - step;
    const double dt = upper ? (t[n] - t[n + 1]) : (t[n - 1] - t[n]);
    for (std::int64_t j = 0; j < J; ++j) p[j] = std::exp(c[j] * dt);

    const double* bprev = B + nprev * J;
    for (std::int64_t j = 0; j < J; ++j) {
      const double bj = bprev[j];
      double* Fj = F.data() + j * K;
      const double pj = p[j];
      for (std::int64_t k = 0; k < K; ++k)
        Fj[k] = pj * (Fj[k] + bj * prev_row[k]);
    }

    const double* an = A + n * J;
    const double* yn = Y + n * K;
    double* zn = Z + n * K;
    for (std::int64_t k = 0; k < K; ++k) zn[k] = is_solve ? yn[k] : 0.0;
    const double sign = is_solve ? -1.0 : 1.0;
    for (std::int64_t j = 0; j < J; ++j) {
      const double aj = sign * an[j];
      const double* Fj = F.data() + j * K;
      for (std::int64_t k = 0; k < K; ++k) zn[k] += aj * Fj[k];
    }
    for (std::int64_t k = 0; k < K; ++k)
      prev_row[k] = is_solve ? zn[k] : yn[k];
  }
}

void celerite2_solve_lower(
    std::int64_t N, std::int64_t J, std::int64_t K,
    const double* t, const double* c, const double* U, const double* W,
    const double* Y, double* Z) {
  sweep(N, J, K, t, c, U, W, Y, Z, true, false);
}

void celerite2_solve_upper(
    std::int64_t N, std::int64_t J, std::int64_t K,
    const double* t, const double* c, const double* U, const double* W,
    const double* Y, double* Z) {
  sweep(N, J, K, t, c, W, U, Y, Z, true, true);
}

void celerite2_matmul_lower(
    std::int64_t N, std::int64_t J, std::int64_t K,
    const double* t, const double* c, const double* U, const double* V,
    const double* Y, double* Z) {
  sweep(N, J, K, t, c, U, V, Y, Z, false, false);
}

void celerite2_matmul_upper(
    std::int64_t N, std::int64_t J, std::int64_t K,
    const double* t, const double* c, const double* U, const double* V,
    const double* Y, double* Z) {
  sweep(N, J, K, t, c, V, U, Y, Z, false, true);
}

// Rectangular products for prediction at new points (merge over sorted
// t1/t2; role of reference forward.hpp:285-392, fresh implementation).
void celerite2_general_matmul_lower(
    std::int64_t N, std::int64_t M, std::int64_t J, std::int64_t K,
    const double* t1, const double* t2, const double* c,
    const double* U, const double* V, const double* Y, double* Z) {
  std::vector<double> F(J * K, 0.0), p(J);
  std::int64_t m = 0;
  double t_state = 0.0;
  bool have_state = false;

  for (std::int64_t n = 0; n < N; ++n) {
    double* zn = Z + n * K;
    for (std::int64_t k = 0; k < K; ++k) zn[k] = 0.0;

    while (m < M && t2[m] <= t1[n]) {
      const double dt = have_state ? (t_state - t2[m]) : 0.0;
      for (std::int64_t j = 0; j < J; ++j) p[j] = std::exp(c[j] * dt);
      const double* vm = V + m * J;
      const double* ym = Y + m * K;
      for (std::int64_t j = 0; j < J; ++j) {
        double* Fj = F.data() + j * K;
        const double pj = p[j], vj = vm[j];
        for (std::int64_t k = 0; k < K; ++k)
          Fj[k] = pj * Fj[k] + vj * ym[k];
      }
      t_state = t2[m];
      have_state = true;
      ++m;
    }
    if (!have_state) continue;

    const double dt = t_state - t1[n];
    const double* un = U + n * J;
    for (std::int64_t j = 0; j < J; ++j) {
      const double f = un[j] * std::exp(c[j] * dt);
      const double* Fj = F.data() + j * K;
      for (std::int64_t k = 0; k < K; ++k) zn[k] += f * Fj[k];
    }
  }
}

void celerite2_general_matmul_upper(
    std::int64_t N, std::int64_t M, std::int64_t J, std::int64_t K,
    const double* t1, const double* t2, const double* c,
    const double* U, const double* V, const double* Y, double* Z) {
  std::vector<double> F(J * K, 0.0), p(J);
  std::int64_t m = M - 1;
  double t_state = 0.0;
  bool have_state = false;

  for (std::int64_t n = N - 1; n >= 0; --n) {
    double* zn = Z + n * K;
    for (std::int64_t k = 0; k < K; ++k) zn[k] = 0.0;

    while (m >= 0 && t2[m] > t1[n]) {
      const double dt = have_state ? (t2[m] - t_state) : 0.0;
      for (std::int64_t j = 0; j < J; ++j) p[j] = std::exp(c[j] * dt);
      const double* vm = V + m * J;
      const double* ym = Y + m * K;
      for (std::int64_t j = 0; j < J; ++j) {
        double* Fj = F.data() + j * K;
        const double pj = p[j], vj = vm[j];
        for (std::int64_t k = 0; k < K; ++k)
          Fj[k] = pj * Fj[k] + vj * ym[k];
      }
      t_state = t2[m];
      have_state = true;
      --m;
    }
    if (!have_state) continue;

    const double dt = t1[n] - t_state;
    const double* un = U + n * J;
    for (std::int64_t j = 0; j < J; ++j) {
      const double f = un[j] * std::exp(c[j] * dt);
      const double* Fj = F.data() + j * K;
      for (std::int64_t k = 0; k < K; ++k) zn[k] += f * Fj[k];
    }
  }
}

// Fused (c, a, U, V) fill from term coefficients (role of the
// reference's fused get_celerite_matrices kernel, driver.cpp:422-477).
void celerite2_matrices(
    std::int64_t N, std::int64_t Jr, std::int64_t Jc,
    const double* ar, const double* cr,
    const double* ac, const double* bc, const double* cc,
    const double* dc,
    const double* x, const double* diag,
    double* c, double* a, double* U, double* V) {
  const std::int64_t J = Jr + 2 * Jc;
  double sum_amp = 0.0;
  for (std::int64_t j = 0; j < Jr; ++j) sum_amp += ar[j];
  for (std::int64_t j = 0; j < Jc; ++j) sum_amp += ac[j];

  for (std::int64_t j = 0; j < Jr; ++j) c[j] = cr[j];
  for (std::int64_t j = 0; j < Jc; ++j) {
    c[Jr + 2 * j] = cc[j];
    c[Jr + 2 * j + 1] = cc[j];
  }

  for (std::int64_t n = 0; n < N; ++n) {
    a[n] = diag[n] + sum_amp;
    double* Un = U + n * J;
    double* Vn = V + n * J;
    for (std::int64_t j = 0; j < Jr; ++j) {
      Un[j] = ar[j];
      Vn[j] = 1.0;
    }
    for (std::int64_t j = 0; j < Jc; ++j) {
      const double arg = dc[j] * x[n];
      const double co = std::cos(arg), si = std::sin(arg);
      Un[Jr + 2 * j] = ac[j] * co + bc[j] * si;
      Un[Jr + 2 * j + 1] = ac[j] * si - bc[j] * co;
      Vn[Jr + 2 * j] = co;
      Vn[Jr + 2 * j + 1] = si;
    }
  }
}

}  // extern "C"
