// The three scan passes of the fused GP log-likelihood (value + gradient),
// written for Hopper (sm_90a).  Built with nvcc into a shared library with
// a plain C interface and bound with ctypes (celerite2_torch/ops/_build.py).
//
// Each pass is the within-block half of a two-level scan over the rows of
// every chain: thread (c, b) walks the L rows of block b of chain c in
// order, builds each row's monoid element in registers from that row's raw
// data, composes it into a running value held in registers, and writes
//   * for every row, the running composition (the prefix the distribute
//     reads: celerite2_torch/ops/fused_loglik.py), and
//   * for the block, its full composition (the block map that the
//     cross-block level composes in torch, ops/elements.py).
// Rows index as n = b * L + l in natural row-major (C, N, ...) layout.  A
// warp's 32 threads read rows L apart, so loads and stores are not
// coalesced (each thread touches its own cache lines); a packed layout is
// left for later work.  The ragged last block stops at row N - 1.
//
// Elements are templated on the scalar type (float, double) and on the
// celerite width J (1..4; the dense factor adjoint K3 1, 2 only); the
// formulas are the JAX package's (celerite2_tpu/ops/fused_slab.py builds,
// celerite2_tpu/ops/planes.py combines), operand order included.
//
// At J = 3, 4 the factor adjoint is the structured pair K4 / K5 instead of
// K3 (fused_slab.py:476-493): K4 densifies one (J^2 + 1)-affine map per
// block, the block maps compose in torch, and K5 re-runs each block's
// structured recursion from its seed.

#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int kThreads = 32;

template <typename T>
struct Limits;
template <>
struct Limits<float> {
  __device__ static float eps() { return FLT_EPSILON; }
  __device__ static float tiny() { return FLT_MIN; }
};
template <>
struct Limits<double> {
  __device__ static double eps() { return DBL_EPSILON; }
  __device__ static double tiny() { return DBL_MIN; }
};

// ------------------------------------------------------ small matrices

template <typename T>
__device__ __forceinline__ T absval(T x) {
  return x < T(0) ? -x : x;
}

template <typename T, int M, int K, int P>
__device__ __forceinline__ void matmul(const T (&X)[M][K], const T (&Y)[K][P],
                                       T (&Z)[M][P]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      T s = X[i][0] * Y[0][j];
#pragma unroll
      for (int l = 1; l < K; ++l) s += X[i][l] * Y[l][j];
      Z[i][j] = s;
    }
  }
}

template <typename T, int J>
__device__ __forceinline__ void transpose(const T (&X)[J][J], T (&Y)[J][J]) {
#pragma unroll
  for (int i = 0; i < J; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) Y[i][j] = X[j][i];
}

// The closed-form inverse of planes.p_inv: 1x1; 2x2 with the scale-aware
// determinant floor of planes._det2_clamped; 4x4 by the 2x2-block Schur
// recursion with that clamped inverse on the leading block and on the Schur
// complement; 3x3 bordered to 4x4 with an identity row and column.  No
// pivoting: the clamp decides what a near-singular combine returns.
template <typename T, int J>
__device__ __forceinline__ void inv_clamped(const T (&M)[J][J], T (&O)[J][J]) {
  if constexpr (J == 1) {
    O[0][0] = T(1) / M[0][0];
  } else if constexpr (J == 2) {
    const T a = M[0][0], b = M[0][1], c = M[1][0], d = M[1][1];
    T det = a * d - b * c;
    const T floor =
        Limits<T>::eps() * (absval(a * d) + absval(b * c)) + Limits<T>::tiny();
    if (!(absval(det) >= floor)) det = det < T(0) ? -floor : floor;
    const T r = T(1) / det;
    O[0][0] = d * r;
    O[0][1] = -b * r;
    O[1][0] = -c * r;
    O[1][1] = a * r;
  } else if constexpr (J == 3) {
    T Mp[4][4], Op[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Mp[i][j] = (i < 3 && j < 3) ? M[i][j] : (i == j ? T(1) : T(0));
    inv_clamped<T, 4>(Mp, Op);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) O[i][j] = Op[i][j];
  } else {
    static_assert(J == 4, "J <= 4");
    T A[2][2], B[2][2], C[2][2], D[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        A[i][j] = M[i][j];
        B[i][j] = M[i][j + 2];
        C[i][j] = M[i + 2][j];
        D[i][j] = M[i + 2][j + 2];
      }
    T Ai[2][2], AiB[2][2], CAiB[2][2], S[2][2], Si[2][2], CAi[2][2],
        AiBSi[2][2], TL[2][2], BL[2][2];
    inv_clamped<T, 2>(A, Ai);
    matmul(Ai, B, AiB);
    matmul(C, AiB, CAiB);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) S[i][j] = D[i][j] - CAiB[i][j];
    inv_clamped<T, 2>(S, Si);
    matmul(C, Ai, CAi);
    matmul(AiB, Si, AiBSi);
    matmul(AiBSi, CAi, TL);
    matmul(Si, CAi, BL);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        O[i][j] = Ai[i][j] + TL[i][j];
        O[i][j + 2] = -AiBSi[i][j];
        O[i + 2][j] = -BL[i][j];
        O[i + 2][j + 2] = Si[i][j];
      }
  }
}

// ============================================== K1: Kalman forward pass
//
// Replaces the Pallas kernel celerite2_tpu/ops/fused_slab.py:_scan_pass
// (pallas_call at :308, body _body :234) run forward with the element
// build _build_kalman (:388) and the kalman_spec combine
// (celerite2_tpu/ops/planes.py:358).
//
// Bound on this card: latency.  Each row is one dependent chain of ~200
// flops (a 2x2 inverse and a dozen 2x2 products at J = 2) on 16 register
// values, and the blocks give only C * N / L threads, so the card's
// throughput is far from the limit; bytes are 3J + 3 values read and
// 3J^2 + 2J written per row.  The design keeps the whole element and the
// running composition in registers, carries the previous row's (u, v, 1/a,
// y) from one step to the next so each row is read once, and uses 32-thread
// CTAs so that few threads still spread over many SMs.  At J = 4 in float64
// the composition alone is 56 doubles and the combine's temporaries as many
// again, past the 255-register limit, so ptxas spills (counts in PERF.md).

template <typename T, int J>
struct Kalman {
  T A[J][J], Q[J][J], R[J][J], b[J][1], e[J][1];
};

template <typename T, int J>
__device__ __forceinline__ Kalman<T, J> kalman_combine(const Kalman<T, J>& x,
                                                       const Kalman<T, J>& y) {
  // x earlier, y later (planes.kalman_spec combine)
  T QR[J][J], G[J][J];
  matmul(x.Q, y.R, QR);
#pragma unroll
  for (int i = 0; i < J; ++i) QR[i][i] += T(1);
  inv_clamped(QR, G);

  T GA1[J][J], GQ1[J][J], R2G[J][J];
  matmul(G, x.A, GA1);
  matmul(G, x.Q, GQ1);
  T Qe[J][1], t1[J][1], Gb[J][1];
  matmul(x.Q, y.e, Qe);
#pragma unroll
  for (int i = 0; i < J; ++i) t1[i][0] = x.b[i][0] + Qe[i][0];
  matmul(G, t1, Gb);
  matmul(y.R, G, R2G);

  T Rb[J][1], vE[J][1], QvE[J][1], RQvE[J][1], Eeta[J][1];
  matmul(y.R, x.b, Rb);
#pragma unroll
  for (int i = 0; i < J; ++i) vE[i][0] = y.e[i][0] - Rb[i][0];
  matmul(x.Q, vE, QvE);
  matmul(R2G, QvE, RQvE);
#pragma unroll
  for (int i = 0; i < J; ++i) Eeta[i][0] = vE[i][0] - RQvE[i][0];

  Kalman<T, J> out;
  matmul(y.A, GA1, out.A);

  T A2T[J][J], AGQ[J][J], Q12[J][J];
  transpose(y.A, A2T);
  matmul(y.A, GQ1, AGQ);
  matmul(AGQ, A2T, Q12);

  T A1T[J][J], ARG[J][J], R12[J][J];
  transpose(x.A, A1T);
  matmul(A1T, R2G, ARG);
  matmul(ARG, x.A, R12);

#pragma unroll
  for (int i = 0; i < J; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) {
      Q12[i][j] += y.Q[i][j];
      R12[i][j] += x.R[i][j];
    }
#pragma unroll
  for (int i = 0; i < J; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) {
      out.Q[i][j] = T(0.5) * (Q12[i][j] + Q12[j][i]);
      out.R[i][j] = T(0.5) * (R12[i][j] + R12[j][i]);
    }

  T AGb[J][1], AE[J][1];
  matmul(y.A, Gb, AGb);
  matmul(A1T, Eeta, AE);
#pragma unroll
  for (int i = 0; i < J; ++i) {
    out.b[i][0] = y.b[i][0] + AGb[i][0];
    out.e[i][0] = x.e[i][0] + AE[i][0];
  }
  return out;
}

template <typename T, int J>
__device__ __forceinline__ void kalman_store(const Kalman<T, J>& k, T* out) {
  // flat order: A, Q, R (row-major J x J), b, eta
#pragma unroll
  for (int i = 0; i < J; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) {
      out[i * J + j] = k.A[i][j];
      out[J * J + i * J + j] = k.Q[i][j];
      out[2 * J * J + i * J + j] = k.R[i][j];
    }
#pragma unroll
  for (int i = 0; i < J; ++i) {
    out[3 * J * J + i] = k.b[i][0];
    out[3 * J * J + J + i] = k.e[i][0];
  }
}

template <typename T, int J>
__global__ void __launch_bounds__(kThreads)
    kalman_fwd_kernel(const T* __restrict__ p, const T* __restrict__ U,
                      const T* __restrict__ V, const T* __restrict__ ainv,
                      const T* __restrict__ y, T* __restrict__ pre,
                      T* __restrict__ maps, int C, int N, int L, int NB) {
  constexpr int E = 3 * J * J + 2 * J;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)C * NB) return;
  const int c = (int)(idx / NB);
  const int blk = (int)(idx % NB);
  const long long row0 = (long long)c * N;
  const int n0 = blk * L;
  const int n1 = min(n0 + L, N);

  // the previous row's data; row 0 of a chain has none (identity element)
  T up[J], vp[J], ainvp = T(0), yp = T(0);
#pragma unroll
  for (int j = 0; j < J; ++j) up[j] = vp[j] = T(0);
  if (n0 > 0) {
    const long long r = row0 + n0 - 1;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      up[j] = U[r * J + j];
      vp[j] = V[r * J + j];
    }
    ainvp = ainv[r];
    yp = y[r];
  }

  Kalman<T, J> acc;
#pragma unroll
  for (int i = 0; i < J; ++i) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      acc.A[i][j] = i == j ? T(1) : T(0);
      acc.Q[i][j] = T(0);
      acc.R[i][j] = T(0);
    }
    acc.b[i][0] = T(0);
    acc.e[i][0] = T(0);
  }

  for (int n = n0; n < n1; ++n) {
    const long long r = row0 + n;
    T pr[J];
#pragma unroll
    for (int j = 0; j < J; ++j) pr[j] = p[r * J + j];

    Kalman<T, J> el;  // fused_slab._build_kalman
#pragma unroll
    for (int i = 0; i < J; ++i) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        el.A[i][j] = pr[i] * ((i == j ? T(1) : T(0)) - vp[i] * up[j] * ainvp);
        el.Q[i][j] = pr[i] * vp[i] * vp[j] * ainvp * pr[j];
        el.R[i][j] = -up[i] * up[j] * ainvp;
      }
      el.b[i][0] = pr[i] * vp[i] * yp * ainvp;
      el.e[i][0] = -up[i] * yp * ainvp;
    }
    acc = kalman_combine(acc, el);
    kalman_store(acc, pre + r * E);

#pragma unroll
    for (int j = 0; j < J; ++j) {
      up[j] = U[r * J + j];
      vp[j] = V[r * J + j];
    }
    ainvp = ainv[r];
    yp = y[r];
  }
  kalman_store(acc, maps + idx * E);
}

// ============================================== K2: solve adjoint pass
//
// Replaces celerite2_tpu/ops/fused_slab.py:_scan_pass (pallas_call :308,
// body _body :234) run in reverse with the element build _build_solve_rev
// (:424) and the mat_affine_spec(J, 1) combine (planes.py:231).
//
// Bound on this card: latency, as K1, with a lighter step (J^2 + J = 6
// register values at J = 2, one J x J product and a matvec per row).  The
// element of row 0 of every chain is the identity (u = 0 there).

template <typename T, int J>
__global__ void __launch_bounds__(kThreads)
    solve_rev_kernel(const T* __restrict__ p, const T* __restrict__ U,
                     const T* __restrict__ W, const T* __restrict__ bz,
                     T* __restrict__ pre, T* __restrict__ maps, int C, int N,
                     int L, int NB) {
  constexpr int E = J * J + J;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)C * NB) return;
  const int c = (int)(idx / NB);
  const int blk = (int)(idx % NB);
  const long long row0 = (long long)c * N;
  const int n0 = blk * L;
  const int n1 = min(n0 + L, N);

  T A[J][J], b[J][1];
#pragma unroll
  for (int i = 0; i < J; ++i) {
#pragma unroll
    for (int j = 0; j < J; ++j) A[i][j] = i == j ? T(1) : T(0);
    b[i][0] = T(0);
  }

  for (int n = n1 - 1; n >= n0; --n) {
    const long long r = row0 + n;
    T pr[J], u[J], w[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      pr[j] = p[r * J + j];
      u[j] = n == 0 ? T(0) : U[r * J + j];
      w[j] = W[r * J + j];
    }
    const T bzr = bz[r];

    T eA[J][J], eb[J][1];  // fused_slab._build_solve_rev
#pragma unroll
    for (int i = 0; i < J; ++i) {
#pragma unroll
      for (int j = 0; j < J; ++j)
        eA[i][j] = pr[i] * ((i == j ? T(1) : T(0)) - u[i] * w[j]);
      eb[i][0] = -pr[i] * u[i] * bzr;
    }
    T nA[J][J], nb[J][1];
    matmul(eA, A, nA);
    matmul(eA, b, nb);
    T* o = pre + r * E;
#pragma unroll
    for (int i = 0; i < J; ++i) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        A[i][j] = nA[i][j];
        o[i * J + j] = nA[i][j];
      }
      b[i][0] = nb[i][0] + eb[i][0];
      o[J * J + i] = b[i][0];
    }
  }
  T* o = maps + idx * E;
#pragma unroll
  for (int i = 0; i < J; ++i) {
#pragma unroll
    for (int j = 0; j < J; ++j) o[i * J + j] = A[i][j];
    o[J * J + i] = b[i][0];
  }
}

// ============================================= K3: factor adjoint pass
//
// Replaces celerite2_tpu/ops/fused_slab.py:_scan_pass (pallas_call :308,
// body _body :234) run in reverse with the element build _build_factor_rev
// (:441) and the mat_affine_spec(J^2, 1) combine.
//
// Bound on this card: latency, with the heaviest step of the three: a
// dense J^2 x J^2 affine map (J^4 + J^2 = 20 register values at J = 2) is
// built per row and composed by a (J^2)^3 product.  The design keeps the
// map and the running composition in registers (about 60 values at J = 2,
// within the 255-register limit); the element of row 0 of every chain is
// the identity (u = 0 there).

template <typename T, int J>
__global__ void __launch_bounds__(kThreads)
    factor_rev_kernel(const T* __restrict__ p, const T* __restrict__ U,
                      const T* __restrict__ W, const T* __restrict__ bv0,
                      const T* __restrict__ bdp, T* __restrict__ pre,
                      T* __restrict__ maps, int C, int N, int L, int NB) {
  constexpr int D = J * J;
  constexpr int E = D * D + D;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)C * NB) return;
  const int c = (int)(idx / NB);
  const int blk = (int)(idx % NB);
  const long long row0 = (long long)c * N;
  const int n0 = blk * L;
  const int n1 = min(n0 + L, N);

  T A[D][D], b[D][1];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) A[i][j] = i == j ? T(1) : T(0);
    b[i][0] = T(0);
  }

  for (int n = n1 - 1; n >= n0; --n) {
    const long long r = row0 + n;
    T pr[J], u[J], w[J], g[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      pr[j] = p[r * J + j];
      u[j] = n == 0 ? T(0) : U[r * J + j];
      w[j] = W[r * J + j];
      g[j] = bv0[r * J + j];
    }
    const T bd = bdp[r];

    // fused_slab._build_factor_rev: dM'[jk]/dM[lm] = p_j p_k [d_jl d_km
    //   - u_j (d_kl w_m + d_km w_l) + u_j u_k w_l w_m], constant = step(0)
    T eA[D][D], eb[D][1];
#pragma unroll
    for (int jj = 0; jj < J; ++jj)
#pragma unroll
      for (int kk = 0; kk < J; ++kk) {
#pragma unroll
        for (int ll = 0; ll < J; ++ll)
#pragma unroll
          for (int mm = 0; mm < J; ++mm) {
            const T term = (jj == ll && kk == mm) ? T(1) : T(0);
            T t2 = T(0);
            if (kk == ll) t2 = t2 + w[mm];
            if (kk == mm) t2 = t2 + w[ll];
            const T val = term - u[jj] * t2 + u[jj] * u[kk] * w[ll] * w[mm];
            eA[jj * J + kk][ll * J + mm] = pr[jj] * pr[kk] * val;
          }
        eb[jj * J + kk][0] =
            pr[jj] * (-u[jj] * g[kk] - bd * u[jj] * u[kk]) * pr[kk];
      }

    T nA[D][D], nb[D][1];
    matmul(eA, A, nA);
    matmul(eA, b, nb);
    T* o = pre + r * E;
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        A[i][j] = nA[i][j];
        o[i * D + j] = nA[i][j];
      }
      b[i][0] = nb[i][0] + eb[i][0];
      o[D * D + i] = b[i][0];
    }
  }
  T* o = maps + idx * E;
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) o[i * D + j] = A[i][j];
    o[D * D + i] = b[i][0];
  }
}

// ================================ K4, K5: the structured factor adjoint
//
// At J = 3, 4 the dense step of K3 is J^4 + J^2 = 272 values per row
// (J = 4); the structured step (fused_slab._structured_apply, :496) applies
// the same affine map to a J x J state M in O(J^2):
//   bv = (M + M^T) w (+ bv0),  ba = -w^T M w (+ bdp),
//   M' = p (.) [M - u (x) bv - ba u (x) u] (.) p,
// where the parenthesised constants belong to the affine step only, and
// u = 0 at row 0 of every chain (the identity step).

template <typename T, int J>
__device__ __forceinline__ void structured_apply(T (&M)[J * J], const T (&p)[J],
                                                 const T (&u)[J],
                                                 const T (&w)[J],
                                                 const T (&g)[J], T bd,
                                                 bool affine) {
  T Mw[J], bv[J];
#pragma unroll
  for (int i = 0; i < J; ++i) {
    T s = M[i * J] * w[0], st = M[i] * w[0];
#pragma unroll
    for (int k = 1; k < J; ++k) {
      s += M[i * J + k] * w[k];
      st += M[k * J + i] * w[k];
    }
    Mw[i] = s;
    bv[i] = s + st;
  }
  T wMw = w[0] * Mw[0];
#pragma unroll
  for (int i = 1; i < J; ++i) wMw += w[i] * Mw[i];
  T ba = -wMw;
  if (affine) {
#pragma unroll
    for (int i = 0; i < J; ++i) bv[i] += g[i];
    ba += bd;
  }
#pragma unroll
  for (int i = 0; i < J; ++i)
#pragma unroll
    for (int k = 0; k < J; ++k)
      M[i * J + k] =
          p[i] * (M[i * J + k] - u[i] * bv[k] - ba * u[i] * u[k]) * p[k];
}

// The parameters of row n (global row r): p, u (0 at n = 0), w, bv0, bdp.
template <typename T, int J>
__device__ __forceinline__ void frev_row(const T* __restrict__ p,
                                         const T* __restrict__ U,
                                         const T* __restrict__ W,
                                         const T* __restrict__ bv0,
                                         const T* __restrict__ bdp, int n,
                                         long long r, T (&pr)[J], T (&u)[J],
                                         T (&w)[J], T (&g)[J], T& bd) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    pr[j] = p[r * J + j];
    u[j] = n == 0 ? T(0) : U[r * J + j];
    w[j] = W[r * J + j];
    g[j] = bv0[r * J + j];
  }
  bd = bdp[r];
}

// K4 frev_maps: replaces the Pallas kernel celerite2_tpu/ops/fused_slab.py:
// _factor_adjoint_structured phase A (pallas_call :629, body _phaseA_body
// :530).  For each (chain, block) it densifies the block's composed reverse
// map: the D = J^2 basis columns go through the steps' linear part, the
// constant through the full affine step, rows in descending order.  Output
// (C, NB, D^2 + D): column k at [k D, (k + 1) D), the constant at
// [D^2, D^2 + D).
//
// Bound on this card: latency, as K1-K3: 256 dependent steps of O(J^2) per
// column.  The TPU carried all D^2 + D = 272 values (J = 4) of a block in
// VMEM scratch; one thread cannot hold that in registers.  So one warp walks
// one (chain, block) and lane k < D carries column k (D values), lane D the
// constant: 17 of 32 lanes at J = 4, 10 at J = 3.  Every lane reads the same
// row's parameters, which the hardware serves as one broadcast load.

template <typename T, int J>
__global__ void __launch_bounds__(kThreads)
    frev_maps_kernel(const T* __restrict__ p, const T* __restrict__ U,
                     const T* __restrict__ W, const T* __restrict__ bv0,
                     const T* __restrict__ bdp, T* __restrict__ maps, int C,
                     int N, int L, int NB) {
  constexpr int D = J * J;
  constexpr int E = D * D + D;
  const long long idx = blockIdx.x;
  const int lane = threadIdx.x;
  if (idx >= (long long)C * NB || lane > D) return;
  const int c = (int)(idx / NB);
  const int blk = (int)(idx % NB);
  const long long row0 = (long long)c * N;
  const int n0 = blk * L;
  const int n1 = min(n0 + L, N);
  const bool affine = lane == D;

  T M[D];
#pragma unroll
  for (int i = 0; i < D; ++i) M[i] = i == lane ? T(1) : T(0);

  for (int n = n1 - 1; n >= n0; --n) {
    T pr[J], u[J], w[J], g[J], bd;
    frev_row<T, J>(p, U, W, bv0, bdp, n, row0 + n, pr, u, w, g, bd);
    structured_apply<T, J>(M, pr, u, w, g, bd, affine);
  }
  T* o = maps + idx * E + lane * D;
#pragma unroll
  for (int i = 0; i < D; ++i) o[i] = M[i];
}

// K5 frev_states: replaces fused_slab.py:_factor_adjoint_structured phase C
// (pallas_call :697, body _phaseC_body :580).  Thread (c, b) starts from its
// block's seed (the state after every later block, from the cross-block
// level) and walks the block's rows in descending order, writing the state
// ENTERING each row before applying that row's affine step.  Output
// (C, N, D).  At row 0 (the identity step) that is the state after every
// real step, which is what the row formulas need there.
//
// Bound on this card: latency, as K2: D = 16 register values (J = 4) and
// O(J^2) per row; D values written per row.

template <typename T, int J>
__global__ void __launch_bounds__(kThreads)
    frev_states_kernel(const T* __restrict__ p, const T* __restrict__ U,
                       const T* __restrict__ W, const T* __restrict__ bv0,
                       const T* __restrict__ bdp, const T* __restrict__ seeds,
                       T* __restrict__ out, int C, int N, int L, int NB) {
  constexpr int D = J * J;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)C * NB) return;
  const int c = (int)(idx / NB);
  const int blk = (int)(idx % NB);
  const long long row0 = (long long)c * N;
  const int n0 = blk * L;
  const int n1 = min(n0 + L, N);

  T M[D];
#pragma unroll
  for (int i = 0; i < D; ++i) M[i] = seeds[idx * D + i];

  for (int n = n1 - 1; n >= n0; --n) {
    const long long r = row0 + n;
    T* o = out + r * D;
#pragma unroll
    for (int i = 0; i < D; ++i) o[i] = M[i];
    T pr[J], u[J], w[J], g[J], bd;
    frev_row<T, J>(p, U, W, bv0, bdp, n, r, pr, u, w, g, bd);
    structured_apply<T, J>(M, pr, u, w, g, bd, true);
  }
}

inline dim3 grid_for(int C, int NB) {
  const long long n = (long long)C * NB;
  return dim3((unsigned)((n + kThreads - 1) / kThreads));
}

template <typename T>
int launch_kalman(int J, const void* p, const void* U, const void* V,
                  const void* ainv, const void* y, void* pre, void* maps,
                  int C, int N, int L, cudaStream_t s) {
  const int NB = (N + L - 1) / L;
  const T *pp = (const T*)p, *Up = (const T*)U, *Vp = (const T*)V,
          *ap = (const T*)ainv, *yy = (const T*)y;
  if (J == 1)
    kalman_fwd_kernel<T, 1><<<grid_for(C, NB), kThreads, 0, s>>>(
        pp, Up, Vp, ap, yy, (T*)pre, (T*)maps, C, N, L, NB);
  else if (J == 2)
    kalman_fwd_kernel<T, 2><<<grid_for(C, NB), kThreads, 0, s>>>(
        pp, Up, Vp, ap, yy, (T*)pre, (T*)maps, C, N, L, NB);
  else if (J == 3)
    kalman_fwd_kernel<T, 3><<<grid_for(C, NB), kThreads, 0, s>>>(
        pp, Up, Vp, ap, yy, (T*)pre, (T*)maps, C, N, L, NB);
  else if (J == 4)
    kalman_fwd_kernel<T, 4><<<grid_for(C, NB), kThreads, 0, s>>>(
        pp, Up, Vp, ap, yy, (T*)pre, (T*)maps, C, N, L, NB);
  else
    return -1;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_solve(int J, const void* p, const void* U, const void* W,
                 const void* bz, void* pre, void* maps, int C, int N, int L,
                 cudaStream_t s) {
  const int NB = (N + L - 1) / L;
  const T *pp = (const T*)p, *Up = (const T*)U, *Wp = (const T*)W,
          *bp = (const T*)bz;
  if (J == 1)
    solve_rev_kernel<T, 1><<<grid_for(C, NB), kThreads, 0, s>>>(
        pp, Up, Wp, bp, (T*)pre, (T*)maps, C, N, L, NB);
  else if (J == 2)
    solve_rev_kernel<T, 2><<<grid_for(C, NB), kThreads, 0, s>>>(
        pp, Up, Wp, bp, (T*)pre, (T*)maps, C, N, L, NB);
  else if (J == 3)
    solve_rev_kernel<T, 3><<<grid_for(C, NB), kThreads, 0, s>>>(
        pp, Up, Wp, bp, (T*)pre, (T*)maps, C, N, L, NB);
  else if (J == 4)
    solve_rev_kernel<T, 4><<<grid_for(C, NB), kThreads, 0, s>>>(
        pp, Up, Wp, bp, (T*)pre, (T*)maps, C, N, L, NB);
  else
    return -1;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_factor(int J, const void* p, const void* U, const void* W,
                  const void* bv0, const void* bdp, void* pre, void* maps,
                  int C, int N, int L, cudaStream_t s) {
  const int NB = (N + L - 1) / L;
  const T *pp = (const T*)p, *Up = (const T*)U, *Wp = (const T*)W,
          *gp = (const T*)bv0, *dp = (const T*)bdp;
  if (J == 1)
    factor_rev_kernel<T, 1><<<grid_for(C, NB), kThreads, 0, s>>>(
        pp, Up, Wp, gp, dp, (T*)pre, (T*)maps, C, N, L, NB);
  else if (J == 2)
    factor_rev_kernel<T, 2><<<grid_for(C, NB), kThreads, 0, s>>>(
        pp, Up, Wp, gp, dp, (T*)pre, (T*)maps, C, N, L, NB);
  else
    return -1;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_frev_maps(int J, const void* p, const void* U, const void* W,
                     const void* bv0, const void* bdp, void* maps, int C,
                     int N, int L, cudaStream_t s) {
  const int NB = (N + L - 1) / L;
  const T *pp = (const T*)p, *Up = (const T*)U, *Wp = (const T*)W,
          *gp = (const T*)bv0, *dp = (const T*)bdp;
  const dim3 grid((unsigned)((long long)C * NB));  // one warp per block
  if (J == 1)
    frev_maps_kernel<T, 1><<<grid, kThreads, 0, s>>>(pp, Up, Wp, gp, dp,
                                                     (T*)maps, C, N, L, NB);
  else if (J == 2)
    frev_maps_kernel<T, 2><<<grid, kThreads, 0, s>>>(pp, Up, Wp, gp, dp,
                                                     (T*)maps, C, N, L, NB);
  else if (J == 3)
    frev_maps_kernel<T, 3><<<grid, kThreads, 0, s>>>(pp, Up, Wp, gp, dp,
                                                     (T*)maps, C, N, L, NB);
  else if (J == 4)
    frev_maps_kernel<T, 4><<<grid, kThreads, 0, s>>>(pp, Up, Wp, gp, dp,
                                                     (T*)maps, C, N, L, NB);
  else
    return -1;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_frev_states(int J, const void* p, const void* U, const void* W,
                       const void* bv0, const void* bdp, const void* seeds,
                       void* out, int C, int N, int L, cudaStream_t s) {
  const int NB = (N + L - 1) / L;
  const T *pp = (const T*)p, *Up = (const T*)U, *Wp = (const T*)W,
          *gp = (const T*)bv0, *dp = (const T*)bdp, *sp = (const T*)seeds;
  if (J == 1)
    frev_states_kernel<T, 1><<<grid_for(C, NB), kThreads, 0, s>>>(
        pp, Up, Wp, gp, dp, sp, (T*)out, C, N, L, NB);
  else if (J == 2)
    frev_states_kernel<T, 2><<<grid_for(C, NB), kThreads, 0, s>>>(
        pp, Up, Wp, gp, dp, sp, (T*)out, C, N, L, NB);
  else if (J == 3)
    frev_states_kernel<T, 3><<<grid_for(C, NB), kThreads, 0, s>>>(
        pp, Up, Wp, gp, dp, sp, (T*)out, C, N, L, NB);
  else if (J == 4)
    frev_states_kernel<T, 4><<<grid_for(C, NB), kThreads, 0, s>>>(
        pp, Up, Wp, gp, dp, sp, (T*)out, C, N, L, NB);
  else
    return -1;
  return (int)cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------ C interface
//
// Every function launches on ``stream`` and returns cudaGetLastError()
// after the launch (0 on success), or -1 for an unsupported J (K1, K2, K4,
// K5: 1..4; K3: 1, 2).  Pointers are to contiguous device arrays of the
// scalar type given by ``is_double``; shapes are (C, N, J) for per-row
// vectors, (C, N) for per-row scalars, (C, N, E) for ``pre``,
// (C, ceil(N / L), E) for ``maps``, (C, ceil(N / L), J^2) for ``seeds`` and
// (C, N, J^2) for ``out``.

extern "C" {

int c2t_kalman_fwd(int is_double, int J, const void* p, const void* U,
                   const void* V, const void* ainv, const void* y, void* pre,
                   void* maps, int C, int N, int L, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_double
             ? launch_kalman<double>(J, p, U, V, ainv, y, pre, maps, C, N, L, s)
             : launch_kalman<float>(J, p, U, V, ainv, y, pre, maps, C, N, L, s);
}

int c2t_solve_rev(int is_double, int J, const void* p, const void* U,
                  const void* W, const void* bz, void* pre, void* maps, int C,
                  int N, int L, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_double
             ? launch_solve<double>(J, p, U, W, bz, pre, maps, C, N, L, s)
             : launch_solve<float>(J, p, U, W, bz, pre, maps, C, N, L, s);
}

int c2t_factor_rev(int is_double, int J, const void* p, const void* U,
                   const void* W, const void* bv0, const void* bdp, void* pre,
                   void* maps, int C, int N, int L, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_double ? launch_factor<double>(J, p, U, W, bv0, bdp, pre, maps, C,
                                           N, L, s)
                   : launch_factor<float>(J, p, U, W, bv0, bdp, pre, maps, C,
                                          N, L, s);
}

int c2t_frev_maps(int is_double, int J, const void* p, const void* U,
                  const void* W, const void* bv0, const void* bdp, void* maps,
                  int C, int N, int L, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_double ? launch_frev_maps<double>(J, p, U, W, bv0, bdp, maps, C,
                                              N, L, s)
                   : launch_frev_maps<float>(J, p, U, W, bv0, bdp, maps, C,
                                             N, L, s);
}

int c2t_frev_states(int is_double, int J, const void* p, const void* U,
                    const void* W, const void* bv0, const void* bdp,
                    const void* seeds, void* out, int C, int N, int L,
                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_double ? launch_frev_states<double>(J, p, U, W, bv0, bdp, seeds,
                                                out, C, N, L, s)
                   : launch_frev_states<float>(J, p, U, W, bv0, bdp, seeds,
                                               out, C, N, L, s);
}

}  // extern "C"
