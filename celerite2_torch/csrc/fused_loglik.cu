// The three scan passes of the fused GP log-likelihood (value + gradient),
// written for Hopper (sm_90a).  Built with nvcc into a shared library with
// a plain C interface and bound with ctypes (celerite2_torch/ops/_build.py).
//
// Each pass runs the whole two-level scan over the rows of every chain on
// the card and returns the per-row states the log-likelihood and its
// gradient use: K1 (the Kalman forward) S and F, K2 (the solve adjoint) R,
// the factor adjoint MX, through K3 at J <= 2 and through K4 and K5 at
// J = 3, 4 (fused_slab.py:476-493).  See "K1, K2" and "K3, K4, K5" below.
//
// Elements are templated on the scalar type (float, double) and on the
// celerite width J (1..4; K3 1, 2 only); the formulas are the JAX
// package's (celerite2_tpu/ops/fused_slab.py builds, celerite2_tpu/ops/
// planes.py combines), operand order included.

#include <cuda_runtime.h>

#include <cfloat>

#include "device_common.cuh"

namespace {

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

// ========================== K1, K2: the Kalman forward and the solve adjoint
//
// K1 kalman_fwd replaces the Pallas kernel celerite2_tpu/ops/fused_slab.py:
// _scan_pass (pallas_call at :308, body _body :234) run forward with the
// element build _build_kalman (:388) and the kalman_spec combine
// (celerite2_tpu/ops/planes.py:358), together with the cross-block level and
// the distribute that the JAX package runs after it in XLA (fused_slab.py:
// 281-330).  It returns what the log-likelihood uses of the Kalman pass: for
// every row n the state after the elements of rows 0..n, the carry
// covariance S (C, N, J, J) and the solve state F (C, N, J).
//
// K2 solve_rev replaces the same _scan_pass run in reverse with the element
// build _build_solve_rev (:424) and the mat_affine_spec(J, 1) combine
// (planes.py:231), with its cross-block level: it returns the suffix state
// Rst (C, N, J), Rst_n = A_n Rst_{n+1} + b_n from Rst_N = 0.
//
// Each is a two-level scan over blocks of L rows (L is the wrapper's choice
// for this card, ops/_build.py), in three launches, two when the blocks fit
// one group of kWalks, one when the rows fit one block:
//   (a) maps:   each (chain, block) composes its rows' elements into the
//               block's map; each group of kWalks consecutive blocks of a
//               chain (one warp, one block a lane) then takes the prefix
//               (K1) or suffix (K2) of its blocks' maps over its lanes;
//   (b) scan:   one thread block per chain takes the exclusive prefix (K1)
//               or suffix (K2) of the groups' maps and writes the state
//               entering every group;
//   (c) states: each (chain, block) carries the state entering its group
//               through the group's blocks before it (one map), walks its
//               rows again from there and writes the state after every row.
//
// What bounds them on this card: each walk of (a) and (c) is a chain of L
// dependent row steps, and the levels above it chains of combines of whole
// maps: log2(kWalks) in (a), about 2 NB / (kWalks kScanThreads) +
// log2(kScanThreads) in (b), one in (c); the bytes (the rows read twice, the
// states written once) take a small fraction of that time.  So the rows are
// cut into many short blocks, one thread each, and
//   * a row step is rank one.  K1's element has Q = p v v^T p / a and
//     R = -u u^T / a (fused_slab._build_kalman), so composing it into a
//     running map (A, Q, R, b, eta) needs no J x J inverse (Sherman-Morrison
//     with the pivot d = a - u^T Q u):
//       x = Q u, g = A^T u, r = v - x, z = y - b^T u,
//       A <- p (A - r g^T / d),  Q <- p (Q + r r^T / d) p,
//       R <- R - g g^T / d,      b <- p (b + r z / d),  eta <- eta - g z / d,
//     and on a state (S, F) only the Q and b lines run, which are the
//     factor's and the lower solve's own row step: O(J^2) a row.  K2's
//     element is x <- p (x - u (w^T x + bZ)): O(J) a row on a state, O(J^2)
//     on a map;
//   * a warp is a thread block of kWalks walks, and the rows pass through
//     shared memory by tiles of kTile rows of every walk: the warp copies
//     each input's tile with cp.async one tile ahead of the walks,
//     consecutive lanes on consecutive rows of a walk, a lane a whole row
//     (copying value by value, each with its own index arithmetic, took
//     more instructions than the row step: PERF.md), and stores each output
//     from an output tile the same way;
//   * only the levels above the rows compose whole maps, K1's with the
//     general Kalman combine and the clamped closed-form inverse
//     inv_clamped above (the plain route's elements.inv_clamped,
//     planes.p_inv): a Kogge-Stone scan over the lanes of a group in (a),
//     and in (b) reduce-then-scan over the groups: each of kScanThreads
//     threads composes a run of consecutive groups' maps, a Kogge-Stone
//     scan in shared memory composes the runs, and each thread applies its
//     run's maps one by one to the state entering the run (the distribute,
//     which needs only S and F of that state).
// A pivot that is not positive (a system that is not positive definite) is
// taken as it is, as the plain route's combine takes it (inv_pivot below):
// the state then stays bounded and finite, the rows up to the first such
// pivot are those of the plain route, and the caller's check d > 0 decides
// (the quiet -inf).

constexpr int kWalks = 32;          // walks (one thread each) per block of (a), (c)
constexpr int kTile = 8;            // rows of every walk in a tile
constexpr int kPitch = kWalks + 1;  // a tile holds value f of row l of walk k
                                    // at (l * width + f) * kPitch + k
constexpr int kScanThreads = 128;   // threads of (b), one block per chain
static_assert(kWalks % kTile == 0, "a lane copies whole rows of a tile");
// The kernels ask for at least one block a multiprocessor in their launch
// bounds: without it ptxas held K1's map kernel to 128 registers, and at
// J = 3 in float64 it spilled.

template <typename T, int J>
__device__ __forceinline__ void mat_load(const T* src, T (&X)[J][J]) {
#pragma unroll
  for (int i = 0; i < J; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) X[i][j] = src[i * J + j];
}

// The walks of one thread block of (a) or (c), a group of kWalks
// consecutive blocks of one chain: lane k walks block group * kWalks + k,
// the rows [n0, n0 + len[k]) of the chain, whose first row is row start[k]
// of the (C * N)-row arrays; lanes past the chain's last block have len 0.
struct Walk {
  long long chain;
  int group, block, n0;
};

__device__ __forceinline__ Walk walk_setup(int N, int L, int NB,
                                           long long* start, int* len) {
  const int lane = threadIdx.x;
  const int GB = (NB + kWalks - 1) / kWalks;
  Walk w;
  w.chain = blockIdx.x / GB;
  w.group = blockIdx.x % GB;
  w.block = w.group * kWalks + lane;
  const bool live = w.block < NB;
  w.n0 = live ? w.block * L : 0;
  start[lane] = w.chain * N + w.n0;
  len[lane] = live ? min(L, N - w.n0) : 0;
  __syncwarp();
  return w;
}

// Copies rows [s kTile, (s + 1) kTile) of every walk of X (W values a row)
// into values [OFF, OFF + W) of the tile's rows of WIDTH values (rows past a
// walk's end are skipped).  Thread j of the NT copying copies row j % kTile
// of the walks j / kTile, j / kTile + NT / kTile, ...: the index arithmetic
// is paid once a row, not once a value.
template <int W, int OFF, int WIDTH, int NT = kWalks, typename T>
__device__ __forceinline__ void stage(T* tile, const T* __restrict__ X,
                                      const long long* start, const int* len,
                                      int s) {
  static_assert(NT % kTile == 0, "a thread copies whole rows of a tile");
  const int l = threadIdx.x % kTile, n = s * kTile + l;
#pragma unroll
  for (int k = threadIdx.x / kTile; k < kWalks; k += NT / kTile) {
    if (n < len[k]) {
      const T* src = X + (start[k] + n) * W;
      T* dst = tile + (l * WIDTH + OFF) * kPitch + k;
#pragma unroll
      for (int f = 0; f < W; ++f) cp_async_elem(dst + f * kPitch, src + f);
    }
  }
}

// Stores values [OFF, OFF + W) of the output tile's rows of WIDTH values
// into rows [s kTile, (s + 1) kTile) of every walk of X (W values a row),
// the lanes taking the rows as stage() does.
template <int W, int OFF, int WIDTH, typename T>
__device__ __forceinline__ void unstage(T* __restrict__ X, const T* tile,
                                        const long long* start,
                                        const int* len, int s) {
  const int l = threadIdx.x % kTile, n = s * kTile + l;
#pragma unroll
  for (int k = threadIdx.x / kTile; k < kWalks; k += kWalks / kTile) {
    if (n < len[k]) {
      T* dst = X + (start[k] + n) * W;
      const T* src = tile + (l * WIDTH + OFF) * kPitch + k;
#pragma unroll
      for (int f = 0; f < W; ++f) dst[f] = src[f * kPitch];
    }
  }
}

// dynamic shared memory of a walk kernel: two input tiles, one output tile
template <typename T>
constexpr size_t walk_smem(int in_width, int out_width) {
  return (size_t)kTile * kPitch * (2 * in_width + out_width) * sizeof(T);
}

// The reciprocal 1 / d of a row's pivot d = 1 / ainv - s = a - u^T S u, as
// the plain route's combine takes it: d / a is the determinant of
// I + S R = I - S u u^T / a, which planes._det2_clamped floors in magnitude
// at eps (1 + |s / a|) + tiny, keeping its sign.  Row 0's element
// (ainv = 0) gives 0.
template <typename T>
__device__ __forceinline__ T inv_pivot(T ainv, T s) {
  const T as = ainv * s;
  T den = T(1) - as;
  const T floor = Limits<T>::eps() * (T(1) + absval(as)) + Limits<T>::tiny();
  if (!(absval(den) >= floor)) den = den < T(0) ? -floor : floor;
  return ainv / den;
}

// ---------------------------------------------- the block maps' algebra

// K1's block maps: (A, Q, R, b, eta) flat, acting on the state (S, F).
template <typename T, int J>
struct KalmanMaps {
  static constexpr int E = 3 * J * J + 2 * J;
  static constexpr int ST = J * J + J;
  static constexpr bool kReverse = false;

  __device__ static void identity(T* m) {
    for (int k = 0; k < E; ++k)
      m[k] = (k < J * J && k / J == k % J) ? T(1) : T(0);
  }

  // the map's state from zero: (Q, b)
  __device__ static void state_of(const T* m, T (&st)[ST]) {
#pragma unroll
    for (int k = 0; k < J * J; ++k) st[k] = m[J * J + k];
#pragma unroll
    for (int i = 0; i < J; ++i) st[J * J + i] = m[3 * J * J + i];
  }

  // x earlier, y later: elements.kalman_combine, operand order included
  __device__ static void combine(const T* x, const T* y, T* out) {
    constexpr int JJ = J * J;
    const T *A1 = x, *Q1 = x + JJ, *R1 = x + 2 * JJ, *b1 = x + 3 * JJ,
            *e1 = x + 3 * JJ + J;
    const T *A2 = y, *Q2 = y + JJ, *R2 = y + 2 * JJ, *b2 = y + 3 * JJ,
            *e2 = y + 3 * JJ + J;
    T G[J][J];  // (I + Q1 R2)^{-1}
    {
      T M[J][J];
#pragma unroll
      for (int i = 0; i < J; ++i)
#pragma unroll
        for (int j = 0; j < J; ++j) {
          T s = T(0);
#pragma unroll
          for (int k = 0; k < J; ++k) s += Q1[i * J + k] * R2[k * J + j];
          M[i][j] = (i == j ? T(1) : T(0)) + s;
        }
      inv_clamped<T, J>(M, G);
    }
    {  // b12 = b2 + A2 (G (b1 + Q1 eta2))
      T t[J], g[J];
#pragma unroll
      for (int i = 0; i < J; ++i) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < J; ++k) s += Q1[i * J + k] * e2[k];
        t[i] = b1[i] + s;
      }
#pragma unroll
      for (int i = 0; i < J; ++i) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < J; ++k) s += G[i][k] * t[k];
        g[i] = s;
      }
#pragma unroll
      for (int i = 0; i < J; ++i) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < J; ++k) s += A2[i * J + k] * g[k];
        out[3 * JJ + i] = b2[i] + s;
      }
    }
    T RG[J][J];  // R2 G
#pragma unroll
    for (int i = 0; i < J; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < J; ++k) s += R2[i * J + k] * G[k][j];
        RG[i][j] = s;
      }
    {  // eta12 = eta1 + A1^T (vE - R2G (Q1 vE)),  vE = eta2 - R2 b1
      T vE[J], q[J], h[J];
#pragma unroll
      for (int i = 0; i < J; ++i) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < J; ++k) s += R2[i * J + k] * b1[k];
        vE[i] = e2[i] - s;
      }
#pragma unroll
      for (int i = 0; i < J; ++i) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < J; ++k) s += Q1[i * J + k] * vE[k];
        q[i] = s;
      }
#pragma unroll
      for (int i = 0; i < J; ++i) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < J; ++k) s += RG[i][k] * q[k];
        h[i] = vE[i] - s;
      }
#pragma unroll
      for (int i = 0; i < J; ++i) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < J; ++k) s += A1[k * J + i] * h[k];
        out[3 * JJ + J + i] = e1[i] + s;
      }
    }
    {  // A12 = A2 (G A1)
      T A1r[J][J], GA[J][J];
      mat_load(A1, A1r);
      matmul(G, A1r, GA);
#pragma unroll
      for (int i = 0; i < J; ++i)
#pragma unroll
        for (int j = 0; j < J; ++j) {
          T s = T(0);
#pragma unroll
          for (int k = 0; k < J; ++k) s += A2[i * J + k] * GA[k][j];
          out[i * J + j] = s;
        }
    }
    {  // Q12 = sym(Q2 + (A2 (G Q1)) A2^T)
      T Q1r[J][J], A2r[J][J], GQ[J][J], AG[J][J], Q12[J][J];
      mat_load(Q1, Q1r);
      mat_load(A2, A2r);
      matmul(G, Q1r, GQ);
      matmul(A2r, GQ, AG);
#pragma unroll
      for (int i = 0; i < J; ++i)
#pragma unroll
        for (int j = 0; j < J; ++j) {
          T s = T(0);
#pragma unroll
          for (int k = 0; k < J; ++k) s += AG[i][k] * A2r[j][k];
          Q12[i][j] = Q2[i * J + j] + s;
        }
#pragma unroll
      for (int i = 0; i < J; ++i)
#pragma unroll
        for (int j = 0; j < J; ++j)
          out[JJ + i * J + j] = T(0.5) * (Q12[i][j] + Q12[j][i]);
    }
    {  // R12 = sym(R1 + (A1^T R2G) A1)
      T ARG[J][J], R12[J][J];
#pragma unroll
      for (int i = 0; i < J; ++i)
#pragma unroll
        for (int j = 0; j < J; ++j) {
          T s = T(0);
#pragma unroll
          for (int k = 0; k < J; ++k) s += A1[k * J + i] * RG[k][j];
          ARG[i][j] = s;
        }
#pragma unroll
      for (int i = 0; i < J; ++i)
#pragma unroll
        for (int j = 0; j < J; ++j) {
          T s = T(0);
#pragma unroll
          for (int k = 0; k < J; ++k) s += ARG[i][k] * A1[k * J + j];
          R12[i][j] = R1[i * J + j] + s;
        }
#pragma unroll
      for (int i = 0; i < J; ++i)
#pragma unroll
        for (int j = 0; j < J; ++j)
          out[2 * JJ + i * J + j] = T(0.5) * (R12[i][j] + R12[j][i]);
    }
  }

  // the state after the map m (elements.kalman_distribute):
  //   S <- sym(Q + A G S A^T),  F <- b + A G (F + S eta),  G = (I + S R)^{-1}
  __device__ static void apply(const T* m, T (&st)[ST]) {
    constexpr int JJ = J * J;
    const T *A = m, *Q = m + JJ, *R = m + 2 * JJ, *b = m + 3 * JJ,
            *e = m + 3 * JJ + J;
    T G[J][J];
    {
      T M[J][J];
#pragma unroll
      for (int i = 0; i < J; ++i)
#pragma unroll
        for (int j = 0; j < J; ++j) {
          T s = T(0);
#pragma unroll
          for (int k = 0; k < J; ++k) s += st[i * J + k] * R[k * J + j];
          M[i][j] = (i == j ? T(1) : T(0)) + s;
        }
      inv_clamped<T, J>(M, G);
    }
    T g[J];  // G (F + S eta)
    {
      T t[J];
#pragma unroll
      for (int i = 0; i < J; ++i) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < J; ++k) s += st[i * J + k] * e[k];
        t[i] = st[JJ + i] + s;
      }
#pragma unroll
      for (int i = 0; i < J; ++i) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < J; ++k) s += G[i][k] * t[k];
        g[i] = s;
      }
    }
    T Sm[J][J], Ar[J][J], GS[J][J], AG[J][J], S2[J][J];
#pragma unroll
    for (int i = 0; i < J; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) Sm[i][j] = st[i * J + j];
    mat_load(A, Ar);
    matmul(G, Sm, GS);
    matmul(Ar, GS, AG);
#pragma unroll
    for (int i = 0; i < J; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < J; ++k) s += AG[i][k] * Ar[j][k];
        S2[i][j] = Q[i * J + j] + s;
      }
#pragma unroll
    for (int i = 0; i < J; ++i) {
#pragma unroll
      for (int j = 0; j < J; ++j)
        st[i * J + j] = T(0.5) * (S2[i][j] + S2[j][i]);
      T s = T(0);
#pragma unroll
      for (int k = 0; k < J; ++k) s += Ar[i][k] * g[k];
      st[JJ + i] = b[i] + s;
    }
  }
};

// K2's block maps: x -> A x + b, (A row-major J x J, b) flat, composed from
// the last block down (a suffix).
template <typename T, int J>
struct AffineMaps {
  static constexpr int E = J * J + J;
  static constexpr int ST = J;
  static constexpr bool kReverse = true;

  __device__ static void identity(T* m) {
    for (int k = 0; k < E; ++k)
      m[k] = (k < J * J && k / J == k % J) ? T(1) : T(0);
  }

  __device__ static void state_of(const T* m, T (&st)[ST]) {
#pragma unroll
    for (int i = 0; i < J; ++i) st[i] = m[J * J + i];
  }

  // x earlier, y later: (A2 A1, A2 b1 + b2) (elements.affine_combine)
  __device__ static void combine(const T* x, const T* y, T* out) {
#pragma unroll
    for (int i = 0; i < J; ++i) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < J; ++k) s += y[i * J + k] * x[k * J + j];
        out[i * J + j] = s;
      }
      T s = T(0);
#pragma unroll
      for (int k = 0; k < J; ++k) s += y[i * J + k] * x[J * J + k];
      out[J * J + i] = s + y[J * J + i];
    }
  }

  __device__ static void apply(const T* m, T (&st)[ST]) {
    T o[J];
#pragma unroll
    for (int i = 0; i < J; ++i) {
      T s = T(0);
#pragma unroll
      for (int k = 0; k < J; ++k) s += m[i * J + k] * st[k];
      o[i] = s + m[J * J + i];
    }
#pragma unroll
    for (int i = 0; i < J; ++i) st[i] = o[i];
  }
};

// The inclusive prefix (M::kReverse: suffix) of the warp's kWalks block
// maps over its lanes (Kogge-Stone, five levels of combines), in shared
// memory: lane k's map in slots[k E, (k + 1) E), scratch of the same size
// after it.  Returns the slots that hold the result.
template <typename T, class M>
__device__ __forceinline__ T* warp_scan(T* slots) {
  constexpr int E = M::E;
  const int lane = threadIdx.x;
  T* src = slots;
  T* dst = slots + kWalks * E;
  for (int d = 1; d < kWalks; d *= 2) {
    const int from = M::kReverse ? lane + d : lane - d;
    if (from >= 0 && from < kWalks)
      M::combine(src + from * E, src + lane * E, dst + lane * E);
    else
      for (int k = 0; k < E; ++k) dst[lane * E + k] = src[lane * E + k];
    __syncwarp();
    T* t = src;
    src = dst;
    dst = t;
  }
  return src;
}

// The end of phase (a): the warp's block maps (``acc`` stored by each lane
// into ``slots``) scanned over the lanes; each live walk's prefix goes to
// ``maps`` (C, NB, E), the group's whole composition to ``groups``
// (C, GB, E).
template <typename T, class M>
__device__ __forceinline__ void store_group(T* slots, const Walk& w, int NB,
                                            int GB, bool live,
                                            T* __restrict__ maps,
                                            T* __restrict__ groups) {
  constexpr int E = M::E;
  const int lane = threadIdx.x;
  __syncwarp();
  const T* pre = warp_scan<T, M>(slots) + lane * E;
  if (live) {
    T* o = maps + (w.chain * NB + w.block) * E;
    for (int k = 0; k < E; ++k) o[k] = pre[k];
  }
  if (lane == (M::kReverse ? 0 : kWalks - 1)) {
    T* o = groups + (w.chain * GB + w.group) * E;
    for (int k = 0; k < E; ++k) o[k] = pre[k];
  }
}

// The state entering a walk in phase (c): the state entering its group
// (``gstates``, (C, GB, ST); zero when null), carried through the prefix
// (suffix) of the blocks before it in the group (``maps``).
template <typename T, class M>
__device__ __forceinline__ void walk_entry(const T* __restrict__ maps,
                                           const T* __restrict__ gstates,
                                           const Walk& w, int NB, int GB,
                                           T (&st)[M::ST]) {
  const T* g = gstates != nullptr ? gstates + (w.chain * GB + w.group) * M::ST
                                  : nullptr;
#pragma unroll
  for (int k = 0; k < M::ST; ++k) st[k] = g ? g[k] : T(0);
  const int lane = threadIdx.x;
  const int before = M::kReverse ? w.block + 1 : w.block - 1;
  const bool inside = M::kReverse ? lane + 1 < kWalks && before < NB : lane > 0;
  if (inside && w.block < NB) M::apply(maps + (w.chain * NB + before) * M::E, st);
}

// ---------------------------------------------------------------- K1

// the values of a row in K1's input tiles: p, u, v, 1/a, y
template <int J>
struct KIn {
  static constexpr int P = 0, U = J, V = 2 * J, AI = 3 * J, Y = 3 * J + 1,
                       W = 3 * J + 2;
};

template <typename T, int J>
__device__ __forceinline__ void kalman_stage(T* tile, const T* p, const T* U,
                                             const T* V, const T* ainv,
                                             const T* y, const long long* start,
                                             const int* len, int s) {
  using I = KIn<J>;
  stage<J, I::P, I::W>(tile, p, start, len, s);
  stage<J, I::U, I::W>(tile, U, start, len, s);
  stage<J, I::V, I::W>(tile, V, start, len, s);
  stage<1, I::AI, I::W>(tile, ainv, start, len, s);
  stage<1, I::Y, I::W>(tile, y, start, len, s);
  cp_async_commit();
}

// The data of row r (u, v, 1/a, y) that builds the next row's element.
template <typename T, int J>
struct KRow {
  T u[J], v[J], ai, y;
  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < J; ++j) u[j] = v[j] = T(0);
    ai = y = T(0);
  }
  __device__ void load(const T* U, const T* V, const T* ainv, const T* Y,
                       long long r) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      u[j] = U[r * J + j];
      v[j] = V[r * J + j];
    }
    ai = ainv[r];
    y = Y[r];
  }
  // from a tile; x points at value 0 of the row of this lane's walk
  __device__ void load_tile(const T* x) {
    using I = KIn<J>;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      u[j] = x[(I::U + j) * kPitch];
      v[j] = x[(I::V + j) * kPitch];
    }
    ai = x[I::AI * kPitch];
    y = x[I::Y * kPitch];
  }
};

// The running map (A, Q, R, b, eta) of phase (a), composed with the element
// of one row: p of that row, (u, v, 1/a, y) of the row before.  Q and R stay
// symmetric: each pair of entries is updated once.
template <typename T, int J>
struct KMap {
  T A[J][J], Q[J][J], R[J][J], b[J], e[J];

  __device__ void identity() {
#pragma unroll
    for (int i = 0; i < J; ++i) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        A[i][j] = i == j ? T(1) : T(0);
        Q[i][j] = R[i][j] = T(0);
      }
      b[i] = e[i] = T(0);
    }
  }

  __device__ void step(const T (&p)[J], const KRow<T, J>& w) {
    T x[J], g[J], r[J];
    T s = T(0), z = w.y;
#pragma unroll
    for (int i = 0; i < J; ++i) {
      T xi = T(0), gi = T(0);
#pragma unroll
      for (int k = 0; k < J; ++k) {
        xi += Q[i][k] * w.u[k];
        gi += A[k][i] * w.u[k];
      }
      x[i] = xi;
      g[i] = gi;
    }
#pragma unroll
    for (int i = 0; i < J; ++i) {
      s += w.u[i] * x[i];
      z -= b[i] * w.u[i];
      r[i] = w.v[i] - x[i];
    }
    const T inv = inv_pivot(w.ai, s);
#pragma unroll
    for (int i = 0; i < J; ++i) {
      const T ri = inv * r[i], gi = inv * g[i];
#pragma unroll
      for (int j = 0; j < J; ++j) A[i][j] = p[i] * (A[i][j] - ri * g[j]);
#pragma unroll
      for (int j = i; j < J; ++j) {
        Q[i][j] = (p[i] * p[j]) * (Q[i][j] + ri * r[j]);
        Q[j][i] = Q[i][j];
        R[i][j] = R[i][j] - gi * g[j];
        R[j][i] = R[i][j];
      }
      b[i] = p[i] * (b[i] + ri * z);
      e[i] = e[i] - gi * z;
    }
  }

  // flat order A, Q, R (row-major J x J), b, eta
  __device__ void store(T* out) const {
#pragma unroll
    for (int i = 0; i < J; ++i) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        out[i * J + j] = A[i][j];
        out[J * J + i * J + j] = Q[i][j];
        out[2 * J * J + i * J + j] = R[i][j];
      }
      out[3 * J * J + i] = b[i];
      out[3 * J * J + J + i] = e[i];
    }
  }
};

// The state (S, F) of phase (c) after the element of one row: the Cholesky
// step S <- p (S + r r^T / d) p, F <- p (F + r z / d), r = v - S u,
// z = y - u^T F.
template <typename T, int J>
__device__ __forceinline__ void kalman_state_step(T (&S)[J][J], T (&F)[J],
                                                  const T (&p)[J],
                                                  const KRow<T, J>& w) {
  T x[J];
  T s = T(0), z = w.y;
#pragma unroll
  for (int i = 0; i < J; ++i) {
    T xi = T(0);
#pragma unroll
    for (int k = 0; k < J; ++k) xi += S[i][k] * w.u[k];
    x[i] = xi;
  }
#pragma unroll
  for (int i = 0; i < J; ++i) {
    s += w.u[i] * x[i];
    z -= F[i] * w.u[i];
  }
  const T inv = inv_pivot(w.ai, s);
#pragma unroll
  for (int i = 0; i < J; ++i) {
    const T ri = inv * (w.v[i] - x[i]);
#pragma unroll
    for (int j = i; j < J; ++j) {
      S[i][j] = (p[i] * p[j]) * (S[i][j] + ri * (w.v[j] - x[j]));
      S[j][i] = S[i][j];
    }
    F[i] = p[i] * (F[i] + ri * z);
  }
}

template <typename T, int J>
__global__ void __launch_bounds__(kWalks, 1)
    kalman_maps_kernel(const T* __restrict__ p, const T* __restrict__ U,
                       const T* __restrict__ V, const T* __restrict__ ainv,
                       const T* __restrict__ y, T* __restrict__ maps,
                       T* __restrict__ groups, int N, int L, int NB, int GB) {
  using I = KIn<J>;
  using M = KalmanMaps<T, J>;
  constexpr int TILE = kTile * I::W * kPitch;
  static_assert(2 * kWalks * M::E <= 2 * TILE, "the scan fits the tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tiles = reinterpret_cast<T*>(smem_raw);
  __shared__ long long start[kWalks];
  __shared__ int len[kWalks];
  const Walk w = walk_setup(N, L, NB, start, len);
  const int lane = threadIdx.x;
  const int mine = len[lane];

  KRow<T, J> prev;  // row n0 - 1 builds row n0's element; row 0 has none
  prev.zero();
  if (mine > 0 && w.n0 > 0) prev.load(U, V, ainv, y, start[lane] - 1);
  KMap<T, J> acc;
  acc.identity();

  const int ntiles = (min(L, N) + kTile - 1) / kTile;
  kalman_stage<T, J>(tiles, p, U, V, ainv, y, start, len, 0);
  for (int s = 0; s < ntiles; ++s) {
    if (s + 1 < ntiles) {
      kalman_stage<T, J>(tiles + ((s + 1) & 1) * TILE, p, U, V, ainv, y,
                         start, len, s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const T* tile = tiles + (s & 1) * TILE + lane;
#pragma unroll 1
    for (int l = 0; l < kTile && s * kTile + l < mine; ++l) {
      const T* x = tile + l * I::W * kPitch;
      T pr[J];
#pragma unroll
      for (int j = 0; j < J; ++j) pr[j] = x[(I::P + j) * kPitch];
      acc.step(pr, prev);
      prev.load_tile(x);
    }
    __syncwarp();
  }
  // the group's prefix maps, in the tiles (every lane is done with them)
  acc.store(tiles + lane * M::E);
  store_group<T, M>(tiles, w, NB, GB, w.block < NB, maps, groups);
}

template <typename T, int J>
__global__ void __launch_bounds__(kWalks, 1)
    kalman_states_kernel(const T* __restrict__ p, const T* __restrict__ U,
                         const T* __restrict__ V, const T* __restrict__ ainv,
                         const T* __restrict__ y, const T* __restrict__ maps,
                         const T* __restrict__ gstates, T* __restrict__ S,
                         T* __restrict__ F, int N, int L, int NB, int GB) {
  using I = KIn<J>;
  constexpr int TILE = kTile * I::W * kPitch;
  constexpr int OUT = J * J + J;  // S, F of a row in the output tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tiles = reinterpret_cast<T*>(smem_raw);
  T* out = tiles + 2 * TILE;
  __shared__ long long start[kWalks];
  __shared__ int len[kWalks];
  const Walk w = walk_setup(N, L, NB, start, len);
  const int lane = threadIdx.x;
  const int mine = len[lane];

  KRow<T, J> prev;
  prev.zero();
  if (mine > 0 && w.n0 > 0) prev.load(U, V, ainv, y, start[lane] - 1);
  T Sm[J][J], Fv[J];  // the state entering the block (zero for the first)
  {
    T st[OUT];
    walk_entry<T, KalmanMaps<T, J>>(maps, gstates, w, NB, GB, st);
#pragma unroll
    for (int i = 0; i < J; ++i) {
#pragma unroll
      for (int j = 0; j < J; ++j) Sm[i][j] = st[i * J + j];
      Fv[i] = st[J * J + i];
    }
  }

  const int ntiles = (min(L, N) + kTile - 1) / kTile;
  kalman_stage<T, J>(tiles, p, U, V, ainv, y, start, len, 0);
  for (int s = 0; s < ntiles; ++s) {
    if (s + 1 < ntiles) {
      kalman_stage<T, J>(tiles + ((s + 1) & 1) * TILE, p, U, V, ainv, y,
                         start, len, s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const T* tile = tiles + (s & 1) * TILE + lane;
#pragma unroll 1
    for (int l = 0; l < kTile && s * kTile + l < mine; ++l) {
      const T* x = tile + l * I::W * kPitch;
      T pr[J];
#pragma unroll
      for (int j = 0; j < J; ++j) pr[j] = x[(I::P + j) * kPitch];
      kalman_state_step(Sm, Fv, pr, prev);
      prev.load_tile(x);
      T* o = out + l * OUT * kPitch + lane;
#pragma unroll
      for (int i = 0; i < J; ++i) {
#pragma unroll
        for (int j = 0; j < J; ++j) o[(i * J + j) * kPitch] = Sm[i][j];
        o[(J * J + i) * kPitch] = Fv[i];
      }
    }
    __syncwarp();
    unstage<J * J, 0, OUT>(S, out, start, len, s);
    unstage<J, J * J, OUT>(F, out, start, len, s);
    __syncwarp();
  }
}

// ---------------------------------------------------------------- K2

// the values of a row in K2's input tiles: p, u, w, bZ
template <int J>
struct RIn {
  static constexpr int P = 0, U = J, W = 2 * J, BZ = 3 * J, WIDTH = 3 * J + 1;
};

template <typename T, int J>
__device__ __forceinline__ void solve_stage(T* tile, const T* p, const T* U,
                                            const T* W, const T* bz,
                                            const long long* start,
                                            const int* len, int s) {
  using I = RIn<J>;
  stage<J, I::P, I::WIDTH>(tile, p, start, len, s);
  stage<J, I::U, I::WIDTH>(tile, U, start, len, s);
  stage<J, I::W, I::WIDTH>(tile, W, start, len, s);
  stage<1, I::BZ, I::WIDTH>(tile, bz, start, len, s);
  cp_async_commit();
}

// One row's parameters from the tile (x at value 0 of the row of this
// lane's walk); u = 0 at row 0 of a chain (the identity step).
template <typename T, int J>
__device__ __forceinline__ void solve_row(const T* x, bool row0, T (&p)[J],
                                          T (&u)[J], T (&w)[J], T& bz) {
  using I = RIn<J>;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    p[j] = x[(I::P + j) * kPitch];
    u[j] = row0 ? T(0) : x[(I::U + j) * kPitch];
    w[j] = x[(I::W + j) * kPitch];
  }
  bz = x[I::BZ * kPitch];
}

// x <- p (x - u (w^T x + c)) for every column of the running map (c = 0)
// and its constant (c = bZ)
template <typename T, int J>
__global__ void __launch_bounds__(kWalks, 1)
    solve_maps_kernel(const T* __restrict__ p, const T* __restrict__ U,
                      const T* __restrict__ W, const T* __restrict__ bz,
                      T* __restrict__ maps, T* __restrict__ groups, int N,
                      int L, int NB, int GB) {
  using I = RIn<J>;
  using M = AffineMaps<T, J>;
  constexpr int TILE = kTile * I::WIDTH * kPitch;
  static_assert(2 * kWalks * M::E <= 2 * TILE, "the scan fits the tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tiles = reinterpret_cast<T*>(smem_raw);
  __shared__ long long start[kWalks];
  __shared__ int len[kWalks];
  const Walk wk = walk_setup(N, L, NB, start, len);
  const int n0 = wk.n0;
  const int lane = threadIdx.x;
  const int mine = len[lane];

  T A[J][J], c[J];
#pragma unroll
  for (int i = 0; i < J; ++i) {
#pragma unroll
    for (int j = 0; j < J; ++j) A[i][j] = i == j ? T(1) : T(0);
    c[i] = T(0);
  }

  const int ntiles = (min(L, N) + kTile - 1) / kTile;
  solve_stage<T, J>(tiles + ((ntiles - 1) & 1) * TILE, p, U, W, bz, start, len,
                    ntiles - 1);
  for (int s = ntiles - 1; s >= 0; --s) {
    if (s > 0) {
      solve_stage<T, J>(tiles + ((s - 1) & 1) * TILE, p, U, W, bz, start, len,
                        s - 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const T* tile = tiles + (s & 1) * TILE + lane;
#pragma unroll 1
    for (int l = min(kTile, mine - s * kTile) - 1; l >= 0; --l) {
      T pr[J], u[J], w[J], b;
      solve_row<T, J>(tile + l * I::WIDTH * kPitch, n0 + s * kTile + l == 0,
                      pr, u, w, b);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        T t = T(0);
#pragma unroll
        for (int i = 0; i < J; ++i) t += w[i] * A[i][j];
#pragma unroll
        for (int i = 0; i < J; ++i) A[i][j] = pr[i] * (A[i][j] - u[i] * t);
      }
      T t = b;
#pragma unroll
      for (int i = 0; i < J; ++i) t += w[i] * c[i];
#pragma unroll
      for (int i = 0; i < J; ++i) c[i] = pr[i] * (c[i] - u[i] * t);
    }
    __syncwarp();
  }
  // the group's suffix maps, in the tiles (every lane is done with them)
  T* o = tiles + lane * M::E;
#pragma unroll
  for (int i = 0; i < J; ++i) {
#pragma unroll
    for (int j = 0; j < J; ++j) o[i * J + j] = A[i][j];
    o[J * J + i] = c[i];
  }
  store_group<T, M>(tiles, wk, NB, GB, wk.block < NB, maps, groups);
}

template <typename T, int J>
__global__ void __launch_bounds__(kWalks, 1)
    solve_states_kernel(const T* __restrict__ p, const T* __restrict__ U,
                        const T* __restrict__ W, const T* __restrict__ bz,
                        const T* __restrict__ maps,
                        const T* __restrict__ gstates, T* __restrict__ R,
                        int N, int L, int NB, int GB) {
  using I = RIn<J>;
  constexpr int TILE = kTile * I::WIDTH * kPitch;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tiles = reinterpret_cast<T*>(smem_raw);
  T* out = tiles + 2 * TILE;
  __shared__ long long start[kWalks];
  __shared__ int len[kWalks];
  const Walk wk = walk_setup(N, L, NB, start, len);
  const int n0 = wk.n0;
  const int lane = threadIdx.x;
  const int mine = len[lane];

  T x[J];  // the state entering the block from above (zero for the last)
  walk_entry<T, AffineMaps<T, J>>(maps, gstates, wk, NB, GB, x);

  const int ntiles = (min(L, N) + kTile - 1) / kTile;
  solve_stage<T, J>(tiles + ((ntiles - 1) & 1) * TILE, p, U, W, bz, start, len,
                    ntiles - 1);
  for (int s = ntiles - 1; s >= 0; --s) {
    if (s > 0) {
      solve_stage<T, J>(tiles + ((s - 1) & 1) * TILE, p, U, W, bz, start, len,
                        s - 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const T* tile = tiles + (s & 1) * TILE + lane;
#pragma unroll 1
    for (int l = min(kTile, mine - s * kTile) - 1; l >= 0; --l) {
      T pr[J], u[J], w[J], b;
      solve_row<T, J>(tile + l * I::WIDTH * kPitch, n0 + s * kTile + l == 0,
                      pr, u, w, b);
      T t = b;
#pragma unroll
      for (int i = 0; i < J; ++i) t += w[i] * x[i];
      T* o = out + l * J * kPitch + lane;
#pragma unroll
      for (int i = 0; i < J; ++i) {
        x[i] = pr[i] * (x[i] - u[i] * t);
        o[i * kPitch] = x[i];
      }
    }
    __syncwarp();
    unstage<J, 0, J>(R, out, start, len, s);
    __syncwarp();
  }
}

// One block per chain.  The scan visits the chain's NB block maps in order
// (from the last block for a suffix); thread t takes the run of them
// [t per, (t + 1) per).  Maps of the runs and of the scan's levels live in
// dynamic shared memory, two slots of E values a thread.
template <typename T, class M>
__global__ void __launch_bounds__(kScanThreads, 1)
    block_scan_kernel(const T* __restrict__ maps, T* __restrict__ states,
                      int NB) {
  constexpr int E = M::E, ST = M::ST;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const T* cm = maps + (long long)blockIdx.x * NB * E;
  T* cs = states + (long long)blockIdx.x * NB * ST;
  const int per = (NB + kScanThreads - 1) / kScanThreads;
  const int lo = min(NB, tid * per), hi = min(NB, lo + per);

  // 1. the composition of the thread's run
  T* mine = buf + tid * E;
  T* cur = mine;
  T* nxt = buf + (kScanThreads + tid) * E;
  if (lo < hi) {
    const T* m = cm + (long long)(M::kReverse ? NB - 1 - lo : lo) * E;
    for (int k = 0; k < E; ++k) cur[k] = m[k];
  } else {
    M::identity(cur);
  }
  for (int q = lo + 1; q < hi; ++q) {
    M::combine(cur, cm + (long long)(M::kReverse ? NB - 1 - q : q) * E, nxt);
    T* t = cur;
    cur = nxt;
    nxt = t;
  }
  if (cur != mine)
    for (int k = 0; k < E; ++k) mine[k] = cur[k];
  __syncthreads();

  // 2. inclusive scan of the runs' compositions (Kogge-Stone)
  T* src = buf;
  T* dst = buf + kScanThreads * E;
  for (int d = 1; d < kScanThreads; d *= 2) {
    if (tid >= d)
      M::combine(src + (tid - d) * E, src + tid * E, dst + tid * E);
    else
      for (int k = 0; k < E; ++k) dst[tid * E + k] = src[tid * E + k];
    __syncthreads();
    T* t = src;
    src = dst;
    dst = t;
  }

  // 3. the state entering each block of the run
  T st[ST];
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < ST; ++k) st[k] = T(0);
  } else {
    M::state_of(src + (tid - 1) * E, st);
  }
  for (int q = lo; q < hi; ++q) {
    const long long b = M::kReverse ? NB - 1 - q : q;
    T* o = cs + b * ST;
#pragma unroll
    for (int k = 0; k < ST; ++k) o[k] = st[k];
    if (q + 1 < hi) M::apply(cm + b * E, st);
  }
}

template <typename T, class M>
int launch_scan(const void* maps, void* states, int C, int NB,
                cudaStream_t s) {
  const size_t smem = 2 * (size_t)kScanThreads * M::E * sizeof(T);
  static size_t allowed = 0;
  const int err = allow_smem(block_scan_kernel<T, M>, smem, &allowed);
  if (err) return err;
  block_scan_kernel<T, M><<<(unsigned)C, kScanThreads, smem, s>>>(
      (const T*)maps, (T*)states, NB);
  return (int)cudaGetLastError();
}

// one thread block of (a) and (c) per group of kWalks blocks of a chain
inline unsigned walk_grid(int C, int GB) { return (unsigned)((long long)C * GB); }

// The phases of K1 at width J, in order: (a) with more than one block, (b)
// with more than one group, (c).
template <typename T, int J>
int launch_kalman_j(const void* p, const void* U, const void* V,
                    const void* ainv, const void* y, void* S, void* F,
                    void* maps, void* groups, void* gstates, int C, int N,
                    int L, cudaStream_t s) {
  const int NB = (N + L - 1) / L;
  const int GB = (NB + kWalks - 1) / kWalks;
  const T *pp = (const T*)p, *Up = (const T*)U, *Vp = (const T*)V,
          *ap = (const T*)ainv, *yp = (const T*)y;
  constexpr int WIN = KIn<J>::W;
  int err;
  if (NB > 1) {
    const size_t smem = walk_smem<T>(WIN, 0);
    static size_t maps_allowed = 0;
    if ((err = allow_smem(kalman_maps_kernel<T, J>, smem, &maps_allowed)))
      return err;
    kalman_maps_kernel<T, J><<<walk_grid(C, GB), kWalks, smem, s>>>(
        pp, Up, Vp, ap, yp, (T*)maps, (T*)groups, N, L, NB, GB);
    if ((err = (int)cudaGetLastError())) return err;
  }
  if (GB > 1 &&
      (err = launch_scan<T, KalmanMaps<T, J>>(groups, gstates, C, GB, s)))
    return err;
  const size_t smem = walk_smem<T>(WIN, J * J + J);
  static size_t states_allowed = 0;
  if ((err = allow_smem(kalman_states_kernel<T, J>, smem, &states_allowed)))
    return err;
  kalman_states_kernel<T, J><<<walk_grid(C, GB), kWalks, smem, s>>>(
      pp, Up, Vp, ap, yp, NB > 1 ? (const T*)maps : nullptr,
      GB > 1 ? (const T*)gstates : nullptr, (T*)S, (T*)F, N, L, NB, GB);
  return (int)cudaGetLastError();
}

// The phases of K2 at width J, as K1's.
template <typename T, int J>
int launch_solve_j(const void* p, const void* U, const void* W,
                   const void* bz, void* R, void* maps, void* groups,
                   void* gstates, int C, int N, int L, cudaStream_t s) {
  const int NB = (N + L - 1) / L;
  const int GB = (NB + kWalks - 1) / kWalks;
  const T *pp = (const T*)p, *Up = (const T*)U, *Wp = (const T*)W,
          *bp = (const T*)bz;
  constexpr int WIN = RIn<J>::WIDTH;
  int err;
  if (NB > 1) {
    const size_t smem = walk_smem<T>(WIN, 0);
    static size_t maps_allowed = 0;
    if ((err = allow_smem(solve_maps_kernel<T, J>, smem, &maps_allowed)))
      return err;
    solve_maps_kernel<T, J><<<walk_grid(C, GB), kWalks, smem, s>>>(
        pp, Up, Wp, bp, (T*)maps, (T*)groups, N, L, NB, GB);
    if ((err = (int)cudaGetLastError())) return err;
  }
  if (GB > 1 &&
      (err = launch_scan<T, AffineMaps<T, J>>(groups, gstates, C, GB, s)))
    return err;
  const size_t smem = walk_smem<T>(WIN, J);
  static size_t states_allowed = 0;
  if ((err = allow_smem(solve_states_kernel<T, J>, smem, &states_allowed)))
    return err;
  solve_states_kernel<T, J><<<walk_grid(C, GB), kWalks, smem, s>>>(
      pp, Up, Wp, bp, NB > 1 ? (const T*)maps : nullptr,
      GB > 1 ? (const T*)gstates : nullptr, (T*)R, N, L, NB, GB);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_kalman(int J, const void* p, const void* U,
                  const void* V, const void* ainv, const void* y, void* S,
                  void* F, void* maps, void* groups, void* gstates, int C,
                  int N, int L, cudaStream_t s) {
  switch (J) {
    case 1:
      return launch_kalman_j<T, 1>(p, U, V, ainv, y, S, F, maps,
                                   groups, gstates, C, N, L, s);
    case 2:
      return launch_kalman_j<T, 2>(p, U, V, ainv, y, S, F, maps,
                                   groups, gstates, C, N, L, s);
    case 3:
      return launch_kalman_j<T, 3>(p, U, V, ainv, y, S, F, maps,
                                   groups, gstates, C, N, L, s);
    case 4:
      return launch_kalman_j<T, 4>(p, U, V, ainv, y, S, F, maps,
                                   groups, gstates, C, N, L, s);
    default:
      return -1;
  }
}

template <typename T>
int launch_solve(int J, const void* p, const void* U,
                 const void* W, const void* bz, void* R, void* maps,
                 void* groups, void* gstates, int C, int N, int L,
                 cudaStream_t s) {
  switch (J) {
    case 1:
      return launch_solve_j<T, 1>(p, U, W, bz, R, maps, groups,
                                  gstates, C, N, L, s);
    case 2:
      return launch_solve_j<T, 2>(p, U, W, bz, R, maps, groups,
                                  gstates, C, N, L, s);
    case 3:
      return launch_solve_j<T, 3>(p, U, W, bz, R, maps, groups,
                                  gstates, C, N, L, s);
    case 4:
      return launch_solve_j<T, 4>(p, U, W, bz, R, maps, groups,
                                  gstates, C, N, L, s);
    default:
      return -1;
  }
}

// ================================ K3, K4, K5: the factor adjoint
//
// The factor adjoint carries a J x J state M over the rows in descending
// order.  Its row step (fused_slab._structured_apply, :496) is affine in M
// and costs O(J^2):
//   bv = (M + M^T) w (+ bv0),  ba = -w^T M w (+ bdp),
//   M' = p (.) [M - u (x) bv - ba u (x) u] (.) p,
// where the parenthesised constants belong to the affine step only, and
// u = 0 at row 0 of every chain (the identity step, p = 1 there).  Flattened
// row-major, M is a vector of D = J^2 values and a block of rows a dense
// D-affine map, which the suffix level composes (AffineMaps<T, D>).
//
// K3 factor_rev (J <= 2) replaces celerite2_tpu/ops/fused_slab.py:
// _scan_pass (pallas_call :308) run in reverse with the dense element build
// _build_factor_rev (:441), with the cross-block level and the distribute
// the JAX package runs in XLA after it.  K4 frev_maps and K5 frev_states
// (J = 3, 4 on the main path) replace fused_slab.py:
// _factor_adjoint_structured's phase A (pallas_call :629, body _phaseA_body
// :530) and phase C (pallas_call :697, body _phaseC_body :580), with phase
// B, which the JAX package runs in XLA (:651-682), between them.  Both
// return MX (C, N, J, J), the state entering every row; at row 0, whose step
// is the identity, that is the state after every step.
//
// What bounds them on this card is what bounds K2: chains of dependent row
// steps and of map combines.  So they take K2's shape, on blocks of L rows
// of the wrapper's choice (ops/_build.py), a lane a block, the rows staged
// through shared memory by tiles and the outputs stored by tiles:
//   K3 (a) factor_maps: each lane composes its block's rows into the
//          block's D-affine map: the D basis states through the steps'
//          linear part and the zero state through the affine steps, O(J^2 D)
//          a row (no dense D x D element per row); a warp scan then takes
//          the suffixes of the group's 32 maps;
//      (b) block_scan_kernel on AffineMaps<T, D> (E = 20 at J = 2) over the
//          groups;
//      (c) frev_rows: each lane's rows from its block's incoming state, D
//          values a row.
//   K4 and K5 (J = 3, 4) split the same three phases over two calls, since
//   a block's map is J^4 + J^2 = 272 values at J = 4, which a lane cannot
//   carry:
//      (a) frev_maps (K4): a thread block per group of 32 blocks, a warp per
//          column of the maps (D + 1 of them) and a lane per block, walks
//          the group's rows by tiles, then composes the group's maps in
//          shared memory and writes each block's suffix within the group
//          and the group's map;
//      (b) frev_scan (K5): a warp per chain carries the state over the
//          groups, last to first (a mat-vec a group, lane i computing value
//          i);
//      (c) frev_rows (K5), K3's (c).

// the values of a row in the factor adjoint's input tiles: p, u, w, bv0, bdp
template <int J>
struct FIn {
  static constexpr int P = 0, U = J, W = 2 * J, G = 3 * J, BD = 4 * J,
                       WIDTH = 4 * J + 1;
};

template <typename T, int J, int NT = kWalks>
__device__ __forceinline__ void frev_stage(T* tile, const T* p, const T* U,
                                           const T* W, const T* bv0,
                                           const T* bdp,
                                           const long long* start,
                                           const int* len, int s) {
  using I = FIn<J>;
  stage<J, I::P, I::WIDTH, NT>(tile, p, start, len, s);
  stage<J, I::U, I::WIDTH, NT>(tile, U, start, len, s);
  stage<J, I::W, I::WIDTH, NT>(tile, W, start, len, s);
  stage<J, I::G, I::WIDTH, NT>(tile, bv0, start, len, s);
  stage<1, I::BD, I::WIDTH, NT>(tile, bdp, start, len, s);
  cp_async_commit();
}

// One row's parameters from the tile (x at value 0 of the row of this
// lane's walk); u = 0 at row 0 of a chain.
template <typename T, int J>
__device__ __forceinline__ void frev_row_tile(const T* x, bool row0,
                                              T (&p)[J], T (&u)[J], T (&w)[J],
                                              T (&g)[J], T& bd) {
  using I = FIn<J>;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    p[j] = x[(I::P + j) * kPitch];
    u[j] = row0 ? T(0) : x[(I::U + j) * kPitch];
    w[j] = x[(I::W + j) * kPitch];
    g[j] = x[(I::G + j) * kPitch];
  }
  bd = x[I::BD * kPitch];
}

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

// K3 (a): each lane's block map, X[k] the image of basis state k under the
// linear part of the block's steps, X[D] the image of the zero state under
// the affine steps (rows descending), stored as AffineMaps<T, D>: A[i][k] =
// X[k][i], b = X[D]; then the suffixes over the group's lanes.
template <typename T, int J>
__global__ void __launch_bounds__(kWalks, 1)
    factor_maps_kernel(const T* __restrict__ p, const T* __restrict__ U,
                       const T* __restrict__ W, const T* __restrict__ bv0,
                       const T* __restrict__ bdp, T* __restrict__ maps,
                       T* __restrict__ groups, int N, int L, int NB, int GB) {
  using I = FIn<J>;
  constexpr int D = J * J;
  using M = AffineMaps<T, D>;
  constexpr int TILE = kTile * I::WIDTH * kPitch;
  static_assert(2 * kWalks * M::E <= 2 * TILE, "the scan fits the tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tiles = reinterpret_cast<T*>(smem_raw);
  __shared__ long long start[kWalks];
  __shared__ int len[kWalks];
  const Walk wk = walk_setup(N, L, NB, start, len);
  const int n0 = wk.n0;
  const int lane = threadIdx.x;
  const int mine = len[lane];

  T X[D + 1][D];
#pragma unroll
  for (int k = 0; k <= D; ++k)
#pragma unroll
    for (int i = 0; i < D; ++i) X[k][i] = k == i ? T(1) : T(0);

  const int ntiles = (min(L, N) + kTile - 1) / kTile;
  frev_stage<T, J>(tiles + ((ntiles - 1) & 1) * TILE, p, U, W, bv0, bdp, start,
                   len, ntiles - 1);
  for (int s = ntiles - 1; s >= 0; --s) {
    if (s > 0) {
      frev_stage<T, J>(tiles + ((s - 1) & 1) * TILE, p, U, W, bv0, bdp, start,
                       len, s - 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const T* tile = tiles + (s & 1) * TILE + lane;
#pragma unroll 1
    for (int l = min(kTile, mine - s * kTile) - 1; l >= 0; --l) {
      T pr[J], u[J], w[J], g[J], bd;
      frev_row_tile<T, J>(tile + l * I::WIDTH * kPitch,
                          n0 + s * kTile + l == 0, pr, u, w, g, bd);
#pragma unroll
      for (int k = 0; k <= D; ++k)
        structured_apply<T, J>(X[k], pr, u, w, g, bd, k == D);
    }
    __syncwarp();
  }
  // the group's suffix maps, in the tiles (every lane is done with them)
  T* o = tiles + lane * M::E;
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int k = 0; k < D; ++k) o[i * D + k] = X[k][i];
    o[D * D + i] = X[D][i];
  }
  store_group<T, M>(tiles, wk, NB, GB, wk.block < NB, maps, groups);
}

// The rows of K3 (c) and K5 (c): each lane's block from its incoming state
// (the state entering its group, ``gstates``, carried through the suffix of
// its group's later blocks, ``maps``: AffineMaps<T, D>), rows descending,
// writing the state entering every row.  At row 0 of a chain that is also
// the state after every step: the step there is the identity (u = 0, and
// p = 1 since dt = 0).
template <typename T, int J>
__global__ void __launch_bounds__(kWalks, 1)
    frev_rows_kernel(const T* __restrict__ p, const T* __restrict__ U,
                     const T* __restrict__ W, const T* __restrict__ bv0,
                     const T* __restrict__ bdp, const T* __restrict__ maps,
                     const T* __restrict__ gstates, T* __restrict__ MX, int N,
                     int L, int NB, int GB) {
  using I = FIn<J>;
  constexpr int D = J * J;
  constexpr int TILE = kTile * I::WIDTH * kPitch;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tiles = reinterpret_cast<T*>(smem_raw);
  T* out = tiles + 2 * TILE;
  __shared__ long long start[kWalks];
  __shared__ int len[kWalks];
  const Walk wk = walk_setup(N, L, NB, start, len);
  const int n0 = wk.n0;
  const int lane = threadIdx.x;
  const int mine = len[lane];

  T x[D];
  walk_entry<T, AffineMaps<T, D>>(maps, gstates, wk, NB, GB, x);

  const int ntiles = (min(L, N) + kTile - 1) / kTile;
  frev_stage<T, J>(tiles + ((ntiles - 1) & 1) * TILE, p, U, W, bv0, bdp, start,
                   len, ntiles - 1);
  for (int s = ntiles - 1; s >= 0; --s) {
    if (s > 0) {
      frev_stage<T, J>(tiles + ((s - 1) & 1) * TILE, p, U, W, bv0, bdp, start,
                       len, s - 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const T* tile = tiles + (s & 1) * TILE + lane;
#pragma unroll 1
    for (int l = min(kTile, mine - s * kTile) - 1; l >= 0; --l) {
      T pr[J], u[J], w[J], g[J], bd;
      frev_row_tile<T, J>(tile + l * I::WIDTH * kPitch,
                          n0 + s * kTile + l == 0, pr, u, w, g, bd);
      T* o = out + l * D * kPitch + lane;
#pragma unroll
      for (int i = 0; i < D; ++i) o[i * kPitch] = x[i];
      structured_apply<T, J>(x, pr, u, w, g, bd, true);
    }
    __syncwarp();
    unstage<D, 0, D>(MX, out, start, len, s);
    __syncwarp();
  }
}

// K5 (b): one warp per chain carries the state over the groups, last to
// first: the state entering group g is the map of group g + 1 applied to
// the state entering it, zero for the last group.  Lane i < D holds value i
// and reads row i of each group's map one group ahead.
template <typename T, int J>
__global__ void __launch_bounds__(kWalks, 1)
    frev_scan_kernel(const T* __restrict__ groups, T* __restrict__ gstates,
                     int GB) {
  constexpr int D = J * J, E = D * D + D;
  const int lane = threadIdx.x;
  const int row = min(lane, D - 1);
  const T* cg = groups + (long long)blockIdx.x * GB * E;
  T* cs = gstates + (long long)blockIdx.x * GB * D;
  T cur[D + 1], nxt[D + 1];
  auto load = [&](int g, T(&r)[D + 1]) {
#pragma unroll
    for (int k = 0; k < D; ++k) r[k] = cg[(long long)g * E + row * D + k];
    r[D] = cg[(long long)g * E + D * D + row];
  };
  load(GB - 1, cur);
  T x = T(0);
  for (int g = GB - 1; g >= 0; --g) {
    if (lane < D) cs[(long long)g * D + lane] = x;
    if (g == 0) break;
    load(g - 1, nxt);
    T s0 = cur[D], s1 = T(0);
#pragma unroll
    for (int k = 0; k < D; k += 2) {
      s0 += cur[k] * __shfl_sync(0xffffffffu, x, k);
      if (k + 1 < D) s1 += cur[k + 1] * __shfl_sync(0xffffffffu, x, k + 1);
    }
    x = s0 + s1;
#pragma unroll
    for (int k = 0; k <= D; ++k) cur[k] = nxt[k];
  }
}

// K4's shared memory after its walk, in values of T: the group's block maps
// by columns (block b's column k at b EP + k D, the constant at k = D; EP
// odd, so that the lanes storing them do not collide on a bank), their
// suffixes row-major with the constant as a last column (rows of D + 1,
// block b's at b E), and for each of the WARPS warps that compose them two
// buffers of the running columns of each of its two half-warps (an even
// pitch CP: pairs of values 16-byte aligned; the halves HS apart, off the
// banks of each other).
constexpr int kCols = 2;  // columns of the suffixes a half-warp carries

template <int J>
struct FrevLayout {
  static constexpr int D = J * J, E = D * D + D, EP = E + 1;
  static constexpr int CP = D + (D & 1);
  static constexpr int HS = kCols * CP + 2;
  static constexpr int WARPS = (D + 2 * kCols) / (2 * kCols);
  static constexpr int SUF = kWalks * EP, XS = SUF + kWalks * E;
  static constexpr int SIZE = XS + WARPS * 4 * HS;
};

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

// K4 (2): one warp's columns [k0, k0 + 2 kCols) of the suffixes of the
// group's nb block maps, last block to first: the last block's suffix is its
// map, and block b's column k is its map applied to column k of block
// b + 1's suffix (the constant added for k = D).  Lane h 16 + i (i < D)
// computes row i of the half-warp h's kCols columns, so that both halves
// read the same values of each block's map; each carries its columns as
// 16-byte broadcasts from ``xs`` (two buffers, one written while the other
// is read: one warp barrier a block).  Each sum runs from the constant (or
// zero) up the map's columns in order.
template <typename T, int J>
__device__ __forceinline__ void frev_compose(const T* maps, T* suf, T* xs,
                                             int k0, int nb) {
  using F = FrevLayout<J>;
  using V = typename Pair<T>::type;
  constexpr int D = F::D;
  static_assert(D <= kWalks / 2, "a row a lane of each half-warp");
  const int lane = threadIdx.x % kWalks;
  const int half = lane / (kWalks / 2);
  const int row = min(lane % (kWalks / 2), D - 1);
  const bool live = lane % (kWalks / 2) < D;
  const int kh = k0 + half * kCols;
  T* xh = xs + half * F::HS;
  T x[kCols];
  auto put = [&](int b, int buf) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (live && kh + c <= D) {
        xh[buf * 2 * F::HS + c * F::CP + row] = x[c];
        suf[b * F::E + row * (D + 1) + kh + c] = x[c];
      }
    }
    __syncwarp();
  };
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    x[c] = kh + c <= D ? maps[(nb - 1) * F::EP + (kh + c) * D + row] : T(0);
  put(nb - 1, 0);
  for (int b = nb - 2, buf = 1; b >= 0; --b, buf ^= 1) {
    const T* m = maps + b * F::EP;
    const T* xp = xh + (buf ^ 1) * 2 * F::HS;
#pragma unroll
    for (int c = 0; c < kCols; ++c) x[c] = kh + c == D ? m[D * D + row] : T(0);
#pragma unroll
    for (int j = 0; j < D; j += 2) {
      const T a0 = m[j * D + row];
      const T a1 = j + 1 < D ? m[(j + 1) * D + row] : T(0);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (kh + c > D) continue;
        const V v = *reinterpret_cast<const V*>(xp + c * F::CP + j);
        x[c] += a0 * v.x;
        if (j + 1 < D) x[c] += a1 * v.y;
      }
    }
    put(b, buf);
  }
}

// K4 frev_maps: replaces the Pallas kernel celerite2_tpu/ops/fused_slab.py:
// _factor_adjoint_structured phase A (pallas_call :629, body _phaseA_body
// :530) and the part of phase B (XLA, :651-682) that stays inside a group of
// kWalks blocks.  One thread block per (chain, group of kWalks consecutive
// blocks), D + 1 warps (D = J^2): warp k < D carries column k of the linear
// part of the group's block maps, warp D their constant, and lane b block b
// of the group.
//   (1) the walk: each thread takes its column through its block's rows,
//       descending (the D basis states through the steps' linear part, the
//       zero state through the affine steps), the rows staged by tiles of
//       kTile rows of every block with cp.async one tile ahead, shared by
//       all the warps (lane b reads block b's row: no bank conflict);
//   (2) the composition: the group's block maps go to shared memory, and
//       ceil((D + 1) / (2 kCols)) warps compose each block's suffix within
//       the group from the last block to the first, kCols columns a
//       half-warp (frev_compose);
//   (3) the suffixes (C, NB, E) and the group's map, its first block's
//       suffix (C, GB, E), E = D^2 + D as AffineMaps<T, D> (A row-major,
//       then b), stored coalesced from shared memory.
// Bound on this card: operations, (D + 1) 10 D a row (the walk) and
// (D + 1) 2 D^2 a block (the composition).  Every lane of every warp walks,
// where one warp a block left 15 of 32 lanes idle at J = 4; the rows come
// from shared memory, where every lane read them from device memory inside
// the dependent row loop; and the block maps never leave the thread block.
// The walk is then bound by the float64 pipe (about 108 float64
// instructions a row and thread at J = 4, 17 warps on 4 schedulers), the
// composition by shared-memory traffic, which few composing warps, each
// map read once for a half-warp's kCols columns, and broadcast reads of
// the running columns keep low (PERF.md).
template <typename T, int J>
__global__ void __launch_bounds__((J * J + 1) * kWalks, 1)
    frev_maps_kernel(const T* __restrict__ p, const T* __restrict__ U,
                     const T* __restrict__ W, const T* __restrict__ bv0,
                     const T* __restrict__ bdp, T* __restrict__ suffix,
                     T* __restrict__ groups, int N, int L, int NB, int GB) {
  using I = FIn<J>;
  using F = FrevLayout<J>;
  constexpr int D = F::D, E = F::E;
  constexpr int NT = (D + 1) * kWalks;
  constexpr int TILE = kTile * I::WIDTH * kPitch;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tiles = reinterpret_cast<T*>(smem_raw);
  __shared__ long long start[kWalks];
  __shared__ int len[kWalks];
  const int col = threadIdx.x / kWalks, lane = threadIdx.x % kWalks;
  const long long chain = blockIdx.x / GB;
  const int group = blockIdx.x % GB;
  const int b0 = group * kWalks, nb = min(kWalks, NB - b0);
  const int n0 = (b0 + lane) * L;
  if (col == 0) {
    start[lane] = chain * N + (lane < nb ? n0 : 0);
    len[lane] = lane < nb ? min(L, N - n0) : 0;
  }
  __syncthreads();
  const int mine = len[lane];
  const bool affine = col == D;

  T X[D];
#pragma unroll
  for (int i = 0; i < D; ++i) X[i] = i == col ? T(1) : T(0);

  const int ntiles = (min(L, N) + kTile - 1) / kTile;
  frev_stage<T, J, NT>(tiles + ((ntiles - 1) & 1) * TILE, p, U, W, bv0, bdp,
                       start, len, ntiles - 1);
  for (int s = ntiles - 1; s >= 0; --s) {
    if (s > 0) {
      frev_stage<T, J, NT>(tiles + ((s - 1) & 1) * TILE, p, U, W, bv0, bdp,
                           start, len, s - 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* tile = tiles + (s & 1) * TILE + lane;
#pragma unroll 2
    for (int l = min(kTile, mine - s * kTile) - 1; l >= 0; --l) {
      T pr[J], u[J], w[J], g[J], bd;
      frev_row_tile<T, J>(tile + l * I::WIDTH * kPitch,
                          n0 + s * kTile + l == 0, pr, u, w, g, bd);
      structured_apply<T, J>(X, pr, u, w, g, bd, affine);
    }
    __syncthreads();  // every warp is done with the tile before it is refilled
  }

  // the group's block maps, then their suffixes (FrevLayout)
  if (lane < nb) {
    T* o = tiles + lane * F::EP + col * D;
#pragma unroll
    for (int i = 0; i < D; ++i) o[i] = X[i];
  }
  __syncthreads();
  if (col < F::WARPS)
    frev_compose<T, J>(tiles, tiles + F::SUF,
                       tiles + F::XS + col * 4 * F::HS, col * 2 * kCols, nb);
  __syncthreads();
  const T* suf = tiles + F::SUF;
  auto at = [&](int b, int r) {  // value r of block b's suffix, as AffineMaps
    return r < D * D ? suf[b * E + r / D * (D + 1) + r % D]
                     : suf[b * E + (r - D * D) * (D + 1) + D];
  };
  T* out = suffix + (chain * NB + b0) * E;
  for (int e = threadIdx.x; e < nb * E; e += NT) out[e] = at(e / E, e % E);
  T* og = groups + (chain * GB + group) * E;
  for (int e = threadIdx.x; e < E; e += NT) og[e] = at(0, e);
}

// dynamic shared memory of K4 at width J: two input tiles, then
// FrevLayout's arrays in the same space
template <typename T, int J>
constexpr size_t frev_maps_smem() {
  const size_t tiles = walk_smem<T>(FIn<J>::WIDTH, 0);
  const size_t after = FrevLayout<J>::SIZE * sizeof(T);
  return tiles > after ? tiles : after;
}

// the rows of K3 (c) or K5 (c), with the shared memory they need
template <typename T, int J>
int launch_rows(const T* p, const T* U, const T* W, const T* bv0,
                const T* bdp, const T* maps, const T* gstates, T* MX, int C,
                int N, int L, int NB, int GB, cudaStream_t s) {
  const size_t smem = walk_smem<T>(FIn<J>::WIDTH, J * J);
  static size_t allowed = 0;
  const int err = allow_smem(frev_rows_kernel<T, J>, smem, &allowed);
  if (err) return err;
  frev_rows_kernel<T, J><<<walk_grid(C, GB), kWalks, smem, s>>>(
      p, U, W, bv0, bdp, maps, gstates, MX, N, L, NB, GB);
  return (int)cudaGetLastError();
}

// The phases of K3 at width J, as K2's.
template <typename T, int J>
int launch_factor_j(const void* p, const void* U, const void* W,
                    const void* bv0, const void* bdp, void* MX, void* maps,
                    void* groups, void* gstates, int C, int N, int L,
                    cudaStream_t s) {
  const int NB = (N + L - 1) / L;
  const int GB = (NB + kWalks - 1) / kWalks;
  const T *pp = (const T*)p, *Up = (const T*)U, *Wp = (const T*)W,
          *gp = (const T*)bv0, *dp = (const T*)bdp;
  int err;
  if (NB > 1) {
    const size_t smem = walk_smem<T>(FIn<J>::WIDTH, 0);
    static size_t maps_allowed = 0;
    if ((err = allow_smem(factor_maps_kernel<T, J>, smem, &maps_allowed)))
      return err;
    factor_maps_kernel<T, J><<<walk_grid(C, GB), kWalks, smem, s>>>(
        pp, Up, Wp, gp, dp, (T*)maps, (T*)groups, N, L, NB, GB);
    if ((err = (int)cudaGetLastError())) return err;
  }
  if (GB > 1 &&
      (err = launch_scan<T, AffineMaps<T, J * J>>(groups, gstates, C, GB, s)))
    return err;
  return launch_rows<T, J>(pp, Up, Wp, gp, dp, NB > 1 ? (const T*)maps : nullptr,
                           GB > 1 ? (const T*)gstates : nullptr, (T*)MX, C, N,
                           L, NB, GB, s);
}

// K4 at width J: with more than one block, one thread block per group of
// kWalks blocks of a chain (with one block the rows of K5 walk it alone).
template <typename T, int J>
int launch_frev_maps_j(const void* p, const void* U, const void* W,
                       const void* bv0, const void* bdp, void* suffix,
                       void* groups, int C, int N, int L, cudaStream_t s) {
  const int NB = (N + L - 1) / L;
  const int GB = (NB + kWalks - 1) / kWalks;
  if (NB < 2) return 0;
  constexpr size_t smem = frev_maps_smem<T, J>();
  static size_t allowed = 0;
  const int err = allow_smem(frev_maps_kernel<T, J>, smem, &allowed);
  if (err) return err;
  frev_maps_kernel<T, J><<<walk_grid(C, GB), (J * J + 1) * kWalks, smem, s>>>(
      (const T*)p, (const T*)U, (const T*)W, (const T*)bv0, (const T*)bdp,
      (T*)suffix, (T*)groups, N, L, NB, GB);
  return (int)cudaGetLastError();
}

// The phases of K5 at width J, on K4's suffixes and group maps: (b) with
// more than one group, (c).
template <typename T, int J>
int launch_frev_states_j(const void* p, const void* U, const void* W,
                         const void* bv0, const void* bdp, const void* suffix,
                         const void* groups, void* MX, void* gstates, int C,
                         int N, int L, cudaStream_t s) {
  const int NB = (N + L - 1) / L;
  const int GB = (NB + kWalks - 1) / kWalks;
  if (GB > 1) {
    frev_scan_kernel<T, J><<<(unsigned)C, kWalks, 0, s>>>(
        (const T*)groups, (T*)gstates, GB);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  return launch_rows<T, J>(
      (const T*)p, (const T*)U, (const T*)W, (const T*)bv0, (const T*)bdp,
      NB > 1 ? (const T*)suffix : nullptr, GB > 1 ? (const T*)gstates : nullptr,
      (T*)MX, C, N, L, NB, GB, s);
}

template <typename T>
int launch_factor(int J, const void* p, const void* U, const void* W,
                  const void* bv0, const void* bdp, void* MX, void* maps,
                  void* groups, void* gstates, int C, int N, int L,
                  cudaStream_t s) {
  switch (J) {
    case 1:
      return launch_factor_j<T, 1>(p, U, W, bv0, bdp, MX, maps, groups,
                                   gstates, C, N, L, s);
    case 2:
      return launch_factor_j<T, 2>(p, U, W, bv0, bdp, MX, maps, groups,
                                   gstates, C, N, L, s);
    default:
      return -1;
  }
}

template <typename T>
int launch_frev_maps(int J, const void* p, const void* U, const void* W,
                     const void* bv0, const void* bdp, void* suffix,
                     void* groups, int C, int N, int L, cudaStream_t s) {
  switch (J) {
    case 1:
      return launch_frev_maps_j<T, 1>(p, U, W, bv0, bdp, suffix, groups, C, N,
                                      L, s);
    case 2:
      return launch_frev_maps_j<T, 2>(p, U, W, bv0, bdp, suffix, groups, C, N,
                                      L, s);
    case 3:
      return launch_frev_maps_j<T, 3>(p, U, W, bv0, bdp, suffix, groups, C, N,
                                      L, s);
    case 4:
      return launch_frev_maps_j<T, 4>(p, U, W, bv0, bdp, suffix, groups, C, N,
                                      L, s);
    default:
      return -1;
  }
}

template <typename T>
int launch_frev_states(int J, const void* p, const void* U, const void* W,
                       const void* bv0, const void* bdp, const void* suffix,
                       const void* groups, void* MX, void* gstates, int C,
                       int N, int L, cudaStream_t s) {
  switch (J) {
    case 1:
      return launch_frev_states_j<T, 1>(p, U, W, bv0, bdp, suffix, groups, MX,
                                        gstates, C, N, L, s);
    case 2:
      return launch_frev_states_j<T, 2>(p, U, W, bv0, bdp, suffix, groups, MX,
                                        gstates, C, N, L, s);
    case 3:
      return launch_frev_states_j<T, 3>(p, U, W, bv0, bdp, suffix, groups, MX,
                                        gstates, C, N, L, s);
    case 4:
      return launch_frev_states_j<T, 4>(p, U, W, bv0, bdp, suffix, groups, MX,
                                        gstates, C, N, L, s);
    default:
      return -1;
  }
}

}  // namespace

// ------------------------------------------------------ C interface
//
// Every function launches on ``stream`` and returns cudaGetLastError()
// after the launch (0 on success), or -1 for an unsupported J (K1, K2, K4,
// K5: 1..4; K3: 1, 2).  Pointers are to contiguous device arrays of the
// scalar type given by ``is_double``; shapes are (C, N, J) for per-row
// vectors and (C, N) for per-row scalars.
//
// c2t_kalman_fwd, c2t_solve_rev and c2t_factor_rev launch the phases their
// rows need, on NB = ceil(N / L) blocks in GB = ceil(NB / 32) groups: 0
// with NB > 1, the block maps (writes each block's prefix or suffix within
// its group, ``maps`` (C, NB, E), and each group's map, ``groups`` (C, GB,
// E); E = 3J^2 + 2J for K1, J^2 + J for K2, J^4 + J^2 for K3); 1 with
// GB > 1, the scan over the groups (writes ``gstates``, the state entering
// every group: (C, GB, J^2 + J), (C, GB, J), (C, GB, J^2)); 2 the rows
// (writes S (C, N, J, J) and F (C, N, J), R (C, N, J), or MX (C, N, J, J)).
// The structured factor adjoint splits the same phases: c2t_frev_maps is
// phase 0 (writes ``suffix`` (C, NB, J^4 + J^2) and ``groups`` (C, GB,
// J^4 + J^2); nothing with NB = 1), c2t_frev_states phases 1 and 2 on them.
// The scratch arrays a call does not need may be null.

extern "C" {

int c2t_kalman_fwd(int is_double, int J, const void* p, const void* U,
                   const void* V, const void* ainv, const void* y, void* S,
                   void* F, void* maps, void* groups, void* gstates, int C,
                   int N, int L, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_double ? launch_kalman<double>(J, p, U, V, ainv, y, S, F, maps,
                                           groups, gstates, C, N, L, s)
                   : launch_kalman<float>(J, p, U, V, ainv, y, S, F, maps,
                                          groups, gstates, C, N, L, s);
}

int c2t_solve_rev(int is_double, int J, const void* p, const void* U,
                  const void* W, const void* bz, void* R, void* maps,
                  void* groups, void* gstates, int C, int N, int L,
                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_double ? launch_solve<double>(J, p, U, W, bz, R, maps, groups,
                                          gstates, C, N, L, s)
                   : launch_solve<float>(J, p, U, W, bz, R, maps, groups,
                                         gstates, C, N, L, s);
}

int c2t_factor_rev(int is_double, int J, const void* p, const void* U,
                   const void* W, const void* bv0, const void* bdp, void* MX,
                   void* maps, void* groups, void* gstates, int C, int N,
                   int L, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_double ? launch_factor<double>(J, p, U, W, bv0, bdp, MX, maps,
                                           groups, gstates, C, N, L, s)
                   : launch_factor<float>(J, p, U, W, bv0, bdp, MX, maps,
                                          groups, gstates, C, N, L, s);
}

int c2t_frev_maps(int is_double, int J, const void* p, const void* U,
                  const void* W, const void* bv0, const void* bdp,
                  void* suffix, void* groups, int C, int N, int L,
                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_double ? launch_frev_maps<double>(J, p, U, W, bv0, bdp, suffix,
                                              groups, C, N, L, s)
                   : launch_frev_maps<float>(J, p, U, W, bv0, bdp, suffix,
                                             groups, C, N, L, s);
}

int c2t_frev_states(int is_double, int J, const void* p, const void* U,
                    const void* W, const void* bv0, const void* bdp,
                    const void* suffix, const void* groups, void* MX,
                    void* gstates, int C, int N, int L, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_double
             ? launch_frev_states<double>(J, p, U, W, bv0, bdp, suffix, groups,
                                          MX, gstates, C, N, L, s)
             : launch_frev_states<float>(J, p, U, W, bv0, bdp, suffix, groups,
                                         MX, gstates, C, N, L, s);
}

}  // extern "C"
