// The blocked prefix kernels of the assoc tier (ops/assoc.py), written for
// Hopper (sm_90a): the inclusive prefix over the rows of a long sequence of
// four element families.  Built with nvcc into the shared library of
// celerite2_torch/ops/_build.py and bound with ctypes.
//
// They replace, each for its element family, the in-block prefix kernel of
// the TPU's prefix engine,
//   celerite2_tpu/ops/planes_engine.py  _block_prefix_kernel
//   (pallas_call at :311, body _kernel at :117),
// with the block maps it emits and the distribute that the engine runs after
// it:
//   * ric_*       the Riccati family (planes.riccati_spec, assoc.py
//                 _riccati_combine): (A, Q, R) acting on the factor's carry
//                 S -> Q + A S (I + R S)^{-1} A^T; assoc.factor_assoc;
//   * the same kernels with K right-hand sides, the Kalman family
//                 (planes.kalman_spec, assoc._kalman_combine): (A, Q, R, b,
//                 eta) acting on (S, F); assoc.factor_solve_assoc;
//   * ma_*        the matrix-affine family (planes.mat_affine_spec,
//                 assoc._mat_affine_combine): x -> A x + b with A (D, D) and
//                 b (D, K); the solves, the solve adjoint and phase B of the
//                 factor adjoint (D = J^2, K = 1);
//   * affine_prefix_kernel  the diagonal-affine family
//                 (planes.diag_affine_spec, assoc._diag_affine_scan): f ->
//                 alpha f + beta entry by entry; the matmuls and the
//                 rectangular products of a prediction at new points.
//
// Riccati and Kalman elements are built in the kernel from the row data
// (p, a, u, v, y): element n >= 1 from row n - 1 and p_n, element 0 the
// identity.  No (N, J, J) element is materialised.  Composing a running map
// (A, Q, R, b, eta) with one row's element is a rank-one update (the
// Sherman-Morrison form of _riccati_combine's (I + Q1 R2)^{-1}):
//     x = Q u,  delta = a - u^T x,  w = (v - x) / delta,  g = A^T u,
//     z = y - b^T u,
//     A <- diag(p) (A - w g^T),      Q <- diag(p) (Q + delta w w^T) diag(p),
//     R <- R - g g^T / delta,        b <- diag(p) (b + w z^T),
//     eta <- eta - g z^T / delta,
// so a row costs O(J^2), not O(J^3), and the state part (Q, b) is the
// factor's and the lower solve's own row recursion.  Whole maps are composed
// only above the rows, with the general combine and its inverse: a
// Gauss-Jordan solve of (I + Q1 R2) X = [A1 | Q1 | b1 + Q1 eta2] (of
// (I + S R) X = [S | F + S eta] to apply a map to a state) with partial
// pivoting.  A non-positive pivot delta divides by 1, as the row kernels do,
// so a system that is not positive definite gives finite values and the
// caller's check d > 0 decides (the quiet -inf).
//
// The Riccati and Kalman families: a two-level scan over blocks of L rows
// (the wrapper's choice, ops/_build.py kalman_block_len) in groups of
// kGroup blocks, each group's blocks walked by one warp.  What bounds them on
// this card is the chains of dependent steps: the rows of a block, twice,
// and the combines above them; the bytes (the rows read twice, S and F
// written once) take a small fraction of that time at one chain.  So the
// rows are cut into many short blocks, and the walks of (a) and (e) below
// are the rank-one steps above:
//   * at J <= 4 a lane walks a block and holds its whole map (3 J^2 + 2 J KC
//     values) in registers, and the levels compose in registers too, each
//     thread a whole combine (the Gauss-Jordan elimination of the combine
//     unrolled over the J rows), in three launches (two with one group, one
//     with one block):
//       (a) ric_maps:   each block's rows composed into the block's map,
//                       then a Kogge-Stone scan over the warp's lanes: the
//                       prefix map of every block within its group, and the
//                       group's map;
//       (b) ric_carry:  a thread block a chain, reduce-then-scan over
//                       the groups' maps (kScanThreads threads, each a run of
//                       groups), the state entering every group;
//       (e) ric_apply:  each lane's state entering its block, the state
//                       entering its group carried over the prefix map of
//                       the blocks before it, then the block's rows again;
//   * from J = 8 a map (208 values at J = 8) does not fit a lane: a team of
//     J lanes walks a block, lane i holding column i of A and row i of Q, R,
//     b, eta (of S, F in (e)); x and g are its own sums, and u^T x, b^T u
//     and the vectors w, g each lane needs are warp shuffles within the
//     team, with no barrier on the row chain.  The levels compose whole maps
//     in shared memory, a warp each (eight from J = 16): the Gauss-Jordan
//     elimination takes its pivot by a warp reduction and eliminates an
//     entry a thread, a barrier between steps.  Five launches (three with
//     one group, one with one block):
//       (a) ric_maps:   each block's rows composed into the block's map;
//       (b) ric_groups: a warp a group composes its blocks' maps in order;
//       (c) ric_scan:   a warp a chain carries the state over the groups'
//                       maps, the state entering every group;
//       (d) ric_enter:  a warp a group carries the state entering it over
//                       its blocks' maps, the state entering every block;
//       (e) ric_apply:  each block's rows again from that state.
// In both, the rows pass through shared memory by tiles of every walk of the
// warp, copied with cp.async one tile ahead (a lane a row, the index
// arithmetic paid once a row), and (e) stores each tile of S and F with
// consecutive lanes on consecutive values.

#include <cuda_runtime.h>

#include <cfloat>

#include "device_common.cuh"

namespace {

template <typename T>
struct Tiny;
template <>
struct Tiny<float> {
  static __device__ __forceinline__ float value() { return FLT_MIN; }
};
template <>
struct Tiny<double> {
  static __device__ __forceinline__ double value() { return DBL_MIN; }
};

template <typename T>
__device__ __forceinline__ T safe_pos(T x) {
  return x > T(0) ? x : T(1);
}

// ===================================================== Riccati / Kalman
//
// Layouts: p, U, V (C, N, J); a (C, N); Y (C, N, K); the outputs S (C, N, J,
// J) and F (C, N, J, K).  The right-hand sides are split into chunks of KC
// columns over blockIdx.y, each chunk redoing the Riccati part.  Scratch, per
// (chain, chunk) cc = chain * chunks + chunk: the block maps (C, chunks, NB,
// E), the group maps (C, chunks, GB, E), the states entering every group
// (C, chunks, GB, ST) and, from J = 8, every block (C, chunks, NB, ST).  A map is [A | Q | R |
// b | eta] (J x J row-major, then J x KC), a state [S | F].  KAL = false is
// the Riccati family (no Y, F, b, eta).

constexpr int kGroup = 32;  // blocks of rows in a group
constexpr unsigned kFull = 0xffffffffu;

// lanes that walk one block of rows together
__host__ __device__ constexpr int ric_team(int J) { return J <= 4 ? 1 : J; }

// right-hand sides of the Kalman family a chunk: what a lane's registers hold
// beside the J x J part of the map it walks
__host__ __device__ constexpr int ric_cols(int J) {
  return J == 1 ? 8 : J == 2 ? 4 : J == 4 ? 2 : J == 8 ? 8 : J == 16 ? 4 : 2;
}

template <int J, bool KAL>
struct Ric {
  static constexpr int P = ric_team(J);    // lanes a block
  static constexpr int NW = 32 / P;        // blocks (walks) a warp
  static constexpr int R = J / P;          // rows of the J x J parts a lane holds
  static constexpr int KC = KAL ? ric_cols(J) : 0;
  static constexpr int KR = KC > 0 ? KC : 1;  // register arrays' width
  static constexpr int JJ = J * J;
  static constexpr int E = 3 * JJ + 2 * J * KC;  // a map
  static constexpr int ST = JJ + J * KC;         // a state
  // a map's slot in the levels' shared memory at J <= 4, one a thread: an
  // odd stride, so that threads reading the same entry of their maps hit
  // different banks
  static constexpr int SLOT = E | 1;
  // a staged row: p of row n, then u, v, a, y of row n - 1
  static constexpr int IP = 0, IU = J, IV = 2 * J, IA = 3 * J, IY = 3 * J + 1;
  static constexpr int WIN = 3 * J + 1 + KC;
  static constexpr int TR = (P == 1 || J == 32) ? 4 : 8;  // rows a tile
  static constexpr int PITCH = NW == 1 ? 1 : NW + 1;      // value f of row l of
  // walk k at (l * WIDTH + f) * PITCH + k
  static constexpr int TILE = TR * WIN * PITCH;
  static constexpr int OUT = TR * ST * PITCH;
  // the static shared memory of a walk kernel (ric_walks' arrays), which
  // counts with the dynamic toward the 48 KB a kernel gets without opting in
  static constexpr size_t WALK_STATIC = NW * (sizeof(long long) + 3 * sizeof(int));
  static_assert(32 % TR == 0, "a lane copies whole rows of a tile");
};

// The walks of one warp of (a) or (e): NW consecutive blocks of one chain;
// walk k is block group * NW + k, the rows [first[k], first[k] + len[k]) of
// the chain, row start[k] of the (C * N)-row arrays; walks past the chain's
// last block have len 0.  At J <= 4 (NW = kGroup) the warp's walks are a
// group.
struct RicWarp {
  long long chain;
  int group;
};

template <int NW>
__device__ __forceinline__ RicWarp ric_walks(int N, int L, int NB,
                                             long long* start, int* len,
                                             int* first, int* block) {
  const int WB = (NB + NW - 1) / NW;
  const RicWarp w{blockIdx.x / WB, (int)(blockIdx.x % WB)};
  if (threadIdx.x < NW) {
    const int k = threadIdx.x, b = w.group * NW + k;
    const bool live = b < NB;
    first[k] = live ? b * L : 0;
    start[k] = w.chain * N + first[k];
    len[k] = live ? min(L, N - b * L) : 0;
    block[k] = b;
  }
  __syncwarp();
  return w;
}

// Copies rows [s TR, (s + 1) TR) of every walk into a tile: p of each row,
// u, v, a and the chunk's columns of y of the row before it.  Row 0 of a
// chain takes u, v and a of the row given before it (``Pv``: the previous
// row's a (C), u and v (C, J), the Riccati family only), and without one
// is the identity.  Lane j copies row j % TR of the walks j / TR,
// j / TR + 32 / TR, ...
template <typename T>
struct RicPrev {
  const T* a;  // (C), or null: row 0 of a chain is the identity
  const T* U;  // (C, J)
  const T* V;  // (C, J)
};

template <typename T, int J, bool KAL>
__device__ __forceinline__ void ric_stage(
    T* tile, const T* __restrict__ p, const T* __restrict__ a,
    const T* __restrict__ U, const T* __restrict__ V, const T* __restrict__ Y,
    const RicPrev<T>& Pv, int N, int K, int k0, int kc,
    const long long* start, const int* len, const int* first, int s) {
  using G = Ric<J, KAL>;
  constexpr int PI = G::PITCH;
  const int l = threadIdx.x % G::TR, n = s * G::TR + l;
  for (int k = threadIdx.x / G::TR; k < G::NW; k += 32 / G::TR) {
    if (n >= len[k]) continue;
    const long long r = start[k] + n;
    T* dst = tile + l * G::WIN * PI + k;
#pragma unroll
    for (int f = 0; f < J; ++f)
      cp_async_elem(dst + (G::IP + f) * PI, p + r * J + f);
    if (first[k] + n == 0) {
      if (KAL || Pv.a == nullptr) continue;
      const long long c = r / N;
#pragma unroll
      for (int f = 0; f < J; ++f) {
        cp_async_elem(dst + (G::IU + f) * PI, Pv.U + c * J + f);
        cp_async_elem(dst + (G::IV + f) * PI, Pv.V + c * J + f);
      }
      cp_async_elem(dst + G::IA * PI, Pv.a + c);
      continue;
    }
#pragma unroll
    for (int f = 0; f < J; ++f) {
      cp_async_elem(dst + (G::IU + f) * PI, U + (r - 1) * J + f);
      cp_async_elem(dst + (G::IV + f) * PI, V + (r - 1) * J + f);
    }
    cp_async_elem(dst + G::IA * PI, a + r - 1);
    if (KAL)
      for (int f = 0; f < kc; ++f)
        cp_async_elem(dst + (G::IY + f) * PI, Y + (r - 1) * K + k0 + f);
  }
  cp_async_commit();
}

// One staged row as a walk reads it (x at value 0 of the row of the lane's
// walk).  A row that is not live (past the walk's end, or row 0 of a chain)
// reads as the identity element: p = 1, u = v = y = 0, a = 1, which leaves a
// map or a state as it is.
template <typename T, int J, bool KAL>
struct RicRow {
  using G = Ric<J, KAL>;
  const T* x;
  bool live;
  int kc;
  __device__ T p(int j) const { return live ? x[(G::IP + j) * G::PITCH] : T(1); }
  __device__ T u(int j) const { return live ? x[(G::IU + j) * G::PITCH] : T(0); }
  __device__ T v(int j) const { return live ? x[(G::IV + j) * G::PITCH] : T(0); }
  __device__ T a() const { return live ? safe_pos(x[G::IA * G::PITCH]) : T(1); }
  __device__ T y(int k) const {
    return live && k < kc ? x[(G::IY + k) * G::PITCH] : T(0);
  }
};

// sum over the team's lanes (every lane gets the same bits)
template <int P, typename T>
__device__ __forceinline__ T team_sum(T v) {
#pragma unroll
  for (int off = P / 2; off > 0; off /= 2) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// entry j of a vector the team holds R entries a lane of (lane t of the
// team entries t, t + P, ...)
template <int P, int R, typename T>
__device__ __forceinline__ T team_get(const T (&x)[R], int j) {
  if constexpr (P == 1)
    return x[j];
  else
    return __shfl_sync(kFull, x[j / P], j % P, P);
}

// The running map of a walk of (a): lane t of its team holds, for its rows
// i_m = t + P m, column i_m of A (A[m][j] = A[j][i_m]) and row i_m of Q, R,
// b, eta.
template <typename T, int J, bool KAL>
struct RicMap {
  using G = Ric<J, KAL>;
  static constexpr int P = G::P, R = G::R, KC = G::KC, KR = G::KR;
  T A[R][J], Q[R][J], Rm[R][J], b[R][KR], e[R][KR];

  __device__ void identity(int t) {
#pragma unroll
    for (int m = 0; m < R; ++m) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        A[m][j] = j == t + P * m ? T(1) : T(0);
        Q[m][j] = Rm[m][j] = T(0);
      }
#pragma unroll
      for (int k = 0; k < KR; ++k) b[m][k] = e[m][k] = T(0);
    }
  }

  __device__ void step(const RicRow<T, J, KAL>& w, int t) {
    T x[R], g[R], wv[R];
    T s = T(0), zs[KR];
#pragma unroll
    for (int k = 0; k < KR; ++k) zs[k] = T(0);
#pragma unroll
    for (int m = 0; m < R; ++m) {
      T xi = T(0), gi = T(0);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const T uj = w.u(j);
        xi += Q[m][j] * uj;
        gi += A[m][j] * uj;
      }
      x[m] = xi;
      g[m] = gi;
      const T ui = w.u(t + P * m);
      s += ui * xi;
#pragma unroll
      for (int k = 0; k < KC; ++k) zs[k] += b[m][k] * ui;
    }
    s = team_sum<P>(s);
    T z[KR];
#pragma unroll
    for (int k = 0; k < KC; ++k) z[k] = w.y(k) - team_sum<P>(zs[k]);
    const T delta = w.a() - s;
    const T inv = T(1) / safe_pos(delta);
#pragma unroll
    for (int m = 0; m < R; ++m) wv[m] = (w.v(t + P * m) - x[m]) * inv;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const T wj = team_get<P, R>(wv, j), gj = team_get<P, R>(g, j);
      const T pj = w.p(j);
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const T pi = w.p(t + P * m);
        A[m][j] = pj * (A[m][j] - wj * g[m]);
        Q[m][j] = (pi * pj) * (Q[m][j] + delta * (wv[m] * wj));
        Rm[m][j] = Rm[m][j] - (g[m] * gj) * inv;
      }
    }
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const T pi = w.p(t + P * m);
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        b[m][k] = pi * (b[m][k] + wv[m] * z[k]);
        e[m][k] = e[m][k] - g[m] * z[k] * inv;
      }
    }
  }

  __device__ void store(T* out, int t) const {
    constexpr int JJ = G::JJ;
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const int i = t + P * m;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        out[j * J + i] = A[m][j];
        out[JJ + i * J + j] = Q[m][j];
        out[2 * JJ + i * J + j] = Rm[m][j];
      }
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        out[3 * JJ + i * KC + k] = b[m][k];
        out[3 * JJ + J * KC + i * KC + k] = e[m][k];
      }
    }
  }
};

// The state (S, F) of a walk of (e), rows i_m of S and F a lane: the
// factor's and the lower solve's row step S <- p (S + delta w w^T) p,
// F <- p (F + w z^T).
template <typename T, int J, bool KAL>
struct RicState {
  using G = Ric<J, KAL>;
  static constexpr int P = G::P, R = G::R, KC = G::KC, KR = G::KR;
  T S[R][J], F[R][KR];

  // from st = [S | F] (null: zero)
  __device__ void load(const T* st, int t) {
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const int i = t + P * m;
#pragma unroll
      for (int j = 0; j < J; ++j) S[m][j] = st ? st[i * J + j] : T(0);
#pragma unroll
      for (int k = 0; k < KR; ++k)
        F[m][k] = st && k < KC ? st[G::JJ + i * KC + k] : T(0);
    }
  }

  __device__ void step(const RicRow<T, J, KAL>& w, int t) {
    T x[R], wv[R];
    T s = T(0), zs[KR];
#pragma unroll
    for (int k = 0; k < KR; ++k) zs[k] = T(0);
#pragma unroll
    for (int m = 0; m < R; ++m) {
      T xi = T(0);
#pragma unroll
      for (int j = 0; j < J; ++j) xi += S[m][j] * w.u(j);
      x[m] = xi;
      const T ui = w.u(t + P * m);
      s += ui * xi;
#pragma unroll
      for (int k = 0; k < KC; ++k) zs[k] += F[m][k] * ui;
    }
    s = team_sum<P>(s);
    T z[KR];
#pragma unroll
    for (int k = 0; k < KC; ++k) z[k] = w.y(k) - team_sum<P>(zs[k]);
    const T delta = w.a() - s;
    const T inv = T(1) / safe_pos(delta);
#pragma unroll
    for (int m = 0; m < R; ++m) wv[m] = (w.v(t + P * m) - x[m]) * inv;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const T wj = team_get<P, R>(wv, j), pj = w.p(j);
#pragma unroll
      for (int m = 0; m < R; ++m)
        S[m][j] = (w.p(t + P * m) * pj) * (S[m][j] + delta * (wv[m] * wj));
    }
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const T pi = w.p(t + P * m);
#pragma unroll
      for (int k = 0; k < KC; ++k) F[m][k] = pi * (F[m][k] + wv[m] * z[k]);
    }
  }

  // into row l of the output tile of walk k (o at value 0 of that row)
  __device__ void put(T* o, int t) const {
    constexpr int PI = G::PITCH;
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const int i = t + P * m;
#pragma unroll
      for (int j = 0; j < J; ++j) o[(i * J + j) * PI] = S[m][j];
#pragma unroll
      for (int k = 0; k < KC; ++k) o[(G::JJ + i * KC + k) * PI] = F[m][k];
    }
  }
};

// Stores the output tile of rows [s TR, (s + 1) TR) of every walk: S (if
// not null) and the chunk's columns of F.  A walk's rows of S in the tile
// are TR J^2 consecutive values of S, and consecutive lanes take
// consecutive values; of F, consecutive lanes take consecutive rows of its
// TR J rows of K values.  Several walks a store where a walk has fewer
// than 32, and every divisor is a constant.
template <typename T, int J, bool KAL>
__device__ __forceinline__ void ric_unstage(T* __restrict__ S,
                                            T* __restrict__ F, const T* out,
                                            const long long* start,
                                            const int* len, int s, int K,
                                            int k0, int kc) {
  using G = Ric<J, KAL>;
  constexpr int JJ = G::JJ, PI = G::PITCH, KC = G::KC;
  constexpr int LS = G::TR * JJ < 32 ? G::TR * JJ : 32;  // lanes a walk: S
  const int lane = threadIdx.x;
  if (S != nullptr)
    for (int k = lane / LS; k < G::NW; k += 32 / LS) {
      const int n = min(G::TR, len[k] - s * G::TR) * JJ;
      const long long base = (start[k] + s * G::TR) * JJ;
      for (int e = lane % LS; e < n; e += LS)
        S[base + e] = out[((e / JJ) * G::ST + e % JJ) * PI + k];
    }
  if constexpr (KAL) {  // a lane a row i of F in a row: its kc columns
    constexpr int LF = G::TR * J < 32 ? G::TR * J : 32;
    for (int k = lane / LF; k < G::NW; k += 32 / LF) {
      const int n = min(G::TR, len[k] - s * G::TR) * J;
      const long long r0 = start[k] + s * G::TR;
      for (int e = lane % LF; e < n; e += LF) {
        T* dst = F + (r0 * J + e) * K + k0;
        const T* src = out + ((e / J) * G::ST + JJ + (e % J) * KC) * PI + k;
        for (int c = 0; c < kc; ++c) dst[c] = src[c * PI];
      }
    }
  }
}

// Gauss-Jordan elimination with partial pivoting on the J x W augmented
// matrix aug in registers, the rule of RicLevel::gauss_jordan: the pivot of
// column c is the first largest |aug[r][c]|, r >= c, its magnitude floored
// at the smallest normal number.  Every index is a constant once unrolled.
template <typename T, int J, int W>
__device__ __forceinline__ void gauss_jordan_regs(T (&aug)[J][W]) {
#pragma unroll
  for (int c = 0; c < J; ++c) {
    int piv = c;
    T best = fabs(aug[c][c]);
#pragma unroll
    for (int r = c + 1; r < J; ++r)
      if (fabs(aug[r][c]) > best) {
        best = fabs(aug[r][c]);
        piv = r;
      }
#pragma unroll
    for (int r = c + 1; r < J; ++r)
      if (piv == r)
#pragma unroll
        for (int q = 0; q < W; ++q) {
          const T tmp = aug[c][q];
          aug[c][q] = aug[r][q];
          aug[r][q] = tmp;
        }
    T pv = aug[c][c];
    if (fabs(pv) < Tiny<T>::value()) pv = Tiny<T>::value();
    const T inv = T(1) / pv;
#pragma unroll
    for (int q = 0; q < W; ++q) aug[c][q] *= inv;
#pragma unroll
    for (int r = 0; r < J; ++r) {
      if (r == c) continue;
      const T f = aug[r][c];
#pragma unroll
      for (int q = 0; q < W; ++q) aug[r][q] -= f * aug[c][q];
    }
  }
}

// The levels' algebra at J <= 4, one thread a combine or an application,
// in registers: RicLevel's combine and apply (elements.kalman_combine,
// kalman_distribute), term for term.  A map is E values [A | Q | R | b |
// eta] anywhere in memory, a state ST values [S | F] in registers.
template <typename T, int J, bool KAL>
struct RicRegs {
  using G = Ric<J, KAL>;
  static constexpr int JJ = G::JJ, KC = G::KC, KR = G::KR, E = G::E,
                       ST = G::ST;

  __device__ static void identity(T* m) {
    for (int e = 0; e < E; ++e) m[e] = (e < JJ && e / J == e % J) ? T(1) : T(0);
  }

  // out = the map m1 (earlier) composed with m2 (later); out aliases neither
  __device__ static void combine(const T* m1, const T* m2, T* out) {
    const T *A1 = m1, *Q1 = m1 + JJ, *R1 = m1 + 2 * JJ, *b1 = m1 + 3 * JJ;
    const T *A2 = m2, *Q2 = m2 + JJ, *R2 = m2 + 2 * JJ, *b2 = m2 + 3 * JJ;
    const T *e1 = b1 + J * KC, *e2 = b2 + J * KC;
    constexpr int WC = 3 * J + KC;  // [I + Q1 R2 | A1 | Q1 | b1 + Q1 eta2]
    T X[J][WC];
#pragma unroll
    for (int i = 0; i < J; ++i) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        T s = (i == j) ? T(1) : T(0);
#pragma unroll
        for (int k = 0; k < J; ++k) s += Q1[i * J + k] * R2[k * J + j];
        X[i][j] = s;
        X[i][J + j] = A1[i * J + j];
        X[i][2 * J + j] = Q1[i * J + j];
      }
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        T s = b1[i * KC + k];
#pragma unroll
        for (int l = 0; l < J; ++l) s += Q1[i * J + l] * e2[l * KC + k];
        X[i][3 * J + k] = s;
      }
    }
    gauss_jordan_regs<T, J, WC>(X);
    T T1[J][J], T2[J][J], v1[J][KR];  // A2 X_Q, R2 X_A, eta2 - R2 b1
#pragma unroll
    for (int i = 0; i < J; ++i) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        T sa = T(0), st = T(0), su = T(0);
#pragma unroll
        for (int k = 0; k < J; ++k) {
          sa += A2[i * J + k] * X[k][J + j];
          st += A2[i * J + k] * X[k][2 * J + j];
          su += R2[i * J + k] * X[k][J + j];
        }
        out[i * J + j] = sa;
        T1[i][j] = st;
        T2[i][j] = su;
      }
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        T sb = b2[i * KC + k], sv = e2[i * KC + k];
#pragma unroll
        for (int l = 0; l < J; ++l) {
          sb += A2[i * J + l] * X[l][3 * J + k];
          sv -= R2[i * J + l] * b1[l * KC + k];
        }
        out[3 * JJ + i * KC + k] = sb;
        v1[i][k] = sv;
      }
    }
    T T3[J][J], T4[J][J];  // Q2 + T1 A2^T, R1 + A1^T T2
#pragma unroll
    for (int i = 0; i < J; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        T sq = Q2[i * J + j], sr = R1[i * J + j];
#pragma unroll
        for (int k = 0; k < J; ++k) {
          sq += T1[i][k] * A2[j * J + k];
          sr += A1[k * J + i] * T2[k][j];
        }
        T3[i][j] = sq;
        T4[i][j] = sr;
      }
#pragma unroll
    for (int i = 0; i < J; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        out[JJ + i * J + j] = T(0.5) * (T3[i][j] + T3[j][i]);
        out[2 * JJ + i * J + j] = T(0.5) * (T4[i][j] + T4[j][i]);
      }
    if constexpr (KC > 0) {  // eta = eta1 + A1^T (v1 - R2 X_Q v1)
      T v2[J][KC], v3[J][KC];
#pragma unroll
      for (int i = 0; i < J; ++i)
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          T s = T(0);
#pragma unroll
          for (int l = 0; l < J; ++l) s += X[i][2 * J + l] * v1[l][k];
          v2[i][k] = s;
        }
#pragma unroll
      for (int i = 0; i < J; ++i)
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          T s = v1[i][k];
#pragma unroll
          for (int l = 0; l < J; ++l) s -= R2[i * J + l] * v2[l][k];
          v3[i][k] = s;
        }
#pragma unroll
      for (int i = 0; i < J; ++i)
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          T s = e1[i * KC + k];
#pragma unroll
          for (int l = 0; l < J; ++l) s += A1[l * J + i] * v3[l][k];
          out[3 * JJ + J * KC + i * KC + k] = s;
        }
    }
  }

  // the state [S | F] after the map m:
  //   X = (I + S R)^{-1} [S | F + S eta],  S <- sym(Q + A X_S A^T),
  //   F <- b + A X_F
  __device__ static void apply(const T* m, T (&st)[ST]) {
    const T *A = m, *Q = m + JJ, *R = m + 2 * JJ, *b = m + 3 * JJ,
            *eta = b + J * KC;
    constexpr int WD = 2 * J + KC;  // [I + S R | S | F + S eta]
    T X[J][WD];
#pragma unroll
    for (int i = 0; i < J; ++i) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        T s = (i == j) ? T(1) : T(0);
#pragma unroll
        for (int k = 0; k < J; ++k) s += st[i * J + k] * R[k * J + j];
        X[i][j] = s;
        X[i][J + j] = st[i * J + j];
      }
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        T s = st[JJ + i * KC + k];
#pragma unroll
        for (int l = 0; l < J; ++l) s += st[i * J + l] * eta[l * KC + k];
        X[i][2 * J + k] = s;
      }
    }
    gauss_jordan_regs<T, J, WD>(X);
    T T1[J][J], T2[J][J];  // A X_S, Q + T1 A^T
#pragma unroll
    for (int i = 0; i < J; ++i) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < J; ++k) s += A[i * J + k] * X[k][J + j];
        T1[i][j] = s;
      }
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        T s = b[i * KC + k];
#pragma unroll
        for (int l = 0; l < J; ++l) s += A[i * J + l] * X[l][2 * J + k];
        st[JJ + i * KC + k] = s;
      }
    }
#pragma unroll
    for (int i = 0; i < J; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        T s = Q[i * J + j];
#pragma unroll
        for (int k = 0; k < J; ++k) s += T1[i][k] * A[j * J + k];
        T2[i][j] = s;
      }
#pragma unroll
    for (int i = 0; i < J; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) st[i * J + j] = T(0.5) * (T2[i][j] + T2[j][i]);
  }

  // the state after m from zero: (Q, b)
  __device__ static void state_of(const T* m, T (&st)[ST]) {
#pragma unroll
    for (int e = 0; e < JJ; ++e) st[e] = m[JJ + e];
#pragma unroll
    for (int e = 0; e < J * KC; ++e) st[JJ + e] = m[3 * JJ + e];
  }
};

// The row walk of (a) and (e), one warp: the rows of its walks staged by
// tiles (cp.async, one tile ahead of the walk), then row(l, w) for row l of
// the tile of the lane's walk, in order, and end(s) after the rows of tile
// s.  A team's shuffles need every lane, so there the rows past a walk's end
// read as the identity (RicRow), as row 0 of a chain does without a
// previous row.
template <typename T, int J, bool KAL, class Row, class End>
__device__ __forceinline__ void ric_over_rows(
    T* tiles, const T* __restrict__ p, const T* __restrict__ a,
    const T* __restrict__ U, const T* __restrict__ V, const T* __restrict__ Y,
    const RicPrev<T>& Pv, int N, int K, int L, int k0, int kc,
    const long long* start, const int* len, const int* first, Row row,
    End end) {
  using G = Ric<J, KAL>;
  const int k = threadIdx.x / G::P, mine = len[k], n0 = first[k];
  const int ntiles = (min(L, N) + G::TR - 1) / G::TR;
  const int from = (!KAL && Pv.a != nullptr) ? 0 : 1;  // first live row
  ric_stage<T, J, KAL>(tiles, p, a, U, V, Y, Pv, N, K, k0, kc, start, len,
                       first, 0);
  for (int s = 0; s < ntiles; ++s) {
    if (s + 1 < ntiles) {
      ric_stage<T, J, KAL>(tiles + ((s + 1) & 1) * G::TILE, p, a, U, V, Y, Pv,
                           N, K, k0, kc, start, len, first, s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const T* tile = tiles + (s & 1) * G::TILE + k;
    const int rows = G::P == 1 ? min(G::TR, mine - s * G::TR) : G::TR;
#pragma unroll 1
    for (int l = 0; l < rows; ++l) {
      const int n = s * G::TR + l;
      row(l, RicRow<T, J, KAL>{tile + l * G::WIN * G::PITCH,
                               n < mine && n0 + n >= from, kc});
    }
    __syncwarp();
    end(s);
  }
}

// (a): the map of every block (one warp: NW blocks of one chain and chunk),
// into ``maps`` (C, chunks, NB, E).  At J <= 4 the warp's blocks are a
// group, and ``maps`` gets each block's prefix within its group (the
// composition of the group's blocks up to it) and ``totals`` (C, chunks,
// GB, E) the group's map.
template <typename T, int J, bool KAL>
__global__ void __launch_bounds__(32, 1)
    ric_maps_kernel(const T* __restrict__ p, const T* __restrict__ a,
                    const T* __restrict__ U, const T* __restrict__ V,
                    const T* __restrict__ Y, RicPrev<T> Pv,
                    T* __restrict__ maps, T* __restrict__ totals, int N, int K,
                    int L, int NB, int GB) {
  using G = Ric<J, KAL>;
  constexpr int E = G::E;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tiles = reinterpret_cast<T*>(smem_raw);
  __shared__ long long start[G::NW];
  __shared__ int len[G::NW], first[G::NW], block[G::NW];
  const RicWarp w = ric_walks<G::NW>(N, L, NB, start, len, first, block);
  const long long cc = w.chain * gridDim.y + blockIdx.y;
  const int k0 = blockIdx.y * G::KC, kc = KAL ? min(G::KC, K - k0) : 0;
  const int lane = threadIdx.x, t = lane % G::P, k = lane / G::P;

  RicMap<T, J, KAL> acc;
  acc.identity(t);
  ric_over_rows<T, J, KAL>(
      tiles, p, a, U, V, Y, Pv, N, K, L, k0, kc, start, len, first,
      [&](int, const RicRow<T, J, KAL>& row) { acc.step(row, t); },
      [](int) {});
  if constexpr (G::P == 1) {
    // Kogge-Stone over the lanes in the tiles (every lane is done with
    // them); a lane past the chain's last block holds the identity
    using X = RicRegs<T, J, KAL>;
    constexpr int SL = G::SLOT;
    T* src = tiles;
    T* dst = tiles + kGroup * SL;
    acc.store(src + lane * SL, 0);
    __syncwarp();
    for (int d = 1; d < kGroup; d *= 2) {
      if (lane >= d)
        X::combine(src + (lane - d) * SL, src + lane * SL, dst + lane * SL);
      else
        for (int e = 0; e < E; ++e) dst[lane * SL + e] = src[lane * SL + e];
      __syncwarp();
      T* tmp = src;
      src = dst;
      dst = tmp;
    }
    const T* mine = src + lane * SL;
    if (len[lane] > 0) {
      T* o = maps + (cc * NB + block[lane]) * E;
      for (int e = 0; e < E; ++e) o[e] = mine[e];
    }
    if (lane == kGroup - 1) {
      T* o = totals + (cc * GB + w.group) * E;
      for (int e = 0; e < E; ++e) o[e] = mine[e];
    }
  } else if (len[k] > 0) {
    acc.store(maps + (cc * NB + block[k]) * E, t);
  }
}

// (e): the state after every row, from the state entering each block.  At
// J <= 4 that is ``states`` (C, chunks, GB, ST), the state entering the
// group, carried over ``maps``' prefix of the blocks before it in the group;
// from J = 8 ``states`` (C, chunks, NB, ST) holds it.  Where ``states`` is
// null, the state entering the chain: ``S0`` (C, J, J) of the Riccati
// family, or zero.  S is written by chunk 0 only.
template <typename T, int J, bool KAL>
__global__ void __launch_bounds__(32, 1)
    ric_apply_kernel(const T* __restrict__ p, const T* __restrict__ a,
                     const T* __restrict__ U, const T* __restrict__ V,
                     const T* __restrict__ Y, RicPrev<T> Pv,
                     const T* __restrict__ S0, const T* __restrict__ maps,
                     const T* __restrict__ states, T* __restrict__ S,
                     T* __restrict__ F, int N, int K, int L, int NB, int GB) {
  using G = Ric<J, KAL>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tiles = reinterpret_cast<T*>(smem_raw);
  T* out = tiles + 2 * G::TILE;
  __shared__ long long start[G::NW];
  __shared__ int len[G::NW], first[G::NW], block[G::NW];
  const RicWarp w = ric_walks<G::NW>(N, L, NB, start, len, first, block);
  const long long cc = w.chain * gridDim.y + blockIdx.y;
  const int k0 = blockIdx.y * G::KC, kc = KAL ? min(G::KC, K - k0) : 0;
  const int lane = threadIdx.x, t = lane % G::P, k = lane / G::P;
  T* Sout = blockIdx.y == 0 ? S : nullptr;

  // the state entering the chain (ST = J^2 without right-hand sides)
  const T* s0 = (!KAL && S0 != nullptr) ? S0 + w.chain * G::ST : nullptr;
  RicState<T, J, KAL> st;
  if constexpr (G::P == 1) {
    T x[G::ST];
    const T* gs = states != nullptr ? states + (cc * GB + w.group) * G::ST
                                    : s0;
#pragma unroll
    for (int e = 0; e < G::ST; ++e) x[e] = gs ? gs[e] : T(0);
    if (lane > 0 && len[lane] > 0)
      RicRegs<T, J, KAL>::apply(maps + (cc * NB + block[lane] - 1) * G::E, x);
    st.load(x, 0);
  } else {
    st.load(states != nullptr
                ? (len[k] > 0 ? states + (cc * NB + block[k]) * G::ST : nullptr)
                : s0,
            t);
  }
  ric_over_rows<T, J, KAL>(
      tiles, p, a, U, V, Y, Pv, N, K, L, k0, kc, start, len, first,
      [&](int l, const RicRow<T, J, KAL>& row) {
        st.step(row, t);
        st.put(out + l * G::ST * G::PITCH + k, t);
      },
      [&](int s) {
        ric_unstage<T, J, KAL>(Sout, F, out, start, len, s, K, k0, kc);
        __syncwarp();
      });
}

// (b) at J <= 4: one thread block a (chain, chunk) over its GB group maps
// (``totals``), writing the state entering every group, ``gstates``
// (C, chunks, GB, ST), from ``S0`` (C, J, J; zero when null) of the Riccati
// family.  Thread t takes the run of groups [t per, (t + 1) per): it
// composes the run's maps, a Kogge-Stone scan in shared memory (two slots a
// thread) composes the runs, and the thread carries the state entering its
// run over the run's maps.  With ``total`` the last thread writes the
// composition of every group's map there (C, chunks, E); with ``gstates``
// null that is all.
constexpr int kScanThreads = 128;

template <typename T, int J, bool KAL>
__global__ void __launch_bounds__(kScanThreads, 1)
    ric_carry_kernel(const T* __restrict__ totals, T* __restrict__ gstates,
                     const T* __restrict__ S0, T* __restrict__ total,
                     int GB) {
  using X = RicRegs<T, J, KAL>;
  constexpr int E = X::E, ST = X::ST, SL = Ric<J, KAL>::SLOT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const long long cc = (long long)blockIdx.x * gridDim.y + blockIdx.y;
  const T* cm = totals + cc * GB * E;
  T* cs = gstates + cc * GB * ST;
  const int per = (GB + kScanThreads - 1) / kScanThreads;
  const int lo = min(GB, tid * per), hi = min(GB, lo + per);

  T* mine = buf + tid * SL;
  T* cur = mine;
  T* nxt = buf + (kScanThreads + tid) * SL;
  if (lo < hi)
    for (int e = 0; e < E; ++e) cur[e] = cm[(long long)lo * E + e];
  else
    X::identity(cur);
  for (int q = lo + 1; q < hi; ++q) {
    X::combine(cur, cm + (long long)q * E, nxt);
    T* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  if (cur != mine)
    for (int e = 0; e < E; ++e) mine[e] = cur[e];
  __syncthreads();

  T* src = buf;
  T* dst = buf + kScanThreads * SL;
  for (int d = 1; d < kScanThreads; d *= 2) {
    if (tid >= d)
      X::combine(src + (tid - d) * SL, src + tid * SL, dst + tid * SL);
    else
      for (int e = 0; e < E; ++e) dst[tid * SL + e] = src[tid * SL + e];
    __syncthreads();
    T* tmp = src;
    src = dst;
    dst = tmp;
  }

  if (total != nullptr && tid == kScanThreads - 1)
    for (int e = 0; e < E; ++e) total[cc * E + e] = src[tid * SL + e];
  if (gstates == nullptr) return;
  T st[ST];
  const T* s0 = (!KAL && S0 != nullptr) ? S0 + blockIdx.x * (long long)ST : nullptr;
  if (tid == 0 || s0 != nullptr) {
#pragma unroll
    for (int e = 0; e < ST; ++e) st[e] = s0 ? s0[e] : T(0);
    if (tid > 0) X::apply(src + (tid - 1) * SL, st);
  } else {
    X::state_of(src + (tid - 1) * SL, st);
  }
  for (int q = lo; q < hi; ++q) {
    T* o = cs + (long long)q * ST;
#pragma unroll
    for (int e = 0; e < ST; ++e) o[e] = st[e];
    if (q + 1 < hi) X::apply(cm + (long long)q * E, st);
  }
}

// The levels' algebra on maps and states in shared memory, by the NT
// threads of a level kernel: one warp up to J = 8, eight from J = 16, where
// a combine's O(J^3) products and eliminations outweigh the barriers.
template <typename T, int J, bool KAL>
struct RicLevel {
  using G = Ric<J, KAL>;
  static constexpr int NT = J >= 16 ? 256 : 32;
  static constexpr int JJ = G::JJ, KC = G::KC, E = G::E, ST = G::ST;
  static constexpr int WC = 3 * J + KC;  // [I + Q1 R2 | A1 | Q1 | b1 + Q1 eta2]
  static constexpr int WD = 2 * J + KC;  // [I + S R | S | F + S eta]
  static constexpr int SCRATCH = J * WC + 4 * JJ + 3 * J * KC + J;
  // a level kernel's shared memory: four maps, a state, the scratch
  static constexpr size_t SMEM = (4 * E + ST + SCRATCH) * sizeof(T);

  __device__ static void sync() {
    if constexpr (NT == 32)
      __syncwarp();
    else
      __syncthreads();
  }

  // Gauss-Jordan elimination with partial pivoting on the J x W augmented
  // matrix aug: the pivot of column c is the first largest |aug[r][c]|,
  // r >= c (a reduction over the first J lanes of warp 0), its magnitude
  // floored at the smallest normal number; one entry a thread in the
  // elimination.
  template <int W>
  __device__ static void gauss_jordan(T* aug, T* sf) {
    __shared__ int spiv;
    const int tid = threadIdx.x;
    for (int c = 0; c < J; ++c) {
      int piv = c;
      if (tid < 32) {
        T best = T(-1);
        int at = J;
        if (tid >= c && tid < J) {
          best = fabs(aug[tid * W + c]);
          at = tid;
        }
#pragma unroll
        for (int off = J / 2; off > 0; off /= 2) {
          const T ob = __shfl_xor_sync(kFull, best, off);
          const int oa = __shfl_xor_sync(kFull, at, off);
          if (ob > best || (ob == best && oa < at)) {
            best = ob;
            at = oa;
          }
        }
        at = __shfl_sync(kFull, at, 0);
        piv = at < J ? at : c;
        if (NT > 32 && tid == 0) spiv = piv;
      }
      if constexpr (NT > 32) {
        __syncthreads();
        piv = spiv;
      }
      if (piv != c)
        for (int q = tid; q < W; q += NT) {
          const T tmp = aug[c * W + q];
          aug[c * W + q] = aug[piv * W + q];
          aug[piv * W + q] = tmp;
        }
      sync();
      T pv = aug[c * W + c];
      if (fabs(pv) < Tiny<T>::value()) pv = Tiny<T>::value();
      const T inv = T(1) / pv;
      sync();
      for (int q = tid; q < W; q += NT) aug[c * W + q] *= inv;
      for (int r = tid; r < J; r += NT) sf[r] = (r == c) ? T(0) : aug[r * W + c];
      sync();
      for (int e = tid; e < J * W; e += NT) {
        const int r = e / W, q = e % W;
        if (r != c) aug[r * W + q] -= sf[r] * aug[c * W + q];
      }
      sync();
    }
  }

  // out = the map m1 (earlier) composed with m2 (later):
  //   X = (I + Q1 R2)^{-1} [A1 | Q1 | b1 + Q1 eta2],
  //   A = A2 X_A,  Q = sym(Q2 + A2 X_Q A2^T),  R = sym(R1 + A1^T R2 X_A),
  //   b = b2 + A2 X_b,  eta = eta1 + A1^T (vE - R2 X_Q vE),  vE = eta2 - R2 b1
  // (elements.kalman_combine).  out aliases neither.
  __device__ static void combine(const T* m1, const T* m2, T* out, T* scr) {
    const int tid = threadIdx.x;
    const T *A1 = m1, *Q1 = m1 + JJ, *R1 = m1 + 2 * JJ, *b1 = m1 + 3 * JJ;
    const T *A2 = m2, *Q2 = m2 + JJ, *R2 = m2 + 2 * JJ, *b2 = m2 + 3 * JJ;
    const T *e1 = b1 + J * KC, *e2 = b2 + J * KC;
    T *aug = scr, *T1 = aug + J * WC, *T2 = T1 + JJ, *T3 = T2 + JJ,
      *T4 = T3 + JJ, *v1 = T4 + JJ, *v2 = v1 + J * KC, *v3 = v2 + J * KC,
      *sf = v3 + J * KC;
    for (int e = tid; e < JJ; e += NT) {
      const int i = e / J, j = e % J;
      T s = (i == j) ? T(1) : T(0);
      for (int k = 0; k < J; ++k) s += Q1[i * J + k] * R2[k * J + j];
      aug[i * WC + j] = s;
      aug[i * WC + J + j] = A1[e];
      aug[i * WC + 2 * J + j] = Q1[e];
    }
    for (int e = tid; e < J * KC; e += NT) {
      const int i = e / KC, k = e % KC;
      T s = b1[e];
      for (int l = 0; l < J; ++l) s += Q1[i * J + l] * e2[l * KC + k];
      aug[i * WC + 3 * J + k] = s;
    }
    sync();
    gauss_jordan<WC>(aug, sf);
    const T *XA = aug + J, *XQ = aug + 2 * J, *Xb = aug + 3 * J;
    for (int e = tid; e < JJ; e += NT) {
      const int i = e / J, j = e % J;
      T sa = T(0), st = T(0), su = T(0);
      for (int k = 0; k < J; ++k) {
        sa += A2[i * J + k] * XA[k * WC + j];
        st += A2[i * J + k] * XQ[k * WC + j];
        su += R2[i * J + k] * XA[k * WC + j];
      }
      out[e] = sa;
      T1[e] = st;
      T2[e] = su;
    }
    for (int e = tid; e < J * KC; e += NT) {
      const int i = e / KC, k = e % KC;
      T sb = b2[e], sv = e2[e];
      for (int l = 0; l < J; ++l) {
        sb += A2[i * J + l] * Xb[l * WC + k];
        sv -= R2[i * J + l] * b1[l * KC + k];
      }
      out[3 * JJ + e] = sb;
      v1[e] = sv;
    }
    sync();
    for (int e = tid; e < JJ; e += NT) {
      const int i = e / J, j = e % J;
      T sq = Q2[e], sr = R1[e];
      for (int k = 0; k < J; ++k) {
        sq += T1[i * J + k] * A2[j * J + k];
        sr += A1[k * J + i] * T2[k * J + j];
      }
      T3[e] = sq;
      T4[e] = sr;
    }
    for (int e = tid; e < J * KC; e += NT) {
      const int i = e / KC, k = e % KC;
      T s = T(0);
      for (int l = 0; l < J; ++l) s += XQ[i * WC + l] * v1[l * KC + k];
      v2[e] = s;
    }
    sync();
    for (int e = tid; e < JJ; e += NT) {
      const int i = e / J, j = e % J;
      out[JJ + e] = T(0.5) * (T3[i * J + j] + T3[j * J + i]);
      out[2 * JJ + e] = T(0.5) * (T4[i * J + j] + T4[j * J + i]);
    }
    for (int e = tid; e < J * KC; e += NT) {
      const int i = e / KC, k = e % KC;
      T s = v1[e];
      for (int l = 0; l < J; ++l) s -= R2[i * J + l] * v2[l * KC + k];
      v3[e] = s;
    }
    sync();
    for (int e = tid; e < J * KC; e += NT) {
      const int i = e / KC, k = e % KC;
      T s = e1[e];
      for (int l = 0; l < J; ++l) s += A1[l * J + i] * v3[l * KC + k];
      out[3 * JJ + J * KC + e] = s;
    }
    sync();
  }

  // the state st = [S | F] after the map m, in place
  // (elements.kalman_distribute):
  //   X = (I + S R)^{-1} [S | F + S eta],  S <- sym(Q + A X_S A^T),
  //   F <- b + A X_F
  __device__ static void apply(T* st, const T* m, T* scr) {
    const int tid = threadIdx.x;
    const T *A = m, *Q = m + JJ, *R = m + 2 * JJ, *b = m + 3 * JJ,
            *eta = b + J * KC;
    T *S = st, *F = st + JJ;
    T *aug = scr, *T1 = aug + J * WC, *T2 = T1 + JJ, *sf = T2 + JJ;
    for (int e = tid; e < JJ; e += NT) {
      const int i = e / J, j = e % J;
      T s = (i == j) ? T(1) : T(0);
      for (int k = 0; k < J; ++k) s += S[i * J + k] * R[k * J + j];
      aug[i * WD + j] = s;
      aug[i * WD + J + j] = S[e];
    }
    for (int e = tid; e < J * KC; e += NT) {
      const int i = e / KC, k = e % KC;
      T s = F[e];
      for (int l = 0; l < J; ++l) s += S[i * J + l] * eta[l * KC + k];
      aug[i * WD + 2 * J + k] = s;
    }
    sync();
    gauss_jordan<WD>(aug, sf);
    for (int e = tid; e < JJ; e += NT) {
      const int i = e / J, j = e % J;
      T s = T(0);
      for (int k = 0; k < J; ++k) s += A[i * J + k] * aug[k * WD + J + j];
      T1[e] = s;
    }
    for (int e = tid; e < J * KC; e += NT) {
      const int i = e / KC, k = e % KC;
      T s = b[e];
      for (int l = 0; l < J; ++l) s += A[i * J + l] * aug[l * WD + 2 * J + k];
      F[e] = s;
    }
    sync();
    for (int e = tid; e < JJ; e += NT) {
      const int i = e / J, j = e % J;
      T s = Q[e];
      for (int k = 0; k < J; ++k) s += T1[i * J + k] * A[j * J + k];
      T2[e] = s;
    }
    sync();
    for (int e = tid; e < JJ; e += NT) {
      const int i = e / J, j = e % J;
      S[e] = T(0.5) * (T2[i * J + j] + T2[j * J + i]);
    }
    sync();
  }

  // copies n values global -> shared, asynchronously (one commit group)
  __device__ static void fetch(T* dst, const T* src, int n) {
    for (int e = threadIdx.x; e < n; e += NT) cp_async_elem(dst + e, src + e);
    cp_async_commit();
  }

  // dst = src, n values, by every thread (no barrier)
  __device__ static void copy(T* dst, const T* src, int n) {
    for (int e = threadIdx.x; e < n; e += NT) dst[e] = src[e];
  }
};

// The walk of a level kernel over ``count`` maps (from ``maps``, each E
// values, one map ahead in the two buffers ``buf``): body(i, map) for each
// in order.
template <typename T, int J, bool KAL, class Body>
__device__ __forceinline__ void ric_over_maps(const T* maps, int count,
                                              T* buf, Body body) {
  using V = RicLevel<T, J, KAL>;
  constexpr int E = V::E;
  if (count <= 0) return;
  V::fetch(buf, maps, E);
  for (int i = 0; i < count; ++i) {
    if (i + 1 < count) {
      V::fetch(buf + ((i + 1) & 1) * E, maps + (long long)(i + 1) * E, E);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    V::sync();
    body(i, buf + (i & 1) * E);
    V::sync();
  }
}

// The shared memory of a level kernel: X and O (two maps), the two map
// buffers of ric_over_maps, a state, the scratch.
template <typename T, int J, bool KAL>
struct RicLevelSmem {
  using V = RicLevel<T, J, KAL>;
  T *X, *O, *buf, *st, *scr;
  __device__ explicit RicLevelSmem(unsigned char* raw) {
    X = reinterpret_cast<T*>(raw);
    O = X + V::E;
    buf = O + V::E;
    st = buf + 2 * V::E;
    scr = st + V::ST;
  }
};

// (b): a (chain, chunk, group) composes the group's block maps in order
// into the group's map, ``totals`` (C, chunks, GB, E).
template <typename T, int J, bool KAL>
__global__ void __launch_bounds__(RicLevel<T, J, KAL>::NT, 1)
    ric_groups_kernel(const T* __restrict__ maps, T* __restrict__ totals,
                      int NB, int GB) {
  using V = RicLevel<T, J, KAL>;
  constexpr int E = V::E;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const RicLevelSmem<T, J, KAL> sm(smem_raw);
  T *X = sm.X, *O = sm.O, *scr = sm.scr;
  const long long cc = (blockIdx.x / GB) * gridDim.y + blockIdx.y;
  const int g = blockIdx.x % GB, b0 = g * kGroup, b1 = min(NB, b0 + kGroup);
  ric_over_maps<T, J, KAL>(maps + (cc * NB + b0) * E, b1 - b0, sm.buf,
                           [&](int i, const T* m) {
                             if (i == 0) {
                               V::copy(X, m, E);
                             } else {
                               V::combine(X, m, O, scr);
                               T* tmp = X;
                               X = O;
                               O = tmp;
                             }
                           });
  V::copy(totals + (cc * GB + g) * E, X, E);
}

// (c): a (chain, chunk) carries the state over the groups' maps, from
// ``S0`` (C, J, J; zero when null) of the Riccati family, and writes the
// state entering every group, ``gstates`` (C, chunks, GB, ST).
template <typename T, int J, bool KAL>
__global__ void __launch_bounds__(RicLevel<T, J, KAL>::NT, 1)
    ric_scan_kernel(const T* __restrict__ totals, T* __restrict__ gstates,
                    const T* __restrict__ S0, int GB) {
  using V = RicLevel<T, J, KAL>;
  constexpr int E = V::E, ST = V::ST;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const RicLevelSmem<T, J, KAL> sm(smem_raw);
  T *st = sm.st, *scr = sm.scr;
  const long long cc = (long long)blockIdx.x * gridDim.y + blockIdx.y;
  const T* s0 = (!KAL && S0 != nullptr) ? S0 + blockIdx.x * (long long)ST : nullptr;
  for (int e = threadIdx.x; e < ST; e += V::NT) st[e] = s0 ? s0[e] : T(0);
  V::sync();
  T* cs = gstates + cc * GB * ST;
  ric_over_maps<T, J, KAL>(totals + cc * GB * E, GB - 1, sm.buf,
                           [&](int g, const T* m) {
                             V::copy(cs + (long long)g * ST, st, ST);
                             V::apply(st, m, scr);
                           });
  V::copy(cs + (long long)(GB - 1) * ST, st, ST);
}

// (d): a (chain, chunk, group) carries the state entering its group
// (``gstates``; when null, ``S0`` (C, J, J) of the Riccati family, or zero)
// over the group's block maps and writes the state entering every block,
// ``cS`` (C, chunks, NB, ST).
template <typename T, int J, bool KAL>
__global__ void __launch_bounds__(RicLevel<T, J, KAL>::NT, 1)
    ric_enter_kernel(const T* __restrict__ maps,
                     const T* __restrict__ gstates, const T* __restrict__ S0,
                     T* __restrict__ cS, int NB, int GB) {
  using V = RicLevel<T, J, KAL>;
  constexpr int E = V::E, ST = V::ST;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const RicLevelSmem<T, J, KAL> sm(smem_raw);
  T *st = sm.st, *scr = sm.scr;
  const long long cc = (blockIdx.x / GB) * gridDim.y + blockIdx.y;
  const int g = blockIdx.x % GB, b0 = g * kGroup, b1 = min(NB, b0 + kGroup);
  const T* s0 = (!KAL && S0 != nullptr) ? S0 + (blockIdx.x / GB) * (long long)ST
                                        : nullptr;
  const T* gs = gstates != nullptr ? gstates + (cc * GB + g) * ST : s0;
  for (int e = threadIdx.x; e < ST; e += V::NT) st[e] = gs ? gs[e] : T(0);
  V::sync();
  T* cs = cS + (cc * NB + b0) * ST;
  ric_over_maps<T, J, KAL>(maps + (cc * NB + b0) * E, b1 - b0 - 1, sm.buf,
                           [&](int i, const T* m) {
                             V::copy(cs + (long long)i * ST, st, ST);
                             V::apply(st, m, scr);
                           });
  V::copy(cs + (long long)(b1 - b0 - 1) * ST, st, ST);
}

// ======================================================== matrix-affine
//
// x -> A_m x + b_m over the rows m of A (C, M, D, D) and b (C, M, D, K), in
// walk order (ascending rows, or descending with ``reverse``); F (C, M, D, K)
// is the value after every row, from zero.  The combine of two maps,
// (A2 A1, A2 b1 + b2), has no inverse, so the J <= 4 Riccati design carries
// over with whole maps in place of the rank-one steps.  What bounds it on
// this card: at one chain the chains of dependent row steps (a block's rows
// composed, then walked again) and the level above them; at 64 chains the
// bytes of A, which is read twice (a block's composition, then its walk).
//
// Up to D = 32 a two-level scan over blocks of L rows (the wrapper's choice,
// ops/_build.py mat_affine_block_len), in three launches (two with one
// group of blocks, one with one block).  D is padded to DP, the power of
// two at or above it; the padded rows and columns of A and b read as zero:
//   (a) ma_maps:  a thread block a group of GS blocks of one (chain, chunk
//                 of KC columns): a walk composes its block's rows into the
//                 block's map [P | q] (P the product of the rows' A, q the
//                 value after them from zero), in one pass over the rows;
//                 then a Kogge-Stone scan over the group's GS maps in
//                 shared memory gives every block's prefix within its group
//                 (``maps``) and the group's map (``totals``);
//   (b) ma_carry: a thread block a (chain, chunk) carries the value over
//                 the groups' maps, the value entering every group
//                 (``gstates``);
//   (c) ma_apply: each walk applies the prefix of the blocks before its
//                 own to the value entering its group, then walks its
//                 block's rows again and stores F.
// A walk is one lane up to DP = 4 (32 walks a warp, the map in registers,
// two warps a thread block: GS = 64 blocks in a group) and a team of DP
// lanes from DP = 8 (eight warps a thread block, GS = 32 at DP = 8, 16 at
// 16, 8 at 32).  In (a) a lane of a team holds one column of P and one of
// q, so a row step reads the row's A (a broadcast from shared memory) and
// needs no shuffle; in (c) lane i holds row i of the value, and the row
// step takes the value's other rows by shuffles within the team.  The rows
// pass through shared memory by tiles of every walk of the warp, copied with
// cp.async one tile ahead; a barrier of the warp, never of the thread block,
// lies on the row chain.
//
// Above D = 32 (phase B of the factor adjoint at J >= 8: D = J^2 and at
// most 128 maps a chain) the rows are few and a map is large, so one launch
// walks them all, a thread block a (chain, chunk of kWideCols columns): warp
// w takes the rows w, w + 32, ... of the value, its lanes split each row's
// sum, and a barrier separates the rows (ma_wide).  That is a route by
// shape: those inputs have no rows enough to cut into blocks.

template <int DP>
struct Ma {
  static constexpr int P = DP <= 4 ? 1 : DP;  // lanes a walk
  static constexpr int NW = 32 / P;           // walks a warp
  static constexpr int WARPS = DP <= 4 ? 2 : 8;
  static constexpr int NT = 32 * WARPS;  // threads a thread block
  static constexpr int GS = NW * WARPS;  // blocks of rows a group
  // columns of b a chunk: what a lane's registers hold beside P
  static constexpr int KC = DP == 1 ? 8 : DP <= 4 ? 4 : DP == 32 ? 16 : DP;
  static constexpr int TR = DP <= 2 ? 4 : DP <= 8 ? 2 : 1;  // rows a tile
  static constexpr int STAGES = 2;  // tiles in a warp's ring
  // value f of row l of walk k of a tile at (l * W + f) * PITCH + k, W the
  // values of a staged row (DP^2 of A, then DP kc of b)
  static constexpr int PITCH = NW == 1 ? 1 : NW + 1;
  static constexpr int PAIRS = TR * NW;  // (row, walk) pairs of a tile
  static constexpr int LP = PAIRS >= 32 ? 1 : 32 / PAIRS;  // lanes a pair
  static constexpr int MW = DP * DP + DP * KC;  // a map in the scratch
  static constexpr int ST = DP * KC;            // a value in the scratch
  static constexpr int CH = DP <= 8 ? 32 : DP == 16 ? 8 : 4;  // maps a chunk of (b)
};

// what a chunk of a launch needs at run time
struct MaRun {
  int D, K, k0, kc, W, step;  // W = DP^2 + DP kc; step -1 with reverse
};

template <int DP>
__device__ __forceinline__ MaRun ma_run(int D, int K, int reverse) {
  const int k0 = blockIdx.y * Ma<DP>::KC, kc = min(Ma<DP>::KC, K - k0);
  return MaRun{D, K, k0, kc, DP * DP + DP * kc, reverse ? -1 : 1};
}

// the values of a warp's ring of tiles
template <int DP>
__device__ __forceinline__ int ma_ring(const MaRun& r) {
  return Ma<DP>::STAGES * Ma<DP>::TR * r.W * Ma<DP>::PITCH;
}

// The walks of thread block (chain, group g): walk s is block g GS + s, its
// first row in walk order start[s] of the (C M)-row arrays, len[s] rows
// (0 past the chain's last block).
template <int DP>
__device__ __forceinline__ void ma_walks(int M, int L, int NB, long long chain,
                                         int g, int reverse, long long* start,
                                         int* len) {
  using G = Ma<DP>;
  for (int s = threadIdx.x; s < G::GS; s += G::NT) {
    const int b = g * G::GS + s;
    const int lo = b < NB ? b * L : 0;
    len[s] = b < NB ? min(L, M - lo) : 0;
    start[s] = chain * M + (reverse ? M - 1 - lo : lo);
  }
  __syncthreads();
}

// Zeroes a warp's ring when D < DP: the padded values are never copied,
// and read as zero.
template <typename T, int DP>
__device__ __forceinline__ void ma_zero_tiles(T* tiles, const MaRun& r) {
  if (r.D == DP) return;
  for (int e = threadIdx.x % 32; e < ma_ring<DP>(r); e += 32) tiles[e] = T(0);
  __syncwarp();
}

// Copies rows [s TR, (s + 1) TR) of the warp's walks into a tile: each
// row's A (D^2 contiguous values) and the chunk's columns of its b.  The
// lanes share out the (row, walk) pairs, LP lanes a pair.  Commits one
// group of copies, empty past the last tile.
template <typename T, int DP>
__device__ __forceinline__ void ma_stage(T* tile, const T* __restrict__ A,
                                         const T* __restrict__ b,
                                         const MaRun& r, const long long* start,
                                         const int* len, int s) {
  using G = Ma<DP>;
  constexpr int PI = G::PITCH;
  const int lane = threadIdx.x % 32, D = r.D, DD = r.D * r.D;
  for (int q = lane / G::LP; q < G::PAIRS; q += 32 / G::LP) {
    const int l = q % G::TR, k = q / G::TR, n = s * G::TR + l;
    if (n >= len[k]) continue;
    const long long row = start[k] + (long long)r.step * n;
    T* dst = tile + l * r.W * PI + k;
    const T* srcA = A + row * DD;
    for (int e = lane % G::LP; e < DD; e += G::LP)
      cp_async_elem(dst + (D == DP ? e : (e / D) * DP + e % D) * PI, srcA + e);
    const T* srcb = b + row * D * r.K + r.k0;
    for (int e = lane % G::LP; e < D * r.kc; e += G::LP) {
      const int i = r.kc == 1 ? e : e / r.kc, c = e - i * r.kc;
      cp_async_elem(dst + (DP * DP + e) * PI, srcb + (long long)i * r.K + c);
    }
  }
  cp_async_commit();
}

// one staged row as a walk reads it (x at value 0 of the row of its walk)
template <typename T, int DP>
struct MaRow {
  const T* x;
  int kc;
  __device__ T a(int i, int j) const { return x[(i * DP + j) * Ma<DP>::PITCH]; }
  __device__ T b(int i, int c) const {
    return x[(DP * DP + i * kc + c) * Ma<DP>::PITCH];
  }
};

// The row walk of (a) and (c), one warp: the rows of its walks staged by
// tiles through a ring of STAGES (cp.async, STAGES - 1 tiles ahead), then
// row(n, row) for the lane's walk's rows n in order.  A team's lanes share
// a walk, so they take the same rows.
template <typename T, int DP, class Row>
__device__ __forceinline__ void ma_over_rows(T* tiles, const T* __restrict__ A,
                                             const T* __restrict__ b,
                                             const MaRun& r,
                                             const long long* start,
                                             const int* len, Row row) {
  using G = Ma<DP>;
  constexpr int S = G::STAGES;
  const int k = (threadIdx.x % 32) / G::P, mine = len[k];
  int most = 0;
#pragma unroll
  for (int w = 0; w < G::NW; ++w) most = max(most, len[w]);
  const int ntiles = (most + G::TR - 1) / G::TR;
  const int TILE = G::TR * r.W * G::PITCH;
#pragma unroll
  for (int q = 0; q < S - 1; ++q)
    ma_stage<T, DP>(tiles + q * TILE, A, b, r, start, len, q);
  for (int s = 0; s < ntiles; ++s) {
    cp_async_wait<S - 2>();  // tile s is in
    __syncwarp();            // and every lane is done with tile s - 1
    ma_stage<T, DP>(tiles + ((s + S - 1) % S) * TILE, A, b, r, start, len,
                    s + S - 1);
    const T* tile = tiles + (s % S) * TILE + k;
    const int rows = min(G::TR, mine - s * G::TR);
#pragma unroll 1
    for (int l = 0; l < rows; ++l)
      row(s * G::TR + l, MaRow<T, DP>{tile + l * r.W * G::PITCH, r.kc});
    __syncwarp();
  }
  cp_async_wait<0>();
}

// The running map [P | q] of a walk of (a), from the identity.  One lane a
// walk (DP <= 4): the whole map, X[i][c] with columns c < DP of P and
// DP + c of q.  A team (from DP = 8): lane t column t of P (p) and of q
// (q, zero for t >= kc).
template <typename T, int DP, bool TEAM = (Ma<DP>::P > 1)>
struct MaMap;

template <typename T, int DP>
struct MaMap<T, DP, false> {
  static constexpr int KC = Ma<DP>::KC, NC = DP + KC;
  T X[DP][NC];

  __device__ void identity(int) {
#pragma unroll
    for (int i = 0; i < DP; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) X[i][c] = (c == i) ? T(1) : T(0);
  }

  __device__ void step(const MaRow<T, DP>& w, int) {
    T a[DP][DP];
#pragma unroll
    for (int i = 0; i < DP; ++i)
#pragma unroll
      for (int j = 0; j < DP; ++j) a[i][j] = w.a(i, j);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c >= DP + w.kc) break;
      T y[DP];
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        T s = c >= DP ? w.b(i, c - DP) : T(0);
#pragma unroll
        for (int j = 0; j < DP; ++j) s += a[i][j] * X[j][c];
        y[i] = s;
      }
#pragma unroll
      for (int i = 0; i < DP; ++i) X[i][c] = y[i];
    }
  }

  // into a map slot [P (DP x DP) | q (DP x kc)], row-major
  __device__ void put(T* m, int kc, int) const {
#pragma unroll
    for (int i = 0; i < DP; ++i) {
#pragma unroll
      for (int c = 0; c < DP; ++c) m[i * DP + c] = X[i][c];
#pragma unroll
      for (int c = 0; c < KC; ++c)
        if (c < kc) m[DP * DP + i * kc + c] = X[i][DP + c];
    }
  }
};

template <typename T, int DP>
struct MaMap<T, DP, true> {
  T p[DP], q[DP];

  __device__ void identity(int t) {
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      p[i] = i == t ? T(1) : T(0);
      q[i] = T(0);
    }
  }

  // p <- A p and q <- A q + b[:, t]; both columns at once up to DP = 16,
  // one after the other at 32, where two columns and their images would
  // not fit the registers
  __device__ void step(const MaRow<T, DP>& w, int t) {
    const bool own = t < w.kc;
    if constexpr (DP <= 16) {
      T yp[DP], yq[DP];
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        T sp = T(0), sq = own ? w.b(i, t) : T(0);
#pragma unroll
        for (int j = 0; j < DP; ++j) {
          const T aij = w.a(i, j);
          sp += aij * p[j];
          sq += aij * q[j];
        }
        yp[i] = sp;
        yq[i] = sq;
      }
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        p[i] = yp[i];
        q[i] = yq[i];
      }
    } else {
      T y[DP];
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        T s = T(0);
#pragma unroll
        for (int j = 0; j < DP; ++j) s += w.a(i, j) * p[j];
        y[i] = s;
      }
#pragma unroll
      for (int i = 0; i < DP; ++i) p[i] = y[i];
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        T s = own ? w.b(i, t) : T(0);
#pragma unroll
        for (int j = 0; j < DP; ++j) s += w.a(i, j) * q[j];
        y[i] = s;
      }
#pragma unroll
      for (int i = 0; i < DP; ++i) q[i] = y[i];
    }
  }

  __device__ void put(T* m, int kc, int t) const {
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      m[i * DP + t] = p[i];
      if (t < kc) m[DP * DP + i * kc + t] = q[i];
    }
  }
};

// entry e of the composition of the map m1 (earlier) with m2 (later), both
// [P | q] slots of W = DP^2 + DP kc values: (P2 P1, P2 q1 + q2)
template <typename T, int DP>
__device__ __forceinline__ T ma_compose(const T* m1, const T* m2, int e,
                                        int kc) {
  if (e < DP * DP) {
    const int i = e / DP, j = e % DP;
    T s = T(0);
#pragma unroll
    for (int l = 0; l < DP; ++l) s += m2[i * DP + l] * m1[l * DP + j];
    return s;
  }
  const int f = e - DP * DP, i = f / kc, c = f - i * kc;
  T s = m2[e];
#pragma unroll
  for (int l = 0; l < DP; ++l) s += m2[i * DP + l] * m1[DP * DP + l * kc + c];
  return s;
}

// (a): every block's map within its group, ``maps`` (C, chunks, NB, MW),
// and the group's, ``totals`` (C, chunks, GB, MW).  Grid (C GB, chunks).
template <typename T, int DP>
__global__ void __launch_bounds__(Ma<DP>::NT, 1)
    ma_maps_kernel(const T* __restrict__ A, const T* __restrict__ b,
                   T* __restrict__ maps, T* __restrict__ totals, int M, int D,
                   int K, int L, int NB, int GB, int reverse) {
  using G = Ma<DP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  __shared__ long long start[G::GS];
  __shared__ int len[G::GS];
  const long long chain = blockIdx.x / GB;
  const int g = blockIdx.x % GB;
  const long long cc = chain * gridDim.y + blockIdx.y;
  const MaRun r = ma_run<DP>(D, K, reverse);
  ma_walks<DP>(M, L, NB, chain, g, reverse, start, len);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % G::P, s = warp * G::NW + lane / G::P;
  T* tiles = sm + warp * ma_ring<DP>(r);
  ma_zero_tiles<T, DP>(tiles, r);

  MaMap<T, DP> acc;
  acc.identity(t);
  ma_over_rows<T, DP>(tiles, A, b, r, start + warp * G::NW, len + warp * G::NW,
                      [&](int, const MaRow<T, DP>& row) { acc.step(row, t); });
  __syncthreads();  // every warp is done with its tiles
  const int W = r.W;
  T* src = sm;
  T* dst = sm + G::GS * W;
  acc.put(src + s * W, r.kc, t);  // a walk past the last block: the identity
  __syncthreads();
  for (int d = 1; d < G::GS; d *= 2) {
    for (int o = threadIdx.x; o < G::GS * W; o += G::NT) {
      const int k = o / W, e = o - k * W;
      dst[o] = k < d ? src[o]
                     : ma_compose<T, DP>(src + (k - d) * W, src + k * W, e, r.kc);
    }
    __syncthreads();
    T* tmp = src;
    src = dst;
    dst = tmp;
  }
  for (int o = threadIdx.x; o < G::GS * W; o += G::NT) {
    const int k = o / W, e = o - k * W, blk = g * G::GS + k;
    if (blk < NB) maps[(cc * NB + blk) * G::MW + e] = src[o];
    if (k == G::GS - 1) totals[(cc * GB + g) * G::MW + e] = src[o];
  }
}

// (b): one thread block a (chain, chunk) carries the value over the GB
// groups' maps (``totals``), from ``x0`` (C, D, K; zero when null), and
// writes the value entering every group, ``gstates`` (C, chunks, GB, ST).  The maps come into shared memory
// by chunks of CH (cp.async, the next chunk while the steps walk this
// one).  A value of at most 32 entries (DP kc) takes one warp, lane o its
// entry o, and a step takes the entries it needs by shuffles, with no
// barrier; a wider one kMaCarryThreads threads and shared memory.
constexpr int kMaCarryThreads = 128;

template <typename T, int DP>
__global__ void __launch_bounds__(kMaCarryThreads)
    ma_carry_kernel(const T* __restrict__ totals, T* __restrict__ gstates,
                    const T* __restrict__ x0, int D, int K, int GB) {
  using G = Ma<DP>;
  constexpr int CH = G::CH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);  // two chunks of maps, two values
  T* cur = buf + 2 * CH * G::MW;
  T* nxt = cur + G::ST;
  const long long cc = (long long)blockIdx.x * gridDim.y + blockIdx.y;
  const int kc = min(G::KC, K - (int)blockIdx.y * G::KC);
  const int W = DP * DP + DP * kc, n = DP * kc, tid = threadIdx.x;
  const int nt = blockDim.x;
  const bool warp = nt == 32;
  auto sync = [&] {
    if (warp)
      __syncwarp();
    else
      __syncthreads();
  };
  const T* tm = totals + cc * GB * G::MW;
  T* gs = gstates + cc * GB * G::ST;
  // the maps applied are those of groups 0 .. GB - 2
  const int napply = GB - 1, nchunks = (napply + CH - 1) / CH;
  auto fetch = [&](int c) {
    T* dst = buf + (c & 1) * CH * G::MW;
    const int q0 = c * CH, cnt = min(CH, napply - q0);
    for (int e = tid; e < cnt * W; e += nt) {
      const int q = e / W, f = e - q * W;
      cp_async_elem(dst + q * G::MW + f, tm + (long long)(q0 + q) * G::MW + f);
    }
    cp_async_commit();
  };
  // entry (i, c) of the value entering the chain
  const T* xc = x0 != nullptr ? x0 + (long long)blockIdx.x * D * K + blockIdx.y * G::KC
                              : nullptr;
  auto start = [&](int e) {
    const int i = e / kc, c = e - i * kc;
    return xc != nullptr && i < D ? xc[(long long)i * K + c] : T(0);
  };
  // one warp: this lane's entry (i, c) of the value, x
  const int o = tid < n ? tid : 0, oi = o / kc, oc = o - oi * kc;
  T x = tid < n ? start(tid) : T(0);
  for (int e = tid; e < n; e += nt) cur[e] = start(e);
  fetch(0);
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      fetch(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    sync();
    const T* chunk = buf + (c & 1) * CH * G::MW;
    const int q0 = c * CH, cnt = min(CH, napply - q0);
    for (int q = 0; q < cnt; ++q) {
      const T* m = chunk + q * G::MW;
      T* out = gs + (long long)(q0 + q) * G::ST;
      if (warp) {
        if (tid < n) out[tid] = x;
        T v = m[DP * DP + o];
#pragma unroll
        for (int j = 0; j < DP; ++j)
          v += m[oi * DP + j] * __shfl_sync(kFull, x, j * kc + oc);
        x = tid < n ? v : T(0);
        continue;
      }
      for (int e = tid; e < n; e += nt) {
        out[e] = cur[e];
        const int i = e / kc, cl = e - i * kc;
        T v = m[DP * DP + e];
#pragma unroll
        for (int j = 0; j < DP; ++j) v += m[i * DP + j] * cur[j * kc + cl];
        nxt[e] = v;
      }
      sync();
      T* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    sync();  // every step is done with this chunk before it is refilled
  }
  T* out = gs + (long long)napply * G::ST;
  if (warp) {
    if (tid < n) out[tid] = x;
  } else {
    for (int e = tid; e < n; e += nt) out[e] = cur[e];
  }
}

// (c): the value after every row, F, from the value entering each block:
// that entering its group (``gstates``; when null, ``x0`` (C, D, K), or
// zero) carried over the prefix of the group's blocks before it (``maps``).
// Grid (C GB, chunks).
template <typename T, int DP>
__global__ void __launch_bounds__(Ma<DP>::NT, 1)
    ma_apply_kernel(const T* __restrict__ A, const T* __restrict__ b,
                    const T* __restrict__ maps, const T* __restrict__ gstates,
                    const T* __restrict__ x0, T* __restrict__ F, int M, int D,
                    int K, int L, int NB, int GB, int reverse) {
  using G = Ma<DP>;
  constexpr int P = G::P, KC = G::KC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  __shared__ long long start[G::GS];
  __shared__ int len[G::GS];
  const long long chain = blockIdx.x / GB;
  const int g = blockIdx.x % GB;
  const long long cc = chain * gridDim.y + blockIdx.y;
  const MaRun r = ma_run<DP>(D, K, reverse);
  ma_walks<DP>(M, L, NB, chain, g, reverse, start, len);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % P, s = warp * G::NW + lane / P, blk = g * G::GS + s;
  T* tiles = sm + warp * ma_ring<DP>(r);
  ma_zero_tiles<T, DP>(tiles, r);
  const int kc = r.kc;
  // the value entering the group, its entry (i, c) at gx[i * gk + c] (from
  // x0 where there are no gstates; null: zero); the prefix map of the
  // blocks before this one
  const T* gx = gstates != nullptr ? gstates + (cc * GB + g) * G::ST
                : x0 != nullptr    ? x0 + chain * D * K + r.k0
                                   : nullptr;
  const int gk = gstates != nullptr ? kc : K;
  const T* pm = s > 0 && len[s] > 0 ? maps + (cc * NB + blk - 1) * G::MW : nullptr;
  auto enter = [&](int i, int c) {
    if (i >= D) return T(0);
    if (pm == nullptr) return gx != nullptr ? gx[i * gk + c] : T(0);
    T v = pm[DP * DP + i * kc + c];
    if (gx != nullptr)
      for (int j = 0; j < D; ++j) v += pm[i * DP + j] * gx[j * gk + c];
    return v;
  };
  T* Fo = F + r.k0;
  if constexpr (P == 1) {
    T x[DP][KC];
#pragma unroll
    for (int i = 0; i < DP; ++i)
#pragma unroll
      for (int c = 0; c < KC; ++c) x[i][c] = c < kc ? enter(i, c) : T(0);
    ma_over_rows<T, DP>(
        tiles, A, b, r, start + warp * G::NW, len + warp * G::NW,
        [&](int n, const MaRow<T, DP>& w) {
          T a[DP][DP];
#pragma unroll
          for (int i = 0; i < DP; ++i)
#pragma unroll
            for (int j = 0; j < DP; ++j) a[i][j] = w.a(i, j);
          T* o = Fo + (start[s] + (long long)r.step * n) * D * K;
#pragma unroll
          for (int c = 0; c < KC; ++c) {
            if (c >= kc) break;
            T y[DP];
#pragma unroll
            for (int i = 0; i < DP; ++i) {
              T v = w.b(i, c);
#pragma unroll
              for (int j = 0; j < DP; ++j) v += a[i][j] * x[j][c];
              y[i] = v;
            }
#pragma unroll
            for (int i = 0; i < DP; ++i) {
              x[i][c] = y[i];
              if (i < D) o[(long long)i * K + c] = y[i];
            }
          }
        });
  } else {
    // lane t: row t of the value; the team's other rows by shuffles
    const unsigned team = P == 32 ? kFull : ((1u << P) - 1u) << (lane & ~(P - 1));
    T x[KC];
#pragma unroll
    for (int c = 0; c < KC; ++c) x[c] = c < kc ? enter(t, c) : T(0);
    ma_over_rows<T, DP>(
        tiles, A, b, r, start + warp * G::NW, len + warp * G::NW,
        [&](int n, const MaRow<T, DP>& w) {
          T a[DP];
#pragma unroll
          for (int j = 0; j < DP; ++j) a[j] = w.a(t, j);
          T* o = Fo + ((start[s] + (long long)r.step * n) * D + t) * K;
#pragma unroll
          for (int c = 0; c < KC; ++c) {
            if (c >= kc) break;
            T v = w.b(t, c);
#pragma unroll
            for (int j = 0; j < DP; ++j) v += a[j] * __shfl_sync(team, x[c], j, P);
            x[c] = v;
            if (t < D) o[c] = v;
          }
        });
  }
}

// Above D = 32: a thread block of kWideThreads a (chain, chunk of kWideCols
// columns) walks every row; warp w computes the rows w, w + 32, ... of the
// value, each lane a share of the row's sum, reduced by shuffles; the value
// is double-buffered in shared memory, a barrier between rows.  The value
// starts from ``x0`` (C, D, K; zero when null).  With ``Ptot`` the walk
// gives the total map instead of F: the columns are those of [P | q], D + K
// of them, column j < D of P from e_j with no constant, column D + k of q
// from zero with b's column k; ``Ptot`` (C, D, D) and ``qtot`` (C, D, K)
// get the value after the last row.
constexpr int kWideThreads = 1024;
constexpr int kWideCols = 4;

template <typename T>
__global__ void __launch_bounds__(kWideThreads, 1)
    ma_wide_kernel(const T* __restrict__ A, const T* __restrict__ b,
                   const T* __restrict__ x0, T* __restrict__ F,
                   T* __restrict__ Ptot, T* __restrict__ qtot, int M, int D,
                   int K, int reverse) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cur = reinterpret_cast<T*>(smem_raw);
  const long long chain = blockIdx.x;
  const bool total = Ptot != nullptr;
  const int cols = total ? D + K : K;
  const int k0 = blockIdx.y * kWideCols, kc = min(kWideCols, cols - k0);
  T* nxt = cur + D * kc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // column k0 + c of the value: of P (total, < D), of q (total), of F
  auto bcol = [&](int c) { return total ? k0 + c - D : k0 + c; };
  for (int o = threadIdx.x; o < D * kc; o += kWideThreads) {
    const int i = o / kc, c = o - i * kc, g = k0 + c;
    T v = T(0);
    if (total && g < D)
      v = i == g ? T(1) : T(0);
    else if (!total && x0 != nullptr)
      v = x0[(chain * D + i) * K + g];
    cur[o] = v;
  }
  __syncthreads();
  for (int n = 0; n < M; ++n) {
    const long long row = chain * M + (reverse ? M - 1 - n : n);
    const T* Ar = A + row * D * D;
    for (int i = warp; i < D; i += kWideThreads / 32) {
      T acc[kWideCols];
#pragma unroll
      for (int c = 0; c < kWideCols; ++c) acc[c] = T(0);
      for (int j = lane; j < D; j += 32) {
        const T a = Ar[(long long)i * D + j];
#pragma unroll
        for (int c = 0; c < kWideCols; ++c)
          if (c < kc) acc[c] += a * cur[j * kc + c];
      }
      T mine = T(0);
#pragma unroll
      for (int c = 0; c < kWideCols; ++c) {
        T v = acc[c];
#pragma unroll
        for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(kFull, v, off);
        if (lane == c) mine = v;
      }
      if (lane < kc) {
        const int bc = bcol(lane);
        const long long at = (row * D + i) * K + bc;
        const T v = mine + (bc >= 0 ? b[at] : T(0));
        nxt[i * kc + lane] = v;
        if (!total) F[at] = v;
      }
    }
    __syncthreads();
    T* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  if (total)
    for (int o = threadIdx.x; o < D * kc; o += kWideThreads) {
      const int i = o / kc, c = o - i * kc, bc = bcol(c);
      if (bc < 0)
        Ptot[(chain * D + i) * D + k0 + c] = cur[o];
      else
        qtot[(chain * D + i) * K + bc] = cur[o];
    }
}

// The total map of each (chain, chunk) up to D = 32 from its groups' maps
// (``totals`` (C, chunks, GB, MW), ma_maps): composed in order, the value
// double-buffered in shared memory, each thread entries of the next map.
// ``Ptot`` (C, D, D) gets P (from chunk 0), ``qtot`` (C, D, K) the chunk's
// columns of q.
constexpr int kMaTotalThreads = 256;

template <typename T, int DP>
__global__ void __launch_bounds__(kMaTotalThreads)
    ma_total_kernel(const T* __restrict__ totals, T* __restrict__ Ptot,
                    T* __restrict__ qtot, int D, int K, int GB) {
  using G = Ma<DP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cur = reinterpret_cast<T*>(smem_raw);
  T* nxt = cur + G::MW;
  const long long chain = blockIdx.x;
  const long long cc = chain * gridDim.y + blockIdx.y;
  const int k0 = blockIdx.y * G::KC, kc = min(G::KC, K - k0);
  const int W = DP * DP + DP * kc;
  const T* tm = totals + cc * GB * G::MW;
  for (int e = threadIdx.x; e < W; e += kMaTotalThreads) cur[e] = tm[e];
  __syncthreads();
  for (int q = 1; q < GB; ++q) {
    const T* m = tm + (long long)q * G::MW;
    for (int e = threadIdx.x; e < W; e += kMaTotalThreads)
      nxt[e] = ma_compose<T, DP>(cur, m, e, kc);
    __syncthreads();
    T* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  for (int e = threadIdx.x; e < W; e += kMaTotalThreads) {
    if (e < DP * DP) {
      const int i = e / DP, j = e % DP;
      if (blockIdx.y == 0 && i < D && j < D) Ptot[(chain * D + i) * D + j] = cur[e];
    } else {
      const int f = e - DP * DP, i = f / kc, c = f - i * kc;
      if (i < D) qtot[(chain * D + i) * K + k0 + c] = cur[e];
    }
  }
}

// ===================================================== diagonal-affine
//
// F_m = phi_m F_prev + G_m for every (chain, entry e = (j, k)), over the M
// rows in walk order (ascending, or descending with ``reverse``): phi
// (C, M, J), G and F (C, M, J, K).  It replaces, for the diagonal-affine
// family (planes.diag_affine_spec), the in-block prefix kernel of the TPU's
// prefix engine, celerite2_tpu/ops/planes_engine.py _block_prefix_kernel
// (pallas_call at :311), with the engine's level over the blocks.
//
// A single-pass scan with decoupled look-back (Merrill and Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA
// 2016).  The function reads its inputs once and writes F once, so the
// bytes bound it at 64 chains; at one chain the chain of dependent tiles.
// A thread block takes a tile of 32 runs of ``run`` rows (the wrapper's
// choice, ops/_build.py affine_run_len) of up to kDiagWarps entries
// of one chain, tiles in the order of an atomic ticket, so that every
// tile's predecessors are already running and none waits on a later one.
// The tile is copied into shared memory (cp.async, coalesced over the
// entries of a row), transposed so that warp w holds entry w and lane s
// walks the rows [s run, (s + 1) run) of the tile.  Each lane
// composes its run's (alpha, beta), a warp scan (Kogge-Stone) composes the
// runs, and lane 31 publishes the tile's aggregate (status 1), looks back
// over its predecessors (32 at a time, a lane each: their aggregates
// composed up to the nearest inclusive value) for the value entering the
// tile, and publishes the tile's inclusive value (status 2).  Each lane then
// walks its run again from the value entering it, F goes back into the
// shared tile and out with coalesced stores.  The wrapper gives the status
// words and the ticket zeroed.
constexpr int kDiagWarps = 8;
constexpr int kDiagMaxRun = 32;  // rows a lane walks, at most

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// the slot of row r of a tile in an entry's rows in shared memory: lane s's
// run of 2^lg rows at s (2^lg + 1), an odd stride for lg > 0
__device__ __forceinline__ int diag_slot(int r, int lg) {
  return (r >> lg) * ((1 << lg) + 1) + (r & ((1 << lg) - 1));
}

// The value entering tile ``tile`` of a sequence whose status words, tile
// aggregates and inclusive values start at ``at``: the predecessors'
// aggregates composed, nearest last, down to the nearest inclusive value
// (or the start, zero).  Every lane of the warp calls it and gets the value.
template <typename T>
__device__ T diag_lookback(const int* status, const T* agg_a, const T* agg_f,
                           const T* incl, long long at, int tile) {
  const int lane = threadIdx.x % 32;
  T ra = T(1), rf = T(0);  // the map of the tiles looked at so far
  for (int j = tile - 1;; j -= 32) {
    const int q = j - lane;
    int f = 2;
    T a = T(0), v = T(0);  // before the first tile: the constant zero
    if (q >= 0) {
      do {
        f = ld_acquire(status + at + q);
      } while (f == 0);
      if (f == 2) {
        v = __ldcg(incl + at + q);
      } else {
        a = __ldcg(agg_a + at + q);
        v = __ldcg(agg_f + at + q);
      }
    }
    const unsigned stop = __ballot_sync(kFull, f == 2);
    const int last = stop ? __ffs(stop) - 1 : 31;
    if (lane > last) {
      a = T(1);
      v = T(0);
    }
    // lanes 0..last in order, lane 0 the nearest (applied last)
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const T oa = __shfl_down_sync(kFull, a, off);
      const T ov = __shfl_down_sync(kFull, v, off);
      if (lane + off < 32) {
        v = a * ov + v;
        a = a * oa;
      }
    }
    a = __shfl_sync(kFull, a, 0);
    v = __shfl_sync(kFull, v, 0);
    rf = ra * v + rf;
    ra = ra * a;
    if (stop) return rf;
  }
}

// grid: C EC ntiles tiles of 32 runs of 2^lg rows, ntiles of each sequence
// of (chain, chunk of up to kDiagWarps entries); the ticket orders them tile
// by tile, the sequences within a tile, so that the tiles in flight spread
// over the sequences
template <typename T>
__global__ void __launch_bounds__(kDiagWarps * 32)
    affine_prefix_kernel(const T* __restrict__ phi, const T* __restrict__ G,
                         T* __restrict__ F, int* status, T* agg_a, T* agg_f,
                         T* incl, int* ticket, int M, int J, int K, int lg,
                         int EC, int ntiles, int reverse) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int run = 1 << lg;
  // an entry's rows in shared memory: an odd pitch, so that the threads
  // copying one row's entries write to different banks
  const int pitch = 32 * (run + 1) + 1;
  T* sg = reinterpret_cast<T*>(smem_raw);  // kDiagWarps entries of ``pitch``
  T* sp = sg + kDiagWarps * pitch;
  __shared__ int s_ticket;
  constexpr int NT = kDiagWarps * 32;
  const int tid = threadIdx.x;
  if (tid == 0) s_ticket = atomicAdd(ticket, 1);
  __syncthreads();
  const long long nseq = (long long)gridDim.x / ntiles, seq = s_ticket % nseq;
  const int tile = (int)(s_ticket / nseq), chunk = (int)(seq % EC);
  const long long chain = seq / EC;
  const int E = J * K, e0 = chunk * kDiagWarps, ew = min(kDiagWarps, E - e0);
  const int pos0 = tile * 32 * run, rows = min(32 * run, M - pos0);
  auto row_of = [&](int r) {
    const int pos = pos0 + r;
    return chain * M + (reverse ? M - 1 - pos : pos);
  };
  // thread tid copies entry tid % kDiagWarps of the rows tid / kDiagWarps,
  // + NT / kDiagWarps, ...: consecutive threads on consecutive entries
  const int we = tid % kDiagWarps, e = e0 + we;
  if (we < ew) {
    const int j = e / K;
    for (int r = tid / kDiagWarps; r < rows; r += NT / kDiagWarps) {
      const long long row = row_of(r);
      const int slot = we * pitch + diag_slot(r, lg);
      cp_async_elem(sg + slot, G + row * E + e);
      cp_async_elem(sp + slot, phi + row * J + j);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int w = tid / 32, lane = tid % 32;
  if (w < ew) {
    T* eg = sg + w * pitch;
    const T* ep = sp + w * pitch;
    const int base = lane * (run + 1), mine = max(0, min(run, rows - lane * run));
    T a = T(1), f = T(0);
    for (int r = 0; r < mine; ++r) {
      const T ph = ep[base + r];
      f = ph * f + eg[base + r];
      a *= ph;
    }
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {  // inclusive over the lanes' runs
      const T oa = __shfl_up_sync(kFull, a, d), of = __shfl_up_sync(kFull, f, d);
      if (lane >= d) {
        f = a * of + f;
        a = a * oa;
      }
    }
    const long long at = (chain * E + e0 + w) * ntiles;
    const long long me = at + tile;
    T x_in = T(0);
    if (tile == 0) {
      if (lane == 31) {
        incl[me] = f;
        st_release(status + me, 2);
      }
    } else {
      if (lane == 31) {
        agg_a[me] = a;
        agg_f[me] = f;
        st_release(status + me, 1);
      }
      x_in = diag_lookback(status, agg_a, agg_f, incl, at, tile);
      if (lane == 31) {
        incl[me] = a * x_in + f;
        st_release(status + me, 2);
      }
    }
    // the value entering this lane's run
    T ea = __shfl_up_sync(kFull, a, 1), ef = __shfl_up_sync(kFull, f, 1);
    if (lane == 0) {
      ea = T(1);
      ef = T(0);
    }
    T v = ea * x_in + ef;
    for (int r = 0; r < mine; ++r) {
      v = ep[base + r] * v + eg[base + r];
      eg[base + r] = v;
    }
  }
  __syncthreads();
  if (we < ew)
    for (int r = tid / kDiagWarps; r < rows; r += NT / kDiagWarps)
      F[row_of(r) * E + e] = sg[we * pitch + diag_slot(r, lg)];
}

// ------------------------------------------------------------ launchers

// the blocks, groups and chunks of a Riccati or Kalman call, and its scratch
template <int J, bool KAL>
struct RicPlan {
  long long C;
  int NB, GB, chunks;
  RicPlan(int C_, int N, int K, int L)
      : C(C_),
        NB((N + L - 1) / L),
        GB((NB + kGroup - 1) / kGroup),
        chunks(KAL ? (K + Ric<J, KAL>::KC - 1) / Ric<J, KAL>::KC : 1) {}
  // scratch values: the maps and states of the blocks and of the groups
  long long work() const {
    using G = Ric<J, KAL>;
    return NB > 1 ? C * chunks * (long long)(NB + GB) * (G::E + G::ST) : 0;
  }
};

// The phases of a Riccati or Kalman call at width J, in order; *launched
// counts the kernels launched.  ``Pv`` and ``S0`` (the Riccati family only):
// the row before each chain's row 0 and the state entering the chain.
template <typename T, int J, bool KAL>
int launch_riccati_j(const void* p, const void* a, const void* U,
                     const void* V, const void* Y, RicPrev<T> Pv,
                     const void* S0, void* S, void* F, void* work, int C,
                     int N, int K, int L, int* launched, cudaStream_t s) {
  using G = Ric<J, KAL>;
  using Lv = RicLevel<T, J, KAL>;
  static_assert(G::P > 1 || G::NW == kGroup, "a warp's lanes walk a group");
  const RicPlan<J, KAL> plan(C, N, K, L);
  const int NB = plan.NB, GB = plan.GB;
  const unsigned chunks = (unsigned)plan.chunks;
  const long long cc = plan.C * plan.chunks;
  T* maps = (T*)work;
  T* totals = maps + cc * NB * G::E;
  T* gstates = totals + cc * GB * G::E;
  T* cS = gstates + cc * GB * G::ST;
  const T *pp = (const T*)p, *ap = (const T*)a, *Up = (const T*)U,
          *Vp = (const T*)V, *Yp = (const T*)Y;
  const dim3 walks((unsigned)(plan.C * ((NB + G::NW - 1) / G::NW)), chunks);
  const dim3 groups((unsigned)(plan.C * GB), chunks);
  const dim3 per_chain((unsigned)plan.C, chunks);
  int err;
  if (NB > 1) {
    // (a); at J <= 4 its scan over the lanes reuses the tiles
    size_t smem = 2 * G::TILE * sizeof(T);
    if (G::P == 1 && smem < 2 * kGroup * G::SLOT * sizeof(T))
      smem = 2 * kGroup * G::SLOT * sizeof(T);
    static size_t maps_allowed = 0;
    if ((err = allow_smem(ric_maps_kernel<T, J, KAL>, smem + G::WALK_STATIC,
                          &maps_allowed)))
      return err;
    ric_maps_kernel<T, J, KAL><<<walks, 32, smem, s>>>(
        pp, ap, Up, Vp, Yp, Pv, maps, totals, N, K, L, NB, GB);
    if ((err = (int)cudaGetLastError())) return err;
    ++*launched;
  }
  const T* s0 = (const T*)S0;
  if constexpr (G::P == 1) {
    if (GB > 1) {  // (b) at J <= 4
      const size_t smem = 2 * (size_t)kScanThreads * G::SLOT * sizeof(T);
      static size_t scan_allowed = 0;
      if ((err = allow_smem(ric_carry_kernel<T, J, KAL>, smem,
                            &scan_allowed)))
        return err;
      ric_carry_kernel<T, J, KAL><<<per_chain, kScanThreads, smem, s>>>(
          totals, gstates, s0, nullptr, GB);
      if ((err = (int)cudaGetLastError())) return err;
      ++*launched;
    }
  } else if (NB > 1) {
    // (b)-(d) from J = 8 (gauss_jordan's pivot index is static shared memory)
    static size_t level_allowed[3] = {0, 0, 0};
    const size_t level = Lv::SMEM + sizeof(int);
    if ((err = allow_smem(ric_groups_kernel<T, J, KAL>, level,
                          &level_allowed[0])) ||
        (err = allow_smem(ric_scan_kernel<T, J, KAL>, level,
                          &level_allowed[1])) ||
        (err = allow_smem(ric_enter_kernel<T, J, KAL>, level,
                          &level_allowed[2])))
      return err;
    if (GB > 1) {
      ric_groups_kernel<T, J, KAL><<<groups, Lv::NT, Lv::SMEM, s>>>(
          maps, totals, NB, GB);
      if ((err = (int)cudaGetLastError())) return err;
      ++*launched;
      ric_scan_kernel<T, J, KAL><<<per_chain, Lv::NT, Lv::SMEM, s>>>(
          totals, gstates, s0, GB);
      if ((err = (int)cudaGetLastError())) return err;
      ++*launched;
    }
    ric_enter_kernel<T, J, KAL><<<groups, Lv::NT, Lv::SMEM, s>>>(
        maps, GB > 1 ? gstates : nullptr, s0, cS, NB, GB);
    if ((err = (int)cudaGetLastError())) return err;
    ++*launched;
  }
  // (e): the states entering the groups (J <= 4) or the blocks (from J = 8)
  const T* states = G::P == 1 ? (GB > 1 ? gstates : nullptr)
                              : (NB > 1 ? cS : nullptr);
  const size_t smem = (2 * G::TILE + G::OUT) * sizeof(T);
  static size_t apply_allowed = 0;
  if ((err = allow_smem(ric_apply_kernel<T, J, KAL>, smem + G::WALK_STATIC,
                        &apply_allowed)))
    return err;
  ric_apply_kernel<T, J, KAL><<<walks, 32, smem, s>>>(
      pp, ap, Up, Vp, Yp, Pv, s0, NB > 1 ? maps : nullptr, states, (T*)S,
      (T*)F, N, K, L, NB, GB);
  if ((err = (int)cudaGetLastError())) return err;
  ++*launched;
  return 0;
}

// The total map of every chain's rows, ``total`` (C, 3, J, J): [A | Q | R]
// of the composition of the chain's elements (row 0's from ``Pv`` when
// given, else the identity), without the rows' states.  (a), then the level
// over the blocks' maps: at J <= 4 (a) gives every group's map and (b)
// composes the groups' maps (none with one group); from J = 8 ric_groups
// composes the blocks' maps a group at a time, then the groups' maps, and
// so on until one map is left.  ``work`` holds riccati_total_work values.
template <typename T, int J>
int launch_riccati_total_j(const void* p, const void* a, const void* U,
                           const void* V, RicPrev<T> Pv, void* total,
                           void* work, int C, int N, int L, int* launched,
                           cudaStream_t s) {
  using G = Ric<J, false>;
  using Lv = RicLevel<T, J, false>;
  const RicPlan<J, false> plan(C, N, 0, L);
  const int NB = plan.NB, GB = plan.GB;
  T* out = (T*)total;
  T* maps = (T*)work;
  T* level = maps + plan.C * NB * G::E;  // two buffers of C GB maps
  const dim3 walks((unsigned)(plan.C * ((NB + G::NW - 1) / G::NW)), 1);
  size_t smem = 2 * G::TILE * sizeof(T);
  if (G::P == 1 && smem < 2 * kGroup * G::SLOT * sizeof(T))
    smem = 2 * kGroup * G::SLOT * sizeof(T);
  static size_t maps_allowed = 0;
  int err;
  if ((err = allow_smem(ric_maps_kernel<T, J, false>, smem + G::WALK_STATIC,
                        &maps_allowed)))
    return err;
  const T *pp = (const T*)p, *ap = (const T*)a, *Up = (const T*)U,
          *Vp = (const T*)V;
  if constexpr (G::P == 1) {
    ric_maps_kernel<T, J, false><<<walks, 32, smem, s>>>(
        pp, ap, Up, Vp, nullptr, Pv, maps, GB > 1 ? level : out, N, 0, L, NB,
        GB);
    if ((err = (int)cudaGetLastError())) return err;
    ++*launched;
    if (GB > 1) {
      const size_t csmem = 2 * (size_t)kScanThreads * G::SLOT * sizeof(T);
      static size_t scan_allowed = 0;
      if ((err = allow_smem(ric_carry_kernel<T, J, false>, csmem,
                            &scan_allowed)))
        return err;
      ric_carry_kernel<T, J, false>
          <<<dim3((unsigned)plan.C, 1), kScanThreads, csmem, s>>>(
              level, nullptr, nullptr, out, GB);
      if ((err = (int)cudaGetLastError())) return err;
      ++*launched;
    }
  } else {
    ric_maps_kernel<T, J, false><<<walks, 32, smem, s>>>(
        pp, ap, Up, Vp, nullptr, Pv, NB > 1 ? maps : out, nullptr, N, 0, L,
        NB, GB);
    if ((err = (int)cudaGetLastError())) return err;
    ++*launched;
    static size_t level_allowed = 0;
    if ((err = allow_smem(ric_groups_kernel<T, J, false>, Lv::SMEM + sizeof(int),
                          &level_allowed)))
      return err;
    const T* src = maps;
    for (int count = NB, lvl = 0; count > 1; ++lvl) {
      const int g = (count + kGroup - 1) / kGroup;
      T* dst = g == 1 ? out : level + (lvl & 1) * plan.C * GB * G::E;
      ric_groups_kernel<T, J, false>
          <<<dim3((unsigned)(plan.C * g), 1), Lv::NT, Lv::SMEM, s>>>(
              src, dst, count, g);
      if ((err = (int)cudaGetLastError())) return err;
      ++*launched;
      src = dst;
      count = g;
    }
  }
  return 0;
}

// the widths the Riccati and Kalman kernels are built for
#define C2T_WIDTHS(X) X(1) X(2) X(4) X(8) X(16) X(32)

template <typename T, bool KAL>
int launch_riccati(int J, const void* p, const void* a, const void* U,
                   const void* V, const void* Y, RicPrev<T> Pv, const void* S0,
                   void* S, void* F, void* work, int C, int N, int K, int L,
                   int* launched, cudaStream_t s) {
  switch (J) {
#define C2T_CASE(JJ)                                                       \
  case JJ:                                                                 \
    return launch_riccati_j<T, JJ, KAL>(p, a, U, V, Y, Pv, S0, S, F, work, \
                                        C, N, K, L, launched, s);
    C2T_WIDTHS(C2T_CASE)
#undef C2T_CASE
    default:
      return -1;
  }
}

template <typename T>
int launch_riccati_total(int J, const void* p, const void* a, const void* U,
                         const void* V, RicPrev<T> Pv, void* total, void* work,
                         int C, int N, int L, int* launched, cudaStream_t s) {
  switch (J) {
#define C2T_CASE(JJ)                                                         \
  case JJ:                                                                   \
    return launch_riccati_total_j<T, JJ>(p, a, U, V, Pv, total, work, C, N, \
                                         L, launched, s);
    C2T_WIDTHS(C2T_CASE)
#undef C2T_CASE
    default:
      return -1;
  }
}

long long riccati_total_work(int J, int C, int N, int L) {
  switch (J) {
#define C2T_CASE(JJ)                                           \
  case JJ: {                                                   \
    const RicPlan<JJ, false> plan(C, N, 0, L);                 \
    return plan.C * (plan.NB + 2LL * plan.GB) * Ric<JJ, false>::E; \
  }
    C2T_WIDTHS(C2T_CASE)
#undef C2T_CASE
    default:
      return -1;
  }
}

template <bool KAL>
long long riccati_work(int J, int C, int N, int K, int L) {
  switch (J) {
#define C2T_CASE(JJ) \
  case JJ:           \
    return RicPlan<JJ, KAL>(C, N, K, L).work();
    C2T_WIDTHS(C2T_CASE)
#undef C2T_CASE
    default:
      return -1;
  }
}

// the blocks, groups and chunks of a matrix-affine call up to D = 32, and
// its scratch: the maps of the blocks and of the groups, the values
// entering the groups
template <int DP>
struct MaPlan {
  long long C;
  int NB, GB, chunks;
  MaPlan(int C_, int M, int K, int L)
      : C(C_),
        NB((M + L - 1) / L),
        GB((NB + Ma<DP>::GS - 1) / Ma<DP>::GS),
        chunks((K + Ma<DP>::KC - 1) / Ma<DP>::KC) {}
  long long work(bool total = false) const {
    return NB > 1 || total ? C * chunks *
                                 ((long long)(NB + GB) * Ma<DP>::MW +
                                  (long long)GB * Ma<DP>::ST)
                           : 0;
  }
};

// A call up to D = 32: F from ``x0`` (null: zero) or, with ``Ptot``, the
// total map (P, q) into ``Ptot``, ``qtot``: (a) (also with one block), then
// ma_total over the groups' maps instead of (b) and (c).
template <typename T, int DP>
int launch_mat_affine_dp(const void* A, const void* b, const void* x0, void* F,
                         void* Ptot, void* qtot, void* work, int C, int M,
                         int D, int K, int L, int reverse, int* launched,
                         cudaStream_t s) {
  using G = Ma<DP>;
  const MaPlan<DP> plan(C, M, K, L);
  const int NB = plan.NB, GB = plan.GB;
  const long long cc = plan.C * plan.chunks;
  T* maps = (T*)work;
  T* totals = maps + cc * NB * G::MW;
  T* gstates = totals + cc * GB * G::MW;
  const T *Ap = (const T*)A, *bp = (const T*)b;
  const dim3 groups((unsigned)(plan.C * GB), (unsigned)plan.chunks);
  // the widest chunk's staged row, and the tiles of every warp
  const int W = DP * DP + DP * (K < G::KC ? K : G::KC);
  const size_t tiles =
      (size_t)G::WARPS * G::STAGES * G::TR * W * G::PITCH * sizeof(T);
  constexpr size_t walk_static = G::GS * (sizeof(long long) + sizeof(int));
  int err;
  const bool total = Ptot != nullptr;
  if (NB > 1 || total) {  // (a); its scan over the group reuses the tiles
    size_t smem = 2 * (size_t)G::GS * W * sizeof(T);
    if (smem < tiles) smem = tiles;
    static size_t maps_allowed = 0;
    if ((err = allow_smem(ma_maps_kernel<T, DP>, smem + walk_static,
                          &maps_allowed)))
      return err;
    ma_maps_kernel<T, DP><<<groups, G::NT, smem, s>>>(
        Ap, bp, maps, totals, M, D, K, L, NB, GB, reverse);
    if ((err = (int)cudaGetLastError())) return err;
    ++*launched;
  }
  if (total) {
    const size_t smem = 2 * (size_t)G::MW * sizeof(T);
    static size_t total_allowed = 0;
    if ((err = allow_smem(ma_total_kernel<T, DP>, smem, &total_allowed)))
      return err;
    ma_total_kernel<T, DP>
        <<<dim3((unsigned)plan.C, (unsigned)plan.chunks), kMaTotalThreads, smem,
           s>>>(totals, (T*)Ptot, (T*)qtot, D, K, GB);
    if ((err = (int)cudaGetLastError())) return err;
    ++*launched;
    return 0;
  }
  const T* x0p = (const T*)x0;
  if (GB > 1) {  // (b)
    const size_t smem = (2 * G::CH * G::MW + 2 * G::ST) * sizeof(T);
    static size_t carry_allowed = 0;
    if ((err = allow_smem(ma_carry_kernel<T, DP>, smem, &carry_allowed)))
      return err;
    const int threads = DP * (K < G::KC ? K : G::KC) <= 32 ? 32 : kMaCarryThreads;
    ma_carry_kernel<T, DP>
        <<<dim3((unsigned)plan.C, (unsigned)plan.chunks), threads, smem, s>>>(
            totals, gstates, x0p, D, K, GB);
    if ((err = (int)cudaGetLastError())) return err;
    ++*launched;
  }
  static size_t apply_allowed = 0;  // (c)
  if ((err = allow_smem(ma_apply_kernel<T, DP>, tiles + walk_static,
                        &apply_allowed)))
    return err;
  ma_apply_kernel<T, DP><<<groups, G::NT, tiles, s>>>(
      Ap, bp, NB > 1 ? maps : nullptr, GB > 1 ? gstates : nullptr, x0p, (T*)F,
      M, D, K, L, NB, GB, reverse);
  if ((err = (int)cudaGetLastError())) return err;
  ++*launched;
  return 0;
}

// the padded width of a matrix-affine call up to D = 32 (0 above)
inline int ma_width(int D) {
  int DP = 1;
  while (DP < D) DP *= 2;
  return DP <= 32 ? DP : 0;
}

template <typename T>
int launch_mat_affine(const void* A, const void* b, const void* x0, void* F,
                      void* Ptot, void* qtot, void* work, int C, int M, int D,
                      int K, int L, int reverse, int* launched,
                      cudaStream_t s) {
  switch (ma_width(D)) {
#define C2T_CASE(DP)                                                        \
  case DP:                                                                  \
    return launch_mat_affine_dp<T, DP>(A, b, x0, F, Ptot, qtot, work, C, M, \
                                       D, K, L, reverse, launched, s);
    C2T_WIDTHS(C2T_CASE)
#undef C2T_CASE
    default: {  // above D = 32: one walk a (chain, chunk)
      const int cols = Ptot != nullptr ? D + K : K;
      const int kc = cols < kWideCols ? cols : kWideCols;
      const size_t smem = 2 * (size_t)D * kc * sizeof(T);
      static size_t wide_allowed = 0;
      int err;
      if ((err = allow_smem(ma_wide_kernel<T>, smem, &wide_allowed)))
        return err;
      ma_wide_kernel<T><<<dim3((unsigned)C, (unsigned)((cols + kWideCols - 1) /
                                                       kWideCols)),
                          kWideThreads, smem, s>>>(
          (const T*)A, (const T*)b, (const T*)x0, (T*)F, (T*)Ptot, (T*)qtot, M,
          D, K, reverse);
      if ((err = (int)cudaGetLastError())) return err;
      ++*launched;
      return 0;
    }
  }
}

long long mat_affine_work(int D, int C, int M, int K, int L, bool total) {
  switch (ma_width(D)) {
#define C2T_CASE(DP) \
  case DP:           \
    return MaPlan<DP>(C, M, K, L).work(total);
    C2T_WIDTHS(C2T_CASE)
#undef C2T_CASE
    default:
      return 0;
  }
}

// the tiles, entries a thread block and chunks of entries of a
// diagonal-affine call
struct DiagPlan {
  int EC, ntiles;
  DiagPlan(int M, int E, int run)
      : EC((E + kDiagWarps - 1) / kDiagWarps),
        ntiles((M + 32 * run - 1) / (32 * run)) {}
};

template <typename T>
int launch_affine_prefix(const void* phi, const void* G, void* F, void* status,
                         void* values, int C, int M, int J, int K, int run,
                         int reverse, cudaStream_t s) {
  int lg = 0;
  while ((1 << lg) < run) ++lg;
  if ((1 << lg) != run || run > kDiagMaxRun) return -1;
  const DiagPlan plan(M, J * K, run);
  const long long n = (long long)C * J * K * plan.ntiles;
  int* st = (int*)status;
  T* v = (T*)values;
  const size_t smem = 2 * (size_t)kDiagWarps * (32 * (run + 1) + 1) * sizeof(T);
  static size_t allowed = 0;
  int err;
  if ((err = allow_smem(affine_prefix_kernel<T>, smem + sizeof(int), &allowed)))
    return err;
  affine_prefix_kernel<T>
      <<<(unsigned)((long long)C * plan.EC * plan.ntiles), kDiagWarps * 32,
         smem, s>>>((const T*)phi, (const T*)G, (T*)F, st, v, v + n, v + 2 * n,
                    st + n, M, J, K, lg, plan.EC, plan.ntiles, reverse);
  return (int)cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------ C interface
//
// Each function returns cudaGetLastError() after its launches (0 on
// success), or -1 for a width that is not one of 1, 2, 4, 8, 16, 32.
// Pointers are to contiguous device arrays of the scalar type given by
// ``is_double``.
//
// c2t_riccati_prefix: K = 0 is the Riccati family (Y, F unused), K >= 1 the
// Kalman family with K right-hand sides.  Launches the phases its blocks of
// L rows need (the header comment: at J <= 4 (e) alone for one block, (a)
// and (e) for one group, (a), (b), (e) above; from J = 8 (e), then (a), (d),
// (e), then all five) and adds their number to *launched; ``work`` holds
// c2t_riccati_work(J, C, N, K, L) values of scratch (null for none).  The
// Riccati family may start from an incoming state: ``a_prev`` (C),
// ``U_prev``, ``V_prev`` (C, J), the row before each chain's row 0, whose
// element row 0 then is (null: the identity), and ``S0`` (C, J, J), the
// state entering the chain (null: zero); with K >= 1 both must be null
// (-2 otherwise).
// c2t_riccati_total: the total map [A | Q | R] (C, 3, J, J) of each chain's
// elements (row 0's from the previous row when given), by (a) and the level
// over the maps alone, no rows' states: at J <= 4 one launch, two with more
// than one group; from J = 8 one launch, plus one a level of groups of
// kGroup maps until one is left.  ``work`` holds c2t_riccati_total_work(J,
// C, N, L) values.
// c2t_riccati_group: the blocks of a group, kGroup.
//
// c2t_mat_affine_prefix: F, the value after every row from ``x0`` (C, D, K;
// null: zero), of A (C, M, D, D) and b (C, M, D, K), any D >= 1 and K >= 1,
// in blocks of L rows up to D = 32 (the header comment: (c) alone for one
// block, (a) and (c) for one group, all three above), in one walk above;
// adds the kernels launched to *launched.  ``work`` holds
// c2t_mat_affine_work(D, C, M, K, L, 0) values of scratch (null for none).
// c2t_mat_affine_total: the total map of each chain's rows, P (C, D, D) and
// q (C, D, K) (x -> P x + q), no F: up to D = 32 (a) and ma_total, two
// launches; above, one walk of the D + K columns of [P | q].  ``work``
// holds c2t_mat_affine_work(D, C, M, K, L, 1) values.
// c2t_mat_affine_group: the blocks of a group at width D (0 above D = 32,
// which has no groups).
//
// c2t_affine_prefix: F (C, M, J, K) of the diagonal-affine recurrence, one
// launch, in tiles of 32 runs of ``run`` rows (a power of two up to
// kDiagMaxRun; -1 otherwise).  ``status`` holds c2t_affine_status(C, M, J, K, run) ints,
// zeroed (the tiles' status words, then the ticket), ``values`` three times
// as many values as there are status words before the ticket (the tiles'
// aggregates and inclusive values).

extern "C" {

int c2t_riccati_group() { return kGroup; }

long long c2t_riccati_work(int J, int C, int N, int K, int L) {
  return K == 0 ? riccati_work<false>(J, C, N, K, L)
                : riccati_work<true>(J, C, N, K, L);
}

int c2t_riccati_prefix(int is_double, int J, const void* p, const void* a,
                       const void* U, const void* V, const void* Y,
                       const void* a_prev, const void* U_prev,
                       const void* V_prev, const void* S0, void* S, void* F,
                       void* work, int C, int N, int K, int L, int* launched,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K > 0 && (a_prev != nullptr || S0 != nullptr)) return -2;
  const RicPrev<double> pd{(const double*)a_prev, (const double*)U_prev,
                           (const double*)V_prev};
  const RicPrev<float> pf{(const float*)a_prev, (const float*)U_prev,
                          (const float*)V_prev};
  if (K == 0)
    return is_double
               ? launch_riccati<double, false>(J, p, a, U, V, Y, pd, S0, S, F,
                                               work, C, N, K, L, launched, s)
               : launch_riccati<float, false>(J, p, a, U, V, Y, pf, S0, S, F,
                                              work, C, N, K, L, launched, s);
  return is_double
             ? launch_riccati<double, true>(J, p, a, U, V, Y, pd, nullptr, S, F,
                                            work, C, N, K, L, launched, s)
             : launch_riccati<float, true>(J, p, a, U, V, Y, pf, nullptr, S, F,
                                           work, C, N, K, L, launched, s);
}

long long c2t_riccati_total_work(int J, int C, int N, int L) {
  return riccati_total_work(J, C, N, L);
}

int c2t_riccati_total(int is_double, int J, const void* p, const void* a,
                      const void* U, const void* V, const void* a_prev,
                      const void* U_prev, const void* V_prev, void* total,
                      void* work, int C, int N, int L, int* launched,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double)
    return launch_riccati_total<double>(
        J, p, a, U, V,
        RicPrev<double>{(const double*)a_prev, (const double*)U_prev,
                        (const double*)V_prev},
        total, work, C, N, L, launched, s);
  return launch_riccati_total<float>(
      J, p, a, U, V,
      RicPrev<float>{(const float*)a_prev, (const float*)U_prev,
                     (const float*)V_prev},
      total, work, C, N, L, launched, s);
}

int c2t_mat_affine_group(int D) {
  switch (ma_width(D)) {
#define C2T_CASE(DP) \
  case DP:           \
    return Ma<DP>::GS;
    C2T_WIDTHS(C2T_CASE)
#undef C2T_CASE
    default:
      return 0;
  }
}

long long c2t_mat_affine_work(int D, int C, int M, int K, int L, int total) {
  return mat_affine_work(D, C, M, K, L, total != 0);
}

int c2t_mat_affine_prefix(int is_double, const void* A, const void* b,
                          const void* x0, void* F, void* work, int C, int M,
                          int D, int K, int L, int reverse, int* launched,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_double ? launch_mat_affine<double>(A, b, x0, F, nullptr, nullptr,
                                               work, C, M, D, K, L, reverse,
                                               launched, s)
                   : launch_mat_affine<float>(A, b, x0, F, nullptr, nullptr,
                                              work, C, M, D, K, L, reverse,
                                              launched, s);
}

int c2t_mat_affine_total(int is_double, const void* A, const void* b,
                         void* Ptot, void* qtot, void* work, int C, int M,
                         int D, int K, int L, int reverse, int* launched,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_double ? launch_mat_affine<double>(A, b, nullptr, nullptr, Ptot,
                                               qtot, work, C, M, D, K, L,
                                               reverse, launched, s)
                   : launch_mat_affine<float>(A, b, nullptr, nullptr, Ptot,
                                              qtot, work, C, M, D, K, L,
                                              reverse, launched, s);
}

long long c2t_affine_status(int C, int M, int J, int K, int run) {
  return (long long)C * J * K * DiagPlan(M, J * K, run).ntiles + 1;
}

int c2t_affine_prefix(int is_double, const void* phi, const void* G, void* F,
                      void* status, void* values, int C, int M, int J, int K,
                      int run, int reverse, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_double ? launch_affine_prefix<double>(phi, G, F, status, values, C,
                                                  M, J, K, run, reverse, s)
                   : launch_affine_prefix<float>(phi, G, F, status, values, C,
                                                 M, J, K, run, reverse, s);
}

}  // extern "C"
