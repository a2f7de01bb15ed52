// The blocked prefix kernels of the assoc tier (ops/assoc.py), written for
// Hopper (sm_90a): the inclusive prefix over the rows of a long sequence of
// three element families, split into blocks of L rows that run side by side.
// Built with nvcc into the shared library of celerite2_torch/ops/_build.py
// and bound with ctypes.
//
// They replace, each for its element family, the in-block prefix kernel of
// the TPU's prefix engine,
//   celerite2_tpu/ops/planes_engine.py  _block_prefix_kernel
//   (pallas_call at :311, body _kernel at :117),
// with the block maps it emits and the distribute that the engine runs after
// it:
//   * riccati_*   the Riccati family (planes.riccati_spec, assoc.py
//                 _riccati_combine): (A, Q, R) acting on the factor's carry
//                 S -> Q + A S (I + R S)^{-1} A^T; assoc.factor_assoc;
//   * the same kernels with K right-hand sides, the Kalman family
//                 (planes.kalman_spec, assoc._kalman_combine): (A, Q, R, b,
//                 eta) acting on (S, F); assoc.factor_solve_assoc;
//   * mat_affine_* the matrix-affine family (planes.mat_affine_spec,
//                 assoc._mat_affine_combine): x -> A x + b with A (D, D) and
//                 b (D, K); the solves, the solve adjoint and phase B of the
//                 factor adjoint (D = J^2, K = 1).
// The diagonal-affine family is affine_prefix_kernel in general_ops.cu.
//
// Shape of every family, three launches (one when the rows fit one block):
//   1. maps:  each (chain, block of L rows) composes its elements into the
//             block's map;
//   2. carry: the same prefix over the block maps (one sequential walk per
//             chain over ceil(N / L) maps) gives the state entering every
//             block;
//   3. apply: each block walks its rows again from the state entering it
//             and writes the state after every row.
// The TPU kernel walks a sequential grid over an (8, 128) tile of blocks
// and carries in VMEM; here blocks are independent thread blocks, so they
// run in parallel and in no order, and only step 2 is sequential over
// blocks.
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
// factor's and the lower solve's own row recursion.  That is what step 3
// runs.  Step 2 composes whole maps and needs the general inverse: a
// Gauss-Jordan solve of (I + S R) X = [S | F + S eta] with partial
// pivoting.  A non-positive pivot delta divides by 1, as the row kernels
// do, so a system that is not positive definite gives finite values and
// the caller's check d > 0 decides (the quiet -inf).
//
// What bounds these kernels on this card: each block's walk is a chain of
// dependent row steps of a few shared-memory sums and three block-wide
// barriers, and the carry walk a chain of ceil(N / L) Gauss-Jordan solves;
// the bytes moved (the rows read twice, the states written once) take a
// small fraction of that time.  The design therefore spreads the rows over
// ceil(N / L) blocks times the chains, so that neither chain is long (L
// about 4 sqrt(N) for the Riccati and Kalman families, whose carry steps
// cost more and lose more digits than their row steps; about sqrt(N) for
// the matrix-affine one), and keeps the J x J matrices of a block in shared
// memory, one entry per thread and step.

#include <cuda_runtime.h>

#include <cfloat>

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

// right-hand sides of the Kalman family per thread block (more are split
// over blockIdx.y, each chunk redoing the Riccati part)
constexpr int kCols = 16;

__host__ __device__ constexpr int ric_threads(int J) {
  return J <= 4 ? 32 : (J <= 8 ? 64 : 256);
}

// ===================================================== Riccati / Kalman
//
// Layouts: p, U, V (C, N, J); a (C, N); Y (C, N, K); the outputs S (C, N, J,
// J) and F (C, N, J, K); the block maps tA, tQ, tR (C, NB, J, J) and tb,
// teta (C, NB, J, K); the states entering each block cS (C, NB, J, J) and
// cF (C, NB, J, K).  KAL = false is the Riccati family (no Y, F, b, eta).

// Loads the row that element n is built from (row n - 1) and p_n.
template <typename T, int J, bool KAL>
__device__ __forceinline__ void load_row(const T* p, const T* a, const T* U,
                                         const T* V, const T* Y, size_t r,
                                         int K, int k0, int KC, T* su, T* sv,
                                         T* sp, T* sy, T* sa) {
  const int tid = threadIdx.x;
  if (tid < J) {
    su[tid] = U[r * J + tid];
    sv[tid] = V[r * J + tid];
    sp[tid] = p[(r + 1) * J + tid];
  } else if (KAL && tid < J + KC) {
    sy[tid - J] = Y[r * K + k0 + tid - J];
  }
  if (tid == 0) *sa = safe_pos(a[r]);
}

// u^T x for every thread (J multiply-adds from shared memory, no barrier)
template <typename T, int J>
__device__ __forceinline__ T dot_shared(const T* x, const T* y) {
  T s = T(0);
#pragma unroll
  for (int i = 0; i < J; ++i) s += x[i] * y[i];
  return s;
}

template <typename T, int J, bool KAL>
__global__ void __launch_bounds__(ric_threads(J))
    riccati_maps_kernel(const T* __restrict__ p, const T* __restrict__ a,
                        const T* __restrict__ U, const T* __restrict__ V,
                        const T* __restrict__ Y, T* __restrict__ tA,
                        T* __restrict__ tQ, T* __restrict__ tR,
                        T* __restrict__ tb, T* __restrict__ teta, int N, int K,
                        int L, int NB) {
  constexpr int NT = ric_threads(J);
  constexpr int KM = KAL ? kCols : 1;
  __shared__ T sA[J * J], sQ[J * J], sR[J * J], sb[J * KM], se[J * KM];
  __shared__ T su[J], sv[J], sp[J], sy[KM], sx[J], sg[J], sz[KM], sa;
  const int tid = threadIdx.x;
  const int blk = blockIdx.x % NB;
  const long long chain = blockIdx.x / NB;
  const int k0 = blockIdx.y * kCols;
  const int KC = KAL ? min(kCols, K - k0) : 0;
  const int lo = blk * L, hi = min(N, lo + L);
  for (int e = tid; e < J * J; e += NT) {
    sA[e] = (e / J == e % J) ? T(1) : T(0);
    sQ[e] = T(0);
    sR[e] = T(0);
  }
  for (int e = tid; e < J * KM; e += NT) sb[e] = se[e] = T(0);
  __syncthreads();
  for (int n = max(lo, 1); n < hi; ++n) {
    const size_t r = (size_t)chain * N + n - 1;
    load_row<T, J, KAL>(p, a, U, V, Y, r, K, k0, KC, su, sv, sp, sy, &sa);
    __syncthreads();
    if (tid < J) {
      T x = T(0);
      for (int k = 0; k < J; ++k) x += sQ[tid * J + k] * su[k];
      sx[tid] = x;
    } else if (tid < 2 * J) {
      const int j = tid - J;
      T g = T(0);
      for (int i = 0; i < J; ++i) g += sA[i * J + j] * su[i];
      sg[j] = g;
    } else if (KAL && tid < 2 * J + KC) {
      const int k = tid - 2 * J;
      T z = sy[k];
      for (int i = 0; i < J; ++i) z -= sb[i * KM + k] * su[i];
      sz[k] = z;
    }
    __syncthreads();
    const T delta = sa - dot_shared<T, J>(su, sx);
    const T inv = T(1) / safe_pos(delta);
    for (int e = tid; e < J * J; e += NT) {
      const int i = e / J, j = e % J;
      const T wi = (sv[i] - sx[i]) * inv, wj = (sv[j] - sx[j]) * inv;
      sA[e] = sp[i] * (sA[e] - wi * sg[j]);
      sQ[e] = (sp[i] * sp[j]) * (sQ[e] + delta * (wi * wj));
      sR[e] = sR[e] - (sg[i] * sg[j]) * inv;
    }
    if (KAL) {
      for (int e = tid; e < J * KC; e += NT) {
        const int i = e / KC, k = e % KC, s = i * KM + k;
        const T wi = (sv[i] - sx[i]) * inv;
        sb[s] = sp[i] * (sb[s] + wi * sz[k]);
        se[s] = se[s] - sg[i] * sz[k] * inv;
      }
    }
    __syncthreads();
  }
  const size_t m = (size_t)chain * NB + blk;
  if (blockIdx.y == 0) {
    for (int e = tid; e < J * J; e += NT) {
      tA[m * J * J + e] = sA[e];
      tQ[m * J * J + e] = sQ[e];
      tR[m * J * J + e] = sR[e];
    }
  }
  if (KAL) {
    for (int e = tid; e < J * KC; e += NT) {
      const int i = e / KC, k = e % KC;
      tb[(m * J + i) * K + k0 + k] = sb[i * KM + k];
      teta[(m * J + i) * K + k0 + k] = se[i * KM + k];
    }
  }
}

// One walk per (chain, chunk of columns) over the NB block maps: writes the
// state entering every block, then applies the block's map,
//   X = (I + S R)^{-1} [S | F + S eta],  S <- sym(Q + A X_S A^T),
//   F <- b + A X_F,
// with the inverse by Gauss-Jordan elimination with partial pivoting on the
// augmented J x (2 J + KC) matrix in shared memory.
template <typename T, int J, bool KAL>
__global__ void __launch_bounds__(ric_threads(J))
    riccati_carry_kernel(const T* __restrict__ tA, const T* __restrict__ tQ,
                         const T* __restrict__ tR, const T* __restrict__ tb,
                         const T* __restrict__ teta, T* __restrict__ cS,
                         T* __restrict__ cF, int K, int NB) {
  constexpr int NT = ric_threads(J);
  constexpr int KM = KAL ? kCols : 1;
  constexpr int W = 2 * J + KM;  // [I + S R | S | F + S eta]
  __shared__ T sS[J * J], sF[J * KM], sT[J * J], aug[J * W], sf[J];
  __shared__ T spinv;
  const int tid = threadIdx.x;
  const long long chain = blockIdx.x;
  const int k0 = blockIdx.y * kCols;
  const int KC = KAL ? min(kCols, K - k0) : 0;
  for (int e = tid; e < J * J; e += NT) sS[e] = T(0);
  for (int e = tid; e < J * KM; e += NT) sF[e] = T(0);
  __syncthreads();
  for (int b = 0; b < NB; ++b) {
    const size_t m = (size_t)chain * NB + b;
    if (blockIdx.y == 0)
      for (int e = tid; e < J * J; e += NT) cS[m * J * J + e] = sS[e];
    if (KAL)
      for (int e = tid; e < J * KC; e += NT)
        cF[(m * J + e / KC) * K + k0 + e % KC] = sF[(e / KC) * KM + e % KC];
    if (b == NB - 1) break;
    const T* A = tA + m * J * J;
    const T* Q = tQ + m * J * J;
    const T* R = tR + m * J * J;
    for (int e = tid; e < J * J; e += NT) {
      const int i = e / J, j = e % J;
      T s = (i == j) ? T(1) : T(0);
      for (int k = 0; k < J; ++k) s += sS[i * J + k] * R[k * J + j];
      aug[i * W + j] = s;
      aug[i * W + J + j] = sS[e];
    }
    if (KAL) {
      for (int e = tid; e < J * KC; e += NT) {
        const int i = e / KC, k = e % KC;
        T s = sF[i * KM + k];
        for (int l = 0; l < J; ++l)
          s += sS[i * J + l] * teta[(m * J + l) * K + k0 + k];
        aug[i * W + 2 * J + k] = s;
      }
    }
    __syncthreads();
    for (int c = 0; c < J; ++c) {
      if (tid == 0) {
        int piv = c;
        T best = fabs(aug[c * W + c]);
        for (int r = c + 1; r < J; ++r) {
          const T v = fabs(aug[r * W + c]);
          if (v > best) {
            best = v;
            piv = r;
          }
        }
        if (piv != c)
          for (int q = 0; q < 2 * J + KC; ++q) {
            const T tmp = aug[c * W + q];
            aug[c * W + q] = aug[piv * W + q];
            aug[piv * W + q] = tmp;
          }
        T pv = aug[c * W + c];
        if (fabs(pv) < Tiny<T>::value()) pv = Tiny<T>::value();
        spinv = T(1) / pv;
      }
      __syncthreads();
      for (int q = tid; q < 2 * J + KC; q += NT) aug[c * W + q] *= spinv;
      for (int r = tid; r < J; r += NT) sf[r] = (r == c) ? T(0) : aug[r * W + c];
      __syncthreads();
      for (int e = tid; e < J * (2 * J + KC); e += NT) {
        const int r = e / (2 * J + KC), q = e % (2 * J + KC);
        if (r != c) aug[r * W + q] -= sf[r] * aug[c * W + q];
      }
      __syncthreads();
    }
    // T = A X_S;  F <- b + A X_F
    for (int e = tid; e < J * J; e += NT) {
      const int i = e / J, j = e % J;
      T s = T(0);
      for (int k = 0; k < J; ++k) s += A[i * J + k] * aug[k * W + J + j];
      sT[e] = s;
    }
    if (KAL) {
      for (int e = tid; e < J * KC; e += NT) {
        const int i = e / KC, k = e % KC;
        T s = tb[(m * J + i) * K + k0 + k];
        for (int l = 0; l < J; ++l) s += A[i * J + l] * aug[l * W + 2 * J + k];
        sF[i * KM + k] = s;
      }
    }
    __syncthreads();
    // Q + T A^T into the (now free) first block of aug, then symmetrise
    for (int e = tid; e < J * J; e += NT) {
      const int i = e / J, j = e % J;
      T s = Q[e];
      for (int k = 0; k < J; ++k) s += sT[i * J + k] * A[j * J + k];
      aug[i * W + j] = s;
    }
    __syncthreads();
    for (int e = tid; e < J * J; e += NT) {
      const int i = e / J, j = e % J;
      sS[e] = T(0.5) * (aug[i * W + j] + aug[j * W + i]);
    }
    __syncthreads();
  }
}

// Each (chain, block, chunk of columns) walks its rows from the state
// entering it (cS, cF; zero for the first block or when cS is null) with
// the factor's and the lower solve's row recursion and writes the state
// after every row: S (C, N, J, J) and F (C, N, J, K).
template <typename T, int J, bool KAL>
__global__ void __launch_bounds__(ric_threads(J))
    riccati_apply_kernel(const T* __restrict__ p, const T* __restrict__ a,
                         const T* __restrict__ U, const T* __restrict__ V,
                         const T* __restrict__ Y, const T* __restrict__ cS,
                         const T* __restrict__ cF, T* __restrict__ S,
                         T* __restrict__ F, int N, int K, int L, int NB) {
  constexpr int NT = ric_threads(J);
  constexpr int KM = KAL ? kCols : 1;
  __shared__ T sS[J * J], sF[J * KM];
  __shared__ T su[J], sv[J], sp[J], sy[KM], sx[J], sz[KM], sa;
  const int tid = threadIdx.x;
  const int blk = blockIdx.x % NB;
  const long long chain = blockIdx.x / NB;
  const int k0 = blockIdx.y * kCols;
  const int KC = KAL ? min(kCols, K - k0) : 0;
  const int lo = blk * L, hi = min(N, lo + L);
  const size_t m = (size_t)chain * NB + blk;
  for (int e = tid; e < J * J; e += NT)
    sS[e] = cS != nullptr ? cS[m * J * J + e] : T(0);
  if (KAL)
    for (int e = tid; e < J * KC; e += NT)
      sF[(e / KC) * KM + e % KC] =
          cF != nullptr ? cF[(m * J + e / KC) * K + k0 + e % KC] : T(0);
  __syncthreads();
  for (int n = lo; n < hi; ++n) {
    const size_t row = (size_t)chain * N + n;
    if (n >= 1) {
      load_row<T, J, KAL>(p, a, U, V, Y, row - 1, K, k0, KC, su, sv, sp, sy,
                          &sa);
      __syncthreads();
      if (tid < J) {
        T x = T(0);
        for (int k = 0; k < J; ++k) x += sS[tid * J + k] * su[k];
        sx[tid] = x;
      } else if (KAL && tid < J + KC) {
        const int k = tid - J;
        T z = sy[k];
        for (int i = 0; i < J; ++i) z -= sF[i * KM + k] * su[i];
        sz[k] = z;
      }
      __syncthreads();
      const T delta = sa - dot_shared<T, J>(su, sx);
      const T inv = T(1) / safe_pos(delta);
      for (int e = tid; e < J * J; e += NT) {
        const int i = e / J, j = e % J;
        const T wi = (sv[i] - sx[i]) * inv, wj = (sv[j] - sx[j]) * inv;
        sS[e] = (sp[i] * sp[j]) * (sS[e] + delta * (wi * wj));
      }
      if (KAL) {
        for (int e = tid; e < J * KC; e += NT) {
          const int i = e / KC, k = e % KC, s = i * KM + k;
          sF[s] = sp[i] * (sF[s] + (sv[i] - sx[i]) * inv * sz[k]);
        }
      }
      __syncthreads();
    }
    if (blockIdx.y == 0)
      for (int e = tid; e < J * J; e += NT) S[row * J * J + e] = sS[e];
    if (KAL)
      for (int e = tid; e < J * KC; e += NT)
        F[(row * J + e / KC) * K + k0 + e % KC] = sF[(e / KC) * KM + e % KC];
  }
}

// ======================================================== matrix-affine
//
// x -> A_m x + b_m over the rows m of A (C, M, D, D), b (C, M, D, K), rows
// descending with ``reverse``.  Two kernels:
//   * walk: each (chain, block, chunk of KC columns) walks its rows from the
//     value leaving the block walked before it (``carry`` (C, NB, D, K),
//     zero when null or for the first block) and writes the value after
//     every row into F (if set) and the last one into ``last`` (if set);
//   * product: each (chain, block) composes the linear parts of its rows,
//     A_last ... A_first, into P (C, NB, D, D), ping-ponging with Pw.
// The wrapper runs the walk from zero for the block totals, the same
// prefix on those NB maps for the carries, and the walk from the carries
// for F.  A thread keeps (D / blockDim) entries of the state; the state is
// double-buffered in shared memory, one barrier per row.
constexpr int kAffineThreads = 256;
constexpr int kAffineEntries = 2048;  // D * KC per thread block

template <typename T>
__global__ void __launch_bounds__(kAffineThreads)
    mat_affine_walk_kernel(const T* __restrict__ A, const T* __restrict__ b,
                           const T* __restrict__ carry, T* __restrict__ F,
                           T* __restrict__ last, int M, int D, int K, int KC,
                           int L, int NB, int reverse) {
  extern __shared__ unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const int blk = blockIdx.x % NB;
  const long long chain = blockIdx.x / NB;
  const int k0 = blockIdx.y * KC;
  const int kc = min(KC, K - k0);
  const int lo = blk * L, len = min(L, M - lo);
  const int step = reverse ? -1 : 1;
  const int first = reverse ? lo + len - 1 : lo;
  const int before = blk - step;
  T* cur = buf;
  T* nxt = buf + D * KC;
  for (int e = tid; e < D * kc; e += kAffineThreads) {
    const int i = e / kc, k = e % kc;
    cur[e] = (carry != nullptr && before >= 0 && before < NB)
                 ? carry[(((size_t)chain * NB + before) * D + i) * K + k0 + k]
                 : T(0);
  }
  __syncthreads();
  for (int r = 0; r < len; ++r) {
    const size_t row = (size_t)chain * M + first + step * r;
    const T* Ar = A + row * D * D;
    for (int e = tid; e < D * kc; e += kAffineThreads) {
      const int i = e / kc, k = e % kc;
      T s = b[(row * D + i) * K + k0 + k];
      for (int j = 0; j < D; ++j) s += Ar[(size_t)i * D + j] * cur[j * kc + k];
      nxt[e] = s;
      if (F != nullptr) F[(row * D + i) * K + k0 + k] = s;
    }
    __syncthreads();
    T* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  if (last != nullptr)
    for (int e = tid; e < D * kc; e += kAffineThreads) {
      const int i = e / kc, k = e % kc;
      last[(((size_t)chain * NB + blk) * D + i) * K + k0 + k] = cur[e];
    }
}

template <typename T>
__global__ void __launch_bounds__(kAffineThreads)
    mat_affine_product_kernel(const T* __restrict__ A, T* P, T* Pw, int M,
                              int D, int L, int NB, int reverse) {
  const int tid = threadIdx.x;
  const int blk = blockIdx.x % NB;
  const long long chain = blockIdx.x / NB;
  const int lo = blk * L, len = min(L, M - lo);
  const int step = reverse ? -1 : 1;
  const int first = reverse ? lo + len - 1 : lo;
  const size_t m = ((size_t)chain * NB + blk) * D * D;
  const size_t DD = (size_t)D * D;
  // after len rows the product lies in P: start in P for an even len
  T* cur = (len % 2 == 0) ? P + m : Pw + m;
  T* nxt = (len % 2 == 0) ? Pw + m : P + m;
  for (size_t e = tid; e < DD; e += kAffineThreads)
    cur[e] = (e / D == e % D) ? T(1) : T(0);
  __syncthreads();
  for (int r = 0; r < len; ++r) {
    const T* Ar = A + ((size_t)chain * M + first + step * r) * DD;
    for (size_t e = tid; e < DD; e += kAffineThreads) {
      const size_t i = e / D, j = e % D;
      T s = T(0);
      for (int k = 0; k < D; ++k) s += Ar[i * D + k] * cur[(size_t)k * D + j];
      nxt[e] = s;
    }
    __syncthreads();
    T* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

// ------------------------------------------------------------ launchers

template <typename T, int J, bool KAL>
int launch_riccati_j(int phase, const void* p, const void* a, const void* U,
                     const void* V, const void* Y, void* S, void* F, void* tA,
                     void* tQ, void* tR, void* tb, void* teta, void* cS,
                     void* cF, int C, int N, int K, int L, cudaStream_t s) {
  const int NB = (N + L - 1) / L;
  const unsigned chunks = KAL ? (unsigned)((K + kCols - 1) / kCols) : 1u;
  constexpr int NT = ric_threads(J);
  if (phase == 0) {
    riccati_maps_kernel<T, J, KAL><<<dim3((unsigned)(C * NB), chunks), NT, 0,
                                     s>>>(
        (const T*)p, (const T*)a, (const T*)U, (const T*)V, (const T*)Y,
        (T*)tA, (T*)tQ, (T*)tR, (T*)tb, (T*)teta, N, K, L, NB);
  } else if (phase == 1) {
    riccati_carry_kernel<T, J, KAL><<<dim3((unsigned)C, chunks), NT, 0, s>>>(
        (const T*)tA, (const T*)tQ, (const T*)tR, (const T*)tb,
        (const T*)teta, (T*)cS, (T*)cF, K, NB);
  } else {
    riccati_apply_kernel<T, J, KAL><<<dim3((unsigned)(C * NB), chunks), NT, 0,
                                      s>>>(
        (const T*)p, (const T*)a, (const T*)U, (const T*)V, (const T*)Y,
        (const T*)cS, (const T*)cF, (T*)S, (T*)F, N, K, L, NB);
  }
  return (int)cudaGetLastError();
}

template <typename T, bool KAL>
int launch_riccati(int J, int phase, const void* p, const void* a,
                   const void* U, const void* V, const void* Y, void* S,
                   void* F, void* tA, void* tQ, void* tR, void* tb, void* teta,
                   void* cS, void* cF, int C, int N, int K, int L,
                   cudaStream_t s) {
#define C2T_RICCATI(JJ)                                                        \
  case JJ:                                                                     \
    return launch_riccati_j<T, JJ, KAL>(phase, p, a, U, V, Y, S, F, tA, tQ,    \
                                        tR, tb, teta, cS, cF, C, N, K, L, s)
  switch (J) {
    C2T_RICCATI(1);
    C2T_RICCATI(2);
    C2T_RICCATI(4);
    C2T_RICCATI(8);
    C2T_RICCATI(16);
    C2T_RICCATI(32);
    default:
      return -1;
  }
#undef C2T_RICCATI
}

template <typename T>
int launch_mat_affine(int phase, const void* A, const void* b,
                      const void* carry, void* F, void* last, void* P,
                      void* Pw, int C, int M, int D, int K, int L, int reverse,
                      cudaStream_t s) {
  const int NB = (M + L - 1) / L;
  if (phase == 0) {
    mat_affine_product_kernel<T><<<(unsigned)(C * NB), kAffineThreads, 0, s>>>(
        (const T*)A, (T*)P, (T*)Pw, M, D, L, NB, reverse);
  } else {
    int KC = kAffineEntries / D;
    if (KC < 1) KC = 1;
    if (KC > K) KC = K;
    const size_t smem = 2 * (size_t)D * KC * sizeof(T);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          mat_affine_walk_kernel<T>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    const unsigned chunks = (unsigned)((K + KC - 1) / KC);
    mat_affine_walk_kernel<T><<<dim3((unsigned)(C * NB), chunks),
                                kAffineThreads, smem, s>>>(
        (const T*)A, (const T*)b, (const T*)carry, (T*)F, (T*)last, M, D, K,
        KC, L, NB, reverse);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------ C interface
//
// Each function launches one kernel on ``stream`` and returns
// cudaGetLastError() after the launch (0 on success), or -1 for a width
// that is not one of 1, 2, 4, 8, 16, 32.  Pointers are to contiguous device
// arrays of the scalar type given by ``is_double``.
//
// c2t_riccati_prefix: K = 0 is the Riccati family (Y, F, tb, teta, cF
// unused), K >= 1 the Kalman family with K right-hand sides.  phase 0 maps
// (writes tA, tQ, tR, tb, teta), 1 carry (reads them, writes cS, cF), 2
// apply (reads cS, cF, null for one block, writes S, F).
//
// c2t_mat_affine_prefix: phase 0 product (writes P from A, using Pw), 1
// walk (reads A, b and ``carry``, null for zero; writes F and/or ``last``,
// either may be null).  Any D >= 1 and K >= 1.

extern "C" {

int c2t_riccati_prefix(int is_double, int J, const void* p, const void* a,
                       const void* U, const void* V, const void* Y, void* S,
                       void* F, void* tA, void* tQ, void* tR, void* tb,
                       void* teta, void* cS, void* cF, int C, int N, int K,
                       int L, int phase, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K == 0)
    return is_double
               ? launch_riccati<double, false>(J, phase, p, a, U, V, Y, S, F,
                                               tA, tQ, tR, tb, teta, cS, cF, C,
                                               N, K, L, s)
               : launch_riccati<float, false>(J, phase, p, a, U, V, Y, S, F,
                                              tA, tQ, tR, tb, teta, cS, cF, C,
                                              N, K, L, s);
  return is_double ? launch_riccati<double, true>(J, phase, p, a, U, V, Y, S,
                                                  F, tA, tQ, tR, tb, teta, cS,
                                                  cF, C, N, K, L, s)
                   : launch_riccati<float, true>(J, phase, p, a, U, V, Y, S, F,
                                                 tA, tQ, tR, tb, teta, cS, cF,
                                                 C, N, K, L, s);
}

int c2t_mat_affine_prefix(int is_double, const void* A, const void* b,
                          const void* carry, void* F, void* last, void* P,
                          void* Pw, int C, int M, int D, int K, int L,
                          int reverse, int phase, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_double ? launch_mat_affine<double>(phase, A, b, carry, F, last, P,
                                               Pw, C, M, D, K, L, reverse, s)
                   : launch_mat_affine<float>(phase, A, b, carry, F, last, P,
                                              Pw, C, M, D, K, L, reverse, s);
}

}  // extern "C"
