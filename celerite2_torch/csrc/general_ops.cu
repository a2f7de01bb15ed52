// The general semiseparable recursions at any celerite width J <= 32,
// written for Hopper (sm_90a): the LDL^T factor, the four sweeps (lower and
// upper solve, lower and upper matmul) and the blocked prefix of the
// diagonal-affine recurrence.  Built with nvcc into the shared library of
// celerite2_torch/ops/_build.py and bound with ctypes.
//
// factor_fwd_kernel replaces the TPU kernels
//   celerite2_tpu/ops/pallas_kernels.py  _factor_kernel  (factor_pallas)
//   celerite2_tpu/ops/pallas_packed.py   _factor_kernel  (factor_packed)
// and sweep_fwd_kernel replaces
//   celerite2_tpu/ops/pallas_kernels.py  _sweep_kernel   (_sweep_lower and
//                                        its time-flipped upper versions)
//   celerite2_tpu/ops/pallas_packed.py   _sweep_kernel   (_sweep_lower).
// The tiled and the lane-packed TPU kernels differ in their TPU layout only,
// so one kernel here is the counterpart of both.  affine_prefix_kernel
// replaces, for the diagonal-affine element family (alpha, b), the in-block
// prefix kernel of the TPU's prefix engine,
//   celerite2_tpu/ops/planes_engine.py  _block_prefix_kernel,
// which is what the rectangular products of a prediction at new points run
// through (ops/api.py, _transported_cumulative); see that kernel below.
//
// Both recursions are sequential in the rows n and independent across the C
// chains (and, for the sweeps, across the K right-hand sides).  What bounds
// them on this card is the latency of the dependent chain of one row step
// (a few dependent multiply-adds, a division or a shuffle reduction), N times
// over: at one chain the card moves a small fraction of what its memory
// could.  The design keeps everything that does not depend on the carry off
// that chain: a row's inputs are fetched before the row is reached (one row
// ahead in registers in the factor, a tile of rows ahead in shared memory in
// the sweep), the carry stays in registers for all N rows, and chains and
// right-hand sides spread over threads.  Nothing is padded to a block of
// rows and nothing is pre-shifted: the previous row's d, w (factor) or b, r
// (sweep) are carried in registers and shared memory.
//
// Layouts are natural row-major with a leading chain axis: p, U, V, W, A, B
// (C, N, J); a, d (C, N); Y, Z (C, N, K); the caches S_half (C, N, J, J)
// and F (C, N, J, K).  p is the transport exp(-c dt) of each row (0 at the
// row where nothing enters: row 0, or row N-1 for an upper sweep).

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kFactorThreads = 32;  // one warp: 32 / J chains
constexpr int kSweepThreads = 128;  // right-hand sides per block
constexpr int kTileElems = 1024;    // per staged array: 1024 / J rows

// ============================================================= factor
//
// S <- p (S + d w w^T) p,  d_n = a_n - u^T S u,  w_n = (v - S u) / d_n.
//
// J consecutive lanes serve one chain (J divides 32, so a warp serves 32 / J
// chains and a group never straddles a warp).  Lane j keeps column j of the
// symmetric carry S in J registers, computes (S u)_j from its own column,
// and the group reduces u^T (S u) by xor shuffles of width J.  The row
// vectors every lane needs in full (p, u and the previous w) go through
// shared memory, written by their owning lanes and read as broadcasts.  The
// next row's p, u, v, a are loaded before the current row's arithmetic
// (staging 16 rows at a time in shared memory instead was measured and is no
// faster: the row step itself, not the fetch, sets the time).
template <typename T, int J>
__global__ void factor_fwd_kernel(const T* __restrict__ p,
                                  const T* __restrict__ a,
                                  const T* __restrict__ U,
                                  const T* __restrict__ V, T* __restrict__ d,
                                  T* __restrict__ W, T* __restrict__ Sh, int C,
                                  int N) {
  __shared__ T sp[kFactorThreads], su[kFactorThreads], sw[kFactorThreads];
  const int tid = threadIdx.x;
  const long long gid = (long long)blockIdx.x * kFactorThreads + tid;
  const long long chain_of = gid / J;
  const bool live = chain_of < C;
  // lanes past the last chain repeat it (they must take part in the
  // shuffles) and store nothing
  const size_t row0 = (size_t)(live ? chain_of : C - 1) * N;
  const int j = tid % J;
  const int base = tid - j;

  T s[J];
#pragma unroll
  for (int i = 0; i < J; ++i) s[i] = T(0);
  T d_prev = T(0), w_prev = T(0);
  sw[tid] = T(0);

  T p_n = p[row0 * J + j], u_n = U[row0 * J + j], v_n = V[row0 * J + j];
  T a_n = a[row0];
  for (int n = 0; n < N; ++n) {
    const size_t row = row0 + n;
    const T pj = p_n, uj = u_n, vj = v_n, an = a_n;
    if (n + 1 < N) {
      p_n = p[(row + 1) * J + j];
      u_n = U[(row + 1) * J + j];
      v_n = V[(row + 1) * J + j];
      a_n = a[row + 1];
    }
    sp[tid] = pj;
    su[tid] = uj;
    __syncwarp();
    const T dwj = d_prev * w_prev;
    T tmp = T(0);
#pragma unroll
    for (int i = 0; i < J; ++i) {
      // S_half[i][j] = p_i (S[i][j] + d w_i w_j)
      const T half = sp[base + i] * (s[i] + dwj * sw[base + i]);
      if (Sh != nullptr && live) Sh[(row * J + i) * J + j] = half;
      s[i] = half * pj;
      tmp += s[i] * su[base + i];
    }
    T dot = uj * tmp;
#pragma unroll
    for (int off = J / 2; off > 0; off /= 2)
      dot += __shfl_xor_sync(kFullMask, dot, off, J);
    const T dn = an - dot;
    const T wn = (vj - tmp) / (dn > T(0) ? dn : T(1));
    if (live) {
      W[row * J + j] = wn;
      if (j == 0) d[row] = dn;
    }
    __syncwarp();  // every lane has read this row's sp, su, sw
    sw[tid] = wn;
    w_prev = wn;
    d_prev = dn;
  }
}

// ============================================================== sweeps
//
// Per row, in the order the rows are walked (ascending for a lower sweep,
// descending for an upper one):
//   F_cache[n] = F;  F <- p_n F;  proj = a_n^T F;
//   z_n = y_n - proj (solve) or proj (matmul);  r = z_n (solve) or y_n;
//   F <- F + b_n r^T,
// which is F_n = p_n (F_prev + b_prev r_prev^T) with the feed of row n added
// as soon as r is known.
//
// One thread owns one right-hand side k of one chain and keeps column k of F
// (J values) in registers; a block serves up to kSweepThreads right-hand
// sides of one chain.  The block stages p, A, B for a tile of 1024 / J rows
// in shared memory (coalesced loads, read back as broadcasts), so the global
// latency is paid once per tile, and each thread loads its next y one row
// ahead.  Loads and stores of Y, Z and F are coalesced across k.
template <typename T, int J>
__global__ void sweep_fwd_kernel(const T* __restrict__ p,
                                 const T* __restrict__ A,
                                 const T* __restrict__ B,
                                 const T* __restrict__ Y, T* __restrict__ Z,
                                 T* __restrict__ Fc, int N, int K, int KB,
                                 int is_solve, int upper) {
  constexpr int kTileRows = kTileElems / J;
  __shared__ T sp[kTileElems], sa[kTileElems], sb[kTileElems];
  const int chain = blockIdx.x / KB;
  const int k = (blockIdx.x % KB) * kSweepThreads + threadIdx.x;
  const bool live = k < K;
  const size_t row0 = (size_t)chain * N;

  T F[J];
#pragma unroll
  for (int j = 0; j < J; ++j) F[j] = T(0);
  const int step = upper ? -1 : 1;
  int n = upper ? N - 1 : 0;
  T y_next = live ? Y[(row0 + n) * K + k] : T(0);

  for (int q0 = 0; q0 < N; q0 += kTileRows) {
    const int rows = min(kTileRows, N - q0);
    const int lo = upper ? N - q0 - rows : q0;  // first row of the tile
    __syncthreads();  // the previous tile has been consumed
    const size_t tile0 = (row0 + lo) * J;
    for (int e = threadIdx.x; e < rows * J; e += kSweepThreads) {
      sp[e] = p[tile0 + e];
      sa[e] = A[tile0 + e];
      sb[e] = B[tile0 + e];
    }
    __syncthreads();
    if (!live) continue;
    for (int q = 0; q < rows; ++q, n += step) {
      const int at = (n - lo) * J;
      const size_t row = row0 + n;
      const T y = y_next;
      const int nn = n + step;
      if (nn >= 0 && nn < N) y_next = Y[(row0 + nn) * K + k];
      T proj = T(0);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (Fc != nullptr) Fc[(row * J + j) * K + k] = F[j];
        F[j] *= sp[at + j];
        proj += sa[at + j] * F[j];
      }
      const T z = is_solve ? y - proj : proj;
      Z[row * K + k] = z;
      const T r = is_solve ? z : y;
#pragma unroll
      for (int j = 0; j < J; ++j) F[j] += sb[at + j] * r;
    }
  }
}

// ======================================================= affine prefix
//
// F_m = phi_m F_prev + G_m for every (chain, j, k), over the M rows in
// ascending order (F_prev = F_{m-1}) or, with ``reverse``, in descending
// order (F_prev = F_{m+1}); nothing enters the first row walked.  phi is
// (C, M, J), G and F are (C, M, J, K).
//
// The recurrence composes the affine maps f -> alpha f + b, and composing is
// associative, so the M rows are cut into NB blocks of L rows that run side
// by side: one thread owns one entry (j, k) of one block of one chain and
// walks the block's rows with its running value in a register.  A launch
// does one of two things, by which pointers it is given:
//   * totals (tot_a, tot_b set, F null): every block starts from zero and
//     writes its composed map, the product of its phi (C, NB, J) and its
//     last value (C, NB, J, K).  Those two arrays are themselves the (phi, G)
//     of the same recurrence over the NB blocks, so the wrapper runs this
//     kernel on them again to get the value leaving every block;
//   * apply (F set): every block starts from the value leaving the block
//     walked before it (``carry`` (C, NB, J, K), null when there is one
//     block) and writes F for its rows.
// The inputs are read twice and F is written once.  Rows are fetched eight at
// a time before the eight dependent multiply-adds, so the memory latency is
// paid once per eight rows; threads of one row's (j, k) entries are adjacent,
// so loads of G and stores of F coalesce over min(J K, 32) values.
constexpr int kPrefixThreads = 128;
constexpr int kPrefixUnroll = 8;

template <typename T>
__global__ void affine_prefix_kernel(const T* __restrict__ phi,
                                     const T* __restrict__ G,
                                     const T* __restrict__ carry,
                                     T* __restrict__ F, T* __restrict__ tot_a,
                                     T* __restrict__ tot_b, long long total,
                                     int M, int J, int K, int L, int NB,
                                     int reverse) {
  const long long gid = (long long)blockIdx.x * kPrefixThreads + threadIdx.x;
  if (gid >= total) return;
  const int E = J * K;
  const int e = (int)(gid % E);
  const int blk = (int)((gid / E) % NB);
  const long long chain = gid / ((long long)E * NB);
  const int j = e / K;
  const int lo = blk * L;
  const int len = min(L, M - lo);
  const int step = reverse ? -1 : 1;
  const int first = reverse ? lo + len - 1 : lo;
  const size_t row0 = (size_t)chain * M;
  const size_t blk0 = (size_t)chain * NB;

  T f = T(0), alpha = T(1);
  const int before = blk - step;  // the block walked before this one
  if (carry != nullptr && before >= 0 && before < NB)
    f = carry[(blk0 + before) * E + e];

  for (int r0 = 0; r0 < len; r0 += kPrefixUnroll) {
    T ph[kPrefixUnroll], g[kPrefixUnroll];
#pragma unroll
    for (int i = 0; i < kPrefixUnroll; ++i) {
      const bool in = r0 + i < len;
      const size_t row = row0 + first + step * (r0 + i);
      ph[i] = in ? phi[row * J + j] : T(1);
      g[i] = in ? G[row * E + e] : T(0);
    }
#pragma unroll
    for (int i = 0; i < kPrefixUnroll; ++i) {
      f = ph[i] * f + g[i];
      alpha *= ph[i];
      if (F != nullptr && r0 + i < len)
        F[(row0 + first + step * (r0 + i)) * E + e] = f;
    }
  }
  if (tot_b != nullptr) {
    tot_b[(blk0 + blk) * E + e] = f;
    if (e % K == 0) tot_a[(blk0 + blk) * J + j] = alpha;
  }
}

// ------------------------------------------------------------ launchers

template <typename T, int J>
int launch_factor_j(const void* p, const void* a, const void* U, const void* V,
                    void* d, void* W, void* Sh, int C, int N, cudaStream_t s) {
  const long long lanes = (long long)C * J;
  const unsigned grid =
      (unsigned)((lanes + kFactorThreads - 1) / kFactorThreads);
  factor_fwd_kernel<T, J><<<grid, kFactorThreads, 0, s>>>(
      (const T*)p, (const T*)a, (const T*)U, (const T*)V, (T*)d, (T*)W, (T*)Sh,
      C, N);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_factor_fwd(int J, const void* p, const void* a, const void* U,
                      const void* V, void* d, void* W, void* Sh, int C, int N,
                      cudaStream_t s) {
  switch (J) {
    case 1: return launch_factor_j<T, 1>(p, a, U, V, d, W, Sh, C, N, s);
    case 2: return launch_factor_j<T, 2>(p, a, U, V, d, W, Sh, C, N, s);
    case 4: return launch_factor_j<T, 4>(p, a, U, V, d, W, Sh, C, N, s);
    case 8: return launch_factor_j<T, 8>(p, a, U, V, d, W, Sh, C, N, s);
    case 16: return launch_factor_j<T, 16>(p, a, U, V, d, W, Sh, C, N, s);
    case 32: return launch_factor_j<T, 32>(p, a, U, V, d, W, Sh, C, N, s);
    default: return -1;
  }
}

template <typename T, int J>
int launch_sweep_j(const void* p, const void* A, const void* B, const void* Y,
                   void* Z, void* Fc, int C, int N, int K, int is_solve,
                   int upper, cudaStream_t s) {
  const int KB = (K + kSweepThreads - 1) / kSweepThreads;
  const unsigned grid = (unsigned)((long long)C * KB);
  sweep_fwd_kernel<T, J><<<grid, kSweepThreads, 0, s>>>(
      (const T*)p, (const T*)A, (const T*)B, (const T*)Y, (T*)Z, (T*)Fc, N, K,
      KB, is_solve, upper);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sweep_fwd(int J, const void* p, const void* A, const void* B,
                     const void* Y, void* Z, void* Fc, int C, int N, int K,
                     int is_solve, int upper, cudaStream_t s) {
  switch (J) {
    case 1:
      return launch_sweep_j<T, 1>(p, A, B, Y, Z, Fc, C, N, K, is_solve, upper, s);
    case 2:
      return launch_sweep_j<T, 2>(p, A, B, Y, Z, Fc, C, N, K, is_solve, upper, s);
    case 4:
      return launch_sweep_j<T, 4>(p, A, B, Y, Z, Fc, C, N, K, is_solve, upper, s);
    case 8:
      return launch_sweep_j<T, 8>(p, A, B, Y, Z, Fc, C, N, K, is_solve, upper, s);
    case 16:
      return launch_sweep_j<T, 16>(p, A, B, Y, Z, Fc, C, N, K, is_solve, upper,
                                   s);
    case 32:
      return launch_sweep_j<T, 32>(p, A, B, Y, Z, Fc, C, N, K, is_solve, upper,
                                   s);
    default:
      return -1;
  }
}

template <typename T>
int launch_affine_prefix(const void* phi, const void* G, const void* carry,
                         void* F, void* tot_a, void* tot_b, int C, int M, int J,
                         int K, int L, int reverse, cudaStream_t s) {
  const int NB = (M + L - 1) / L;
  const long long total = (long long)C * NB * J * K;
  const unsigned grid =
      (unsigned)((total + kPrefixThreads - 1) / kPrefixThreads);
  affine_prefix_kernel<T><<<grid, kPrefixThreads, 0, s>>>(
      (const T*)phi, (const T*)G, (const T*)carry, (T*)F, (T*)tot_a, (T*)tot_b,
      total, M, J, K, L, NB, reverse);
  return (int)cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------ C interface
//
// Each function launches on ``stream`` and returns cudaGetLastError() after
// the launch (0 on success); the factor and the sweep return -1 for a width
// that is not one of 1, 2, 4, 8, 16, 32.  Pointers are to contiguous device
// arrays of the scalar type given by ``is_double``.  The cache pointers ``Sh``
// and ``Fc`` may be null: the cache is then not written.  C, N, K >= 1.
// c2t_affine_prefix takes any J >= 1 and blocks of L >= 1 rows; ``carry``,
// ``F``, ``tot_a`` and ``tot_b`` may be null as its kernel describes.

extern "C" {

int c2t_factor_fwd(int is_double, int J, const void* p, const void* a,
                   const void* U, const void* V, void* d, void* W, void* Sh,
                   int C, int N, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_double
             ? launch_factor_fwd<double>(J, p, a, U, V, d, W, Sh, C, N, s)
             : launch_factor_fwd<float>(J, p, a, U, V, d, W, Sh, C, N, s);
}

int c2t_sweep_fwd(int is_double, int J, const void* p, const void* A,
                  const void* B, const void* Y, void* Z, void* Fc, int C, int N,
                  int K, int is_solve, int upper, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_double ? launch_sweep_fwd<double>(J, p, A, B, Y, Z, Fc, C, N, K,
                                              is_solve, upper, s)
                   : launch_sweep_fwd<float>(J, p, A, B, Y, Z, Fc, C, N, K,
                                             is_solve, upper, s);
}

int c2t_affine_prefix(int is_double, int J, const void* phi, const void* G,
                      const void* carry, void* F, void* tot_a, void* tot_b,
                      int C, int M, int K, int L, int reverse, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_double ? launch_affine_prefix<double>(phi, G, carry, F, tot_a,
                                                  tot_b, C, M, J, K, L,
                                                  reverse, s)
                   : launch_affine_prefix<float>(phi, G, carry, F, tot_a, tot_b,
                                                 C, M, J, K, L, reverse, s);
}

}  // extern "C"
