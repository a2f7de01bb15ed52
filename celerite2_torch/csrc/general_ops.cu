// The general semiseparable recursions at any celerite width J <= 32,
// written for Hopper (sm_90a): the LDL^T factor, the four sweeps (lower and
// upper solve, lower and upper matmul), their adjoints, and the blocked
// prefix of the diagonal-affine recurrence.  Built with nvcc into the shared
// library of celerite2_torch/ops/_build.py and bound with ctypes.
//
// factor_fwd_kernel replaces the TPU kernels
//   celerite2_tpu/ops/pallas_kernels.py  _factor_kernel  (factor_pallas)
//   celerite2_tpu/ops/pallas_packed.py   _factor_kernel  (factor_packed)
// and sweep_fwd_kernel replaces
//   celerite2_tpu/ops/pallas_kernels.py  _sweep_kernel   (_sweep_lower and
//                                        its time-flipped upper versions)
//   celerite2_tpu/ops/pallas_packed.py   _sweep_kernel   (_sweep_lower).
// Their adjoints: factor_bwd_kernel replaces
//   celerite2_tpu/ops/pallas_kernels.py  _factor_rev_kernel (factor_rev_pallas)
//   celerite2_tpu/ops/pallas_packed.py   _factor_rev_kernel (factor_rev_packed)
// and sweep_bwd_kernel replaces
//   celerite2_tpu/ops/pallas_kernels.py  _sweep_rev_kernel  (sweep_rev_pallas)
//   celerite2_tpu/ops/pallas_packed.py   _sweep_rev_kernel  (sweep_rev_packed).
// The tiled and the lane-packed TPU kernels differ in their TPU layout only,
// so one kernel here is the counterpart of both.  affine_prefix_kernel
// replaces, for the diagonal-affine element family (alpha, b), the in-block
// prefix kernel of the TPU's prefix engine,
//   celerite2_tpu/ops/planes_engine.py  _block_prefix_kernel,
// which is what the rectangular products of a prediction at new points run
// through (ops/api.py, _transported_cumulative); see that kernel below.
//
// The recursions are sequential in the rows n and independent across the C
// chains (and, for the sweeps, across the K right-hand sides).  What bounds
// them on this card is the latency of the dependent chain of one row step
// (a few dependent multiply-adds, a division or a shuffle reduction), N times
// over: at one chain the card moves a small fraction of what its memory
// could.  The design keeps everything that does not depend on the carry off
// that chain: a row's inputs are fetched before the row is reached (one row
// ahead in registers in the factor and its adjoint, a tile of rows ahead in
// shared memory in the sweeps), the carry stays in registers for all N rows,
// and chains and right-hand sides spread over threads.  Nothing is padded to
// a block of rows and nothing is pre-shifted: the previous row's d, w
// (factor) or b, r (sweep) are carried in registers and shared memory.  The
// adjoints walk the rows in the order opposite to their forward's.
//
// Layouts are natural row-major with a leading chain axis: p, U, V, W, A, B
// (C, N, J); a, d (C, N); Y, Z, R (C, N, K); the caches S_half (C, N, J, J)
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

// ====================================================== factor adjoint
//
// The reverse of the factor over the rows, descending, with the carried
// adjoint bS (J x J) of the carry S and the deferrals dba, dbv that row n
// hands to row n - 1 (celerite2_tpu/ops/scan.py factor_rev_scan):
//   ba = bd_n + dba;  bv = bW_n / d_n + dbv;  ba -= w_n . bv
//   bU_n = -(S_half_n diag(p_n)) (bv + 2 ba u_n)
//   bS  -= u_n (bv + ba u_n)^T
//   bp_n = diag(bS S_half_n + S_half_n^T bS) p_n
//   bS   = diag(p_n) bS diag(p_n)
//   dba  = w_{n-1}^T bS w_{n-1};  dbv = (bS + bS^T) w_{n-1}
// At row 0 (p_0 = 0, nothing enters) bU and bp are zero and the deferrals
// are not used; the wrapper turns bp into the time cotangents.
//
// J consecutive lanes serve one chain, as in the forward.  Unlike the
// forward's S, bS is not symmetric, and each lane needs both its column
// (for the update, the transport and w^T bS w) and its row (for bp and
// dbv).  Lane j keeps column j of bS in J registers and publishes it to
// shared memory after the rank-one update, where the group reads row j back
// (the TPU's lane-packed kernel keeps bS and bS^T for the same reason;
// rebuilding S_half^T from S_half by p_k / p_j would over- and underflow
// across large time gaps, so the cache is read as it is).  The row's cache
// S_half_n goes through shared memory too: lane j fetches column j of the
// next row's cache (coalesced) a row ahead, and reads row j of it for bU.
// Shared tiles are padded to a row stride of J + 1 against bank conflicts.
template <typename T, int J>
__global__ void factor_bwd_kernel(const T* __restrict__ p,
                                  const T* __restrict__ d,
                                  const T* __restrict__ U,
                                  const T* __restrict__ W,
                                  const T* __restrict__ Sh,
                                  const T* __restrict__ bd,
                                  const T* __restrict__ bW, T* __restrict__ ba,
                                  T* __restrict__ bU, T* __restrict__ bV,
                                  T* __restrict__ bp, int C, int N) {
  constexpr int S = J + 1;  // row stride of the shared tiles
  __shared__ T sbS[kFactorThreads * S], sSh[kFactorThreads * S];
  __shared__ T sp[kFactorThreads], su[kFactorThreads], spg[kFactorThreads],
      sq[kFactorThreads];
  const int tid = threadIdx.x;
  const long long gid = (long long)blockIdx.x * kFactorThreads + tid;
  const long long chain_of = gid / J;
  const bool live = chain_of < C;
  // lanes past the last chain repeat it (they must take part in the
  // shuffles) and store nothing
  const size_t row0 = (size_t)(live ? chain_of : C - 1) * N;
  const int j = tid % J;
  const int base = tid - j;
  T* const tS = sbS + base * S;  // tS[i * S + r] = bS[r][i]
  T* const tSh = sSh + base * S;  // tSh[r * S + i] = S_half_n[r][i]

  T col[J];  // column j of bS
#pragma unroll
  for (int i = 0; i < J; ++i) col[i] = T(0);
  T dba = T(0), dbv = T(0);

  // row N - 1's inputs; each later fetch runs one row ahead
  size_t row = row0 + N - 1;
  T p_n = p[row * J + j], u_n = U[row * J + j], w_n = W[row * J + j];
  T bw_n = bW[row * J + j], d_n = d[row], bd_n = bd[row];
  T w_prev = N > 1 ? W[(row - 1) * J + j] : T(0);
  T shc[J];  // column j of S_half_n
#pragma unroll
  for (int k = 0; k < J; ++k) shc[k] = Sh[(row * J + k) * J + j];

  for (int n = N - 1; n >= 0; --n) {
    row = row0 + n;
    const T pj = p_n, uj = u_n, wj = w_n, bwj = bw_n, dn = d_n, bdn = bd_n;
    const T wpj = w_prev;
#pragma unroll
    for (int k = 0; k < J; ++k) tSh[k * S + j] = shc[k];
    if (n > 0) {
      const size_t nx = row - 1;
      p_n = p[nx * J + j];
      u_n = U[nx * J + j];
      w_n = wpj;
      bw_n = bW[nx * J + j];
      d_n = d[nx];
      bd_n = bd[nx];
      w_prev = n > 1 ? W[(nx - 1) * J + j] : T(0);
#pragma unroll
      for (int k = 0; k < J; ++k) shc[k] = Sh[(nx * J + k) * J + j];
    }
    const T bv = bwj / (dn > T(0) ? dn : T(1)) + dbv;
    T dot = wj * bv;
#pragma unroll
    for (int off = J / 2; off > 0; off /= 2)
      dot += __shfl_xor_sync(kFullMask, dot, off, J);
    const T ban = bdn + dba - dot;
    const T h = bv + ban * uj;  // bS -= u h^T
    const T g = h + ban * uj;   // bv + 2 ba u
    sp[tid] = pj;
    su[tid] = uj;
    spg[tid] = pj * g;
    sq[tid] = pj * wpj;  // diag(p_n) w_{n-1}: the deferrals after transport
    __syncwarp();
    T bu = T(0);
#pragma unroll
    for (int k = 0; k < J; ++k) bu += tSh[j * S + k] * spg[base + k];
#pragma unroll
    for (int i = 0; i < J; ++i) {
      col[i] -= su[base + i] * h;
      tS[j * S + i] = col[i];
    }
    __syncwarp();  // bS after the update is in shared memory
    T bpa = T(0), dv = T(0), cq = T(0);
#pragma unroll
    for (int k = 0; k < J; ++k) {
      const T sym = tS[k * S + j] + col[k];  // bS[j][k] + bS[k][j]
      bpa += sym * tSh[k * S + j];
      dv += sym * sq[base + k];
      cq += col[k] * sq[base + k];
    }
    T dq = sq[tid] * cq;
#pragma unroll
    for (int off = J / 2; off > 0; off /= 2)
      dq += __shfl_xor_sync(kFullMask, dq, off, J);
    dba = dq;
    dbv = pj * dv;
#pragma unroll
    for (int i = 0; i < J; ++i) col[i] *= sp[base + i] * pj;
    if (live) {
      bV[row * J + j] = bv;
      bU[row * J + j] = n > 0 ? -bu : T(0);
      bp[row * J + j] = n > 0 ? pj * bpa : T(0);
      if (j == 0) ba[row] = ban;
    }
    __syncwarp();  // every lane has read this row's shared tiles
  }
}

// ======================================================= sweep adjoint
//
// The reverse of a sweep, walking the rows in the order opposite to the
// forward's (descending for a lower sweep, ascending for an upper one),
// with the carried adjoint bF (J x K) of the transported carry
// (celerite2_tpu/ops/scan.py sweep_rev_scan).  Per row n, what the rows
// walked before left for it comes first, then the row's own step (s = -1
// for a solve, +1 for a matmul; r_n = z_n for a solve, y_n for a matmul):
//   bB_n = bF r_n;  dbR = bF^T b_n;  bz = bZ_n (+ dbR for a solve)
//   bA_n = s diag(p_n) F_n bz;  M = bF + s a_n bz^T
//   bp_n = p_n sum_k (F_n o M);  bF = diag(p_n) M
// and bY_n = bz for a solve, dbR for a matmul.
//
// As in the forward, one thread owns one right-hand side k of one chain
// and keeps column k of bF in registers (the carry is independent across
// k), a block stages p, A, B for a tile of rows in shared memory, and each
// thread fetches its r, bZ and column k of F_n one row ahead.  bB_n, bA_n
// and bp_n are sums over k, so across threads: with K = 1 (the
// log-likelihood's shape) the one thread writes them; otherwise each warp
// sums its lanes by xor shuffles and its first lane adds the sums into the
// zeroed outputs with atomicAdd (the order of those adds varies from run to
// run in the last bits).  Nothing of size (C, N, J, K) is allocated.
template <typename T, int J>
__global__ void sweep_bwd_kernel(const T* __restrict__ p,
                                 const T* __restrict__ A,
                                 const T* __restrict__ B,
                                 const T* __restrict__ R,
                                 const T* __restrict__ Fc,
                                 const T* __restrict__ bZ, T* __restrict__ bA,
                                 T* __restrict__ bB, T* __restrict__ bp,
                                 T* __restrict__ bY, int N, int K, int KB,
                                 int is_solve, int upper) {
  constexpr int kTileRows = kTileElems / J;
  __shared__ T sp[kTileElems], sa[kTileElems], sb[kTileElems];
  const int chain = blockIdx.x / KB;
  const int k = (blockIdx.x % KB) * kSweepThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool live = k < K;
  const bool single = K == 1;
  // with K > 1 a warp runs whole (its dead lanes carry zeros) when any of
  // its lanes is live
  const bool run = single ? live : (k - lane < K);
  const size_t row0 = (size_t)chain * N;
  const T s = is_solve ? T(-1) : T(1);

  T bF[J];
#pragma unroll
  for (int j = 0; j < J; ++j) bF[j] = T(0);
  const int step = upper ? 1 : -1;
  int n = upper ? 0 : N - 1;
  T r_nx = T(0), bz_nx = T(0), F_nx[J];
#pragma unroll
  for (int j = 0; j < J; ++j) F_nx[j] = T(0);
  if (live) {
    const size_t row = row0 + n;
    r_nx = R[row * K + k];
    bz_nx = bZ[row * K + k];
#pragma unroll
    for (int j = 0; j < J; ++j) F_nx[j] = Fc[(row * J + j) * K + k];
  }

  for (int q0 = 0; q0 < N; q0 += kTileRows) {
    const int rows = min(kTileRows, N - q0);
    const int lo = upper ? q0 : N - q0 - rows;  // first row of the tile
    __syncthreads();  // the previous tile has been consumed
    const size_t tile0 = (row0 + lo) * J;
    for (int e = threadIdx.x; e < rows * J; e += kSweepThreads) {
      sp[e] = p[tile0 + e];
      sa[e] = A[tile0 + e];
      sb[e] = B[tile0 + e];
    }
    __syncthreads();
    if (!run) continue;
    for (int q = 0; q < rows; ++q, n += step) {
      const int at = (n - lo) * J;
      const size_t row = row0 + n;
      const T r = r_nx, bzi = bz_nx;
      T Fn[J];
#pragma unroll
      for (int j = 0; j < J; ++j) Fn[j] = F_nx[j];
      const int nn = n + step;
      if (live && nn >= 0 && nn < N) {
        const size_t rx = row0 + nn;
        r_nx = R[rx * K + k];
        bz_nx = bZ[rx * K + k];
#pragma unroll
        for (int j = 0; j < J; ++j) F_nx[j] = Fc[(rx * J + j) * K + k];
      }
      T dbR = T(0);
#pragma unroll
      for (int j = 0; j < J; ++j) dbR += bF[j] * sb[at + j];
      const T bz = is_solve ? bzi + dbR : bzi;
      if (live) bY[row * K + k] = is_solve ? bz : dbR;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const T pj = sp[at + j];
        T vb = bF[j] * r;
        T va = s * pj * Fn[j] * bz;
        const T m = bF[j] + s * sa[at + j] * bz;
        T vp = pj * Fn[j] * m;
        bF[j] = pj * m;
        if (single) {
          bB[row * J + j] = vb;
          bA[row * J + j] = va;
          bp[row * J + j] = vp;
        } else {
#pragma unroll
          for (int off = 16; off > 0; off /= 2) {
            vb += __shfl_xor_sync(kFullMask, vb, off);
            va += __shfl_xor_sync(kFullMask, va, off);
            vp += __shfl_xor_sync(kFullMask, vp, off);
          }
          if (lane == 0) {
            atomicAdd(bB + row * J + j, vb);
            atomicAdd(bA + row * J + j, va);
            atomicAdd(bp + row * J + j, vp);
          }
        }
      }
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

template <typename T, int J>
int launch_factor_bwd_j(const void* p, const void* d, const void* U,
                        const void* W, const void* Sh, const void* bd,
                        const void* bW, void* ba, void* bU, void* bV, void* bp,
                        int C, int N, cudaStream_t s) {
  const long long lanes = (long long)C * J;
  const unsigned grid =
      (unsigned)((lanes + kFactorThreads - 1) / kFactorThreads);
  factor_bwd_kernel<T, J><<<grid, kFactorThreads, 0, s>>>(
      (const T*)p, (const T*)d, (const T*)U, (const T*)W, (const T*)Sh,
      (const T*)bd, (const T*)bW, (T*)ba, (T*)bU, (T*)bV, (T*)bp, C, N);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_factor_bwd(int J, const void* p, const void* d, const void* U,
                      const void* W, const void* Sh, const void* bd,
                      const void* bW, void* ba, void* bU, void* bV, void* bp,
                      int C, int N, cudaStream_t s) {
#define C2T_FACTOR_BWD(JJ)                                                  \
  case JJ:                                                                  \
    return launch_factor_bwd_j<T, JJ>(p, d, U, W, Sh, bd, bW, ba, bU, bV, \
                                      bp, C, N, s)
  switch (J) {
    C2T_FACTOR_BWD(1);
    C2T_FACTOR_BWD(2);
    C2T_FACTOR_BWD(4);
    C2T_FACTOR_BWD(8);
    C2T_FACTOR_BWD(16);
    C2T_FACTOR_BWD(32);
    default:
      return -1;
  }
#undef C2T_FACTOR_BWD
}

template <typename T, int J>
int launch_sweep_bwd_j(const void* p, const void* A, const void* B,
                       const void* R, const void* Fc, const void* bZ, void* bA,
                       void* bB, void* bp, void* bY, int C, int N, int K,
                       int is_solve, int upper, cudaStream_t s) {
  const int KB = (K + kSweepThreads - 1) / kSweepThreads;
  const unsigned grid = (unsigned)((long long)C * KB);
  sweep_bwd_kernel<T, J><<<grid, kSweepThreads, 0, s>>>(
      (const T*)p, (const T*)A, (const T*)B, (const T*)R, (const T*)Fc,
      (const T*)bZ, (T*)bA, (T*)bB, (T*)bp, (T*)bY, N, K, KB, is_solve, upper);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sweep_bwd(int J, const void* p, const void* A, const void* B,
                     const void* R, const void* Fc, const void* bZ, void* bA,
                     void* bB, void* bp, void* bY, int C, int N, int K,
                     int is_solve, int upper, cudaStream_t s) {
#define C2T_SWEEP_BWD(JJ)                                                   \
  case JJ:                                                                  \
    return launch_sweep_bwd_j<T, JJ>(p, A, B, R, Fc, bZ, bA, bB, bp, bY, C, \
                                     N, K, is_solve, upper, s)
  switch (J) {
    C2T_SWEEP_BWD(1);
    C2T_SWEEP_BWD(2);
    C2T_SWEEP_BWD(4);
    C2T_SWEEP_BWD(8);
    C2T_SWEEP_BWD(16);
    C2T_SWEEP_BWD(32);
    default:
      return -1;
  }
#undef C2T_SWEEP_BWD
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
// the launch (0 on success); the factor, the sweep and their adjoints return
// -1 for a width that is not one of 1, 2, 4, 8, 16, 32.  Pointers are to
// contiguous device arrays of the scalar type given by ``is_double``.  The
// forward's cache pointers ``Sh`` and ``Fc`` may be null: the cache is then
// not written.  The adjoints read the caches; with K > 1 the sweep adjoint
// adds into ``bA``, ``bB`` and ``bp``, which must be zeroed.  C, N, K >= 1.
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

int c2t_factor_bwd(int is_double, int J, const void* p, const void* d,
                   const void* U, const void* W, const void* Sh,
                   const void* bd, const void* bW, void* ba, void* bU,
                   void* bV, void* bp, int C, int N, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_double ? launch_factor_bwd<double>(J, p, d, U, W, Sh, bd, bW, ba,
                                               bU, bV, bp, C, N, s)
                   : launch_factor_bwd<float>(J, p, d, U, W, Sh, bd, bW, ba,
                                              bU, bV, bp, C, N, s);
}

int c2t_sweep_bwd(int is_double, int J, const void* p, const void* A,
                  const void* B, const void* R, const void* Fc, const void* bZ,
                  void* bA, void* bB, void* bp, void* bY, int C, int N, int K,
                  int is_solve, int upper, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_double ? launch_sweep_bwd<double>(J, p, A, B, R, Fc, bZ, bA, bB,
                                              bp, bY, C, N, K, is_solve,
                                              upper, s)
                   : launch_sweep_bwd<float>(J, p, A, B, R, Fc, bZ, bA, bB, bp,
                                             bY, C, N, K, is_solve, upper, s);
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
