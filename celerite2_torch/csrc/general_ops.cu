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
// that chain, and the carry in registers for all N rows; chains and
// right-hand sides spread over threads.  The forward kernels fetch a row's
// inputs before the row is reached (one row ahead in registers in the
// factor, a tile of rows ahead in shared memory in the sweep), carry the
// previous row's d, w (factor) or b, r (sweep) in registers and shared
// memory, and store their outputs and caches from the carry's own thread.
// The adjoints, which walk the rows in the order opposite to their
// forward's, go further (see "the adjoints' tile ring" below): a producer
// warp keeps tiles of rows in flight into shared memory by asynchronous
// bulk copies, a carry warp per chain does only the carry, and epilogue
// warps compute the per-row outputs from what the carry leaves in shared
// memory and store them by tiles; a block serves one chain, or up to four
// when C is large.  Nothing is padded to a block of rows and nothing is
// pre-shifted.
//
// Layouts are natural row-major with a leading chain axis: p, U, V, W, A, B
// (C, N, J); a, d (C, N); Y, Z, R (C, N, K); the caches S_half (C, N, J, J)
// and F (C, N, J, K).  p is the transport exp(-c dt) of each row (0 at the
// row where nothing enters: row 0, or row N-1 for an upper sweep).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <initializer_list>

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

// ============================================== the adjoints' tile ring
//
// Both adjoints walk N rows with a carry that depends on every row before,
// and read caches far larger than the carry: S_half (C, N, J, J) for the
// factor's, F (C, N, J, K) for the sweep's.  Their blocks split the work by
// warp, so that the carry's dependent chain waits on nothing else:
//   warp 0, the producer, keeps kRingStages tiles of rows in flight into a
//     ring of slots in dynamic shared memory, in the order the rows are
//     walked.  A tile that is contiguous in device memory and starts on a
//     16-byte boundary goes by one bulk copy (cp.async.bulk, completing on
//     the slot's mbarrier), the few elements past its last 16 bytes by
//     cp.async; a tile off a 16-byte boundary (odd N at J = 1, float32 at
//     J <= 2, a view into the middle of an allocation) or strided (a slice
//     of the right-hand sides) by cp.async, one element per lane and copy;
//   warps 1 .. n, one per chain of the block, walk the carry over the
//     tile's rows and leave, per row, what the outputs need of the carry in
//     a second, double-buffered tile;
//   the other warps of the block, the epilogue, turn those tiles and the
//     ring slot into the per-row outputs and store them, coalesced, then
//     free both for the next tile.
// Each hand-over is an mbarrier: a slot is full when its bytes have landed,
// empty when the epilogue is done with it; an output tile is full when the
// carry warps have walked it, empty when the epilogue has stored it.  Tile
// t uses ring slot t % kRingStages and output tile t % 2; a wait on a
// barrier's k-th completion passes parity k & 1.  A slot and an output
// tile hold the tile's rows of each of the block's n chains.
//
// A block of one chain is as fast as a chain goes, but its ring (up to
// about 96 KB) lets few blocks share a multiprocessor (two at J = 8 in
// float64): past that the blocks would run in waves, each walking all N
// rows (H100, J = 8, float64, N = 3e4: 1024 chains one to a block took the
// factor adjoint 31.7 ms, four to a block 19.1).  So the launch puts n
// chains into a block, with n carry warps and tiles of 1 / n the rows, and
// takes the fewest n that brings the blocks to as few waves as any n up to
// kMaxRingChains does (the card's occupancy of the kernel at each n, from
// the runtime): n is 1 while the chains fit one wave of blocks of one
// chain, and grows with C past that.
//
// On this card one warp walking a chain spends its time on its shared
// memory loads and stores more than on the latency of its multiply-adds
// (PERF.md, Findings), so a carry warp reads and writes whole rows of 16
// bytes at a time: every tile row sits on a 16-byte boundary in its slot,
// and the per-row tiles the carry writes are padded to keep theirs.
constexpr int kRingStages = 3;
// Each kernel has two instantiations, by the most chains NC of its blocks:
// NC = 1, a block of the producer, one carry warp and four epilogue warps,
// all of it fixed at compile time; and NC = kMaxRingChains, blocks of
// 2 .. NC chains (a launch's count) beside three epilogue warps: eight
// warps at most, two on each of the multiprocessor's four schedulers, which
// leaves a thread all 255 registers (nine spilled the factor adjoint at
// J = 16).  One instantiation for both was 10-17% slower at one chain.
constexpr int kMaxRingChains = 4;
__host__ __device__ constexpr int epilogue_warps(int NC) {
  return NC == 1 ? 4 : 3;
}
__host__ __device__ constexpr int ring_threads(int NC, int chains) {
  return 32 * (1 + chains + epilogue_warps(NC));
}
// rows per tile: what fits this much shared memory, within these bounds
constexpr size_t kRingBudget = 96 * 1024;
constexpr int kMinTileRows = 4;
constexpr int kMaxTileRows = 128;
// right-hand sides per block of the sweep adjoint (one carry warp)
constexpr int kSweepBwdSlice = 32;

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// arrive, and expect ``bytes`` more from bulk copies before the phase ends
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_done(uint64_t* bar, unsigned parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred P;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
      " selp.u32 %0, 1, 0, P;\n}"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// the carry warp's wait: its data is nearly always there already
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  while (!mbar_done(bar, parity)) {
  }
}

// The wait of a warp that has nothing else to do (the producer, the
// epilogue): it backs off between tries, so that its polling takes few
// issue slots and little shared-memory bandwidth from the carry warp.
__device__ __forceinline__ void mbar_wait_idle(uint64_t* bar,
                                               unsigned parity) {
  unsigned ns = 32;
  while (!mbar_done(bar, parity)) {
    __nanosleep(ns);
    ns = min(2 * ns, 1024u);
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_addr(dst)),
               "l"(src), "n"(sizeof(T))
               : "memory");
}

// the barrier's phase also waits for this thread's cp.async copies so far
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// epilogue warps only (named barrier 1; barrier 0 is __syncthreads)
template <int THREADS>
__device__ __forceinline__ void epilogue_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(THREADS) : "memory");
}

// ---- rows of 16 bytes at a time (scalars where a row is not 16k bytes)

template <typename T>
struct Vec16;
template <>
struct Vec16<double> {
  using type = double2;
  __device__ static void get(const double2& v, double* x) {
    x[0] = v.x;
    x[1] = v.y;
  }
  __device__ static double2 put(const double* x) {
    return make_double2(x[0], x[1]);
  }
};
template <>
struct Vec16<float> {
  using type = float4;
  __device__ static void get(const float4& v, float* x) {
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
  __device__ static float4 put(const float* x) {
    return make_float4(x[0], x[1], x[2], x[3]);
  }
};

// whether rows of N values of T are whole 16-byte pieces
template <typename T, int N>
constexpr bool kRowVec = N * sizeof(T) % 16 == 0;

template <typename T, int N>
__device__ __forceinline__ void load_row(T (&x)[N], const T* src) {
  if constexpr (kRowVec<T, N>) {
    using V = Vec16<T>;
    constexpr int W = 16 / sizeof(T);
#pragma unroll
    for (int i = 0; i < N; i += W)
      V::get(*reinterpret_cast<const typename V::type*>(src + i), x + i);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = src[i];
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_row(T* dst, const T (&x)[N]) {
  if constexpr (kRowVec<T, N>) {
    using V = Vec16<T>;
    constexpr int W = 16 / sizeof(T);
#pragma unroll
    for (int i = 0; i < N; i += W)
      *reinterpret_cast<typename V::type*>(dst + i) = V::put(x + i);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = x[i];
  }
}

// two values side by side (8- or 16-byte aligned)
__device__ __forceinline__ void store_pair(double* dst, double a, double b) {
  *reinterpret_cast<double2*>(dst) = make_double2(a, b);
}
__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

// x[i] for a lane-dependent i, without indexing a register array at run time
template <typename T, int N>
__device__ __forceinline__ T pick(const T (&x)[N], int i) {
  T v = x[0];
#pragma unroll
  for (int k = 1; k < N; ++k) v = k == i ? x[k] : v;
  return v;
}

// a . x over N values in two independent chains
template <typename T, int N>
__device__ __forceinline__ T dot2(const T (&a)[N], const T (&x)[N]) {
  T s0 = T(0), s1 = T(0);
#pragma unroll
  for (int k = 0; k < N; k += 2) {
    s0 += a[k] * x[k];
    if (k + 1 < N) s1 += a[k + 1] * x[k + 1];
  }
  return s0 + s1;
}

// a . x for a row x of J values in shared memory at ``src``, of which the
// first CH are in ``x0`` already; the rest is read CH values at a time
template <int CH, typename T, int J>
__device__ __forceinline__ T dot_row(const T (&a)[J], const T (&x0)[CH],
                                     const T* src) {
  if constexpr (CH == J) {
    return dot2(a, x0);
  } else {
    T s0 = T(0), s1 = T(0);
#pragma unroll
    for (int c = 0; c < J; c += CH) {
      T xc[CH];
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < CH; ++i) xc[i] = x0[i];
      } else {
        load_row(xc, src + c);
      }
#pragma unroll
      for (int i = 0; i < CH; ++i) (i & 1 ? s1 : s0) += a[c + i] * xc[i];
    }
    return s0 + s1;
  }
}

// ---- the producer's copies

// Dynamic shared memory handed out in 16-byte aligned pieces; the same
// sequence of take() calls on the host gives the launch's byte count.
struct Carve {
  unsigned top = 0;
  __host__ __device__ unsigned take(unsigned bytes) {
    const unsigned at = (top + 15u) & ~15u;
    top = at + bytes;
    return at;
  }
  __host__ __device__ unsigned end() const { return (top + 15u) & ~15u; }
};

// Elements of a contiguous piece of ``count`` at ``src`` that one bulk copy
// takes: its whole 16-byte pieces, none if ``src`` is off a 16-byte boundary.
template <typename T>
__device__ __forceinline__ int bulk_elems(const T* src, int count) {
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  return aligned ? count * (int)sizeof(T) / 16 * 16 / (int)sizeof(T) : 0;
}

// The producer warp fills a ring slot.  ``pieces(visit)`` calls visit(dst,
// src, count) for each contiguous piece of the tile (dst 16-byte aligned).
// The lanes start cp.async copies of what a bulk copy cannot take and have
// the barrier wait for them; then lane 0 arrives expecting the bulk copies'
// bytes and starts them.
template <typename T, typename Pieces>
__device__ void fill_slot(Pieces pieces, uint64_t* full, int lane) {
  unsigned bytes = 0;
  pieces([&](T* dst, const T* src, int count) {
    const int body = bulk_elems(src, count);
    for (int i = body + lane; i < count; i += 32)
      cp_async_elem(dst + i, src + i);
    bytes += body * sizeof(T);
  });
  cp_async_arrive(full);
  __syncwarp();
  if (lane != 0) return;
  mbar_arrive_tx(full, bytes);
  pieces([&](T* dst, const T* src, int count) {
    const int body = bulk_elems(src, count);
    if (body > 0) bulk_load(dst, src, body * sizeof(T), full);
  });
}

// The ring's barriers: full and empty per slot, full and empty per output
// tile, and (the factor adjoint's) the epilogue's per-row preparation.
struct RingBars {
  uint64_t full[kRingStages], empty[kRingStages];
  uint64_t out_full[2], out_empty[2], prep_full[2];
};

// ``carries``: the carry warps that walk an output tile; ``epilogue``: the
// epilogue's warps
__device__ void ring_init(RingBars* bars, int carries, int epilogue) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRingStages; ++s) {
      mbar_init(&bars->full[s], 1);
      mbar_init(&bars->empty[s], epilogue);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&bars->out_full[b], carries);
      mbar_init(&bars->out_empty[b], epilogue);
      mbar_init(&bars->prep_full[b], epilogue);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// The producer's wait before refilling the slot of tile t (its previous
// tile, t - kRingStages, must have been freed), and the fence that orders
// the epilogue's reads of that slot before the bulk copies' writes.
__device__ __forceinline__ void ring_wait_empty(RingBars* bars, int t) {
  if (t >= kRingStages)
    mbar_wait_idle(&bars->empty[t % kRingStages],
                   ((t / kRingStages) & 1) ^ 1);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void ring_wait_full(RingBars* bars, int t,
                                               bool idle) {
  uint64_t* bar = &bars->full[t % kRingStages];
  if (idle)
    mbar_wait_idle(bar, (t / kRingStages) & 1);
  else
    mbar_wait(bar, (t / kRingStages) & 1);
}

// one arrival per epilogue warp
__device__ __forceinline__ void epilogue_arrive(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

int tile_rows(size_t bytes_per_row) {
  const size_t rows = kRingBudget / bytes_per_row;
  return (int)std::max<size_t>(kMinTileRows,
                               std::min<size_t>(kMaxTileRows, rows));
}

// Set a kernel's dynamic shared memory limit above the default 48 KB once
// per instantiation (and again if a launch asks for more).
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes, size_t* allowed) {
  if (bytes <= 48 * 1024 || bytes <= *allowed) return 0;
  const int rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc == 0) *allowed = bytes;
  return rc;
}

// A launch's ring: its kernel (of the instantiation for its chains per
// block), rows per tile, chains per block, threads, dynamic shared memory,
// and the shared memory the kernel is allowed so far.
template <typename Kernel>
struct RingPlan {
  Kernel kernel = nullptr;
  int rows = 0, chains = 0, threads = 0;
  size_t bytes = 0;
  size_t* allowed = nullptr;
};

// The plan for C chains: of n = 1 .. max_chains (``size(n)`` gives each
// n's plan), the fewest chains per block that bring the blocks to as few
// waves over the card's multiprocessors as any, by the runtime's occupancy
// of the plan's kernel; an n whose ring exceeds a block's shared memory
// ends the search (rings grow with n once their tiles are shortest).
// Returns a CUDA error, or -1 if no n fits.
template <typename Kernel, typename Size>
int ring_plan(long long C, int max_chains, Size size,
              RingPlan<Kernel>* best) {
  int dev = 0, sms = 0, most = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc == 0)
    rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
  if (rc == 0)
    rc = (int)cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rc != 0) return rc;
  long long best_waves = -1;
  for (int n = 1; n <= max_chains && best_waves != 1; ++n) {
    const RingPlan<Kernel> plan = size(n);
    if (plan.bytes > (size_t)most) break;
    rc = allow_smem(plan.kernel, plan.bytes, plan.allowed);
    int per_sm = 0;
    if (rc == 0)
      rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, plan.kernel, plan.threads, plan.bytes);
    if (rc != 0) return rc;
    if (per_sm < 1) continue;
    const long long slots = (long long)per_sm * sms;
    const long long waves = ((C + n - 1) / n + slots - 1) / slots;
    if (best_waves < 0 || waves < best_waves) {
      best_waves = waves;
      *best = plan;
    }
  }
  return best_waves < 0 ? -1 : 0;
}

// ====================================================== factor adjoint
//
// The reverse of the factor over the rows, descending
// (celerite2_tpu/ops/scan.py factor_rev_scan).  Its carried adjoint bS of
// the carry S enters every use as bS + bS^T (the rank-one update, bp, the
// deferrals w^T bS w and (bS + bS^T) w), so the kernel carries the
// symmetric G = bS + bS^T.  With G the carry entering row n (after row
// n + 1's transport; zero at row N - 1):
//   y  = G w_n;  q = w_n . y;  ba = bd_n - w_n . (bW_n / d_n) - q / 2
//   bv = bW_n / d_n + y;  h = bv + ba u_n;  g = h + ba u_n
//   G~ = G - u_n h^T - h u_n^T                   (the snapshot of row n)
//   bU_n = -(S_half_n diag(p_n)) g;  bp_n = p_n o diag(G~ S_half_n)
//   G  = diag(p_n) G~ diag(p_n)
// which is the plain version's recursion (dba = q / 2, dbv = y) with the
// deferrals folded into the row that uses them.  At row 0 (p_0 = 0,
// nothing enters) bU and bp are zero.
//
// What bounds it on this card is the row step of one chain, 1e5 steps
// (H100, N = 1e5, J = 8: waiting for a row's inputs fetched one row ahead
// from device memory was 4% of a row, its stores nothing, the step itself
// the rest).  So each chain of a block has a carry warp that does only the
// chain: lane j of J keeps column j of G in registers (also its row j, as
// G is symmetric), reads the row's p, u, w and bW / d 16 bytes at a time,
// computes y_j, gathers y through shared memory (one store, one read of
// the row), then q, ba and its column of the snapshot, which it leaves in
// the output tile.  The epilogue prepares bW / d and
// bd - w . (bW / d) for each tile before the carry reaches it (the division
// by the guarded pivot, divide by 1 where d <= 0, never on the chain), and
// after it turns the snapshots, g, bv, ba and the ring's S_half (51 MB at
// N = 1e5, J = 8, needed by bU and bp alone) into the outputs.
template <typename T, int J>
struct FactorBwdSmem {
  // row stride of the snapshot tile: J values and 16 bytes, so that each
  // lane's row is 16-byte aligned and the lanes' rows fall in other banks
  static constexpr int kSnap = J + 16 / sizeof(T);
  // a chain's part of a slot: p, U, W, bW (rows x J), S_half (rows x J x
  // J), d, bd (rows)
  unsigned p, u, w, bw, sh, d, bd, slot;
  // a chain's part of an output tile: bW / d and bd - w . (bW / d)
  // (prepared ahead of the carry), the snapshots (rows x J x kSnap), (g,
  // bv) pairs, ba
  unsigned bwd, bdc, snap, gv, ba, out;
  unsigned ring, ybuf, outs, bytes;
  static constexpr unsigned kYbuf = (2 * J * sizeof(T) + 15u) & ~15u;
  // R rows per tile, ``chains`` chains per block
  __host__ __device__ FactorBwdSmem(int R, int chains) {
    const unsigned row = R * J * sizeof(T);
    Carve c;
    p = c.take(row);
    u = c.take(row);
    w = c.take(row);
    bw = c.take(row);
    sh = c.take(R * J * J * sizeof(T));
    d = c.take(R * sizeof(T));
    bd = c.take(R * sizeof(T));
    slot = c.end();
    Carve o;
    bwd = o.take(row);
    bdc = o.take(R * sizeof(T));
    snap = o.take(R * J * kSnap * sizeof(T));
    gv = o.take(2 * row);
    ba = o.take(R * sizeof(T));
    out = o.end();
    ring = (sizeof(RingBars) + 15u) & ~15u;
    ybuf = ring + kRingStages * chains * slot;  // per chain, y of two rows
    outs = ybuf + chains * kYbuf;
    bytes = outs + 2 * chains * out;
  }
  // per chain and row
  static size_t bytes_per_row() {
    return (kRingStages * (J * J + 4 * J + 2) +
            2 * (J * kSnap + 3 * J + 2)) *
           sizeof(T);
  }
};

template <typename T, int J, int NC>
__global__ void __launch_bounds__(ring_threads(NC, NC))
    factor_bwd_kernel(const T* __restrict__ p, const T* __restrict__ d,
                      const T* __restrict__ U, const T* __restrict__ W,
                      const T* __restrict__ Sh, const T* __restrict__ bd,
                      const T* __restrict__ bW, T* __restrict__ ba,
                      T* __restrict__ bU, T* __restrict__ bV,
                      T* __restrict__ bp, int C, int N, int R,
                      int chains_) {
  constexpr int SN = FactorBwdSmem<T, J>::kSnap;
  // values of a row of u, p and bW / d the carry lane holds at once: the
  // whole row, or 16 bytes where J rows of seven arrays would not fit its
  // registers (float64 at J = 32)
  constexpr int CH = J * sizeof(T) > 128 ? 16 / sizeof(T) : J;
  extern __shared__ __align__(16) unsigned char smem[];
  const int chains = NC == 1 ? 1 : chains_;  // of this launch's blocks
  const int c0 = blockIdx.x * chains;
  const int live = min(chains, C - c0);  // this block's chains
  const FactorBwdSmem<T, J> L(R, chains);
  RingBars* bars = reinterpret_cast<RingBars*>(smem);
  // chain g's piece of ring slot s, of output tile o
  auto in = [&](int s, int g, unsigned piece) {
    return reinterpret_cast<T*>(smem + L.ring + (s * chains + g) * L.slot +
                                piece);
  };
  auto out = [&](int o, int g, unsigned piece) {
    return reinterpret_cast<T*>(smem + L.outs + (o * chains + g) * L.out +
                                piece);
  };
  const int tiles = (N + R - 1) / R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  constexpr int ET = 32 * epilogue_warps(NC);  // the epilogue's threads
  ring_init(bars, live, ET / 32);
  // tile t holds rows [lo, lo + rows), walked from the top down
  auto tile = [&](int t, int& lo, int& rows) {
    rows = min(R, N - t * R);
    lo = N - t * R - rows;
  };

  if (warp == 0) {  // ----------------------------------------- producer
    for (int t = 0; t < tiles; ++t) {
      int lo, rows;
      tile(t, lo, rows);
      const int s = t % kRingStages;
      ring_wait_empty(bars, t);
      fill_slot<T>(
          [&](auto&& piece) {
            for (int g = 0; g < live; ++g) {
              const size_t first = (size_t)(c0 + g) * N + lo;
              piece(in(s, g, L.p), p + first * J, rows * J);
              piece(in(s, g, L.u), U + first * J, rows * J);
              piece(in(s, g, L.w), W + first * J, rows * J);
              piece(in(s, g, L.bw), bW + first * J, rows * J);
              piece(in(s, g, L.sh), Sh + first * J * J, rows * J * J);
              piece(in(s, g, L.d), d + first, rows);
              piece(in(s, g, L.bd), bd + first, rows);
            }
          },
          &bars->full[s], lane);
    }
  } else if (warp <= chains) {  // --------------------------- carry of chain g
    const int g = warp - 1;
    if (g >= live || lane >= J) return;
    constexpr unsigned mask = J == 32 ? kFullMask : (1u << J) - 1u;
    const int j = lane;
    T* const ybuf = reinterpret_cast<T*>(smem + L.ybuf + g * L.kYbuf);
    int parity = 0;
    T G[J];  // column (and row) j of chains
#pragma unroll
    for (int i = 0; i < J; ++i) G[i] = T(0);
    for (int t = 0; t < tiles; ++t) {
      int lo, rows;
      tile(t, lo, rows);
      const int s = t % kRingStages, b = t & 1;
      ring_wait_full(bars, t, false);
      mbar_wait(&bars->prep_full[b], (t >> 1) & 1);
      if (t >= 2) mbar_wait(&bars->out_empty[b], ((t >> 1) & 1) ^ 1);
      const T* tp = in(s, g, L.p);
      const T* tu = in(s, g, L.u);
      const T* tw = in(s, g, L.w);
      const T* tbwd = out(b, g, L.bwd);
      const T* tbdc = out(b, g, L.bdc);
      T* osnap = out(b, g, L.snap);
      T* ogv = out(b, g, L.gv);
      T* oba = out(b, g, L.ba);
      for (int q = rows - 1; q >= 0; --q) {
        T wr[CH];
        load_row(wr, tw + q * J);
        const T y = dot_row<CH>(G, wr, tw + q * J);
        // the gather of y, through one of two buffers (the other may still
        // be read by a lane finishing the previous row)
        T* yb = ybuf + parity * J;
        parity ^= 1;
        yb[j] = y;
        // the row's u, p and bW / d, CH values at a time
        T ur[CH], pr[CH], vr[CH];
        load_row(ur, tu + q * J);
        load_row(pr, tp + q * J);
        load_row(vr, tbwd + q * J);
        __syncwarp(mask);
        T ys[J];
        load_row(ys, yb);
        const T ban = tbdc[q] - T(0.5) * dot_row<CH>(ys, wr, tw + q * J);
        T uj, pj, vj;
        if constexpr (CH == J) {
          uj = pick(ur, j);
          pj = pick(pr, j);
          vj = pick(vr, j);
        } else {
          uj = tu[q * J + j];
          pj = tp[q * J + j];
          vj = tbwd[q * J + j];
        }
        const T bvj = vj + y;
        const T hj = bvj + ban * uj;
        T* sn = osnap + (q * J + j) * SN;
#pragma unroll
        for (int c = 0; c < J; c += CH) {
          if (c > 0) {
            load_row(ur, tu + q * J + c);
            load_row(pr, tp + q * J + c);
            load_row(vr, tbwd + q * J + c);
          }
          T snc[CH];
#pragma unroll
          for (int i = 0; i < CH; ++i) {
            const T hi = vr[i] + ys[c + i] + ban * ur[i];
            snc[i] = G[c + i] - ur[i] * hj - hi * uj;
            G[c + i] = (pr[i] * pj) * snc[i];
          }
          store_row(sn + c, snc);
        }
        store_pair(ogv + 2 * (q * J + j), hj + ban * uj, bvj);
        if (j == 0) oba[q] = ban;
      }
      __syncwarp(mask);
      if (j == 0) mbar_arrive(&bars->out_full[b]);
    }
  } else {  // ------------------------------------------------- epilogue
    const int e = threadIdx.x - 32 * (1 + chains);
    // bW / d (the guarded pivot) and bd - w . (bW / d) for the rows of tile t
    auto prepare = [&](int t) {
      int lo, rows;
      tile(t, lo, rows);
      const int s = t % kRingStages, b = t & 1;
      ring_wait_full(bars, t, true);
      for (int x = e; x < live * rows * J; x += ET) {
        const int g = NC == 1 ? 0 : x / (rows * J), xr = x - g * rows * J;
        const T dn = in(s, g, L.d)[xr / J];
        out(b, g, L.bwd)[xr] = in(s, g, L.bw)[xr] / (dn > T(0) ? dn : T(1));
      }
      epilogue_sync<ET>();
      for (int y = e; y < live * rows; y += ET) {
        const int g = NC == 1 ? 0 : y / rows, q = y - g * rows;
        const T* tw = in(s, g, L.w) + q * J;
        const T* vb = out(b, g, L.bwd) + q * J;
        T c = T(0);
#pragma unroll
        for (int i = 0; i < J; ++i) c += tw[i] * vb[i];
        out(b, g, L.bdc)[q] = in(s, g, L.bd)[q] - c;
      }
      epilogue_arrive(&bars->prep_full[b]);
    };
    prepare(0);
    for (int t = 0; t < tiles; ++t) {
      if (t + 1 < tiles) prepare(t + 1);
      int lo, rows;
      tile(t, lo, rows);
      const int s = t % kRingStages, b = t & 1;
      mbar_wait_idle(&bars->out_full[b], (t >> 1) & 1);
      for (int x = e; x < live * rows * J; x += ET) {
        const int g = NC == 1 ? 0 : x / (rows * J), xr = x - g * rows * J;
        const int q = xr / J, j = xr - q * J;
        const T* tp = in(s, g, L.p);
        const T* ogv = out(b, g, L.gv);
        T bu = T(0), bpj = T(0);
        if (lo + q > 0) {
          const T* shq = in(s, g, L.sh) + q * J * J;
          const T* sn = out(b, g, L.snap) + xr * SN;
#pragma unroll
          for (int k = 0; k < J; ++k) {
            bu += shq[j * J + k] * (tp[q * J + k] * ogv[2 * (q * J + k)]);
            bpj += sn[k] * shq[k * J + j];
          }
          bu = -bu;
          bpj *= tp[xr];
        }
        const size_t idx = ((size_t)(c0 + g) * N + lo) * J + xr;
        bU[idx] = bu;
        bp[idx] = bpj;
        bV[idx] = ogv[2 * xr + 1];
      }
      for (int y = e; y < live * rows; y += ET) {
        const int g = NC == 1 ? 0 : y / rows, q = y - g * rows;
        ba[(size_t)(c0 + g) * N + lo + q] = out(b, g, L.ba)[q];
      }
      epilogue_arrive(&bars->empty[s]);
      epilogue_arrive(&bars->out_empty[b]);
    }
  }
}

// ======================================================= sweep adjoint
//
// The reverse of a sweep, walking the rows in the order opposite to the
// forward's (descending for a lower sweep, ascending for an upper one,
// with no time flip), with the carried adjoint bF (J x K) of the
// transported carry (celerite2_tpu/ops/scan.py sweep_rev_scan).  Per row
// n, what the rows walked before left for it comes first, then the row's
// own step (s = -1 for a solve, +1 for a matmul; r_n = z_n for a solve,
// y_n for a matmul):
//   bB_n = bF r_n;  dbR = bF^T b_n;  bz = bZ_n (+ dbR for a solve)
//   bA_n = s diag(p_n) F_n bz;  M = bF + s a_n bz^T
//   bp_n = p_n sum_k (F_n o M);  bF = diag(p_n) M
// and bY_n = bz for a solve, dbR for a matmul.
//
// The carry is independent across the right-hand sides k: a block serves
// a slice of up to kSweepBwdSlice of them (KB slices per chain) of one
// chain, or of its chains when a chain has one slice; each chain's carry
// warp one k per lane, column k of bF in registers.  What
// bounds it on this card is the row step (H100, N = 1e5, J = 8, K = 1:
// waiting for r, bZ and F fetched one row ahead was 23% of a row, storing
// bB, bA and bp from the carry's thread at least 17%).  So the carry lane
// does only bF,
// dbR and bz: it reads the row's p, a and b 16 bytes at a time and bZ from
// the ring, and leaves bF (before the step, as one row) and the pair (bz,
// bY) in the output tile.  The epilogue computes bB, bA and bp from that
// tile and the ring's F and R, sums them over the slice's k in shared
// memory, and stores them by tiles; only with more than one slice per
// chain (K > kSweepBwdSlice) does it add into the outputs, which the
// launch zeroes first, with atomicAdd, whose order varies from run to run
// in the last bits.  Nothing of size (C, N, J, K) is allocated.
template <typename T, int J>
struct SweepBwdSmem {
  static constexpr int kRow = J + 16 / sizeof(T);  // see FactorBwdSmem
  // a chain's part of a slot: p, A, B (rows x J), F (rows x J x KS), R, bZ
  // (rows x KS)
  unsigned p, a, b, f, r, z, slot;
  // a chain's part of an output tile: bF before each row's step (rows x KS
  // x kRow), the pairs (bz, bY) (rows x KS x 2)
  unsigned bf, zy, out;
  unsigned ring, outs, bytes;
  // R rows per tile, KS right-hand sides, ``chains`` chains per block
  __host__ __device__ SweepBwdSmem(int R, int KS, int chains) {
    const unsigned row = R * J * sizeof(T);
    Carve c;
    p = c.take(row);
    a = c.take(row);
    b = c.take(row);
    f = c.take(R * J * KS * sizeof(T));
    r = c.take(R * KS * sizeof(T));
    z = c.take(R * KS * sizeof(T));
    slot = c.end();
    Carve o;
    bf = o.take(R * KS * kRow * sizeof(T));
    zy = o.take(2 * R * KS * sizeof(T));
    out = o.end();
    ring = (sizeof(RingBars) + 15u) & ~15u;
    outs = ring + kRingStages * chains * slot;
    bytes = outs + 2 * chains * out;
  }
  // per chain and row
  static size_t bytes_per_row(int KS) {
    return (kRingStages * (3 * J + J * KS + 2 * KS) +
            2 * (kRow * KS + 2 * KS)) *
           sizeof(T);
  }
};

template <typename T, int J, int NC>
__global__ void __launch_bounds__(ring_threads(NC, NC))
    sweep_bwd_kernel(const T* __restrict__ p, const T* __restrict__ A,
                     const T* __restrict__ B, const T* __restrict__ Rm,
                     const T* __restrict__ Fc, const T* __restrict__ bZ,
                     T* __restrict__ bA, T* __restrict__ bB,
                     T* __restrict__ bp, T* __restrict__ bY, int C, int N,
                     int K, int KB, int is_solve, int upper, int R,
                     int chains_) {
  constexpr int SR = SweepBwdSmem<T, J>::kRow;
  extern __shared__ __align__(16) unsigned char smem[];
  const int KS = min(K, kSweepBwdSlice);
  const int chains = NC == 1 ? 1 : chains_;  // of this launch's blocks
  const int c0 = (blockIdx.x / KB) * chains;
  const int live = min(chains, C - c0);  // this block's chains
  const SweepBwdSmem<T, J> L(R, KS, chains);
  RingBars* bars = reinterpret_cast<RingBars*>(smem);
  // chain g's piece of ring slot s, of output tile o
  auto in = [&](int s, int g, unsigned piece) {
    return reinterpret_cast<T*>(smem + L.ring + (s * chains + g) * L.slot +
                                piece);
  };
  auto out = [&](int o, int g, unsigned piece) {
    return reinterpret_cast<T*>(smem + L.outs + (o * chains + g) * L.out +
                                piece);
  };
  const int k0 = (blockIdx.x % KB) * KS;
  const int nk = min(KS, K - k0);  // live right-hand sides of this block
  // one slice per chain: F, R and bZ of a tile are contiguous
  const bool whole = KB == 1;
  const int tiles = (N + R - 1) / R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const T sgn = is_solve ? T(-1) : T(1);
  constexpr int ET = 32 * epilogue_warps(NC);  // the epilogue's threads
  ring_init(bars, live, ET / 32);
  // tile t holds rows [lo, lo + rows), walked downwards (lower) or upwards
  auto tile = [&](int t, int& lo, int& rows) {
    rows = min(R, N - t * R);
    lo = upper ? t * R : N - t * R - rows;
  };

  if (warp == 0) {  // ----------------------------------------- producer
    for (int t = 0; t < tiles; ++t) {
      int lo, rows;
      tile(t, lo, rows);
      const int s = t % kRingStages;
      ring_wait_empty(bars, t);
      if (!whole) {
        // a slice of k of the block's one chain: strided rows, one
        // cp.async per element
        const size_t first = (size_t)c0 * N + lo;
        T* sf = in(s, 0, L.f);
        T* sr = in(s, 0, L.r);
        T* sz = in(s, 0, L.z);
        for (int x = lane; x < rows * J * nk; x += 32) {
          const int q = x / (J * nk), rem = x - q * J * nk;
          const int j = rem / nk, kk = rem - j * nk;
          cp_async_elem(sf + (q * J + j) * KS + kk,
                        Fc + ((first + q) * J + j) * K + k0 + kk);
        }
        for (int x = lane; x < rows * nk; x += 32) {
          const int q = x / nk, kk = x - q * nk;
          cp_async_elem(sr + q * KS + kk, Rm + (first + q) * K + k0 + kk);
          cp_async_elem(sz + q * KS + kk, bZ + (first + q) * K + k0 + kk);
        }
      }
      fill_slot<T>(
          [&](auto&& piece) {
            for (int g = 0; g < live; ++g) {
              const size_t first = (size_t)(c0 + g) * N + lo;
              piece(in(s, g, L.p), p + first * J, rows * J);
              piece(in(s, g, L.a), A + first * J, rows * J);
              piece(in(s, g, L.b), B + first * J, rows * J);
              if (whole) {
                piece(in(s, g, L.f), Fc + first * J * K, rows * J * K);
                piece(in(s, g, L.r), Rm + first * K, rows * K);
                piece(in(s, g, L.z), bZ + first * K, rows * K);
              }
            }
          },
          &bars->full[s], lane);
    }
  } else if (warp <= chains) {  // ---------------------- carry of chain g
    const int g = warp - 1;
    if (g >= live || lane >= nk) return;
    const unsigned mask = nk == 32 ? kFullMask : (1u << nk) - 1u;
    const int kk = lane;
    T bF[J];  // column k of bF
#pragma unroll
    for (int j = 0; j < J; ++j) bF[j] = T(0);
    for (int t = 0; t < tiles; ++t) {
      int lo, rows;
      tile(t, lo, rows);
      const int s = t % kRingStages, o = t & 1;
      ring_wait_full(bars, t, false);
      if (t >= 2) mbar_wait(&bars->out_empty[o], ((t >> 1) & 1) ^ 1);
      const T* tp = in(s, g, L.p);
      const T* ta = in(s, g, L.a);
      const T* tb = in(s, g, L.b);
      const T* tz = in(s, g, L.z);
      T* obf = out(o, g, L.bf);
      T* ozy = out(o, g, L.zy);
      for (int i = 0; i < rows; ++i) {
        const int q = upper ? i : rows - 1 - i;
        T br[J], ar[J], pr[J];
        load_row(br, tb + q * J);
        const T dbR = dot2(bF, br);
        const T bzi = tz[q * KS + kk];
        load_row(ar, ta + q * J);
        load_row(pr, tp + q * J);
        const T bz = is_solve ? bzi + dbR : bzi;
        store_row(obf + (q * KS + kk) * SR, bF);
        store_pair(ozy + 2 * (q * KS + kk), bz, is_solve ? bz : dbR);
#pragma unroll
        for (int j = 0; j < J; ++j) bF[j] = pr[j] * (bF[j] + sgn * ar[j] * bz);
      }
      __syncwarp(mask);
      if (kk == 0) mbar_arrive(&bars->out_full[o]);
    }
  } else {  // ------------------------------------------------- epilogue
    const int e = threadIdx.x - 32 * (1 + chains);
    for (int t = 0; t < tiles; ++t) {
      int lo, rows;
      tile(t, lo, rows);
      const int s = t % kRingStages, o = t & 1;
      ring_wait_full(bars, t, true);
      mbar_wait_idle(&bars->out_full[o], (t >> 1) & 1);
      for (int x = e; x < live * rows * J; x += ET) {
        const int g = NC == 1 ? 0 : x / (rows * J), xr = x - g * rows * J;
        const int q = xr / J, j = xr - q * J;
        const T* fq = in(s, g, L.f) + xr * KS;
        const T* rq = in(s, g, L.r) + q * KS;
        const T* obf = out(o, g, L.bf);
        const T* ozy = out(o, g, L.zy);
        const T sa = sgn * in(s, g, L.a)[xr];
        T vb = T(0), va = T(0), vp = T(0);
        for (int kk = 0; kk < nk; ++kk) {
          const T bfk = obf[(q * KS + kk) * SR + j];
          const T bzk = ozy[2 * (q * KS + kk)];
          vb += bfk * rq[kk];
          va += fq[kk] * bzk;
          vp += fq[kk] * (bfk + sa * bzk);
        }
        const T pj = in(s, g, L.p)[xr];
        va *= sgn * pj;
        vp *= pj;
        const size_t idx = ((size_t)(c0 + g) * N + lo) * J + xr;
        if (whole) {
          bB[idx] = vb;
          bA[idx] = va;
          bp[idx] = vp;
        } else {
          atomicAdd(bB + idx, vb);
          atomicAdd(bA + idx, va);
          atomicAdd(bp + idx, vp);
        }
      }
      for (int x = e; x < live * rows * nk; x += ET) {
        const int g = NC == 1 ? 0 : x / (rows * nk), xr = x - g * rows * nk;
        const int q = xr / nk, kk = xr - q * nk;
        bY[((size_t)(c0 + g) * N + lo + q) * K + k0 + kk] =
            out(o, g, L.zy)[2 * (q * KS + kk) + 1];
      }
      epilogue_arrive(&bars->empty[s]);
      epilogue_arrive(&bars->out_empty[o]);
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
using FactorBwdKernel = decltype(&factor_bwd_kernel<T, J, 1>);

// the factor adjoint's ring for C chains
template <typename T, int J>
int factor_bwd_plan(long long C, RingPlan<FactorBwdKernel<T, J>>* plan) {
  static size_t allowed[2] = {0, 0};  // of the two instantiations
  return ring_plan(
      C, kMaxRingChains,
      [](int chains) {
        const int NC = chains == 1 ? 1 : kMaxRingChains;
        RingPlan<FactorBwdKernel<T, J>> x;
        x.kernel = NC == 1 ? factor_bwd_kernel<T, J, 1>
                           : factor_bwd_kernel<T, J, kMaxRingChains>;
        x.rows = tile_rows(chains * FactorBwdSmem<T, J>::bytes_per_row());
        x.chains = chains;
        x.threads = ring_threads(NC, chains);
        x.bytes = FactorBwdSmem<T, J>(x.rows, chains).bytes;
        x.allowed = &allowed[NC != 1];
        return x;
      },
      plan);
}

template <typename T, int J>
int launch_factor_bwd_j(const void* p, const void* d, const void* U,
                        const void* W, const void* Sh, const void* bd,
                        const void* bW, void* ba, void* bU, void* bV, void* bp,
                        int C, int N, cudaStream_t s) {
  RingPlan<FactorBwdKernel<T, J>> plan;
  const int rc = factor_bwd_plan<T, J>(C, &plan);
  if (rc != 0) return rc;
  const unsigned grid = (unsigned)((C + plan.chains - 1) / plan.chains);
  plan.kernel<<<grid, plan.threads, plan.bytes, s>>>(
      (const T*)p, (const T*)d, (const T*)U, (const T*)W, (const T*)Sh,
      (const T*)bd, (const T*)bW, (T*)ba, (T*)bU, (T*)bV, (T*)bp, C, N,
      plan.rows, plan.chains);
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
using SweepBwdKernel = decltype(&sweep_bwd_kernel<T, J, 1>);

// the sweep adjoint's ring for C chains of K right-hand sides
template <typename T, int J>
int sweep_bwd_plan(long long C, int K, RingPlan<SweepBwdKernel<T, J>>* plan) {
  static size_t allowed[2] = {0, 0};  // of the two instantiations
  const int KS = std::min(K, kSweepBwdSlice);
  const long long KB = (K + kSweepBwdSlice - 1) / kSweepBwdSlice;
  return ring_plan(
      C * KB, KB == 1 ? kMaxRingChains : 1,
      [KS](int chains) {
        const int NC = chains == 1 ? 1 : kMaxRingChains;
        RingPlan<SweepBwdKernel<T, J>> x;
        x.kernel = NC == 1 ? sweep_bwd_kernel<T, J, 1>
                           : sweep_bwd_kernel<T, J, kMaxRingChains>;
        x.rows = tile_rows(chains * SweepBwdSmem<T, J>::bytes_per_row(KS));
        x.chains = chains;
        x.threads = ring_threads(NC, chains);
        x.bytes = SweepBwdSmem<T, J>(x.rows, KS, chains).bytes;
        x.allowed = &allowed[NC != 1];
        return x;
      },
      plan);
}

template <typename T, int J>
int launch_sweep_bwd_j(const void* p, const void* A, const void* B,
                       const void* R, const void* Fc, const void* bZ, void* bA,
                       void* bB, void* bp, void* bY, int C, int N, int K,
                       int is_solve, int upper, cudaStream_t s) {
  const int KB = (K + kSweepBwdSlice - 1) / kSweepBwdSlice;
  RingPlan<SweepBwdKernel<T, J>> plan;
  int rc = sweep_bwd_plan<T, J>(C, K, &plan);
  // with more than one slice per chain the blocks add into the sums
  for (void* sum : {bA, bB, bp})
    if (rc == 0 && KB > 1)
      rc = (int)cudaMemsetAsync(sum, 0, (size_t)C * N * J * sizeof(T), s);
  if (rc != 0) return rc;
  const long long blocks = (C + plan.chains - 1) / plan.chains * (long long)KB;
  plan.kernel<<<(unsigned)blocks, plan.threads, plan.bytes, s>>>(
      (const T*)p, (const T*)A, (const T*)B, (const T*)R, (const T*)Fc,
      (const T*)bZ, (T*)bA, (T*)bB, (T*)bp, (T*)bY, C, N, K, KB, is_solve,
      upper, plan.rows, plan.chains);
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

// the adjoints' rings for C chains (rows per tile, chains per block and
// shared memory; rows 0 for a width that is not built, below 0 for an error)
template <typename T, int J>
int adjoint_ring_j(int K, int C, int is_sweep, int* chains, long long* bytes) {
  RingPlan<SweepBwdKernel<T, J>> sweep;
  RingPlan<FactorBwdKernel<T, J>> factor;
  const int rc = is_sweep ? sweep_bwd_plan<T, J>(C, K, &sweep)
                          : factor_bwd_plan<T, J>(C, &factor);
  if (rc != 0) return rc > 0 ? -rc : rc;
  const int rows = is_sweep ? sweep.rows : factor.rows;
  if (chains != nullptr) *chains = is_sweep ? sweep.chains : factor.chains;
  if (bytes != nullptr)
    *bytes = (long long)(is_sweep ? sweep.bytes : factor.bytes);
  return rows;
}

template <typename T>
int adjoint_ring(int J, int K, int C, int is_sweep, int* chains,
                 long long* bytes) {
  switch (J) {
    case 1: return adjoint_ring_j<T, 1>(K, C, is_sweep, chains, bytes);
    case 2: return adjoint_ring_j<T, 2>(K, C, is_sweep, chains, bytes);
    case 4: return adjoint_ring_j<T, 4>(K, C, is_sweep, chains, bytes);
    case 8: return adjoint_ring_j<T, 8>(K, C, is_sweep, chains, bytes);
    case 16: return adjoint_ring_j<T, 16>(K, C, is_sweep, chains, bytes);
    case 32: return adjoint_ring_j<T, 32>(K, C, is_sweep, chains, bytes);
    default: return 0;
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
// the launch (0 on success); the factor, the sweep and their adjoints return
// -1 for a width that is not one of 1, 2, 4, 8, 16, 32.  Pointers are to
// contiguous device arrays of the scalar type given by ``is_double``.  The
// forward's cache pointers ``Sh`` and ``Fc`` may be null: the cache is then
// not written.  The adjoints read the caches.  C, N, K >= 1.
// c2t_adjoint_ring gives the rows per tile of the factor adjoint's
// (``is_sweep`` 0) or the sweep adjoint's ring for C chains of width J and
// K right-hand sides, with its chains per block in ``chains`` and its
// launch's dynamic shared memory in ``bytes`` (either may be null); 0 for a
// width that is not built, below 0 for a CUDA error.
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

int c2t_adjoint_ring(int is_double, int J, int K, int C, int is_sweep,
                     int* chains, long long* bytes) {
  return is_double ? adjoint_ring<double>(J, K, C, is_sweep, chains, bytes)
                   : adjoint_ring<float>(J, K, C, is_sweep, chains, bytes);
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
