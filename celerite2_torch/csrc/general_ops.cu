// The general semiseparable recursions at any celerite width J <= 32,
// written for Hopper (sm_90a): the LDL^T factor, the four sweeps (lower and
// upper solve, lower and upper matmul) and their adjoints.  Built with nvcc
// into the shared library of celerite2_torch/ops/_build.py and bound with
// ctypes.
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
// so one kernel here is the counterpart of both.  (The diagonal-affine
// prefix of the rectangular products is in assoc_prefix.cu.)
//
// The recursions are sequential in the rows n and independent across the C
// chains (and, for the sweeps, across the K right-hand sides).  What bounds
// them on this card is the latency of the dependent chain of one row step
// (a few dependent multiply-adds, a reciprocal or a shuffle reduction), N
// times over: at one chain the card moves a small fraction of what its
// memory could.  So the four row kernels share one design (see "the tile
// ring" below), which keeps everything that does not depend on the carry
// off that chain: a producer warp keeps tiles of rows in flight into shared
// memory by asynchronous bulk copies, a carry warp per chain does only the
// carry, in registers for all N rows, and epilogue warps turn what the
// carry leaves in shared memory into the per-row outputs and caches and
// store them by tiles; a block serves one chain, or up to four when C is
// large.  The factor also takes the part of its row step that does not
// depend on the previous row's w one row ahead, and the matmul sweeps
// leave their output to the epilogue.  Nothing is padded to a block of
// rows and nothing is pre-shifted.
//
// Layouts are natural row-major with a leading chain axis: p, U, V, W, A, B
// (C, N, J); a, d (C, N); Y, Z, R (C, N, K); the caches S_half (C, N, J, J)
// and F (C, N, J, K).  p is the transport exp(-c dt) of each row (0 at the
// row where nothing enters: row 0, or row N-1 for an upper sweep).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "device_common.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// ======================================================== the tile ring
//
// The four row kernels (the factor, the sweeps and their adjoints) walk N
// rows with a carry that depends on every row before; their inputs and
// outputs, the caches S_half (C, N, J, J) and F (C, N, J, K) above all, are
// far larger than the carry.  Their blocks split the work by warp, so that
// the carry's dependent chain waits on nothing else:
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
// right-hand sides per block of a sweep and of its adjoint (one carry warp)
constexpr int kSweepSlice = 32;

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

// the reciprocal of a pivot: the hardware's approximation and Newton steps
// to the last bit or so (two for float64, one for float32), a few dependent
// multiply-adds where a division is a longer sequence with a branch
__device__ __forceinline__ double recip(double x) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
  double e = fma(-x, r, 1.0);
  r = fma(r, e, r);
  e = fma(-x, r, 1.0);
  return fma(r, e, r);
}
__device__ __forceinline__ float recip(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return fmaf(r, fmaf(-x, r, 1.0f), r);
}

// the sum over the J lanes of a chain (every lane gets the same bits)
template <int J, typename T>
__device__ __forceinline__ T lane_sum(T x, unsigned mask) {
#pragma unroll
  for (int off = J / 2; off > 0; off /= 2)
    x += __shfl_xor_sync(mask, x, off, J);
  return x;
}

// ============================================================= factor
//
// S <- p (S + d w w^T) p,  d_n = a_n - u^T S u,  w_n = (v - S u) / d_n,
// with the pivot guarded (w divides by 1 where d <= 0; d is stored as
// computed).  Written with x = p_n o u_n and C the carry after row n - 1's
// update (zero before row 0), row n is
//   c = w_{n-1} . x;  e = d_{n-1} c
//   d_n = a_n - x^T C x - e c;  S u = p_n o (C x + e w_{n-1})
//   C <- diag(p_n) (C + d_{n-1} w_{n-1} w_{n-1}^T) diag(p_n),
// where S_half_n (the cache the adjoint reads) is the carry after the
// rank-one update and the first transport.  C x and x^T C x do not depend
// on w_{n-1}, so the carry works them out one row ahead: what is left on
// the dependent chain of a row is the two sums over the chain's lanes,
// w_{n-1} . x and x^T C x, side by side (log2 J shuffles each), two
// multiply-adds, the pivot's reciprocal and a multiply, while the update
// of C, S_half and the next row's C x run beside it.
//
// What bounds it on this card is that row step, N times over: one warp
// issuing, in order, the chain's shuffles, reciprocal and multiply-adds
// beside the update's float64 instructions (H100, N = 1e5, J = 8: 0.18 us
// a row, 0.19 with the cache; the parent of this design, which walked the
// update and S u on the chain, read p, u, v and the previous w one value a
// load and fetched a row ahead from device memory, took 0.42 and 0.56;
// variants that summed w_n . x_{n+1} beside the reciprocal, or spread a
// column over several lanes, were slower at one chain; PERF.md,
// Findings).  The block is the ring above: the producer streams p, U, V and a in tiles of rows; each
// chain's carry warp has J lanes, lane j keeping column j of the symmetric
// C in registers, reading the rows 16 bytes at a time and gathering w
// through shared memory (one store and one read of the row, off the
// chain); it leaves w, d and, with the cache, lane j's column of S_half in
// the output tile, and the epilogue stores them by tiles.  The carry's
// arithmetic does not depend on whether the cache is stored.
template <typename T, int J>
struct FactorFwdSmem {
  // row stride of the S_half tile (lane j's column of a row): J values and
  // 16 bytes, so that each lane's row is 16-byte aligned and the lanes'
  // rows fall in other banks
  static constexpr int kSnap = J + 16 / sizeof(T);
  // a chain's part of a slot: p, U, V (rows x J), a (rows)
  unsigned p, u, v, a, slot;
  // a chain's part of an output tile: W (rows x J), d (rows), and with the
  // cache S_half (rows x J x kSnap)
  unsigned w, d, sh, out;
  unsigned ring, wbuf, outs, bytes;
  // per chain, w of two rows
  static constexpr unsigned kWbuf = (2 * J * sizeof(T) + 15u) & ~15u;
  // R rows per tile, ``chains`` chains per block
  __host__ __device__ FactorFwdSmem(int R, int chains, bool cache) {
    const unsigned row = R * J * sizeof(T);
    Carve c;
    p = c.take(row);
    u = c.take(row);
    v = c.take(row);
    a = c.take(R * sizeof(T));
    slot = c.end();
    Carve o;
    w = o.take(row);
    d = o.take(R * sizeof(T));
    sh = o.take(cache ? R * J * kSnap * sizeof(T) : 0);
    out = o.end();
    ring = (sizeof(RingBars) + 15u) & ~15u;
    wbuf = ring + kRingStages * chains * slot;
    outs = wbuf + chains * kWbuf;
    bytes = outs + 2 * chains * out;
  }
  // per chain and row
  static size_t bytes_per_row(bool cache) {
    return (kRingStages * (3 * J + 1) + 2 * (J + 1 + (cache ? J * kSnap : 0))) *
           sizeof(T);
  }
};

// (one block a multiprocessor at least: without it ptxas held the float64
// J = 32 instantiation of four chains to 128 registers, and spilled)
template <typename T, int J, int NC>
__global__ void __launch_bounds__(ring_threads(NC, NC), 1)
    factor_fwd_kernel(const T* __restrict__ p, const T* __restrict__ a,
                      const T* __restrict__ U, const T* __restrict__ V,
                      T* __restrict__ d, T* __restrict__ W, T* __restrict__ Sh,
                      int C, int N, int R, int chains_) {
  constexpr int SN = FactorFwdSmem<T, J>::kSnap;
  // values of a row the carry lane holds at once: the whole row, or 16
  // bytes where four rows would not fit its registers (float64 at J = 32)
  constexpr int CH = J * sizeof(T) > 128 ? 16 / sizeof(T) : J;
  extern __shared__ __align__(16) unsigned char smem[];
  const int chains = NC == 1 ? 1 : chains_;  // of this launch's blocks
  const int c0 = blockIdx.x * chains;
  const int live = min(chains, C - c0);  // this block's chains
  const bool cache = Sh != nullptr;
  const FactorFwdSmem<T, J> L(R, chains, cache);
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

  if (warp == 0) {  // ----------------------------------------- producer
    for (int t = 0; t < tiles; ++t) {
      const int lo = t * R, rows = min(R, N - lo);
      const int s = t % kRingStages;
      ring_wait_empty(bars, t);
      fill_slot<T>(
          [&](auto&& piece) {
            for (int g = 0; g < live; ++g) {
              const size_t first = (size_t)(c0 + g) * N + lo;
              piece(in(s, g, L.p), p + first * J, rows * J);
              piece(in(s, g, L.u), U + first * J, rows * J);
              piece(in(s, g, L.v), V + first * J, rows * J);
              piece(in(s, g, L.a), a + first, rows);
            }
          },
          &bars->full[s], lane);
    }
  } else if (warp <= chains) {  // --------------------------- carry of chain g
    const int g = warp - 1;
    if (g >= live || lane >= J) return;
    constexpr unsigned mask = J == 32 ? kFullMask : (1u << J) - 1u;
    const int j = lane;
    T* const wbuf = reinterpret_cast<T*>(smem + L.wbuf + g * L.kWbuf);
    wbuf[j] = T(0);  // w before row 0
    // the walk, with the stores of S_half or without (the same arithmetic)
    auto walk = [&](auto with_cache) {
      constexpr bool kCache = decltype(with_cache)::value;
      int parity = 0;
      T Cj[J];  // column (and row) j of the carry C
#pragma unroll
      for (int i = 0; i < J; ++i) Cj[i] = T(0);
      // this lane's w_{n-1, j}, d_{n-1}, x_{n, j}, (C x_n)_j and x_{n, j}
      // (C x_n)_j, whose sum over the lanes is x_n^T C x_n
      T w_prev = T(0), d_prev = T(0), xj = T(0), cx = T(0), xcxj = T(0);
      for (int t = 0; t < tiles; ++t) {
        const int lo = t * R, rows = min(R, N - lo);
        const int s = t % kRingStages, o = t & 1;
        ring_wait_full(bars, t, false);
        // the last row of a tile works ahead on the first of the next
        if (t + 1 < tiles) ring_wait_full(bars, t + 1, false);
        if (t >= 2) mbar_wait(&bars->out_empty[o], ((t >> 1) & 1) ^ 1);
        const T* tp = in(s, g, L.p);
        const T* tu = in(s, g, L.u);
        const T* tv = in(s, g, L.v);
        const T* ta = in(s, g, L.a);
        // the next tile's first p and u row (past the last tile, this
        // tile's last again: what the last row works out from them is not
        // used)
        const int s1 = (t + 1) % kRingStages;
        const T* np = t + 1 < tiles ? in(s1, g, L.p) : tp + (rows - 1) * J;
        const T* nu = t + 1 < tiles ? in(s1, g, L.u) : tu + (rows - 1) * J;
        T* ow = out(o, g, L.w);
        T* od = out(o, g, L.d);
        T* osh = out(o, g, L.sh);
        if (t == 0) xj = tp[j] * tu[j];
        __syncwarp(mask);  // wbuf's first row is written
        for (int q = 0; q < rows; ++q) {
          const bool last = q + 1 == rows;
          const T* p1 = last ? np : tp + (q + 1) * J;
          const T* u1 = last ? nu : tu + (q + 1) * J;
          const T* pr = tp + q * J;
          const T pj = pr[j];
          // the chain: w_n from w_{n-1}, its two sums over the lanes side
          // by side
          const T c = lane_sum<J>(w_prev * xj, mask);
          const T xcx = lane_sum<J>(xcxj, mask);
          const T e = d_prev * c;
          const T dn = (ta[q] - xcx) - e * c;
          const T su = pj * (cx + e * w_prev);
          const T wn = (tv[q * J + j] - su) * recip(dn > T(0) ? dn : T(1));
          // beside it: C's update with w_{n-1} (gathered) and p_n, S_half,
          // and C x_{n+1}
          const T* wr = wbuf + parity * J;
          const T dwj = d_prev * w_prev;
          T acc0 = T(0), acc1 = T(0);
#pragma unroll
          for (int cb = 0; cb < J; cb += CH) {
            T wc[CH], pc[CH], p1c[CH], u1c[CH], half[CH];
            load_row(wc, wr + cb);
            load_row(pc, pr + cb);
            load_row(p1c, p1 + cb);
            load_row(u1c, u1 + cb);
#pragma unroll
            for (int i = 0; i < CH; ++i) {
              // S_half[n][i][j] = p_i (C[i][j] + d w_i w_j)
              half[i] = pc[i] * (Cj[cb + i] + dwj * wc[i]);
              Cj[cb + i] = half[i] * pj;
              (i & 1 ? acc1 : acc0) += Cj[cb + i] * (p1c[i] * u1c[i]);
            }
            if constexpr (kCache) store_row(osh + (q * J + j) * SN + cb, half);
          }
          cx = acc0 + acc1;
          xj = p1[j] * u1[j];
          xcxj = xj * cx;
          // w_n for the next row's update, and the row's outputs
          wbuf[(parity ^ 1) * J + j] = wn;
          ow[q * J + j] = wn;
          if (j == 0) od[q] = dn;
          __syncwarp(mask);
          parity ^= 1;
          w_prev = wn;
          d_prev = dn;
        }
        if (j == 0) mbar_arrive(&bars->out_full[o]);
      }
    };
    if (cache)
      walk(std::true_type{});
    else
      walk(std::false_type{});
  } else {  // ------------------------------------------------- epilogue
    const int e = threadIdx.x - 32 * (1 + chains);
    for (int t = 0; t < tiles; ++t) {
      const int lo = t * R, rows = min(R, N - lo);
      const int s = t % kRingStages, o = t & 1;
      mbar_wait_idle(&bars->out_full[o], (t >> 1) & 1);
      for (int g = 0; g < live; ++g) {
        const size_t first = (size_t)(c0 + g) * N + lo;
        const T* ow = out(o, g, L.w);
        const T* od = out(o, g, L.d);
        for (int x = e; x < rows * J; x += ET) W[first * J + x] = ow[x];
        for (int q = e; q < rows; q += ET) d[first + q] = od[q];
        if (cache) {
          // two neighbours in a row of S_half a thread (one 16- or 8-byte
          // store), from lanes j and j + 1's columns in the tile
          constexpr int JJ = J * J, P = J > 1 ? 2 : 1;
          const T* osh = out(o, g, L.sh);
          for (int x = P * e; x < rows * JJ; x += P * ET) {
            const int q = x / JJ, i = x % JJ / J, j = x % J;
            const T* col = osh + (q * J + j) * SN + i;
            if constexpr (P == 2)
              store_pair(Sh + first * JJ + x, col[0], col[SN]);
            else
              Sh[first * JJ + x] = col[0];
          }
        }
      }
      epilogue_arrive(&bars->empty[s]);
      epilogue_arrive(&bars->out_empty[o]);
    }
  }
}

// ============================================================== sweeps
//
// Per row, in the order the rows are walked (ascending for a lower sweep,
// descending for an upper one, with no time flip):
//   F_cache[n] = F;  F <- p_n F;  proj = a_n^T F;
//   z_n = y_n - proj (solve) or proj (matmul);  r = z_n (solve) or y_n;
//   F <- F + b_n r^T,
// which is F_n = p_n (F_prev + b_prev r_prev^T) with the feed of row n added
// as soon as r is known.  In a matmul r = y, so the carry does not need z:
// it is F <- p_n o F + b_n y_n alone, and z_n = a_n . (p_n o F_cache[n])
// is worked out from the cached F by the epilogue.
//
// The carry is independent across the right-hand sides k.  What bounds it
// on this card is the row step of one right-hand side, N times over (H100,
// N = 1e5, J = 8, K = 1: 59 ns a row in a solve, 75 with the cache, 47 to
// 52 in a matmul; the parent of this design, which staged a tile of p, A,
// B between two block barriers, fetched y a row ahead from device memory,
// stored Z and F from the carry's thread and computed z in the matmuls
// too, took 136 to 142, 194 to 200 with the cache; PERF.md, Findings).  So the block is the ring above,
// as for the sweep adjoint: a block serves a slice of up to kSweepSlice
// right-hand sides (KB slices per chain) of one chain, or of its chains
// when a chain has one slice; the producer streams p, A, B and the slice's
// Y in tiles of rows; each chain's carry warp holds one k per lane, column
// k of F in registers, reads a row's p, a, b 16 bytes at a time, and
// leaves F before the row (with the cache, or in a matmul) and, in a
// solve, z in the output tile; the epilogue stores Z and F by tiles.
template <typename T, int J>
struct SweepFwdSmem {
  static constexpr int kRow = J + 16 / sizeof(T);  // see FactorFwdSmem
  // a chain's part of a slot: p, A, B (rows x J), Y (rows x KS)
  unsigned p, a, b, y, slot;
  // a chain's part of an output tile: F before each row (rows x KS x kRow;
  // with the cache, or in a matmul), z (rows x KS)
  unsigned f, z, out;
  unsigned ring, outs, bytes;
  // R rows per tile, KS right-hand sides, ``chains`` chains per block;
  // ``with_f``: F goes through the output tile
  __host__ __device__ SweepFwdSmem(int R, int KS, int chains, bool with_f) {
    const unsigned row = R * J * sizeof(T);
    Carve c;
    p = c.take(row);
    a = c.take(row);
    b = c.take(row);
    y = c.take(R * KS * sizeof(T));
    slot = c.end();
    Carve o;
    f = o.take(with_f ? R * KS * kRow * sizeof(T) : 0);
    z = o.take(R * KS * sizeof(T));
    out = o.end();
    ring = (sizeof(RingBars) + 15u) & ~15u;
    outs = ring + kRingStages * chains * slot;
    bytes = outs + 2 * chains * out;
  }
  // per chain and row
  static size_t bytes_per_row(int KS, bool with_f) {
    return (kRingStages * (3 * J + KS) + 2 * ((with_f ? kRow * KS : 0) + KS)) *
           sizeof(T);
  }
};

template <typename T, int J, int NC>
__global__ void __launch_bounds__(ring_threads(NC, NC))
    sweep_fwd_kernel(const T* __restrict__ p, const T* __restrict__ A,
                     const T* __restrict__ B, const T* __restrict__ Y,
                     T* __restrict__ Z, T* __restrict__ Fc, int C, int N,
                     int K, int KB, int is_solve, int upper, int R,
                     int chains_) {
  constexpr int SR = SweepFwdSmem<T, J>::kRow;
  extern __shared__ __align__(16) unsigned char smem[];
  const int KS = min(K, kSweepSlice);
  const int chains = NC == 1 ? 1 : chains_;  // of this launch's blocks
  const int c0 = (blockIdx.x / KB) * chains;
  const int live = min(chains, C - c0);  // this block's chains
  const bool cache = Fc != nullptr;
  const SweepFwdSmem<T, J> L(R, KS, chains, cache || !is_solve);
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
  // one slice per chain: a tile's Y, Z and F are contiguous
  const bool whole = KB == 1;
  const int tiles = (N + R - 1) / R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  constexpr int ET = 32 * epilogue_warps(NC);  // the epilogue's threads
  ring_init(bars, live, ET / 32);
  // tile t holds rows [lo, lo + rows), walked upwards (lower) or downwards
  auto tile = [&](int t, int& lo, int& rows) {
    rows = min(R, N - t * R);
    lo = upper ? N - t * R - rows : t * R;
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
        T* sy = in(s, 0, L.y);
        for (int x = lane; x < rows * nk; x += 32) {
          const int q = x / nk, kk = x - q * nk;
          cp_async_elem(sy + q * KS + kk, Y + (first + q) * K + k0 + kk);
        }
      }
      fill_slot<T>(
          [&](auto&& piece) {
            for (int g = 0; g < live; ++g) {
              const size_t first = (size_t)(c0 + g) * N + lo;
              piece(in(s, g, L.p), p + first * J, rows * J);
              piece(in(s, g, L.a), A + first * J, rows * J);
              piece(in(s, g, L.b), B + first * J, rows * J);
              if (whole) piece(in(s, g, L.y), Y + first * K, rows * K);
            }
          },
          &bars->full[s], lane);
    }
  } else if (warp <= chains) {  // ---------------------- carry of chain g
    const int g = warp - 1;
    if (g >= live || lane >= nk) return;
    const unsigned mask = nk == 32 ? kFullMask : (1u << nk) - 1u;
    const int kk = lane;
    T F[J];  // column k of F
#pragma unroll
    for (int j = 0; j < J; ++j) F[j] = T(0);
    // the walk in a solve or a matmul, storing F before each row or not
    // (the same arithmetic)
    auto walk = [&](auto solve, auto store_f) {
      constexpr bool kSolve = decltype(solve)::value;
      constexpr bool kStoreF = decltype(store_f)::value;
      // a solve reads the next row's p, b, a and y into registers before
      // this row's stores to the output tile, which the compiler would not
      // move them past, so that their latency stays off its chain (float64
      // up to J = 8, float32 up to 16; wider rows would not fit the
      // registers twice).  A matmul's chain, two operations a row, gains
      // nothing from it (H100: 56 ns a row with it, 43 without).
      constexpr bool kAhead = kSolve && 3 * J * sizeof(T) <= 192;
      const int step = upper ? -1 : 1;
      for (int t = 0; t < tiles; ++t) {
        int lo, rows;
        tile(t, lo, rows);
        const int s = t % kRingStages, o = t & 1;
        ring_wait_full(bars, t, false);
        if (t >= 2) mbar_wait(&bars->out_empty[o], ((t >> 1) & 1) ^ 1);
        const T* tp = in(s, g, L.p);
        const T* ta = in(s, g, L.a);
        const T* tb = in(s, g, L.b);
        const T* ty = in(s, g, L.y);
        T* of = out(o, g, L.f);
        T* oz = out(o, g, L.z);
        auto fetch = [&](int q, T(&p_)[J], T(&b_)[J], T(&a_)[J], T& y_) {
          load_row(p_, tp + q * J);
          load_row(b_, tb + q * J);
          if constexpr (kSolve) load_row(a_, ta + q * J);
          y_ = ty[q * KS + kk];
        };
        // row q: F before it, and the carry's step
        auto row = [&](int q, const T(&pr)[J], const T(&br)[J],
                       const T(&ar)[J], T y) {
          if constexpr (kStoreF) store_row(of + (q * KS + kk) * SR, F);
          if constexpr (kSolve) {
#pragma unroll
            for (int j = 0; j < J; ++j) F[j] *= pr[j];
            const T z = y - dot2(ar, F);
#pragma unroll
            for (int j = 0; j < J; ++j) F[j] += br[j] * z;
            oz[q * KS + kk] = z;
          } else {
#pragma unroll
            for (int j = 0; j < J; ++j) {
              F[j] *= pr[j];
              F[j] += br[j] * y;
            }
          }
        };
        if constexpr (kAhead) {
          // two sets of registers in turns: a row's step runs on one while
          // the next row's inputs are read into the other (past the last
          // row, a row of the tile again)
          T p0[J], b0[J], a0[J], y0, p1[J], b1[J], a1[J], y1;
          int q = upper ? rows - 1 : 0, i = 0;
          fetch(q, p0, b0, a0, y0);
          for (; i + 1 < rows; i += 2, q += 2 * step) {
            fetch(q + step, p1, b1, a1, y1);
            row(q, p0, b0, a0, y0);
            fetch(i + 2 < rows ? q + 2 * step : q, p0, b0, a0, y0);
            row(q + step, p1, b1, a1, y1);
          }
          if (i < rows) row(q, p0, b0, a0, y0);
        } else {
          for (int i = 0; i < rows; ++i) {
            const int q = upper ? rows - 1 - i : i;
            T pr[J], br[J], ar[J], y;
            fetch(q, pr, br, ar, y);
            row(q, pr, br, ar, y);
          }
        }
        __syncwarp(mask);
        if (kk == 0) mbar_arrive(&bars->out_full[o]);
      }
    };
    if (!is_solve)
      walk(std::false_type{}, std::true_type{});
    else if (cache)
      walk(std::true_type{}, std::true_type{});
    else
      walk(std::true_type{}, std::false_type{});
  } else {  // ------------------------------------------------- epilogue
    const int e = threadIdx.x - 32 * (1 + chains);
    for (int t = 0; t < tiles; ++t) {
      int lo, rows;
      tile(t, lo, rows);
      const int s = t % kRingStages, o = t & 1;
      ring_wait_full(bars, t, true);
      mbar_wait_idle(&bars->out_full[o], (t >> 1) & 1);
      for (int x = e; x < live * rows * nk; x += ET) {
        const int g = NC == 1 ? 0 : x / (rows * nk), xr = x - g * rows * nk;
        const int q = xr / nk, kk = xr - q * nk;
        T z;
        if (is_solve) {
          z = out(o, g, L.z)[q * KS + kk];
        } else {
          // a . (p o F before the row), as the carry would have it
          const T* fq = out(o, g, L.f) + (q * KS + kk) * SR;
          const T* pq = in(s, g, L.p) + q * J;
          const T* aq = in(s, g, L.a) + q * J;
          T z0 = T(0), z1 = T(0);
#pragma unroll
          for (int j = 0; j < J; ++j) (j & 1 ? z1 : z0) += aq[j] * (pq[j] * fq[j]);
          z = z0 + z1;
        }
        Z[((size_t)(c0 + g) * N + lo + q) * K + k0 + kk] = z;
      }
      if (cache) {
        for (int x = e; x < live * rows * J * nk; x += ET) {
          const int g = NC == 1 ? 0 : x / (rows * J * nk),
                    xr = x - g * rows * J * nk;
          const int q = xr / (J * nk), rem = xr - q * J * nk;
          const int j = rem / nk, kk = rem - j * nk;
          Fc[(((size_t)(c0 + g) * N + lo + q) * J + j) * K + k0 + kk] =
              out(o, g, L.f)[(q * KS + kk) * SR + j];
        }
      }
      epilogue_arrive(&bars->empty[s]);
      epilogue_arrive(&bars->out_empty[o]);
    }
  }
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
// a slice of up to kSweepSlice of them (KB slices per chain) of one
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
// chain (K > kSweepSlice) does it add into the outputs, which the
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
  const int KS = min(K, kSweepSlice);
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

// ------------------------------------------------------------ launchers

template <typename T, int J>
using FactorFwdKernel = decltype(&factor_fwd_kernel<T, J, 1>);

// the factor's ring for C chains, with or without the cache
template <typename T, int J>
int factor_fwd_plan(long long C, bool cache,
                    RingPlan<FactorFwdKernel<T, J>>* plan) {
  static size_t allowed[2] = {0, 0};  // of the two instantiations
  return ring_plan(
      C, kMaxRingChains,
      [cache](int chains) {
        const int NC = chains == 1 ? 1 : kMaxRingChains;
        RingPlan<FactorFwdKernel<T, J>> x;
        x.kernel = NC == 1 ? factor_fwd_kernel<T, J, 1>
                           : factor_fwd_kernel<T, J, kMaxRingChains>;
        x.rows = tile_rows(chains * FactorFwdSmem<T, J>::bytes_per_row(cache));
        x.chains = chains;
        x.threads = ring_threads(NC, chains);
        x.bytes = FactorFwdSmem<T, J>(x.rows, chains, cache).bytes;
        x.allowed = &allowed[NC != 1];
        return x;
      },
      plan);
}

template <typename T, int J>
int launch_factor_fwd_j(const void* p, const void* a, const void* U,
                        const void* V, void* d, void* W, void* Sh, int C,
                        int N, cudaStream_t s) {
  RingPlan<FactorFwdKernel<T, J>> plan;
  const int rc = factor_fwd_plan<T, J>(C, Sh != nullptr, &plan);
  if (rc != 0) return rc;
  const unsigned grid = (unsigned)((C + plan.chains - 1) / plan.chains);
  plan.kernel<<<grid, plan.threads, plan.bytes, s>>>(
      (const T*)p, (const T*)a, (const T*)U, (const T*)V, (T*)d, (T*)W,
      (T*)Sh, C, N, plan.rows, plan.chains);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_factor_fwd(int J, const void* p, const void* a, const void* U,
                      const void* V, void* d, void* W, void* Sh, int C, int N,
                      cudaStream_t s) {
#define C2T_FACTOR_FWD(JJ) \
  case JJ:                 \
    return launch_factor_fwd_j<T, JJ>(p, a, U, V, d, W, Sh, C, N, s)
  switch (J) {
    C2T_FACTOR_FWD(1);
    C2T_FACTOR_FWD(2);
    C2T_FACTOR_FWD(4);
    C2T_FACTOR_FWD(8);
    C2T_FACTOR_FWD(16);
    C2T_FACTOR_FWD(32);
    default:
      return -1;
  }
#undef C2T_FACTOR_FWD
}

template <typename T, int J>
using SweepFwdKernel = decltype(&sweep_fwd_kernel<T, J, 1>);

// the sweep's ring for C chains of K right-hand sides; ``with_f``: F goes
// through the output tile (with the cache, or in a matmul)
template <typename T, int J>
int sweep_fwd_plan(long long C, int K, bool with_f,
                   RingPlan<SweepFwdKernel<T, J>>* plan) {
  static size_t allowed[2] = {0, 0};  // of the two instantiations
  const int KS = std::min(K, kSweepSlice);
  const long long KB = (K + kSweepSlice - 1) / kSweepSlice;
  return ring_plan(
      C * KB, KB == 1 ? kMaxRingChains : 1,
      [KS, with_f](int chains) {
        const int NC = chains == 1 ? 1 : kMaxRingChains;
        RingPlan<SweepFwdKernel<T, J>> x;
        x.kernel = NC == 1 ? sweep_fwd_kernel<T, J, 1>
                           : sweep_fwd_kernel<T, J, kMaxRingChains>;
        x.rows = tile_rows(chains *
                           SweepFwdSmem<T, J>::bytes_per_row(KS, with_f));
        x.chains = chains;
        x.threads = ring_threads(NC, chains);
        x.bytes = SweepFwdSmem<T, J>(x.rows, KS, chains, with_f).bytes;
        x.allowed = &allowed[NC != 1];
        return x;
      },
      plan);
}

template <typename T, int J>
int launch_sweep_fwd_j(const void* p, const void* A, const void* B,
                       const void* Y, void* Z, void* Fc, int C, int N, int K,
                       int is_solve, int upper, cudaStream_t s) {
  const int KB = (K + kSweepSlice - 1) / kSweepSlice;
  RingPlan<SweepFwdKernel<T, J>> plan;
  const int rc =
      sweep_fwd_plan<T, J>(C, K, Fc != nullptr || !is_solve, &plan);
  if (rc != 0) return rc;
  const long long blocks = (C + plan.chains - 1) / plan.chains * (long long)KB;
  plan.kernel<<<(unsigned)blocks, plan.threads, plan.bytes, s>>>(
      (const T*)p, (const T*)A, (const T*)B, (const T*)Y, (T*)Z, (T*)Fc, C, N,
      K, KB, is_solve, upper, plan.rows, plan.chains);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sweep_fwd(int J, const void* p, const void* A, const void* B,
                     const void* Y, void* Z, void* Fc, int C, int N, int K,
                     int is_solve, int upper, cudaStream_t s) {
#define C2T_SWEEP_FWD(JJ)                                                    \
  case JJ:                                                                   \
    return launch_sweep_fwd_j<T, JJ>(p, A, B, Y, Z, Fc, C, N, K, is_solve, \
                                     upper, s)
  switch (J) {
    C2T_SWEEP_FWD(1);
    C2T_SWEEP_FWD(2);
    C2T_SWEEP_FWD(4);
    C2T_SWEEP_FWD(8);
    C2T_SWEEP_FWD(16);
    C2T_SWEEP_FWD(32);
    default:
      return -1;
  }
#undef C2T_SWEEP_FWD
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
  const int KS = std::min(K, kSweepSlice);
  const long long KB = (K + kSweepSlice - 1) / kSweepSlice;
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
  const int KB = (K + kSweepSlice - 1) / kSweepSlice;
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

// The rings' plans for C chains: rows per tile, chains per block and shared
// memory of ``kernel`` (0 factor_fwd, 1 sweep_fwd, 2 factor_bwd, 3
// sweep_bwd) at K right-hand sides; ``with_out``: the forward's optional
// output tile (the factor's cache; F of a sweep, with its cache or in a
// matmul).  Rows 0 for a width or kernel that is not built, below 0 for an
// error.
template <typename T, int J>
int ring_j(int kernel, int K, int C, int with_out, int* chains,
           long long* bytes) {
  int rc = -1, rows = 0, n = 0;
  size_t b = 0;
  auto take = [&](const auto& plan) {
    rows = plan.rows;
    n = plan.chains;
    b = plan.bytes;
  };
  if (kernel == 0) {
    RingPlan<FactorFwdKernel<T, J>> x;
    rc = factor_fwd_plan<T, J>(C, with_out != 0, &x);
    take(x);
  } else if (kernel == 1) {
    RingPlan<SweepFwdKernel<T, J>> x;
    rc = sweep_fwd_plan<T, J>(C, K, with_out != 0, &x);
    take(x);
  } else if (kernel == 2) {
    RingPlan<FactorBwdKernel<T, J>> x;
    rc = factor_bwd_plan<T, J>(C, &x);
    take(x);
  } else if (kernel == 3) {
    RingPlan<SweepBwdKernel<T, J>> x;
    rc = sweep_bwd_plan<T, J>(C, K, &x);
    take(x);
  } else {
    return 0;
  }
  if (rc != 0) return rc > 0 ? -rc : rc;
  if (chains != nullptr) *chains = n;
  if (bytes != nullptr) *bytes = (long long)b;
  return rows;
}

template <typename T>
int ring(int J, int kernel, int K, int C, int with_out, int* chains,
         long long* bytes) {
  switch (J) {
    case 1: return ring_j<T, 1>(kernel, K, C, with_out, chains, bytes);
    case 2: return ring_j<T, 2>(kernel, K, C, with_out, chains, bytes);
    case 4: return ring_j<T, 4>(kernel, K, C, with_out, chains, bytes);
    case 8: return ring_j<T, 8>(kernel, K, C, with_out, chains, bytes);
    case 16: return ring_j<T, 16>(kernel, K, C, with_out, chains, bytes);
    case 32: return ring_j<T, 32>(kernel, K, C, with_out, chains, bytes);
    default: return 0;
  }
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
// c2t_ring gives the rows per tile of the ring of a row kernel (``kernel``
// 0 factor_fwd, 1 sweep_fwd, 2 factor_bwd, 3 sweep_bwd) for C chains of
// width J and K right-hand sides, with (``with_out`` 1) or without the
// forward's optional output tile (the factor's cache; F of a sweep, with
// its cache or in a matmul), with its chains per block in ``chains`` and
// its launch's dynamic shared memory in ``bytes`` (either may be null); 0
// for a width that is not built, below 0 for a CUDA error.

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

int c2t_ring(int is_double, int J, int kernel, int K, int C, int with_out,
             int* chains, long long* bytes) {
  return is_double ? ring<double>(J, kernel, K, C, with_out, chains, bytes)
                   : ring<float>(J, kernel, K, C, with_out, chains, bytes);
}

}  // extern "C"
