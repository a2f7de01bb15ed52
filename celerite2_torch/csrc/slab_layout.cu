// The fused slab's layout kernels, written for Hopper (sm_90a): a batch of
// float32 planes moved between the natural row layout and the slab's
// (sublane, lane) layout.  Built with nvcc into the shared library of
// celerite2_torch/ops/_build.py and bound with ctypes.
//
// They replace the two Pallas kernels of the TPU's layout probe,
//   benchmarks/probe_transpose_tpu.py  make_pallas_T   (pallas_call at :119,
//                                      body transpose_kernel at :58)
//                                      make_pallas_inv (pallas_call at :144,
//                                      body inv_transpose_kernel at :65):
//   * slab_transpose_kernel (K15): x (E, TOT, LP) -> y (E, LP, TOT), which
//     the wrapper views as the slab's (E, LP, s, 128);
//   * slab_inverse_kernel (K16): y (E, LP, TOT) -> x (E, TOT, LP).
// Each is one batched 2-D transpose of every plane.  The TPU kernel swapped
// the axes of a whole (EB, s*128, 128) block in vector memory; here a
// thread block moves one 32 x 32 tile of one plane through shared memory.
//
// Bound: bytes.  Each value is read once and written once, and nothing is
// computed, so the least time is 2 * E * TOT * LP * 4 bytes at the card's
// memory rate (3.76 us at the probe's N = 1e5, 30.0 us at N = 1e6 on an
// H100 SXM).  A transpose is at that rate only if both the reads and the
// writes are coalesced: a warp reads 32 neighbouring values of a row of the
// input (128 bytes) into a row of the tile, and writes 32 neighbouring
// values of a row of the output from a column of the tile.  The tile has 33
// columns, so that a column's 32 values lie in 32 different banks of shared
// memory.  Tiles at the planes' edges are masked, for any (E, R, C).  Work
// for later: a block of more than one tile, cp.async or TMA staging.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 32;
// rows of the tile a pass of the thread block's 32 x 8 threads covers
constexpr int kRows = 8;
// planes a launch spreads over gridDim.y; a block walks the rest in steps
constexpr int kMaxPlanes = 65535;

// out (C, R) = in (R, C)^T for one plane, one 32 x 32 tile: tile t of the
// row-major grid of ceil(R / 32) x ceil(C / 32) tiles
__device__ __forceinline__ void transpose_tile(const float* __restrict__ in,
                                               float* __restrict__ out, int R,
                                               int C, long long t,
                                               float (*tile)[kTile + 1]) {
  const int tiles_c = (C + kTile - 1) / kTile;
  const int r0 = static_cast<int>(t / tiles_c) * kTile;
  const int c0 = static_cast<int>(t % tiles_c) * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  // reads coalesced along C
  const int c = c0 + tx;
#pragma unroll
  for (int i = ty; i < kTile; i += kRows) {
    const int r = r0 + i;
    if (r < R && c < C) tile[i][tx] = in[static_cast<size_t>(r) * C + c];
  }
  __syncthreads();
  // writes coalesced along R
  const int r = r0 + tx;
#pragma unroll
  for (int i = ty; i < kTile; i += kRows) {
    const int cc = c0 + i;
    if (cc < C && r < R) out[static_cast<size_t>(cc) * R + r] = tile[tx][i];
  }
}

// K15: x (E, TOT, LP) -> y (E, LP, TOT)
__global__ void __launch_bounds__(kTile * kRows)
    slab_transpose_kernel(const float* __restrict__ x, float* __restrict__ y,
                          int E, int TOT, int LP) {
  __shared__ float tile[kTile][kTile + 1];
  const size_t plane = static_cast<size_t>(TOT) * LP;
  for (int e = blockIdx.y; e < E; e += gridDim.y) {
    transpose_tile(x + e * plane, y + e * plane, TOT, LP, blockIdx.x, tile);
    __syncthreads();
  }
}

// K16: y (E, LP, TOT) -> x (E, TOT, LP)
__global__ void __launch_bounds__(kTile * kRows)
    slab_inverse_kernel(const float* __restrict__ y, float* __restrict__ x,
                        int E, int LP, int TOT) {
  __shared__ float tile[kTile][kTile + 1];
  const size_t plane = static_cast<size_t>(TOT) * LP;
  for (int e = blockIdx.y; e < E; e += gridDim.y) {
    transpose_tile(y + e * plane, x + e * plane, LP, TOT, blockIdx.x, tile);
    __syncthreads();
  }
}

dim3 layout_grid(int E, int R, int C) {
  const long long tiles = static_cast<long long>((R + kTile - 1) / kTile) *
                          ((C + kTile - 1) / kTile);
  return dim3(static_cast<unsigned>(tiles),
              static_cast<unsigned>(E < kMaxPlanes ? E : kMaxPlanes));
}

}  // namespace

extern "C" {

// x (E, TOT, LP) -> y (E, LP, TOT), float32; returns the launch's CUDA error
int c2t_slab_transpose(const void* x, void* y, int E, int TOT, int LP,
                       void* stream) {
  if (E < 1 || TOT < 1 || LP < 1) return 0;
  slab_transpose_kernel<<<layout_grid(E, TOT, LP), dim3(kTile, kRows), 0,
                          (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<float*>(y), E, TOT, LP);
  return static_cast<int>(cudaGetLastError());
}

// y (E, LP, TOT) -> x (E, TOT, LP), float32
int c2t_slab_inverse(const void* y, void* x, int E, int LP, int TOT,
                     void* stream) {
  if (E < 1 || TOT < 1 || LP < 1) return 0;
  slab_inverse_kernel<<<layout_grid(E, LP, TOT), dim3(kTile, kRows), 0,
                        (cudaStream_t)stream>>>(
      static_cast<const float*>(y), static_cast<float*>(x), E, LP, TOT);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
