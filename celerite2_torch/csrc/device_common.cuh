// Helpers shared by the port's CUDA sources (general_ops.cu and
// fused_loglik.cu): shared-memory addresses, element-wise cp.async copies
// and the opt-in to more than 48 KB of dynamic shared memory.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// one element global -> shared, asynchronous (cp.async, cached in L1)
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_addr(dst)),
               "l"(src), "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most PENDING of this thread's groups of copies are in flight
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}

// Set a kernel's dynamic shared memory limit above the default 48 KB once
// per instantiation (and again if a launch asks for more); *allowed keeps
// the limit set so far.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes, size_t* allowed) {
  if (bytes <= 48 * 1024 || bytes <= *allowed) return 0;
  const int rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc == 0) *allowed = bytes;
  return rc;
}

}  // namespace
