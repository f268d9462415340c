// Host-side launch helpers shared by the port's CUDA sources.

#pragma once

#include <cuda_runtime.h>

#include <atomic>

// Raises a kernel's dynamic shared-memory limit on the current device once
// per device: bit `dev` of `done`, one word per kernel instantiation.  Call
// it before the launch, so that a CUDA graph capture of a later launch holds
// no attribute call.  Two threads racing on a first call set the same value
// twice; a device past the 64th sets it on every call.
template <typename K>
static cudaError_t set_smem_once(std::atomic<unsigned long long>& done,
                                 K kernel, size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit && (done.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}
