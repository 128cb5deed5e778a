// The opt-in that a kernel needs for more than 48 KB of dynamic shared
// memory, once per device. Shared by the blendshape kernels (blendshapes.cu,
// blendshapes_bwd.cu) and the resample kernel (resample.cu).

#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace d3d {

// A kernel whose dynamic shared memory exceeds 48 KB must opt in, and the
// setting is held per device context: set it the first time the kernel
// launches on the current device. `opted_in` is the kernel's own set of
// device ordinals (one bit each; past 64 it is set on every launch).
template <typename Kernel>
inline cudaError_t opt_in_smem(Kernel kernel, int smem, std::atomic<uint64_t>& opted_in) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (bit & opted_in.load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) opted_in.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace d3d
