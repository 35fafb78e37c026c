// Launch helpers shared by the package's kernels: the shared memory a block
// may opt into, and the one-wave grid of a grid-stride pass over the docs.
#pragma once

#include <cuda_runtime.h>

namespace pinot {

// Opt-in dynamic shared memory a block of the current device can use
// (232,448 B on an H100).
inline cudaError_t shared_limit(int* limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// 1 when `bytes` of block-private state fit in shared memory on the current
// device, 0 when a kernel must keep it in global memory, or a negative CUDA
// error code.
inline int fits_shared(size_t bytes) {
  int limit = 0;
  const cudaError_t err = shared_limit(&limit);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return bytes <= static_cast<size_t>(limit) ? 1 : 0;
}

// Grid for a grid-stride pass of `kernel` over n docs at `threads` a block and
// `smem` dynamic shared bytes: enough blocks to cover n, at most one wave of
// resident blocks, so per-block set-up and flush scale with the SM count and
// not with n. Raises the kernel's dynamic shared-memory limit to `smem`.
template <typename Kernel>
cudaError_t one_wave(Kernel kernel, int threads, size_t smem, long long n, unsigned int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (smem > 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;
  const long long needed = (n + threads - 1) / threads;
  const long long wave = static_cast<long long>(sms) * per_sm;
  *blocks = static_cast<unsigned int>(needed < wave ? needed : wave);
  return cudaSuccess;
}

}  // namespace pinot
