// Launch helpers shared by the package's kernels: the shared memory a block
// may opt into, the one-wave grid of a grid-stride pass over the docs, and
// the plan (grid, shared bytes, flush cap) of the one-pass group-bys.
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

// The current device's SM count and shared_limit.
inline cudaError_t device_shape(int* sms, int* limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
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

// Docs a block of a one-pass group-by keeps for each counter it flushes.
constexpr long long kDocsPerFlush = 8;

// Blocks of a one-pass group-by over n docs, `docs_per_round` docs a block
// round: enough to cover n, at most one wave (`per_sm` resident blocks an SM
// of `sms`). Where each block flushes `flush_cells` shared counters at its
// end (0: none), at most n / (kDocsPerFlush x flush_cells) blocks, but at
// least one an SM, so the flush stays small beside the docs.
inline long long pass_blocks(long long n, long long docs_per_round, int sms, int per_sm, long long flush_cells) {
  const long long needed = (n + docs_per_round - 1) / docs_per_round;
  const long long wave = static_cast<long long>(sms) * (per_sm < 1 ? 1 : per_sm);
  long long b = needed < wave ? needed : wave;
  if (flush_cells > 0) {
    const long long flush = n / (kDocsPerFlush * flush_cells);
    const long long cap = flush > sms ? flush : sms;
    if (b > cap) b = cap;
  }
  return b;
}

// The plan of a one-pass group-by over n docs on the current device. While
// its `bytes` of per-block counters fit a block's shared memory it runs the
// shared-counter pair (four-doc and one-doc steps, `threads` a block, four
// docs a thread a round, each block flushing `flush_cells` counters at its
// end; their dynamic limit is raised to the device's) and *smem = bytes;
// else the global kernel (`global_threads` a block, `global_docs` docs a
// thread a round, no flush) and *smem = 0. *blocks: pass_blocks's grid.
// Returns the CUDA error (0 on success).
template <typename Shared4, typename Shared1, typename Global>
cudaError_t plan_pass(Shared4 shared4, Shared1 shared1, int threads, size_t bytes, long long flush_cells,
                      Global global, int global_threads, int global_docs, long long n, long long* blocks, int* smem) {
  int sms = 0, limit = 0, per_sm = 0;
  cudaError_t err = device_shape(&sms, &limit);
  if (err != cudaSuccess) return err;
  const bool shared = bytes <= static_cast<size_t>(limit);
  if (shared) {
    if ((err = cudaFuncSetAttribute(shared4, cudaFuncAttributeMaxDynamicSharedMemorySize, limit)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(shared1, cudaFuncAttributeMaxDynamicSharedMemorySize, limit)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, shared4, threads, bytes)) != cudaSuccess)
      return err;
    *blocks = pass_blocks(n, 4LL * threads, sms, per_sm, flush_cells);
  } else {
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, global, global_threads, 0)) != cudaSuccess)
      return err;
    *blocks = pass_blocks(n, static_cast<long long>(global_docs) * global_threads, sms, per_sm, 0);
  }
  *smem = shared ? static_cast<int>(bytes) : 0;
  return cudaSuccess;
}

}  // namespace pinot
