// Per-group float32 SUM (and COUNT) of masked values, and the DISTINCTCOUNT
// presence flags, in one pass over the docs each.
//
// Replaces the TPU kernel pinot_tpu/ops/groupby_pallas.py::_make_sum_kernel
// (launched by _grouped_sum_impl, reached from pallas_grouped_sum,
// pallas_grouped_count and pallas_presence). That kernel turns the scatter-add
// into a (1, CHUNK) x (CHUNK, group-tile) one-hot matmul on the MXU, re-reading
// every doc chunk once per group tile; presence is its count > 0. On Hopper a
// block reads each doc once and adds into its group's slot.
//
// Two entry points:
//  * grouped_sum_f32: f32 sums of masked values per group (COUNT passes no
//    values and adds 1 per masked doc). Each block keeps ng f32 sums in
//    dynamic shared memory, adds with shared f32 atomics, and flushes the
//    non-zero sums with global atomics once at the end. The order of the adds
//    changes from run to run, so sums agree with any other order only to f32
//    rounding; counts stay exact below 2^24 per group. A non-finite value
//    stays in its own group (the TPU one-hot multiplies it by 0 for every
//    other group of its tile, which turns the whole tile NaN).
//  * presence_flags: "count > 0" without the sum. One byte flag per
//    (group, id) cell, set to 1 by a plain store: the store is idempotent, so
//    no atomic is needed, and a flag already set is read and not stored again.
//    gid may be null (the scalar form, one group).
//
// Bound: memory. The passes read N * (4 gid + 1 mask + 4 value) and
// N * (4 id + 4 gid + 1 mask) bytes; the work is one add or one store per
// masked doc. The grid is one wave of resident blocks, so the flush traffic
// scales with the SM count and not with N. Past the shared memory a block can
// use, the same loops work on the output in global memory (in the 50 MB L2).
// Docs with the mask off, or with a group id (or an id) out of range,
// contribute nothing.

#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 512;

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    sum_kernel(const float* __restrict__ values, const int32_t* __restrict__ gid,
               const uint8_t* __restrict__ mask, long long n, int ng, float* out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* acc = kShared ? reinterpret_cast<float*>(smem_raw) : out;
  if (kShared) {
    for (int i = threadIdx.x; i < ng; i += blockDim.x) acc[i] = 0.0f;
    __syncthreads();
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long d = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; d < n;
       d += stride) {
    if (!mask[d]) continue;
    const int g = gid[d];
    if (g < 0 || g >= ng) continue;
    atomicAdd(acc + g, values != nullptr ? values[d] : 1.0f);
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < ng; i += blockDim.x) {
      const float v = acc[i];
      if (v != 0.0f) atomicAdd(out + i, v);  // NaN != 0: a NaN flushes too
    }
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    presence_kernel(const int32_t* __restrict__ ids, const int32_t* __restrict__ gid,
                    const uint8_t* __restrict__ mask, long long n, int pad, int ng,
                    uint8_t* out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long cells = static_cast<long long>(ng) * pad;
  uint8_t* flags = kShared ? smem_raw : out;
  // shared flags are cleared and flushed a 32-bit word at a time
  unsigned int* words = reinterpret_cast<unsigned int*>(smem_raw);
  const long long n_words = (cells + 3) / 4;
  if (kShared) {
    for (long long i = threadIdx.x; i < n_words; i += blockDim.x) words[i] = 0u;
    __syncthreads();
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long d = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; d < n;
       d += stride) {
    if (!mask[d]) continue;
    const int id = ids[d];
    if (id < 0 || id >= pad) continue;
    const int g = gid != nullptr ? gid[d] : 0;
    if (g < 0 || g >= ng) continue;
    uint8_t* f = flags + static_cast<long long>(g) * pad + id;
    if (!*const_cast<volatile uint8_t*>(f)) *f = 1;
  }
  if (kShared) {
    __syncthreads();
    for (long long i = threadIdx.x; i < n_words; i += blockDim.x) {
      const unsigned int w = words[i];
      if (w == 0u) continue;
      for (int b = 0; b < 4; ++b) {
        const long long c = 4 * i + b;
        if (c < cells && ((w >> (8 * b)) & 0xFFu)) out[c] = 1;
      }
    }
  }
}

}  // namespace

// 1 when `bytes` of per-block state (ng * 4 for a sum, the rounded-up
// ng * pad for presence) take the shared-memory path on the current device, 0
// when they take the global path, or a negative CUDA error code.
extern "C" int grouped_sum_f32_uses_shared(long long bytes) {
  return pinot::fits_shared(static_cast<size_t>(bytes));
}

// out: (ng,) float32, zeroed by the caller. values: float32 device pointer, or
// null to count masked docs. Launches on `stream` without synchronising and
// returns the CUDA error of the launch (0 on success).
extern "C" int grouped_sum_f32(const void* values, const void* gid, const void* mask,
                               long long n, int ng, void* out, void* stream) {
  if (ng <= 0 || n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(ng) * sizeof(float);
  const int shared = pinot::fits_shared(smem);
  if (shared < 0) return -shared;
  unsigned int blocks = 0;
  const cudaError_t err = shared == 1 ? pinot::one_wave(sum_kernel<true>, kThreads, smem, n, &blocks)
                                      : pinot::one_wave(sum_kernel<false>, kThreads, 0, n, &blocks);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(values);
  const int32_t* g = static_cast<const int32_t*>(gid);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* o = static_cast<float*>(out);
  if (shared == 1) {
    sum_kernel<true><<<blocks, kThreads, smem, s>>>(v, g, m, n, ng, o);
  } else {
    sum_kernel<false><<<blocks, kThreads, 0, s>>>(v, g, m, n, ng, o);
  }
  return cudaGetLastError();
}

// out: (ng, pad) bytes, zeroed by the caller; receives 1 where a masked doc
// of group g has id i. gid may be null (ng must then be 1). Launches on
// `stream` without synchronising and returns the CUDA error of the launch.
extern "C" int presence_flags(const void* ids, const void* gid, const void* mask, long long n,
                              int pad, int ng, void* out, void* stream) {
  if (pad <= 0 || ng <= 0 || n < 0 || (gid == nullptr && ng != 1)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>((static_cast<long long>(ng) * pad + 15) / 16 * 16);
  const int shared = pinot::fits_shared(smem);
  if (shared < 0) return -shared;
  unsigned int blocks = 0;
  const cudaError_t err = shared == 1
                              ? pinot::one_wave(presence_kernel<true>, kThreads, smem, n, &blocks)
                              : pinot::one_wave(presence_kernel<false>, kThreads, 0, n, &blocks);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* i = static_cast<const int32_t*>(ids);
  const int32_t* g = static_cast<const int32_t*>(gid);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (shared == 1) {
    presence_kernel<true><<<blocks, kThreads, smem, s>>>(i, g, m, n, pad, ng, o);
  } else {
    presence_kernel<false><<<blocks, kThreads, 0, s>>>(i, g, m, n, pad, ng, o);
  }
  return cudaGetLastError();
}
