// Exact per-group SUM of k int32 columns and COUNT of masked docs, in one
// pass over the docs.
//
// Replaces the TPU kernel pinot_tpu/ops/groupby_pallas.py::_make_planes_kernel
// (launched by _planes_impl, reached from pallas_grouped_multi_sum_blocked).
// That kernel splits each value into four byte planes and runs a bf16 one-hot
// matmul on the MXU with int32 accumulators, which bounds a call to SAFE_DOCS
// docs. Hopper adds 64-bit integers natively, so none of that carries over:
// each value adds into an int64 counter of its group, signed values going
// through unsigned long long in two's complement (exact modulo 2^64, and the
// true sums of up to 2^32 int32 values fit in int64).
//
// Bound: memory. The pass reads N * (4 gid + 1 mask + 4k values) bytes and
// writes (k+1) * ng * 8 bytes of results; the arithmetic is k+1 integer adds
// per doc, far below what the card's integer units do in the time the bytes
// take. Design for that bound: a grid-stride loop with neighbouring threads on
// neighbouring docs (coalesced loads of every stream), and counters that stay
// on chip. Each block keeps its (k+1) x ng int64 counters in dynamic shared
// memory, adds with shared 64-bit atomics, and flushes its non-zero counters
// to the output with global atomics once at the end. The grid is one wave of
// resident blocks, so the flush traffic scales with the SM count and not with
// N. When the counters pass the shared memory a block can use (large ng, or
// many columns at large ng) the same loop adds straight into the output with
// global atomics, which land in the 50 MB L2.
//
// Docs with the mask off, or with a group id outside [0, ng), contribute
// nothing: the TPU one-hot never matches them either.

#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kMaxCols = 8;
constexpr int kThreads = 512;

struct Cols {
  const int32_t* p[kMaxCols];
};

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    grouped_sum_count_kernel(Cols cols, int k, const int32_t* __restrict__ gid,
                             const uint8_t* __restrict__ mask, long long n, int ng,
                             unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long acc[];
  const long long cells = static_cast<long long>(k + 1) * ng;
  unsigned long long* dst = kShared ? acc : out;
  if (kShared) {
    for (long long i = threadIdx.x; i < cells; i += blockDim.x) acc[i] = 0ULL;
    __syncthreads();
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long d = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; d < n;
       d += stride) {
    if (!mask[d]) continue;
    const int g = gid[d];
    if (g < 0 || g >= ng) continue;
    atomicAdd(dst + static_cast<long long>(k) * ng + g, 1ULL);
    for (int j = 0; j < k; ++j) {
      const long long v = cols.p[j][d];
      atomicAdd(dst + static_cast<long long>(j) * ng + g, static_cast<unsigned long long>(v));
    }
  }
  if (kShared) {
    __syncthreads();
    for (long long i = threadIdx.x; i < cells; i += blockDim.x) {
      const unsigned long long v = acc[i];
      if (v != 0ULL) atomicAdd(out + i, v);
    }
  }
}

size_t shared_bytes(int k, int ng) {
  return static_cast<size_t>(k + 1) * static_cast<size_t>(ng) * sizeof(unsigned long long);
}

}  // namespace

// 1 when (k, ng) takes the shared-memory path on the current device, 0 when
// it takes the global-atomics path, or a negative CUDA error code.
extern "C" int grouped_sum_count_uses_shared(int k, int ng) {
  return pinot::fits_shared(shared_bytes(k, ng));
}

// out: (k+1, ng) int64, zeroed by the caller; rows 0..k-1 receive the sums of
// values[0..k-1], row k the counts. All pointers are device pointers; values
// is a host array of k device pointers. Launches on `stream` without
// synchronising and returns the CUDA error of the launch (0 on success).
extern "C" int grouped_sum_count(const void* const* values, int k, const void* gid,
                                 const void* mask, long long n, int ng, void* out,
                                 void* stream) {
  if (k < 0 || k > kMaxCols || ng <= 0 || n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  Cols cols{};
  for (int j = 0; j < k; ++j) cols.p[j] = static_cast<const int32_t*>(values[j]);
  const size_t smem = shared_bytes(k, ng);
  const int shared = pinot::fits_shared(smem);
  if (shared < 0) return -shared;
  const bool use_shared = shared == 1;
  unsigned int blocks = 0;
  const cudaError_t err =
      use_shared ? pinot::one_wave(grouped_sum_count_kernel<true>, kThreads, smem, n, &blocks)
                 : pinot::one_wave(grouped_sum_count_kernel<false>, kThreads, 0, n, &blocks);
  if (err != cudaSuccess) return err;

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* g = static_cast<const int32_t*>(gid);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  if (use_shared) {
    grouped_sum_count_kernel<true><<<blocks, kThreads, smem, s>>>(cols, k, g, m, n, ng, o);
  } else {
    grouped_sum_count_kernel<false><<<blocks, kThreads, 0, s>>>(cols, k, g, m, n, ng, o);
  }
  return cudaGetLastError();
}
