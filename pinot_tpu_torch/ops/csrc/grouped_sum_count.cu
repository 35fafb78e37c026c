// Exact per-group SUM of k int32 columns and COUNT of masked docs, in one
// pass over the docs.
//
// Replaces the TPU kernel pinot_tpu/ops/groupby_pallas.py::_make_planes_kernel
// (launched by _planes_impl, reached from pallas_grouped_multi_sum_blocked).
// That kernel splits each value into four byte planes and runs a bf16 one-hot
// matmul on the MXU with int32 accumulators, which bounds a call to SAFE_DOCS
// docs. None of that carries over: on Hopper each value adds into its
// group's counters, signed values in two's complement, exact modulo 2^64
// (the true sums of up to 2^32 int32 values fit in int64).
//
// Bound: memory. The pass reads N * (4 gid + 1 mask + 4k values) bytes (only
// the steps with a mask byte on read their group ids and values) and writes
// (k+1) * ng * 8 bytes; the arithmetic is far below what the card does in
// the time the bytes take. What the design does about it:
//  - Counters are 32-bit shared words (steps.cuh): a count is one word, a sum
//    a low and a high word with the carry taken from the low word's old
//    value, (2k+1) x ng words a block. The card has no 64-bit shared atomic
//    add; nvcc turned the first design's into a compare-and-swap loop
//    (ATOMS.CAST.SPIN.64), two of them per masked doc at k = 1.
//  - Loads: four docs a step (one 16-byte load of group ids, one 4-byte load
//    of mask bytes, one 16-byte load per value column), four steps' loads
//    issued together, where the pointers are aligned; else one doc a step.
//  - Flush: each block adds its non-zero counters to the output with one
//    global 64-bit add each, so the flush is blocks x (k+1) x ng adds at
//    most. The grid is held to n / (8 x (k+1) x ng) blocks (launch.cuh), but
//    to at least one a SM and at most one wave: at Q4's shape (ng 4608,
//    k = 1) that is one 1024-thread block a SM, where the first design's 396
//    blocks flushed ~2.9M adds against ~2.7M masked docs. Of the three
//    designs weighed (fewer, wider blocks; a cluster sharing one counter set
//    over distributed shared memory; per-block partials and a second pass)
//    this is the first, chosen on the card's numbers (H100 80GB HBM3 at
//    700 W, device time alone at Q4's shape, one call of an A/B harness
//    over copies of this kernel with one edit each): 0.0343 ms, 0.0312 with
//    the flush skipped, so the flush is ~9% and caps what the other two
//    designs could save; 512-thread blocks took 0.0375, and a full wave of
//    them 0.0389 (0.0317 without the flush). chip_ab.py reads 0.0349
//    against the first design's 0.0658-0.0723 in one call.
//  - Contention at small ng: 7 present groups of ng 256 under a 90% mask
//    take 0.0311 ms (first design 0.1315), no more than Q4's shape, so the
//    native 32-bit shared adds need no warp-level pre-aggregation.
// Past the shared memory a block can use (large ng) the global branch adds
// each doc straight into the output with global 64-bit atomics, which land
// in the 50 MB L2; the engine leaves those shapes to grouped_sum_count_2l.
//
// The host plans once per shape (grouped_sum_count_plan: grid, shared bytes,
// and the kernels' shared-memory limit raised once); a launch makes no
// runtime query. Docs with the mask off, or with a group id outside [0, ng),
// contribute nothing: the TPU one-hot never matches them either.

#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"
#include "steps.cuh"

namespace {

using pinot::for_step_groups;
using pinot::kUnroll;
using pinot::taken;

constexpr int kMaxCols = 8;
constexpr int kThreads = 1024;
constexpr int kGlobalThreads = 512;  // the global branch's blocks, as in the first design

struct Cols {
  const int32_t* p[kMaxCols];
};

template <int V>
__global__ void __launch_bounds__(kThreads)
    shared_kernel(Cols cols, int k, const int32_t* __restrict__ gid, const uint8_t* __restrict__ mask, long long n,
                  int ng, unsigned long long* __restrict__ out) {
  // ng counts, then a low and a high row of ng words per column
  extern __shared__ unsigned int acc[];
  const int words = (2 * k + 1) * ng;
  for (int i = threadIdx.x; i < words; i += blockDim.x) acc[i] = 0u;
  __syncthreads();
  for_step_groups<V>(gid, mask, n, [&](const long long* d0, const uint32_t* m, const int (*g)[V], bool full) {
    // one column at a time, its loads for the group's steps issued together;
    // the counts go in while column 0's loads are in flight
    for (int j = 0; j < (k > 0 ? k : 1); ++j) {
      int32_t v[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j < k && m[u] != 0u) pinot::step_values<int32_t, V>(cols.p[j], d0[u], full, v[u]);
      }
      if (j == 0) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int i = 0; i < V; ++i) {
            if (taken(m[u], i, g[u][i], ng)) atomicAdd(acc + g[u][i], 1u);
          }
        }
      }
      if (j == k) break;
      unsigned int* low = acc + (1 + 2 * j) * ng;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if (taken(m[u], i, g[u][i], ng)) pinot::add_wide(low + g[u][i], low + ng + g[u][i], v[u][i]);
        }
      }
    }
  });
  __syncthreads();
  unsigned long long* counts = out + static_cast<long long>(k) * ng;
  for (int c = threadIdx.x; c < ng; c += blockDim.x) {
    const unsigned int n_c = acc[c];
    if (n_c == 0u) continue;  // no doc of this block in group c, so every sum is 0 too
    atomicAdd(counts + c, static_cast<unsigned long long>(n_c));
    for (int j = 0; j < k; ++j) {
      const unsigned int* low = acc + (1 + 2 * j) * ng + c;
      const unsigned long long v = pinot::wide(low[0], low[ng]);
      if (v != 0ULL) atomicAdd(out + static_cast<long long>(j) * ng + c, v);
    }
  }
}

// Counters past a block's shared memory: every doc adds into the output.
__global__ void __launch_bounds__(kGlobalThreads)
    global_kernel(Cols cols, int k, const int32_t* __restrict__ gid, const uint8_t* __restrict__ mask, long long n,
                  int ng, unsigned long long* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long d = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; d < n; d += stride) {
    if (!mask[d]) continue;
    const int g = gid[d];
    if (g < 0 || g >= ng) continue;
    atomicAdd(out + static_cast<long long>(k) * ng + g, 1ULL);
    for (int j = 0; j < k; ++j) {
      const long long v = cols.p[j][d];
      atomicAdd(out + static_cast<long long>(j) * ng + g, static_cast<unsigned long long>(v));
    }
  }
}

size_t shared_bytes(int k, int ng) {
  return static_cast<size_t>(2 * k + 1) * static_cast<size_t>(ng) * sizeof(unsigned int);
}

bool valid(int k, int ng, long long n) { return k >= 0 && k <= kMaxCols && ng > 0 && n >= 0; }

}  // namespace

// The launch plan of (k, ng, n) on the current device: *blocks (0 when n is
// 0) and *smem, the dynamic shared bytes of the shared-counter kernel, or 0
// for the global branch. Raises the shared kernels' dynamic shared-memory
// limit to the device's. Returns the CUDA error (0 on success).
extern "C" int grouped_sum_count_plan(int k, int ng, long long n, int* blocks, int* smem) {
  if (!valid(k, ng, n)) return cudaErrorInvalidValue;
  // a shared block flushes (k+1) x ng counters; the global branch takes one
  // doc a thread a round
  long long b = 0;
  const cudaError_t err = pinot::plan_pass(shared_kernel<4>, shared_kernel<1>, kThreads, shared_bytes(k, ng),
                                           (k + 1LL) * ng, global_kernel, kGlobalThreads, 1, n, &b, smem);
  *blocks = static_cast<int>(b);
  return err;
}

// out: (k+1, ng) int64, zeroed by the caller; rows 0..k-1 receive the sums of
// values[0..k-1], row k the counts. blocks and smem: grouped_sum_count_plan's
// for (k, ng, n) on this device. All pointers are device pointers; values is
// a host array of k device pointers. Launches on `stream` without
// synchronising and returns the CUDA error of the launch (0 on success).
extern "C" int grouped_sum_count(const void* const* values, int k, const void* gid, const void* mask, long long n,
                                 int ng, int blocks, int smem, void* out, void* stream) {
  if (!valid(k, ng, n) || blocks < 0 || smem < 0) return cudaErrorInvalidValue;
  if (n == 0 || blocks == 0) return cudaSuccess;
  Cols cols{};
  for (int j = 0; j < k; ++j) cols.p[j] = static_cast<const int32_t*>(values[j]);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* g = static_cast<const int32_t*>(gid);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  if (smem == 0) {
    global_kernel<<<blocks, kGlobalThreads, 0, s>>>(cols, k, g, m, n, ng, o);
    return cudaGetLastError();
  }
  // four docs a step where group ids and values allow 16-byte loads and the
  // mask 4-byte ones
  bool vec = reinterpret_cast<uintptr_t>(gid) % 16 == 0 && reinterpret_cast<uintptr_t>(mask) % 4 == 0;
  for (int j = 0; j < k; ++j) vec = vec && reinterpret_cast<uintptr_t>(values[j]) % 16 == 0;
  if (vec) {
    shared_kernel<4><<<blocks, kThreads, smem, s>>>(cols, k, g, m, n, ng, o);
  } else {
    shared_kernel<1><<<blocks, kThreads, smem, s>>>(cols, k, g, m, n, ng, o);
  }
  return cudaGetLastError();
}
