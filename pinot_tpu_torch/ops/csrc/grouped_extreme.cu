// Per-group MIN and MAX of masked values: up to kMaxOut outputs over one
// (gid, mask) in one pass over the docs.
//
// Replaces the TPU kernel pinot_tpu/ops/groupby_pallas.py::_make_extreme_kernel
// (launched by _grouped_extreme_impl, reached from pallas_grouped_min/max).
// That kernel builds a (CHUNK, group-tile) one-hot select per grid step and
// reduces its columns on the VPU, re-reading every doc chunk once per group
// tile and once per aggregate. Hopper has no use for the one-hot: a block
// reads each doc once and updates its group's slot with an integer atomic.
//
// Order-preserving keys. Each value maps to an unsigned integer key whose
// unsigned order is the value's order:
//   int32   v ^ 0x80000000
//   float / double  bits | sign when the sign bit is clear, ~bits when set
// -0.0 orders below +0.0. NaN maps to key 0 for MIN and to the largest key for
// MAX, so a masked NaN wins both ways, as jnp.min/jnp.minimum and XLA's
// segment_min/segment_max propagate it; both keys map back to a NaN. A MIN
// slot holds the complement ~key, so every slot starts at 0 and every update
// is an atomicMax: the scratch keys need one memset, and no fill kernel. A
// float slot still at 0 is an empty group (no value's key reaches it); an
// int32 group is empty where the caller's per-group counts are 0 (INT32_MIN
// and INT32_MAX are real values).
//
// Bound: memory. One pass reads N * (4 gid + 1 mask) bytes and each distinct
// value column once (sizeof(T) a doc), and writes the outputs; the work is a
// compare (and rarely an atomic) per masked doc and output. A MIN and a MAX
// of one column read it once. Docs go four a step (steps.cuh: 16-byte group
// ids, 4-byte mask bytes, 16-byte values) where the pointers are aligned.
// Each block keeps every output's ng keys in dynamic shared memory, reads a
// slot before its atomic and skips the atomic when the slot already holds a
// better key (after a few docs a group almost every doc skips it, which keeps
// heavy contention at small ng cheap), and flushes the slots that moved to
// the global keys once at the end; the grid is at most one wave, held to
// n / (8 x outputs x ng) blocks but at least one a SM (launch.cuh). Past a
// block's shared memory the same loop updates the global keys directly (they
// land in the 50 MB L2).
//
// Finish: keys back to values, and the empty-group rule. While outputs x ng
// is at most kFoldFinish the last block to retire does it (a ticket in the
// zeroed scratch, taken after __threadfence), so a call is one memset and one
// kernel; past that, one finish kernel follows. The cutover is measured
// (chip_smoke.py's extreme_finish, H100 80GB HBM3 at 700 W, one 4M-doc
// segment): the fold's device time was within 1 us of the finish kernel's
// at 1024-2048 cells, 2.1 us longer at 4096, 5.5 at 8192 and 13.6 at 16384,
// while the launch it saves took the host 5.2 us on average over those
// shapes. So the fold runs up to 4096 cells (eight keys a thread of the last
// block), where it costs the device less than it saves the host. Docs with
// the mask off, or with a group id outside [0, ng), contribute nothing.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"
#include "steps.cuh"

namespace {

using pinot::for_step_groups;
using pinot::kUnroll;
using pinot::taken;

constexpr int kThreads = 512;
constexpr int kFinishThreads = 256;
constexpr int kMaxOut = 8;
// outputs x ng that the last block finishes itself (eight keys a thread)
constexpr int kFoldFinish = 8 * kThreads;

enum Dtype : int { kF32 = 0, kI32 = 1, kF64 = 2 };

template <typename T>
struct Ord;

template <>
struct Ord<int32_t> {
  using Key = unsigned int;
  __device__ static Key key(int32_t v, bool) { return static_cast<Key>(v) ^ 0x80000000u; }
  __device__ static int32_t value(Key k) { return static_cast<int32_t>(k ^ 0x80000000u); }
};

template <>
struct Ord<float> {
  using Key = unsigned int;
  __device__ static Key key(float v, bool is_min) {
    if (v != v) return is_min ? 0u : 0xFFFFFFFFu;
    const Key b = __float_as_uint(v);
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  }
  __device__ static float value(Key k) { return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k); }
};

template <>
struct Ord<double> {
  using Key = unsigned long long;
  static constexpr Key kSign = 0x8000000000000000ull;
  __device__ static Key key(double v, bool is_min) {
    if (v != v) return is_min ? 0ull : ~0ull;
    const Key b = static_cast<Key>(__double_as_longlong(v));
    return (b & kSign) ? ~b : (b | kSign);
  }
  __device__ static double value(Key k) {
    return __longlong_as_double(static_cast<long long>((k & kSign) ? (k ^ kSign) : ~k));
  }
};

// The launch's columns and outputs. Column c feeds output min_out[c] (its
// MIN) and max_out[c] (its MAX), -1 where it has none; output o's keys lie at
// byte offset off[o] of the key area (shared memory and the global scratch
// alike), and its result goes to out[o].
struct Args {
  int n_cols, n_out, key_bytes;
  const void* col[kMaxOut];
  int dtype[kMaxOut];
  int min_out[kMaxOut];
  int max_out[kMaxOut];
  int out_col[kMaxOut];
  int out_min[kMaxOut];
  int off[kMaxOut];
  void* out[kMaxOut];
};

__host__ __device__ inline int key_width(int dtype) { return dtype == kF64 ? 8 : 4; }

template <typename Key>
__device__ __forceinline__ void improve(Key* slot, Key k) {
  // a plain read first: once the slot holds a better key the atomic is skipped
  if (k > *const_cast<volatile Key*>(slot)) atomicMax(slot, k);
}

// Column c's MIN and MAX updates for a group of steps, the column's loads
// for the group's steps issued together.
template <typename T, int V>
__device__ __forceinline__ void update(const Args& a, int c, unsigned char* keys, const long long* d0,
                                       const uint32_t* m, const int (*g)[V], bool full, int ng) {
  using Key = typename Ord<T>::Key;
  T v[kUnroll][V];
  const T* col = static_cast<const T*>(a.col[c]);
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (m[u] != 0u) pinot::step_values<T, V>(col, d0[u], full, v[u]);
  }
  const int lo = a.min_out[c], hi = a.max_out[c];
  Key* kmin = lo < 0 ? nullptr : reinterpret_cast<Key*>(keys + a.off[lo]);
  Key* kmax = hi < 0 ? nullptr : reinterpret_cast<Key*>(keys + a.off[hi]);
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (!taken(m[u], i, g[u][i], ng)) continue;
      if (kmin != nullptr) improve(kmin + g[u][i], static_cast<Key>(~Ord<T>::key(v[u][i], true)));
      if (kmax != nullptr) improve(kmax + g[u][i], Ord<T>::key(v[u][i], false));
    }
  }
}

template <typename Key>
__device__ __forceinline__ void flush(const Key* __restrict__ from, Key* to, int ng) {
  for (int g = threadIdx.x; g < ng; g += blockDim.x) {
    const Key k = from[g];
    if (k != 0) improve(to + g, k);
  }
}

// Output o's result for group g from its global key (read past L1: other
// blocks' atomics land in L2).
__device__ __forceinline__ void finish_one(const Args& a, const unsigned char* scratch, int o, int g,
                                           const long long* __restrict__ counts) {
  const bool is_min = a.out_min[o] != 0;
  // +inf for an empty MIN, -inf for an empty MAX
  const float finf = __uint_as_float(is_min ? 0x7f800000u : 0xff800000u);
  const double dinf = static_cast<double>(finf);
  const int dtype = a.dtype[a.out_col[o]];
  if (dtype == kF64) {
    const unsigned long long s = __ldcg(reinterpret_cast<const unsigned long long*>(scratch + a.off[o]) + g);
    static_cast<double*>(a.out[o])[g] = s == 0ull ? dinf : Ord<double>::value(is_min ? ~s : s);
    return;
  }
  const unsigned int s = __ldcg(reinterpret_cast<const unsigned int*>(scratch + a.off[o]) + g);
  if (dtype == kF32) {
    static_cast<float*>(a.out[o])[g] = s == 0u ? finf : Ord<float>::value(is_min ? ~s : s);
  } else {
    static_cast<double*>(a.out[o])[g] = counts[g] == 0 ? dinf : static_cast<double>(Ord<int32_t>::value(is_min ? ~s : s));
  }
}

__device__ __forceinline__ void finish_range(const Args& a, const unsigned char* scratch, int ng,
                                             const long long* __restrict__ counts, long long first, long long step) {
  const long long cells = static_cast<long long>(a.n_out) * ng;
  for (long long i = first; i < cells; i += step) {
    const int o = static_cast<int>(i / ng);
    finish_one(a, scratch, o, static_cast<int>(i - static_cast<long long>(o) * ng), counts);
  }
}

template <int V, bool kShared>
__global__ void __launch_bounds__(kThreads)
    extremes_kernel(Args a, const int32_t* __restrict__ gid, const uint8_t* __restrict__ mask, long long n, int ng,
                    const long long* __restrict__ counts, unsigned char* scratch, bool fold) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* keys = kShared ? smem_raw : scratch;
  if (kShared) {
    unsigned long long* w = reinterpret_cast<unsigned long long*>(smem_raw);
    for (int i = threadIdx.x; i < a.key_bytes / 8; i += blockDim.x) w[i] = 0ull;
    __syncthreads();
  }
  for_step_groups<V>(gid, mask, n, [&](const long long* d0, const uint32_t* m, const int (*g)[V], bool full) {
    for (int c = 0; c < a.n_cols; ++c) {
      switch (a.dtype[c]) {
        case kF32:
          update<float, V>(a, c, keys, d0, m, g, full, ng);
          break;
        case kI32:
          update<int32_t, V>(a, c, keys, d0, m, g, full, ng);
          break;
        default:
          update<double, V>(a, c, keys, d0, m, g, full, ng);
      }
    }
  });
  if (kShared) {
    __syncthreads();
    for (int o = 0; o < a.n_out; ++o) {
      if (key_width(a.dtype[a.out_col[o]]) == 8) {
        flush(reinterpret_cast<const unsigned long long*>(smem_raw + a.off[o]),
              reinterpret_cast<unsigned long long*>(scratch + a.off[o]), ng);
      } else {
        flush(reinterpret_cast<const unsigned int*>(smem_raw + a.off[o]),
              reinterpret_cast<unsigned int*>(scratch + a.off[o]), ng);
      }
    }
  }
  if (!fold) return;
  // the last block to retire finishes every output (no static shared
  // memory: the dynamic limit is the whole opt-in)
  __threadfence();
  __syncthreads();
  bool last = false;
  if (threadIdx.x == 0) last = atomicAdd(reinterpret_cast<unsigned int*>(scratch + a.key_bytes), 1u) == gridDim.x - 1;
  if (!__syncthreads_or(last)) return;
  __threadfence();
  finish_range(a, scratch, ng, counts, threadIdx.x, blockDim.x);
}

__global__ void __launch_bounds__(kFinishThreads)
    finish_kernel(Args a, int ng, const long long* __restrict__ counts, const unsigned char* scratch) {
  finish_range(a, scratch, ng, counts, static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x,
               static_cast<long long>(gridDim.x) * blockDim.x);
}

// Byte offset of each output's keys (each area rounded up to 8 bytes) from
// their key widths; returns the key area's bytes. The ticket follows it.
long long layout(int n_out, const int* width, int ng, int* off) {
  long long total = 0;
  for (int o = 0; o < n_out; ++o) {
    if (off != nullptr) off[o] = static_cast<int>(total);
    total += (static_cast<long long>(width[o]) * ng + 7) / 8 * 8;
  }
  return total;
}

}  // namespace

// The launch plan for n_out outputs of the given key widths (4 or 8 bytes)
// over (ng, n) on the current device: *blocks of the pass (at least 1),
// *smem its dynamic shared bytes (0: keys in global memory), *finish the
// blocks of a separate finish kernel (0: the pass's last block finishes),
// *scratch the bytes of the zeroed scratch the launch needs. Raises the pass
// kernels' dynamic shared-memory limit to the device's. Returns the CUDA
// error (0 on success).
extern "C" int grouped_extremes_plan(int n_out, const int* width, int ng, long long n, int* blocks, int* smem,
                                     int* finish, long long* scratch) {
  if (n_out < 1 || n_out > kMaxOut || ng <= 0 || n < 0) return cudaErrorInvalidValue;
  for (int o = 0; o < n_out; ++o) {
    if (width[o] != 4 && width[o] != 8) return cudaErrorInvalidValue;
  }
  const long long bytes = layout(n_out, width, ng, nullptr);
  if (bytes > INT_MAX) return cudaErrorInvalidValue;
  // a block with shared keys flushes every cell; the global-key kernel takes
  // four docs a thread a round too
  const long long cells = static_cast<long long>(n_out) * ng;
  long long b = 0;
  const cudaError_t err = pinot::plan_pass(extremes_kernel<4, true>, extremes_kernel<1, true>, kThreads,
                                           static_cast<size_t>(bytes), cells, extremes_kernel<4, false>, kThreads,
                                           4, n, &b, smem);
  if (err != cudaSuccess) return err;
  *blocks = static_cast<int>(b < 1 ? 1 : b);
  *finish = cells <= kFoldFinish ? 0 : static_cast<int>((cells + kFinishThreads - 1) / kFinishThreads);
  *scratch = bytes + 8;
  return cudaSuccess;
}

// cols: n_cols device pointers of values, dtypes their codes (0 float32 ->
// float32 results, 1 int32 -> float64 results, 2 float64 -> float64 results).
// Output o is the MIN (out_min[o] != 0) or MAX of column out_col[o], written
// to outs[o] (ng values); no two outputs are the same (column, MIN/MAX).
// counts: the int64 per-group counts of (gid, mask), needed when an int32
// column has an output. blocks, smem, finish and the scratch's bytes:
// grouped_extremes_plan's for these outputs' key widths and (ng, n); the
// scratch is zeroed here. Launches on `stream` without synchronising: a
// memset and one kernel (two where finish > 0). Returns the first CUDA
// error (0 on success).
extern "C" int grouped_extremes(int n_cols, const void* const* cols, const int* dtypes, int n_out, const int* out_col,
                                const int* out_min, const void* gid, const void* mask, long long n, int ng,
                                const void* counts, int blocks, int smem, int finish, void* scratch,
                                long long scratch_bytes, void* const* outs, void* stream) {
  if (n_cols < 1 || n_cols > kMaxOut || n_out < 1 || n_out > kMaxOut || ng <= 0 || n < 0 || blocks < 1 ||
      smem < 0 || finish < 0)
    return cudaErrorInvalidValue;
  Args a{};
  a.n_cols = n_cols;
  a.n_out = n_out;
  int width[kMaxOut];
  for (int c = 0; c < n_cols; ++c) {
    if (dtypes[c] < kF32 || dtypes[c] > kF64) return cudaErrorInvalidValue;
    a.col[c] = cols[c];
    a.dtype[c] = dtypes[c];
    a.min_out[c] = a.max_out[c] = -1;
  }
  for (int o = 0; o < n_out; ++o) {
    const int c = out_col[o];
    if (c < 0 || c >= n_cols) return cudaErrorInvalidValue;
    int& slot = out_min[o] ? a.min_out[c] : a.max_out[c];
    if (slot >= 0) return cudaErrorInvalidValue;  // a repeated output
    if (a.dtype[c] == kI32 && counts == nullptr) return cudaErrorInvalidValue;
    slot = o;
    a.out_col[o] = c;
    a.out_min[o] = out_min[o] != 0;
    a.out[o] = outs[o];
    width[o] = key_width(a.dtype[c]);
  }
  a.key_bytes = static_cast<int>(layout(n_out, width, ng, a.off));
  if (scratch_bytes < a.key_bytes + 8LL || (smem > 0 && smem != a.key_bytes)) return cudaErrorInvalidValue;

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(scratch, 0, static_cast<size_t>(a.key_bytes) + 8, s);
  if (err != cudaSuccess) return err;
  // four docs a step where group ids and values allow 16-byte loads and the
  // mask 4-byte ones
  bool vec = reinterpret_cast<uintptr_t>(gid) % 16 == 0 && reinterpret_cast<uintptr_t>(mask) % 4 == 0;
  for (int c = 0; c < n_cols; ++c) vec = vec && reinterpret_cast<uintptr_t>(cols[c]) % 16 == 0;
  const int32_t* g = static_cast<const int32_t*>(gid);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const long long* cn = static_cast<const long long*>(counts);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  const bool fold = finish == 0;
  if (smem > 0) {
    if (vec) {
      extremes_kernel<4, true><<<blocks, kThreads, smem, s>>>(a, g, m, n, ng, cn, sc, fold);
    } else {
      extremes_kernel<1, true><<<blocks, kThreads, smem, s>>>(a, g, m, n, ng, cn, sc, fold);
    }
  } else if (vec) {
    extremes_kernel<4, false><<<blocks, kThreads, 0, s>>>(a, g, m, n, ng, cn, sc, fold);
  } else {
    extremes_kernel<1, false><<<blocks, kThreads, 0, s>>>(a, g, m, n, ng, cn, sc, fold);
  }
  if ((err = cudaGetLastError()) != cudaSuccess || fold) return err;
  finish_kernel<<<finish, kFinishThreads, 0, s>>>(a, ng, cn, sc);
  return cudaGetLastError();
}
