// Per-group MIN or MAX of masked values, in one pass over the docs.
//
// Replaces the TPU kernel pinot_tpu/ops/groupby_pallas.py::_make_extreme_kernel
// (launched by _grouped_extreme_impl, reached from pallas_grouped_min/max).
// That kernel builds a (CHUNK, group-tile) one-hot select per grid step and
// reduces its columns on the VPU, re-reading every doc chunk once per group
// tile. Hopper has no use for the one-hot: a block reads each doc once and
// updates its group's slot with an integer atomic.
//
// Order-preserving keys. Each value maps to an unsigned integer key whose
// unsigned order is the value's order, so integer atomicMin/atomicMax give the
// value's MIN/MAX:
//   int32   v ^ 0x80000000
//   float / double  bits | sign when the sign bit is clear, ~bits when set
// -0.0 orders below +0.0. NaN maps to key 0 for MIN and to the largest key for
// MAX, so a masked NaN wins both ways, as jnp.min/jnp.minimum and XLA's
// segment_min/segment_max propagate it; both keys map back to a NaN.
//
// Bound: memory. The pass reads N * (4 gid + 1 mask + sizeof(T) value) bytes
// and writes ng outputs; the work is one compare (and rarely an atomic) per
// masked doc. Each block keeps ng keys in dynamic shared memory, reads a slot
// before its atomic and skips the atomic when the slot already holds a better
// key (after a few docs per group almost every doc skips it, which is what
// keeps heavy contention at small ng cheap), and flushes the keys that moved
// to global keys with global atomics once at the end. The grid is one wave of
// resident blocks. Past the shared memory a block can use the same loop
// updates the global keys directly (they land in the 50 MB L2).
//
// Three launches per call on the caller's stream: fill the global keys with
// the identity, the pass, and a finish that maps keys back to values (and, for
// int32, writes +-inf where the caller's per-group counts are 0, since
// INT32_MIN and INT32_MAX are real values). Docs with the mask off, or with a
// group id outside [0, ng), contribute nothing.

#include <cstdint>
#include <limits>

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kSmallThreads = 256;

template <typename T>
struct Ord;

template <>
struct Ord<int32_t> {
  using Key = unsigned int;
  using Out = double;
  static constexpr Key kLow = 0u;  // INT32_MIN
  static constexpr Key kHigh = 0xFFFFFFFFu;  // INT32_MAX
  __device__ static Key key(int32_t v, bool) { return static_cast<Key>(v) ^ 0x80000000u; }
  __device__ static int32_t value(Key k) { return static_cast<int32_t>(k ^ 0x80000000u); }
};

template <>
struct Ord<float> {
  using Key = unsigned int;
  using Out = float;
  static constexpr Key kLow = 0x007FFFFFu;  // -inf
  static constexpr Key kHigh = 0xFF800000u;  // +inf
  __device__ static Key key(float v, bool is_min) {
    if (v != v) return is_min ? 0u : 0xFFFFFFFFu;
    const Key b = __float_as_uint(v);
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  }
  __device__ static float value(Key k) {
    return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
  }
};

template <>
struct Ord<double> {
  using Key = unsigned long long;
  using Out = double;
  static constexpr Key kLow = 0x000FFFFFFFFFFFFFull;  // -inf
  static constexpr Key kHigh = 0xFFF0000000000000ull;  // +inf
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

// the key MIN starts from (the type's largest value) and MAX's (its smallest)
template <typename T>
__host__ __device__ constexpr typename Ord<T>::Key identity(bool is_min) {
  return is_min ? Ord<T>::kHigh : Ord<T>::kLow;
}

template <bool kMin, typename Key>
__device__ __forceinline__ void improve(Key* slot, Key k) {
  // a plain read first: once the slot holds a better key the atomic is skipped
  const Key cur = *const_cast<volatile Key*>(slot);
  if (kMin ? (k < cur) : (k > cur)) {
    if (kMin) {
      atomicMin(slot, k);
    } else {
      atomicMax(slot, k);
    }
  }
}

template <typename T, bool kMin, bool kShared>
__global__ void __launch_bounds__(kThreads)
    extreme_kernel(const T* __restrict__ values, const int32_t* __restrict__ gid,
                   const uint8_t* __restrict__ mask, long long n, int ng,
                   typename Ord<T>::Key* keys) {
  using Key = typename Ord<T>::Key;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr Key kIdentity = identity<T>(kMin);
  Key* acc = kShared ? reinterpret_cast<Key*>(smem_raw) : keys;
  if (kShared) {
    for (int i = threadIdx.x; i < ng; i += blockDim.x) acc[i] = kIdentity;
    __syncthreads();
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long d = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; d < n;
       d += stride) {
    if (!mask[d]) continue;
    const int g = gid[d];
    if (g < 0 || g >= ng) continue;
    improve<kMin>(acc + g, Ord<T>::key(values[d], kMin));
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < ng; i += blockDim.x) {
      const Key k = acc[i];
      if (k != kIdentity) improve<kMin>(keys + i, k);
    }
  }
}

template <typename Key>
__global__ void fill_kernel(Key* keys, int ng, Key value) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < ng) keys[g] = value;
}

// keys -> values; where `counts` is given, a group with count 0 gets `empty`
template <typename T>
__global__ void finish_kernel(const typename Ord<T>::Key* __restrict__ keys, int ng,
                              const long long* __restrict__ counts, double empty,
                              typename Ord<T>::Out* __restrict__ out) {
  using Out = typename Ord<T>::Out;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= ng) return;
  out[g] = (counts != nullptr && counts[g] == 0) ? static_cast<Out>(empty)
                                                  : static_cast<Out>(Ord<T>::value(keys[g]));
}

template <typename T, bool kMin>
cudaError_t run(const void* values, const void* gid, const void* mask, long long n, int ng,
                const void* counts, void* keys, void* out, cudaStream_t s) {
  using Key = typename Ord<T>::Key;
  Key* k = static_cast<Key*>(keys);
  const unsigned int small_blocks = static_cast<unsigned int>((ng + kSmallThreads - 1) / kSmallThreads);
  fill_kernel<Key><<<small_blocks, kSmallThreads, 0, s>>>(k, ng, identity<T>(kMin));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (n > 0) {
    const size_t smem = static_cast<size_t>(ng) * sizeof(Key);
    const int shared = pinot::fits_shared(smem);
    if (shared < 0) return static_cast<cudaError_t>(-shared);
    unsigned int blocks = 0;
    const T* v = static_cast<const T*>(values);
    const int32_t* g = static_cast<const int32_t*>(gid);
    const uint8_t* m = static_cast<const uint8_t*>(mask);
    if (shared == 1) {
      err = pinot::one_wave(extreme_kernel<T, kMin, true>, kThreads, smem, n, &blocks);
      if (err != cudaSuccess) return err;
      extreme_kernel<T, kMin, true><<<blocks, kThreads, smem, s>>>(v, g, m, n, ng, k);
    } else {
      err = pinot::one_wave(extreme_kernel<T, kMin, false>, kThreads, 0, n, &blocks);
      if (err != cudaSuccess) return err;
      extreme_kernel<T, kMin, false><<<blocks, kThreads, 0, s>>>(v, g, m, n, ng, k);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const double inf = std::numeric_limits<double>::infinity();
  const double empty = kMin ? inf : -inf;
  finish_kernel<T><<<small_blocks, kSmallThreads, 0, s>>>(
      k, ng, static_cast<const long long*>(counts), empty, static_cast<typename Ord<T>::Out*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_either(int is_min, const void* values, const void* gid, const void* mask,
                       long long n, int ng, const void* counts, void* keys, void* out,
                       cudaStream_t s) {
  return is_min ? run<T, true>(values, gid, mask, n, ng, counts, keys, out, s)
                : run<T, false>(values, gid, mask, n, ng, counts, keys, out, s);
}

}  // namespace

// 1 when ng keys of `key_bytes` each take the shared-memory path on the
// current device, 0 when they take the global-atomics path, or a negative
// CUDA error code.
extern "C" int grouped_extreme_uses_shared(int key_bytes, int ng) {
  return pinot::fits_shared(static_cast<size_t>(key_bytes) * static_cast<size_t>(ng));
}

// dtype: 0 float32 values -> float32 out; 1 int32 values -> float64 out, with
// counts (int64, ng) required; 2 float64 values -> float64 out. keys: ng
// scratch keys (4 bytes for dtypes 0 and 1, 8 for 2). counts may be null for
// dtypes 0 and 2. All pointers are device pointers. Launches on `stream`
// without synchronising and returns the first CUDA error (0 on success).
extern "C" int grouped_extreme(int dtype, int is_min, const void* values, const void* gid,
                               const void* mask, long long n, int ng, const void* counts,
                               void* keys, void* out, void* stream) {
  if (ng <= 0 || n < 0 || (dtype == 1 && counts == nullptr)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return run_either<float>(is_min, values, gid, mask, n, ng, counts, keys, out, s);
    case 1:
      return run_either<int32_t>(is_min, values, gid, mask, n, ng, counts, keys, out, s);
    case 2:
      return run_either<double>(is_min, values, gid, mask, n, ng, counts, keys, out, s);
    default:
      return cudaErrorInvalidValue;
  }
}
