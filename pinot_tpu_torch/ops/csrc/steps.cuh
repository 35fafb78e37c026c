// Device helpers shared by the package's one-pass group-by kernels
// (grouped_sum_count.cu, grouped_sum_count_2l.cu, grouped_extreme.cu): the
// step loop over the docs and a step's value loads, the test of whether a
// doc is taken, and the exact 64-bit add into a pair of 32-bit shared words.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace pinot {

constexpr int kUnroll = 4;  // steps whose loads a thread issues together

// Calls f(d0, m, g, full) for each group of kUnroll steps of this block's
// share: step u covers docs d0[u] .. d0[u]+V-1, their mask bytes in m[u]
// (byte i for doc d0[u]+i; 0 where the step has no doc to take, and then
// its group ids are not loaded) and group ids in g[u]. V docs a step (V = 4:
// one 16-byte load of group ids and one 4-byte load of mask bytes, so gid
// must be 16-byte and mask 4-byte aligned), neighbouring threads on
// neighbouring steps, the group's loads issued together. The last n % V docs
// are groups of one one-doc step (full = false) on the first threads of
// block 0. The docs a block meets depend on the grid alone, so two passes on
// one grid meet the same ones.
template <int V, typename F>
__device__ __forceinline__ void for_step_groups(const int32_t* __restrict__ gid, const uint8_t* __restrict__ mask,
                                                long long n, F&& f) {
  const long long steps = n / V;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long s0 = t; s0 < steps; s0 += kUnroll * stride) {
    long long d0[kUnroll];
    uint32_t m[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long s = s0 + u * stride;
      d0[u] = s * V;
      m[u] = s >= steps ? 0u : (V == 4 ? reinterpret_cast<const uint32_t*>(mask)[s] : mask[s]);
    }
    int g[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (m[u] == 0u) continue;
      if constexpr (V == 4) {
        const int4 q = reinterpret_cast<const int4*>(gid)[d0[u] / 4];
        g[u][0] = q.x;
        g[u][1] = q.y;
        g[u][2] = q.z;
        g[u][3] = q.w;
      } else {
        g[u][0] = gid[d0[u]];
      }
    }
    f(d0, m, g, true);
  }
  if (V > 1 && t < n - steps * V) {
    long long d0[kUnroll] = {steps * V + t};
    uint32_t m[kUnroll] = {};
    int g[kUnroll][V] = {};
    g[0][0] = gid[d0[0]];
    m[0] = mask[d0[0]] ? 1u : 0u;
    if (m[0] != 0u) f(d0, m, g, false);
  }
}

// Calls f(d0, m, g, full) for each step of for_step_groups' groups that has
// a mask byte on.
template <int V, typename F>
__device__ __forceinline__ void for_steps(const int32_t* __restrict__ gid, const uint8_t* __restrict__ mask,
                                          long long n, F&& f) {
  for_step_groups<V>(gid, mask, n, [&](const long long* d0, const uint32_t* m, const int (*g)[V], bool full) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (m[u] != 0u) f(d0[u], m[u], g[u], full);
    }
  });
}

template <typename T>
__device__ __forceinline__ T from_bits(unsigned int w);
template <>
__device__ __forceinline__ float from_bits<float>(unsigned int w) {
  return __uint_as_float(w);
}
template <>
__device__ __forceinline__ int32_t from_bits<int32_t>(unsigned int w) {
  return static_cast<int32_t>(w);
}

// A step's values of one column (int32, float or double): four with 16-byte
// loads in a full 4-doc step (the column 16-byte aligned), else the step's
// one doc.
template <typename T, int V>
__device__ __forceinline__ void step_values(const T* __restrict__ col, long long d0, bool full, T (&v)[V]) {
  if constexpr (V == 4) {
    if (full) {
      if constexpr (sizeof(T) == 4) {
        const uint4 q = reinterpret_cast<const uint4*>(col)[d0 / 4];
        v[0] = from_bits<T>(q.x);
        v[1] = from_bits<T>(q.y);
        v[2] = from_bits<T>(q.z);
        v[3] = from_bits<T>(q.w);
      } else {
        const double2 a = reinterpret_cast<const double2*>(col)[d0 / 2];
        const double2 b = reinterpret_cast<const double2*>(col)[d0 / 2 + 1];
        v[0] = a.x;
        v[1] = a.y;
        v[2] = b.x;
        v[3] = b.y;
      }
      return;
    }
  }
  v[0] = col[d0];
}

// Whether doc i of a step is taken: its mask byte is on and its group id in [0, ng).
__device__ __forceinline__ bool taken(uint32_t m, int i, int g, int ng) {
  return ((m >> (8 * i)) & 0xFFu) != 0u && g >= 0 && g < ng;
}

// Adds s into the 64-bit sum held as a low and a high 32-bit shared word
// (the card has no 64-bit shared atomic add: nvcc emits a compare-and-swap
// loop for one). The add into the low word returns its old value, so the
// adding thread knows whether its add wrapped and carries one into the high
// word, together with s's high half. Every add is exact modulo 2^64, in any
// order.
__device__ __forceinline__ void add_wide(unsigned int* low, unsigned int* high, long long s) {
  const unsigned long long u = static_cast<unsigned long long>(s);
  const unsigned int lo = static_cast<unsigned int>(u);
  const unsigned int old = atomicAdd(low, lo);
  const unsigned int hi = static_cast<unsigned int>(u >> 32) + (old + lo < old ? 1u : 0u);
  if (hi != 0u) atomicAdd(high, hi);
}

// The 64-bit value a low and a high word hold.
__device__ __forceinline__ unsigned long long wide(unsigned int low, unsigned int high) {
  return static_cast<unsigned long long>(high) << 32 | low;
}

}  // namespace pinot
