// Per-group float32 SUM (and COUNT) of masked values, and the DISTINCTCOUNT
// presence flags of up to eight id columns, in one pass over the docs each.
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
//  * presences: "count > 0" without the sum, for every DISTINCTCOUNT of a
//    query in one pass: up to kMaxCols id columns (each with its own pad)
//    over one mask and one gid (or none: the scalar form, one group).
//
// Presence design. Bound: memory, and at the main path's masks (0.066% of
// the docs on) the bytes are the mask's: the docs run in steps.cuh's step
// loop, a 4-byte mask word a step with kUnroll steps' loads in flight, and a
// step's 16-byte id and group-id loads are issued only where its mask word
// is non-zero. The flags of a block are bits in shared memory, ceil(pad/32)
// 32-bit words a (column, group), set with atomicOr and only after a read
// shows the bit clear (a set bit is never cleared, so the read can only
// skip an atomic that would change nothing): 1 KB at ng 256, pad 32, where
// byte flags took 8 KB, so clearing and flushing them costs a block little.
// The flush ORs each block's non-zero words into one global bit table of
// the call (skipping the atomic where an L2 read shows the bits set), and
// the block that sets a bit first stores its byte of the contract's bool
// (ng, pad) flags, so each byte is stored once. Every block storing the
// bytes of all its bits wrote the same lines from every SM (0.118 ms at
// ng 256 and a 70% mask, 0.027 without any flush); the last block
// expanding the whole table took 0.053 ms at Q4's shape (PERF.md). Past
// the shared memory a block can use, the loop sets byte flags in the output
// directly (a read first, then a plain store). Grid: one wave at most, held
// to n / (8 x flag words) blocks but at least one an SM
// (launch.cuh::pass_blocks). The host plans once per shape (presence_plan);
// a launch makes no runtime query.
//
// Docs with the mask off, or with a group id (or an id) out of range,
// contribute nothing.

#include <cstdint>
#include <initializer_list>

#include <cuda_runtime.h>

#include "launch.cuh"
#include "steps.cuh"

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

constexpr int kMaxCols = 8;
constexpr int kPresenceThreads = 512;

// The id columns of one presence launch. Column j's flags: pad[j] byte
// flags a group in out[j]; in shared memory wpg[j] = ceil(pad[j] / 32) bit
// words a group from word base[j].
struct Presence {
  const int32_t* ids[kMaxCols];
  uint8_t* out[kMaxCols];
  int pad[kMaxCols];
  int wpg[kMaxCols];
  int base[kMaxCols + 1];
  int ncols;
};

template <int V, bool kGrouped, bool kShared>
__global__ void __launch_bounds__(kPresenceThreads)
    presence_kernel(Presence p, const int32_t* __restrict__ gid, const uint8_t* __restrict__ mask, long long n,
                    int ng, unsigned int* __restrict__ table) {
  extern __shared__ unsigned int flags[];
  const int words = p.base[p.ncols];
  if (kShared) {
    for (int w = threadIdx.x; w < words; w += blockDim.x) flags[w] = 0u;
    __syncthreads();
  }
  // the step loop loads the group ids, or in the scalar form column 0's ids
  pinot::for_step_groups<V>(kGrouped ? gid : p.ids[0], mask, n,
                            [&](const long long* d0, const uint32_t* m, const int (*g)[V], bool full) {
    for (int j = 0; j < p.ncols; ++j) {
      int id[pinot::kUnroll][V];
#pragma unroll
      for (int u = 0; u < pinot::kUnroll; ++u) {
        if (m[u] == 0u) continue;
        if (kGrouped || j > 0) {
          pinot::step_values<int32_t, V>(p.ids[j], d0[u], full, id[u]);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) id[u][i] = g[u][i];
        }
      }
      const int pad = p.pad[j];
#pragma unroll
      for (int u = 0; u < pinot::kUnroll; ++u) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if (((m[u] >> (8 * i)) & 0xFFu) == 0u) continue;
          const int grp = kGrouped ? g[u][i] : 0;
          const int x = id[u][i];
          if (grp < 0 || grp >= ng || x < 0 || x >= pad) continue;
          if (kShared) {
            unsigned int* w = flags + p.base[j] + grp * p.wpg[j] + (x >> 5);
            const unsigned int bit = 1u << (x & 31);
            if ((*const_cast<volatile unsigned int*>(w) & bit) == 0u) atomicOr(w, bit);
          } else {
            uint8_t* f = p.out[j] + static_cast<long long>(grp) * pad + x;
            if (!*const_cast<volatile uint8_t*>(f)) *f = 1;
          }
        }
      }
    }
  });
  if (!kShared) return;
  // the flush: this block's bits into the call's global bit table (a read
  // from L2 first, so bits that some block has set cost no atomic); the
  // block whose atomicOr sets a bit first stores its byte, so each byte of
  // the output is stored once
  __syncthreads();
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    const unsigned int bits = flags[w];
    if (bits == 0u || (__ldcg(table + w) & bits) == bits) continue;
    unsigned int fresh = bits & ~atomicOr(table + w, bits);
    if (fresh == 0u) continue;
    int j = 0;
    while (w >= p.base[j + 1]) ++j;
    const int local = w - p.base[j];
    const int grp = local / p.wpg[j];
    uint8_t* row = p.out[j] + static_cast<long long>(grp) * p.pad[j] + (local - grp * p.wpg[j]) * 32;
    while (fresh != 0u) {
      row[__ffs(fresh) - 1] = 1;
      fresh &= fresh - 1u;
    }
  }
}

template <bool kGrouped, bool kShared>
void launch_presence(bool vec, unsigned int blocks, size_t smem, const Presence& p, const int32_t* g,
                     const uint8_t* m, long long n, int ng, unsigned int* table, cudaStream_t s) {
  if (vec) {
    presence_kernel<4, kGrouped, kShared><<<blocks, kPresenceThreads, smem, s>>>(p, g, m, n, ng, table);
  } else {
    presence_kernel<1, kGrouped, kShared><<<blocks, kPresenceThreads, smem, s>>>(p, g, m, n, ng, table);
  }
}

}  // namespace

// 1 when `bytes` of per-block sums (ng * 4) take the shared-memory path on
// the current device, 0 when they take the global path, or a negative CUDA
// error code.
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

// The plan of a presence launch over n docs whose shared flags take `words`
// 32-bit words (ng x the columns' ceil(pad / 32)), grouped or scalar, on
// the current device (launch.cuh::plan_pass, the flag words as the flush
// cells): *smem = words * 4 while they fit a block's shared memory, else 0
// (byte flags in the output); *blocks, the grid (0 when n is 0). Raises
// the form's shared kernels' dynamic shared-memory limit. Returns the CUDA
// error (0 on success).
extern "C" int presence_plan(int grouped, long long words, long long n, int* blocks, int* smem) {
  if (words <= 0 || n < 0) return cudaErrorInvalidValue;
  const size_t bytes = static_cast<size_t>(words) * sizeof(unsigned int);
  long long b = 0;
  const cudaError_t err =
      grouped ? pinot::plan_pass(presence_kernel<4, true, true>, presence_kernel<1, true, true>, kPresenceThreads,
                                 bytes, words, presence_kernel<4, true, false>, kPresenceThreads, 4, n, &b, smem)
              : pinot::plan_pass(presence_kernel<4, false, true>, presence_kernel<1, false, true>, kPresenceThreads,
                                 bytes, words, presence_kernel<4, false, false>, kPresenceThreads, 4, n, &b, smem);
  if (err != cudaSuccess) return err;
  *blocks = static_cast<int>(b);
  return cudaSuccess;
}

// outs[j]: (ng, pads[j]) bytes, zeroed by the caller; receives 1 where a
// masked doc of group g has id i in column j (ids[j]), for ncols <= 8
// columns. gid may be null (ng must then be 1). blocks and smem:
// presence_plan's for this shape on this device. table: smem / 4 32-bit
// words zeroed by the caller where smem > 0 (the bit table), else unused.
// All pointers but the host arrays ids, pads and outs are device pointers.
// Launches on `stream` without synchronising and returns the CUDA error of
// the launch (0 on success).
extern "C" int presences(int ncols, const void* const* ids, const int* pads, const void* gid, const void* mask,
                         long long n, int ng, int blocks, int smem, void* const* outs, void* table, void* stream) {
  if (ncols <= 0 || ncols > kMaxCols || ng <= 0 || n < 0 || blocks < 0 || smem < 0 || (gid == nullptr && ng != 1) ||
      (smem > 0 && table == nullptr))
    return cudaErrorInvalidValue;
  Presence p{};
  p.ncols = ncols;
  long long base = 0;
  bool vec = reinterpret_cast<uintptr_t>(mask) % 4 == 0 && reinterpret_cast<uintptr_t>(gid) % 16 == 0;
  for (int j = 0; j < ncols; ++j) {
    if (pads[j] <= 0) return cudaErrorInvalidValue;
    p.ids[j] = static_cast<const int32_t*>(ids[j]);
    p.out[j] = static_cast<uint8_t*>(outs[j]);
    p.pad[j] = pads[j];
    p.wpg[j] = (pads[j] + 31) / 32;
    p.base[j] = static_cast<int>(base);
    base += static_cast<long long>(ng) * p.wpg[j];
    vec = vec && reinterpret_cast<uintptr_t>(ids[j]) % 16 == 0;
  }
  if (smem > 0 && base * static_cast<long long>(sizeof(unsigned int)) != smem) return cudaErrorInvalidValue;
  p.base[ncols] = smem > 0 ? static_cast<int>(base) : 0;
  if (n == 0 || blocks == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* g = static_cast<const int32_t*>(gid);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const size_t bytes = static_cast<size_t>(smem);
  const unsigned int b = static_cast<unsigned int>(blocks);
  unsigned int* t = static_cast<unsigned int*>(table);
  if (g != nullptr) {
    smem > 0 ? launch_presence<true, true>(vec, b, bytes, p, g, m, n, ng, t, s)
             : launch_presence<true, false>(vec, b, 0, p, g, m, n, ng, t, s);
  } else {
    smem > 0 ? launch_presence<false, true>(vec, b, bytes, p, g, m, n, ng, t, s)
             : launch_presence<false, false>(vec, b, 0, p, g, m, n, ng, t, s);
  }
  return cudaGetLastError();
}
