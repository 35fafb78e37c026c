// Exact per-group SUM of k int32 columns and COUNT of masked docs for group
// counts whose counters do not fit one block's shared memory, with the group
// id split in two levels: gid = hi << L | lo.
//
// Replaces the TPU kernel pinot_tpu/ops/groupby_pallas.py::_make_planes2_kernel
// (launched by _planes2_impl, reached from pallas_grouped_multi_sum under
// PINOT_TPU_PALLAS_V2). That kernel computes the flat kernel's function
// (grouped_sum_count.cu) with gid = hi*128 + lo so that its one-hot matmul
// fills the MXU's 128 rows, and still re-reads every doc chunk once per tile
// of hi values. Neither carries over. On Hopper a block's counters live in
// shared memory, which ends at 227 KB; past that the flat kernel pays k+1
// global 64-bit atomics for every masked doc.
//
// Design: the caller picks L so that the counters of one hi bucket fit one
// block's shared memory ((2k+1) x 2^L 32-bit words; up to 2^14 groups,
// 192 KB, for k = 1, and the package's wrapper takes at most 2^12, since the
// reduce's flush grows with 2^L). Four launches on the caller's stream after
// zeroing the bucket totals:
//   1. histogram: masked in-range docs per hi bucket, counted per block in
//      shared memory; each block writes its row and adds it to the totals;
//   2. scan: exclusive prefix sum of the bucket totals (one block), and a
//      cursor per bucket: its offset, or kDirect for a sparse bucket, one
//      with at most kSparse x 2^L docs for each of its reduce blocks.
//      Folding the scan into the histogram's last block (a ticket after
//      __threadfence) cost the histogram more than the launch it saved:
//      0.0135 ms against 0.0106 + 0.0024 at config 8's shape (PERF.md);
//   3. partition: each block reserves its run in every bucket it touches with
//      one global atomic per (block, bucket), then each masked doc takes a
//      slot of its run. A slot of kDirect or more is a sparse bucket's: the
//      doc adds straight into the output with global 64-bit atomics, no
//      record and no reduce work. Else the doc's record (lo, then its k
//      values, padded for vector stores) goes to its slot, so the docs of
//      one bucket lie together. Passes 1 and 3 run the same one-wave
//      grid-stride loop, so every block meets the same docs in both;
//   4. reduce: a grid of (bucket, chunk) blocks; a dense bucket's block adds
//      its chunk of records into shared counters and flushes the groups it
//      saw once, with global atomics; a sparse bucket's blocks exit.
// Past kMaxSharedBuckets buckets (a small L over a large ng) passes 1 and 3
// count and reserve with global atomics instead.
//
// Shared counters are 32-bit words (steps.cuh's add_wide): the card has no
// 64-bit shared atomic add. A count is one word (a block adds fewer than 2^32
// docs). A sum is two, low and high, with the carry taken from the low
// word's old value. Every add is an integer add exact modulo 2^64, so the
// result does not depend on where the partition placed each doc.
//
// Bound: memory. The docs' group ids and mask are read twice (passes 1 and
// 3; four docs a step with one 16-byte and one 4-byte load where the
// pointers are aligned), the masked docs' values once, a dense bucket's
// records cross the scratch buffer twice (4 + 4k B and padding written, then
// read) and the output is written once. The scratch (N records at most, and
// the bucket tables) is allocated by the caller through torch; nothing here
// allocates.
//
// Weighed and dropped on the card's numbers (H100 80GB HBM3 at 700 W, device
// time alone, config 8's shape: ng 90,112, k = 1, 2.98M masked docs): one
// pass through a thread-block cluster of 8 (or 16) blocks holding the
// counters in distributed shared memory, each doc adding into its owner
// block's slice with remote atomics. It took 0.096-0.112 ms against this
// kernel's 0.078: the remote adds run at about one per four cycles an SM
// (counts alone at k = 0: 2.9M adds in 0.055 ms), whatever the atomics'
// form (generic or PTX .shared::cluster), the block size (512 or 1024
// threads) or the flush (3.5 us of it); PERF.md.
//
// Docs with the mask off, or with a group id outside [0, ng), contribute
// nothing, as in the flat kernel.

#include <atomic>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"
#include "steps.cuh"

namespace {

using pinot::for_steps;
using pinot::taken;

constexpr int kMaxCols = 8;
constexpr int kThreads = 512;
constexpr int kReduceThreads = 1024;
constexpr int kScanThreads = 1024;
// resident blocks of passes 1 and 3 per SM (2048 threads)
constexpr int kBlocksPerSm = 2048 / kThreads;
// buckets whose counts and cursors passes 1 and 3 keep in shared memory
// (48 KB of 32-bit counters: within the default limit, no opt-in)
constexpr int kMaxSharedBuckets = 12288;
// a bucket with at most kSparse x 2^L docs for each of its reduce blocks is
// sparse: the partition adds its docs straight into the output. At config
// 9's shape (14 buckets of ~4,300 docs, 2^L = 4096) that took the kernel
// from 0.0495 to 0.0452 ms; 8 x 2^L turned config 8's buckets (~135k docs)
// sparse too and took it from 0.077 to 0.102 (PERF.md)
constexpr int kSparse = 2;
// the cursor of a sparse bucket, and past it: a record's slot is below
// n <= INT_MAX, so a doc whose cursor add returns kDirect or more is a
// sparse bucket's and goes straight into the output
constexpr unsigned int kDirect = 0x80000000u;
constexpr int kMaxDevices = 64;

struct Cols {
  const int32_t* p[kMaxCols];
};

// Words of a doc's record in the scratch: lo, then its k values, padded to 1,
// 2, 4 or a multiple of 4 words so that it is written and read with vector
// accesses (one store request a doc for k <= 3).
__host__ __device__ constexpr int record_words(int k) { return k < 2 ? k + 1 : (k + 4) / 4 * 4; }

// offsets[b] = totals[0] + ... + totals[b-1], offsets[n_hi] = the total, and
// cursor[b] = offsets[b], or kDirect for a sparse bucket (at most
// sparse_max docs). One block: each thread sums a contiguous run of
// buckets, the block scans the runs' sums, each thread writes its run.
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(const unsigned int* __restrict__ totals, int n_hi, long long sparse_max,
                unsigned int* __restrict__ offsets, unsigned int* __restrict__ cursor) {
  __shared__ unsigned int part[kScanThreads];
  const int t = threadIdx.x;
  const int per = (n_hi + kScanThreads - 1) / kScanThreads;
  const int begin = min(n_hi, t * per);
  const int end = min(n_hi, begin + per);
  unsigned int sum = 0u;
  for (int b = begin; b < end; ++b) sum += totals[b];
  part[t] = sum;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {  // inclusive scan of the runs' sums
    const unsigned int add = t >= off ? part[t - off] : 0u;
    __syncthreads();
    part[t] += add;
    __syncthreads();
  }
  unsigned int run = part[t] - sum;
  for (int b = begin; b < end; ++b) {
    const unsigned int c = totals[b];
    offsets[b] = run;
    cursor[b] = c <= sparse_max ? kDirect : run;
    run += c;
  }
  if (t == kScanThreads - 1) offsets[n_hi] = part[t];
}

template <int V, bool kShared>
__global__ void __launch_bounds__(kThreads)
    histogram_kernel(const int32_t* __restrict__ gid, const uint8_t* __restrict__ mask, long long n, int ng,
                     int bits, int n_hi, unsigned int* __restrict__ totals, unsigned int* __restrict__ per_block) {
  extern __shared__ unsigned int hist[];
  if (kShared) {
    for (int b = threadIdx.x; b < n_hi; b += blockDim.x) hist[b] = 0u;
    __syncthreads();
  }
  unsigned int* count = kShared ? hist : totals;
  for_steps<V>(gid, mask, n, [&](long long, uint32_t m, const int* g, bool) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (taken(m, i, g[i], ng)) atomicAdd(count + (g[i] >> bits), 1u);
    }
  });
  if (kShared) {
    __syncthreads();
    unsigned int* mine = per_block + static_cast<long long>(blockIdx.x) * n_hi;
    for (int b = threadIdx.x; b < n_hi; b += blockDim.x) {
      const unsigned int c = hist[b];
      mine[b] = c;
      if (c != 0u) atomicAdd(totals + b, c);
    }
  }
}

template <int V, bool kShared>
__global__ void __launch_bounds__(kThreads)
    partition_kernel(Cols cols, int k, const int32_t* __restrict__ gid, const uint8_t* __restrict__ mask,
                     long long n, int ng, int bits, int n_hi, const unsigned int* __restrict__ per_block,
                     unsigned int* __restrict__ cursor, int32_t* __restrict__ rec,
                     unsigned long long* __restrict__ out) {
  extern __shared__ unsigned int next[];
  if (kShared) {
    // this block's run in each bucket it touches: one global atomic per
    // bucket (a sparse bucket's returns kDirect or more)
    const unsigned int* mine = per_block + static_cast<long long>(blockIdx.x) * n_hi;
    for (int b = threadIdx.x; b < n_hi; b += blockDim.x) {
      const unsigned int c = mine[b];
      next[b] = c != 0u ? atomicAdd(cursor + b, c) : 0u;
    }
    __syncthreads();
  }
  unsigned int* slots = kShared ? next : cursor;
  const int lo_mask = (1 << bits) - 1;
  const int w = record_words(k);
  unsigned long long* counts = out + static_cast<long long>(k) * ng;
  for_steps<V>(gid, mask, n, [&](long long d0, uint32_t m, const int* g, bool full) {
    // the step's values, loaded before any record is stored (the compiler
    // may not move a load of a column above a store to the scratch)
    int v[kMaxCols][V];
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      if (j >= k) break;
      if (V == 4 && full) {
        const int4 q = reinterpret_cast<const int4*>(cols.p[j])[d0 / 4];
        v[j][0] = q.x;
        v[j][1 % V] = q.y;
        v[j][2 % V] = q.z;
        v[j][3 % V] = q.w;
      } else {
        v[j][0] = cols.p[j][d0];
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (!taken(m, i, g[i], ng)) continue;
      // the lanes of a warp that hit one cursor take neighbouring slots
      const unsigned int pos = atomicAdd(slots + (g[i] >> bits), 1u);
      if (pos >= kDirect) {
        atomicAdd(counts + g[i], 1ULL);
#pragma unroll
        for (int j = 0; j < kMaxCols; ++j) {
          if (j >= k) break;
          atomicAdd(out + static_cast<long long>(j) * ng + g[i],
                    static_cast<unsigned long long>(static_cast<long long>(v[j][i])));
        }
        continue;
      }
      int32_t* r = rec + static_cast<long long>(pos) * w;
      const int lo = g[i] & lo_mask;
      if (w == 1) {
        r[0] = lo;
      } else if (w == 2) {
        *reinterpret_cast<int2*>(r) = make_int2(lo, v[0][i]);
      } else {
#pragma unroll
        for (int q = 0; q < record_words(kMaxCols); q += 4) {
          if (q >= w) break;
          int x[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = q + e;  // a constant once unrolled, so v stays in registers
            x[e] = c == 0 ? lo : (c <= k ? v[min(c - 1, kMaxCols - 1)][i] : 0);
          }
          *reinterpret_cast<int4*>(r + q) = make_int4(x[0], x[1], x[2], x[3]);
        }
      }
    }
  });
}

// Calls f(l, j, v) for column j's value v of the w-word record at r, after
// f(l, -1, 0) for its count; l is the record's lo.
template <typename F>
__device__ __forceinline__ void read_record(const int32_t* __restrict__ r, int k, int w, F&& f) {
  if (w == 1) {
    f(r[0], -1, 0);
  } else if (w == 2) {
    const int2 x = *reinterpret_cast<const int2*>(r);
    f(x.x, -1, 0);
    f(x.x, 0, x.y);
  } else {
    int l = 0;
    for (int q = 0; q < w; q += 4) {
      const int4 v = *reinterpret_cast<const int4*>(r + q);
      const int x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = q + e;
        if (i == 0) {
          l = x[0];
          f(l, -1, 0);
        } else if (i <= k) {
          f(l, i - 1, x[e]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kReduceThreads)
    reduce_kernel(int k, const int32_t* __restrict__ rec, const unsigned int* __restrict__ offsets, int bits,
                  int chunks, long long sparse_max, int ng, unsigned long long* __restrict__ out) {
  // 2^L counts, then a low and a high word per column: (2k+1) x 2^L words
  extern __shared__ unsigned int acc[];
  const int bucket = blockIdx.x / chunks;
  const int chunk = blockIdx.x - bucket * chunks;
  const long long first = offsets[bucket];
  const long long end = offsets[bucket + 1];
  // the same for every thread of the block: a sparse bucket's docs went
  // into the output in the partition, or nothing of this bucket is left
  if (end - first <= sparse_max) return;
  const long long begin = first + static_cast<long long>(chunk) * blockDim.x;
  if (begin >= end) return;
  const int width = 1 << bits;
  const int w = record_words(k);
  const long long base = static_cast<long long>(bucket) << bits;
  const long long step = static_cast<long long>(chunks) * blockDim.x;
  unsigned long long* counts = out + static_cast<long long>(k) * ng;

  const int words = (2 * k + 1) * width;
  for (int c = threadIdx.x; c < words; c += blockDim.x) acc[c] = 0u;
  __syncthreads();
  for (long long i = begin + threadIdx.x; i < end; i += step) {
    read_record(rec + i * w, k, w, [&](int l, int j, int v) {
      if (j < 0) {
        atomicAdd(acc + l, 1u);
        return;
      }
      unsigned int* low = acc + (1 + 2 * j) * width + l;
      pinot::add_wide(low, low + width, v);
    });
  }
  __syncthreads();
  for (int c = threadIdx.x; c < width; c += blockDim.x) {
    const unsigned int n_c = acc[c];
    if (n_c == 0u) continue;  // no doc of this block in group c, so every sum is 0 too
    const long long g = base + c;
    atomicAdd(counts + g, static_cast<unsigned long long>(n_c));
    for (int j = 0; j < k; ++j) {
      const unsigned int* low = acc + (1 + 2 * j) * width + c;
      const unsigned long long v = pinot::wide(low[0], low[width]);
      if (v != 0ULL) atomicAdd(out + static_cast<long long>(j) * ng + g, v);
    }
  }
}

// What one device gives the launches: its SM count and the shared memory a
// block may opt into; the reduce kernel's dynamic shared-memory limit is
// raised to the latter once per device.
struct Device {
  int sms;
  int limit;
};

cudaError_t device(Device* out) {
  // a device's SM count is published last, after its limit and attribute
  static std::atomic<int> seen_sms[kMaxDevices];
  static int seen_limit[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices) {
    const int sms = seen_sms[dev].load(std::memory_order_acquire);
    if (sms > 0) {
      *out = Device{sms, seen_limit[dev]};
      return cudaSuccess;
    }
  }
  Device d{};
  if ((err = pinot::device_shape(&d.sms, &d.limit)) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, d.limit);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices) {
    seen_limit[dev] = d.limit;
    seen_sms[dev].store(d.sms, std::memory_order_release);
  }
  *out = d;
  return cudaSuccess;
}

// Offsets into the scratch buffer, in 32-bit words, each table aligned to 16
// bytes, and the grids.
struct Plan {
  int n_hi;
  bool shared_hist;
  unsigned int blocks;  // grid of passes 1 and 3
  int chunks;           // reduce blocks per bucket
  long long sparse_max;  // a bucket with at most this many docs is sparse
  size_t reduce_smem;
  long long totals, offsets, cursor, per_block, rec, words;
};

long long align4(long long words) { return (words + 3) & ~3LL; }

size_t reduce_bytes(int k, int bits) { return static_cast<size_t>(2 * k + 1) * sizeof(unsigned int) << bits; }

cudaError_t make_plan(int k, long long n, int ng, int bits, Plan* p) {
  Device dev;
  const cudaError_t err = device(&dev);
  if (err != cudaSuccess) return err;
  p->reduce_smem = reduce_bytes(k, bits);
  if (p->reduce_smem > static_cast<size_t>(dev.limit)) return cudaErrorInvalidValue;
  p->n_hi = static_cast<int>((static_cast<long long>(ng) + (1LL << bits) - 1) >> bits);
  p->shared_hist = p->n_hi <= kMaxSharedBuckets;
  // one wave: passes 1 and 3 need at most 48 KB of shared memory a block
  const long long needed = (n + 4LL * kThreads - 1) / (4LL * kThreads);
  const long long wave = static_cast<long long>(dev.sms) * kBlocksPerSm;
  p->blocks = static_cast<unsigned int>(needed < 1 ? 1 : (needed < wave ? needed : wave));
  // reduce: at most one block per SM in all, and at least one a bucket
  const long long chunks = dev.sms / p->n_hi;
  p->chunks = static_cast<int>(chunks < 1 ? 1 : chunks);
  if (static_cast<long long>(p->n_hi) * p->chunks > INT_MAX) return cudaErrorInvalidValue;
  p->sparse_max = static_cast<long long>(p->chunks) * kSparse << bits;

  long long w = 0;
  p->totals = w;
  w = align4(w + p->n_hi);
  p->offsets = w;
  w = align4(w + p->n_hi + 1);
  p->cursor = w;
  w = align4(w + p->n_hi);
  p->per_block = w;
  w = align4(w + (p->shared_hist ? static_cast<long long>(p->blocks) * p->n_hi : 0));
  p->rec = w;
  p->words = align4(w + static_cast<long long>(record_words(k)) * n);
  return cudaSuccess;
}

bool valid(int k, long long n, int ng, int bits) {
  return k >= 0 && k <= kMaxCols && ng > 0 && n >= 0 && n <= INT_MAX && bits >= 0 && bits <= 30;
}

template <int V, bool kShared>
void launch_passes(const Plan& p, Cols cols, int k, const int32_t* g, const uint8_t* m, long long n, int ng,
                   int bits, unsigned int* totals, unsigned int* offsets, unsigned int* cursor,
                   unsigned int* per_block, int32_t* rec, unsigned long long* o, cudaStream_t s) {
  const size_t smem = kShared ? static_cast<size_t>(p.n_hi) * sizeof(unsigned int) : 0;
  histogram_kernel<V, kShared><<<p.blocks, kThreads, smem, s>>>(g, m, n, ng, bits, p.n_hi, totals, per_block);
  scan_kernel<<<1, kScanThreads, 0, s>>>(totals, p.n_hi, p.sparse_max, offsets, cursor);
  partition_kernel<V, kShared><<<p.blocks, kThreads, smem, s>>>(cols, k, g, m, n, ng, bits, p.n_hi, per_block,
                                                                cursor, rec, o);
}

}  // namespace

// The opt-in dynamic shared memory a block of the current device can use, in
// bytes, or a negative CUDA error code. The caller picks L from it.
extern "C" int grouped_sum_count_2l_shared_limit() {
  Device dev;
  const cudaError_t err = device(&dev);
  return err == cudaSuccess ? dev.limit : -static_cast<int>(err);
}

// Bytes of scratch grouped_sum_count_2l needs for (k, n, ng, bits) on the
// current device, into *bytes. Returns the CUDA error (0 on success).
extern "C" int grouped_sum_count_2l_scratch(int k, long long n, int ng, int bits, long long* bytes) {
  if (!valid(k, n, ng, bits)) return cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = make_plan(k, n, ng, bits, &p);
  if (err != cudaSuccess) return err;
  *bytes = p.words * static_cast<long long>(sizeof(unsigned int));
  return cudaSuccess;
}

// The most masked in-range docs a hi bucket may hold and still be sparse
// (its docs added straight into the output by the partition) for (k, n, ng,
// bits) on the current device, into *docs. Returns the CUDA error (0 on
// success).
extern "C" int grouped_sum_count_2l_sparse_max(int k, long long n, int ng, int bits, long long* docs) {
  if (!valid(k, n, ng, bits)) return cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = make_plan(k, n, ng, bits, &p);
  if (err != cudaSuccess) return err;
  *docs = p.sparse_max;
  return cudaSuccess;
}

// out: (k+1, ng) int64, zeroed by the caller; rows 0..k-1 receive the sums of
// values[0..k-1], row k the counts. bits is L. scratch: a device buffer of at
// least grouped_sum_count_2l_scratch's bytes. All pointers are device
// pointers; values is a host array of k device pointers. Launches on `stream`
// without synchronising and returns the CUDA error of the launches (0 on
// success).
extern "C" int grouped_sum_count_2l(const void* const* values, int k, const void* gid, const void* mask,
                                    long long n, int ng, int bits, void* scratch, long long scratch_bytes,
                                    void* out, void* stream) {
  if (!valid(k, n, ng, bits)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  Plan p;
  cudaError_t err = make_plan(k, n, ng, bits, &p);
  if (err != cudaSuccess) return err;
  if (scratch_bytes < p.words * static_cast<long long>(sizeof(unsigned int))) return cudaErrorInvalidValue;
  Cols cols{};
  for (int j = 0; j < k; ++j) cols.p[j] = static_cast<const int32_t*>(values[j]);

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* g = static_cast<const int32_t*>(gid);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  unsigned int* words = static_cast<unsigned int*>(scratch);
  unsigned int* totals = words + p.totals;
  unsigned int* offsets = words + p.offsets;
  unsigned int* cursor = words + p.cursor;
  unsigned int* per_block = words + p.per_block;
  int32_t* rec = reinterpret_cast<int32_t*>(words + p.rec);
  unsigned long long* o = static_cast<unsigned long long*>(out);

  if ((err = cudaMemsetAsync(totals, 0, static_cast<size_t>(p.n_hi) * sizeof(unsigned int), s)) != cudaSuccess)
    return err;
  // four docs a step where group ids and values allow 16-byte loads and the
  // mask 4-byte ones
  bool vec = reinterpret_cast<uintptr_t>(gid) % 16 == 0 && reinterpret_cast<uintptr_t>(mask) % 4 == 0;
  for (int j = 0; j < k; ++j) vec = vec && reinterpret_cast<uintptr_t>(values[j]) % 16 == 0;
  if (vec && p.shared_hist) {
    launch_passes<4, true>(p, cols, k, g, m, n, ng, bits, totals, offsets, cursor, per_block, rec, o, s);
  } else if (vec) {
    launch_passes<4, false>(p, cols, k, g, m, n, ng, bits, totals, offsets, cursor, per_block, rec, o, s);
  } else if (p.shared_hist) {
    launch_passes<1, true>(p, cols, k, g, m, n, ng, bits, totals, offsets, cursor, per_block, rec, o, s);
  } else {
    launch_passes<1, false>(p, cols, k, g, m, n, ng, bits, totals, offsets, cursor, per_block, rec, o, s);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  reduce_kernel<<<p.n_hi * p.chunks, kReduceThreads, p.reduce_smem, s>>>(k, rec, offsets, bits, p.chunks,
                                                                         p.sparse_max, ng, o);
  return cudaGetLastError();
}
