// pinot_tpu_torch native host library: the host code of the segment store
// and the host runtime.
//
// The JAX package's pinot_tpu/native/csrc/pinot_native.cpp, copied function
// for function, so a segment file written by either package decodes in the
// other and every function gives the other package's bits:
//   - fixed-bit forward-index pack/unpack   (FixedBitSVForwardIndexReaderV2)
//   - chunk codec (LZ4 block format)        (ChunkCompressionType LZ4)
//   - dense bitmap algebra                  (RoaringBitmap BitmapCollection.java:31)
//   - HLL register updates                  (DistinctCountHLL aggregation)
//   - masked / grouped aggregation loops    (DefaultGroupByExecutor.java:191)
//   - hashing + crc32 integrity             (DataTable serde, segment files)
//   - zstd / zlib / snappy, dlopen'd when the host has them
//
// The device path is torch and the CUDA kernels of ops/csrc/; this library
// serves the HOST: segment file IO (pack/compress on build, unpack on load
// before the copy to the card), host-side execution, wire serde and
// ingestion.
//
// All entry points are extern "C", operate on caller-owned buffers, and are
// bound from Python via ctypes (pinot_tpu_torch/native/__init__.py). No
// exceptions across the boundary. Built with g++ at first use.

#include <cstdint>
#include <cstring>
#include <cmath>

#if defined(_MSC_VER)
#define PT_EXPORT extern "C" __declspec(dllexport)
#else
#define PT_EXPORT extern "C" __attribute__((visibility("default")))
#endif

// ---------------------------------------------------------------------------
// fixed-bit packing (LSB-first within little-endian uint64 words)
// ---------------------------------------------------------------------------

PT_EXPORT int64_t pt_bitpack_words(int64_t n, int32_t bits) {
  if (bits <= 0) return 0;
  return (n * (int64_t)bits + 63) / 64;
}

PT_EXPORT void pt_bitpack32(const uint32_t* in, int64_t n, int32_t bits,
                            uint64_t* out) {
  int64_t nwords = pt_bitpack_words(n, bits);
  std::memset(out, 0, (size_t)nwords * 8);
  const uint64_t m = (bits >= 64) ? ~0ull : ((1ull << bits) - 1);
  for (int64_t i = 0; i < n; i++) {
    uint64_t v = (uint64_t)in[i] & m;
    int64_t bit = i * bits;
    int64_t w = bit >> 6;
    int off = (int)(bit & 63);
    out[w] |= v << off;
    if (off + bits > 64) out[w + 1] |= v >> (64 - off);
  }
}

PT_EXPORT void pt_bitunpack32(const uint64_t* in, int64_t n, int32_t bits,
                              uint32_t* out) {
  if (bits == 0) {
    std::memset(out, 0, (size_t)n * 4);
    return;
  }
  const uint64_t m = (bits >= 64) ? ~0ull : ((1ull << bits) - 1);
  for (int64_t i = 0; i < n; i++) {
    int64_t bit = i * bits;
    int64_t w = bit >> 6;
    int off = (int)(bit & 63);
    uint64_t v = in[w] >> off;
    if (off + bits > 64) v |= in[w + 1] << (64 - off);
    out[i] = (uint32_t)(v & m);
  }
}

// ---------------------------------------------------------------------------
// LZ4 block format codec (clean-room implementation of the public format:
// token(4b literal len | 4b match len-4), literal-length extension bytes,
// literals, 2-byte LE offset, match-length extension bytes)
// ---------------------------------------------------------------------------

static const int LZ4_MIN_MATCH = 4;
static const int LZ4_HASH_LOG = 16;

static inline uint32_t lz4_read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

static inline uint32_t lz4_hash(uint32_t v) {
  return (v * 2654435761u) >> (32 - LZ4_HASH_LOG);
}

PT_EXPORT int64_t pt_lz4_compress_bound(int64_t n) {
  return n + n / 255 + 16;
}

// Greedy single-pass LZ4 block compressor. Returns compressed size, or -1 if
// dst capacity is insufficient.
PT_EXPORT int64_t pt_lz4_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                                  int64_t cap) {
  if (n < 0 || cap < pt_lz4_compress_bound(0)) return -1;
  uint8_t* op = dst;
  uint8_t* const op_end = dst + cap;
  const uint8_t* ip = src;
  const uint8_t* anchor = src;
  const uint8_t* const iend = src + n;
  // spec: last match must start >=12 bytes before end; last 5 bytes literals
  const uint8_t* const mflimit = (n >= 13) ? iend - 12 : src;

  int32_t table[1 << LZ4_HASH_LOG];
  for (auto& t : table) t = -1;

  if (n >= 13) {
    while (ip < mflimit) {
      uint32_t h = lz4_hash(lz4_read32(ip));
      int64_t cand = table[h];
      table[h] = (int32_t)(ip - src);
      if (cand >= 0 && (ip - src) - cand <= 65535 &&
          lz4_read32(src + cand) == lz4_read32(ip)) {
        // extend match forward
        const uint8_t* match = src + cand;
        const uint8_t* mp = match + 4;
        const uint8_t* p = ip + 4;
        const uint8_t* matchlimit = iend - 5;
        while (p < matchlimit && *p == *mp) {
          p++;
          mp++;
        }
        int64_t mlen = (p - ip) - LZ4_MIN_MATCH;
        int64_t llen = ip - anchor;
        // emit sequence
        int64_t need = 1 + llen + llen / 255 + 2 + mlen / 255 + 1 + 8;
        if (op + need > op_end) return -1;
        uint8_t* token = op++;
        if (llen >= 15) {
          *token = 15 << 4;
          int64_t l = llen - 15;
          for (; l >= 255; l -= 255) *op++ = 255;
          *op++ = (uint8_t)l;
        } else {
          *token = (uint8_t)(llen << 4);
        }
        std::memcpy(op, anchor, (size_t)llen);
        op += llen;
        uint16_t offset = (uint16_t)(ip - match);
        *op++ = (uint8_t)offset;
        *op++ = (uint8_t)(offset >> 8);
        if (mlen >= 15) {
          *token |= 15;
          int64_t l = mlen - 15;
          for (; l >= 255; l -= 255) *op++ = 255;
          *op++ = (uint8_t)l;
        } else {
          *token |= (uint8_t)mlen;
        }
        ip = p;
        anchor = ip;
      } else {
        ip++;
      }
    }
  }
  // trailing literals
  int64_t llen = iend - anchor;
  int64_t need = 1 + llen + llen / 255 + 1;
  if (op + need > op_end) return -1;
  uint8_t* token = op++;
  if (llen >= 15) {
    *token = 15 << 4;
    int64_t l = llen - 15;
    for (; l >= 255; l -= 255) *op++ = 255;
    *op++ = (uint8_t)l;
  } else {
    *token = (uint8_t)(llen << 4);
  }
  std::memcpy(op, anchor, (size_t)llen);
  op += llen;
  return op - dst;
}

// LZ4 block decompressor. Returns decompressed size, or -1 on malformed input
// / capacity overflow.
PT_EXPORT int64_t pt_lz4_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                                    int64_t cap) {
  const uint8_t* ip = src;
  const uint8_t* const iend = src + n;
  uint8_t* op = dst;
  uint8_t* const oend = dst + cap;
  while (ip < iend) {
    uint8_t token = *ip++;
    // literals
    int64_t llen = token >> 4;
    if (llen == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        llen += b;
      } while (b == 255);
    }
    if (ip + llen > iend || op + llen > oend) return -1;
    std::memcpy(op, ip, (size_t)llen);
    ip += llen;
    op += llen;
    if (ip >= iend) break;  // last sequence is literals-only
    // match
    if (ip + 2 > iend) return -1;
    uint16_t offset = (uint16_t)(ip[0] | (ip[1] << 8));
    ip += 2;
    if (offset == 0 || op - dst < offset) return -1;
    int64_t mlen = (token & 15) + LZ4_MIN_MATCH;
    if ((token & 15) == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        mlen += b;
      } while (b == 255);
    }
    if (op + mlen > oend) return -1;
    const uint8_t* match = op - offset;
    // byte-wise copy: overlapping matches replicate
    for (int64_t i = 0; i < mlen; i++) op[i] = match[i];
    op += mlen;
  }
  return op - dst;
}

// ---------------------------------------------------------------------------
// dense bitmap algebra (uint64 words, bit i of word w = doc w*64+i)
// ---------------------------------------------------------------------------

PT_EXPORT void pt_bm_and(const uint64_t* a, const uint64_t* b, uint64_t* out,
                         int64_t nwords) {
  for (int64_t i = 0; i < nwords; i++) out[i] = a[i] & b[i];
}

PT_EXPORT void pt_bm_or(const uint64_t* a, const uint64_t* b, uint64_t* out,
                        int64_t nwords) {
  for (int64_t i = 0; i < nwords; i++) out[i] = a[i] | b[i];
}

PT_EXPORT void pt_bm_andnot(const uint64_t* a, const uint64_t* b, uint64_t* out,
                            int64_t nwords) {
  for (int64_t i = 0; i < nwords; i++) out[i] = a[i] & ~b[i];
}

PT_EXPORT void pt_bm_not(const uint64_t* a, uint64_t* out, int64_t nwords) {
  for (int64_t i = 0; i < nwords; i++) out[i] = ~a[i];
}

PT_EXPORT int64_t pt_bm_cardinality(const uint64_t* a, int64_t nwords) {
  int64_t c = 0;
  for (int64_t i = 0; i < nwords; i++) c += __builtin_popcountll(a[i]);
  return c;
}

// bitmap -> sorted doc ids; returns count written (<= cap)
PT_EXPORT int64_t pt_bm_extract(const uint64_t* a, int64_t nwords,
                                int32_t* out, int64_t cap) {
  int64_t k = 0;
  for (int64_t w = 0; w < nwords; w++) {
    uint64_t bits = a[w];
    while (bits) {
      if (k >= cap) return k;
      int b = __builtin_ctzll(bits);
      out[k++] = (int32_t)(w * 64 + b);
      bits &= bits - 1;
    }
  }
  return k;
}

PT_EXPORT void pt_bm_from_indices(const int32_t* idx, int64_t n,
                                  uint64_t* out, int64_t nwords) {
  std::memset(out, 0, (size_t)nwords * 8);
  for (int64_t i = 0; i < n; i++) {
    int64_t d = idx[i];
    out[d >> 6] |= 1ull << (d & 63);
  }
}

// ---------------------------------------------------------------------------
// hashing: splitmix64 (PK/dedup/join keys, HLL input)
// ---------------------------------------------------------------------------

static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

PT_EXPORT void pt_hash64(const uint64_t* in, int64_t n, uint64_t* out) {
  for (int64_t i = 0; i < n; i++) out[i] = splitmix64(in[i]);
}

// FNV-1a over variable-length byte slices (string keys); offsets[n+1]
PT_EXPORT void pt_hash_bytes(const uint8_t* data, const int64_t* offsets,
                             int64_t n, uint64_t* out) {
  for (int64_t i = 0; i < n; i++) {
    uint64_t h = 1469598103934665603ull;
    for (int64_t j = offsets[i]; j < offsets[i + 1]; j++) {
      h ^= data[j];
      h *= 1099511628211ull;
    }
    out[i] = splitmix64(h);
  }
}

// ---------------------------------------------------------------------------
// HyperLogLog registers (2^p registers, rho of remaining bits)
// ---------------------------------------------------------------------------

PT_EXPORT void pt_hll_update(const uint64_t* hashes, const uint8_t* mask,
                             int64_t n, int32_t p, uint8_t* regs) {
  const uint64_t idx_mask = (1ull << p) - 1;
  for (int64_t i = 0; i < n; i++) {
    if (mask && !mask[i]) continue;
    uint64_t h = hashes[i];
    uint64_t idx = h & idx_mask;
    uint64_t rest = h >> p;
    uint8_t rho = (uint8_t)(rest ? (__builtin_ctzll(rest) + 1) : (64 - p + 1));
    if (rho > regs[idx]) regs[idx] = rho;
  }
}

PT_EXPORT void pt_hll_merge(const uint8_t* src, uint8_t* acc, int64_t nregs) {
  for (int64_t i = 0; i < nregs; i++)
    if (src[i] > acc[i]) acc[i] = src[i];
}

PT_EXPORT double pt_hll_estimate(const uint8_t* regs, int32_t p) {
  const int64_t m = 1ll << p;
  double sum = 0.0;
  int64_t zeros = 0;
  for (int64_t i = 0; i < m; i++) {
    sum += std::ldexp(1.0, -(int)regs[i]);
    if (regs[i] == 0) zeros++;
  }
  double alpha = (m == 16)   ? 0.673
                 : (m == 32) ? 0.697
                 : (m == 64) ? 0.709
                             : 0.7213 / (1.0 + 1.079 / (double)m);
  double e = alpha * m * m / sum;
  if (e <= 2.5 * m && zeros > 0)
    e = m * std::log((double)m / (double)zeros);  // linear counting
  return e;
}

// ---------------------------------------------------------------------------
// masked & grouped aggregation inner loops (host execution tier)
// ---------------------------------------------------------------------------

// out4 = {sum, min, max, count}
PT_EXPORT void pt_masked_stats_f64(const double* v, const uint8_t* m,
                                   int64_t n, double* out4) {
  double sum = 0.0, mn = INFINITY, mx = -INFINITY;
  int64_t cnt = 0;
  for (int64_t i = 0; i < n; i++) {
    if (m && !m[i]) continue;
    double x = v[i];
    sum += x;
    if (x < mn) mn = x;
    if (x > mx) mx = x;
    cnt++;
  }
  out4[0] = sum;
  out4[1] = mn;
  out4[2] = mx;
  out4[3] = (double)cnt;
}

PT_EXPORT void pt_group_sum_f64(const double* v, const int32_t* gid,
                                const uint8_t* m, int64_t n, double* acc) {
  for (int64_t i = 0; i < n; i++)
    if (!m || m[i]) acc[gid[i]] += v[i];
}

PT_EXPORT void pt_group_count(const int32_t* gid, const uint8_t* m, int64_t n,
                              int64_t* acc) {
  for (int64_t i = 0; i < n; i++)
    if (!m || m[i]) acc[gid[i]]++;
}

PT_EXPORT void pt_group_min_f64(const double* v, const int32_t* gid,
                                const uint8_t* m, int64_t n, double* acc) {
  for (int64_t i = 0; i < n; i++)
    if ((!m || m[i]) && v[i] < acc[gid[i]]) acc[gid[i]] = v[i];
}

PT_EXPORT void pt_group_max_f64(const double* v, const int32_t* gid,
                                const uint8_t* m, int64_t n, double* acc) {
  for (int64_t i = 0; i < n; i++)
    if ((!m || m[i]) && v[i] > acc[gid[i]]) acc[gid[i]] = v[i];
}

// dense group id from dict ids: gid = sum_k ids_k * stride_k
// (DictionaryBasedGroupKeyGenerator.java:119-130 cardinality-product scheme)
PT_EXPORT void pt_group_key(const int32_t* const* id_cols,
                            const int64_t* strides, int32_t ncols, int64_t n,
                            int32_t* gid) {
  std::memset(gid, 0, (size_t)n * 4);
  for (int32_t c = 0; c < ncols; c++) {
    const int32_t* ids = id_cols[c];
    int64_t s = strides[c];
    for (int64_t i = 0; i < n; i++) gid[i] += (int32_t)(ids[i] * s);
  }
}

// ---------------------------------------------------------------------------
// open-addressing hash table group-id assignment for high-cardinality keys
// (NoDictionary*GroupKeyGenerator equivalent). keys: uint64 hashed keys.
// table_cap MUST be a power of two and > n. Returns number of distinct groups.
// slots: int64[table_cap] scratch, gid out: int32[n].
// ---------------------------------------------------------------------------

PT_EXPORT int64_t pt_hash_group_ids(const uint64_t* keys, int64_t n,
                                    uint64_t* slot_keys, int32_t* slot_gids,
                                    int64_t table_cap, int32_t* gid) {
  const uint64_t mask = (uint64_t)table_cap - 1;
  const uint64_t EMPTY = 0xFFFFFFFFFFFFFFFFull;
  for (int64_t i = 0; i < table_cap; i++) slot_keys[i] = EMPTY;
  int32_t next = 0;
  for (int64_t i = 0; i < n; i++) {
    uint64_t k = keys[i];
    if (k == EMPTY) k = 0;  // reserve sentinel
    uint64_t s = splitmix64(k) & mask;
    while (true) {
      if (slot_keys[s] == EMPTY) {
        slot_keys[s] = k;
        slot_gids[s] = next;
        gid[i] = next;
        next++;
        break;
      }
      if (slot_keys[s] == k) {
        gid[i] = slot_gids[s];
        break;
      }
      s = (s + 1) & mask;
    }
  }
  return next;
}

// ---------------------------------------------------------------------------
// crc32 (reflected, poly 0xEDB88320) for segment-file / wire integrity
// ---------------------------------------------------------------------------

static uint32_t crc_table[256];
static bool crc_init_done = false;

static void crc_init() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[i] = c;
  }
  crc_init_done = true;
}

PT_EXPORT uint32_t pt_crc32(const uint8_t* p, int64_t n, uint32_t seed) {
  if (!crc_init_done) crc_init();
  uint32_t c = seed ^ 0xFFFFFFFFu;
  for (int64_t i = 0; i < n; i++) c = crc_table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// var-length string blob: encode offsets during dictionary/file IO
// (takes utf-8 blob + int32 lengths, writes int64 offsets prefix-sum)
// ---------------------------------------------------------------------------

PT_EXPORT void pt_prefix_sum_i64(const int32_t* lens, int64_t n,
                                 int64_t* offsets) {
  int64_t acc = 0;
  for (int64_t i = 0; i < n; i++) {
    offsets[i] = acc;
    acc += lens[i];
  }
  offsets[n] = acc;
}

PT_EXPORT int32_t pt_abi_version() { return 1; }

// ---------------------------------------------------------------------------
// system chunk codecs via dlopen: ZSTD / GZIP(zlib) / Snappy
// (ChunkCompressionType.java:22 parity — ZSTANDARD, GZIP, SNAPPY). Lazily
// resolved so the library builds and runs without any of them installed;
// unavailable codecs return -2 and the Python layer falls back.
// ---------------------------------------------------------------------------

#include <dlfcn.h>
#include <stddef.h>

namespace {

void* dl_open_first(const char* a, const char* b) {
  void* h = dlopen(a, RTLD_NOW | RTLD_GLOBAL);
  if (!h && b) h = dlopen(b, RTLD_NOW | RTLD_GLOBAL);
  return h;
}

// zstd
typedef size_t (*zstd_bound_t)(size_t);
typedef size_t (*zstd_compress_t)(void*, size_t, const void*, size_t, int);
typedef size_t (*zstd_decompress_t)(void*, size_t, const void*, size_t);
typedef unsigned (*zstd_iserror_t)(size_t);
struct ZstdApi {
  zstd_bound_t bound = nullptr;
  zstd_compress_t compress = nullptr;
  zstd_decompress_t decompress = nullptr;
  zstd_iserror_t is_error = nullptr;
  bool ok = false;
  ZstdApi() {
    void* h = dl_open_first("libzstd.so.1", "libzstd.so");
    if (!h) return;
    bound = (zstd_bound_t)dlsym(h, "ZSTD_compressBound");
    compress = (zstd_compress_t)dlsym(h, "ZSTD_compress");
    decompress = (zstd_decompress_t)dlsym(h, "ZSTD_decompress");
    is_error = (zstd_iserror_t)dlsym(h, "ZSTD_isError");
    ok = bound && compress && decompress && is_error;
  }
};
ZstdApi& zstd() { static ZstdApi api; return api; }

// zlib (GZIP analog: zlib stream format)
typedef unsigned long (*z_bound_t)(unsigned long);
typedef int (*z_compress2_t)(uint8_t*, unsigned long*, const uint8_t*, unsigned long, int);
typedef int (*z_uncompress_t)(uint8_t*, unsigned long*, const uint8_t*, unsigned long);
struct ZlibApi {
  z_bound_t bound = nullptr;
  z_compress2_t compress2 = nullptr;
  z_uncompress_t uncompress = nullptr;
  bool ok = false;
  ZlibApi() {
    void* h = dl_open_first("libz.so.1", "libz.so");
    if (!h) return;
    bound = (z_bound_t)dlsym(h, "compressBound");
    compress2 = (z_compress2_t)dlsym(h, "compress2");
    uncompress = (z_uncompress_t)dlsym(h, "uncompress");
    ok = bound && compress2 && uncompress;
  }
};
ZlibApi& zlib() { static ZlibApi api; return api; }

// snappy C bindings
typedef int (*sn_compress_t)(const char*, size_t, char*, size_t*);
typedef int (*sn_uncompress_t)(const char*, size_t, char*, size_t*);
typedef size_t (*sn_maxlen_t)(size_t);
struct SnappyApi {
  sn_compress_t compress = nullptr;
  sn_uncompress_t uncompress = nullptr;
  sn_maxlen_t maxlen = nullptr;
  bool ok = false;
  SnappyApi() {
    void* h = dl_open_first("libsnappy.so.1", "libsnappy.so");
    if (!h) return;
    compress = (sn_compress_t)dlsym(h, "snappy_compress");
    uncompress = (sn_uncompress_t)dlsym(h, "snappy_uncompress");
    maxlen = (sn_maxlen_t)dlsym(h, "snappy_max_compressed_length");
    ok = compress && uncompress && maxlen;
  }
};
SnappyApi& snappy() { static SnappyApi api; return api; }

}  // namespace

PT_EXPORT int64_t pt_zstd_bound(int64_t n) {
  if (!zstd().ok) return -2;
  return (int64_t)zstd().bound((size_t)n);
}

PT_EXPORT int64_t pt_zstd_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                                   int64_t cap, int32_t level) {
  if (!zstd().ok) return -2;
  size_t k = zstd().compress(dst, (size_t)cap, src, (size_t)n, level);
  if (zstd().is_error(k)) return -1;
  return (int64_t)k;
}

PT_EXPORT int64_t pt_zstd_decompress(const uint8_t* src, int64_t n,
                                     uint8_t* dst, int64_t cap) {
  if (!zstd().ok) return -2;
  size_t k = zstd().decompress(dst, (size_t)cap, src, (size_t)n);
  if (zstd().is_error(k)) return -1;
  return (int64_t)k;
}

PT_EXPORT int64_t pt_gzip_bound(int64_t n) {
  if (!zlib().ok) return -2;
  return (int64_t)zlib().bound((unsigned long)n);
}

PT_EXPORT int64_t pt_gzip_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                                   int64_t cap, int32_t level) {
  if (!zlib().ok) return -2;
  unsigned long out_len = (unsigned long)cap;
  int rc = zlib().compress2(dst, &out_len, src, (unsigned long)n, level);
  if (rc != 0) return -1;
  return (int64_t)out_len;
}

PT_EXPORT int64_t pt_gzip_decompress(const uint8_t* src, int64_t n,
                                     uint8_t* dst, int64_t cap) {
  if (!zlib().ok) return -2;
  unsigned long out_len = (unsigned long)cap;
  int rc = zlib().uncompress(dst, &out_len, src, (unsigned long)n);
  if (rc != 0) return -1;
  return (int64_t)out_len;
}

PT_EXPORT int64_t pt_snappy_bound(int64_t n) {
  if (!snappy().ok) return -2;
  return (int64_t)snappy().maxlen((size_t)n);
}

PT_EXPORT int64_t pt_snappy_compress(const uint8_t* src, int64_t n,
                                     uint8_t* dst, int64_t cap) {
  if (!snappy().ok) return -2;
  size_t out_len = (size_t)cap;
  int rc = snappy().compress((const char*)src, (size_t)n, (char*)dst, &out_len);
  if (rc != 0) return -1;
  return (int64_t)out_len;
}

PT_EXPORT int64_t pt_snappy_decompress(const uint8_t* src, int64_t n,
                                       uint8_t* dst, int64_t cap) {
  if (!snappy().ok) return -2;
  size_t out_len = (size_t)cap;
  int rc = snappy().uncompress((const char*)src, (size_t)n, (char*)dst, &out_len);
  if (rc != 0) return -1;
  return (int64_t)out_len;
}
