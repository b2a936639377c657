// Host fold library of redisson_tpu_torch: the C ABI the delta / tape ingest
// and the Bloom host mirror call through ctypes (`redisson_tpu_torch/native.py`).
//
// The port's own copy of the fold half of `native/redisson_native.cpp`:
//   * murmur3 x64 128 of 8-byte little-endian keys and of byte rows;
//   * the HLL fold (p = 14: bucket = h1 & 16383, rank = ctz((h1 >> 14) |
//     2^50) + 1) of u64 keys and of padded byte rows into 16384 uint8
//     registers;
//   * the Bloom fold and probe (idx_i = (h1 + i*h2) mod 2^64 mod m) of u64
//     keys and byte rows over a packed big-endian bitmap (bit i in byte
//     i >> 3 at mask 0x80 >> (i & 7), numpy packbits order), with an
//     optional per-key "newly set" mask;
//   * a population count of a packed bitmap.
// Every function is bit-identical to its counterpart there; the thread
// splits are the same too, so the per-key flags of a threaded fold race in
// the same, documented way.
//
// Built at first use with `g++ -O3 -std=c++17 -fPIC -shared -lpthread` into
// the package's git-ignored build/ directory (native.py).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#define HF_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

constexpr int kRegs = 16384;

inline uint64_t rotl64(uint64_t x, int8_t r) {
  return (x << r) | (x >> (64 - r));
}

inline uint64_t fmix64(uint64_t k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdULL;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ULL;
  k ^= k >> 33;
  return k;
}

inline uint64_t load_le64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);  // little-endian hosts (x86-64, arm64)
  return v;
}

void murmur3_x64_128(const uint8_t* data, int64_t len, uint64_t seed,
                     uint64_t* out_h1, uint64_t* out_h2) {
  const uint64_t c1 = 0x87c37b91114253d5ULL;
  const uint64_t c2 = 0x4cf5ad432745937fULL;
  uint64_t h1 = seed, h2 = seed;
  const int64_t nblocks = len / 16;
  for (int64_t i = 0; i < nblocks; i++) {
    uint64_t k1 = load_le64(data + i * 16);
    uint64_t k2 = load_le64(data + i * 16 + 8);
    k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
    h1 = rotl64(h1, 27); h1 += h2; h1 = h1 * 5 + 0x52dce729ULL;
    k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
    h2 = rotl64(h2, 31); h2 += h1; h2 = h2 * 5 + 0x38495ab5ULL;
  }
  const uint8_t* tail = data + nblocks * 16;
  uint64_t k1 = 0, k2 = 0;
  switch (len & 15) {
    case 15: k2 ^= (uint64_t)tail[14] << 48; [[fallthrough]];
    case 14: k2 ^= (uint64_t)tail[13] << 40; [[fallthrough]];
    case 13: k2 ^= (uint64_t)tail[12] << 32; [[fallthrough]];
    case 12: k2 ^= (uint64_t)tail[11] << 24; [[fallthrough]];
    case 11: k2 ^= (uint64_t)tail[10] << 16; [[fallthrough]];
    case 10: k2 ^= (uint64_t)tail[9] << 8; [[fallthrough]];
    case 9:  k2 ^= (uint64_t)tail[8];
             k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2; [[fallthrough]];
    case 8:  k1 ^= (uint64_t)tail[7] << 56; [[fallthrough]];
    case 7:  k1 ^= (uint64_t)tail[6] << 48; [[fallthrough]];
    case 6:  k1 ^= (uint64_t)tail[5] << 40; [[fallthrough]];
    case 5:  k1 ^= (uint64_t)tail[4] << 32; [[fallthrough]];
    case 4:  k1 ^= (uint64_t)tail[3] << 24; [[fallthrough]];
    case 3:  k1 ^= (uint64_t)tail[2] << 16; [[fallthrough]];
    case 2:  k1 ^= (uint64_t)tail[1] << 8; [[fallthrough]];
    case 1:  k1 ^= (uint64_t)tail[0];
             k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
  }
  h1 ^= (uint64_t)len; h2 ^= (uint64_t)len;
  h1 += h2; h2 += h1;
  h1 = fmix64(h1); h2 = fmix64(h2);
  h1 += h2; h2 += h1;
  *out_h1 = h1; *out_h2 = h2;
}

// h1 of one u64 key hashed as its 8-byte LE encoding: the key is all tail,
// so the algorithm collapses to one k1 mix and the finalization.
inline uint64_t mm3_h1_u64(uint64_t key, uint64_t seed) {
  const uint64_t c1 = 0x87c37b91114253d5ULL;
  const uint64_t c2 = 0x4cf5ad432745937fULL;
  uint64_t k1 = key;
  k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2;
  uint64_t h1 = seed ^ k1;
  uint64_t h2 = seed;
  h1 ^= 8; h2 ^= 8;
  h1 += h2;
  h2 += h1;
  h1 = fmix64(h1);
  h2 = fmix64(h2);
  return h1 + h2;
}

inline void mm3_u64_pair(uint64_t key, uint64_t seed, uint64_t* o1,
                         uint64_t* o2) {
  murmur3_x64_128(reinterpret_cast<const uint8_t*>(&key), 8, seed, o1, o2);
}

inline void hll_fold_h1(uint64_t h1, uint8_t* regs) {
  uint32_t bucket = (uint32_t)(h1 & (kRegs - 1));
  uint64_t rest = (h1 >> 14) | (1ULL << 50);
  uint8_t rank = (uint8_t)(__builtin_ctzll(rest) + 1);
  if (rank > regs[bucket]) regs[bucket] = rank;
}

void hll_fold_u64_range(const uint64_t* keys, int64_t n, uint64_t seed,
                        uint8_t* regs) {
  for (int64_t i = 0; i < n; i++) hll_fold_h1(mm3_h1_u64(keys[i], seed), regs);
}

int32_t clamp_threads(int32_t nthreads, int64_t n, int64_t min_per_thread) {
  if (nthreads > 16) nthreads = 16;
  if (nthreads > (int32_t)(n / min_per_thread))
    nthreads = (int32_t)(n / min_per_thread);
  return nthreads;
}

inline int get_bit(const uint8_t* bits, uint64_t idx) {
  return (bits[idx >> 3] >> (7 - (idx & 7))) & 1;
}

// Threads share the bitmap: an atomic OR keeps every concurrent set in a
// byte (relaxed order: Bloom bits only ever turn on).
inline void set_bit_atomic(uint8_t* bits, uint64_t idx) {
  __atomic_fetch_or(&bits[idx >> 3], (uint8_t)(0x80u >> (idx & 7u)),
                    __ATOMIC_RELAXED);
}

template <bool Atomic>
inline void set_bit(uint8_t* bits, uint64_t idx) {
  if (Atomic)
    set_bit_atomic(bits, idx);
  else
    bits[idx >> 3] |= (uint8_t)(0x80u >> (idx & 7u));
}

template <bool Atomic>
inline uint8_t bloom_fold_one(uint64_t h1, uint64_t h2, int32_t k, uint64_t m,
                              uint8_t* bits) {
  uint64_t acc = h1;
  uint8_t fresh = 0;
  for (int32_t i = 0; i < k; i++) {
    uint64_t idx = acc % m;
    if (!get_bit(bits, idx)) {
      fresh = 1;
      set_bit<Atomic>(bits, idx);
    }
    acc += h2;
  }
  return fresh;
}

inline uint8_t bloom_probe_one(uint64_t h1, uint64_t h2, int32_t k, uint64_t m,
                               const uint8_t* bits) {
  uint64_t acc = h1;
  for (int32_t i = 0; i < k; i++) {
    if (!get_bit(bits, acc % m)) return 0;
    acc += h2;
  }
  return 1;
}

// The walk is bound by memory latency (k random bytes of a large bitmap):
// a block of keys' indexes is computed and prefetched before it is applied,
// so the misses overlap.
template <bool Atomic>
void bloom_fold_u64_range(const uint64_t* keys, int64_t n, uint64_t seed,
                          int32_t k, uint64_t m, uint8_t* bits,
                          uint8_t* newly) {
  constexpr int64_t kBlock = 32;
  constexpr int32_t kMaxK = 32;
  uint64_t idx[kBlock * kMaxK];
  int64_t i = 0;
  for (; i + kBlock <= n && k <= kMaxK; i += kBlock) {
    for (int64_t b = 0; b < kBlock; b++) {
      uint64_t h1, h2;
      mm3_u64_pair(keys[i + b], seed, &h1, &h2);
      uint64_t acc = h1;
      for (int32_t j = 0; j < k; j++) {
        uint64_t ix = acc % m;
        idx[b * k + j] = ix;
        __builtin_prefetch(&bits[ix >> 3], 1, 1);
        acc += h2;
      }
    }
    for (int64_t b = 0; b < kBlock; b++) {
      uint8_t fresh = 0;
      for (int32_t j = 0; j < k; j++) {
        uint64_t ix = idx[b * k + j];
        if (!get_bit(bits, ix)) {
          fresh = 1;
          set_bit<Atomic>(bits, ix);
        }
      }
      if (newly) newly[i + b] = fresh;
    }
  }
  for (; i < n; i++) {
    uint64_t h1, h2;
    mm3_u64_pair(keys[i], seed, &h1, &h2);
    uint8_t fresh = bloom_fold_one<Atomic>(h1, h2, k, m, bits);
    if (newly) newly[i] = fresh;
  }
}

void bloom_probe_u64_range(const uint64_t* keys, int64_t n, uint64_t seed,
                           int32_t k, uint64_t m, const uint8_t* bits,
                           uint8_t* out) {
  constexpr int64_t kBlock = 32;
  uint64_t h1s[kBlock], h2s[kBlock];
  int64_t i = 0;
  for (; i + kBlock <= n; i += kBlock) {
    for (int64_t b = 0; b < kBlock; b++) {
      mm3_u64_pair(keys[i + b], seed, &h1s[b], &h2s[b]);
      __builtin_prefetch(&bits[(h1s[b] % m) >> 3], 0, 1);
    }
    for (int64_t b = 0; b < kBlock; b++)
      out[i + b] = bloom_probe_one(h1s[b], h2s[b], k, m, bits);
  }
  for (; i < n; i++) {
    uint64_t h1, h2;
    mm3_u64_pair(keys[i], seed, &h1, &h2);
    out[i] = bloom_probe_one(h1, h2, k, m, bits);
  }
}

// Run fn(start, end) over [0, n) split into `nthreads` slices, the first
// slice on the calling thread.
template <typename Fn>
void split(int64_t n, int32_t nthreads, Fn fn) {
  if (nthreads <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t per = n / nthreads;
  for (int32_t t = 1; t < nthreads; t++) {
    const int64_t s = per * t;
    const int64_t e = (t == nthreads - 1) ? n : per * (t + 1);
    threads.emplace_back([=] { fn(s, e); });
  }
  fn(0, per);
  for (auto& th : threads) th.join();
}

}  // namespace

// HLL fold of u64 keys into 16384 uint8 registers, in place. Threads fold
// disjoint slices into private registers, merged by max (the fold
// commutes).
HF_EXPORT void hf_hll_fold_u64(const uint64_t* keys, int64_t n, uint64_t seed,
                               uint8_t* regs, int32_t nthreads) {
  nthreads = clamp_threads(nthreads, n, 1 << 16);
  if (nthreads <= 1) {
    hll_fold_u64_range(keys, n, seed, regs);
    return;
  }
  std::vector<std::vector<uint8_t>> scratch(
      (size_t)nthreads, std::vector<uint8_t>(kRegs, 0));
  const int64_t per = n / nthreads;
  split(n, nthreads, [&](int64_t s, int64_t e) {
    hll_fold_u64_range(keys + s, e - s, seed, scratch[(size_t)(s / per)].data());
  });
  for (auto& sc : scratch)
    for (int i = 0; i < kRegs; i++)
      if (sc[(size_t)i] > regs[i]) regs[i] = sc[(size_t)i];
}

// HLL fold of u64 keys into per-row sketches of a host bank mirror
// ([nrows, 16384] uint8, in place): key i goes to row rows[i]; a row
// outside [0, nrows) is skipped, never written.
HF_EXPORT void hf_hll_fold_u64_rows(const uint64_t* keys, const int32_t* rows,
                                    int64_t n, uint64_t seed, uint8_t* bank,
                                    int64_t nrows) {
  for (int64_t i = 0; i < n; i++) {
    const int64_t row = rows[i];
    if (row < 0 || row >= nrows) continue;
    hll_fold_h1(mm3_h1_u64(keys[i], seed), bank + row * kRegs);
  }
}

// HLL fold of padded byte rows ([n, w] uint8 plus lengths).
HF_EXPORT void hf_hll_fold_rows(const uint8_t* data, int64_t w,
                                const int32_t* lengths, int64_t n,
                                uint64_t seed, uint8_t* regs) {
  for (int64_t i = 0; i < n; i++) {
    uint64_t h1, h2;
    murmur3_x64_128(data + i * w, lengths[i], seed, &h1, &h2);
    hll_fold_h1(h1, regs);
  }
}

// Bloom fold of u64 keys into a packed bitmap, in place; `newly` (size n,
// may be null) gets 1 where the key set a bit that was unset when read.
HF_EXPORT void hf_bloom_fold_u64(const uint64_t* keys, int64_t n,
                                 uint64_t seed, int32_t k, uint64_t m,
                                 uint8_t* bits, uint8_t* newly,
                                 int32_t nthreads) {
  nthreads = clamp_threads(nthreads, n, 1 << 15);
  if (nthreads <= 1) {
    bloom_fold_u64_range<false>(keys, n, seed, k, m, bits, newly);
    return;
  }
  split(n, nthreads, [=](int64_t s, int64_t e) {
    bloom_fold_u64_range<true>(keys + s, e - s, seed, k, m, bits,
                               newly ? newly + s : nullptr);
  });
}

HF_EXPORT void hf_bloom_contains_u64(const uint64_t* keys, int64_t n,
                                     uint64_t seed, int32_t k, uint64_t m,
                                     const uint8_t* bits, uint8_t* out,
                                     int32_t nthreads) {
  nthreads = clamp_threads(nthreads, n, 1 << 15);
  split(n, nthreads, [=](int64_t s, int64_t e) {
    bloom_probe_u64_range(keys + s, e - s, seed, k, m, bits, out + s);
  });
}

HF_EXPORT void hf_bloom_fold_rows(const uint8_t* data, int64_t w,
                                  const int32_t* lengths, int64_t n,
                                  uint64_t seed, int32_t k, uint64_t m,
                                  uint8_t* bits, uint8_t* newly) {
  for (int64_t i = 0; i < n; i++) {
    uint64_t h1, h2;
    murmur3_x64_128(data + i * w, lengths[i], seed, &h1, &h2);
    uint8_t fresh = bloom_fold_one<false>(h1, h2, k, m, bits);
    if (newly) newly[i] = fresh;
  }
}

HF_EXPORT void hf_bloom_contains_rows(const uint8_t* data, int64_t w,
                                      const int32_t* lengths, int64_t n,
                                      uint64_t seed, int32_t k, uint64_t m,
                                      const uint8_t* bits, uint8_t* out) {
  for (int64_t i = 0; i < n; i++) {
    uint64_t h1, h2;
    murmur3_x64_128(data + i * w, lengths[i], seed, &h1, &h2);
    out[i] = bloom_probe_one(h1, h2, k, m, bits);
  }
}

HF_EXPORT uint64_t hf_popcount(const uint8_t* bits, int64_t nbytes) {
  uint64_t total = 0;
  int64_t i = 0;
  for (; i + 8 <= nbytes; i += 8) {
    uint64_t w;
    std::memcpy(&w, bits + i, 8);
    total += (uint64_t)__builtin_popcountll(w);
  }
  for (; i < nbytes; i++) total += (uint64_t)__builtin_popcount(bits[i]);
  return total;
}

HF_EXPORT const char* hf_version() { return "redisson-tpu-torch native 1.0"; }
