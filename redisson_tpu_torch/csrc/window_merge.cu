// Window merge: the tape megakernel. One launch retires a whole encoded
// window (ingest/tape.py): for each row t of the [T, L] uint8 stack `old`,
// in place,
//   delta[c] = 0                                  if c >= length[t]
//            = wire[t, c]                         if op_code[t] == OP_HLL
//            = (wire[t, c >> 3] >> (7 - (c & 7))) & 1   otherwise
//   old[t, c] = max(old[t, c], delta[c]),
// wire bytes past the wire's width reading as 0, plus changed[t] = 1 where
// any cell of row t rose. op_code and length come from the table
// [T, cols] int32 (columns 0 and 3); its offset column is not read: row t's
// operand is wire row t, as in the Pallas kernel.
//
// Replaces: redisson_tpu/ops/window_kernel.py::_window_tape_kernel
// (window_merge_pallas). It walked a (row, block) grid with the table in
// SMEM by scalar prefetch, read the wire twice (dense at cell granularity,
// packed at byte granularity), expanded packed bytes with a repeat-by-8
// and kept a per-row SMEM flag.
//
// Bound on the H100: memory. The cells below each row's length are read
// and written once (2 bytes per cell) and a row reads its wire bytes once:
// the length bytes of a dense row, length / 8 of a packed one. A mixed
// window of 64 rows of 2^20 lanes moves ~63 MB (0.0189 ms at 3.35 TB/s),
// an HLL window [256, 16384] ~12.6 MB (0.0037 ms). At the HLL window the
// host's issue of the call, not the device, sets the time as called, so
// the call is one foreign call: the flags are written here, not cleared
// and converted by the caller.
//
// Design: a flat grid of independent blocks, each owning one chunk of one
// row (64-bit offsets). Every thread reads its row's (op_code, length) from
// the table (one broadcast load, no barrier) and the block merges the
// vectors of its chunk that hold cells below the length: a chunk at or past
// it loads nothing, so OP_PAD rows (length 0) and ragged tails cost no
// traffic. A thread merges 16 cells as one 16-byte vector of `old`, 2 or 4
// vectors a step, all loads of a step issued before any store: a dense row
// takes 16 wire bytes at the same column in one 16-byte load, a packed row
// 2 wire bytes in one 2-byte load (a warp reads 64 contiguous wire bytes)
// and expands them into 16 cells, most significant bit first; cells at or
// past the length are masked to 0. A wire whose width is not a multiple of
// 16 is read byte by byte. The old vector stays in registers across its
// store, so "changed" compares with the values from before the merge, and
// a vector is stored only where a cell rose.
// - Short rows (at most kOwnerRowVecs vectors, an HLL window's 16 KiB rows
//   among them): the chunk is the whole row, so the block owns the row's
//   flag and writes it, 0 or 1, after a `__syncthreads_or`. Nothing clears
//   the flags first: the call is the kernel alone.
// - Long rows (the mixed window's 2^20 lanes): chunks of kChunkVecs vectors
//   (64 KiB of cells), several per row, 4 vectors per thread in flight. The
//   entry clears the 1-byte flags with cudaMemsetAsync on the caller's
//   stream and a block that saw a rise stores byte 1; every writer stores
//   the same value, so the race needs no atomic.
// No warp shuffle: a row's length ends anywhere, and no lane waits on
// another.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOpHll = 1;  // window_kernel.OP_HLL
constexpr int kColOp = 0;
constexpr int kColLength = 3;
constexpr long long kOwnerRowVecs = 4096;  // rows up to 64 KiB: one block each
constexpr int kOwnerThreads = 512;
constexpr int kOwnerUnroll = 2;  // vectors per thread in flight
constexpr long long kChunkVecs = 4096;  // 64 KiB of a long row per block
constexpr int kChunkThreads = 256;
constexpr int kChunkUnroll = 4;

__device__ __forceinline__ uint4 vmax4(uint4 a, uint4 b) {
  return make_uint4(__vmaxu4(a.x, b.x), __vmaxu4(a.y, b.y),
                    __vmaxu4(a.z, b.z), __vmaxu4(a.w, b.w));
}

__device__ __forceinline__ bool differs(uint4 a, uint4 b) {
  return ((a.x ^ b.x) | (a.y ^ b.y) | (a.z ^ b.z) | (a.w ^ b.w)) != 0;
}

// Four cells from a nibble, most significant bit first: cell i of the
// nibble goes to byte i of the word (little-endian memory order).
__device__ __forceinline__ unsigned expand4(unsigned nib) {
  return ((nib >> 3) & 1u) | (((nib >> 2) & 1u) << 8) |
         (((nib >> 1) & 1u) << 16) | ((nib & 1u) << 24);
}

// Keep the first n (0..4) bytes of a word.
__device__ __forceinline__ unsigned keep(unsigned w, long long n) {
  if (n >= 4) return w;
  if (n <= 0) return 0u;
  return w & ((1u << (8 * n)) - 1u);
}

// The delta of cells [16 v, 16 v + 16) of one row, from its wire row `src`
// of `w` bytes; `vec`: w % 16 == 0 (the wire rows are 16-byte aligned).
__device__ __forceinline__ uint4 delta_vec(const uint8_t* __restrict__ src,
                                           long long v, long long w,
                                           bool dense, bool vec,
                                           long long length) {
  const long long c = v * 16;
  uint4 d;
  if (dense) {
    if (vec && c + 16 <= w) {
      d = __ldg(reinterpret_cast<const uint4*>(src + c));
    } else {
      unsigned b[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) b[j] = c + j < w ? src[c + j] : 0u;
      d = make_uint4(b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24,
                     b[4] | b[5] << 8 | b[6] << 16 | b[7] << 24,
                     b[8] | b[9] << 8 | b[10] << 16 | b[11] << 24,
                     b[12] | b[13] << 8 | b[14] << 16 | b[15] << 24);
    }
  } else {
    const long long byte = v * 2;  // cells c .. c + 15 live in 2 bytes
    unsigned b0, b1;
    if (vec && byte + 2 <= w) {
      const unsigned h = __ldg(reinterpret_cast<const unsigned short*>(src + byte));
      b0 = h & 0xffu;
      b1 = h >> 8;
    } else {
      b0 = byte < w ? src[byte] : 0u;
      b1 = byte + 1 < w ? src[byte + 1] : 0u;
    }
    d = make_uint4(expand4(b0 >> 4), expand4(b0 & 15u), expand4(b1 >> 4),
                   expand4(b1 & 15u));
  }
  const long long valid = length - c;  // >= 1 for the vectors merged
  if (valid < 16) {
    d.x = keep(d.x, valid);
    d.y = keep(d.y, valid - 4);
    d.z = keep(d.z, valid - 8);
    d.w = keep(d.w, valid - 12);
  }
  return d;
}

template <int kThreads, int kUnroll>
__global__ void __launch_bounds__(kThreads)
window_merge_kernel(uint4* __restrict__ old, const uint8_t* __restrict__ wire,
                    const int* __restrict__ table, uint8_t* __restrict__ changed,
                    long long row_vecs, long long chunk_vecs, long long chunks,
                    long long w, int cols) {
  const long long row = blockIdx.x / chunks;
  const long long first = (blockIdx.x - row * chunks) * chunk_vecs;
  const int op = __ldg(table + row * cols + kColOp);
  const long long length = max(__ldg(table + row * cols + kColLength), 0);
  // Vectors holding a cell below the length; the chunk's share of them.
  const long long used = min(row_vecs, (length + 15) / 16);
  const long long last = min(first + chunk_vecs, used);
  const bool dense = op == kOpHll;
  const bool vec = w % 16 == 0;
  const uint8_t* src = wire + row * w;
  uint4* dst = old + row * row_vecs;
  int rose = 0;
  for (long long step = first; step < last; step += kUnroll * kThreads) {
    uint4 o[kUnroll], d[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = step + u * kThreads + threadIdx.x;
      if (v < last) {
        o[u] = dst[v];
        d[u] = delta_vec(src, v, w, dense, vec, length);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = step + u * kThreads + threadIdx.x;
      if (v < last) {
        const uint4 merged = vmax4(o[u], d[u]);
        if (differs(merged, o[u])) {
          dst[v] = merged;
          rose = 1;
        }
      }
    }
  }
  rose = __syncthreads_or(rose);
  if (threadIdx.x != 0) return;
  if (chunks == 1)
    changed[row] = rose ? 1 : 0;  // the block owns the whole row
  else if (rose)
    changed[row] = 1;  // cleared by the entry; all writers store 1
}

template <int kThreads, int kUnroll>
void launch(unsigned blocks, cudaStream_t s, uint4* old, const uint8_t* wire,
            const int* table, uint8_t* changed, long long row_vecs,
            long long chunk_vecs, long long chunks, long long w, int cols) {
  window_merge_kernel<kThreads, kUnroll><<<blocks, kThreads, 0, s>>>(
      old, wire, table, changed, row_vecs, chunk_vecs, chunks, w, cols);
}

}  // namespace

// old: [t, l] uint8, contiguous, 16-byte aligned, l % 16 == 0 (in place);
// wire: [t, w] uint8, contiguous, 16-byte aligned; table: [t, cols] int32,
// contiguous, cols > 3; changed: [t] bytes (a torch.bool tensor), no initial
// contents. Returns the CUDA error code of the first failing call (0 on
// success).
extern "C" int window_merge_u8(void* old, const void* wire, const void* table,
                               void* changed, long long t, long long l,
                               long long w, int cols, int device,
                               void* stream) {
  // This library's runtime keeps its own current device per thread.
  thread_local int current = -1;
  if (current != device) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    current = device;
  }
  if (t <= 0 || l <= 0) return 0;
  if (l % 16 || cols <= kColLength || w < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long row_vecs = l / 16;
  const long long chunk_vecs = row_vecs <= kOwnerRowVecs ? row_vecs : kChunkVecs;
  const long long chunks = (row_vecs + chunk_vecs - 1) / chunk_vecs;
  const long long blocks = t * chunks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* c = static_cast<uint8_t*>(changed);
  if (chunks > 1) {
    const cudaError_t err = cudaMemsetAsync(c, 0, static_cast<size_t>(t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  uint4* o = static_cast<uint4*>(old);
  const uint8_t* wr = static_cast<const uint8_t*>(wire);
  const int* tb = static_cast<const int*>(table);
  const unsigned g = static_cast<unsigned>(blocks);
  // Whole rows: 512 threads, 2 vectors each a step; chunks of long rows:
  // 256 threads, 4 vectors each (PERF.md).
  if (chunks > 1)
    launch<kChunkThreads, kChunkUnroll>(g, s, o, wr, tb, c, row_vecs, chunk_vecs,
                                        chunks, w, cols);
  else
    launch<kOwnerThreads, kOwnerUnroll>(g, s, o, wr, tb, c, row_vecs, chunk_vecs,
                                        chunks, w, cols);
  return static_cast<int>(cudaGetLastError());
}
