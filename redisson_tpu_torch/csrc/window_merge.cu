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
// the length bytes of a dense row, length / 8 of a packed one. At a mixed
// window of 64 rows of 2^20 cells that is ~139 MB, 0.042 ms at 3.35 TB/s.
//
// Design: a flat grid of independent blocks, each owning one 16 KiB chunk
// of one row (64-bit offsets). A block reads its row's (op_code, length)
// once into shared memory; a chunk at or past the length has a zero delta
// and leaves at once, so OP_PAD rows (length 0) and ragged tails cost no
// traffic. A thread merges 16 cells per step as one 16-byte vector: a dense
// row loads 16 wire bytes at the same column; a packed row loads 2 wire
// bytes and expands them into 16 cells, most significant bit first; cells
// at or past the length are masked to 0. Only the wire bytes a row needs
// are read (the Pallas version padded the wire to L). The old vector stays
// in registers across the in-place store, so "changed" compares with the
// values from before the merge; the row flag is `__syncthreads_or` per
// block and one atomicOr into a zeroed int32 per block that saw a change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunkVecs = 1024;  // 16-cell groups per block
constexpr int kOpHll = 1;               // window_kernel.OP_HLL
constexpr int kColOp = 0;
constexpr int kColLength = 3;

__device__ __forceinline__ unsigned vmax(unsigned a, unsigned b) {
  return __vmaxu4(a, b);
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

__global__ void window_merge_kernel(uint4* __restrict__ old,
                                    const uint8_t* __restrict__ wire,
                                    const int* __restrict__ table,
                                    int* __restrict__ changed,
                                    long long row_vecs, long long chunks,
                                    long long w, int cols) {
  __shared__ int s_op, s_len;
  const long long row = blockIdx.x / chunks;
  const long long chunk = blockIdx.x % chunks;
  if (threadIdx.x == 0) {
    s_op = table[row * cols + kColOp];
    s_len = table[row * cols + kColLength];
  }
  __syncthreads();
  const int op = s_op;
  const long long length = s_len;
  const long long begin = chunk * kChunkVecs;
  if (begin * 16 >= length) return;  // a zero delta: nothing to read or write
  long long end = begin + kChunkVecs;
  if (end > row_vecs) end = row_vecs;
  const long long base = row * row_vecs;
  const uint8_t* src = wire + row * w;
  const bool dense_vec = op == kOpHll && (w % 16) == 0;
  int rose = 0;
  for (long long v = begin + threadIdx.x; v < end; v += kThreads) {
    const long long c = v * 16;
    if (c >= length) break;
    uint4 d;
    if (op == kOpHll) {
      if (dense_vec && c + 16 <= w) {
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
      const unsigned b0 = byte < w ? src[byte] : 0u;
      const unsigned b1 = byte + 1 < w ? src[byte + 1] : 0u;
      d = make_uint4(expand4(b0 >> 4), expand4(b0 & 15u), expand4(b1 >> 4),
                     expand4(b1 & 15u));
    }
    const long long valid = length - c;  // >= 1 here
    if (valid < 16) {
      d.x = keep(d.x, valid);
      d.y = keep(d.y, valid - 4);
      d.z = keep(d.z, valid - 8);
      d.w = keep(d.w, valid - 12);
    }
    const uint4 o = old[base + v];
    const uint4 merged = make_uint4(vmax(o.x, d.x), vmax(o.y, d.y),
                                    vmax(o.z, d.z), vmax(o.w, d.w));
    if (((merged.x ^ o.x) | (merged.y ^ o.y) | (merged.z ^ o.z) |
         (merged.w ^ o.w)) != 0) {
      rose = 1;
      old[base + v] = merged;
    }
  }
  if (__syncthreads_or(rose) && threadIdx.x == 0) atomicOr(changed + row, 1);
}

}  // namespace

// old: [t, l] uint8, contiguous, 16-byte aligned, l % 16 == 0 (in place);
// wire: [t, w] uint8, contiguous, 16-byte aligned; table: [t, cols] int32,
// contiguous, cols > 3; changed: [t] int32, zeroed by the caller. Returns
// the CUDA error code of the launch (0 on success).
extern "C" int window_merge_u8(void* old, const void* wire, const void* table,
                               void* changed, long long t, long long l,
                               long long w, int cols, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (t <= 0 || l <= 0) return 0;
  if (l % 16 || cols <= kColLength || w < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long row_vecs = l / 16;
  const long long chunks = (row_vecs + kChunkVecs - 1) / kChunkVecs;
  const long long blocks = t * chunks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  window_merge_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(old), static_cast<const uint8_t*>(wire),
      static_cast<const int*>(table), static_cast<int*>(changed), row_vecs,
      chunks, w, cols);
  return static_cast<int>(cudaGetLastError());
}
