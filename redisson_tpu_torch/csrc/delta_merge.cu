// Delta merge: in place over a [T, L] uint8 stack,
//   old[t, c] = max(old[t, c], delta[t, c]),
// plus changed[t] = 1 where any cell of row t rose.
//
// Replaces: redisson_tpu/ops/pallas_kernels.py::_delta_merge_kernel
// (delta_merge), the retire kernel of the delta ingest. It streamed
// (1, 2^15) blocks of each row through VMEM on a sequential grid and kept a
// per-row flag in SMEM across the row's blocks. One stack row per target:
// HLL register images (0..64) and unpacked Bloom / BitSet cells (0/1, where
// OR is max) share the one elementwise max.
//
// Bound on the H100: memory. Each cell is read twice (old, delta) and
// written once: 3 bytes per cell, 0.0038 ms for an HLL window [256, 16384]
// and 0.240 ms for a Bloom row [1, 2^28] at 3.35 TB/s. The byte max is one
// `__vmaxu4` per 4 cells, far below any compute limit.
//
// Design: the sequential (row, block) grid becomes a flat grid of
// independent blocks, each owning one chunk of one row (64-bit offsets: a
// Bloom row is 2^28 cells and T * L passes 2^31). Threads move 16-byte
// vectors; rows are a multiple of 16 bytes (the wrapper checks it; lanes
// are powers of two >= 1024). A thread keeps the old vector in registers
// across the in-place store, so its "changed" test compares against the
// values from before the merge. The per-row flag needs no order between
// blocks: the block ORs its threads' flags with `__syncthreads_or` and one
// thread of a block that saw a change does one atomicOr into the row's
// int32 flag, which the wrapper zeroes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Vectors (16 bytes) per block: 1024 vectors = 16 KiB of one row.
constexpr long long kChunkVecs = 1024;

__device__ __forceinline__ uint4 vmax4(uint4 a, uint4 b) {
  return make_uint4(__vmaxu4(a.x, b.x), __vmaxu4(a.y, b.y),
                    __vmaxu4(a.z, b.z), __vmaxu4(a.w, b.w));
}

__device__ __forceinline__ bool differs(uint4 a, uint4 b) {
  return ((a.x ^ b.x) | (a.y ^ b.y) | (a.z ^ b.z) | (a.w ^ b.w)) != 0;
}

__global__ void delta_merge_kernel(uint4* __restrict__ old,
                                   const uint4* __restrict__ delta,
                                   int* __restrict__ changed,
                                   long long row_vecs, long long chunks) {
  const long long row = blockIdx.x / chunks;
  const long long chunk = blockIdx.x % chunks;
  const long long begin = chunk * kChunkVecs;
  long long end = begin + kChunkVecs;
  if (end > row_vecs) end = row_vecs;
  const long long base = row * row_vecs;
  int rose = 0;
  for (long long v = begin + threadIdx.x; v < end; v += kThreads) {
    const uint4 o = old[base + v];
    const uint4 merged = vmax4(o, __ldg(delta + base + v));
    if (differs(merged, o)) {
      rose = 1;
      old[base + v] = merged;  // cells that did not rise need no store
    }
  }
  if (__syncthreads_or(rose) && threadIdx.x == 0) atomicOr(changed + row, 1);
}

}  // namespace

// old, delta: [t, l] uint8, contiguous, 16-byte aligned, l % 16 == 0;
// changed: [t] int32, zeroed by the caller. Returns the CUDA error code of
// the launch (0 on success).
extern "C" int delta_merge_u8(void* old, const void* delta, void* changed,
                              long long t, long long l, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (t <= 0 || l <= 0) return 0;
  if (l % 16) return static_cast<int>(cudaErrorInvalidValue);
  const long long row_vecs = l / 16;
  const long long chunks = (row_vecs + kChunkVecs - 1) / kChunkVecs;
  const long long blocks = t * chunks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  delta_merge_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(old), static_cast<const uint4*>(delta),
      static_cast<int*>(changed), row_vecs, chunks);
  return static_cast<int>(cudaGetLastError());
}
