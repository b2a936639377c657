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
// written at most once: 3 bytes per cell, 0.0038 ms for an HLL window
// [256, 16384] and 0.240 ms for a Bloom row [1, 2^28] at 3.35 TB/s. The byte
// max is one `__vmaxu4` per 4 cells, far below any compute limit. At the
// HLL window's 12 MB the host's issue of the call, not the device, sets the
// time as called, so the call is one foreign call with one kernel launch.
//
// Design: each block merges one contiguous chunk of one row, its threads
// stepping through the chunk one 16-byte vector each per step (a warp's
// step covers 512 contiguous bytes), old and delta loaded before the max
// and the store.
// - Short rows (at most kOwnerRowVecs vectors, an HLL window's 16 KiB rows
//   among them): the chunk is the whole row, so the block owns the row's
//   flag and writes it, 0 or 1, after a `__syncthreads_or`. Nothing clears
//   the flags first: the call is the kernel alone.
// - Long rows (Bloom and BitSet rows of 2^20-2^32 cells): chunks of
//   kChunkVecs vectors, several per row. The entry clears the 1-byte flags
//   with cudaMemsetAsync on the caller's stream and a block that saw a rise
//   stores byte 1; every writer stores the same value, so the race between
//   the blocks of one row is benign and needs no atomic.
// - Stores are conditional per 32-byte sector (a sector in which no cell
//   rose is not written, and one that rose is written whole) and streaming
//   (`__stcs`): the merged row is not read again by this call, so it should
//   not displace the rows still to be read from L2.
// - One flag store per block, after the block's `__syncthreads_or`: stores
//   to one flag byte from every thread that saw a rise serialise on it.
// - Offsets are 64-bit (T * L passes 2^31); rows are a multiple of 16 bytes
//   (the wrapper checks it).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOwnerThreads = 512;
constexpr long long kOwnerRowVecs = 4096;  // rows up to 64 KiB: one block each
constexpr int kChunkThreads = 256;
constexpr long long kChunkVecs = 512;  // 8 KiB of a long row per block

__device__ __forceinline__ uint4 vmax4(uint4 a, uint4 b) {
  return make_uint4(__vmaxu4(a.x, b.x), __vmaxu4(a.y, b.y),
                    __vmaxu4(a.z, b.z), __vmaxu4(a.w, b.w));
}

__device__ __forceinline__ bool differs(uint4 a, uint4 b) {
  return ((a.x ^ b.x) | (a.y ^ b.y) | (a.z ^ b.z) | (a.w ^ b.w)) != 0;
}

// Merges the vector `v` of one row when `in` (lanes past the chunk pass
// false); every lane of the warp must call it, for the shuffle. Returns 1
// where a cell of the vector rose.
__device__ __forceinline__ int merge_vec(uint4* __restrict__ old,
                                         const uint4* __restrict__ delta,
                                         long long v, bool in) {
  const uint4 o = in ? old[v] : make_uint4(0, 0, 0, 0);
  const uint4 merged = in ? vmax4(o, __ldg(delta + v)) : o;
  const int rose = differs(merged, o);
  // Lanes 2i and 2i+1 hold the two halves of one 32-byte sector: store both
  // when either rose, so no sector is written half.
  const int sector = rose | __shfl_xor_sync(0xffffffffu, rose, 1);
  if (in && sector) __stcs(old + v, merged);
  return rose;
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
delta_merge_kernel(uint4* __restrict__ old, const uint4* __restrict__ delta,
                   uint8_t* __restrict__ changed, long long row_vecs,
                   long long chunk_vecs, long long chunks) {
  const long long row = blockIdx.x / chunks;
  const long long first = (blockIdx.x - row * chunks) * chunk_vecs;
  const long long last = min(first + chunk_vecs, row_vecs);
  const long long begin = row * row_vecs + first, end = row * row_vecs + last;
  int rose = 0;
  long long step = begin;
  for (; step + kThreads <= end; step += kThreads)
    rose |= merge_vec(old, delta, step + threadIdx.x, true);
  if (step < end)  // a ragged last step: the block takes it together
    rose |= merge_vec(old, delta, step + threadIdx.x, step + threadIdx.x < end);
  rose = __syncthreads_or(rose);
  if (threadIdx.x != 0) return;
  if (chunks == 1)
    changed[row] = rose ? 1 : 0;  // the block owns the whole row
  else if (rose)
    changed[row] = 1;  // cleared by the entry; all writers store 1
}

}  // namespace

// old, delta: [t, l] uint8, contiguous, 16-byte aligned, l % 16 == 0;
// changed: [t] bytes (a torch.bool tensor), no initial contents. Returns the
// CUDA error code of the first failing call (0 on success).
extern "C" int delta_merge_u8(void* old, const void* delta, void* changed,
                              long long t, long long l, int device,
                              void* stream) {
  // This library's runtime keeps its own current device per thread: set it
  // once per thread and device, not on every call.
  thread_local int current = -1;
  if (current != device) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    current = device;
  }
  if (t <= 0 || l <= 0) return 0;
  if (l % 16) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long row_vecs = l / 16;
  const bool owned = row_vecs <= kOwnerRowVecs;
  const long long chunk_vecs = owned ? row_vecs : kChunkVecs;
  const long long chunks = (row_vecs + chunk_vecs - 1) / chunk_vecs;
  const long long blocks = t * chunks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (!owned) {
    const cudaError_t err = cudaMemsetAsync(changed, 0, static_cast<size_t>(t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  uint4* o = static_cast<uint4*>(old);
  const uint4* d = static_cast<const uint4*>(delta);
  uint8_t* c = static_cast<uint8_t*>(changed);
  const unsigned g = static_cast<unsigned>(blocks);
  if (owned)
    delta_merge_kernel<kOwnerThreads><<<g, kOwnerThreads, 0, s>>>(
        o, d, c, row_vecs, chunk_vecs, chunks);
  else
    delta_merge_kernel<kChunkThreads><<<g, kChunkThreads, 0, s>>>(
        o, d, c, row_vecs, chunk_vecs, chunks);
  return static_cast<int>(cudaGetLastError());
}
