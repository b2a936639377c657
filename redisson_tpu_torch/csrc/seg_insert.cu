// Segmented insert: fold sorted `bucket << shift | value` codes into a
// register / cell array, `out = max(regs, segment_max(codes))`.
//
// Replaces: redisson_tpu/ingest/kernels.py::_seg_kernel as called by
// hll_insert_segmented (shift=6, int32 registers). The Bloom segment-OR,
// the same Pallas body at shift=0, has its own sort-free kernel in
// bits_insert.cu.
//
// Bound on the H100: memory. The kernel reads each sorted code once (4 B),
// the tile spans, the old registers, and writes the new registers: about
// N*4 + 2*m*4 bytes. At N = 2^21 and m = 16384 that is 8.5 MB, ~2.5 us at
// 3.35 TB/s. It does one compare per code, far below any compute limit.
//
// Design: one thread block per register tile. The block reads its own span
// [starts[t], starts[t+1]) of the sorted codes (no scalar prefetch on
// Hopper). The TPU kernel dense-expanded each chunk of codes against the
// whole tile, a (chunk, tile) compare, because the TPU has no scatter unit;
// here the fold is a scatter into a shared-memory tile. It needs no atomics:
// the codes are sorted by (bucket, value), so the last code of each bucket
// run carries that bucket's maximum, and only that code stores into the
// tile with a plain store. A hot bucket (Zipf keys) therefore costs nothing
// extra. Padding and invalid lanes arrive as code 0 (bucket 0, value 0); a
// value of 0 never raises a register, so they are no-ops as in JAX. Codes
// past the last tile are in no span, and the write guard `r < m` covers a
// ragged last tile.
// The block writes a fresh output array, so the caller can compare old and
// new registers for PFADD's "changed" flag.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void seg_insert_kernel(const int32_t* __restrict__ codes, int n,
                                  const int32_t* __restrict__ starts,
                                  const T* __restrict__ regs,
                                  T* __restrict__ out, int m, int tile,
                                  int shift) {
  extern __shared__ int32_t acc[];
  const int base = blockIdx.x * tile;
  for (int j = threadIdx.x; j < tile; j += blockDim.x) acc[j] = 0;
  __syncthreads();

  const int lo = starts[blockIdx.x];
  const int hi = starts[blockIdx.x + 1];
  const int32_t vmask = (1 << shift) - 1;
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const int32_t c = codes[i];
    const int32_t bucket = c >> shift;  // codes are >= 0
    // Only the last code of a bucket run holds the run's maximum.
    if (i + 1 < n && (codes[i + 1] >> shift) == bucket) continue;
    acc[bucket - base] = shift ? (c & vmask) : 1;
  }
  __syncthreads();

  for (int j = threadIdx.x; j < tile; j += blockDim.x) {
    const long long r = static_cast<long long>(base) + j;  // m < 2^31
    if (r < m) {
      const int32_t v = max(static_cast<int32_t>(regs[r]), acc[j]);
      out[r] = static_cast<T>(v);
    }
  }
}

template <typename T>
int launch(const void* codes, int n, const void* starts, const void* regs,
           void* out, int m, int tile, int shift, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int g = (m + tile - 1) / tile;
  if (g == 0) return 0;
  seg_insert_kernel<T><<<g, kThreads, tile * sizeof(int32_t),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(codes), n,
      static_cast<const int32_t*>(starts), static_cast<const T*>(regs),
      static_cast<T*>(out), m, tile, shift);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `starts` holds g+1 span offsets into the sorted `codes` (g = ceil(m/tile)).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int seg_insert_i32(const void* codes, int n, const void* starts,
                              const void* regs, void* out, int m, int tile,
                              int shift, int device, void* stream) {
  return launch<int32_t>(codes, n, starts, regs, out, m, tile, shift, device,
                         stream);
}
