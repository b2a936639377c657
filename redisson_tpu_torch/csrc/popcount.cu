// BITCOUNT partials: per-block int32 sums over an [n] uint8 cell array
// (one cell per bit, value 0/1), out[g] = sum(cells[g*block, (g+1)*block)).
//
// Replaces: redisson_tpu/ops/pallas_kernels.py::_popcount_kernel
// (popcount_partials), which gave each 2^18-cell grid step one SMEM scalar.
// The partition is the same (one block per 2^18 cells, the ragged tail
// counted as zeros), so the partials compare one to one; the int64 combine
// stays on the host.
//
// Bound on the H100: memory. The kernel reads n bytes once and writes 4 B
// per block: at n = 257,296,945 (a 10M-key Bloom filter), 77 us at
// 3.35 TB/s. The arithmetic is one __dp4a per 4 cells, far below any limit.
//
// Design: the TPU streamed one block through VMEM per sequential grid step.
// Here the 982 blocks of that size run in parallel on the 132 SMs. Each
// thread reads 16-byte vectors (four in flight per loop trip) and sums
// their bytes with __dp4a(word, 0x01010101): the exact byte sum, so a cell
// holding any value counts as the plain version counts it. A warp shuffle
// and one shared-memory step reduce the block's 256 sums. The ragged tail
// of the last block is read byte by byte.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kOnes = 0x01010101u;

__device__ __forceinline__ unsigned sum16(uint4 v, unsigned acc) {
  acc = __dp4a(v.x, kOnes, acc);
  acc = __dp4a(v.y, kOnes, acc);
  acc = __dp4a(v.z, kOnes, acc);
  return __dp4a(v.w, kOnes, acc);
}

__global__ void popcount_kernel(const uint8_t* __restrict__ cells,
                                long long n, int block,
                                int32_t* __restrict__ out) {
  const long long base = static_cast<long long>(blockIdx.x) * block;
  const long long len = min(static_cast<long long>(block), n - base);
  const uint8_t* p = cells + base;
  const uint4* pv = reinterpret_cast<const uint4*>(p);
  const long long nvec = len / 16;
  unsigned acc = 0;
  long long i = threadIdx.x;
  for (; i + 3 * kThreads < nvec; i += 4 * kThreads) {
    const uint4 a = __ldg(pv + i);
    const uint4 b = __ldg(pv + i + kThreads);
    const uint4 c = __ldg(pv + i + 2 * kThreads);
    const uint4 d = __ldg(pv + i + 3 * kThreads);
    acc = sum16(d, sum16(c, sum16(b, sum16(a, acc))));
  }
  for (; i < nvec; i += kThreads) acc = sum16(__ldg(pv + i), acc);
  for (long long j = nvec * 16 + threadIdx.x; j < len; j += kThreads) {
    acc += p[j];
  }

  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  __shared__ unsigned warp_sums[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    unsigned v = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0u;
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (threadIdx.x == 0) out[blockIdx.x] = static_cast<int32_t>(v);
  }
}

}  // namespace

// cells: [n] uint8, 16-byte aligned; block % 16 == 0 and block * 255 < 2^31.
// out: [ceil(n / block)] int32. Returns the CUDA error code of the launch.
extern "C" int popcount_partials_u8(const void* cells, long long n, int block,
                                    void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const long long g = (n + block - 1) / block;
  popcount_kernel<<<static_cast<unsigned>(g), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(cells), n, block,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
