// BITOP AND | OR | XOR over a [K, n] uint8 cell stack -> [n]:
// out[j] = stack[0, j] op stack[1, j] op ... op stack[K-1, j].
//
// Replaces: redisson_tpu/ops/pallas_kernels.py::_bitop_kernel (bitop_cells),
// which streamed (K, 2^18) blocks through VMEM on a sequential grid and
// folded the K rows in an unrolled loop.
//
// Bound on the H100: memory. The kernel reads K*n bytes and writes n: at
// K = 8, n = 2^27 (a week of daily 2^27-bit bitmaps), 1.2 GB, 361 us at
// 3.35 TB/s. One bitwise op per byte and operand is far below any limit.
//
// Design: the TPU's fixed blocks become a grid-stride loop over 16-byte
// vectors, sized to keep every SM busy. The K loads of one vector do not
// depend on each other, so the unrolled fold keeps them in flight together
// and one thread has up to K * 16 bytes moving. The operation is a
// template parameter, chosen once per launch. Rows whose length is not a
// multiple of 16 (no 16-byte alignment for rows past the first) take a
// byte-wide loop instead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

enum Op { kAnd = 0, kOr = 1, kXor = 2 };

template <int OP>
__device__ __forceinline__ unsigned apply(unsigned a, unsigned b) {
  if (OP == kAnd) return a & b;
  if (OP == kOr) return a | b;
  return a ^ b;
}

template <int OP>
__device__ __forceinline__ uint4 apply4(uint4 a, uint4 b) {
  return make_uint4(apply<OP>(a.x, b.x), apply<OP>(a.y, b.y),
                    apply<OP>(a.z, b.z), apply<OP>(a.w, b.w));
}

template <int OP>
__global__ void bitop_vec_kernel(const uint4* __restrict__ stack,
                                 uint4* __restrict__ out, int k,
                                 long long nvec) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < nvec; i += stride) {
    uint4 acc = __ldg(stack + i);
#pragma unroll 8
    for (int r = 1; r < k; ++r) {
      acc = apply4<OP>(acc, __ldg(stack + r * nvec + i));
    }
    out[i] = acc;
  }
}

template <int OP>
__global__ void bitop_byte_kernel(const uint8_t* __restrict__ stack,
                                  uint8_t* __restrict__ out, int k,
                                  long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    unsigned acc = stack[i];
    for (int r = 1; r < k; ++r) acc = apply<OP>(acc, stack[r * n + i]);
    out[i] = static_cast<uint8_t>(acc);
  }
}

unsigned grid_for(long long items) {
  const long long want = (items + kThreads - 1) / kThreads;
  return static_cast<unsigned>(want < kMaxBlocks ? want : kMaxBlocks);
}

template <int OP>
void launch(const void* stack, void* out, int k, long long n, bool vec,
            cudaStream_t stream) {
  if (vec) {
    const long long nvec = n / 16;
    bitop_vec_kernel<OP><<<grid_for(nvec), kThreads, 0, stream>>>(
        static_cast<const uint4*>(stack), static_cast<uint4*>(out), k, nvec);
  } else {
    bitop_byte_kernel<OP><<<grid_for(n), kThreads, 0, stream>>>(
        static_cast<const uint8_t*>(stack), static_cast<uint8_t*>(out), k, n);
  }
}

}  // namespace

// stack: [k, n] uint8, contiguous, k >= 1; out: [n] uint8. op: 0 and, 1 or,
// 2 xor. `vec` (n % 16 == 0, both pointers 16-byte aligned) selects the
// 16-byte path. Returns the CUDA error code of the launch (0 on success).
extern "C" int bitop_u8(const void* stack, void* out, int k, long long n,
                        int op, int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || k <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kAnd: launch<kAnd>(stack, out, k, n, vec != 0, s); break;
    case kOr: launch<kOr>(stack, out, k, n, vec != 0, s); break;
    case kXor: launch<kXor>(stack, out, k, n, vec != 0, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
