// PFMERGE over a stack of sketches: out[j] = max_i stack[rows[i], j] over
// an [S, m] int32 array, for the rows listed (they may repeat), or over
// every row when no list is given.
//
// Replaces: redisson_tpu/ops/pallas_kernels.py::_merge_kernel (merge_stack),
// which carried one [m] accumulator through a sequential grid over S. The
// client's PFMERGE and countWith merge a subset of the bank's rows; JAX
// gathers them into a fresh stack and reduces it (jnp.max). Here the list
// is read by the kernel, so the rows are read once from the bank and no
// gathered copy is written.
//
// Bound on the H100: memory. The kernel must read R*m*4 bytes once (64 MiB
// at R = 1024, m = 16384: ~20 us at 3.35 TB/s) and write m*4.
//
// Design: Hopper blocks run in parallel and in no order, so nothing can be
// carried from one block to the next. A grid over columns alone would give
// m / (256 threads * 4 lanes) = 16 blocks for m = 16384, far too few for
// 132 SMs. So the grid also splits the rows: block (x, y) folds rows
// [y*rows, (y+1)*rows) of the list of a 1024-column strip, each thread
// holding four columns as one 16-byte int4 load per row, and then combines
// its partial with atomicMax into the output, which the entry zeroes on the
// same stream first (one foreign call). Registers are >= 0 and max is
// order-independent, so the result is exact and the same on every run. A
// ragged row count needs no padding copy: the last row block is masked; a
// listed row outside [0, S) is skipped.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int4 max4(int4 a, int4 b) {
  return make_int4(max(a.x, b.x), max(a.y, b.y), max(a.z, b.z),
                   max(a.w, b.w));
}

// Row r of the merge (listed, or r itself), column `col` of its int4s.
__device__ __forceinline__ int4 load_row(const int4* __restrict__ stack,
                                         const int* __restrict__ rows,
                                         unsigned height, int m4, int col, int r) {
  const int w = rows != nullptr ? __ldg(rows + r) : r;
  if (static_cast<unsigned>(w) >= height) return make_int4(0, 0, 0, 0);
  return __ldg(stack + static_cast<size_t>(w) * m4 + col);
}

__global__ void merge_stack_kernel(const int4* __restrict__ stack,
                                   const int* __restrict__ rows,
                                   int* __restrict__ out, int s,
                                   unsigned height, int m4, int per) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= m4) return;
  const int r0 = blockIdx.y * per;
  const int r1 = min(s, r0 + per);
  if (r0 >= r1) return;
  int4 acc = make_int4(0, 0, 0, 0);
  int r = r0;
  // Four independent loads in flight per thread.
  for (; r + 4 <= r1; r += 4) {
    const int4 a = load_row(stack, rows, height, m4, col, r);
    const int4 b = load_row(stack, rows, height, m4, col, r + 1);
    const int4 c = load_row(stack, rows, height, m4, col, r + 2);
    const int4 d = load_row(stack, rows, height, m4, col, r + 3);
    acc = max4(acc, max4(max4(a, b), max4(c, d)));
  }
  for (; r < r1; ++r) acc = max4(acc, load_row(stack, rows, height, m4, col, r));
  int* o = out + 4 * col;
  atomicMax(o + 0, acc.x);
  atomicMax(o + 1, acc.y);
  atomicMax(o + 2, acc.z);
  atomicMax(o + 3, acc.w);
}

int use_device(int device) {
  // This library's runtime keeps its own current device per thread.
  thread_local int current = -1;
  if (current != device) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    current = device;
  }
  return 0;
}

}  // namespace

// stack: [height, m] int32, contiguous, 16-byte aligned, m % 4 == 0.
// rows: [s] int32 row indexes into the stack, or null for rows 0..s-1
// (then s == height). out: [m] int32, zeroed here before the kernel. `per`
// is the row count of one block. Returns the CUDA error code of the first
// failing call (0 on success).
extern "C" int merge_stack_i32(const void* stack, const void* rows, void* out,
                               int s, int height, int m, int per, int device,
                               void* stream) {
  int err = use_device(device);
  if (err) return err;
  if (s < 0 || height < 0 || m <= 0 || m % 4 || (s > 0 && per < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = static_cast<int>(cudaMemsetAsync(out, 0, sizeof(int) * static_cast<size_t>(m), st));
  if (err) return err;
  if (s == 0) return 0;
  const int m4 = m / 4;
  dim3 grid((m4 + kThreads - 1) / kThreads, (s + per - 1) / per);
  merge_stack_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const int4*>(stack), static_cast<const int*>(rows),
      static_cast<int*>(out), s, static_cast<unsigned>(height), m4, per);
  return static_cast<int>(cudaGetLastError());
}
