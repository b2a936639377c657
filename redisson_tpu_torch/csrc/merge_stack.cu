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
// Bound on the H100: memory. The kernel must read R*m*4 bytes once (16 MiB
// at R = 256, m = 16384: ~5 us at 3.35 TB/s) and write m*4. At that size
// the host's cost of a call is as large as the device's, so a call is one
// foreign call and one launch, with nothing else on the stream.
//
// Design: Hopper blocks run in parallel and in no order, so nothing can be
// carried from one block to the next, and a grid over columns alone gives
// too few blocks (m / 512 columns = 32 for m = 16384). So the grid is
// strips of columns (x) times row splits (y), and the row splits of one
// strip form one thread block cluster (8 blocks, the portable size; up to
// 16 with the non-portable attribute, which measured slower). Each block
// folds its rows of the strip into registers, a thread holding four
// columns as one 16-byte int4 load per row with kDepth loads in flight,
// and stages its partial in shared memory. After cluster.sync(), block
// rank r reads its 1/C slice of every peer's partial through distributed
// shared memory and writes that slice of the output with plain 16-byte
// stores; a second cluster.sync() keeps each block resident until its
// peers have read it. The output is written once and never read: no
// zeroing, no atomics, one launch. Registers are >= 0 and max is
// order-independent, so the result is exact and the same on every run. A
// ragged row count needs no padding: the last split is short; a listed row
// outside [0, height) is skipped.
//
// Row lists come in three forms, one kernel instantiation each: every row
// (no list), a device int32 vector, or a host list copied into the launch's
// parameters (by value, capacity 64, 1024 or 8000 rows: up to 32,000 bytes
// of the 32,764 that Hopper takes with CUDA 12.1 or later), which spares
// the caller an allocation and a host-to-device copy per merge, and the
// kernel a dependent load of each row index.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

#if CUDART_VERSION < 12010
#error "merge_stack.cu needs CUDA 12.1 or later (32 KB kernel parameters)"
#endif

namespace {

constexpr int kMaxThreads = 256;  // int4 columns of the widest strip
constexpr int kMaxCluster = 16;
constexpr int kDepth = 16;        // independent 16-byte loads per thread in flight
constexpr int kMaxDevices = 64;

struct AllRows {
  __device__ __forceinline__ int operator[](int i) const { return i; }
};

struct DeviceRows {
  const int* idx;
  __device__ __forceinline__ int operator[](int i) const { return __ldg(idx + i); }
};

template <int N>
struct HostRows {
  int idx[N];
  __device__ __forceinline__ int operator[](int i) const { return idx[i]; }
};

__device__ __forceinline__ int4 max4(int4 a, int4 b) {
  return make_int4(max(a.x, b.x), max(a.y, b.y), max(a.z, b.z),
                   max(a.w, b.w));
}

// Row w of the stack, int4 column `col`; zeros for a row out of range.
__device__ __forceinline__ int4 load_row(const int4* __restrict__ stack, int w,
                                         unsigned height, int m4, int col) {
  if (static_cast<unsigned>(w) >= height) return make_int4(0, 0, 0, 0);
  return __ldg(stack + static_cast<size_t>(w) * m4 + col);
}

// grid (strips, splits), cluster (1, splits, 1): block (x, y) folds list
// entries [y*per, (y+1)*per) over int4 columns [x*blockDim.x, (x+1)*
// blockDim.x), kDepth entries at a time: kDepth independent 16-byte loads
// issued before any fold, a short last batch masked (never a serial
// tail). `rows` is a __grid_constant__ so that a list passed by value is
// indexed in the parameter space, never copied per thread.
template <class Rows>
__global__ void __launch_bounds__(kMaxThreads)
    merge_kernel(const int4* __restrict__ stack, const __grid_constant__ Rows rows,
                 int4* __restrict__ out, int s, unsigned height, int m4, int per) {
  __shared__ int4 part[kMaxThreads];
  const int width = static_cast<int>(blockDim.x);
  const int base = static_cast<int>(blockIdx.x) * width;
  const int col = base + static_cast<int>(threadIdx.x);
  int4 acc = make_int4(0, 0, 0, 0);
  if (col < m4) {
    const int r0 = static_cast<int>(blockIdx.y) * per;
    const int n = min(s - r0, per);
    // Strips start at different rows of their split (rotation by kDepth
    // rows per strip): strips running together then read different rows,
    // whose addresses spread over more memory channels than one row's.
    const int off = static_cast<int>((static_cast<long long>(blockIdx.x) * kDepth) % n);
    for (int i = 0; i < n; i += kDepth) {
      int4 v[kDepth];
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        int k = i + u + off;
        k -= k >= n ? n : 0;
        v[u] = i + u < n ? load_row(stack, rows[r0 + k], height, m4, col)
                         : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kDepth; ++u) acc = max4(acc, v[u]);
    }
  }
  part[threadIdx.x] = acc;

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's partial of the strip is staged
  const int size = static_cast<int>(cluster.num_blocks());
  const int me = static_cast<int>(cluster.block_rank());
  const int j = width * me / size + static_cast<int>(threadIdx.x);
  if (j < width * (me + 1) / size && base + j < m4) {
    int4 a = make_int4(0, 0, 0, 0);
#pragma unroll 4
    for (int q = 0; q < size; ++q) a = max4(a, cluster.map_shared_rank(part, q)[j]);
    out[base + j] = a;
  }
  cluster.sync();  // no block leaves while a peer reads its shared memory
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

template <class Rows>
int launch(const Rows& rows, const void* stack, void* out, int s, int height,
           int m4, int threads, int cluster, int per, int device,
           cudaStream_t stream) {
  if (cluster > 8) {  // the non-portable size: allowed once per device
    static bool allowed[kMaxDevices];
    if (!allowed[device]) {
      const cudaError_t err = cudaFuncSetAttribute(
          merge_kernel<Rows>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return static_cast<int>(err);
      allowed[device] = true;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((m4 + threads - 1) / threads),
                     static_cast<unsigned>(cluster));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int4* stack4 = static_cast<const int4*>(stack);
  int4* out4 = static_cast<int4*>(out);
  unsigned h = static_cast<unsigned>(height);
  void* args[] = {&stack4, const_cast<Rows*>(&rows), &out4, &s, &h, &m4, &per};
  return static_cast<int>(cudaLaunchKernelExC(
      &cfg, reinterpret_cast<const void*>(merge_kernel<Rows>), args));
}

template <int N>
int launch_host(const void* rows, int s, const void* stack, void* out,
                int height, int m4, int threads, int cluster, int per, int device,
                cudaStream_t stream) {
  HostRows<N> list;  // only the first s entries are set; the launch copies it
  memcpy(list.idx, rows, sizeof(int) * static_cast<size_t>(s));
  return launch(list, stack, out, s, height, m4, threads, cluster, per, device, stream);
}

}  // namespace

// stack: [height, m] int32 (>= 0), contiguous, 16-byte aligned, m % 4 == 0.
// out: [m] int32, 16-byte aligned, written in full (never read).
// rows: with cap == 0, a device int32 vector of s row indexes, or null for
// rows 0..s-1 (then s == height); with cap in {64, 1024, 8000} (>= s), a
// host int32 vector of s row indexes, copied into the launch's parameters.
// The grid, from ops.kernels.merge_plan: strips of strip_cols columns (a
// multiple of 128, at most 1024), clusters of `cluster` row splits (1..16)
// of `per` rows each, covering the s entries. s == 0 launches nothing.
// Returns the CUDA error code of the first failing call (0 on success).
extern "C" int merge_stack_i32(const void* stack, const void* rows, void* out,
                               int s, int height, int m, int strip_cols,
                               int cluster, int per, int cap, int device,
                               void* stream) {
  if (s < 0 || height < 0 || m <= 0 || m % 4 || strip_cols < 128 ||
      strip_cols % 128 || strip_cols > 4 * kMaxThreads || device < 0 ||
      device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  if (s == 0) return 0;
  if (cluster < 1 || cluster > kMaxCluster || per < 1 ||
      static_cast<long long>(cluster) * per < s || (cluster - 1) * per >= s ||
      (rows == nullptr && (cap != 0 || s != height)))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = use_device(device);
  if (err) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m4 = m / 4;
  const int threads = strip_cols / 4;
  switch (cap) {
    case 0:
      return rows == nullptr
                 ? launch(AllRows{}, stack, out, s, height, m4, threads, cluster, per,
                          device, st)
                 : launch(DeviceRows{static_cast<const int*>(rows)}, stack, out, s, height,
                          m4, threads, cluster, per, device, st);
    case 64:
      if (s > 64) break;
      return launch_host<64>(rows, s, stack, out, height, m4, threads, cluster, per,
                             device, st);
    case 1024:
      if (s > 1024) break;
      return launch_host<1024>(rows, s, stack, out, height, m4, threads, cluster, per,
                               device, st);
    case 8000:
      if (s > 8000) break;
      return launch_host<8000>(rows, s, stack, out, height, m4, threads, cluster, per,
                               device, st);
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same arguments, no work: what a foreign call of this signature costs
// the host (chip_smoke.py's breakdown of a merge's host time).
extern "C" int merge_stack_noop(const void*, const void*, void*, int, int, int,
                                int, int, int, int, int, void*) {
  return 0;
}
