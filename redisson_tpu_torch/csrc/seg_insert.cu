// HLL segmented insert, in place: for a batch of (bucket, rank) pairs,
//   regs[b] = max(regs[b], max{rank[i] : bucket[i] == b}),
// and, where a register rose, one "changed" byte set to 1 (PFADD's reply;
// the caller passes it cleared).
//
// Replaces: redisson_tpu/ingest/kernels.py::_seg_kernel as called by
// hll_insert_segmented (shift 6, int32 registers). JAX encodes each pair as
// a code bucket << 6 | rank, sorts the codes (jnp.sort, XLA) and the Pallas
// grid walks every register tile, dense-expanding each chunk of its span of
// sorted codes against the tile, into a fresh output. The Bloom segment-OR,
// the same Pallas body at shift 0, has its own kernel in bits_insert.cu.
//
// Bound on the H100: memory. The call must read bucket and rank once (8
// bytes a pair) and read and write the registers once: at 2^21 pairs and
// m = 16384 that is 16.91 MB, 0.00505 ms at 3.35 TB/s. A pair costs one
// compare and at most one atomic, far below any compute limit. At the
// client's batches (40,000 keys in 2^16 lanes) the bound is 0.2 us, below
// one launch: there the call is one launch and nothing else.
//
// Design: no sort, no code tensor, no fresh output, two kernels.
// - Both take the pairs straight from `bucket` and `rank` (int32 each) with
//   16-byte loads, several vectors of each per thread in flight. Ranks <= 0
//   (padded and invalid lanes) never fold; buckets outside [0, m) are
//   dropped, as in the Pallas kernel.
// - Read before atomic: a pair or a block's combined value takes an
//   atomicMax only where it exceeds the value read first. Once a bucket's
//   maximum is in, every later pair of that bucket is a compare, so a hot
//   bucket (Zipf keys) costs nothing extra.
// - seg_direct_kernel (small batches; any m): each thread reads the
//   registers its pairs land on and raises them in device memory. The
//   64 KiB of registers stays in L2, so a 2^16-lane batch costs two
//   dependent memory round trips after the launch.
// - seg_rows_kernel (multi-target runs into an [S, m] bank): the direct
//   kernel's scheme with each pair's row read beside its bucket and rank,
//   one launch for a chunk of a run whatever its target count. JAX's
//   kernel takes one register array of int32 codes bucket << 6 | rank and
//   keeps multi-target runs on a flat scatter (row * m + bucket codes
//   would overflow them for large banks); here the row is an int32 of its
//   own, so no code overflows. Each raising pair sets its row's flag.
// - seg_shared_kernel (large batches, m <= kMaxRegisters): each block folds
//   one contiguous slice of the pairs into a block-private copy of the
//   registers in shared memory (64 KiB at p = 14) with shared atomics.
//   Blocks run in thread block clusters of up to 8 on neighbouring SMs:
//   after a cluster barrier each block owns 1/size of the registers, takes
//   the max of the cluster's copies of that slice through distributed
//   shared memory, reads the registers of the slice with 16-byte loads and
//   raises them with global atomics. The cluster cuts the flush's register
//   reads and atomics by its size.
// - The flag is exact: an atomic is issued only where the value exceeds a
//   register value read after the call began, which is at least the
//   register's value from before the call, so every atomic raises the final
//   register above its old value; and a register that ends above its old
//   value had an atomic issued for it (if none were, it would still hold its
//   old value, and the pair or block holding its maximum would have issued
//   one). Every register ends as max(old, all ranks) whatever the order, so
//   registers and flag are deterministic and bit-identical to the plain
//   version. A block that issued an atomic stores byte 1 into the flag; no
//   block stores 0, so the flag needs no clear of its own (the engine's
//   flags are a zeroed tensor) and the call is one launch.
// - The host picks the kernel and the grid (`ingest/kernels.py` seg_plan):
//   the direct kernel for small batches, the shared one above, about 8K
//   pairs a block, at most 64 blocks: more blocks multiply the zeroing and
//   flush of the 64 KiB copies, and 128 blocks in clusters of 8 do not all
//   fit on the card at once (PERF.md). Registers are >= 0; the shared
//   kernel takes m a multiple of 4 of at most kMaxRegisters (the block's
//   shared-memory copy).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;          // seg_shared_kernel
constexpr int kUnroll = 4;              // 16-byte vectors of each input in flight
constexpr int kDirectThreads = 256;     // seg_direct_kernel
constexpr int kDirectUnroll = 2;
constexpr int kMaxRegisters = 1 << 15;  // 128 KiB of int32 in shared memory
constexpr int kMaxCluster = 8;          // the portable cluster size
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void fold(int* acc, unsigned m, int b, int r) {
  if (static_cast<unsigned>(b) < m && r > acc[b]) atomicMax(acc + b, r);
}

__device__ __forceinline__ void fold4(int* acc, unsigned m, int4 b, int4 r) {
  fold(acc, m, b.x, r.x);
  fold(acc, m, b.y, r.y);
  fold(acc, m, b.z, r.z);
  fold(acc, m, b.w, r.w);
}

__device__ __forceinline__ int4 max4(int4 a, int4 b) {
  return make_int4(max(a.x, b.x), max(a.y, b.y), max(a.z, b.z), max(a.w, b.w));
}

// Raises one register where `a` exceeds its value `o` read before; returns
// 1 where it issued the atomic.
__device__ __forceinline__ int lift(int* reg, int a, int o) {
  if (a <= o) return 0;
  atomicMax(reg, a);
  return 1;
}

// The value of register b as read before its atomic, or INT_MAX for a pair
// that must not fold (rank <= 0 or b outside [0, m)).
__device__ __forceinline__ int seen(const int* regs, unsigned m, int b, int r) {
  return r > 0 && static_cast<unsigned>(b) < m ? regs[b] : 0x7fffffff;
}

__global__ void __launch_bounds__(kDirectThreads)
seg_direct_kernel(int* regs, unsigned m, const int* __restrict__ bucket,
                  const int* __restrict__ rank, long long n,
                  uint8_t* changed) {
  const long long nvec = n >> 2;
  const long long v0 = static_cast<long long>(blockIdx.x) * kDirectUnroll *
                           kDirectThreads + threadIdx.x;
  const int4* b4 = reinterpret_cast<const int4*>(bucket);
  const int4* r4 = reinterpret_cast<const int4*>(rank);
  int4 b[kDirectUnroll], r[kDirectUnroll], o[kDirectUnroll];
#pragma unroll
  for (int u = 0; u < kDirectUnroll; ++u) {
    const long long v = v0 + u * kDirectThreads;
    const bool in = v < nvec;
    b[u] = in ? __ldg(b4 + v) : make_int4(0, 0, 0, 0);
    r[u] = in ? __ldg(r4 + v) : make_int4(0, 0, 0, 0);  // rank 0: no fold
  }
#pragma unroll
  for (int u = 0; u < kDirectUnroll; ++u)
    o[u] = make_int4(seen(regs, m, b[u].x, r[u].x), seen(regs, m, b[u].y, r[u].y),
                     seen(regs, m, b[u].z, r[u].z), seen(regs, m, b[u].w, r[u].w));
  int rose = 0;
#pragma unroll
  for (int u = 0; u < kDirectUnroll; ++u) {
    rose |= lift(regs + b[u].x, r[u].x, o[u].x);
    rose |= lift(regs + b[u].y, r[u].y, o[u].y);
    rose |= lift(regs + b[u].z, r[u].z, o[u].z);
    rose |= lift(regs + b[u].w, r[u].w, o[u].w);
  }
  // The n % 4 pairs past the last vector: the first block's first threads.
  const long long i = (nvec << 2) + threadIdx.x;
  if (blockIdx.x == 0 && i < n) {
    const int bi = __ldg(bucket + i), ri = __ldg(rank + i);
    rose |= lift(regs + bi, ri, seen(regs, m, bi, ri));
  }
  if (__syncthreads_or(rose) && threadIdx.x == 0 && changed != nullptr) *changed = 1;
}

// Raises the register `p` points at to `a` where `a` exceeds the value `o`
// read before, and sets its row's flag byte (read first: most raises find it
// set already).
__device__ __forceinline__ void lift_row(int* p, int a, int o, uint8_t* flag) {
  if (a <= o) return;
  atomicMax(p, a);
  if (flag != nullptr && *flag == 0) *flag = 1;
}

// The register of pair (w, b, r) in an [s, m] bank, or null for a pair that
// must not fold (rank <= 0, or row or bucket out of range).
__device__ __forceinline__ int* bank_reg(int* bank, unsigned s, unsigned m,
                                         int w, int b, int r) {
  return r > 0 && static_cast<unsigned>(w) < s && static_cast<unsigned>(b) < m
             ? bank + static_cast<size_t>(w) * m + b
             : nullptr;
}

// The multi-target insert: pair i folds into row row[i] of an [s, m] bank
// and sets flag byte changed[row[i]] where it raised a register. The direct
// kernel's scheme (every pair reads its register, then raises it with one
// atomic where it exceeds what it read), with the row read beside the
// bucket and rank; the flag argument is the same, per row.
__global__ void __launch_bounds__(kDirectThreads)
seg_rows_kernel(int* bank, unsigned s, unsigned m, const int* __restrict__ bucket,
                const int* __restrict__ rank, const int* __restrict__ row,
                long long n, uint8_t* changed) {
  constexpr int kLanes = 4 * kDirectUnroll;
  const long long nvec = n >> 2;
  const long long v0 = static_cast<long long>(blockIdx.x) * kDirectUnroll *
                           kDirectThreads + threadIdx.x;
  const int4* b4 = reinterpret_cast<const int4*>(bucket);
  const int4* r4 = reinterpret_cast<const int4*>(rank);
  const int4* w4 = reinterpret_cast<const int4*>(row);
  int b[kLanes], r[kLanes], w[kLanes];
#pragma unroll
  for (int u = 0; u < kDirectUnroll; ++u) {
    const long long v = v0 + u * kDirectThreads;
    const bool in = v < nvec;
    const int4 bv = in ? __ldg(b4 + v) : make_int4(0, 0, 0, 0);
    const int4 rv = in ? __ldg(r4 + v) : make_int4(0, 0, 0, 0);  // rank 0: no fold
    const int4 wv = in ? __ldg(w4 + v) : make_int4(0, 0, 0, 0);
    b[4 * u] = bv.x; b[4 * u + 1] = bv.y; b[4 * u + 2] = bv.z; b[4 * u + 3] = bv.w;
    r[4 * u] = rv.x; r[4 * u + 1] = rv.y; r[4 * u + 2] = rv.z; r[4 * u + 3] = rv.w;
    w[4 * u] = wv.x; w[4 * u + 1] = wv.y; w[4 * u + 2] = wv.z; w[4 * u + 3] = wv.w;
  }
  int* p[kLanes];
  int o[kLanes];
#pragma unroll
  for (int k = 0; k < kLanes; ++k) p[k] = bank_reg(bank, s, m, w[k], b[k], r[k]);
#pragma unroll
  for (int k = 0; k < kLanes; ++k) o[k] = p[k] != nullptr ? *p[k] : 0x7fffffff;
#pragma unroll
  for (int k = 0; k < kLanes; ++k)
    lift_row(p[k], r[k], o[k], changed != nullptr ? changed + w[k] : nullptr);
  // The n % 4 pairs past the last vector: the first block's first threads.
  const long long i = (nvec << 2) + threadIdx.x;
  if (blockIdx.x == 0 && i < n) {
    const int wi = __ldg(row + i), ri = __ldg(rank + i);
    int* pi = bank_reg(bank, s, m, wi, __ldg(bucket + i), ri);
    if (pi != nullptr) lift_row(pi, ri, *pi, changed != nullptr ? changed + wi : nullptr);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
seg_shared_kernel(int* regs, int m, const int* __restrict__ bucket,
                  const int* __restrict__ rank, long long n, long long per,
                  uint8_t* changed) {
  extern __shared__ int4 acc4[];
  int* acc = reinterpret_cast<int*>(acc4);
  const int m4 = m >> 2;
  for (int j = threadIdx.x; j < m4; j += kThreads) acc4[j] = make_int4(0, 0, 0, 0);
  __syncthreads();

  // This block's slice of the pairs: `per` is a multiple of 4, so a slice
  // starts on a 16-byte vector and only the last one has a scalar tail.
  const long long begin = static_cast<long long>(blockIdx.x) * per;
  const long long end = min(begin + per, n);
  if (begin < end) {
    const int4* b4 = reinterpret_cast<const int4*>(bucket);
    const int4* r4 = reinterpret_cast<const int4*>(rank);
    const unsigned um = static_cast<unsigned>(m);
    const long long vend = end >> 2;
    for (long long v = (begin >> 2) + threadIdx.x; v < vend; v += kUnroll * kThreads) {
      int4 b[kUnroll], r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {  // every load before any fold
        const long long x = v + u * kThreads;
        const bool in = x < vend;
        b[u] = in ? __ldg(b4 + x) : make_int4(0, 0, 0, 0);
        r[u] = in ? __ldg(r4 + x) : make_int4(0, 0, 0, 0);  // rank 0: no fold
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) fold4(acc, um, b[u], r[u]);
    }
    const long long i = (vend << 2) + threadIdx.x;
    if (i < end) fold(acc, um, __ldg(bucket + i), __ldg(rank + i));
  }

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every copy of the cluster is complete
  const int size = static_cast<int>(cluster.num_blocks());
  const int me = static_cast<int>(cluster.block_rank());
  const int lo = static_cast<int>(static_cast<long long>(m4) * me / size);
  const int hi = static_cast<int>(static_cast<long long>(m4) * (me + 1) / size);
  int rose = 0;
  int4* regs4 = reinterpret_cast<int4*>(regs);
  for (int j = lo + threadIdx.x; j < hi; j += kThreads) {
    int4 c[kMaxCluster];  // every block's copy, all loads in flight at once
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      c[r] = r < size ? cluster.map_shared_rank(acc4, r)[j] : make_int4(0, 0, 0, 0);
    int4 a = c[0];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r) a = max4(a, c[r]);
    if ((a.x | a.y | a.z | a.w) == 0) continue;  // nothing for these four
    const int4 o = regs4[j];
    int* reg = regs + 4 * j;
    rose |= lift(reg, a.x, o.x);
    rose |= lift(reg + 1, a.y, o.y);
    rose |= lift(reg + 2, a.z, o.z);
    rose |= lift(reg + 3, a.w, o.w);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
  if (__syncthreads_or(rose) && threadIdx.x == 0 && changed != nullptr) *changed = 1;
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

// regs: [m] int32 (>= 0), in place; bucket, rank: [n] int32, 16-byte
// aligned; changed: one byte (a torch.bool element) set to 1 where a
// register rose, or null. Launches ceil(n / 2048) blocks. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int seg_insert_direct_i32(void* regs, int m, const void* bucket,
                                     const void* rank, long long n,
                                     void* changed, int device, void* stream) {
  const int err = use_device(device);
  if (err) return err;
  if (m < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const long long per_block = 4LL * kDirectThreads * kDirectUnroll;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  seg_direct_kernel<<<static_cast<unsigned>(blocks), kDirectThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(regs), static_cast<unsigned>(m),
      static_cast<const int*>(bucket), static_cast<const int*>(rank), n,
      static_cast<uint8_t*>(changed));
  return static_cast<int>(cudaGetLastError());
}

// regs: [m] int32 (>= 0), 16-byte aligned, m % 4 == 0, 4 <= m <= 2^15, in
// place; bucket, rank: [n] int32, 16-byte aligned; changed: as above;
// blocks: a multiple of `cluster` (1..8). Returns the CUDA error code of the
// first failing call (0 on success).
extern "C" int seg_insert_shared_i32(void* regs, int m, const void* bucket,
                                     const void* rank, long long n, int blocks,
                                     int cluster, void* changed, int device,
                                     void* stream) {
  int err = use_device(device);
  if (err) return err;
  if (m < 4 || m % 4 || m > kMaxRegisters || n < 0 || blocks < 1 ||
      cluster < 1 || cluster > kMaxCluster || blocks % cluster ||
      device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  static bool allowed[kMaxDevices];  // set once per device; a repeat is harmless
  if (!allowed[device]) {
    err = static_cast<int>(cudaFuncSetAttribute(
        seg_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(int) * kMaxRegisters)));
    if (err) return err;
    allowed[device] = true;
  }
  long long per = (n + blocks - 1) / blocks;
  per = (per + 3) & ~3LL;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = sizeof(int) * static_cast<size_t>(m);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = static_cast<int>(cudaLaunchKernelEx(
      &cfg, seg_shared_kernel, static_cast<int*>(regs), m,
      static_cast<const int*>(bucket), static_cast<const int*>(rank), n, per,
      static_cast<uint8_t*>(changed)));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// bank: [s, m] int32 (>= 0), in place; bucket, rank, row: [n] int32, 16-byte
// aligned; changed: [s] bytes (a torch.bool tensor), byte row[i] set to 1
// where pair i raised a register, or null. Pairs whose row lies outside
// [0, s) or bucket outside [0, m) are dropped. Launches ceil(n / 2048)
// blocks. Returns the CUDA error code of the launch (0 on success).
extern "C" int seg_insert_rows_i32(void* bank, int s, int m, const void* bucket,
                                   const void* rank, const void* row, long long n,
                                   void* changed, int device, void* stream) {
  const int err = use_device(device);
  if (err) return err;
  if (s < 1 || m < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const long long per_block = 4LL * kDirectThreads * kDirectUnroll;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  seg_rows_kernel<<<static_cast<unsigned>(blocks), kDirectThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(bank), static_cast<unsigned>(s), static_cast<unsigned>(m),
      static_cast<const int*>(bucket), static_cast<const int*>(rank),
      static_cast<const int*>(row), n, static_cast<uint8_t*>(changed));
  return static_cast<int>(cudaGetLastError());
}
