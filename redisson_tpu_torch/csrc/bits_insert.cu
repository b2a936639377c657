// Segment-OR: set `cells[c] = max(cells[c], 1)` in place over [m] uint8
// cells for every code c of a batch with 0 <= c < m (compared as unsigned:
// negative codes and the one-past-the-end sentinel m are dropped).
//
// Replaces: redisson_tpu/ingest/kernels.py::_seg_kernel as called by
// bits_insert_segmented (shift 0, value 1, uint8 cells). JAX sorts the codes
// (jnp.sort, XLA) and the Pallas grid walks every 1024-cell tile, dense-
// expanding each chunk of its span against the tile, into a fresh output.
//
// Bound on the H100: memory. The batch must read its codes once (n * 4 or
// n * 8 bytes) and read and write each 32-byte sector of cells it touches
// once: 2^21 * 7 random codes into m = 257,296,945 cells touch ~84% of the
// sectors. The work per code is a compare and a byte store.
//
// Design: no sort and no fresh output. The cells are cut into 64 KiB slabs
// and the codes are partitioned into one bin per slab (a counting sort on
// code >> 16), then one block per slab applies its bin in shared memory:
// - bin_count: each block histograms its contiguous chunk of codes per slab
//   in shared memory, then reserves its range in every slab it hit with one
//   global atomicAdd per (block, slab); bins keep no order, so the block
//   order in which the reservations land does not matter.
// - scan_counts: one block turns the slab totals into bin offsets.
// - bin_scatter: each block re-reads its chunk and writes every code's
//   16-bit offset within its slab into the slab's bin, through shared-memory
//   cursors that start at the block's reserved range.
// - slab_apply: one block per slab loads its 64 KiB of cells into registers
//   with 16-byte loads, marks its bin's offsets in a zeroed shared-memory
//   copy (byte stores; duplicate codes store the same byte, a benign race),
//   and writes back only the 32-byte sectors in which a cell rose.
// Global traffic is coalesced except the bin writes (2 bytes per code, each
// to a random bin), which set the call's time on the H100 (PERF.md): the
// codes are read twice, the bins written and read once and the filter read
// once and written where it changed. The wrapper gives 16-byte aligned
// cells; a ragged last slab takes its tail bytes one by one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlabShift = 16;  // 64 KiB of cells per slab: 16-bit offsets
constexpr int kSlabCells = 1 << kSlabShift;
constexpr int kBinThreads = 1024;
constexpr int kUnroll = 4;  // codes each thread has in flight
constexpr long long kMinCodesPerBlock = 8192;
constexpr int kScanThreads = 1024;
constexpr int kApplyThreads = 512;
constexpr int kWordsPerThread = kSlabCells / 16 / kApplyThreads;
constexpr int kMaxDevices = 64;
constexpr size_t kAlign = 256;

__device__ __forceinline__ uint32_t as_unsigned(int32_t c) {
  return static_cast<uint32_t>(c);
}
__device__ __forceinline__ unsigned long long as_unsigned(long long c) {
  return static_cast<unsigned long long>(c);
}

__device__ __forceinline__ uint4 vmax4(uint4 a, uint4 b) {
  return make_uint4(__vmaxu4(a.x, b.x), __vmaxu4(a.y, b.y),
                    __vmaxu4(a.z, b.z), __vmaxu4(a.w, b.w));
}

__device__ __forceinline__ bool differs(uint4 a, uint4 b) {
  return ((a.x ^ b.x) | (a.y ^ b.y) | (a.z ^ b.z) | (a.w ^ b.w)) != 0;
}

// Loads up to kUnroll codes of [i, hi) spaced kBinThreads apart; lanes past
// hi get -1, which no unsigned compare admits.
template <typename C>
__device__ __forceinline__ void load_codes(const C* __restrict__ codes,
                                           long long i, long long hi,
                                           C (&c)[kUnroll]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long j = i + static_cast<long long>(u) * kBinThreads;
    c[u] = j < hi ? __ldg(codes + j) : C(-1);
  }
}

template <typename C>
__global__ void __launch_bounds__(kBinThreads)
bin_count(const C* __restrict__ codes, long long n, long long per,
          unsigned long long m, int slabs, int* __restrict__ slab_count,
          int* __restrict__ block_base) {
  extern __shared__ int hist[];
  for (int s = threadIdx.x; s < slabs; s += kBinThreads) hist[s] = 0;
  __syncthreads();
  const long long lo = blockIdx.x * per;
  const long long hi = lo + per < n ? lo + per : n;
  for (long long i = lo + threadIdx.x; i < hi; i += kUnroll * kBinThreads) {
    C c[kUnroll];
    load_codes(codes, i, hi, c);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned long long v = as_unsigned(c[u]);
      if (v < m) atomicAdd(&hist[v >> kSlabShift], 1);
    }
  }
  __syncthreads();
  int* base = block_base + static_cast<long long>(blockIdx.x) * slabs;
  for (int s = threadIdx.x; s < slabs; s += kBinThreads) {
    const int h = hist[s];
    base[s] = h ? atomicAdd(&slab_count[s], h) : 0;
  }
}

// Exclusive scan of the slab totals: start[s] = sum of count[0, s),
// start[slabs] = the number of valid codes.
__global__ void __launch_bounds__(kScanThreads)
scan_counts(const int* __restrict__ count, int slabs, int* __restrict__ start) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int per = (slabs + kScanThreads - 1) / kScanThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, slabs);
  const int hi = min(lo + per, slabs);
  int sum = 0;
  for (int s = lo; s < hi; ++s) sum += count[s];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = warp_sums[lane];
    int wincl = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, wincl, d);
      if (lane >= d) wincl += v;
    }
    warp_sums[lane] = wincl - w;
  }
  __syncthreads();
  int run = warp_sums[warp] + incl - sum;
  for (int s = lo; s < hi; ++s) {
    start[s] = run;
    run += count[s];
  }
  if (threadIdx.x == kScanThreads - 1) start[slabs] = run;
}

template <typename C>
__global__ void __launch_bounds__(kBinThreads)
bin_scatter(const C* __restrict__ codes, long long n, long long per,
            unsigned long long m, int slabs, const int* __restrict__ slab_start,
            const int* __restrict__ block_base, uint16_t* __restrict__ bins) {
  extern __shared__ int cursor[];
  const int* base = block_base + static_cast<long long>(blockIdx.x) * slabs;
  for (int s = threadIdx.x; s < slabs; s += kBinThreads)
    cursor[s] = slab_start[s] + base[s];
  __syncthreads();
  const long long lo = blockIdx.x * per;
  const long long hi = lo + per < n ? lo + per : n;
  for (long long i = lo + threadIdx.x; i < hi; i += kUnroll * kBinThreads) {
    C c[kUnroll];
    load_codes(codes, i, hi, c);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned long long v = as_unsigned(c[u]);
      if (v < m) {
        const int pos = atomicAdd(&cursor[v >> kSlabShift], 1);
        bins[pos] = static_cast<uint16_t>(v & (kSlabCells - 1));
      }
    }
  }
}

__global__ void __launch_bounds__(kApplyThreads)
slab_apply(uint8_t* __restrict__ cells, long long m,
           const int* __restrict__ slab_start,
           const uint16_t* __restrict__ bins) {
  extern __shared__ uint4 marks[];  // kSlabCells bytes
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const long long base = static_cast<long long>(blockIdx.x) << kSlabShift;
  const int len = static_cast<int>(m - base < kSlabCells ? m - base : kSlabCells);
  const int full = len / 16;  // whole 16-byte words of this slab
  uint4* words = reinterpret_cast<uint4*>(cells + base);
  uint4 old[kWordsPerThread];
#pragma unroll
  for (int w = 0; w < kWordsPerThread; ++w) {
    const int j = threadIdx.x + w * kApplyThreads;
    old[w] = j < full ? words[j] : zero;
  }
#pragma unroll
  for (int w = 0; w < kWordsPerThread; ++w)
    marks[threadIdx.x + w * kApplyThreads] = zero;
  __syncthreads();
  uint8_t* mark = reinterpret_cast<uint8_t*>(marks);
  const int lo = slab_start[blockIdx.x], hi = slab_start[blockIdx.x + 1];
  for (int i = lo + threadIdx.x; i < hi; i += kUnroll * kApplyThreads) {
    uint16_t b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = i + u * kApplyThreads;
      b[u] = j < hi ? __ldcs(bins + j) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + u * kApplyThreads < hi) mark[b[u]] = 1;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWordsPerThread; ++w) {
    const int j = threadIdx.x + w * kApplyThreads;
    const uint4 merged = vmax4(old[w], marks[j]);
    const int rose = j < full && differs(merged, old[w]);
    // Lanes 2i and 2i+1 hold one 32-byte sector: store it whole or not at all.
    const int sector = rose | __shfl_xor_sync(0xffffffffu, rose, 1);
    if (j < full && sector) words[j] = merged;
  }
  const int tail = len - full * 16;  // the ragged end of the last slab
  if (static_cast<int>(threadIdx.x) < tail) {
    const int c = full * 16 + threadIdx.x;
    if (mark[c] > cells[base + c]) cells[base + c] = mark[c];
  }
}

struct Layout {
  int slabs;
  int grid;
  long long per;
  size_t count_off, start_off, base_off, bins_off, bytes;
};

size_t align_up(size_t x) { return (x + kAlign - 1) / kAlign * kAlign; }

int sm_count(int device) {
  static int sms[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return 132;
  if (sms[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess ||
        n <= 0)
      n = 132;
    sms[device] = n;
  }
  return sms[device];
}

Layout layout(long long n, long long m, int device) {
  Layout l;
  l.slabs = static_cast<int>((m + kSlabCells - 1) >> kSlabShift);
  long long grid = (n + kMinCodesPerBlock - 1) / kMinCodesPerBlock;
  if (grid > sm_count(device)) grid = sm_count(device);
  if (grid < 1) grid = 1;
  l.grid = static_cast<int>(grid);
  l.per = (n + grid - 1) / grid;
  l.count_off = 0;
  l.start_off = align_up(l.count_off + sizeof(int) * l.slabs);
  l.base_off = align_up(l.start_off + sizeof(int) * (l.slabs + 1));
  l.bins_off = align_up(l.base_off + sizeof(int) * l.slabs * l.grid);
  l.bytes = align_up(l.bins_off + sizeof(uint16_t) * n);
  return l;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename C>
cudaError_t launch(uint8_t* cells, long long m, const C* codes, long long n,
                   char* scratch, const Layout& l, cudaStream_t s) {
  int* count = reinterpret_cast<int*>(scratch + l.count_off);
  int* start = reinterpret_cast<int*>(scratch + l.start_off);
  int* base = reinterpret_cast<int*>(scratch + l.base_off);
  uint16_t* bins = reinterpret_cast<uint16_t*>(scratch + l.bins_off);
  const size_t hist_smem = sizeof(int) * l.slabs;
  cudaError_t err = allow_smem(bin_count<C>, hist_smem);
  if (err == cudaSuccess) err = allow_smem(bin_scatter<C>, hist_smem);
  if (err == cudaSuccess) err = allow_smem(slab_apply, kSlabCells);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(count, 0, sizeof(int) * l.slabs, s);
  if (err != cudaSuccess) return err;
  const unsigned long long mu = static_cast<unsigned long long>(m);
  bin_count<C><<<l.grid, kBinThreads, hist_smem, s>>>(codes, n, l.per, mu,
                                                     l.slabs, count, base);
  scan_counts<<<1, kScanThreads, 0, s>>>(count, l.slabs, start);
  bin_scatter<C><<<l.grid, kBinThreads, hist_smem, s>>>(
      codes, n, l.per, mu, l.slabs, start, base, bins);
  slab_apply<<<l.slabs, kApplyThreads, kSlabCells, s>>>(cells, m, start, bins);
  return cudaGetLastError();
}

}  // namespace

// Bytes of scratch the call below needs for n codes into m cells.
extern "C" long long bits_insert_scratch_bytes(long long n, long long m,
                                               int device) {
  return static_cast<long long>(layout(n, m, device).bytes);
}

// cells: [m] uint8, 16-byte aligned, m < 2^31; codes: [n] int32 or int64
// (code_bytes 4 or 8), n < 2^31; scratch: bits_insert_scratch_bytes(n, m)
// bytes, 16-byte aligned, no initial contents. Returns the CUDA error code
// of the first failing call (0 on success).
extern "C" int bits_insert_u8(void* cells, long long m, const void* codes,
                              long long n, int code_bytes, void* scratch,
                              long long scratch_bytes, int device,
                              void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m <= 0 || n <= 0) return 0;
  if (m > 0x7fffffffLL || n > 0x7fffffffLL ||
      (code_bytes != 4 && code_bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(n, m, device);
  if (scratch_bytes < static_cast<long long>(l.bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* c = static_cast<uint8_t*>(cells);
  char* sc = static_cast<char*>(scratch);
  err = code_bytes == 4
            ? launch(c, m, static_cast<const int32_t*>(codes), n, sc, l, s)
            : launch(c, m, static_cast<const long long*>(codes), n, sc, l, s);
  return static_cast<int>(err);
}
