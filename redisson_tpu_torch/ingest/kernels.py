"""Segmented insert: the `seg_insert` kernel wrappers, for HLL registers
(`hll_insert_segmented`) and for bit cells (`bits_insert_segmented`).

Counterparts of the same functions in `redisson_tpu.ingest.kernels`. The
random scatter of a key batch becomes a streaming pass:

  1. encode each update as `code = bucket << 6 | rank` and sort ascending
     (`torch.sort`, outside the kernel, as JAX left it to XLA);
  2. find, per register tile, the span of sorted codes that land in it
     (`torch.searchsorted` on the tile boundaries);
  3. one thread block per tile folds its span into the registers
     (`csrc/seg_insert.cu`; the kernel reads exactly its span, so the
     sentinel padding the TPU's fixed-size chunk loads needed is gone).

On a CUDA tensor the wrapper launches that kernel or raises; on a CPU
tensor it runs the plain version, `hll_insert_segmented_plain` (the same
sort-compress as `ops.hll.insert_sorted`), which is also what the kernel is
held against on the card. The kernel body takes the shift and the cell type
as parameters: the Bloom filter's segment-OR (`bits_insert_segmented`) is
the same body with shift 0 and uint8 cells, its codes the raw cell indexes
and its plain version the sorted-dedup set of the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from redisson_tpu_torch.ops import _build, hll

#: kernel launches since the last `reset_launches()`
launches = {"seg_insert": 0, "bits_insert_segmented": 0}

#: registers per thread block: m = 16384 gives 128 blocks, one wave on 132 SMs
TILE = 128
HLL_SHIFT = 6
#: cells per thread block of the segment-OR, the JAX kernel's tile
BITS_TILE = 1024
#: codes are int32, and invalid lanes carry code m: m must stay below 2^31
MAX_SEGMENT_CELLS = (1 << 31) - 1

_fns = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _kernel(dtype: torch.dtype):
    name = {torch.int32: "seg_insert_i32", torch.uint8: "seg_insert_u8"}[dtype]
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("seg_insert"), name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def sort_codes(codes: torch.Tensor, m: int, shift: int = HLL_SHIFT,
               tile: int = TILE):
    """Sort int32 codes and compute the g+1 tile span offsets (int32)."""
    codes = torch.sort(codes).values
    g = -(-m // tile)
    # Formed in int64 and clamped: (g * tile) << shift may pass 2^31 - 1 for
    # large cell arrays, and no int32 code lies beyond the clamp anyway.
    bounds = (torch.arange(g + 1, dtype=torch.int64, device=codes.device)
              * tile) << shift
    bounds = bounds.clamp_(max=(1 << 31) - 1).to(torch.int32)
    return codes, torch.searchsorted(codes, bounds, out_int32=True)


def seg_insert_launch(cells: torch.Tensor, codes: torch.Tensor,
                      starts: torch.Tensor, shift: int = HLL_SHIFT,
                      tile: int = TILE,
                      counter: str = "seg_insert") -> torch.Tensor:
    """Launch the kernel on pre-sorted codes and their tile spans; returns a
    fresh [m] tensor `max(cells, segment_max(codes))`."""
    m = cells.shape[0]
    g = -(-m // tile)
    for name, t, dt in (("cells", cells, cells.dtype), ("codes", codes, torch.int32),
                        ("starts", starts, torch.int32)):
        if t.device != cells.device or t.dtype != dt or not t.is_contiguous() \
                or t.dim() != 1:
            raise ValueError(
                f"seg_insert: {name} must be a contiguous 1-D {dt} tensor on "
                f"{cells.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if cells.dtype not in (torch.int32, torch.uint8):
        raise ValueError(f"seg_insert: unsupported cell type {cells.dtype}")
    if starts.shape[0] != g + 1:
        raise ValueError(f"seg_insert: starts must hold {g + 1} offsets")
    if cells.device.type != "cuda":
        raise ValueError(f"seg_insert: needs a CUDA tensor, got {cells.device}")
    out = torch.empty_like(cells)
    stream = torch.cuda.current_stream(cells.device).cuda_stream
    rc = _kernel(cells.dtype)(codes.data_ptr(), codes.shape[0], starts.data_ptr(),
                              cells.data_ptr(), out.data_ptr(), m, tile, shift,
                              cells.device.index, stream)
    if rc:
        raise RuntimeError(f"seg_insert launch failed: CUDA error {rc}")
    launches[counter] += 1
    return out


def hll_insert_segmented_plain(registers: torch.Tensor, bucket: torch.Tensor,
                               rank: torch.Tensor) -> torch.Tensor:
    """Sort + run-compress + scatter of the survivors (fresh tensor)."""
    return hll.insert_sorted(registers, bucket, rank)


def hll_insert_segmented(registers: torch.Tensor, bucket: torch.Tensor,
                         rank: torch.Tensor) -> torch.Tensor:
    """Segment-max fold of a (bucket, rank) batch into [m] int32 registers;
    returns a fresh tensor. Padding and invalid lanes carry code 0
    (bucket 0, rank 0), which never raises a register."""
    if registers.dtype != torch.int32 or registers.dim() != 1:
        raise ValueError("hll_insert_segmented needs [m] int32 registers")
    if registers.device.type == "cpu":
        return hll_insert_segmented_plain(registers, bucket, rank)
    if registers.device.type != "cuda":
        raise ValueError(f"hll_insert_segmented: unsupported device {registers.device}")
    if bucket.numel() == 0:
        return registers.clone()
    codes = bucket.to(torch.int32) * 64 + rank.to(torch.int32)
    codes, starts = sort_codes(codes, registers.shape[0])
    return seg_insert_launch(registers.contiguous(), codes, starts)


def segmented_hll_add(registers: torch.Tensor, bucket: torch.Tensor,
                      rank: torch.Tensor) -> torch.Tensor:
    """The engine's `ingest="segment"` insert."""
    return hll_insert_segmented(registers, bucket, rank)


def bits_insert_segmented_plain(cells: torch.Tensor,
                                idx: torch.Tensor) -> torch.Tensor:
    """Sorted-dedup set `cells[idx] = 1` (fresh tensor); indexes outside
    [0, m), such as the sentinel m, are dropped, as JAX's
    `bits_insert_segmented_lax` drops them (`mode="drop"`)."""
    m = cells.shape[0]
    s = torch.sort(idx.to(torch.int64)).values
    s = s[(s >= 0) & (s < m)]
    out = cells.clone()
    out[s] = 1
    return out


def bits_insert_segmented(cells: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Segment-OR: set `cells[idx] = 1` over [m] uint8 cells -> a fresh
    tensor. Invalid lanes must carry index m (one past the end), never 0:
    the kernel drops m, while 0 would set cell 0."""
    if cells.dtype != torch.uint8 or cells.dim() != 1:
        raise ValueError("bits_insert_segmented needs [m] uint8 cells")
    m = cells.shape[0]
    if m > MAX_SEGMENT_CELLS:
        raise ValueError(
            f"bits_insert_segmented: m = {m} cells do not fit int32 codes "
            "with the one-past-the-end sentinel (m must be < 2^31)")
    if cells.device.type == "cpu":
        return bits_insert_segmented_plain(cells, idx)
    if cells.device.type != "cuda":
        raise ValueError(f"bits_insert_segmented: unsupported device {cells.device}")
    if idx.numel() == 0:
        return cells.clone()
    codes, starts = sort_codes(idx.to(torch.int32), m, 0, BITS_TILE)
    return seg_insert_launch(cells.contiguous(), codes, starts, 0, BITS_TILE,
                             counter="bits_insert_segmented")


def segmented_bits_set(cells: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The engine's Bloom insert under `ingest="segment"`."""
    return bits_insert_segmented(cells, idx)
