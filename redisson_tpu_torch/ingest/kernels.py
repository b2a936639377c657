"""Segmented inserts: the HLL `seg_insert` kernel (`hll_insert_segmented`)
and the Bloom segment-OR (`bits_insert_segmented`).

Counterparts of the same functions in `redisson_tpu.ingest.kernels`. The
HLL insert turns the random scatter of a key batch into a streaming pass:

  1. encode each update as `code = bucket << 6 | rank` and sort ascending
     (`torch.sort`, outside the kernel, as JAX left it to XLA);
  2. find, per register tile, the span of sorted codes that land in it
     (`torch.searchsorted` on the tile boundaries);
  3. one thread block per tile folds its span into the registers
     (`csrc/seg_insert.cu`; the kernel reads exactly its span, so the
     sentinel padding the TPU's fixed-size chunk loads needed is gone).

The segment-OR sorts nothing: `csrc/bits_insert.cu` bins the raw cell
indexes by 64 KiB slab of cells and applies each bin to its slab in place
(see that file's note).

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version (`*_plain`), which is also what the kernel
is held against on the card.
"""

from __future__ import annotations

import ctypes

import torch

from redisson_tpu_torch.ops import _build, hll
from redisson_tpu_torch.ops.kernels import _stream

#: kernel launches since the last `reset_launches()`
launches = {"seg_insert": 0, "bits_insert_segmented": 0}

#: registers per thread block: m = 16384 gives 128 blocks, one wave on 132 SMs
TILE = 128
HLL_SHIFT = 6
#: invalid lanes carry code m, compared as a 32-bit cell offset: m must stay
#: below 2^31
MAX_SEGMENT_CELLS = (1 << 31) - 1

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: C entry point -> (source, argtypes, restype)
_SIGNATURES = {
    "seg_insert_i32": ("seg_insert", [_P, _I, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "bits_insert_scratch_bytes": ("bits_insert", [_LL, _LL, _I], _LL),
    "bits_insert_u8": ("bits_insert", [_P, _LL, _P, _LL, _I, _P, _LL, _I, _P], _I),
}
_fns = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        source, argtypes, restype = _SIGNATURES[name]
        fn = getattr(_build.load(source), name)
        fn.argtypes = argtypes
        fn.restype = restype
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
                      tile: int = TILE) -> torch.Tensor:
    """Launch the kernel on pre-sorted codes and their tile spans; returns a
    fresh [m] int32 tensor `max(cells, segment_max(codes))`."""
    m = cells.shape[0]
    g = -(-m // tile)
    for name, t, dt in (("cells", cells, cells.dtype), ("codes", codes, torch.int32),
                        ("starts", starts, torch.int32)):
        if t.device != cells.device or t.dtype != dt or not t.is_contiguous() \
                or t.dim() != 1:
            raise ValueError(
                f"seg_insert: {name} must be a contiguous 1-D {dt} tensor on "
                f"{cells.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if cells.dtype != torch.int32:
        raise ValueError(f"seg_insert: unsupported cell type {cells.dtype}")
    if starts.shape[0] != g + 1:
        raise ValueError(f"seg_insert: starts must hold {g + 1} offsets")
    if cells.device.type != "cuda":
        raise ValueError(f"seg_insert: needs a CUDA tensor, got {cells.device}")
    out = torch.empty_like(cells)
    stream = torch.cuda.current_stream(cells.device).cuda_stream
    rc = _kernel("seg_insert_i32")(codes.data_ptr(), codes.shape[0], starts.data_ptr(),
                                   cells.data_ptr(), out.data_ptr(), m, tile, shift,
                                   cells.device.index, stream)
    if rc:
        raise RuntimeError(f"seg_insert launch failed: CUDA error {rc}")
    launches["seg_insert"] += 1
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
    """`cells[idx] = 1` in place over [m] uint8 cells -> `cells`; indexes
    outside [0, m), such as the sentinel m, are dropped, as JAX's
    `bits_insert_segmented_lax` drops them (`mode="drop"`)."""
    m = cells.shape[0]
    s = idx.reshape(-1).to(torch.int64)
    cells[s[(s >= 0) & (s < m)]] = 1
    return cells


def bits_insert_segmented(cells: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Segment-OR: set `cells[idx] = 1` in place over [m] 0/1 uint8 cells
    and return `cells`. JAX's function returns a new array with the same
    values. Indexes outside [0, m) are dropped, so invalid lanes carry
    index m (one past the end), never 0, which would set cell 0."""
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
    codes = idx.reshape(-1)
    if codes.device != cells.device:
        raise ValueError(f"bits_insert_segmented: idx on {codes.device}, cells on "
                         f"{cells.device}")
    n = codes.shape[0]
    if n > MAX_SEGMENT_CELLS:
        raise ValueError(f"bits_insert_segmented: {n} codes in one call (< 2^31)")
    if n == 0 or m == 0:
        return cells
    if codes.dtype not in (torch.int32, torch.int64):
        codes = codes.to(torch.int64)
    codes = codes.contiguous()
    # The kernel takes 16-byte aligned cells; a view at another offset is
    # merged through an aligned copy and written back.
    target = cells if cells.is_contiguous() and cells.data_ptr() % 16 == 0 \
        else cells.clone(memory_format=torch.contiguous_format)
    dev = cells.device.index
    size = _kernel("bits_insert_scratch_bytes")(n, m, dev)
    scratch = torch.empty((size,), dtype=torch.uint8, device=cells.device)
    rc = _kernel("bits_insert_u8")(target.data_ptr(), m, codes.data_ptr(), n,
                                   codes.element_size(), scratch.data_ptr(), size,
                                   dev, _stream(cells))
    if rc:
        raise RuntimeError(f"bits_insert_segmented launch failed: CUDA error {rc}")
    launches["bits_insert_segmented"] += 1
    if target is not cells:
        cells.copy_(target)
    return cells


def segmented_bits_set(cells: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The engine's Bloom insert under `ingest="segment"` (in place)."""
    return bits_insert_segmented(cells, idx)
