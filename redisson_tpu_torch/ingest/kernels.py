"""Segmented inserts: the HLL `seg_insert` kernel (`hll_insert_segmented`)
and the Bloom segment-OR (`bits_insert_segmented`).

Counterparts of the same functions in `redisson_tpu.ingest.kernels`. JAX
sorts `bucket << 6 | rank` codes and folds each register tile's span of
them into a fresh output. Here neither insert sorts, and both work in place:

* `hll_insert_segmented`: the (bucket, rank) pairs raise the registers
  with atomics taken only where a register rises, directly for a small
  batch, through block copies of the registers in shared memory for a
  large one, and set PFADD's changed flag (`csrc/seg_insert.cu`);
  `hll_insert_segmented_rows` is its multi-target form, a row per pair
  into a bank, one launch for a run of many sketches;
* `bits_insert_segmented`: the raw cell indexes are binned by 64 KiB slab
  of cells and each bin applied to its slab (`csrc/bits_insert.cu`).

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

#: the largest register count whose int32 copy fits one block's shared
#: memory (128 KiB of the H100's 227 KB): p <= 15
MAX_SHARED_REGISTERS = 1 << 15
#: batches up to this many pairs, and every batch into more registers than
#: MAX_SHARED_REGISTERS, take the direct kernel (PERF.md)
MAX_DIRECT_PAIRS = 1 << 18
#: the shared kernel's pairs per block, its most blocks (more multiply the
#: flush of the block copies), and its largest thread block cluster
PAIRS_PER_BLOCK = 8192
MAX_BLOCKS = 64
MAX_CLUSTER = 8
#: invalid lanes carry code m, compared as a 32-bit cell offset: m must stay
#: below 2^31
MAX_SEGMENT_CELLS = (1 << 31) - 1

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: C entry point -> (source, argtypes, restype)
_SIGNATURES = {
    "seg_insert_direct_i32": ("seg_insert", [_P, _I, _P, _P, _LL, _P, _I, _P], _I),
    "seg_insert_shared_i32": ("seg_insert", [_P, _I, _P, _P, _LL, _I, _I, _P, _I, _P], _I),
    "seg_insert_rows_i32": ("seg_insert", [_P, _I, _I, _P, _P, _P, _LL, _P, _I, _P], _I),
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


def seg_plan(n: int, m: int):
    """How the HLL insert runs n pairs into m registers: (0, 0) for the
    direct kernel (at most MAX_DIRECT_PAIRS pairs, or m past
    MAX_SHARED_REGISTERS), else (blocks, cluster) of the shared kernel:
    about PAIRS_PER_BLOCK pairs a block, at most MAX_BLOCKS blocks, in
    clusters of the largest power of two up to MAX_CLUSTER that the block
    count allows (blocks is a multiple of it)."""
    if n <= MAX_DIRECT_PAIRS or m > MAX_SHARED_REGISTERS or m % 4:
        return 0, 0
    blocks = max(1, min(MAX_BLOCKS, -(-n // PAIRS_PER_BLOCK)))
    cluster = 1
    while cluster * 2 <= min(blocks, MAX_CLUSTER):
        cluster *= 2
    return blocks - blocks % cluster, cluster


def hll_insert_segmented_plain(registers: torch.Tensor, bucket: torch.Tensor,
                               rank: torch.Tensor,
                               changed: torch.Tensor = None) -> torch.Tensor:
    """Sort + run-compress + scatter of the survivors, written back into
    `registers` -> `registers`; `changed` (one bool element), when given,
    is set where a register rose and left as it was otherwise."""
    new = hll.insert_sorted(registers, bucket, rank)
    if changed is not None:
        changed.logical_or_((new != registers).any().reshape(changed.shape))
    return registers.copy_(new)


def hll_insert_segmented(registers: torch.Tensor, bucket: torch.Tensor,
                         rank: torch.Tensor,
                         changed: torch.Tensor = None) -> torch.Tensor:
    """Segment-max fold of a (bucket, rank) batch into [m] int32 registers
    (>= 0), in place, and return `registers`. JAX's function returns a new
    array with the same values. `changed`, when given, is one bool element
    (for example `changed_rows[row:row + 1]` of a bank's zeroed flags) set
    to True where a register rose and left as it was otherwise: PFADD's
    reply. Padding and invalid lanes carry rank 0, which never raises a
    register. On a card this is one kernel launch (`seg_plan` picks it)."""
    if registers.dtype != torch.int32 or registers.dim() != 1:
        raise ValueError("hll_insert_segmented needs [m] int32 registers")
    if not registers.is_cuda:
        if registers.device.type == "cpu":
            return hll_insert_segmented_plain(registers, bucket, rank, changed)
        raise ValueError(f"hll_insert_segmented: unsupported device {registers.device}")
    m = registers.shape[0]
    n = bucket.numel()
    index = registers.get_device()
    pairs = []
    for name, t in (("bucket", bucket), ("rank", rank)):
        if (t.dtype != torch.int32 or not t.is_cuda or t.get_device() != index
                or t.numel() != n):
            raise ValueError(f"hll_insert_segmented: {name} must be [{n}] int32 on "
                             f"{registers.device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            t = t.contiguous() if not t.is_contiguous() else t.clone()
        pairs.append(t)
    flag = None
    if changed is not None:
        if (changed.dtype != torch.bool or changed.numel() != 1 or not changed.is_cuda
                or changed.get_device() != index):
            raise ValueError("hll_insert_segmented: changed must be one bool element "
                             f"on {registers.device}")
        flag = changed.data_ptr()
    if n == 0:
        return registers
    blocks, cluster = seg_plan(n, m)
    # The shared kernel takes 16-byte aligned registers; a view at another
    # offset is merged through an aligned copy and written back.
    target = registers
    if not registers.is_contiguous() or (blocks and registers.data_ptr() % 16):
        target = registers.clone(memory_format=torch.contiguous_format)
    stream = torch._C._cuda_getCurrentRawStream(index)
    if blocks:
        rc = _kernel("seg_insert_shared_i32")(
            target.data_ptr(), m, pairs[0].data_ptr(), pairs[1].data_ptr(), n, blocks,
            cluster, flag, index, stream)
    else:
        rc = _kernel("seg_insert_direct_i32")(
            target.data_ptr(), m, pairs[0].data_ptr(), pairs[1].data_ptr(), n, flag,
            index, stream)
    if rc:
        raise RuntimeError(f"hll_insert_segmented launch failed: CUDA error {rc}")
    launches["seg_insert"] += 1
    if target is not registers:
        registers.copy_(target)
    return registers


def _int32_operand(name: str, t: torch.Tensor, n: int, device) -> torch.Tensor:
    """`t` as a contiguous, 16-byte aligned [n] int32 tensor on `device`
    (a copy where it is not one), or raise."""
    if t.dtype != torch.int32 or t.device != device or t.numel() != n:
        raise ValueError(f"hll_insert_segmented: {name} must be [{n}] int32 on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        t = t.contiguous() if not t.is_contiguous() else t.clone()
    return t


def hll_insert_segmented_rows_plain(bank: torch.Tensor, bucket: torch.Tensor,
                                    rank: torch.Tensor, rows: torch.Tensor,
                                    changed: torch.Tensor = None) -> torch.Tensor:
    """The flat scatter at row * m + bucket (JAX's multi-target insert),
    in place -> `bank`; `changed` ([S] bool), when given, is set at the
    rows where a register rose and left as it was elsewhere. Pairs with
    rank <= 0, or a row or bucket out of range, are dropped."""
    s, m = bank.shape
    rows, bucket = rows.long(), bucket.long()
    keep = (rank > 0) & (rows >= 0) & (rows < s) & (bucket >= 0) & (bucket < m)
    rows, rank = rows[keep], rank[keep]
    idx = rows * m + bucket[keep]
    flat = bank.view(-1)
    if changed is not None:
        changed.index_fill_(0, rows[rank > flat[idx]], True)
    flat.scatter_reduce_(0, idx, rank, reduce="amax")
    return bank


def hll_insert_segmented_rows(bank: torch.Tensor, bucket: torch.Tensor,
                              rank: torch.Tensor, rows: torch.Tensor,
                              changed: torch.Tensor = None) -> torch.Tensor:
    """Multi-target segment-max fold, in place: pair i raises register
    bucket[i] of row rows[i] of an [S, m] int32 bank (>= 0) -> `bank`.
    `changed` ([S] bool), when given, is set to True at each row where a
    register rose and left as it was elsewhere: PFADD's replies for a run
    of many sketches. Padding lanes carry rank 0. On a card this is one
    kernel launch whatever the number of rows."""
    if bank.dtype != torch.int32 or bank.dim() != 2:
        raise ValueError("hll_insert_segmented_rows needs an [S, m] int32 bank")
    if not bank.is_cuda:
        if bank.device.type == "cpu":
            return hll_insert_segmented_rows_plain(bank, bucket, rank, rows, changed)
        raise ValueError(f"hll_insert_segmented_rows: unsupported device {bank.device}")
    if not bank.is_contiguous():
        raise ValueError("hll_insert_segmented_rows: the bank must be contiguous")
    s, m = bank.shape
    n = bucket.numel()
    ops = [_int32_operand(name, t, n, bank.device)
           for name, t in (("bucket", bucket), ("rank", rank), ("rows", rows))]
    flag = None
    if changed is not None:
        if (changed.dtype != torch.bool or changed.shape != (s,)
                or changed.device != bank.device or not changed.is_contiguous()):
            raise ValueError(f"hll_insert_segmented_rows: changed must be [{s}] bool on "
                             f"{bank.device}")
        flag = changed.data_ptr()
    if n == 0:
        return bank
    index = bank.get_device()
    rc = _kernel("seg_insert_rows_i32")(
        bank.data_ptr(), s, m, ops[0].data_ptr(), ops[1].data_ptr(), ops[2].data_ptr(), n,
        flag, index, torch._C._cuda_getCurrentRawStream(index))
    if rc:
        raise RuntimeError(f"hll_insert_segmented_rows launch failed: CUDA error {rc}")
    launches["seg_insert"] += 1
    return bank


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
    dev = cells.get_device()
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
