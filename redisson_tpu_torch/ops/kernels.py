"""The ops-level kernel wrappers: PFMERGE's `merge_stack`, BITCOUNT's
`popcount_partials`, BITOP's `bitop_cells` and the delta ingest's
`delta_merge`.

Counterparts of the same functions in `redisson_tpu.ops.pallas_kernels`.
On a CUDA tensor each wrapper launches its hand-written kernel
(`csrc/merge_stack.cu`, `csrc/popcount.cu`, `csrc/bitop.cu`,
`csrc/delta_merge.cu`) or raises; on a CPU tensor it runs its plain
PyTorch version (`*_plain`), which is also what the kernel is held against
on the card.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from redisson_tpu_torch.ops import _build

#: kernel launches since the last `reset_launches()`
launches = {"merge_stack": 0, "popcount_partials": 0, "bitop_cells": 0,
            "delta_merge": 0}

_fns = {}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: C entry point -> (source, argtypes)
_SIGNATURES = {
    "merge_stack_i32": ("merge_stack", [_P, _P, _P] + [_I] * 8 + [_P]),
    "merge_stack_noop": ("merge_stack", [_P, _P, _P] + [_I] * 8 + [_P]),
    "popcount_partials_u8": ("popcount", [_P, _LL, _I, _P, _I, _P]),
    "bitop_u8": ("bitop", [_P, _P, _I, _LL, _I, _I, _I, _P]),
    "delta_merge_u8": ("delta_merge", [_P, _P, _P, _LL, _LL, _I, _P]),
    "window_merge_u8": ("window_merge", [_P, _P, _P, _P, _LL, _LL, _LL, _I, _I,
                                         _P]),
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        source, argtypes = _SIGNATURES[name]
        fn = getattr(_build.load(source), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _on_cpu(name: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version), False for a CUDA one (the
    kernel); raises for any other device. `is_cuda` first: it builds no
    device object (host time on the small-call path)."""
    if t.is_cuda:
        return False
    if t.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def _stream(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream on `t`'s card: the
    `cuda_stream` of `torch.cuda.current_stream(t.device)`, read without
    building a Stream or a device object (host time on the small-call
    path)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def merge_stack_plain(stack: torch.Tensor, rows: torch.Tensor = None) -> torch.Tensor:
    """Elementwise max over the leading axis of an [S, m] int32 stack, or
    over the rows `rows` lists (gathered first)."""
    if rows is not None:
        stack = stack[rows.long()]
    s, m = stack.shape
    if s == 0:
        return torch.zeros((m,), dtype=stack.dtype, device=stack.device)
    return stack.amax(dim=0)


#: int4 columns (threads) of one merge_stack strip and row splits per
#: cluster (chip_smoke.py's grid probe on the H100 set both: PERF.md)
MERGE_THREADS = 128
MERGE_CLUSTER = 8
#: capacities of a row list passed by value, smallest first: a longer host
#: list goes to the card as a device tensor
ROW_CAPACITIES = (64, 1024, 8000)


@functools.lru_cache(maxsize=4096)
def merge_plan(s: int, m: int, threads: int = MERGE_THREADS,
               cluster: int = MERGE_CLUSTER):
    """merge_stack's grid for s rows (or list entries) of m int32 columns
    -> (strip_cols, cluster, rows_per_block): strips of strip_cols columns,
    each folded by one thread block cluster of `cluster` blocks that take
    rows_per_block consecutive entries each (the last may take fewer; none
    takes none)."""
    if s < 1 or m < 4 or m % 4:
        raise ValueError(f"merge_plan: needs s >= 1 and m % 4 == 0, got {s}, {m}")
    threads = min(threads, 32 * -(-(m // 4) // 32))
    per = -(-s // min(cluster, s))
    return 4 * threads, -(-s // per), per


def rows_capacity(r: int) -> int:
    """The by-value capacity a host row list of r entries takes, or 0 above
    the largest: then it reaches the kernel as a device tensor."""
    for cap in ROW_CAPACITIES:
        if r <= cap:
            return cap
    return 0


def _merge_args(stack: torch.Tensor, rows):
    """Everything the card path checks and works out before its foreign
    call -> (stack pointer, rows kept alive for the launch, the row list's
    argument, entries, height, m, by-value capacity or 0 for a device
    pointer). A numpy list is passed as its bytes (ctypes hands the C entry
    their address): cheaper on the host than `ndarray.ctypes`."""
    height, m = stack.shape
    ptr = stack.data_ptr()
    if m % 4 or ptr % 16 or not stack.is_contiguous():
        raise ValueError("merge_stack: needs a contiguous stack, m % 4 == 0 and "
                         "16-byte alignment")
    if rows is None:
        return ptr, None, None, height, height, m, 0
    if isinstance(rows, np.ndarray):
        if rows.dtype != np.int32 or rows.ndim != 1:
            raise ValueError(f"merge_stack: host rows must be an [R] int32 vector, got "
                             f"{rows.dtype} {rows.shape}")
        r = rows.shape[0]
        cap = rows_capacity(r)
        if cap:
            return ptr, rows, rows.tobytes(), r, height, m, cap
        rows = torch.from_numpy(np.ascontiguousarray(rows))
    if rows.dtype != torch.int32 or rows.dim() != 1 or not rows.is_contiguous():
        raise ValueError(f"merge_stack: rows must be a contiguous [R] int32 vector, got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    r = rows.shape[0]
    if rows.is_cuda:
        if rows.get_device() != stack.get_device():
            raise ValueError(f"merge_stack: rows on {rows.device}, stack on {stack.device}")
        return ptr, rows, rows.data_ptr(), r, height, m, 0
    if rows.device.type != "cpu":
        raise ValueError(f"merge_stack: unsupported rows device {rows.device}")
    cap = rows_capacity(r)
    if cap:
        return ptr, rows, rows.data_ptr(), r, height, m, cap
    rows = rows.to(stack.device)  # longer than the largest by-value list
    return ptr, rows, rows.data_ptr(), r, height, m, 0


def merge_stack(stack: torch.Tensor, rows=None) -> torch.Tensor:
    """PFMERGE over an [S, m] int32 stack -> [m] (a fresh tensor; the stack
    is not modified). `rows` lists the rows to merge (they may repeat; on a
    card one outside [0, S) is skipped): the client's PFMERGE over bank
    rows, read in place with no gathered copy. It is an [R] int32 vector on
    the stack's card, or on the host (a CPU tensor or a numpy array), whose
    entries a list of up to max(ROW_CAPACITIES) reach the kernel in its
    launch parameters. None merges all S rows. On a card one foreign call
    and one launch (none for R = 0)."""
    if stack.dim() != 2 or stack.dtype != torch.int32:
        raise ValueError(
            f"merge_stack needs an [S, m] int32 tensor, got "
            f"{tuple(stack.shape)} {stack.dtype}")
    if _on_cpu("merge_stack", stack):
        if isinstance(rows, np.ndarray):
            rows = torch.from_numpy(rows)
        return merge_stack_plain(stack, rows)
    # `keep` holds a device row list alive until its launch is enqueued.
    ptr, keep, rows_arg, s, height, m, cap = _merge_args(stack, rows)
    if s == 0:
        return stack.new_zeros((m,))
    strip, cluster, per = merge_plan(s, m)
    index = stack.get_device()
    out = stack.new_empty((m,))
    rc = _kernel("merge_stack_i32")(ptr, rows_arg, out.data_ptr(), s, height, m, strip,
                                    cluster, per, cap, index,
                                    torch._C._cuda_getCurrentRawStream(index))
    if rc:
        raise RuntimeError(f"merge_stack launch failed: CUDA error {rc}")
    launches["merge_stack"] += 1
    return out


# ---------------------------------------------------------------------------
# popcount_partials: BITCOUNT per-block int32 partials over uint8 cells
# ---------------------------------------------------------------------------

#: cells per partial, as in the JAX kernel (partials compare one to one)
POPCOUNT_BLOCK = 1 << 18


def popcount_partials_plain(cells: torch.Tensor,
                            block: int = POPCOUNT_BLOCK) -> torch.Tensor:
    """[n] uint8 -> [G, 1] int32 per-block sums; the ragged tail counts as
    zeros and n = 0 gives one zero partial (JAX's shapes)."""
    n = cells.shape[0]
    if n == 0:
        return torch.zeros((1, 1), dtype=torch.int32, device=cells.device)
    pad = (-n) % block
    if pad:
        cells = torch.cat([cells, cells.new_zeros((pad,))])
    return cells.reshape(-1, block).sum(dim=1, dtype=torch.int32)[:, None]


def popcount_partials(cells: torch.Tensor,
                      block: int = POPCOUNT_BLOCK) -> torch.Tensor:
    """BITCOUNT partials of [n] uint8 cells -> [G, 1] int32, G = ceil(n /
    block); the exact total is `ops.bitset.combine_partials` on the host."""
    if cells.dim() != 1 or cells.dtype != torch.uint8:
        raise ValueError(
            f"popcount_partials needs [n] uint8 cells, got "
            f"{tuple(cells.shape)} {cells.dtype}")
    if block <= 0 or block % 16 or block * 255 >= 1 << 31:
        raise ValueError(f"popcount_partials: bad block {block}")
    if _on_cpu("popcount_partials", cells):
        return popcount_partials_plain(cells, block)
    n = cells.shape[0]
    if n == 0:
        return torch.zeros((1, 1), dtype=torch.int32, device=cells.device)
    if not cells.is_contiguous() or cells.data_ptr() % 16:
        cells = cells.clone()  # a fresh allocation is contiguous and aligned
    out = torch.empty((-(-n // block), 1), dtype=torch.int32, device=cells.device)
    rc = _kernel("popcount_partials_u8")(cells.data_ptr(), n, block,
                                         out.data_ptr(), cells.get_device(),
                                         _stream(cells))
    if rc:
        raise RuntimeError(f"popcount_partials launch failed: CUDA error {rc}")
    launches["popcount_partials"] += 1
    return out


def popcount_cells(cells: torch.Tensor, block: int = POPCOUNT_BLOCK) -> torch.Tensor:
    """BITCOUNT as one int64 device scalar."""
    return popcount_partials(cells, block).sum(dtype=torch.int64)


# ---------------------------------------------------------------------------
# bitop_cells: BITOP AND | OR | XOR over a [K, n] uint8 stack -> [n]
# ---------------------------------------------------------------------------

BITOPS = {"and": 0, "or": 1, "xor": 2}
_TORCH_BITOPS = {"and": torch.bitwise_and, "or": torch.bitwise_or,
                 "xor": torch.bitwise_xor}


def bitop_cells_plain(stack: torch.Tensor, op: str) -> torch.Tensor:
    """Fold the K rows with `op`; K = 0 gives zeros."""
    fn = _TORCH_BITOPS[op]
    k, n = stack.shape
    if k == 0:
        return torch.zeros((n,), dtype=stack.dtype, device=stack.device)
    acc = stack[0].clone()
    for r in range(1, k):
        acc = fn(acc, stack[r])
    return acc


def bitop_cells(stack: torch.Tensor, op: str) -> torch.Tensor:
    """BITOP `op` ('and' | 'or' | 'xor') over K operands stacked as [K, n]
    uint8 -> a fresh [n] tensor."""
    if op not in BITOPS:
        raise ValueError(f"unknown bitop {op!r}")
    if stack.dim() != 2 or stack.dtype != torch.uint8:
        raise ValueError(
            f"bitop_cells needs a [K, n] uint8 stack, got "
            f"{tuple(stack.shape)} {stack.dtype}")
    if _on_cpu("bitop_cells", stack):
        return bitop_cells_plain(stack, op)
    k, n = stack.shape
    out = torch.zeros((n,), dtype=torch.uint8, device=stack.device)
    if k == 0 or n == 0:
        return out
    stack = stack.contiguous()
    vec = n % 16 == 0 and stack.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    rc = _kernel("bitop_u8")(stack.data_ptr(), out.data_ptr(), k, n, BITOPS[op],
                             int(vec), stack.get_device(), _stream(stack))
    if rc:
        raise RuntimeError(f"bitop_cells launch failed: CUDA error {rc}")
    launches["bitop_cells"] += 1
    return out


# ---------------------------------------------------------------------------
# delta_merge: in-place max of two [T, L] uint8 stacks + per-row changed
# ---------------------------------------------------------------------------


def delta_merge_plain(old: torch.Tensor, delta: torch.Tensor):
    """`old = max(old, delta)` in place -> (old, changed [T] bool), changed
    where any cell of the row rose."""
    merged = torch.maximum(old, delta)
    changed = (merged != old).any(dim=1)
    old.copy_(merged)
    return old, changed


def delta_merge(old: torch.Tensor, delta: torch.Tensor):
    """The delta ingest's retire: merge the [T, L] uint8 `delta` stack into
    `old` in place (one row per target) -> (old, changed [T] bool). On a card
    this is one foreign call; `changed` is the bool tensor allocated here,
    and the kernel writes every flag."""
    if (old.dtype != torch.uint8 or delta.dtype != torch.uint8 or old.dim() != 2
            or delta.shape != old.shape):
        raise ValueError(
            f"delta_merge needs two [T, L] uint8 stacks, got "
            f"{tuple(old.shape)} {old.dtype} and {tuple(delta.shape)} "
            f"{delta.dtype}")
    # The small-merge path is host-bound: each tensor attribute read below
    # costs host time, so each is read once.
    if not old.is_cuda:
        if old.device.type == "cpu":
            return delta_merge_plain(old, delta)
        raise ValueError(f"delta_merge: unsupported device {old.device}")
    t, l = old.shape
    old_ptr, delta_ptr = old.data_ptr(), delta.data_ptr()
    if l % 16 or old_ptr % 16 or not old.is_contiguous():
        raise ValueError("delta_merge: old must be contiguous and 16-byte "
                         "aligned with L % 16 == 0")
    if delta_ptr % 16 or not delta.is_contiguous():
        delta = delta.clone(memory_format=torch.contiguous_format)
        delta_ptr = delta.data_ptr()
    index = old.get_device()
    changed = torch.empty(t, dtype=torch.bool, device=index)
    if t == 0:
        return old, changed
    rc = _kernel("delta_merge_u8")(old_ptr, delta_ptr, changed.data_ptr(), t, l,
                                   index, torch._C._cuda_getCurrentRawStream(index))
    if rc:
        raise RuntimeError(f"delta_merge launch failed: CUDA error {rc}")
    launches["delta_merge"] += 1
    return old, changed
