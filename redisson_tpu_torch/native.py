"""ctypes binding of the host fold library (`csrc/host_fold.cpp`).

The host half of the delta / tape ingest and of the Bloom host mirror:
murmur3 folds of u64 keys or byte rows into HLL registers or a packed
big-endian Bloom bitmap, Bloom probes against such a bitmap, and a
population count. The port's counterpart of the fold functions of
`redisson_tpu.native`, with its own copy of the C++ source.

The library is compiled with `g++` at first use into the package's
git-ignored `build/` directory, named by a digest of the source (like the
CUDA libraries, `ops/_build.py`). There is no Python fallback: `available()`
says whether the library built and loaded, and every fold raises when it
did not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from redisson_tpu_torch.ops import _build

SOURCE = _build.CSRC / "host_fold.cpp"
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-fvisibility=hidden")
HLL_M = 16384

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
#: compiler output of the last build (empty when the library was cached)
BUILD_LOG = ""

_U8 = ctypes.POINTER(ctypes.c_uint8)
_I32 = ctypes.POINTER(ctypes.c_int32)
_U64 = ctypes.POINTER(ctypes.c_uint64)
_I64, _SEED, _K, _NT = ctypes.c_int64, ctypes.c_uint64, ctypes.c_int32, ctypes.c_int32
_SIGNATURES = {
    "hf_hll_fold_u64": [_U64, _I64, _SEED, _U8, _NT],
    "hf_hll_fold_rows": [_U8, _I64, _I32, _I64, _SEED, _U8],
    "hf_bloom_fold_u64": [_U64, _I64, _SEED, _K, ctypes.c_uint64, _U8, _U8, _NT],
    "hf_bloom_contains_u64": [_U64, _I64, _SEED, _K, ctypes.c_uint64, _U8, _U8,
                              _NT],
    "hf_bloom_fold_rows": [_U8, _I64, _I32, _I64, _SEED, _K, ctypes.c_uint64,
                           _U8, _U8],
    "hf_bloom_contains_rows": [_U8, _I64, _I32, _I64, _SEED, _K,
                               ctypes.c_uint64, _U8, _U8],
    "hf_popcount": [_U8, _I64],
}


def target() -> "os.PathLike":
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return _build.BUILD_DIR / f"libhost_fold-{digest}.so"


def build() -> None:
    """Compile the library unless a build of this source exists; raises on
    a failed compile."""
    global BUILD_LOG
    so = target()
    if so.exists():
        return
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    out = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE),
                          "-lpthread"],
                         capture_output=True, text=True, timeout=300)
    BUILD_LOG = out.stdout + out.stderr
    if out.returncode != 0:
        raise RuntimeError(f"host fold library build failed:\n{BUILD_LOG}")
    os.replace(tmp, so)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            try:
                build()
                lib = ctypes.CDLL(str(target()))
            except (OSError, RuntimeError, subprocess.SubprocessError):
                return None
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = None
            lib.hf_popcount.restype = ctypes.c_uint64
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the library built and loaded (it is built on first call)."""
    return _load() is not None


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("host fold library unavailable (g++ build or load "
                           "failed)")
    return lib


def _p(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _threads(nthreads: int) -> int:
    return nthreads if nthreads > 0 else (os.cpu_count() or 1)


def _u64_keys(keys: np.ndarray, who: str) -> np.ndarray:
    """uint64 [n] or the packed uint32 [n, 2] layout -> contiguous uint64
    [n]. Anything else would pair values into wrong keys: refused."""
    if keys.dtype == np.uint64:
        return np.ascontiguousarray(keys).reshape(-1)
    if keys.dtype == np.uint32 and keys.ndim == 2 and keys.shape[1] == 2:
        return np.ascontiguousarray(keys).view(np.uint64).reshape(-1)
    raise TypeError(f"{who} wants uint64 [n] or packed uint32 [n, 2] keys, "
                    f"got {keys.dtype} {keys.shape}")


def _check_regs(regs: np.ndarray) -> None:
    if regs.dtype != np.uint8 or regs.shape != (HLL_M,) or not regs.flags.c_contiguous:
        raise ValueError("regs must be a contiguous uint8 [16384] array")


def _check_bits(bits: np.ndarray, m: int) -> None:
    if (bits.dtype != np.uint8 or bits.shape != ((m + 7) // 8,)
            or not bits.flags.c_contiguous):
        raise ValueError(f"bits must be a contiguous uint8 [{(m + 7) // 8}] array")


def _rows(data: np.ndarray, lengths: np.ndarray):
    data = np.ascontiguousarray(data, np.uint8)
    lengths = np.ascontiguousarray(lengths, np.int32)
    if data.ndim != 2 or lengths.shape != (data.shape[0],):
        raise ValueError("byte rows must be [n, w] uint8 with [n] lengths")
    return data, lengths


def hll_fold_u64(keys: np.ndarray, regs: np.ndarray, seed: int = 0,
                 nthreads: int = 0) -> np.ndarray:
    """Fold u64 keys (hashed as 8-byte LE murmur3 x64 128) into 16384 uint8
    registers, in place; returns `regs`. nthreads 0 = os.cpu_count()."""
    _check_regs(regs)
    keys = _u64_keys(keys, "hll_fold_u64")
    _lib_or_raise().hf_hll_fold_u64(_p(keys, ctypes.c_uint64), keys.shape[0],
                                    seed, _p(regs, ctypes.c_uint8),
                                    _threads(nthreads))
    return regs


def hll_fold_rows(data: np.ndarray, lengths: np.ndarray, regs: np.ndarray,
                  seed: int = 0) -> np.ndarray:
    """Fold padded byte-key rows ([n, w] uint8 + [n] lengths) into the
    registers, in place; returns `regs`."""
    _check_regs(regs)
    data, lengths = _rows(data, lengths)
    _lib_or_raise().hf_hll_fold_rows(
        _p(data, ctypes.c_uint8), data.shape[1], _p(lengths, ctypes.c_int32),
        data.shape[0], seed, _p(regs, ctypes.c_uint8))
    return regs


def bloom_fold_u64(keys: np.ndarray, bits: np.ndarray, k: int, m: int,
                   seed: int = 0, want_newly: bool = True,
                   nthreads: int = 0) -> Optional[np.ndarray]:
    """Fold u64 keys into a packed Bloom bitmap, in place. Returns the
    per-key newly-set mask (uint8 [n]) when `want_newly`, else None."""
    _check_bits(bits, m)
    keys = _u64_keys(keys, "bloom_fold_u64")
    newly = np.empty(keys.shape[0], np.uint8) if want_newly else None
    _lib_or_raise().hf_bloom_fold_u64(
        _p(keys, ctypes.c_uint64), keys.shape[0], seed, k, m,
        _p(bits, ctypes.c_uint8),
        _p(newly, ctypes.c_uint8) if newly is not None else None,
        _threads(nthreads))
    return newly


def bloom_contains_u64(keys: np.ndarray, bits: np.ndarray, k: int, m: int,
                       seed: int = 0, nthreads: int = 0) -> np.ndarray:
    """Membership of u64 keys in a packed bitmap -> uint8 [n]."""
    _check_bits(bits, m)
    keys = _u64_keys(keys, "bloom_contains_u64")
    out = np.empty(keys.shape[0], np.uint8)
    _lib_or_raise().hf_bloom_contains_u64(
        _p(keys, ctypes.c_uint64), keys.shape[0], seed, k, m,
        _p(bits, ctypes.c_uint8), _p(out, ctypes.c_uint8), _threads(nthreads))
    return out


def bloom_fold_rows(data: np.ndarray, lengths: np.ndarray, bits: np.ndarray,
                    k: int, m: int, seed: int = 0,
                    want_newly: bool = True) -> Optional[np.ndarray]:
    """Byte-key ([n, w] + lengths) Bloom fold into a packed bitmap."""
    _check_bits(bits, m)
    data, lengths = _rows(data, lengths)
    newly = np.empty(data.shape[0], np.uint8) if want_newly else None
    _lib_or_raise().hf_bloom_fold_rows(
        _p(data, ctypes.c_uint8), data.shape[1], _p(lengths, ctypes.c_int32),
        data.shape[0], seed, k, m, _p(bits, ctypes.c_uint8),
        _p(newly, ctypes.c_uint8) if newly is not None else None)
    return newly


def bloom_contains_rows(data: np.ndarray, lengths: np.ndarray,
                        bits: np.ndarray, k: int, m: int,
                        seed: int = 0) -> np.ndarray:
    """Byte-key membership in a packed bitmap -> uint8 [n]."""
    _check_bits(bits, m)
    data, lengths = _rows(data, lengths)
    out = np.empty(data.shape[0], np.uint8)
    _lib_or_raise().hf_bloom_contains_rows(
        _p(data, ctypes.c_uint8), data.shape[1], _p(lengths, ctypes.c_int32),
        data.shape[0], seed, k, m, _p(bits, ctypes.c_uint8),
        _p(out, ctypes.c_uint8))
    return out


def popcount(bits: np.ndarray) -> int:
    """Population count of a packed uint8 buffer (host BITCOUNT)."""
    bits = np.ascontiguousarray(bits, np.uint8)
    return int(_lib_or_raise().hf_popcount(_p(bits, ctypes.c_uint8),
                                           bits.shape[0]))
