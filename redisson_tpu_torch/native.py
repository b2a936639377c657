"""ctypes binding of the host library (`csrc/host_fold.cpp` and
`csrc/resp.cpp`).

The host half of the delta / tape ingest and of the Bloom host mirror:
murmur3 folds of u64 keys or byte rows into HLL registers or a packed
big-endian Bloom bitmap, Bloom probes against such a bitmap, and a
population count (`hll_fold` is the list-of-bytes form the embedded RESP
server's PFADD folds with, `interop/fake_server.py`). And the RESP2 wire
codec of the RESP front-end (`wire/`) and of the redis tier's client
(`interop/`): `resp_encode` / `resp_encode_pipeline` and the incremental
`RespParser`.
The port's counterpart of the fold and RESP functions of
`redisson_tpu.native`, with its own copy of the C++ source.

The library is compiled with `g++` at first use into the package's
git-ignored `build/` directory, named by a digest of the sources (like the
CUDA libraries, `ops/_build.py`). There is no Python fallback: `available()`
says whether the library built and loaded, and every fold and the codec
raise when it did not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

from redisson_tpu_torch.ops import _build

SOURCE = _build.CSRC / "host_fold.cpp"
#: every source compiled into the one library (the fold half, the codec)
SOURCES = (SOURCE, _build.CSRC / "resp.cpp")
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
    "hf_resp_encode_pipeline": [_U8, ctypes.POINTER(_I64), _I32, _I64,
                                ctypes.POINTER(_I64)],
    "hf_free": [ctypes.c_void_p],
    "hf_resp_parser_new": [],
    "hf_resp_parser_free": [ctypes.c_void_p],
    "hf_resp_parser_feed": [ctypes.c_void_p, _U8, _I64],
    "hf_resp_parser_pending": [ctypes.c_void_p],
    "hf_resp_parser_take": [ctypes.c_void_p, _U8, _I64],
}
_RESTYPES = {
    "hf_popcount": ctypes.c_uint64,
    "hf_resp_encode_pipeline": ctypes.c_void_p,
    "hf_resp_parser_new": ctypes.c_void_p,
    "hf_resp_parser_feed": _I64,
    "hf_resp_parser_pending": _I64,
    "hf_resp_parser_take": _I64,
}


def target() -> "os.PathLike":
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in SOURCES)).hexdigest()[:16]
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
    out = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp),
                          *(str(p) for p in SOURCES), "-lpthread"],
                         capture_output=True, text=True, timeout=300)
    BUILD_LOG = out.stdout + out.stderr
    if out.returncode != 0:
        raise RuntimeError(f"host fold library build failed:\n{BUILD_LOG}")
    os.replace(tmp, so)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None:
        return _lib
    # `_tried` is read under the lock: a thread that came while another one
    # was building must wait for that build, not report the library missing.
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
                fn.restype = _RESTYPES.get(name)
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


def hll_fold(keys: Sequence[bytes], regs: np.ndarray, seed: int = 0) -> np.ndarray:
    """Fold a list of byte keys into the registers, in place; returns
    `regs`. The keys go to the library's row entry as zero-padded [n, w]
    rows (JAX's list form has a Python fallback; this one raises without
    the library, like every entry here)."""
    _check_regs(regs)
    lib = _lib_or_raise()
    n = len(keys)
    if n == 0:
        return regs
    lengths = np.fromiter(map(len, keys), np.int32, n)
    w = max(1, int(lengths.max()))
    data = np.zeros((n, w), np.uint8)
    data[np.arange(w) < lengths[:, None]] = np.frombuffer(b"".join(keys), np.uint8)
    lib.hf_hll_fold_rows(_p(data, ctypes.c_uint8), w,
                         _p(lengths, ctypes.c_int32), n, seed,
                         _p(regs, ctypes.c_uint8))
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


# ---------------------------------------------------------------------------
# RESP2 codec
# ---------------------------------------------------------------------------

def _as_arg(a) -> bytes:
    if isinstance(a, bytes):
        return a
    if isinstance(a, str):
        return a.encode()
    if isinstance(a, (int, float)):
        return repr(a).encode() if isinstance(a, float) else str(a).encode()
    return bytes(a)


def _u8(arr: np.ndarray):
    if arr.size == 0:
        # NULL is fine: every native loop guards on its length first.
        return ctypes.cast(0, _U8)
    return _p(arr, ctypes.c_uint8)


def resp_encode(*args) -> bytes:
    """Encode one command (a RESP array of bulk strings)."""
    return resp_encode_pipeline([args])


def resp_encode_pipeline(commands: Sequence[Sequence]) -> bytes:
    """Encode many commands into one wire buffer (a pipeline)."""
    lib = _lib_or_raise()
    flat: List[bytes] = []
    counts = np.empty(len(commands), np.int32)
    for i, cmd in enumerate(commands):
        enc = [_as_arg(a) for a in cmd]
        counts[i] = len(enc)
        flat.extend(enc)
    offsets = np.zeros(len(flat) + 1, np.int64)
    if flat:
        np.cumsum(np.fromiter((len(a) for a in flat), np.int64, len(flat)),
                  out=offsets[1:])
    data = np.frombuffer(b"".join(flat), np.uint8)
    out_len = ctypes.c_int64()
    ptr = lib.hf_resp_encode_pipeline(
        _u8(data), offsets.ctypes.data_as(ctypes.POINTER(_I64)),
        _p(counts, ctypes.c_int32), len(commands), ctypes.byref(out_len))
    try:
        return ctypes.string_at(ptr, out_len.value)
    finally:
        lib.hf_free(ptr)


class RespError(Exception):
    """A Redis `-ERR ...` reply."""


class RespParser:
    """Incremental RESP2 parser. feed(data) -> list of completed frames.

    Frames decode as: bytes (bulk / simple strings), int, None (null bulk /
    null array), list (arrays, recursively), RespError instances for error
    frames (returned, not raised: the caller decides). A protocol violation
    (a bad header, RESP3 types included, or nesting deeper than 64)
    surfaces one error frame and drops the rest of the stream."""

    def __init__(self):
        self._lib = _lib_or_raise()
        self._h = self._lib.hf_resp_parser_new()

    def close(self):
        if self._h is not None:
            self._lib.hf_resp_parser_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

    def feed(self, data: bytes) -> List:
        if self._h is None:
            raise ValueError("RespParser is closed")
        buf = np.frombuffer(data, np.uint8)
        n = self._lib.hf_resp_parser_feed(self._h, _u8(buf), len(data))
        if n == 0:
            return []
        pend = self._lib.hf_resp_parser_pending(self._h)
        out = np.empty(pend, np.uint8)
        got = self._lib.hf_resp_parser_take(self._h, _u8(out), pend)
        if got != pend:
            raise RuntimeError(f"RESP parser handed back {got} of {pend} bytes")
        return self._unflatten(out.tobytes(), n)

    @staticmethod
    def _unflatten(stream: bytes, count: int) -> List:
        pos = 0

        def one():
            nonlocal pos
            t = stream[pos:pos + 1]
            payload = int.from_bytes(stream[pos + 1:pos + 9], "little", signed=True)
            pos += 9
            if t == b":":
                return payload
            if t in (b"+", b"$", b"-"):
                if t == b"$" and payload < 0:
                    return None
                body = stream[pos:pos + payload]
                pos += payload
                if t == b"-":
                    return RespError(body.decode("utf-8", "replace"))
                return body
            if t == b"*":
                if payload < 0:
                    return None
                return [one() for _ in range(payload)]
            raise ValueError(f"bad flat type {t!r}")

        return [one() for _ in range(count)]
