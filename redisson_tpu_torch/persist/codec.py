"""Journal payload codec — compact, deterministic, self-describing (a copy
of `redisson_tpu.persist.codec`: same tags, same bytes).

Op payloads are plain python containers of codec-encoded values plus numpy
arrays (the ingest paths ship packed key/register arrays). The journal
needs an encoding that is (a) byte-deterministic for a given payload, so
replay golden-tests can compare journals, (b) exact for arbitrary-precision
ints and raw bytes — JSON is neither, and (c) zero-copy-ish for arrays
(`tobytes` of the contiguous buffer, no base64 inflation) in the spirit of
the UltraLogLog space argument: journaling must not dominate the hot path.

Wire format: one tag byte per value, length-prefixed blobs, little-endian
fixed-width ints. Containers encode length then elements (dicts preserve
insertion order). A `torch.Tensor` is encoded as its host numpy array: a
CUDA tensor (the `device_packed` keys of `RHyperLogLog.add_device`) is
copied to the host, and the copy completes before the record is framed.
`np.asarray` of a CUDA tensor raises, so the branch comes before the
generic `__array__` one.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

_U32 = struct.Struct("<I")
_F64 = struct.Struct("<d")


def _blob(out: bytearray, b: bytes) -> None:
    out += _U32.pack(len(b))
    out += b


def _enc(obj: Any, out: bytearray) -> None:
    if obj is None:
        out += b"N"
    elif obj is True:
        out += b"T"
    elif obj is False:
        out += b"F"
    elif isinstance(obj, int):
        # Decimal text: exact for arbitrary precision (u64 cursors, negative
        # TTLs) without a custom bignum format.
        out += b"I"
        _blob(out, str(obj).encode("ascii"))
    elif isinstance(obj, float):
        out += b"D"
        out += _F64.pack(obj)
    elif isinstance(obj, str):
        out += b"S"
        _blob(out, obj.encode("utf-8"))
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        out += b"B"
        _blob(out, bytes(obj))
    elif isinstance(obj, np.generic):
        # numpy scalars (np.uint64 lengths etc.) round-trip as python values.
        _enc(obj.item(), out)
    elif isinstance(obj, list):
        out += b"L"
        out += _U32.pack(len(obj))
        for item in obj:
            _enc(item, out)
    elif isinstance(obj, tuple):
        out += b"U"
        out += _U32.pack(len(obj))
        for item in obj:
            _enc(item, out)
    elif isinstance(obj, dict):
        out += b"M"
        out += _U32.pack(len(obj))
        for k, v in obj.items():
            _enc(k, out)
            _enc(v, out)
    elif isinstance(obj, torch.Tensor):
        # .cpu() of a CUDA tensor is a synchronous copy: the bytes are on
        # the host before they are framed.
        _enc(obj.detach().cpu().numpy(), out)
    elif isinstance(obj, np.ndarray) or hasattr(obj, "__array__"):
        arr = np.ascontiguousarray(np.asarray(obj))
        out += b"A"
        _blob(out, arr.dtype.str.encode("ascii"))
        out += _U32.pack(arr.ndim)
        for dim in arr.shape:
            out += _U32.pack(dim)
        _blob(out, arr.tobytes())
    else:
        raise TypeError(f"journal codec cannot encode {type(obj).__name__!r}")


def encode_payload(obj: Any) -> bytes:
    out = bytearray()
    _enc(obj, out)
    return bytes(out)


def _read_blob(buf: bytes, pos: int) -> Tuple[bytes, int]:
    (n,) = _U32.unpack_from(buf, pos)
    pos += 4
    end = pos + n
    if end > len(buf):
        raise ValueError("journal codec: truncated blob")
    return buf[pos:end], end


def _dec(buf: bytes, pos: int) -> Tuple[Any, int]:
    tag = buf[pos:pos + 1]
    pos += 1
    if tag == b"N":
        return None, pos
    if tag == b"T":
        return True, pos
    if tag == b"F":
        return False, pos
    if tag == b"I":
        b, pos = _read_blob(buf, pos)
        return int(b.decode("ascii")), pos
    if tag == b"D":
        (v,) = _F64.unpack_from(buf, pos)
        return v, pos + 8
    if tag == b"S":
        b, pos = _read_blob(buf, pos)
        return b.decode("utf-8"), pos
    if tag == b"B":
        b, pos = _read_blob(buf, pos)
        return b, pos
    if tag in (b"L", b"U"):
        (n,) = _U32.unpack_from(buf, pos)
        pos += 4
        items = []
        for _ in range(n):
            item, pos = _dec(buf, pos)
            items.append(item)
        return (items if tag == b"L" else tuple(items)), pos
    if tag == b"M":
        (n,) = _U32.unpack_from(buf, pos)
        pos += 4
        d = {}
        for _ in range(n):
            k, pos = _dec(buf, pos)
            v, pos = _dec(buf, pos)
            d[k] = v
        return d, pos
    if tag == b"A":
        dt, pos = _read_blob(buf, pos)
        (ndim,) = _U32.unpack_from(buf, pos)
        pos += 4
        shape = []
        for _ in range(ndim):
            (dim,) = _U32.unpack_from(buf, pos)
            shape.append(dim)
            pos += 4
        raw, pos = _read_blob(buf, pos)
        arr = np.frombuffer(raw, dtype=np.dtype(dt.decode("ascii")))
        return arr.reshape(shape).copy(), pos
    raise ValueError(f"journal codec: unknown tag {tag!r} at offset {pos - 1}")


def decode_payload(buf: bytes) -> Any:
    obj, pos = _dec(buf, 0)
    if pos != len(buf):
        raise ValueError(f"journal codec: {len(buf) - pos} trailing bytes")
    return obj
