"""The RESP frame codec — ONE implementation per direction (counterpart of
`redisson_tpu.wire.proto`).

Request direction (client -> server): encode via the port's C++ codec's
``resp_encode`` / ``resp_encode_pipeline``, parse via ``RespParser`` (both
in `redisson_tpu_torch.native`, with no Python fallback) — re-exported here
so every user imports the same symbols from the same place.

Reply direction (server -> client): the functions below render python
values into RESP2/RESP3 frames, the same bytes the JAX package's wire
server writes.

RESP3 (``HELLO 3``) differences handled here:

  * maps render as ``%N`` instead of a flattened ``*2N`` array;
  * doubles render as ``,<val>`` instead of a bulk string;
  * null renders as ``_`` instead of ``$-1``.

Redirect/overload renderers (``moved`` / ``ask`` / ``busy``) translate the
cluster and serve error taxonomy into the wire shapes real redis clients
already know how to follow.
"""

from __future__ import annotations

from typing import Any, Iterable, List, Optional, Sequence, Tuple

from redisson_tpu_torch.native import (RespError, RespParser, resp_encode,
                                       resp_encode_pipeline)

__all__ = [
    "RespError", "RespParser", "resp_encode", "resp_encode_pipeline",
    "ok", "simple", "err", "integer", "bulk", "array", "double",
    "null", "map_reply", "render_value", "moved", "ask", "busy",
    "RESP2", "RESP3",
]

RESP2 = 2
RESP3 = 3

OK = b"+OK\r\n"
NIL_BULK = b"$-1\r\n"
NIL_RESP3 = b"_\r\n"


def _b(v: Any) -> bytes:
    if isinstance(v, bytes):
        return v
    if isinstance(v, bytearray):
        return bytes(v)
    if isinstance(v, str):
        return v.encode()
    return str(v).encode()


def ok() -> bytes:
    return OK


def simple(s: Any) -> bytes:
    return b"+" + _b(s) + b"\r\n"


def err(msg: str, code: str = "ERR") -> bytes:
    """``-<code> <msg>`` error frame. `msg` must not contain CR/LF (RESP
    simple-error frames are line-delimited); offenders are flattened."""
    text = f"{code} {msg}".replace("\r", " ").replace("\n", " ")
    return b"-" + text.encode() + b"\r\n"


def integer(v: int) -> bytes:
    return b":%d\r\n" % int(v)


def bulk(v: Optional[bytes]) -> bytes:
    if v is None:
        return NIL_BULK
    v = _b(v)
    return b"$%d\r\n" % len(v) + v + b"\r\n"


def array(items: Sequence[bytes]) -> bytes:
    return b"*%d\r\n" % len(items) + b"".join(items)


def null(proto: int = RESP2) -> bytes:
    return NIL_RESP3 if proto >= RESP3 else NIL_BULK


def double(v: float, proto: int = RESP2) -> bytes:
    if proto >= RESP3:
        return b",%.17g\r\n" % float(v)
    return bulk(("%.17g" % float(v)).encode())


def map_reply(pairs: Iterable[Tuple[Any, Any]],
              proto: int = RESP2) -> bytes:
    """Key/value map: RESP3 ``%N`` map frame, RESP2 flattened array."""
    flat: List[bytes] = []
    n = 0
    for k, v in pairs:
        flat.append(render_value(k, proto))
        flat.append(render_value(v, proto))
        n += 1
    if proto >= RESP3:
        return b"%%%d\r\n" % n + b"".join(flat)
    return array(flat)


def render_value(v: Any, proto: int = RESP2) -> bytes:
    """Generic python -> RESP frame (the INFO/MEMORY/CLUSTER introspection
    renderer: nested dicts/lists come straight from the facade)."""
    if v is None:
        return null(proto)
    if isinstance(v, bool):
        return integer(1 if v else 0)
    if isinstance(v, int):
        return integer(v)
    if isinstance(v, float):
        return double(v, proto)
    if isinstance(v, (bytes, bytearray, str)):
        return bulk(_b(v))
    if isinstance(v, dict):
        return map_reply(v.items(), proto)
    if isinstance(v, (list, tuple, set, frozenset)):
        seq = sorted(v) if isinstance(v, (set, frozenset)) else v
        return array([render_value(x, proto) for x in seq])
    return bulk(repr(v).encode())


# -- redirect / overload rendering -------------------------------------------

def moved(slot: int, addr: str) -> bytes:
    """``-MOVED <slot> <host:port>`` — permanent slot relocation."""
    return f"-MOVED {int(slot)} {addr}\r\n".encode()


def ask(slot: int, addr: str) -> bytes:
    """``-ASK <slot> <host:port>`` — one-op redirect during a cutover."""
    return f"-ASK {int(slot)} {addr}\r\n".encode()


def busy(msg: str, retry_after_s: float = 0.0) -> bytes:
    """``-BUSY`` overload shedding frame carrying the retry hint the serve
    tier computed (RejectedError.retry_after_s), so well-behaved clients
    back off by the server's estimate instead of guessing."""
    text = str(msg).replace("\r", " ").replace("\n", " ")
    return (f"-BUSY retry_after={max(0.0, float(retry_after_s)):.3f}s "
            f"{text}\r\n").encode()
