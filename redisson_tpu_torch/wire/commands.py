"""Wire command table: RESP command frames -> engine ops -> RESP replies
(counterpart of `redisson_tpu.wire.commands`).

Each data-plane command builds an :class:`EngineCall` — a list of staged
``(target, kind, payload, nkeys)`` ops in the executor's narrow-waist shape
(the exact payloads the model layer builds, reusing ``RObject._encode_batch``
for key hashing so a value written over the wire and the same value written
through the facade land in identical sketch registers) plus a renderer that
turns the resolved results into the RESP reply frame.

The server coalesces EngineCalls from MANY connections into one
``ServingLayer.execute_many`` window; introspection commands (INFO, MEMORY,
SLOWLOG, CLUSTER, HELLO, ...) never touch the engine and are handled inline
in ``wire/server.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from redisson_tpu_torch.wire import proto

#: one staged op in the executor's narrow-waist shape
StagedOp = Tuple[str, str, Any, int]


class WireCommandError(Exception):
    """Rendered as ``-ERR <msg>``; the command never reaches the engine."""


class EngineCall:
    """A data-plane command: its staged ops + the reply renderer.

    ``render(results, proto_ver)`` receives one resolved result per op, in
    op order; ``key`` is the routing key (cluster slot checks), None for
    keyspace-wide ops."""

    __slots__ = ("ops", "render", "key")

    def __init__(self, ops: List[StagedOp],
                 render: Callable[[List[Any], int], bytes],
                 key: Optional[str] = None):
        self.ops = ops
        self.render = render
        self.key = key


def _text(b: Any) -> str:
    if isinstance(b, (bytes, bytearray)):
        return bytes(b).decode("utf-8", "surrogateescape")
    return str(b)


def _int_arg(b: Any, what: str) -> int:
    try:
        return int(_text(b))
    except ValueError:
        raise WireCommandError(f"value is not an integer or out of range "
                               f"({what})")


def _need(args: Sequence[bytes], n: int, name: str) -> None:
    if len(args) < n:
        raise WireCommandError(f"wrong number of arguments for "
                               f"'{name.lower()}' command")


# -- builders -----------------------------------------------------------------

def _pfadd(client, args) -> EngineCall:
    _need(args, 2, "pfadd")
    key = _text(args[1])
    values = list(args[2:])
    obj = client.get_hyper_log_log(key)
    data, lengths = obj._encode_batch(values)
    ops = [(key, "hll_add", {"data": data, "lengths": lengths},
            int(data.shape[0]))]
    return EngineCall(
        ops, lambda rs, p: proto.integer(1 if rs[0] else 0), key)


def _pfcount(client, args) -> EngineCall:
    _need(args, 2, "pfcount")
    keys = [_text(a) for a in args[1:]]
    if len(keys) == 1:
        ops = [(keys[0], "hll_count", None, 1)]
    else:
        ops = [(keys[0], "hll_count_with", {"names": keys[1:]}, len(keys))]
    return EngineCall(
        ops, lambda rs, p: proto.integer(int(rs[0] or 0)), keys[0])


def _pfmerge(client, args) -> EngineCall:
    _need(args, 2, "pfmerge")
    dest = _text(args[1])
    sources = [_text(a) for a in args[2:]]
    ops = [(dest, "hll_merge_with", {"names": sources},
            max(1, len(sources)))]
    return EngineCall(ops, lambda rs, p: proto.ok(), dest)


def _setbit(client, args) -> EngineCall:
    _need(args, 4, "setbit")
    key = _text(args[1])
    offset = _int_arg(args[2], "bit offset")
    value = _int_arg(args[3], "bit")
    if offset < 0:
        raise WireCommandError("bit offset is not an integer or out of range")
    if value not in (0, 1):
        raise WireCommandError("bit is not an integer or out of range")
    idx = np.asarray([offset], np.int64)
    kind = "bitset_set" if value else "bitset_clear"
    ops = [(key, kind, {"idx": idx, "max_idx": offset}, 1)]
    return EngineCall(
        ops, lambda rs, p: proto.integer(int(np.asarray(rs[0])[0])), key)


def _getbit(client, args) -> EngineCall:
    _need(args, 3, "getbit")
    key = _text(args[1])
    offset = _int_arg(args[2], "bit offset")
    if offset < 0:
        raise WireCommandError("bit offset is not an integer or out of range")
    idx = np.asarray([offset], np.int64)
    ops = [(key, "bitset_get", {"idx": idx}, 1)]
    return EngineCall(
        ops, lambda rs, p: proto.integer(int(np.asarray(rs[0])[0])), key)


def _bitcount(client, args) -> EngineCall:
    if len(args) != 2:
        # start/end windows need a byte-range scan kind the engine does not
        # expose; refuse loudly instead of answering the wrong question.
        raise WireCommandError("BITCOUNT with a range is not supported")
    key = _text(args[1])
    ops = [(key, "bitset_cardinality", None, 1)]
    return EngineCall(
        ops, lambda rs, p: proto.integer(int(rs[0] or 0)), key)


def _bitop(client, args) -> EngineCall:
    _need(args, 4, "bitop")
    op = _text(args[1]).lower()
    dest = _text(args[2])
    sources = [_text(a) for a in args[3:]]
    if op not in ("and", "or", "xor", "not"):
        raise WireCommandError("syntax error")
    if op == "not":
        if sources != [dest]:
            # Engine BITOP NOT is in-place (RBitSet.not_); an out-of-place
            # NOT would need a copy kind. redis requires exactly one source.
            raise WireCommandError(
                "BITOP NOT is in-place here: source must equal destkey")
        sources = []
    # Reply is the destination length in bytes (redis BITOP contract):
    # ride a bitset_size op in the same window, ordered after the bitop.
    ops: List[StagedOp] = [
        (dest, "bitset_op", {"op": op, "names": sources},
         max(1, len(sources))),
        (dest, "bitset_size", None, 1),
    ]
    return EngineCall(
        ops, lambda rs, p: proto.integer(int(rs[1] or 0) // 8), dest)


def _del(client, args) -> EngineCall:
    _need(args, 2, "del")
    keys = [_text(a) for a in args[1:]]
    ops: List[StagedOp] = [(k, "delete", None, 1) for k in keys]
    return EngineCall(
        ops, lambda rs, p: proto.integer(sum(1 for r in rs if r)), keys[0])


def _exists(client, args) -> EngineCall:
    _need(args, 2, "exists")
    keys = [_text(a) for a in args[1:]]
    ops: List[StagedOp] = [(k, "exists", None, 1) for k in keys]
    return EngineCall(
        ops, lambda rs, p: proto.integer(sum(1 for r in rs if r)), keys[0])


def _flushall(client, args) -> EngineCall:
    ops: List[StagedOp] = [("", "flushall", None, 1)]
    return EngineCall(ops, lambda rs, p: proto.ok(), None)


def _dbsize(client, args) -> EngineCall:
    ops: List[StagedOp] = [("", "keys", {"pattern": "*"}, 1)]
    return EngineCall(
        ops, lambda rs, p: proto.integer(len(rs[0] or ())), None)


def _keys(client, args) -> EngineCall:
    _need(args, 2, "keys")
    pattern = _text(args[1])
    ops: List[StagedOp] = [("", "keys", {"pattern": pattern}, 1)]
    return EngineCall(
        ops,
        lambda rs, p: proto.array([proto.bulk(_text(k).encode())
                                   for k in (rs[0] or ())]),
        None)


#: command name -> EngineCall builder (data plane; coalesced into windows)
ENGINE_COMMANDS: Dict[bytes, Callable[[Any, Sequence[bytes]], EngineCall]] = {
    b"PFADD": _pfadd,
    b"PFCOUNT": _pfcount,
    b"PFMERGE": _pfmerge,
    b"SETBIT": _setbit,
    b"GETBIT": _getbit,
    b"BITCOUNT": _bitcount,
    b"BITOP": _bitop,
    b"DEL": _del,
    b"UNLINK": _del,
    b"EXISTS": _exists,
    b"FLUSHALL": _flushall,
    b"DBSIZE": _dbsize,
    b"KEYS": _keys,
}

#: introspection commands the server answers inline on the event loop
INLINE_COMMANDS = frozenset({
    b"PING", b"ECHO", b"HELLO", b"AUTH", b"SELECT", b"QUIT", b"RESET",
    b"INFO", b"MEMORY", b"SLOWLOG", b"CLUSTER", b"CLIENT", b"COMMAND",
})


def build(client, args: Sequence[bytes]) -> EngineCall:
    """Look up + build the EngineCall for one decoded command frame."""
    name = bytes(args[0]).upper()
    fn = ENGINE_COMMANDS.get(name)
    if fn is None:
        raise WireCommandError(
            f"unknown command '{_text(args[0])}'")
    return fn(client, args)
