"""Value codecs: object <-> bytes at the API boundary, and the key encoding
that hashing sees (a copy of `redisson_tpu.codecs`).

JSON is the default (the reference's default is JsonJacksonCodec), with
string / long / raw-bytes wire codecs and a pickle codec standing in for JDK
serialization. Compression wrappers (zlib here; LZ4 / Snappy when their
packages are installed) compose over any inner codec. The optional codecs
(msgpack, cbor, lz4, snappy) raise at construction when their package is
missing.
"""

from __future__ import annotations

import json
import pickle
import zlib
from typing import Any


class Codec:
    name = "base"

    def encode(self, value: Any) -> bytes:
        raise NotImplementedError

    def decode(self, data: bytes) -> Any:
        raise NotImplementedError


class JsonCodec(Codec):
    """Default codec (JsonJacksonCodec analogue)."""

    name = "json"

    def encode(self, value: Any) -> bytes:
        return json.dumps(value, sort_keys=True, separators=(",", ":")).encode()

    def decode(self, data: bytes) -> Any:
        return json.loads(data.decode())


class StringCodec(Codec):
    name = "string"

    def encode(self, value: Any) -> bytes:
        return value.encode() if isinstance(value, str) else bytes(value)

    def decode(self, data: bytes) -> Any:
        return data.decode()


class LongCodec(Codec):
    name = "long"

    def encode(self, value: Any) -> bytes:
        return str(int(value)).encode()

    def decode(self, data: bytes) -> Any:
        return int(data)


class BytesCodec(Codec):
    name = "bytes"

    def encode(self, value: Any) -> bytes:
        return bytes(value)

    def decode(self, data: bytes) -> Any:
        return data


class PickleCodec(Codec):
    """JDK SerializationCodec analogue."""

    name = "pickle"

    def encode(self, value: Any) -> bytes:
        return pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)

    def decode(self, data: bytes) -> Any:
        return pickle.loads(data)


class CompressionCodec(Codec):
    """zlib wrapper over an inner codec (LZ4/SnappyCodec analogue)."""

    name = "zlib"

    def __init__(self, inner: Codec):
        self.inner = inner

    def encode(self, value: Any) -> bytes:
        return zlib.compress(self.inner.encode(value))

    def decode(self, data: bytes) -> Any:
        return self.inner.decode(zlib.decompress(data))


class MsgPackCodec(Codec):
    """MsgPackJacksonCodec analogue. Gated: requires the msgpack package."""

    name = "msgpack"

    def __init__(self):
        import msgpack  # noqa: F401 — fail fast if unavailable

        self._msgpack = msgpack

    def encode(self, value: Any) -> bytes:
        return self._msgpack.packb(value, use_bin_type=True)

    def decode(self, data: bytes) -> Any:
        return self._msgpack.unpackb(data, raw=False)


class CborCodec(Codec):
    """CborJacksonCodec analogue. Gated: requires the cbor2 package."""

    name = "cbor"

    def __init__(self):
        import cbor2

        self._cbor = cbor2

    def encode(self, value: Any) -> bytes:
        return self._cbor.dumps(value)

    def decode(self, data: bytes) -> Any:
        return self._cbor.loads(data)


class Lz4Codec(Codec):
    """LZ4Codec analogue over an inner codec. Gated: requires lz4."""

    name = "lz4"

    def __init__(self, inner: "Codec" = None):
        import lz4.frame

        self._lz4 = lz4.frame
        self.inner = inner or JsonCodec()

    def encode(self, value: Any) -> bytes:
        return self._lz4.compress(self.inner.encode(value))

    def decode(self, data: bytes) -> Any:
        return self.inner.decode(self._lz4.decompress(data))


class SnappyCodec(Codec):
    """SnappyCodec analogue over an inner codec. Gated: requires snappy."""

    name = "snappy"

    def __init__(self, inner: "Codec" = None):
        import snappy

        self._snappy = snappy
        self.inner = inner or JsonCodec()

    def encode(self, value: Any) -> bytes:
        return self._snappy.compress(self.inner.encode(value))

    def decode(self, data: bytes) -> Any:
        return self.inner.decode(self._snappy.decompress(data))


_REGISTRY = {
    "json": JsonCodec,
    "string": StringCodec,
    "long": LongCodec,
    "bytes": BytesCodec,
    "pickle": PickleCodec,
    "msgpack": MsgPackCodec,
    "cbor": CborCodec,
    "lz4": Lz4Codec,
    "snappy": SnappyCodec,
    # zlib compression wrapper defaults to json inside (stdlib, always on)
    "zlib": lambda: CompressionCodec(JsonCodec()),
}


def get_codec(name_or_codec) -> Codec:
    if isinstance(name_or_codec, Codec):
        return name_or_codec
    try:
        factory = _REGISTRY[name_or_codec]
    except KeyError:
        raise ValueError(f"unknown codec '{name_or_codec}'") from None
    try:
        return factory()
    except ImportError as e:
        raise ValueError(
            f"codec '{name_or_codec}' needs an optional package: {e}") from e


def encode_key(value: Any, codec: Codec) -> bytes:
    """Encode a value for hashing: bytes/str pass through, rest via codec."""
    if isinstance(value, bytes):
        return value
    if isinstance(value, str):
        return value.encode()
    if isinstance(value, bool):  # before int: bool is an int subtype
        return codec.encode(value)
    if isinstance(value, int):
        return str(value).encode()
    return codec.encode(value)
