"""Object base class: name + codec + executor; every object is stateless
client-side (a copy of `redisson_tpu.models.object`)."""

from __future__ import annotations

from concurrent.futures import Future
from typing import Iterable, List, Sequence

import numpy as np

from redisson_tpu_torch.codecs import Codec, encode_key


def map_future(f, fn):
    """Chain a decode step onto an executor future (async methods return
    decoded values, like the reference's reply convertors)."""
    out = Future()

    def done(src):
        if src.cancelled():
            out.cancel()
            return
        exc = src.exception()
        if exc is not None:
            out.set_exception(exc)
        else:
            try:
                out.set_result(fn(src.result()))
            except Exception as e:  # decode error
                out.set_exception(e)

    f.add_done_callback(done)
    note = getattr(f, "_note_mapped", None)
    if note is not None:
        # Staged batch future: register the decode wrapper so
        # RBatch.execute() returns decoded values; forward the hook so
        # chained decodes keep pointing at the same batch slot.
        note(out)
        out._note_mapped = note
    return out


def pack_u64(values) -> np.ndarray:
    """uint64 keys -> their raw little-endian uint32 view [n, 2]
    ([:, 0]=lo, [:, 1]=hi), the key layout shared with the JAX package (the
    backend views it as int64 keys).

    BORROW CONTRACT: when `values` is already uint64-contiguous no copy is
    taken; the caller must not mutate the source array until the op's
    future resolves."""
    values = np.ascontiguousarray(values, np.uint64)
    return values.view(np.uint32).reshape(-1, 2)


class RObject:
    """name + codec + executor; all state lives behind the executor."""

    def __init__(self, name: str, executor, codec: Codec,
                 key_width_buckets: Sequence[int] = (16, 32, 64, 128, 256)):
        self.name = name
        self._executor = executor
        self._codec = codec
        self._width_buckets = tuple(key_width_buckets)

    def _encode_batch(self, values: Iterable) -> tuple:
        """values -> ([N, W] uint8 zero-padded, [N] int32 lengths); W is the
        smallest configured width bucket holding the longest key."""
        keys: List[bytes] = [encode_key(v, self._codec) for v in values]
        n = len(keys)
        lengths = (np.fromiter((len(k) for k in keys), np.int32, n) if n
                   else np.zeros((0,), np.int32))
        max_len = int(lengths.max()) if n else 1
        w = next((b for b in self._width_buckets if b >= max_len), None)
        if w is None:
            raise ValueError(
                f"key length {max_len} exceeds max width bucket "
                f"{self._width_buckets[-1]}")
        data = np.zeros((n, w), np.uint8)
        if n:
            # A row-major mask selects exactly the first len(k) cells of each
            # row, in concatenation order: one vectorized fill.
            flat = np.frombuffer(b"".join(keys), np.uint8)
            data[np.arange(w, dtype=np.int32)[None, :] < lengths[:, None]] = flat
        return data, lengths

    def delete(self) -> bool:
        return self.delete_async().result()

    def delete_async(self):
        return self._executor.execute_async(self.name, "delete", None)

    def is_exists(self) -> bool:
        return self._executor.execute_sync(self.name, "exists", None)

    def get_name(self) -> str:
        return self.name

    def rename(self, new_name: str) -> None:
        """RENAME: move this object's state under a new key; this handle
        follows it."""
        self._executor.execute_sync(self.name, "rename", {"newkey": new_name})
        self.name = new_name

    def renamenx(self, new_name: str) -> bool:
        """RENAMENX: rename only when the destination is absent (one atomic
        op on the dispatcher)."""
        ok = self._executor.execute_sync(
            self.name, "rename", {"newkey": new_name, "nx": True})
        if ok:
            self.name = new_name
        return bool(ok)
