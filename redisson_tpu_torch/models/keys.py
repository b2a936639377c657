"""RKeys — keyspace facade (reference: `RedissonKeys.java` over
KEYS/RANDOMKEY/DEL/FLUSHALL; fans out across both storage tiers via the
RoutingBackend, the analogue of `readAllAsync` + SlotCallback)."""

from __future__ import annotations

from typing import List, Optional


class RKeys:
    def __init__(self, executor, routing):
        self._executor = executor
        self._routing = routing

    def get_keys(self, pattern: str = "*") -> List[str]:
        # A real op on the dispatcher thread, so the listing is serialized
        # with in-flight mutations across both tiers.
        return self._executor.execute_sync("", "keys", {"pattern": pattern})

    def get_keys_by_pattern(self, pattern: str) -> List[str]:
        return self.get_keys(pattern)

    def find_keys_by_pattern(self, pattern: str) -> List[str]:
        """Reference findKeysByPattern (KEYS pattern)."""
        return self.get_keys(pattern)

    def get_slot(self, key: str) -> int:
        """CRC16 key slot (reference getSlot; same function cluster routing
        uses, connection/CRC16.java + hashtag rules)."""
        from redisson_tpu_torch.ops import crc16

        return crc16.key_slot(key)

    def random_key(self) -> Optional[str]:
        import random

        keys = self.get_keys()
        return random.choice(keys) if keys else None

    def count(self) -> int:
        return len(self.get_keys())

    def delete(self, *names: str) -> int:
        n = 0
        for name in names:
            if self._executor.execute_sync(name, "delete", None):
                n += 1
        return n

    def delete_by_pattern(self, pattern: str) -> int:
        return self.delete(*self.get_keys(pattern))

    # -- async twins (RKeysAsync; also what RBatch.get_keys() stages) -------

    def get_keys_async(self, pattern: str = "*"):
        return self._executor.execute_async(
            "", "keys", {"pattern": pattern})

    def delete_async(self, *names: str):
        """Stage/async delete; resolves to the number of keys removed.

        The aggregate never blocks inside a done-callback: callbacks run on
        the dispatcher thread, and waiting there for a sibling future that
        the same thread must complete would deadlock the client.  Instead
        each future decrements a counter and the last one to finish sums the
        (all-done) results.
        """
        from redisson_tpu_torch.models.object import map_future

        if not names:
            return None
        if len(names) == 1:
            return map_future(
                self._executor.execute_async(names[0], "delete", None),
                lambda ok: int(bool(ok)))
        futs = [self._executor.execute_async(n, "delete", None)
                for n in names]

        import threading
        from concurrent.futures import Future

        out = Future()
        remaining = [len(futs)]
        lock = threading.Lock()

        def _one_done(_f):
            with lock:
                remaining[0] -= 1
                if remaining[0]:
                    return
            # All siblings are done; reading result() cannot block now.
            try:
                total = 0
                for f in futs:
                    exc = f.exception()
                    if exc is not None:
                        out.set_exception(exc)
                        return
                    total += int(bool(f.result()))
                out.set_result(total)
            except Exception as e:  # pragma: no cover - defensive
                out.set_exception(e)

        for f in futs:
            f.add_done_callback(_one_done)
        return out

    def flushall(self) -> None:
        self._executor.execute_sync("", "flushall", None)

    def flushdb(self) -> None:
        self.flushall()
