"""RExpirable base (reference: `RedissonExpirable.java` — expire/TTL ops
available on every keyed object)."""

from __future__ import annotations

from redisson_tpu_torch.models.object import RObject


class RExpirable(RObject):
    def expire(self, seconds: float) -> bool:
        return self.expire_async(seconds).result()

    def expire_async(self, seconds: float):
        return self._executor.execute_async(self.name, "pexpire", {"ms": int(seconds * 1000)})

    def expire_at(self, timestamp_s: float) -> bool:
        return self._executor.execute_sync(
            self.name, "pexpireat", {"ts_ms": int(timestamp_s * 1000)}
        )

    def clear_expire(self) -> bool:
        return self._executor.execute_sync(self.name, "persist", None)

    def remain_time_to_live(self) -> int:
        """Remaining TTL in ms; -1 no expiry, -2 no key (PTTL contract)."""
        return self._executor.execute_sync(self.name, "pttl", None)

    def rename(self, new_name: str) -> None:
        self._executor.execute_sync(self.name, "rename", {"newkey": new_name})
        self.name = new_name
