"""Bloom filter over the wire — the reference's own execution model
(counterpart of `redisson_tpu.interop.bloom_redis`).

`RedissonBloomFilter.java`: k SETBIT/GETBIT per key behind a Lua config
guard (`:80-168`), config in the `{name}__config` sidecar hash
(`:254-256`). Index math matches the device tier exactly (same murmur3
halves, same `(h1 + i*h2) mod 2^64 mod m` walk, same seed when configured
alike), so filters flushed by the durability tier and filters built live
over the wire are bit-compatible.

The passthrough mode holds no device state: the keys hash with the port's
`ops.hashing.murmur3_x64_128` on CPU tensors (the JAX package calls its
native batch murmur3 here, which the port's host library does not have),
and the k-index walk runs in numpy uint64, exact for every m up to the
2^32 cap (`ops.bloom.indexes` is exact only up to 2^31 or a power of two).
"""

from __future__ import annotations

from typing import List

from redisson_tpu_torch.executor import Op
from redisson_tpu_torch.native import RespError
from redisson_tpu_torch.ops import bloom_math


def _bloom_cfg_key(name: str) -> str:
    from redisson_tpu_torch.interop.durability import bloom_config_key

    return bloom_config_key(name)


def _bloom_indexes_host(keys: List[bytes], k: int, m: int, seed: int = 0):
    """Exact host-side index walk: [n] keys -> [n][k] python-int offsets."""
    import numpy as np
    import torch

    from redisson_tpu_torch.ops import hashing

    if not keys:
        return []
    width = max(16, max(len(key) for key in keys))
    data = np.zeros((len(keys), width), np.uint8)
    for i, key in enumerate(keys):
        data[i, : len(key)] = np.frombuffer(key, np.uint8)
    lengths = np.array([len(key) for key in keys], np.int32)
    h1, h2 = hashing.murmur3_x64_128(torch.from_numpy(data),
                                     torch.from_numpy(lengths), seed)
    h1 = h1.numpy().view(np.uint64)[:, None]
    h2 = h2.numpy().view(np.uint64)[:, None]
    # uint64 arithmetic wraps mod 2^64, as the reference's long math does.
    with np.errstate(over="ignore"):
        walk = (h1 + np.arange(k, dtype=np.uint64)[None, :] * h2) % np.uint64(m)
    return walk.tolist()


# Atomic config-guard + SETBIT batch: ARGV = size, hashIterations, then
# per-key groups of k offsets. Returns per-key added flags (1 when any of
# the key's bits was 0). Aborts with BLOOMCFG when the config drifted; the
# caller re-reads config and retries (RedissonBloomFilter.java:80-114).
_BLOOM_ADD_LUA = (
    "local size = redis.call('hget', KEYS[2], 'size') "
    "local hi = redis.call('hget', KEYS[2], 'hashIterations') "
    "if size ~= ARGV[1] or hi ~= ARGV[2] then "
    "  return redis.error_reply('BLOOMCFG config changed') end "
    "local k = tonumber(ARGV[2]) "
    "local out = {} "
    "local n = (#ARGV - 2) / k "
    "for key = 1, n do "
    "  local added = 0 "
    "  for i = 1, k do "
    "    local off = ARGV[2 + (key - 1) * k + i] "
    "    if redis.call('setbit', KEYS[1], off, 1) == 0 then added = 1 end "
    "  end "
    "  out[key] = added "
    "end "
    "return out")

_BLOOM_CONTAINS_LUA = (
    "local size = redis.call('hget', KEYS[2], 'size') "
    "local hi = redis.call('hget', KEYS[2], 'hashIterations') "
    "if size ~= ARGV[1] or hi ~= ARGV[2] then "
    "  return redis.error_reply('BLOOMCFG config changed') end "
    "local k = tonumber(ARGV[2]) "
    "local out = {} "
    "local n = (#ARGV - 2) / k "
    "for key = 1, n do "
    "  local hit = 1 "
    "  for i = 1, k do "
    "    local off = ARGV[2 + (key - 1) * k + i] "
    "    if redis.call('getbit', KEYS[1], off) == 0 then hit = 0 end "
    "  end "
    "  out[key] = hit "
    "end "
    "return out")

_BLOOM_INIT_LUA = (
    "if redis.call('exists', KEYS[2]) == 1 then return 0 end "
    "redis.call('hset', KEYS[2], 'size', ARGV[1], 'hashIterations', ARGV[2], "
    "'expectedInsertions', ARGV[3], 'falseProbability', ARGV[4]) "
    "return 1")


class RedisBloomMixin:
    """Bloom op handlers mixed into RedisBackend (which provides `_x`,
    `_eval` and `hash_seed`)."""

    # murmur3 seed for the host-side index walk; MUST match the device
    # tier's CudaConfig.hash_seed when filters cross tiers via durability flushes.
    hash_seed: int = 0

    def _op_bloom_init(self, key: str, op: Op) -> None:
        from redisson_tpu_torch.interop.backend_redis import UnsupportedInRedisMode

        p = op.payload
        if p.get("blocked"):
            raise UnsupportedInRedisMode(
                "blocked bloom layout is a device-tier feature; redis mode "
                "keeps the reference's classic layout")
        n, prob = p["expected_insertions"], p["false_probability"]
        m = bloom_math.optimal_num_of_bits(n, prob)
        k = bloom_math.optimal_num_of_hash_functions(n, m)
        # Layout-independent cap only: the host-side walk takes any m, the
        # device index math's power-of-two restriction does not apply here.
        bloom_math.check_cap(m)
        res = self._eval(
            _BLOOM_INIT_LUA, [key, _bloom_cfg_key(key)],
            [str(m), str(k), str(n), repr(float(prob))])
        op.future.set_result(res == 1)

    def _bloom_cfg(self, key: str, allow_blocked: bool = False):
        from redisson_tpu_torch.interop.backend_redis import UnsupportedInRedisMode

        pairs = self._x("HGETALL", _bloom_cfg_key(key))
        if not pairs:
            raise RuntimeError(f"bloom filter '{key}' is not initialized")
        cfg = {bytes(pairs[i]).decode(): bytes(pairs[i + 1]).decode()
               for i in range(0, len(pairs), 2)}
        if not allow_blocked and cfg.get("blocked") in ("1", "true", "True"):
            # A blocked-layout filter flushed from the device tier: the classic
            # (h1 + i*h2) mod m walk below would silently return false
            # negatives against blocked-layout bits — refuse loudly instead
            # (same guard as _op_bloom_init; advisor r3 medium).
            raise UnsupportedInRedisMode(
                f"bloom filter '{key}' uses the blocked (device-tier) layout; "
                "redis mode cannot answer it — re-add into a classic filter")
        return int(cfg["size"]), int(cfg["hashIterations"]), cfg

    def _bloom_keys_of(self, op: Op) -> List[bytes]:
        from redisson_tpu_torch.interop.backend_redis import UnsupportedInRedisMode

        p = op.payload
        if "device_packed" in p:
            # No opaque KeyError: device-resident key batches are a device-tier
            # surface (advisor r3 low).
            raise UnsupportedInRedisMode(
                "device-resident key batches are not available in redis "
                "mode; use contains_count_ints / contains_ints with host "
                "keys")
        if "packed" in p:
            import numpy as np

            return [bytes(row) for row in
                    np.ascontiguousarray(p["packed"], np.uint32)
                    .view(np.uint8).reshape(-1, 8)]
        data, lengths = p["data"], p["lengths"]
        return [bytes(data[i, : lengths[i]]) for i in range(data.shape[0])]

    def _bloom_rw(self, key: str, op: Op, script: str):
        import numpy as np

        keys = self._bloom_keys_of(op)
        out: List[int] = []
        for attempt in range(3):
            m, k, _ = self._bloom_cfg(key)
            idx = _bloom_indexes_host(keys, k, m, self.hash_seed)
            out = []
            try:
                # Slab the Lua argv (very large batches would build giant
                # argument lists; the reference pipelines similarly).
                slab = 2048
                for s in range(0, len(idx), slab):
                    argv = [str(m), str(k)]
                    for row in idx[s:s + slab]:
                        argv += [str(o) for o in row]
                    res = self._eval(script, [key, _bloom_cfg_key(key)], argv)
                    out += [int(v) for v in res]
                break
            except RespError as e:
                # Config drifted mid-batch (concurrent delete + re-init):
                # re-read config and retry, like the reference's guard loop
                # (RedissonBloomFilter.java:80-114). Earlier slabs'
                # SETBIT effects against the OLD filter are gone with it.
                if "BLOOMCFG" not in str(e) or attempt == 2:
                    raise
        op.future.set_result(np.array(out, np.uint8).astype(bool))

    def _op_bloom_add(self, key: str, op: Op) -> None:
        self._bloom_rw(key, op, _BLOOM_ADD_LUA)

    def _op_bloom_contains(self, key: str, op: Op) -> None:
        self._bloom_rw(key, op, _BLOOM_CONTAINS_LUA)

    def _op_bloom_contains_count(self, key: str, op: Op) -> None:
        inner = Op(target=key, kind="bloom_contains", payload=op.payload)
        self._op_bloom_contains(key, inner)
        op.future.set_result(int(inner.future.result().sum()))

    def _op_bloom_count(self, key: str, op: Op) -> None:
        m, k, _ = self._bloom_cfg(key)
        bc = self._x("BITCOUNT", key)
        op.future.set_result(
            int(round(bloom_math.count_estimate(int(bc), m, k))))

    def _op_bloom_meta(self, key: str, op: Op) -> None:
        # meta is layout-independent introspection (is_blocked() reads it),
        # so the blocked guard does not apply here.
        m, k, cfg = self._bloom_cfg(key, allow_blocked=True)
        op.future.set_result({
            "size": m,
            "hash_iterations": k,
            "expected_insertions": int(cfg.get("expectedInsertions", 0)),
            "false_probability": float(cfg.get("falseProbability", 0.0)),
            "blocked": cfg.get("blocked") in ("1", "true", "True"),
        })
