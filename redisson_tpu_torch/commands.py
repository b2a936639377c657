"""The command table — the framework's explicit op vocabulary (a copy of
`redisson_tpu.commands`, descriptor for descriptor: the tier names are the
JAX package's, so `tpu` is the device sketch tier, served here by
`backend_torch.py`).

The reference declares its vocabulary as ~170 static descriptors
(`client/protocol/RedisCommands.java:60-266`: name, arity, convertor,
decoder). This framework's executor routes by op *kind* strings; this
module is the equivalent static table: every kind the backends implement,
annotated with its closest RESP command, whether it mutates state, and
which execution tiers implement it. A completeness test
(tests/test_torch_commands.py here, tests/test_commands_table.py for the
JAX package) introspects the backends against this table in both
directions, so the vocabulary cannot drift implicit again.

Tiers:
  engine — in-process structure interpreter (structures/engine.py + extended)
  tpu    — device sketch backend (backend_torch.py here; backend_tpu.py in
           the JAX package)
  redis  — RESP passthrough (interop/backend_redis.py)
  coord  — redis-mode coordination objects run OUTSIDE the executor as
           server-side Lua (interop/coordination_redis.py), the reference's
           own mechanism — listed so the redis column reads complete.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import FrozenSet


@dataclass(frozen=True)
class OpDescriptor:
    kind: str
    redis_name: str          # closest RESP command; "LUA" = EVAL script;
                             # "-" = no wire analogue (engine/device only)
    write: bool              # mutates keyspace/sketch state
    tiers: FrozenSet[str] = field(default_factory=frozenset)
    #: Machine-readable contract annotation (read by the JAX package's lint).
    #: A tpu-tier kind with a RESP analogue is expected to be served by the
    #: wire front-end (wire/commands.py); a kind deliberately absent from
    #: that table declares its escape here:
    #:   "engine-only(<why>)" — facade-reachable, not wire-served
    #:   "internal(<why>)"    — no client surface at all (replication,
    #:                          checkpoint, migration transport)
    #: Kinds with redis_name "-" are implicitly internal. An empty reason
    #: does not count as an escape — the lint flags it.
    contract: str = ""


def _d(kind, redis_name, write, tiers, contract=""):
    return OpDescriptor(kind, redis_name, write, frozenset(tiers.split()),
                        contract)


_ALL = "engine redis"
_ALL_C = "engine coord"  # redis tier via coordination Lua, not executor

OP_TABLE = {d.kind: d for d in [
    # -- strings / buckets (RBucket, RBuckets; RedisCommands.java strings) --
    _d("get", "GET", False, _ALL),
    _d("set", "SET", True, _ALL),
    _d("getset", "GETSET", True, _ALL),
    _d("setnx", "SETNX", True, _ALL),
    _d("compare_and_set", "LUA", True, _ALL),
    _d("mget", "MGET", False, _ALL),
    _d("mset", "MSET", True, _ALL),
    _d("msetnx", "MSETNX", True, _ALL),
    _d("strlen", "STRLEN", False, _ALL),
    _d("incr", "INCRBY", True, _ALL),
    # -- atomics (RAtomicLong/RAtomicDouble) --------------------------------
    _d("num_get", "GET", False, _ALL),
    _d("num_cas", "LUA", True, _ALL),
    _d("num_getandset", "GETSET", True, _ALL),
    # -- keyspace admin / expiry (RKeys, RExpirable) ------------------------
    _d("delete", "DEL", True, _ALL + " tpu"),
    _d("exists", "EXISTS", False, _ALL + " tpu"),
    _d("flushall", "FLUSHALL", True, _ALL + " tpu"),
    _d("keys", "KEYS", False, _ALL + " tpu"),
    _d("type", "TYPE", False, _ALL),
    _d("rename", "RENAME", True, _ALL + " tpu",
       "engine-only(wire RENAME needs the cross-slot move semantics the "
       "cluster router does not expose yet)"),
    _d("persist", "PERSIST", True, _ALL),
    _d("pexpire", "PEXPIRE", True, _ALL),
    _d("pexpireat", "PEXPIREAT", True, _ALL),
    _d("pttl", "PTTL", False, _ALL),
    # -- hash (RMap) --------------------------------------------------------
    _d("hput", "HSET", True, _ALL),
    _d("hput_if_absent", "HSETNX", True, _ALL),
    _d("hputall", "HSET", True, _ALL),
    _d("hget", "HGET", False, _ALL),
    _d("hmget", "HMGET", False, _ALL),
    _d("hgetall", "HGETALL", False, _ALL),
    _d("hdel", "HDEL", True, _ALL),
    _d("hremove", "HDEL", True, _ALL),
    _d("hremove_if", "LUA", True, _ALL),
    _d("hreplace", "LUA", True, _ALL),
    _d("hreplace_if", "LUA", True, _ALL),
    _d("hlen", "HLEN", False, _ALL),
    _d("hkeys", "HKEYS", False, _ALL),
    _d("hvals", "HVALS", False, _ALL),
    _d("hcontains_key", "HEXISTS", False, _ALL),
    _d("hcontains_value", "HVALS", False, _ALL),
    _d("hincr", "HINCRBY", True, _ALL),
    _d("hscan", "HSCAN", False, _ALL),
    # -- set (RSet) ---------------------------------------------------------
    _d("sadd", "SADD", True, _ALL),
    _d("srem", "SREM", True, _ALL),
    _d("sismember", "SISMEMBER", False, _ALL),
    _d("smembers", "SMEMBERS", False, _ALL),
    _d("scard", "SCARD", False, _ALL),
    _d("spop", "SPOP", True, _ALL),
    _d("srandmember", "SRANDMEMBER", False, _ALL),
    _d("smove", "SMOVE", True, _ALL),
    _d("sinter", "SINTER", False, _ALL),
    _d("sunion", "SUNION", False, _ALL),
    _d("sdiff", "SDIFF", False, _ALL),
    _d("sstore", "SINTERSTORE", True, _ALL),
    _d("sretain", "LUA", True, _ALL),
    _d("sscan", "SSCAN", False, _ALL),
    # -- list / queue / deque (RList, RQueue, RDeque) -----------------------
    _d("rpush", "RPUSH", True, _ALL),
    _d("lpush", "LPUSH", True, _ALL),
    _d("lrange", "LRANGE", False, _ALL),
    _d("llen", "LLEN", False, _ALL),
    _d("lindex", "LINDEX", False, _ALL),
    _d("lindexof", "LPOS", False, _ALL),
    _d("lset", "LSET", True, _ALL),
    _d("lrem", "LREM", True, _ALL),
    _d("lrem_index", "LUA", True, _ALL),
    _d("linsert", "LINSERT", True, _ALL),
    _d("linsert_at", "LUA", True, _ALL),
    _d("lsplice", "LUA", True, _ALL),
    _d("lretain", "LUA", True, _ALL),
    _d("ltrim", "LTRIM", True, _ALL),
    _d("lpop", "LPOP", True, _ALL),
    _d("rpop", "RPOP", True, _ALL),
    _d("rpoplpush", "RPOPLPUSH", True, _ALL),
    _d("bpop", "BLPOP", True, _ALL),
    _d("bpop_cancel", "-", False, _ALL),
    # -- zset (RScoredSortedSet, RLexSortedSet) -----------------------------
    _d("zadd", "ZADD", True, _ALL),
    _d("zscore", "ZSCORE", False, _ALL),
    _d("zmscore", "ZMSCORE", False, _ALL),
    _d("zincrby", "ZINCRBY", True, _ALL),
    _d("zrem", "ZREM", True, _ALL),
    _d("zcard", "ZCARD", False, _ALL),
    _d("zcount", "ZCOUNT", False, _ALL),
    _d("zrank", "ZRANK", False, _ALL),
    _d("zrange", "ZRANGE", False, _ALL),
    _d("zrangebyscore", "ZRANGEBYSCORE", False, _ALL),
    _d("zrangebylex", "ZRANGEBYLEX", False, _ALL),
    _d("zremrangebyrank", "ZREMRANGEBYRANK", True, _ALL),
    _d("zremrangebyscore", "ZREMRANGEBYSCORE", True, _ALL),
    _d("zremrangebylex", "ZREMRANGEBYLEX", True, _ALL),
    _d("zpop", "ZPOPMIN", True, _ALL),
    _d("zstore", "ZUNIONSTORE", True, _ALL),
    _d("zscan", "ZSCAN", False, _ALL),
    # -- map cache (RMapCache; reference Lua family RedissonMapCache) -------
    _d("mc_put", "LUA", True, _ALL_C),
    _d("mc_get", "LUA", False, _ALL_C),
    _d("mc_remove", "LUA", True, _ALL_C),
    _d("mc_contains", "LUA", False, _ALL_C),
    _d("mc_size", "LUA", False, _ALL_C),
    _d("mc_getall", "LUA", False, _ALL_C),
    _d("mc_evict_expired", "LUA", True, _ALL_C),
    # -- set cache (RSetCache: zset scored by expiry) -----------------------
    _d("sc_add", "ZADD", True, _ALL),
    _d("sc_contains", "ZSCORE", False, _ALL),
    _d("sc_remove", "ZREM", True, _ALL),
    _d("sc_size", "ZCOUNT", False, _ALL),
    _d("sc_members", "ZRANGEBYSCORE", False, _ALL),
    # -- multimaps (RSetMultimap/RListMultimap: index set + subkeys) --------
    _d("mm_put", "SADD", True, _ALL),
    _d("mm_get_all", "SMEMBERS", False, _ALL),
    _d("mm_remove", "SREM", True, _ALL),
    _d("mm_remove_all", "DEL", True, _ALL),
    _d("mm_keys", "SMEMBERS", False, _ALL),
    _d("mm_size", "SCARD", False, _ALL),
    _d("mm_key_size", "SCARD", False, _ALL),
    _d("mm_contains_key", "SISMEMBER", False, _ALL),
    _d("mm_contains_value", "SISMEMBER", False, _ALL),
    _d("mm_contains_entry", "SISMEMBER", False, _ALL),
    _d("mm_entries", "SMEMBERS", False, _ALL),
    _d("mm_expire_key", "LUA", True, _ALL),
    _d("mm_delete", "LUA", True, _ALL),
    # -- geo (RGeo) ---------------------------------------------------------
    _d("geoadd", "GEOADD", True, _ALL),
    _d("geopos", "GEOPOS", False, _ALL),
    _d("geodist", "GEODIST", False, _ALL),
    _d("georadius", "GEORADIUS", False, _ALL),
    # -- locks / semaphores / latches (engine ops; redis tier = Lua objects,
    # interop/coordination_redis.py — the reference's own mechanism) --------
    _d("lock_try", "LUA", True, "engine coord"),
    _d("lock_unlock", "LUA", True, "engine coord"),
    _d("lock_renew", "LUA", True, "engine coord"),
    _d("lock_force_unlock", "LUA", True, "engine coord"),
    _d("lock_state", "LUA", False, "engine coord"),
    _d("lock_queue_remove", "LUA", True, "engine coord"),
    _d("sem_try_set_permits", "SETNX", True, "engine coord"),
    _d("sem_try_acquire", "LUA", True, "engine coord"),
    _d("sem_release", "LUA", True, "engine coord"),
    _d("sem_available", "GET", False, "engine coord"),
    _d("sem_drain", "GETSET", True, "engine coord"),
    _d("sem_set_permits", "SET", True, "engine coord"),
    _d("sem_add_permits", "INCRBY", True, "engine coord"),
    _d("latch_try_set", "SETNX", True, "engine coord"),
    _d("latch_count_down", "LUA", True, "engine coord"),
    _d("latch_get", "GET", False, "engine coord"),
    # -- pub/sub + scripting ------------------------------------------------
    _d("publish", "PUBLISH", True, "engine coord"),
    _d("script_eval", "EVAL", True, "engine coord"),
    _d("script_load", "SCRIPT LOAD", True, "engine coord"),
    _d("script_exists", "SCRIPT EXISTS", False, "engine coord"),
    _d("script_flush", "SCRIPT FLUSH", True, "engine coord"),
    # -- sketches (the device tier; redis names are the PF*/bit families the
    # reference passes through, RedisCommands.java:70-77,163-165) -----------
    _d("hll_add", "PFADD", True, "tpu redis"),
    _d("hll_count", "PFCOUNT", False, "tpu redis"),
    _d("hll_count_with", "PFCOUNT", False, "tpu redis"),
    _d("hll_merge_with", "PFMERGE", True, "tpu redis"),
    _d("hll_merge_count", "PFMERGE", True, "tpu redis",
       "engine-only(facade composite of PFMERGE+PFCOUNT in one dispatch; "
       "wire clients issue the two commands separately)"),
    _d("hll_export", "GET", False, "tpu redis",
       "engine-only(redis-interop register export; wire reads are served "
       "by PFCOUNT)"),
    _d("hll_import", "RESTORE", True, "tpu",
       "internal(checkpoint/replica-bootstrap restore transport)"),
    _d("bitset_set", "SETBIT", True, "tpu redis"),
    _d("bitset_clear", "SETBIT", True, "tpu redis"),
    _d("bitset_get", "GETBIT", False, "tpu redis"),
    _d("bitset_cardinality", "BITCOUNT", False, "tpu redis"),
    _d("bitset_length", "GETRANGE", False, "tpu redis",
       "engine-only(facade bit-length probe; the wire exposes byte sizing "
       "via the BITOP reply rider)"),
    _d("bitset_size", "STRLEN", False, "tpu redis"),
    _d("bitset_set_range", "SETBIT", True, "tpu redis",
       "engine-only(facade bulk range set; wire SETBIT is single-bit)"),
    _d("bitset_op", "BITOP", True, "tpu redis"),
    # Bloom kinds are facade-only: the reference's RBloomFilter is a
    # Lua/bitfield composite object, not a single RESP command — a wire
    # surface needs that object protocol, not a command mapping.
    _d("bloom_init", "LUA", True, "tpu redis",
       "engine-only(bloom wire surface needs the reference's Lua-object "
       "protocol)"),
    _d("bloom_add", "SETBIT", True, "tpu redis",
       "engine-only(bloom wire surface needs the reference's Lua-object "
       "protocol)"),
    _d("bloom_contains", "GETBIT", False, "tpu redis",
       "engine-only(bloom wire surface needs the reference's Lua-object "
       "protocol)"),
    _d("bloom_contains_count", "BITCOUNT", False, "tpu redis",
       "engine-only(bloom wire surface needs the reference's Lua-object "
       "protocol)"),
    _d("bloom_count", "BITCOUNT", False, "tpu redis",
       "engine-only(bloom wire surface needs the reference's Lua-object "
       "protocol)"),
    _d("bloom_meta", "HGETALL", False, "tpu redis",
       "engine-only(bloom wire surface needs the reference's Lua-object "
       "protocol)"),
    # Generic bitset/bloom state export/import (checkpoint + durability;
    # the sharded pod tier serves these from mesh-sharded arrays).
    _d("bits_export", "DUMP", False, "tpu",
       "internal(checkpoint + slot-migration transport)"),
    _d("bits_import", "RESTORE", True, "tpu",
       "internal(checkpoint + slot-migration transport)"),
    # Barrier flushing host-mirror bloom bits into device state before a
    # device-side read (durability/checkpoint); internal, no wire analogue.
    _d("bloom_sync", "-", True, "tpu"),
    # -- geo tier (geo/; active-active cross-site replication) --------------
    # Remote mutations arrive as these kinds, NOT as replayed origin ops:
    # journaling them locally (write=True) makes crash recovery replay the
    # remote state, and the SiteLink never re-ships geo_* records, which
    # breaks the full-mesh echo loop. geo_merge is group-coalesced with
    # the local delta kinds, so a window of remote planes plus local
    # writes retires in ONE fused delta_merge_stack launch.
    _d("geo_merge", "-", True, "tpu"),     # stamped semilattice delta plane
    _d("geo_replace", "-", True, "tpu"),   # stamped full-state overwrite (LWW)
    _d("geo_delete", "-", True, "tpu"),    # stamped tombstone delete (LWW)
    _d("geo_flush", "-", True, "tpu"),     # stamped keyspace flush (key list)
    # -- cluster tier (cluster/; ClusterConnectionManager.java semantics) ---
    # Slot-ownership transitions are journaled WRITES: the migrate_flip
    # record is the cutover point in the source shard's journal (everything
    # before it replays on the source, everything after re-routes), and
    # replaying adopt/begin/flip records at recovery rebuilds the guard's
    # slot table in exactly the order live traffic saw it.
    _d("migrate_begin", "CLUSTER SETSLOT IMPORTING", True, "cluster"),
    _d("migrate_flip", "CLUSTER SETSLOT NODE", True, "cluster"),
    _d("migrate_adopt", "CLUSTER ADDSLOTS", True, "cluster"),
    _d("migrate_install", "RESTORE", True, "cluster"),
    # Journaled migration rollback: clears the migrating mark so an
    # aborted migration leaves a retryable state (CLUSTER SETSLOT STABLE).
    _d("migrate_abort", "CLUSTER SETSLOT STABLE", True, "cluster"),
]}


def kinds_for_tier(tier: str) -> set:
    return {k for k, d in OP_TABLE.items() if tier in d.tiers}
