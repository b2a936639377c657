"""Differential test of the structures tier: seeded random op sequences over
every structure kind run through the JAX client (`RedissonTPU`, local mode)
and the port's client (`RedissonTorch`, device="cpu").

Every return value must be equal, and so must the final structure state of
both engines, compared after decoding `dump_state()` into plain containers.
Tolerances and the two places where equality is not asked for:
- wall clock: expiry timestamps in the state (epoch ms) may differ by
  `CLOCK_TOL_MS`, and PTTL replies likewise; TTLs are 1000 s, so no expiry
  falls inside a run;
- entropy: SRANDMEMBER and SPOP draw from each engine's own random source, so
  their replies are compared by count and by membership in the set before
  the op. After an SPOP the JAX set is brought back to the port's with a
  plain SADD / SREM (it then holds exactly the port's members);
- lock owners hold each client's own uuid, which is replaced by a marker
  before the states are compared.
"""

import pickle
from collections import deque

import numpy as np
import pytest

from redisson_tpu.client import RedissonTPU
from redisson_tpu.config import Config as JaxConfig
from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.config import Config

SEEDS = [0, 1, 2, 3]
OPS_PER_KIND = 120
CLOCK_TOL_MS = 5000
TTL_S = 1000.0

VALS = [0, 1, 2, 3, "a", "b", "c", "d", 2.5, [1, "x"], {"k": 1}]
MEMBERS = ["a", "b", "c", "d", "e", "f", 1, 2, 3]
LEX = ["a", "aa", "ab", "b", "ba", "c", "d", "dd"]
NAMES = ["p0", "p1", "p2"]


def _pick(rng, seq):
    return seq[int(rng.integers(len(seq)))]


def _v(rng):
    return _pick(rng, VALS)


def _m(rng):
    return _pick(rng, MEMBERS)


def _i(rng, lo=-3, hi=6):
    return int(rng.integers(lo, hi))


def _score(rng):
    return float(rng.integers(-4, 5)) / 2


def _mems(rng, k=3):
    return [_m(rng) for _ in range(int(rng.integers(1, k + 1)))]


def _lonlat(rng):
    return float(rng.uniform(-10, 10)), float(rng.uniform(-10, 10))


# kind -> (client getter, [(method, args(rng) -> tuple), ...]). A method
# named "spop" / "srand" is compared by membership (module docstring).
KINDS = {
    "bucket": ("get_bucket", [
        ("get", lambda r: ()),
        ("set", lambda r: (_v(r),)),
        ("get_and_set", lambda r: (_pick(r, VALS + [None]),)),
        ("try_set", lambda r: (_v(r),)),
        ("compare_and_set", lambda r: (_pick(r, VALS + [None]), _pick(r, VALS + [None]))),
        ("size", lambda r: ()),
        ("is_exists", lambda r: ()),
        ("delete", lambda r: ()),
    ]),
    "atomic_long": ("get_atomic_long", [
        ("get", lambda r: ()),
        ("set", lambda r: (_i(r),)),
        ("increment_and_get", lambda r: ()),
        ("decrement_and_get", lambda r: ()),
        ("add_and_get", lambda r: (_i(r),)),
        ("get_and_add", lambda r: (_i(r),)),
        ("get_and_set", lambda r: (_i(r),)),
        ("compare_and_set", lambda r: (_i(r), _i(r))),
    ]),
    "atomic_double": ("get_atomic_double", [
        ("get", lambda r: ()),
        ("set", lambda r: (_score(r),)),
        ("add_and_get", lambda r: (_score(r),)),
        ("get_and_increment", lambda r: ()),
        ("get_and_set", lambda r: (_score(r),)),
        ("compare_and_set", lambda r: (_score(r), _score(r))),
    ]),
    "map": ("get_map", [
        ("put", lambda r: (_m(r), _v(r))),
        ("fast_put", lambda r: (_m(r), _v(r))),
        ("put_if_absent", lambda r: (_m(r), _v(r))),
        ("put_all", lambda r: ({_m(r): _v(r) for _ in range(3)},)),
        ("get", lambda r: (_m(r),)),
        ("get_all", lambda r: (_mems(r),)),
        ("read_all_map", lambda r: ()),
        ("remove", lambda r: (_m(r),)),
        ("remove", lambda r: (_m(r), _v(r))),
        ("fast_remove", lambda r: tuple(_mems(r))),
        ("replace", lambda r: (_m(r), _v(r))),
        ("replace", lambda r: (_m(r), _v(r), _v(r))),
        ("contains_key", lambda r: (_m(r),)),
        ("contains_value", lambda r: (_v(r),)),
        ("size", lambda r: ()),
        ("key_set", lambda r: ()),
        ("values", lambda r: ()),
        ("fast_put_if_absent", lambda r: (_m(r), _v(r))),
        ("add_and_get", lambda r: (_pick(r, ["n1", "n2"]), _i(r))),
    ]),
    "map_cache": ("get_map_cache", [
        ("put", lambda r: (_m(r), _v(r), TTL_S)),
        ("put", lambda r: (_m(r), _v(r))),
        ("put_if_absent", lambda r: (_m(r), _v(r), TTL_S)),
        ("fast_put", lambda r: (_m(r), _v(r), None, TTL_S)),
        ("get", lambda r: (_m(r),)),
        ("remove", lambda r: (_m(r),)),
        ("contains_key", lambda r: (_m(r),)),
        ("size", lambda r: ()),
        ("read_all_map", lambda r: ()),
        ("evict_expired", lambda r: ()),
    ]),
    "set": ("get_set", [
        ("add", lambda r: (_m(r),)),
        ("add_all", lambda r: (_mems(r),)),
        ("remove", lambda r: (_m(r),)),
        ("remove_all", lambda r: (_mems(r),)),
        ("retain_all", lambda r: (_mems(r, 6),)),
        ("contains", lambda r: (_m(r),)),
        ("contains_all", lambda r: (_mems(r),)),
        ("read_all", lambda r: ()),
        ("size", lambda r: ()),
        ("srand", lambda r: (int(r.integers(1, 4)),)),
        ("spop", lambda r: (int(r.integers(1, 3)),)),
        ("move", lambda r: (_pick(r, NAMES), _m(r))),
        ("read_union", lambda r: (_pick(r, NAMES),)),
        ("read_intersection", lambda r: (_pick(r, NAMES),)),
        ("read_diff", lambda r: (_pick(r, NAMES),)),
        ("union", lambda r: (_pick(r, NAMES),)),
        ("intersection", lambda r: (_pick(r, NAMES),)),
        ("diff", lambda r: (_pick(r, NAMES),)),
    ]),
    "set_cache": ("get_set_cache", [
        ("add", lambda r: (_m(r), TTL_S)),
        ("add", lambda r: (_m(r),)),
        ("contains", lambda r: (_m(r),)),
        ("remove", lambda r: (_m(r),)),
        ("size", lambda r: ()),
        ("read_all", lambda r: ()),
    ]),
    "list": ("get_list", [
        ("add", lambda r: (_v(r),)),
        ("add_all", lambda r: ([_v(r) for _ in range(3)],)),
        ("insert", lambda r: (_i(r, 0, 4), _v(r))),
        ("get", lambda r: (_i(r),)),
        ("set", lambda r: (_i(r), _v(r))),
        ("remove", lambda r: (_v(r),)),
        ("remove_at", lambda r: (_i(r),)),
        ("index_of", lambda r: (_v(r),)),
        ("last_index_of", lambda r: (_v(r),)),
        ("contains", lambda r: (_v(r),)),
        ("size", lambda r: ()),
        ("read_all", lambda r: ()),
        ("range", lambda r: (_i(r), _i(r))),
        ("trim", lambda r: (0, _i(r, 3, 9))),
        ("add_after", lambda r: (_v(r), _v(r))),
        ("add_before", lambda r: (_v(r), _v(r))),
        ("sub_list", lambda r: (_i(r, 0, 2), _i(r, 2, 5))),
        ("remove_all", lambda r: ([_v(r), _v(r)],)),
        ("retain_all", lambda r: ([_v(r) for _ in range(6)],)),
        ("add_all_at", lambda r: (_i(r, 0, 3), [_v(r), _v(r)])),
        ("fast_remove", lambda r: (_i(r, 0, 3),)),
    ]),
    "deque": ("get_deque", [
        ("offer", lambda r: (_v(r),)),
        ("poll", lambda r: ()),
        ("peek", lambda r: ()),
        ("poll_last_and_offer_first_to", lambda r: (_pick(r, NAMES),)),
        ("add_first", lambda r: (_v(r),)),
        ("add_last", lambda r: (_v(r),)),
        ("poll_first", lambda r: ()),
        ("poll_last", lambda r: ()),
        ("peek_last", lambda r: ()),
        ("push", lambda r: (_v(r),)),
        ("pop", lambda r: ()),
        ("remove_first", lambda r: ()),
        ("remove_last", lambda r: ()),
        ("remove_first_occurrence", lambda r: (_v(r),)),
        ("remove_last_occurrence", lambda r: (_v(r),)),
        ("read_all", lambda r: ()),
    ]),
    "blocking_queue": ("get_blocking_queue", [
        ("put", lambda r: (_v(r),)),
        ("offer", lambda r: (_v(r),)),
        ("poll", lambda r: (0.001,)),
        ("take_if_any", lambda r: ()),
        ("drain_to", lambda r: ([], int(r.integers(1, 3)))),
        ("read_all", lambda r: ()),
    ]),
    "zset": ("get_scored_sorted_set", [
        ("add", lambda r: (_score(r), _m(r))),
        ("add_all", lambda r: ([(_score(r), _m(r)) for _ in range(3)],)),
        ("try_add", lambda r: (_score(r), _m(r))),
        ("add_score", lambda r: (_m(r), _score(r))),
        ("remove", lambda r: (_m(r),)),
        ("remove_all", lambda r: (_mems(r),)),
        ("poll_first", lambda r: ()),
        ("poll_last", lambda r: ()),
        ("remove_range_by_score", lambda r: (_score(r), True, _score(r), False)),
        ("remove_range_by_rank", lambda r: (_i(r, 0, 2), _i(r, 0, 3))),
        ("get_score", lambda r: (_m(r),)),
        ("contains", lambda r: (_m(r),)),
        ("rank", lambda r: (_m(r),)),
        ("rev_rank", lambda r: (_m(r),)),
        ("size", lambda r: ()),
        ("count", lambda r: (_score(r), True, _score(r), True)),
        ("value_range", lambda r: (_i(r), _i(r))),
        ("entry_range", lambda r: (_i(r), _i(r), bool(r.integers(2)))),
        ("value_range_by_score", lambda r: (_score(r), True, _score(r), True)),
        ("read_all", lambda r: ()),
        ("first", lambda r: ()),
        ("last", lambda r: ()),
        ("retain_all", lambda r: (_mems(r, 6),)),
        ("union", lambda r: (_pick(r, NAMES),)),
        ("intersection", lambda r: (_pick(r, NAMES),)),
    ]),
    "lex_sorted_set": ("get_lex_sorted_set", [
        ("add", lambda r: (_pick(r, LEX),)),
        ("add_all", lambda r: ([_pick(r, LEX) for _ in range(3)],)),
        ("remove", lambda r: (_pick(r, LEX),)),
        ("contains", lambda r: (_pick(r, LEX),)),
        ("size", lambda r: ()),
        ("lex_range", lambda r: (_pick(r, LEX), True, _pick(r, LEX), bool(r.integers(2)))),
        ("lex_range_head", lambda r: (_pick(r, LEX),)),
        ("lex_range_tail", lambda r: (_pick(r, LEX), False)),
        ("lex_count", lambda r: (_pick(r, LEX), True, _pick(r, LEX), True)),
        ("rank", lambda r: (_pick(r, LEX),)),
        ("poll_first", lambda r: ()),
        ("poll_last", lambda r: ()),
        ("remove_range_tail", lambda r: (_pick(r, LEX),)),
        ("read_all", lambda r: ()),
    ]),
    "sorted_set": ("get_sorted_set", [
        ("add", lambda r: (_pick(r, LEX),)),
        ("remove", lambda r: (_pick(r, LEX),)),
        ("contains", lambda r: (_pick(r, LEX),)),
        ("size", lambda r: ()),
        ("first", lambda r: ()),
        ("last", lambda r: ()),
        ("read_all", lambda r: ()),
    ]),
    "set_multimap": ("get_set_multimap", [
        ("put", lambda r: (_m(r), _v(r))),
        ("put_all", lambda r: (_m(r), [_v(r), _v(r)])),
        ("get_all", lambda r: (_m(r),)),
        ("remove", lambda r: (_m(r), _v(r))),
        ("remove_all", lambda r: (_m(r),)),
        ("key_set", lambda r: ()),
        ("key_size", lambda r: ()),
        ("size", lambda r: ()),
        ("contains_key", lambda r: (_m(r),)),
        ("contains_value", lambda r: (_v(r),)),
        ("contains_entry", lambda r: (_m(r), _v(r))),
        ("entries", lambda r: ()),
        ("fast_remove", lambda r: (_m(r), _m(r))),
        ("replace_values", lambda r: (_m(r), [_v(r)])),
    ]),
    "list_multimap": ("get_list_multimap", [
        ("put", lambda r: (_m(r), _v(r))),
        ("put_all", lambda r: (_m(r), [_v(r), _v(r)])),
        ("get_all", lambda r: (_m(r),)),
        ("remove", lambda r: (_m(r), _v(r))),
        ("remove_all", lambda r: (_m(r),)),
        ("key_size", lambda r: ()),
        ("size", lambda r: ()),
        ("contains_entry", lambda r: (_m(r), _v(r))),
        ("entries", lambda r: ()),
        ("replace_values", lambda r: (_m(r), [_v(r), _v(r)])),
    ]),
    "set_multimap_cache": ("get_set_multimap_cache", [
        ("put", lambda r: (_m(r), _v(r))),
        ("get_all", lambda r: (_m(r),)),
        ("remove", lambda r: (_m(r), _v(r))),
        ("expire_key", lambda r: (_m(r), TTL_S)),
        ("size", lambda r: ()),
        ("key_set", lambda r: ()),
    ]),
    "geo": ("get_geo", [
        ("add", lambda r: (*_lonlat(r), _m(r))),
        ("pos", lambda r: tuple(_mems(r))),
        ("hash", lambda r: tuple(_mems(r))),
        ("dist", lambda r: (_m(r), _m(r), _pick(r, ["m", "km", "mi"]))),
        ("radius", lambda r: (*_lonlat(r), float(r.integers(100, 1500)), "km")),
        ("radius_with_distance", lambda r: (*_lonlat(r), float(r.integers(100, 1500)), "km")),
        ("radius_by_member", lambda r: (_m(r), float(r.integers(100, 1500)), "km")),
    ]),
    "semaphore": ("get_semaphore", [
        ("try_set_permits", lambda r: (_i(r, 0, 5),)),
        ("try_acquire", lambda r: (_i(r, 1, 3),)),
        ("release", lambda r: (_i(r, 1, 3),)),
        ("available_permits", lambda r: ()),
        ("drain_permits", lambda r: ()),
        ("add_permits", lambda r: (_i(r, 1, 3),)),
        ("reduce_permits", lambda r: (_i(r, 1, 3),)),
    ]),
    "latch": ("get_count_down_latch", [
        ("try_set_count", lambda r: (_i(r, 1, 4),)),
        ("count_down", lambda r: ()),
        ("get_count", lambda r: ()),
    ]),
    "lock": ("get_lock", [
        ("try_lock", lambda r: (0,)),
        ("unlock", lambda r: ()),
        ("is_locked", lambda r: ()),
        ("is_held_by_current_thread", lambda r: ()),
        ("get_hold_count", lambda r: ()),
        ("force_unlock", lambda r: ()),
    ]),
    # RExpirable / keyspace surface across the names of one kind
    "keyspace": ("get_map", [
        ("fast_put", lambda r: (_m(r), _v(r))),
        ("expire", lambda r: (TTL_S,)),
        ("pttl", lambda r: ()),
        ("clear_expire", lambda r: ()),
        ("is_exists", lambda r: ()),
        ("renamenx", lambda r: (_pick(r, NAMES),)),
        ("delete", lambda r: ()),
    ]),
}


def _outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except Exception as exc:  # noqa: BLE001 — both clients must raise alike
        return "raise", type(exc).__name__


def _same(a, b, path="") -> None:
    """Structural equality with the module's clock tolerance for epoch-ms
    integers."""
    if isinstance(a, (deque, tuple)):
        a = list(a)
    if isinstance(b, (deque, tuple)):
        b = list(b)
    if isinstance(a, bool) or isinstance(b, bool):
        assert a == b, (path, a, b)
    elif isinstance(a, int) and isinstance(b, int) and min(a, b) > 10**12:
        assert abs(a - b) <= CLOCK_TOL_MS, (path, a, b)
    elif isinstance(a, dict) and isinstance(b, dict):
        assert list(a) == list(b), (path, a, b)
        for k in a:
            _same(a[k], b[k], f"{path}/{k!r}")
    elif isinstance(a, list) and isinstance(b, list):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _plain(obj, client_id: str):
    """dump_state() content as plain containers (KV -> dict); the client's
    uuid inside lock owners becomes a marker."""
    if hasattr(obj, "otype") and hasattr(obj, "expire_at"):
        return {"otype": obj.otype, "value": _plain(obj.value, client_id),
                "expire_at": obj.expire_at,
                "mm_expiry": _plain(obj.mm_expiry, client_id)}
    if isinstance(obj, dict):
        return {_plain(k, client_id): _plain(v, client_id) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, deque)):
        return [_plain(v, client_id) for v in obj]
    if isinstance(obj, set):
        return sorted(obj, key=repr)
    if isinstance(obj, str):
        return obj.replace(client_id, "<client>")
    return obj


def _state(client):
    blob = client._executor.execute_barrier(
        client._routing.structures.dump_state).result()
    payload = pickle.loads(blob)
    assert payload["format"] == 1
    return {k: _plain(v, client.id) for k, v in sorted(payload["data"].items())}


@pytest.fixture(scope="module")
def clients():
    jc = RedissonTPU.create(JaxConfig())
    tc = RedissonTorch.create(Config().use_cuda(device="cpu"))
    yield jc, tc
    tc.shutdown()
    jc.shutdown()


def _call(client, kind: str, getter: str, name: str, method: str, args):
    obj = getattr(client, getter)(name)
    if method == "pttl":
        return _outcome(obj.remain_time_to_live)
    if method == "take_if_any":
        return _outcome(lambda: obj.poll(0.001))
    if method == "srand":
        return _outcome(obj.random, *args)
    if method == "spop":
        return _outcome(obj.remove_random, *args)
    return _outcome(getattr(obj, method), *args)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_random_ops_agree(clients, kind, seed):
    jc, tc = clients
    jc.flushall()
    tc.flushall()
    getter, ops = KINDS[kind]
    rng = np.random.default_rng([seed, sorted(KINDS).index(kind)])
    for step in range(OPS_PER_KIND):
        method, argf = ops[int(rng.integers(len(ops)))]
        name = _pick(rng, NAMES)
        args = argf(rng)
        before = None
        if method in ("srand", "spop"):
            before = set(jc.get_set(name).read_all())
            assert before == set(tc.get_set(name).read_all())
        jr = _call(jc, kind, getter, name, method, args)
        tr = _call(tc, kind, getter, name, method, args)
        where = (kind, seed, step, name, method, args)
        if before is not None:
            assert jr[0] == tr[0] == "ok", (where, jr, tr)
            jset, tset = set(jr[1]), set(tr[1])
            assert len(jset) == len(tset) and jset <= before and tset <= before, (
                where, jr, tr)
            if method == "spop" and jset != tset:
                # bring the JAX set to the port's members (docstring)
                js = jc.get_set(name)
                js.add_all(list(jset))
                js.remove_all(list(tset))
            continue
        assert jr[0] == tr[0], (where, jr, tr)
        if method == "pttl" and jr[0] == "ok" and jr[1] >= 0:
            assert abs(jr[1] - tr[1]) <= CLOCK_TOL_MS, (where, jr, tr)
            continue
        _same(jr[1], tr[1], repr(where))
    _same(_state(jc), _state(tc), kind)


# ---------------------------------------------------------------------------
# The mc_evict_expired sweep against a key of another kind. The eviction
# scheduler keeps a timer per cache name across FLUSHALL, so a sweep
# scheduled by the "mapcache" kind above can land on the semaphore of the
# same name later in this module: the JAX engine then drops a semaphore
# drained to 0 permits (its `_drop_if_empty` sees a falsy value), which made
# `test_random_ops_agree[semaphore-3]` disagree once at step 80
# (`try_set_permits` on p1: False in one client, True in the other). The
# port sweeps caches only; the JAX behaviour is pinned below and recorded in
# ROADMAP Queue 3.
# ---------------------------------------------------------------------------


def _semaphore_survives_sweep(client) -> bool:
    """Drain a semaphore under a cache's name, run the cache sweep on that
    name, and say whether the semaphore survived."""
    client.get_map_cache("swept").put("a", 1, 1000)
    client.flushall()
    sem = client.get_semaphore("swept")
    assert sem.try_set_permits(0) is True
    client._executor.execute_sync("swept", "mc_evict_expired", {"limit": 300})
    return sem.try_set_permits(3) is False  # still set: it survived


def test_cache_sweep_leaves_a_drained_semaphore_alone(clients):
    _, tc = clients
    assert _semaphore_survives_sweep(tc) is True


def test_jax_cache_sweep_drops_a_drained_semaphore(clients):
    """Pins the JAX engine's behaviour (ROADMAP Queue 3): its sweep deletes
    the semaphore. If this starts failing, the JAX package was repaired and
    the Queue 3 record can go."""
    jc, _ = clients
    assert _semaphore_survives_sweep(jc) is False
