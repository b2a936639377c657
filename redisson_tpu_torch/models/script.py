"""RScript — the Lua-scripting analogue.

The reference wraps SCRIPT LOAD / EVAL / EVALSHA (`RedissonScript.java`):
user-supplied Lua runs atomically inside Redis' single-threaded command
loop. Here the "server" is the structure engine on the executor's
dispatcher thread, so a script is a Python function executed as ONE op —
atomic with respect to every other operation, exactly the guarantee Lua
gets. The function receives a ScriptContext (the keyspace API playing
redis.call's role), the key list, and the arg list:

    def transfer(ctx, keys, args):
        a = int(ctx.get(keys[0]) or 0)
        if a < int(args[0]):
            return False
        ctx.set(keys[0], str(a - int(args[0])))
        ctx.incr(keys[1], int(args[0]))
        return True

    sha = script.script_load(transfer)
    ok = script.evalsha(sha, keys=["acct:a", "acct:b"], args=[10])

Scripts must be pure host-side logic (no blocking, no device calls) — they
run on the dispatcher and stall every other op while executing, same as a
hot Lua script stalls Redis.
"""

from __future__ import annotations

import hashlib
import inspect
from typing import Any, Callable, List, Optional, Sequence


class ScriptContext:
    """Keyspace API handed to scripts (the redis.call surface). All methods
    operate on raw bytes values like the engine does; scripts apply their
    own encoding."""

    def __init__(self, backend):
        self._b = backend

    # strings
    def get(self, key: str) -> Optional[bytes]:
        kv = self._b._entry(key, "string")
        return None if kv is None else kv.value

    def set(self, key: str, value) -> None:
        if isinstance(value, str):
            value = value.encode()
        self._b._create(key, "string", lambda: None).value = value

    def incr(self, key: str, by: int = 1) -> int:
        kv = self._b._create(key, "string", lambda: None)
        v = (0 if kv.value is None else int(kv.value)) + by
        kv.value = str(v).encode()
        return v

    # hash
    def hget(self, key: str, field: bytes) -> Optional[bytes]:
        kv = self._b._entry(key, "hash")
        return None if kv is None else kv.value.get(field)

    def hset(self, key: str, field: bytes, value: bytes) -> None:
        self._b._create(key, "hash", dict).value[field] = value

    def hgetall(self, key: str) -> dict:
        kv = self._b._entry(key, "hash")
        return {} if kv is None else dict(kv.value)

    # generic
    def delete(self, key: str) -> bool:
        return self._b._drop(key)

    def exists(self, key: str) -> bool:
        return self._b._entry(key) is not None

    def keys(self, pattern: str = "*") -> List[str]:
        return self._b.keys(pattern)

    def type(self, key: str) -> Optional[str]:
        kv = self._b._entry(key)
        return None if kv is None else kv.otype

    def pexpire(self, key: str, ms: int) -> bool:
        from redisson_tpu_torch.structures.engine import now_ms

        kv = self._b._entry(key)
        if kv is None:
            return False
        kv.expire_at = now_ms() + int(ms)
        return True


def script_sha(fn: Callable) -> str:
    """Digest of the function's identity — the EVALSHA handle.

    Source text alone is not enough: two closures minted by the same def
    share source but capture different state, and colliding shas would let
    a later script_load silently rebind an older handle. Fold in closure
    cell values and defaults."""
    try:
        src = inspect.getsource(fn)
    except (OSError, TypeError):
        src = repr(fn)
    extras = []
    for cell in (getattr(fn, "__closure__", None) or ()):
        try:
            extras.append(repr(cell.cell_contents))
        except ValueError:  # unfilled cell
            extras.append("<empty>")
    extras.append(repr(getattr(fn, "__defaults__", None)))
    payload = src + "\x00" + "\x00".join(extras)
    return hashlib.sha1(payload.encode("utf-8", "replace")).hexdigest()


class RScript:
    """Script registry + executor facade (RedissonScript analogue)."""

    def __init__(self, executor):
        self._executor = executor

    def script_load(self, fn: Callable) -> str:
        """Register; returns the sha handle (SCRIPT LOAD)."""
        return self._executor.execute_sync("", "script_load", {"fn": fn})

    def script_exists(self, *shas: str) -> List[bool]:
        return self._executor.execute_sync("", "script_exists", {"shas": list(shas)})

    def script_flush(self) -> None:
        self._executor.execute_sync("", "script_flush", None)

    def eval(self, fn: Callable, keys: Sequence[str] = (),
             args: Sequence[Any] = ()) -> Any:
        """Run a function atomically (EVAL — registers implicitly)."""
        return self.eval_async(fn, keys, args).result()

    def eval_async(self, fn: Callable, keys: Sequence[str] = (),
                   args: Sequence[Any] = ()):
        return self._executor.execute_async(
            "", "script_eval", {"fn": fn, "keys": list(keys), "args": list(args)})

    def eval_sha(self, sha: str, keys: Sequence[str] = (), args: Sequence = ()):
        """Reference evalSha spelling."""
        return self.evalsha(sha, keys, args)

    def evalsha(self, sha: str, keys: Sequence[str] = (),
                args: Sequence[Any] = ()) -> Any:
        """Run a previously loaded script by handle (EVALSHA)."""
        return self.evalsha_async(sha, keys, args).result()

    def evalsha_async(self, sha: str, keys: Sequence[str] = (),
                      args: Sequence[Any] = ()):
        return self._executor.execute_async(
            "", "script_eval", {"sha": sha, "keys": list(keys), "args": list(args)})
