"""RPC over blocking queues — the RRemoteService analogue (counterpart of
`redisson_tpu.services.remote`).

Reference design (RedissonRemoteService.java:96-226 + remote/, SURVEY.md §2
L4/L5): the service side runs N workers blocking-taking RemoteServiceRequest
payloads from a request queue named `{service}:{interface}` (hashtag ⇒ one
slot), optionally acks within the ack timeout, invokes the method
reflectively, and pushes a RemoteServiceResponse onto a per-request response
queue. The client side is a dynamic proxy that enqueues the request and
blocking-polls its response queue. Modes (RemoteInvocationOptions): ack or
no-ack, result-aware or fire-and-forget.

Here the queues are our structure-tier blocking queues, the "reflective
invoke" is getattr, and the dynamic proxy is __getattr__; worker pools are
daemon threads. Async invocation (the @RRemoteAsync analogue) returns
concurrent futures from `get_async()`.
"""

from __future__ import annotations

import threading
import time
import traceback
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Optional


@dataclass
class RemoteInvocationOptions:
    """Invocation mode knobs (reference remote/RemoteInvocationOptions)."""

    ack_timeout_s: Optional[float] = 1.0      # None = no ack expected
    execution_timeout_s: Optional[float] = 30.0  # None = fire-and-forget

    @classmethod
    def defaults(cls) -> "RemoteInvocationOptions":
        return cls()

    def no_ack(self) -> "RemoteInvocationOptions":
        return RemoteInvocationOptions(None, self.execution_timeout_s)

    def no_result(self) -> "RemoteInvocationOptions":
        return RemoteInvocationOptions(self.ack_timeout_s, None)

    def with_timeouts(self, ack_s: Optional[float],
                      exec_s: Optional[float]) -> "RemoteInvocationOptions":
        return RemoteInvocationOptions(ack_s, exec_s)

    # -- reference accessor/builder surface ---------------------------------

    def expect_ack_within(self, ack_s: float) -> "RemoteInvocationOptions":
        return RemoteInvocationOptions(ack_s, self.execution_timeout_s)

    def expect_result_within(self, exec_s: float) -> "RemoteInvocationOptions":
        return RemoteInvocationOptions(self.ack_timeout_s, exec_s)

    def is_ack_expected(self) -> bool:
        return self.ack_timeout_s is not None

    def is_result_expected(self) -> bool:
        return self.execution_timeout_s is not None

    def get_ack_timeout_in_millis(self) -> Optional[int]:
        return (None if self.ack_timeout_s is None
                else int(self.ack_timeout_s * 1000))

    def get_execution_timeout_in_millis(self) -> Optional[int]:
        return (None if self.execution_timeout_s is None
                else int(self.execution_timeout_s * 1000))


class RemoteServiceTimeoutError(TimeoutError):
    """No response inside execution_timeout_s."""


class RemoteServiceAckTimeoutError(TimeoutError):
    """No worker acked inside ack_timeout_s (no service instance alive)."""


class RemoteServiceError(RuntimeError):
    """The remote method raised; message carries the remote traceback."""


def _req_queue_name(service: str, iface: str) -> str:
    # hashtag for slot colocation, mirroring `name:{iface}` in the reference
    return f"{service}:{{{iface}}}"


class _Invoker:
    """Client-side dynamic proxy: attribute access -> remote call."""

    def __init__(self, service: "RRemoteService", iface: str,
                 options: RemoteInvocationOptions, as_async: bool):
        self._service = service
        self._iface = iface
        self._options = options
        self._async = as_async

    def __getattr__(self, method: str):
        if method.startswith("_"):
            raise AttributeError(method)

        def call(*args, **kwargs):
            if self._async:
                return self._service._pool.submit(
                    self._service._invoke, self._iface, method, args, kwargs,
                    self._options)
            return self._service._invoke(self._iface, method, args, kwargs,
                                         self._options)

        call.__name__ = method
        return call


class RRemoteService:
    """Register service implementations and obtain client proxies.

    One instance wraps one RedissonTorch client; server and clients may live
    in different processes when the structure tier is shared (or the same
    process in tests — same as the reference's in-JVM usage).
    """

    def __init__(self, client, name: str = "remote_service"):
        self._client = client
        self._name = name
        self._workers: list = []
        self._stop = threading.Event()
        self._pool = ThreadPoolExecutor(max_workers=8,
                                        thread_name_prefix="rtorch-rs-client")

    # -- service side -------------------------------------------------------

    def register(self, iface: str, impl: Any, workers: int = 1) -> None:
        """Start `workers` daemon threads serving `iface` with `impl`
        (RedissonRemoteService.register analogue)."""
        qname = _req_queue_name(self._name, iface)
        for i in range(workers):
            t = threading.Thread(
                target=self._worker_loop, args=(qname, impl),
                name=f"rtorch-rs-{iface}-{i}", daemon=True)
            t.start()
            self._workers.append(t)

    def _worker_loop(self, qname: str, impl: Any) -> None:
        q = self._client.get_blocking_queue(qname)
        while not self._stop.is_set():
            try:
                req = q.poll(timeout_s=0.2)
                if req is None:
                    continue
                self._serve_one(req, impl)
            except RuntimeError:
                # Client executor shut down under us (possibly mid-serve,
                # e.g. while offering the response) — exit quietly instead
                # of raising into a daemon thread.
                return

    def _serve_one(self, req: dict, impl: Any) -> None:
        rid = req["id"]
        if req.get("ack"):
            # SETNX-style ack so exactly one worker claims the request and
            # the client learns a server is alive (reference Lua ack,
            # RedissonRemoteService.java:96-160). TTL'd so a vanished
            # client can't leak it forever.
            acked = self._client.get_bucket(
                f"{self._name}:ack:{rid}").try_set(1, ttl_s=60.0)
            if not acked:
                return
        try:
            method = getattr(impl, req["method"])
            result = method(*req.get("args", ()), **req.get("kwargs", {}))
            resp = {"id": rid, "result": result, "error": None}
        except Exception as e:  # noqa: BLE001 - errors cross the wire
            resp = {"id": rid, "result": None,
                    "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()}
        if req.get("want_result", True):
            rq = self._client.get_blocking_queue(f"{self._name}:resp:{rid}")
            rq.offer(resp)
            # TTL the response (reference RemoteInvocationOptions response
            # timeToLive): a client that already gave up never drains it,
            # so it must expire rather than leak.
            rq.expire(60.0)

    # -- client side --------------------------------------------------------

    def get(self, iface: str,
            options: Optional[RemoteInvocationOptions] = None) -> _Invoker:
        """Synchronous proxy for `iface`."""
        return _Invoker(self, iface, options or RemoteInvocationOptions(),
                        as_async=False)

    def get_async(self, iface: str,
                  options: Optional[RemoteInvocationOptions] = None) -> _Invoker:
        """Async proxy: every method returns a concurrent Future
        (the @RRemoteAsync mapping analogue)."""
        return _Invoker(self, iface, options or RemoteInvocationOptions(),
                        as_async=True)

    def _invoke(self, iface: str, method: str, args, kwargs,
                options: RemoteInvocationOptions) -> Any:
        rid = uuid.uuid4().hex
        want_ack = options.ack_timeout_s is not None
        want_result = options.execution_timeout_s is not None
        req = {"id": rid, "method": method, "args": list(args),
               "kwargs": kwargs, "ack": want_ack, "want_result": want_result}
        req_queue = self._client.get_blocking_queue(
            _req_queue_name(self._name, iface))
        req_queue.offer(req)

        if want_ack:
            ack_bucket = self._client.get_bucket(f"{self._name}:ack:{rid}")
            deadline = options.ack_timeout_s
            t0 = time.monotonic()
            while ack_bucket.get() is None:
                if time.monotonic() - t0 > deadline:
                    # Withdraw the request so a worker that appears later
                    # does not execute a call the caller saw fail (the
                    # reference's ack-timeout Lua removal). If a worker
                    # already dequeued it, win or lose the ack atomically:
                    # our tombstone try_set vs the worker's ack try_set —
                    # exactly one succeeds, so the worker either never
                    # executes (we won) or executes with a TTL'd response
                    # (it won; bounded leak, same as the reference).
                    req_queue.remove(req)
                    tombstoned = ack_bucket.try_set("cancelled", ttl_s=60.0)
                    if not tombstoned:
                        self._cleanup(rid, want_ack)
                    raise RemoteServiceAckTimeoutError(
                        f"no worker acked {iface}.{method} within {deadline}s")
                time.sleep(0.005)
        if not want_result:
            if want_ack:  # observed: the ack key is ours to clean up
                self._client.delete(f"{self._name}:ack:{rid}")
            return None
        resp = self._client.get_blocking_queue(
            f"{self._name}:resp:{rid}").poll(
                timeout_s=options.execution_timeout_s)
        self._cleanup(rid, want_ack)
        if resp is None:
            raise RemoteServiceTimeoutError(
                f"{iface}.{method} gave no response within "
                f"{options.execution_timeout_s}s")
        if resp["error"] is not None:
            raise RemoteServiceError(resp["error"])
        return resp["result"]

    def _cleanup(self, rid: str, want_ack: bool) -> None:
        self._client.delete(f"{self._name}:resp:{rid}")
        if want_ack:
            self._client.delete(f"{self._name}:ack:{rid}")

    # -- lifecycle ----------------------------------------------------------

    def shutdown(self, wait: bool = True) -> None:
        self._stop.set()
        if wait:
            for t in self._workers:
                t.join(timeout=2)
        self._workers.clear()
        self._pool.shutdown(wait=wait)
