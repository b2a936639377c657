"""WireServer — the RESP2/RESP3 network front-end (the engine-side L0;
counterpart of `redisson_tpu.wire.server`).

The reference's Netty transport + per-connection ``CommandsQueue.java``
correlator + ``CommandDecoder``/``ConnectionWatchdog`` lifecycle, rebuilt
server-side: an asyncio event loop on a private thread accepts connections,
decodes command frames with the native RESP codec, and funnels the data
plane into the existing stack through ``ServingLayer.execute_many``.

Scheduling shape (the whole point of the wire tier): commands arriving on
MANY connections inside one event-loop wave accumulate into a shared
staging list; a ``call_soon`` microtask flushes them as ONE
``execute_many`` window, so the executor coalesces a multi-connection window
into runs (a PFADD run of many sketches is one seg_insert launch per chunk
on the card) instead of one run per socket. Replies resolve out
of order across the window; each connection's :class:`ConnectionWindow`
(serve/windows.py) releases them strictly in submission order.

Cluster mode: one WireServer fronts each shard. Keyed commands are checked
against the live slot table before dispatch and the shard guard's
``SlotMovedError`` (plus the router's ASK cutover window) render as real
``-MOVED <slot> <host:port>`` / ``-ASK`` wire errors, so off-the-shelf
redirect-following clients drive slot migration.

Thread model: all connection/window/staging state is event-loop confined;
executor threads hand completion back through ``call_soon_threadsafe``.
Counters are plain ints written on the loop thread and read racily by
metrics gauges (torn reads of monotonic counters are benign).
"""

from __future__ import annotations

import asyncio
import dataclasses
import inspect
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from redisson_tpu_torch import contractwitness
from redisson_tpu_torch.cluster.errors import (SlotAskError, SlotMovedError,
                                               render_redirect)
from redisson_tpu_torch.fault.inject import fire
from redisson_tpu_torch.loopwitness import loop_gauges, unwatch_loop, watch_loop
from redisson_tpu_torch.ops.crc16 import key_slot
from redisson_tpu_torch.serve.errors import (CircuitOpenError, DeadlineExceeded,
                                             RejectedError)
from redisson_tpu_torch.serve.windows import ConnectionWindow
from redisson_tpu_torch.wire import commands as wire_commands
from redisson_tpu_torch.wire import proto
from redisson_tpu_torch.wire.commands import EngineCall, WireCommandError

SERVER_VERSION = "7.0.0-rtpu"

_conn_ids = itertools.count(1)


async def _cancel_loop_tasks() -> None:
    """Cancel-and-await every other task on this loop (connection handler
    coroutines at shutdown), so teardown never leaves pending tasks."""
    tasks = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
    for t in tasks:
        t.cancel()
    if tasks:
        await asyncio.gather(*tasks, return_exceptions=True)


class _WireConn:
    """One accepted connection: decoder + reply window + identity."""

    __slots__ = ("conn_id", "reader", "writer", "window", "proto_ver",
                 "authed", "name", "client_name", "closing")

    def __init__(self, reader, writer, max_inflight: int, authed: bool):
        self.conn_id = next(_conn_ids)
        self.reader = reader
        self.writer = writer
        self.window = ConnectionWindow(max_inflight=max_inflight)
        self.proto_ver = proto.RESP2
        self.authed = authed
        peer = writer.get_extra_info("peername")
        self.name = f"{peer[0]}:{peer[1]}" if peer else f"conn-{self.conn_id}"
        self.client_name = ""
        self.closing = False

    def pump(self) -> int:
        """Write the completed reply prefix; returns bytes written."""
        out = self.window.drain()
        if not out or self.closing:
            return 0
        n = 0
        for data in out:
            self.writer.write(data)
            n += len(data)
        return n

    def kill(self) -> None:
        self.closing = True
        try:
            self.writer.close()
        except Exception:
            pass


class _CallState:
    """One EngineCall in flight: reply slot + per-op result collection.
    Mutated only on the event loop (_op_done marshals here)."""

    __slots__ = ("conn", "slot", "call", "results", "remaining", "exc")

    def __init__(self, conn: _WireConn, slot, call: EngineCall):
        self.conn = conn
        self.slot = slot
        self.call = call
        self.results: List[Any] = [None] * len(call.ops)
        self.remaining = len(call.ops)
        self.exc: Optional[BaseException] = None


class WireServer:
    """RESP front-end for ONE engine client (or one cluster shard).

    PersistenceManager-style lifecycle: construct, ``start()`` (binds the
    socket, spins the private loop thread), ``stop()``. ``port`` is the
    bound port (ephemeral when the config asked for 0)."""

    def __init__(self, client, cfg, cluster_ctx=None,
                 dispatch_getter: Optional[Callable[[], Any]] = None):
        self._client = client
        self._cfg = cfg
        self._cluster = cluster_ctx
        self._get_dispatch = dispatch_getter or (lambda: client._dispatch)
        self._accepts_admitted: Dict[int, bool] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self.host = cfg.host
        self.port = int(cfg.port)
        self._conns: set = set()
        # Cross-connection staging window, flushed by ONE call_soon
        # microtask per event-loop wave.
        self._pending_ops: List[Tuple[str, str, Any, int]] = []
        self._pending_ats: List[float] = []
        self._pending_targets: List[Tuple[_CallState, int]] = []
        self._flush_scheduled = False
        # counters (see GUARDED_BY: racy monotonic reads are fine)
        self.total_connections = 0
        self.bytes_in = 0
        self.bytes_out = 0
        self.commands_total = 0
        self.engine_commands = 0
        self.sheds_total = 0
        self.redirects_rendered = 0
        self.windows_flushed = 0
        self.ops_flushed = 0
        self.last_window_depth = 0
        self.dropped_conns = 0

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._loop is not None:
            return
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever,
            name=f"redisson-torch-wire-{self.host}:{self._cfg.port}", daemon=True)
        self._thread.start()
        try:
            fut = asyncio.run_coroutine_threadsafe(
                self._bind(), self._loop)
            fut.result(15.0)
        except Exception:
            self.stop()
            raise
        # Loop-stall witness (no-op unless REDISSON_TPU_LOOP_WITNESS=1):
        # feeds wire.loop_lag_p99_us / wire.loop_stalls and the
        # --aio-smoke gate's stall attribution.
        watch_loop(self._loop, f"wire:{self.host}:{self.port}")

    async def _bind(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, int(self._cfg.port),
            backlog=int(self._cfg.backlog))
        sock = self._server.sockets[0]
        self.port = sock.getsockname()[1]

    def stop(self) -> None:
        loop, self._loop = self._loop, None
        if loop is None:
            return
        unwatch_loop(loop)
        try:
            asyncio.run_coroutine_threadsafe(
                self._shutdown(), loop).result(10.0)
        except Exception:
            pass
        loop.call_soon_threadsafe(loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        loop.close()

    async def _shutdown(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        for conn in list(self._conns):
            conn.kill()
        await _cancel_loop_tasks()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    # -- accept + read loop --------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        if (self._cfg.max_connections > 0
                and len(self._conns) >= self._cfg.max_connections):
            # Connection-limit shedding: same -BUSY rendering the serve
            # tier's RejectedError gets, with the configured retry hint.
            self.sheds_total += 1
            try:
                writer.write(proto.busy(
                    "max connections reached",
                    retry_after_s=self._cfg.shed_retry_after_s))
                await writer.drain()
                writer.close()
            except Exception:
                pass
            return
        conn = _WireConn(reader, writer,
                         max_inflight=self._cfg.max_inflight_per_conn,
                         authed=self._cfg.password is None)
        self._conns.add(conn)
        self.total_connections += 1
        parser = proto.RespParser()
        try:
            while not conn.closing:
                data = await reader.read(1 << 16)
                if not data:
                    break
                self.bytes_in += len(data)
                try:
                    # Chaos seam: a DROPCONN-style plan kills the socket
                    # mid-pipeline right here, after bytes were read but
                    # before their commands dispatch.
                    fire("wire_conn", kind="read", target=conn.name)
                except Exception:
                    self.dropped_conns += 1
                    conn.kill()
                    break
                # Network-queue attribution: admitted_at is the socket-read
                # stamp, so SLOWLOG's admission stage covers wire queueing.
                admitted_at = time.monotonic()
                try:
                    frames = parser.feed(data)
                except proto.RespError as exc:
                    conn.window.reserve_immediate(
                        proto.err(f"Protocol error: {exc}"))
                    self.bytes_out += conn.pump()
                    break
                for frame in frames:
                    self._dispatch_frame(conn, frame, admitted_at)
                self.bytes_out += conn.pump()
                try:
                    await writer.drain()
                except (ConnectionError, OSError):
                    break
        except (asyncio.CancelledError, ConnectionError, OSError):
            pass
        finally:
            self._conns.discard(conn)
            conn.closing = True
            try:
                parser.close()
            except Exception:
                pass
            try:
                writer.close()
            except Exception:
                pass

    # -- per-frame dispatch --------------------------------------------------

    def _dispatch_frame(self, conn: _WireConn, frame: Any,
                        admitted_at: float) -> None:
        self.commands_total += 1
        if not isinstance(frame, list) or not frame or \
                not isinstance(frame[0], (bytes, bytearray)):
            conn.window.reserve_immediate(
                proto.err("Protocol error: expected a command array"))
            return
        args = [bytes(a) if isinstance(a, (bytes, bytearray)) else a
                for a in frame]
        name = args[0].upper()
        if not conn.authed and name not in (b"AUTH", b"HELLO", b"QUIT"):
            conn.window.reserve_immediate(
                proto.err("Authentication required.", code="NOAUTH"))
            return
        if name in wire_commands.INLINE_COMMANDS:
            conn.window.reserve_immediate(self._inline(conn, name, args))
            return
        try:
            call = wire_commands.build(self._client, args)
        except WireCommandError as exc:
            conn.window.reserve_immediate(proto.err(str(exc)))
            return
        except Exception as exc:
            conn.window.reserve_immediate(proto.err(str(exc) or repr(exc)))
            return
        if self._cluster is not None and call.key is not None:
            redirect = self._cluster.redirect_for(key_slot(call.key))
            if redirect is not None:
                self.redirects_rendered += 1
                conn.window.reserve_immediate(redirect)
                return
        slot = conn.window.try_reserve()
        if slot is None:
            # Per-connection inflight cap: shed THIS command, keep the
            # pipeline's reply order dense (-BUSY takes the reply position).
            self.sheds_total += 1
            conn.window.reserve_immediate(proto.busy(
                f"connection inflight cap {conn.window.max_inflight} "
                "reached", retry_after_s=self._cfg.shed_retry_after_s))
            return
        self.engine_commands += 1
        state = _CallState(conn, slot, call)
        for i, op in enumerate(call.ops):
            self._pending_ops.append(op)
            self._pending_ats.append(admitted_at)
            self._pending_targets.append((state, i))
        if not self._flush_scheduled:
            self._flush_scheduled = True
            self._loop.call_soon(self._flush)

    # -- the connection-scheduler window ------------------------------------

    def _flush(self) -> None:
        """Flush the cross-connection staging window as ONE execute_many."""
        self._flush_scheduled = False
        staged = self._pending_ops
        ats = self._pending_ats
        targets = self._pending_targets
        if not staged:
            return
        self._pending_ops = []
        self._pending_ats = []
        self._pending_targets = []
        self.windows_flushed += 1
        self.ops_flushed += len(staged)
        self.last_window_depth = len(staged)
        dispatch = self._get_dispatch()
        try:
            # execute_many runs synchronously on this thread, so the
            # contract-witness surface tag covers the whole window.
            with contractwitness.surface("wire"):
                if self._dispatch_accepts_admitted(dispatch):
                    futures = dispatch.execute_many(staged, admitted_ats=ats)
                else:
                    futures = dispatch.execute_many(staged)
        except Exception as exc:
            for state, idx in targets:
                self._op_settle(state, idx, exc, True)
            return
        for fut, (state, idx) in zip(futures, targets):
            fut.add_done_callback(
                lambda f, s=state, i=idx: self._op_done(s, i, f))

    def _dispatch_accepts_admitted(self, dispatch) -> bool:
        key = id(type(dispatch))
        known = self._accepts_admitted.get(key)
        if known is None:
            try:
                sig = inspect.signature(dispatch.execute_many)
                known = "admitted_ats" in sig.parameters
            except (TypeError, ValueError):
                known = False
            self._accepts_admitted[key] = known
        return known

    # -- completion (executor threads -> loop) -------------------------------

    def _op_done(self, state: _CallState, idx: int, fut) -> None:
        """Future done-callback; runs on whichever thread resolved it."""
        exc = fut.exception()
        if exc is not None:
            value, is_exc = exc, True
        else:
            value, is_exc = fut.result(), False
        loop = self._loop
        if loop is None or loop.is_closed():
            return
        try:
            loop.call_soon_threadsafe(self._op_settle, state, idx, value,
                                      is_exc)
        except RuntimeError:
            pass  # loop stopped between the check and the call

    def _op_settle(self, state: _CallState, idx: int, value: Any,
                   is_exc: bool) -> None:
        """Loop-thread half: record one op's result; when the call's last
        op lands, render the reply onto its slot and pump the connection."""
        if is_exc:
            if state.exc is None:
                state.exc = value
        else:
            state.results[idx] = value
        state.remaining -= 1
        if state.remaining > 0:
            return
        conn = state.conn
        if state.exc is not None:
            data = self._render_error(state)
        else:
            try:
                data = state.call.render(state.results, conn.proto_ver)
            except Exception as exc:
                data = proto.err(str(exc) or repr(exc))
        conn.window.complete(state.slot, data)
        if not conn.closing:
            self.bytes_out += conn.pump()

    def _render_error(self, state: _CallState) -> bytes:
        exc = state.exc
        if isinstance(exc, SlotMovedError):  # SlotAskError subclasses it
            self.redirects_rendered += 1
            addr = ""
            if self._cluster is not None:
                if isinstance(exc, SlotAskError):
                    addr = self._cluster.ask_addr(exc.slot)
                else:
                    addr = self._cluster.owner_addr(exc.slot)
            return render_redirect(exc, addr)
        if isinstance(exc, (RejectedError, CircuitOpenError)):
            self.sheds_total += 1
            return proto.busy(str(exc),
                              retry_after_s=getattr(exc, "retry_after_s",
                                                    0.0))
        if isinstance(exc, DeadlineExceeded):
            return proto.err(str(exc) or "deadline exceeded")
        return proto.err(str(exc) or repr(exc))

    # -- inline (introspection) commands -------------------------------------

    def _inline(self, conn: _WireConn, name: bytes,
                args: List[bytes]) -> bytes:
        try:
            return self._inline_inner(conn, name, args)
        except WireCommandError as exc:
            return proto.err(str(exc))
        except Exception as exc:
            return proto.err(str(exc) or repr(exc))

    def _inline_inner(self, conn: _WireConn, name: bytes,
                      args: List[bytes]) -> bytes:
        p = conn.proto_ver
        if name == b"PING":
            if len(args) > 1:
                return proto.bulk(args[1])
            return proto.simple("PONG")
        if name == b"ECHO":
            wire_commands._need(args, 2, "echo")
            return proto.bulk(args[1])
        if name == b"QUIT":
            conn.closing = True
            return proto.ok()
        if name == b"RESET":
            conn.proto_ver = proto.RESP2
            return proto.simple("RESET")
        if name == b"AUTH":
            return self._auth(conn, args[1:])
        if name == b"SELECT":
            wire_commands._need(args, 2, "select")
            if wire_commands._int_arg(args[1], "db") != 0:
                return proto.err("DB index is out of range")
            return proto.ok()
        if name == b"HELLO":
            return self._hello(conn, args)
        if name == b"CLIENT":
            return self._client_cmd(conn, args)
        if name == b"COMMAND":
            if len(args) > 1 and args[1].upper() == b"COUNT":
                return proto.integer(
                    len(wire_commands.ENGINE_COMMANDS)
                    + len(wire_commands.INLINE_COMMANDS))
            return proto.array([])
        if name == b"INFO":
            return self._info(conn, args)
        if name == b"MEMORY":
            return self._memory(conn, args)
        if name == b"SLOWLOG":
            return self._slowlog(conn, args)
        if name == b"CLUSTER":
            return self._cluster_cmd(conn, args)
        return proto.err(
            f"unknown command '{wire_commands._text(args[0])}'")

    def _auth(self, conn: _WireConn, creds: Sequence[bytes]) -> bytes:
        if not creds:
            raise WireCommandError(
                "wrong number of arguments for 'auth' command")
        if self._cfg.password is None:
            return proto.err(
                "Client sent AUTH, but no password is set.")
        # AUTH <password> or AUTH <user> <password> (default user only)
        password = wire_commands._text(creds[-1])
        if len(creds) == 2 and wire_commands._text(creds[0]) != "default":
            return proto.err(
                "invalid username-password pair or user is disabled.",
                code="WRONGPASS")
        if password != self._cfg.password:
            return proto.err(
                "invalid username-password pair or user is disabled.",
                code="WRONGPASS")
        conn.authed = True
        return proto.ok()

    def _hello(self, conn: _WireConn, args: List[bytes]) -> bytes:
        i = 1
        if i < len(args) and not args[i].upper() in (b"AUTH", b"SETNAME"):
            ver = wire_commands._int_arg(args[i], "protover")
            if ver not in (proto.RESP2, proto.RESP3):
                return proto.err(
                    "unsupported protocol version", code="NOPROTO")
            i += 1
        else:
            ver = conn.proto_ver
        while i < len(args):
            tok = args[i].upper()
            if tok == b"AUTH" and i + 2 < len(args):
                reply = self._auth(conn, args[i + 1:i + 3])
                if not reply.startswith(b"+"):
                    return reply
                i += 3
            elif tok == b"SETNAME" and i + 1 < len(args):
                conn.client_name = wire_commands._text(args[i + 1])
                i += 2
            else:
                return proto.err("syntax error in HELLO")
        if not conn.authed:
            return proto.err("Authentication required.", code="NOAUTH")
        conn.proto_ver = ver
        mode = "cluster" if self._cluster is not None else \
            getattr(self._client, "_mode", "standalone")
        return proto.map_reply([
            ("server", "redisson-tpu"),
            ("version", SERVER_VERSION),
            ("proto", ver),
            ("id", conn.conn_id),
            ("mode", mode),
            ("role", "master"),
            ("modules", []),
        ], ver)

    def _client_cmd(self, conn: _WireConn, args: List[bytes]) -> bytes:
        sub = args[1].upper() if len(args) > 1 else b""
        if sub in (b"SETINFO", b"NO-EVICT", b"NO-TOUCH"):
            return proto.ok()
        if sub == b"SETNAME":
            wire_commands._need(args, 3, "client setname")
            conn.client_name = wire_commands._text(args[2])
            return proto.ok()
        if sub == b"GETNAME":
            return proto.bulk(conn.client_name.encode())
        if sub == b"ID":
            return proto.integer(conn.conn_id)
        if sub == b"INFO":
            return proto.bulk(
                f"id={conn.conn_id} addr={conn.name} "
                f"name={conn.client_name} resp={conn.proto_ver}".encode())
        return proto.err(f"Unknown CLIENT subcommand "
                         f"'{wire_commands._text(sub)}'")

    @staticmethod
    def _flatten(prefix: str, value: Any, out: List[str]) -> None:
        if isinstance(value, dict):
            for k in value:
                WireServer._flatten(
                    f"{prefix}.{k}" if prefix else str(k), value[k], out)
        else:
            out.append(f"{prefix}:{value}")

    def _info(self, conn: _WireConn, args: List[bytes]) -> bytes:
        section = wire_commands._text(args[1]) if len(args) > 1 else None
        try:
            sections = self._client.info(section)
        except ValueError as exc:
            return proto.err(str(exc))
        mode = "cluster" if self._cluster is not None else "standalone"
        lines: List[str] = [
            "# server",
            f"redis_version:{SERVER_VERSION}",
            f"redis_mode:{mode}",
            "",
        ]
        for sect in sections:
            lines.append(f"# {sect}")
            body: List[str] = []
            self._flatten("", sections[sect], body)
            lines.extend(body)
            lines.append("")
        lines.append("# wire")
        for k, v in sorted(self.snapshot().items()):
            lines.append(f"wire_{k}:{v}")
        return proto.bulk("\r\n".join(lines).encode())

    def _memory(self, conn: _WireConn, args: List[bytes]) -> bytes:
        sub = args[1].upper() if len(args) > 1 else b""
        if sub == b"USAGE":
            wire_commands._need(args, 3, "memory usage")
            usage = self._client.memory_usage(wire_commands._text(args[2]))
            if usage is None:
                return proto.null(conn.proto_ver)
            return proto.integer(int(usage))
        if sub == b"STATS":
            stats = self._client.memory_stats()
            return proto.map_reply(sorted(stats.items()), conn.proto_ver)
        if sub == b"DOCTOR":
            doctor = self._client.memory_doctor()
            if isinstance(doctor, dict):
                text = "\n".join(f"{k}: {v}" for k, v in doctor.items()) \
                    or "Sam, I detected a few issues... just kidding. OK"
            else:
                text = str(doctor)
            return proto.bulk(text.encode())
        return proto.err(f"Unknown MEMORY subcommand "
                         f"'{wire_commands._text(sub)}'")

    def _slowlog(self, conn: _WireConn, args: List[bytes]) -> bytes:
        trace = getattr(self._client, "trace", None)
        if trace is None:
            return proto.err("SLOWLOG requires Config.use_trace()")
        sub = args[1].upper() if len(args) > 1 else b""
        if sub == b"GET":
            count = wire_commands._int_arg(args[2], "count") \
                if len(args) > 2 else 10
            entries = trace.slowlog.get(None if count < 0 else count)
            frames = []
            for e in entries:
                frames.append(proto.array([
                    proto.integer(e.entry_id),
                    proto.integer(int(e.ts_wall)),
                    proto.integer(int(e.duration_s * 1e6)),
                    proto.array([proto.bulk(e.kind.encode()),
                                 proto.bulk(e.target.encode())]),
                    proto.bulk(e.tenant.encode()),
                    proto.bulk(e.worst_stage.encode()),
                ]))
            return proto.array(frames)
        if sub == b"RESET":
            trace.slowlog.reset()
            return proto.ok()
        if sub == b"LEN":
            return proto.integer(len(trace.slowlog))
        return proto.err(f"Unknown SLOWLOG subcommand "
                         f"'{wire_commands._text(sub)}'")

    def _cluster_cmd(self, conn: _WireConn, args: List[bytes]) -> bytes:
        sub = args[1].upper() if len(args) > 1 else b""
        if sub == b"KEYSLOT":
            wire_commands._need(args, 3, "cluster keyslot")
            return proto.integer(key_slot(wire_commands._text(args[2])))
        if sub == b"INFO":
            if self._cluster is not None:
                info = self._cluster.manager.cluster_info()
            else:
                info = {"cluster_enabled": 0, "cluster_state": "ok",
                        "cluster_slots_assigned": 0, "cluster_known_nodes": 1,
                        "cluster_size": 1}
            text = "\r\n".join(f"{k}:{v}" for k, v in info.items())
            return proto.bulk(text.encode())
        if sub == b"SLOTS":
            if self._cluster is None:
                return proto.array([])
            frames = []
            for start, end, shard_id, _replicas in \
                    self._cluster.manager.cluster_slots():
                host, port = self._cluster.split_addr(shard_id)
                frames.append(proto.array([
                    proto.integer(start),
                    proto.integer(end),
                    proto.array([
                        proto.bulk(host.encode()),
                        proto.integer(port),
                        proto.bulk(f"shard-{shard_id}".encode()),
                    ]),
                ]))
            return proto.array(frames)
        return proto.err(f"Unknown CLUSTER subcommand "
                         f"'{wire_commands._text(sub)}'")

    # -- introspection -------------------------------------------------------

    def connections(self) -> int:
        return len(self._conns)

    def inflight(self) -> int:
        return sum(c.window.inflight() for c in list(self._conns))

    def snapshot(self) -> Dict[str, Any]:
        return {
            "connections": self.connections(),
            "total_connections": self.total_connections,
            "inflight": self.inflight(),
            "bytes_in": self.bytes_in,
            "bytes_out": self.bytes_out,
            "commands_total": self.commands_total,
            "engine_commands": self.engine_commands,
            "sheds_total": self.sheds_total,
            "redirects_rendered": self.redirects_rendered,
            "windows_flushed": self.windows_flushed,
            "ops_flushed": self.ops_flushed,
            "last_window_depth": self.last_window_depth,
            "avg_window_depth": (self.ops_flushed
                                 / max(1, self.windows_flushed)),
            "dropped_conns": self.dropped_conns,
            # zeros unless the loop-stall witness is watching this loop
            **loop_gauges(self._loop),
        }


class ShardWireContext:
    """Cluster-mode slot bookkeeping for one shard's wire server: the live
    slot table + the cross-shard wire address map, rendered into
    -MOVED/-ASK redirects."""

    def __init__(self, shard_id: int, manager):
        self.shard_id = int(shard_id)
        self.manager = manager
        # shard_id -> "host:port"; installed by ClusterWireFrontend once
        # every shard server has bound its (possibly ephemeral) port.
        self.addrs: Dict[int, str] = {}

    def owner_addr(self, slot: int) -> str:
        owner = self.manager.router.slot_table()[slot]
        return self.addrs.get(owner, "")

    def ask_addr(self, slot: int) -> str:
        target = self._import_target(slot)
        if target is not None:
            return self.addrs.get(target, "")
        return self.owner_addr(slot)

    def _import_target(self, slot: int) -> Optional[int]:
        """The shard currently importing `slot` (its guard carries the
        migrate_begin mark), i.e. the -ASK destination."""
        for sid, shard in self.manager.shards.items():
            if sid == self.shard_id:
                continue
            try:
                if slot in shard.guard.migrating_slots():
                    return sid
            except Exception:
                continue
        return None

    def split_addr(self, shard_id: int) -> Tuple[str, int]:
        addr = self.addrs.get(shard_id, ":0")
        host, _, port = addr.rpartition(":")
        return host or "127.0.0.1", int(port or 0)

    def redirect_for(self, slot: int) -> Optional[bytes]:
        """Pre-dispatch slot check: -MOVED when the slot lives elsewhere,
        -ASK while it is parked in the router's cutover window."""
        router = self.manager.router
        ask = router.ask_slots()
        if slot in ask:
            target = self._import_target(slot)
            if target is not None:
                return proto.ask(slot, self.addrs.get(target, ""))
        owner = router.slot_table()[slot]
        if owner != self.shard_id:
            return proto.moved(slot, self.addrs.get(owner, ""))
        return None


class ClusterWireFrontend:
    """One WireServer per shard behind a shared address table — what the
    cluster facade starts when ``Config.wire`` is set. A fixed base port
    assigns port+i to shard i; port 0 binds each shard ephemerally."""

    def __init__(self, facade, cfg):
        self._facade = facade
        self._cfg = cfg
        self.servers: Dict[int, WireServer] = {}

    def start(self) -> None:
        manager = self._facade.cluster
        ctxs: Dict[int, ShardWireContext] = {}
        base_port = int(self._cfg.port)
        try:
            for i, sid in enumerate(sorted(manager.shards)):
                shard = manager.shards[sid]
                ctx = ShardWireContext(sid, manager)
                scfg = dataclasses.replace(
                    self._cfg, port=base_port + i if base_port else 0)
                srv = WireServer(
                    shard.client, scfg, cluster_ctx=ctx,
                    dispatch_getter=lambda s=shard: s.dispatch)
                srv.start()
                self.servers[sid] = srv
                ctxs[sid] = ctx
        except Exception:
            self.stop()
            raise
        addrs = {sid: srv.address for sid, srv in self.servers.items()}
        for ctx in ctxs.values():
            ctx.addrs = addrs
        self.addrs = addrs

    def stop(self) -> None:
        for srv in self.servers.values():
            try:
                srv.stop()
            except Exception:
                pass
        self.servers.clear()

    def addr_of(self, shard_id: int) -> str:
        srv = self.servers.get(shard_id)
        return srv.address if srv is not None else ""

    # facade-level rollups (the wire.* gauges in cluster mode)

    def connections(self) -> int:
        return sum(s.connections() for s in self.servers.values())

    def inflight(self) -> int:
        return sum(s.inflight() for s in self.servers.values())

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for srv in self.servers.values():
            for k, v in srv.snapshot().items():
                if isinstance(v, (int, float)):
                    out[k] = out.get(k, 0) + v
        out["shards"] = len(self.servers)
        return out
