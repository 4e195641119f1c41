"""Lean asyncio msgpack-RPC server (counterpart of jubatus_tpu/rpc/server.py).

Wire protocol (msgpack-rpc): request [0, msgid, method, params] ->
response [1, msgid, error, result]; notifications [2, method, params] are
ignored.  A missing method answers error 1, a wrong argument count error
2, an application exception its message string — the JAX server's
taxonomy.  Responses use the OLD msgpack spec (raw family only, no bin
type), which the reference's msgpack-c 0.5.9 clients require; requests
are decoded with raw=False + surrogateescape so binary that traveled as
raw round-trips to exact bytes.

Threads: decoded handlers (add) run on the event-loop thread, one request
at a time, unless they are registered with threaded=True: those run on a
pool of their own (CALL_WORKERS threads), as the JAX server's threaded
mode runs them on its executor.  A handler that makes peer RPCs (do_mix
fans get_diff and put_diff out to every member, this server included)
must be threaded: on the loop it would wait forever on its own
self-call.  The mixer's peer handlers are threaded too, so a round's
decode and fold never stall the loop.  A decoded handler may also return
a concurrent Future (a read queued on the read lane,
framework/dispatch.py): the loop awaits it without blocking, so reads of
other connections arrive meanwhile and share the lane's sweep.  Raw
handlers (add_raw) run on a pool of worker threads: once a server
registers one, every connection is framed by the native FrameSplitter
(native/_fastconv.c), which scans each stream byte once, and a request
whose method has a raw handler is handed over as its undecoded bytes.
A raw train handler returns a concurrent Future, and its ack waits for
it: the ack proves the request's device step was dispatched (the
dispatch thread of framework/dispatch.py issues it, not this loop).  Acks keep wire order per connection, and a decoded request
first waits for the acks of the raw requests before it, so a classify
pipelined after trains sees all of them.  Handlers that share model state
across these threads take the server's model lock (framework/service.py).
The inline dispatch mode and the tracer of the JAX server are later work.
"""

from __future__ import annotations

import asyncio
import inspect
import logging
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional, Tuple

import msgpack

log = logging.getLogger("jubatus_tpu_torch.rpc")

REQUEST = 0
RESPONSE = 1
NOTIFY = 2

NO_METHOD_ERROR = 1
ARGUMENT_ERROR = 2


class RpcServer:
    # worker threads of the raw handlers (each connection's reader awaits
    # its own handler, so this many connections hand frames over at once)
    WORKERS = 2
    # worker threads of the threaded decoded handlers, a pool apart from
    # the raw one: a do_mix, its get_diff or put_diff self-call and a
    # peer's leg each hold one while raw trains keep the other pool
    CALL_WORKERS = 4

    def __init__(self, call_workers: int = 0):
        """call_workers: the call pool's size (0: CALL_WORKERS); a proxy
        runs every request there, so it sets its --thread count."""
        self._methods: Dict[str, Tuple[Callable[..., Any],
                                       Optional[inspect.Signature]]] = {}
        self._raw_methods: Dict[str, Callable[[bytes, int], Any]] = {}
        self._threaded: set = set()
        self._splitter = None             # native FrameSplitter type
        self._pool = ThreadPoolExecutor(max_workers=self.WORKERS,
                                        thread_name_prefix="rpc-worker")
        self._call_pool = ThreadPoolExecutor(
            max_workers=call_workers or self.CALL_WORKERS,
            thread_name_prefix="rpc-call")
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.base_events.Server] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._error: Optional[BaseException] = None
        self.port: Optional[int] = None

    def add(self, name: str, fn: Callable[..., Any],
            threaded: bool = False) -> None:
        """Register a decoded handler; threaded=True runs it on the call
        pool instead of the event loop (see the module docstring)."""
        try:
            sig = inspect.signature(fn)
        except (TypeError, ValueError):
            sig = None
        self._methods[name] = (fn, sig)
        if threaded:
            self._threaded.add(name)
        else:
            self._threaded.discard(name)

    def add_raw(self, name: str, fn: Callable[[bytes, int], Any]) -> None:
        """Register a raw handler fn(message_bytes, params_offset): it gets
        the COMPLETE msgpack-rpc request bytes and the byte offset of the
        params array, so it can parse the payload natively.  Builds the
        native extension if needed (raising where it cannot)."""
        from jubatus_tpu_torch import native
        self._splitter = native.load().FrameSplitter
        self._raw_methods[name] = fn

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        if self._raw_methods:
            await self._handle_conn_raw(reader, writer)
            return
        unpacker = msgpack.Unpacker(raw=False, strict_map_key=False,
                                    unicode_errors="surrogateescape",
                                    max_buffer_size=1 << 30)
        try:
            while True:
                data = await reader.read(1 << 20)
                if not data:
                    break
                unpacker.feed(data)
                for msg in unpacker:
                    await self._handle_msg(msg, writer)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except (msgpack.UnpackException, ValueError) as e:
            log.warning("malformed msgpack-rpc frame (%s); closing", e)
        finally:
            writer.close()

    async def _handle_conn_raw(self, reader: asyncio.StreamReader,
                               writer: asyncio.StreamWriter) -> None:
        """Framing by the native FrameSplitter.  The reader awaits each
        raw request's handler (a worker thread), so requests reach the
        dispatcher in wire order; the ack of a request whose handler
        returned a Future waits in a task, at most 8 per connection, so
        the next frames are read meanwhile.  A decoded request, or a raw
        one answered at once, first waits for the acks before it."""
        splitter = self._splitter()
        pending: set = set()
        sem = asyncio.Semaphore(8)
        loop = asyncio.get_running_loop()

        async def drain_acks():
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)

        async def await_ack(name, fut, msgid):
            try:
                result = await asyncio.wrap_future(fut)
                await self._reply(writer, msgid, None, result)
            except Exception as e:  # noqa: BLE001 - relayed to the client
                log.warning("error in %s (dispatch): %s", name, e,
                            exc_info=True)
                try:
                    await self._reply(writer, msgid, str(e), None)
                except ConnectionError:
                    pass
            finally:
                sem.release()

        try:
            while True:
                data = await reader.read(1 << 20)
                if not data:
                    break
                splitter.feed(data)
                while True:
                    try:
                        env = splitter.next()
                    except ValueError:
                        log.warning("malformed msgpack-rpc frame; closing")
                        return
                    if env is None:
                        break
                    msg, msgtype, msgid, method, params_off = env
                    if msgtype != REQUEST:
                        continue
                    name = method.decode() if method else ""
                    raw_fn = self._raw_methods.get(name)
                    if raw_fn is None:
                        await drain_acks()
                        await self._handle_msg(
                            msgpack.unpackb(msg, raw=False,
                                            strict_map_key=False,
                                            unicode_errors="surrogateescape"),
                            writer)
                        continue
                    await sem.acquire()
                    try:
                        result = await loop.run_in_executor(
                            self._pool, raw_fn, msg, params_off)
                    except Exception as e:  # noqa: BLE001 - to the client
                        sem.release()
                        log.warning("error in %s (raw): %s", name, e,
                                    exc_info=True)
                        await drain_acks()
                        await self._reply(writer, msgid, str(e), None)
                        continue
                    if isinstance(result, Future):
                        task = asyncio.ensure_future(
                            await_ack(name, result, msgid))
                        pending.add(task)
                        task.add_done_callback(pending.discard)
                    else:
                        sem.release()
                        await drain_acks()
                        await self._reply(writer, msgid, None, result)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except (msgpack.UnpackException, ValueError) as e:
            log.warning("malformed msgpack-rpc frame (%s); closing", e)
        finally:
            await drain_acks()
            writer.close()

    async def _handle_msg(self, msg: Any,
                          writer: asyncio.StreamWriter) -> None:
        if not isinstance(msg, (list, tuple)) or len(msg) != 4 \
                or msg[0] != REQUEST:
            return
        _, msgid, method, params = msg
        if isinstance(method, bytes):
            method = method.decode()
        entry = self._methods.get(method)
        if entry is None:
            await self._reply(writer, msgid, NO_METHOD_ERROR, None)
            return
        fn, sig = entry
        if sig is not None:
            # arity check BEFORE invoking, so a TypeError raised inside
            # the handler is never mistaken for a malformed request
            try:
                sig.bind(*params)
            except TypeError as e:
                log.warning("argument error on %s: %s", method, e)
                await self._reply(writer, msgid, ARGUMENT_ERROR, None)
                return
        try:
            if method in self._threaded:
                result = await asyncio.get_running_loop().run_in_executor(
                    self._call_pool, lambda: fn(*params))
            else:
                result = fn(*params)
            if isinstance(result, Future):
                result = await asyncio.wrap_future(result)
        except Exception as e:  # noqa: BLE001 - relayed to the client
            log.warning("error in %s: %s", method, e, exc_info=True)
            await self._reply(writer, msgid, str(e), None)
            return
        await self._reply(writer, msgid, None, result)

    async def _reply(self, writer: asyncio.StreamWriter, msgid: int,
                     error: Any, result: Any) -> None:
        data = msgpack.packb([RESPONSE, msgid, error, result],
                             use_bin_type=False,
                             unicode_errors="surrogateescape")
        writer.write(data)
        await writer.drain()

    # -- lifecycle ------------------------------------------------------------

    def start(self, port: int, host: str = "127.0.0.1") -> int:
        """Serve on a background thread; returns the bound port."""

        async def _main():
            self._server = await asyncio.start_server(
                self._handle_conn, host, port, limit=1 << 22)
            self.port = self._server.sockets[0].getsockname()[1]
            self._started.set()
            async with self._server:
                await self._server.serve_forever()

        def _run():
            self._loop = asyncio.new_event_loop()
            try:
                self._loop.run_until_complete(_main())
            except asyncio.CancelledError:
                pass
            except OSError as e:      # bind failure: reported by start()
                self._error = e
                self._started.set()
            finally:
                self._loop.close()

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name="rpc-server")
        self._thread.start()
        if not self._started.wait(timeout=30):
            raise RuntimeError("rpc server failed to start")
        if self._error is not None:
            raise self._error
        return self.port

    def stop(self) -> None:
        loop = self._loop
        if loop is not None and not loop.is_closed():
            def _shutdown():
                for task in asyncio.all_tasks(loop):
                    task.cancel()
            try:
                loop.call_soon_threadsafe(_shutdown)
            except RuntimeError:      # loop closed meanwhile
                pass
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._pool.shutdown(wait=False)
        self._call_pool.shutdown(wait=False)
