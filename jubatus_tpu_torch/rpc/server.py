"""Lean asyncio msgpack-RPC server (counterpart of jubatus_tpu/rpc/server.py).

Wire protocol (msgpack-rpc): request [0, msgid, method, params] ->
response [1, msgid, error, result]; notifications [2, method, params] are
ignored.  A missing method answers error 1, a wrong argument count error
2, an application exception its message string — the JAX server's
taxonomy.  Responses use the OLD msgpack spec (raw family only, no bin
type), which the reference's msgpack-c 0.5.9 clients require; requests
are decoded with raw=False + surrogateescape so binary that traveled as
raw round-trips to exact bytes.  A handler may return PreEncoded, an
already-packed result body (the query cache's hits), which is spliced
into the response frame without a second encode.

Threads: decoded handlers (add) run on the event-loop thread, one request
at a time, unless they are registered with threaded=True: those run on a
pool of their own (CALL_WORKERS threads, or the proxy's --thread), as
the JAX server runs its handlers that are not marked inline on its
executor.  A handler that makes peer RPCs (do_mix fans get_diff and
put_diff out to every member, this server included) must be threaded: on
the loop it would wait forever on its own self-call.  The mixer's peer
handlers are threaded too, so a round's decode and fold never stall the
loop.  A decoded handler may also return a concurrent Future (a read
queued on the read lane, framework/dispatch.py): the loop awaits it
without blocking, so reads of other connections arrive meanwhile and
share the lane's sweep.  Raw handlers (add_raw) run on a pool of
`threads` worker threads (the server's --thread): once a server
registers one, every connection is framed by the native FrameSplitter
(native/_fastconv.c), which scans each stream byte once, and a request
whose method has a raw handler is handed over as its undecoded bytes.
A raw train handler may return a concurrent Future, and its ack waits
for it: the ack proves the request's device step was dispatched.  Acks
keep wire order per connection, and a decoded request first waits for
the acks of the raw requests before it, so a classify pipelined after
trains sees all of them.

Inline dispatch (`inline_raw`, the server's --dispatch inline): raw
requests with a batch handler run synchronously on the event loop, every
complete frame of one read burst as ONE fused call (batching/coalescer.py
InlineCoalescer), with no thread hand-off at all; device_call() runs the
local model write of a threaded handler (anomaly's add) or of the
partition handoff on the loop thread too, beside every request's.

Every request records its time in the `rpc.<method>` histogram and a
failure in `rpc_error_total.<method>`.  With the tracer on
(--trace_ring, --slow_op_ms) each request is one root span `rpc.<method>`
from its arrival to its response's write, with its stage tags
(queue_wait_s, dispatch_wait_s, encode_s, write_s, and what the handler
adds); the span is re-attached on the thread that runs the handler,
because context variables do not follow run_in_executor.
"""

from __future__ import annotations

import asyncio
import inspect
import logging
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional, Tuple

import msgpack

from jubatus_tpu_torch.obs.trace import TRACER as _tracer
from jubatus_tpu_torch.utils.metrics import GLOBAL as _metrics

log = logging.getLogger("jubatus_tpu_torch.rpc")

REQUEST = 0
RESPONSE = 1
NOTIFY = 2

NO_METHOD_ERROR = 1
ARGUMENT_ERROR = 2


class InlineFault:
    """Per-request error marker in an inline batch handler's result
    list: a failure that concerns some frames of a burst fails only
    those, since the others were already applied and journaled."""

    __slots__ = ("error",)

    def __init__(self, error: str):
        self.error = error


class PreEncoded:
    """A handler result that is already msgpack-encoded (the old wire
    spec of _reply); _reply splices the body into the response frame."""

    __slots__ = ("body",)

    def __init__(self, body: bytes):
        self.body = body


# fixarray(4) + RESPONSE(1): the constant prefix of a success frame
# spliced around a PreEncoded body (the msgid varies, error is nil)
_RESP4_PREFIX = b"\x94\x01"
_NIL = b"\xc0"


class RpcServer:
    # worker threads of the raw handlers (each connection's reader awaits
    # its own handler, so this many connections hand frames over at once)
    WORKERS = 2
    # worker threads of the threaded decoded handlers, a pool apart from
    # the raw one: a do_mix, its get_diff or put_diff self-call and a
    # peer's leg each hold one while raw trains keep the other pool
    CALL_WORKERS = 4

    def __init__(self, threads: int = 0, call_workers: int = 0,
                 inline_raw: bool = False):
        """threads: the raw pool's size (0: WORKERS; the server's
        --thread); call_workers: the call pool's size (0: CALL_WORKERS;
        a proxy runs every request there, so it sets its --thread);
        inline_raw: inline dispatch (see the module docstring)."""
        self._methods: Dict[str, Tuple[Callable[..., Any],
                                       Optional[inspect.Signature]]] = {}
        self._raw_methods: Dict[str, Callable[[bytes, int], Any]] = {}
        self._raw_batch: Dict[str, Callable] = {}
        self._threaded: set = set()
        self._splitter = None             # native FrameSplitter type
        self.inline_raw = inline_raw
        # the fused-call bound of inline mode (0: one read burst); the
        # service sets it from --batch_max
        self.inline_batch_max = 0
        self._pool = ThreadPoolExecutor(max_workers=threads or self.WORKERS,
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
        pool instead of the event loop (see the module docstring).  The
        JAX server's inline=True mark is the port's default: a handler
        that is not threaded runs on the loop in both dispatch modes."""
        try:
            sig = inspect.signature(fn)
        except (TypeError, ValueError):
            sig = None
        self._methods[name] = (fn, sig)
        if threaded:
            self._threaded.add(name)
        else:
            self._threaded.discard(name)

    def add_raw(self, name: str, fn: Callable[[bytes, int], Any],
                batch_fn: Optional[Callable] = None) -> None:
        """Register a raw handler fn(message_bytes, params_offset): it gets
        the COMPLETE msgpack-rpc request bytes and the byte offset of the
        params array, so it can parse the payload natively.  batch_fn(
        [(msg, off), ...]) -> [result, ...] is its inline-mode form, one
        call for a read burst's frames.  Builds the native extension if
        needed (raising where it cannot)."""
        from jubatus_tpu_torch import native
        self._splitter = native.load().FrameSplitter
        self._raw_methods[name] = fn
        if batch_fn is not None:
            self._raw_batch[name] = batch_fn

    @staticmethod
    def _traced_call(fn: Callable, params, root, t_enq: float):
        """Run a handler under its request's root span, re-attached on
        whatever thread runs it; the queue-wait stage is the gap between
        the loop's enqueue and this frame starting."""
        root.tag("stage.queue_wait_s", round(time.monotonic() - t_enq, 6))
        with _tracer.attach(root):
            return fn(*params)

    def device_call(self, fn: Callable[[], Any]) -> Any:
        """Run fn on the thread that runs the process's device work: in
        inline mode the event loop's, where a threaded handler (it makes
        peer RPCs, so it is off the loop) must send its local device
        mutation; otherwise, or from the loop itself, a plain call."""
        if (not self.inline_raw or self._loop is None
                or not self._loop.is_running()
                or (self._thread is not None
                    and threading.get_ident() == self._thread.ident)):
            return fn()
        fut: Future = Future()

        def run():
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 - to the caller
                fut.set_exception(e)

        self._loop.call_soon_threadsafe(run)
        return fut.result()

    # -- connection handling ------------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        if self.inline_raw and self._raw_batch:
            await self._handle_conn_inline(reader, writer)
            return
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

        def done(name, t0, root, error=None):
            _metrics.observe(f"rpc.{name}", loop.time() - t0)
            if error is not None:
                _metrics.inc_keyed("rpc_error_total", name)
            if root is not None:
                if error is not None:
                    root.tag("error", str(error))
                _tracer.finish(root)

        async def await_ack(name, fut, msgid, t0, root):
            t_d = time.monotonic() if root is not None else 0.0
            err = None
            try:
                result = await asyncio.wrap_future(fut)
                if root is not None:
                    # the wait for the fused step holding this request
                    root.tag("stage.dispatch_wait_s",
                             round(time.monotonic() - t_d, 6))
                await self._reply(writer, msgid, None, result, span=root)
            except Exception as e:  # noqa: BLE001 - relayed to the client
                err = e
                log.warning("error in %s (dispatch): %s", name, e,
                            exc_info=getattr(e, "log_trace", True))
                try:
                    await self._reply(writer, msgid, str(e), None)
                except ConnectionError:
                    pass
            finally:
                done(name, t0, root, err)
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
                    t0 = loop.time()
                    root = _tracer.start(f"rpc.{name}") \
                        if _tracer.enabled else None
                    try:
                        if root is None:
                            result = await loop.run_in_executor(
                                self._pool, raw_fn, msg, params_off)
                        else:
                            result = await loop.run_in_executor(
                                self._pool, self._traced_call, raw_fn,
                                (msg, params_off), root, time.monotonic())
                    except Exception as e:  # noqa: BLE001 - to the client
                        sem.release()
                        log.warning("error in %s (raw): %s", name, e,
                                    exc_info=getattr(e, "log_trace", True))
                        await drain_acks()
                        await self._reply(writer, msgid, str(e), None)
                        done(name, t0, root, e)
                        continue
                    if isinstance(result, Future):
                        task = asyncio.ensure_future(
                            await_ack(name, result, msgid, t0, root))
                        pending.add(task)
                        task.add_done_callback(pending.discard)
                    else:
                        sem.release()
                        await drain_acks()
                        await self._reply(writer, msgid, None, result,
                                          span=root)
                        done(name, t0, root)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except (msgpack.UnpackException, ValueError) as e:
            log.warning("malformed msgpack-rpc frame (%s); closing", e)
        finally:
            await drain_acks()
            writer.close()

    async def _handle_conn_inline(self, reader: asyncio.StreamReader,
                                  writer: asyncio.StreamWriter) -> None:
        """Inline dispatch: raw requests that have a batch handler run
        synchronously on the event loop, one fused call a read burst
        (InlineCoalescer owns the policy and its stats; this handler the
        framing and the replies).  A decoded request first drains the
        pending batch: per-connection wire order holds."""
        from jubatus_tpu_torch.batching import InlineCoalescer
        splitter = self._splitter()
        ic = InlineCoalescer(self._raw_batch, registry=_metrics,
                             max_batch=self.inline_batch_max)

        async def flush_batch():
            out = ic.drain()
            if out is None:
                return
            name, todo, results, err = out
            if err is not None:
                log.warning("error in %s (inline batch): %s", name, err,
                            exc_info=err)
                _metrics.inc_keyed("rpc_error_total", name)
                for msgid, _, _ in todo:
                    await self._reply(writer, msgid, str(err), None)
                return
            for (msgid, _, _), result in zip(todo, results):
                if isinstance(result, InlineFault):
                    _metrics.inc_keyed("rpc_error_total", name)
                    await self._reply(writer, msgid, result.error, None)
                else:
                    await self._reply(writer, msgid, None, result)

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
                    if name in self._raw_batch:
                        if not ic.offer(name, msgid, msg, params_off):
                            # a full batch (fused calls are one method):
                            # drain, then queue
                            await flush_batch()
                            ic.offer(name, msgid, msg, params_off)
                        continue
                    # an ordering barrier: a decoded request observes
                    # every train batched before it
                    await flush_batch()
                    await self._handle_msg(
                        msgpack.unpackb(msg, raw=False, strict_map_key=False,
                                        unicode_errors="surrogateescape"),
                        writer)
                # one fused call a read burst
                await flush_batch()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except (msgpack.UnpackException, ValueError) as e:
            log.warning("malformed msgpack-rpc frame (%s); closing", e)
        finally:
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
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        # one root span a request, finished after the response is written
        # (the disabled path costs one attribute check)
        root = _tracer.start(f"rpc.{method}") if _tracer.enabled else None
        try:
            if method in self._threaded:
                if root is None:
                    result = await loop.run_in_executor(
                        self._call_pool, lambda: fn(*params))
                else:
                    result = await loop.run_in_executor(
                        self._call_pool, self._traced_call, fn, params,
                        root, time.monotonic())
            elif root is None:
                result = fn(*params)
            else:
                result = self._traced_call(fn, params, root,
                                           time.monotonic())
            if isinstance(result, Future):
                t_d = time.monotonic() if root is not None else 0.0
                result = await asyncio.wrap_future(result)
                if root is not None:
                    root.tag("stage.dispatch_wait_s",
                             round(time.monotonic() - t_d, 6))
            await self._reply(writer, msgid, None, result, span=root)
        except Exception as e:  # noqa: BLE001 - relayed to the client
            # an expected refusal (a tenant's quota) logs without its
            # stack: it is the client's, and counted where it is raised
            log.warning("error in %s: %s", method, e,
                        exc_info=getattr(e, "log_trace", True))
            _metrics.inc_keyed("rpc_error_total", method)
            if root is not None:
                root.tag("error", str(e))
            await self._reply(writer, msgid, str(e), None)
        finally:
            _metrics.observe(f"rpc.{method}", loop.time() - t0)
            if root is not None:
                _tracer.finish(root)

    async def _reply(self, writer: asyncio.StreamWriter, msgid: int,
                     error: Any, result: Any, span=None) -> None:
        if error is None and isinstance(result, PreEncoded):
            # the body was packed once (the cache fill); splice it
            t_w = time.monotonic() if span is not None else 0.0
            writer.write(_RESP4_PREFIX
                         + msgpack.packb(msgid, use_bin_type=False)
                         + _NIL + result.body)
            await writer.drain()
            if span is not None:
                span.tag("stage.write_s", round(time.monotonic() - t_w, 6))
            return
        t_e = time.monotonic() if span is not None else 0.0
        data = msgpack.packb([RESPONSE, msgid, error, result],
                             use_bin_type=False,
                             unicode_errors="surrogateescape")
        if span is not None:
            t_w = time.monotonic()
            span.tag("stage.encode_s", round(t_w - t_e, 6))
        writer.write(data)
        await writer.drain()
        if span is not None:
            span.tag("stage.write_s", round(time.monotonic() - t_w, 6))

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
