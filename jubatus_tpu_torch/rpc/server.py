"""Lean asyncio msgpack-RPC server (counterpart of jubatus_tpu/rpc/server.py).

Wire protocol (msgpack-rpc): request [0, msgid, method, params] ->
response [1, msgid, error, result]; notifications [2, method, params] are
ignored.  A missing method answers error 1, a wrong argument count error
2, an application exception its message string — the JAX server's
taxonomy.  Responses use the OLD msgpack spec (raw family only, no bin
type), which the reference's msgpack-c 0.5.9 clients require; requests
are decoded with raw=False + surrogateescape so binary that traveled as
raw round-trips to exact bytes.

Every handler runs on the event-loop thread, one request at a time: all
device work of a server stays on one thread, and nothing here needs a
lock.  The native framer, coalescer and tracer of the JAX server are
later work.
"""

from __future__ import annotations

import asyncio
import inspect
import logging
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import msgpack

log = logging.getLogger("jubatus_tpu_torch.rpc")

REQUEST = 0
RESPONSE = 1
NOTIFY = 2

NO_METHOD_ERROR = 1
ARGUMENT_ERROR = 2


class RpcServer:
    def __init__(self):
        self._methods: Dict[str, Tuple[Callable[..., Any],
                                       Optional[inspect.Signature]]] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.base_events.Server] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._error: Optional[BaseException] = None
        self.port: Optional[int] = None

    def add(self, name: str, fn: Callable[..., Any]) -> None:
        try:
            sig = inspect.signature(fn)
        except (TypeError, ValueError):
            sig = None
        self._methods[name] = (fn, sig)

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
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
            result = fn(*params)
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
