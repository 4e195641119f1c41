"""Adaptive request coalescer: concurrent RPC calls -> fused device
steps (the port's copy of jubatus_tpu/batching/coalescer.py).

The layer between the RPC surface and the device:
  (a) drain every queued request in one gather,
  (b) linger an adaptive window (controller.py) for more when load
      warrants, not at all at low load,
  (c) hand the whole set to ONE fused execute,
  (d) split the results back per request in FIFO order, with flush()
      as a FIFO barrier.

RequestCoalescer owns a queue and one dispatch thread; RPC workers
submit() and get a Future.  The per-request TrainDispatcher and the read
lane (framework/dispatch.py) ride on it.  InlineCoalescer is the
synchronous variant of inline dispatch (--dispatch inline): frames
collect per read burst on the event loop and drain() runs them as one
fused call (rpc/server.py _handle_conn_inline).  Both record
`batch.<name>.size` (the coalesce width) and `batch.<name>.step` (the
fused step's time) into utils/metrics.py; the inline one also
`rpc.<name>`, its requests' time.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Tuple

from jubatus_tpu_torch.batching.controller import FixedWindow, WindowController
from jubatus_tpu_torch.utils import metrics as _metrics

log = logging.getLogger("jubatus_tpu_torch.batching")

_STOP = object()
_BARRIER = object()


class RequestCoalescer:
    """Queue-fed coalescing engine with one dedicated dispatch thread.

    `execute(items) -> [result, ...]` is the fused device step, called
    with every drained payload in FIFO order; it must return one result
    per item (per-request splitting).  One dispatch thread keeps the
    device steps back to back whatever the number of RPC workers.
    """

    def __init__(self, execute: Callable[[list], list], *,
                 name: str = "train", maxsize: int = 32,
                 max_batch: int = 16, max_wait_s: float = 0.002,
                 adaptive: bool = True,
                 registry: "_metrics.Registry" = None):
        self._execute = execute
        self.name = name
        self.max_batch = max(1, int(max_batch))
        if adaptive and max_wait_s > 0:
            self.controller = WindowController(
                max_wait_s=max_wait_s,
                target_batch=max(2, self.max_batch // 2))
        else:
            self.controller = FixedWindow(max_wait_s if not adaptive else 0.0)
        self._registry = registry if registry is not None else _metrics.GLOBAL
        self._q: "queue.Queue" = queue.Queue(maxsize)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"coalesce-{name}")
        self._thread.start()

    # -- producer side ------------------------------------------------------

    def submit(self, item) -> Future:
        """Enqueue a payload; the Future resolves with its per-request
        result once the fused step containing it has been dispatched.
        Blocks (bounded queue) when the device pipeline is saturated:
        backpressure to the RPC workers."""
        fut: Future = Future()
        self._q.put((item, fut))
        return fut

    def flush(self) -> None:
        """FIFO barrier: wait until everything enqueued BEFORE this call
        has been dispatched.  Later submits do not delay it (a global
        drain would starve admin ops under sustained train traffic).
        MUST NOT be called while holding the model lock (the executor
        takes the write lock per fused step)."""
        fut: Future = Future()
        self._q.put((_BARRIER, fut))
        fut.result(timeout=600)

    def stop(self) -> None:
        self._q.put((_STOP, None))
        self._thread.join(timeout=10)
        # fail anything still queued so awaiting connections see an error
        # instead of hanging through shutdown
        while True:
            try:
                item, fut = self._q.get_nowait()
            except queue.Empty:
                break
            if fut is not None and not fut.done():
                fut.set_exception(RuntimeError("server stopping"))

    # -- dispatch thread ----------------------------------------------------

    def _gather(self) -> list:
        """One blocking get, then drain everything queued; linger up to
        the controller's window for more while the batch is small.  A
        barrier or stop in hand cancels the linger — flush/shutdown must
        never wait on requests that might arrive."""
        items = [self._q.get()]
        deadline = 0.0
        window = self.controller.wait_s
        while len(items) < self.max_batch:
            if items[-1][0] is _STOP or items[-1][0] is _BARRIER:
                window = 0.0
            try:
                items.append(self._q.get_nowait())
                continue
            except queue.Empty:
                pass
            if window <= 0.0:
                break
            if not deadline:
                deadline = time.monotonic() + window
            remaining = deadline - time.monotonic()
            if remaining <= 0.0:
                break
            try:
                items.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return items

    @staticmethod
    def _resolve(pairs, results) -> None:
        for (item, fut), r in zip(pairs, results):
            if not fut.done():
                fut.set_result(r)

    @staticmethod
    def _fail(pairs, exc) -> None:
        for item, fut in pairs:
            if not fut.done():
                fut.set_exception(exc)

    def _after_batch(self, n: int) -> None:
        """Hook called after a fused step's results are resolved (the
        dispatcher's periodic device_sync cadence lives here)."""

    def _run(self) -> None:
        reg = self._registry
        stop = False
        while not stop:
            items = self._gather()
            batch, barriers = [], []
            for item, fut in items:
                if item is _STOP:
                    stop = True
                elif item is _BARRIER:
                    barriers.append(fut)
                else:
                    batch.append((item, fut))
            try:
                if batch:
                    reg.observe_value(f"batch.{self.name}.size", len(batch))
                    with reg.time(f"batch.{self.name}.step"):
                        results = self._execute([i for i, _ in batch])
                    self._resolve(batch, results)
                    self._after_batch(len(batch))
                self.controller.observe(len(batch), self._q.qsize())
            except BaseException as e:  # noqa: BLE001 - relay to the callers
                log.warning("coalesced %s step failed: %s", self.name, e,
                            exc_info=True)
                self._fail(batch, e)
            finally:
                for fut in barriers:   # resolve AFTER the preceding batch
                    if not fut.done():
                        fut.set_result(None)


class InlineCoalescer:
    """Synchronous coalescer for inline (uniprocessor) mode.

    Same policy as RequestCoalescer — coalesce same-method requests,
    one fused call, FIFO result splitting, identical stats — but driven
    by its caller (the event loop) instead of a thread: offer() queues a
    raw frame, drain() executes everything pending as ONE call.  A
    method change refuses the offer so the caller can drain first
    (per-connection wire order is the barrier discipline).
    """

    def __init__(self, batch_fns: Dict[str, Callable],
                 registry: "_metrics.Registry" = None,
                 max_batch: int = 0):
        self._fns = batch_fns
        self._registry = registry if registry is not None else _metrics.GLOBAL
        # 0 = bounded only by the read burst; clamped so a negative knob
        # cannot make offer() refuse forever (dropped frames = a client
        # waiting on a reply that never comes)
        self.max_batch = max(0, int(max_batch))
        self._frames: List[Tuple[Any, bytes, int]] = []
        self._method = ""

    def __len__(self) -> int:
        return len(self._frames)

    def offer(self, name: str, msgid, msg: bytes, params_off: int) -> bool:
        """Queue one raw frame for the pending fused call.  Returns False
        (frame NOT queued) when the caller must drain() first: no batch
        handler for `name`, a different method pending, or the batch is
        full."""
        if name not in self._fns:
            return False
        if self._method and self._method != name:
            return False
        if self.max_batch and len(self._frames) >= self.max_batch:
            return False
        self._method = name
        self._frames.append((msgid, msg, params_off))
        return True

    def drain(self):
        """Execute the pending frames as one fused call.

        Returns None when nothing is pending, else
        (method, frames, results, error): `frames` is the FIFO
        [(msgid, msg, off), ...] list, `results` aligns with it
        (None when `error` is set).  Exceptions are captured, not
        raised — the caller owns the wire-error replies."""
        if not self._frames:
            return None
        name, todo = self._method, self._frames
        self._frames, self._method = [], ""
        fn = self._fns[name]
        reg = self._registry
        reg.observe_value(f"batch.{name}.size", len(todo))
        results = err = None
        t0 = time.perf_counter()
        try:
            with reg.time(f"batch.{name}.step"):
                results = fn([(m, o) for _, m, o in todo])
        except Exception as e:  # noqa: BLE001 - relayed via the return value
            err = e
        finally:
            # request latency incl. coalesce — the per-RPC timing metric
            reg.observe(f"rpc.{name}", time.perf_counter() - t0)
        return name, todo, results, err
