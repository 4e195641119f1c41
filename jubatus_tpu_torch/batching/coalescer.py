"""Request coalescer: concurrent RPC calls -> fused device steps
(counterpart of jubatus_tpu/batching/coalescer.py, RequestCoalescer).

One queue and one dispatch thread.  The thread
  (a) drains every request queued in one gather,
  (b) lingers an adaptive window (controller.py) for more when load
      warrants, and not at all at low load,
  (c) hands the whole set to ONE fused `execute`,
  (d) splits the results back per request in FIFO order.

The read lane (framework/dispatch.py ReadDispatcher) rides on this, one
coalescer per read method.  It records `batch.<name>.size` (the
coalesce width) and `batch.<name>.step` (the fused step's time) into
utils/metrics.py.  The JAX package's InlineCoalescer (inline dispatch)
is later work.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable

from jubatus_tpu_torch.batching.controller import FixedWindow, WindowController
from jubatus_tpu_torch.utils import metrics as _metrics

log = logging.getLogger("jubatus_tpu_torch.batching")

_STOP = object()


class RequestCoalescer:
    """Queue-fed coalescing engine with one dedicated dispatch thread.

    `execute(items) -> [result, ...]` is the fused step, called with
    every drained payload in FIFO order; it returns one result per item.
    """

    def __init__(self, execute: Callable[[list], list], *, name: str,
                 maxsize: int, max_batch: int, max_wait_s: float,
                 registry: "_metrics.Registry" = None):
        self._execute = execute
        self.name = name
        self.max_batch = max(1, int(max_batch))
        self.controller = (
            WindowController(max_wait_s=max_wait_s,
                             target_batch=max(2, self.max_batch // 2))
            if max_wait_s > 0 else FixedWindow(0.0))
        self._registry = registry if registry is not None else _metrics.GLOBAL
        self._q: "queue.Queue" = queue.Queue(maxsize)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"coalesce-{name}")
        self._thread.start()

    # -- producer side ------------------------------------------------------

    def submit(self, item) -> Future:
        """Enqueue a payload; the Future resolves with its own result once
        the fused step holding it has run.  Blocks while the bounded
        queue is full (backpressure to the RPC workers)."""
        fut: Future = Future()
        self._q.put((item, fut))
        return fut

    def stop(self) -> None:
        self._q.put((_STOP, None))
        self._thread.join(timeout=10)
        # fail what is still queued, so no caller waits through shutdown
        while True:
            try:
                _item, fut = self._q.get_nowait()
            except queue.Empty:
                break
            if fut is not None and not fut.done():
                fut.set_exception(RuntimeError("server stopping"))

    # -- dispatch thread ----------------------------------------------------

    def _gather(self) -> list:
        """One blocking get, then drain everything queued; linger up to
        the controller's window while the batch is small.  A stop in
        hand cancels the linger."""
        items = [self._q.get()]
        deadline = 0.0
        window = self.controller.wait_s
        while len(items) < self.max_batch:
            if items[-1][0] is _STOP:
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

    def _run(self) -> None:
        reg = self._registry
        stop = False
        while not stop:
            items = self._gather()
            batch = []
            for item, fut in items:
                if item is _STOP:
                    stop = True
                else:
                    batch.append((item, fut))
            try:
                if batch:
                    reg.observe_value(f"batch.{self.name}.size", len(batch))
                    with reg.time(f"batch.{self.name}.step"):
                        results = self._execute([i for i, _ in batch])
                    for (_item, fut), r in zip(batch, results):
                        if not fut.done():
                            fut.set_result(r)
                self.controller.observe(len(batch), self._q.qsize())
            except BaseException as e:  # noqa: BLE001 - relay to the callers
                log.warning("coalesced %s step failed: %s", self.name, e,
                            exc_info=True)
                for _item, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
