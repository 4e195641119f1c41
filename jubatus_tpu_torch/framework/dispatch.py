"""The device-dispatch threads of the raw train path (counterpart of
jubatus_tpu/framework/dispatch.py, IngestPipeline).

Raw train frames go straight to a CONVERT thread, which converts a whole
window in one GIL-released C call into a recycled arena
(batching/arenas.py); a DISPATCH thread runs one fused device step per
window.  So steps stay back to back whatever the number of RPC workers
feeding them, and the RPC reader never waits on the device.

Semantics: a request is acked only after the step holding it has been
dispatched (issued to the device stream; the stream executes steps in
order, so a later read sees every acked train).  Order across requests
is FIFO.  Paths that change the model outside these queues must call
flush() BEFORE taking the model lock — never while holding it, or they
deadlock against the dispatch thread acquiring that lock; flush() raises
LockDisciplineError when the calling thread holds either side.

The JAX package's TrainDispatcher (per-request conversion on the RPC
workers), tracer spans, journal records, tenant quotas and metrics
registry have no counterpart yet; the places where the hooks go are
marked.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future

from jubatus_tpu_torch.batching import WindowController
from jubatus_tpu_torch.utils.rwlock import LockDisciplineError

log = logging.getLogger("jubatus_tpu_torch.dispatch")


def _check_flush_lock_discipline(server, who: str) -> None:
    """The flush()-before-model-lock rule, enforced: the dispatch thread
    needs the model write lock to drain, so a flush() issued while the
    calling thread holds either side of that lock can never complete."""
    lock = getattr(server, "model_lock", None)
    if lock is None:
        return
    if lock.write_held_by_me():
        raise LockDisciplineError(
            f"flush() while holding the model write lock: the {who} "
            "dispatch thread needs that lock to drain the queue — call "
            "flush() BEFORE locking (framework/dispatch.py)")
    if lock.read_held_by_me():
        raise LockDisciplineError(
            f"flush() while holding the model read lock: the {who} "
            "dispatch thread's write acquire waits for this reader, "
            "which is blocked in flush() — call flush() BEFORE locking "
            "(framework/dispatch.py)")


_STOP = object()
_BARRIER = object()


class IngestPipeline:
    """The native batched ingest pipeline: decode -> convert -> dispatch
    across dedicated threads with bounded hand-off queues.

    The RPC reader frames messages with the native FrameSplitter and
    submits raw train frames here; the CONVERT thread gathers a window
    (an adaptive linger, batching/controller.py) and converts it in ONE C
    call into an arena from the driver's pool; the DISPATCH thread
    runs one fused step per window under the model write lock.  The
    bounded convert->dispatch queue (DEPTH) is what pipelines: window
    W+1 converts while window W's step runs.  When it fills, the convert
    thread waits (counted in `stalls`), and backpressure reaches the RPC
    workers through the bounded frame queue.

    The periodic device_sync (every SYNC_EVERY steps) bounds the device
    backlog and is the fence after which consumed arenas go back to the
    pool: a pinned arena's copy to the card is asynchronous, so it may
    not be rewritten before then.  `windows` and `frames` count the
    converted windows and the frames in them.
    """

    # the JAX server's defaults (--batch_max, --batch_window_us,
    # --ingest_depth); the port's server has no knobs for them yet
    # at most this many queued frames as one window
    MAX_COALESCE = 16
    # adaptive linger ceiling: 0 at low load, up to this under pressure
    MAX_WAIT_S = 0.002
    # converted windows waiting for the dispatch stage
    DEPTH = 2
    # a device_sync at least every N fused steps: bounds the queued device
    # backlog without a blocking round trip per request, and fences arenas
    SYNC_EVERY = 4
    QUEUE_SIZE = 128             # frames waiting for the convert stage

    def __init__(self, server):
        self._server = server
        self.controller = WindowController(
            max_wait_s=self.MAX_WAIT_S,
            target_batch=max(2, self.MAX_COALESCE // 2))
        self._q: "queue.Queue" = queue.Queue(self.QUEUE_SIZE)
        self._dq: "queue.Queue" = queue.Queue(self.DEPTH)  # converted
        self._ops_since_sync = 0
        self._spent_arenas = []      # consumed, awaiting the sync fence
        self.stalls = 0              # convert thread waited on dispatch
        self.windows = 0             # windows converted
        self.frames = 0              # frames in them
        self._convert_thread = threading.Thread(
            target=self._convert_loop, daemon=True, name="ingest-convert")
        self._dispatch_thread = threading.Thread(
            target=self._dispatch_loop, daemon=True, name="ingest-dispatch")
        self._convert_thread.start()
        self._dispatch_thread.start()

    # -- producer side (RPC workers) ----------------------------------------

    def submit(self, msg: bytes, params_off: int) -> Future:
        """Enqueue one raw train frame; the Future resolves with the
        request's result once the fused step holding it has been
        dispatched.  Blocks while the pipeline is saturated."""
        fut: Future = Future()
        self._q.put(((msg, params_off), fut))
        return fut

    def flush(self) -> None:
        """FIFO barrier through BOTH stages: wait until every frame
        enqueued before this call has been converted AND dispatched.
        Never call while holding the model lock (either side)."""
        _check_flush_lock_discipline(self._server, "ingest")
        fut: Future = Future()
        self._q.put((_BARRIER, fut))
        fut.result(timeout=600)

    def stop(self) -> None:
        self._q.put((_STOP, None))
        self._convert_thread.join(timeout=10)
        self._dispatch_thread.join(timeout=10)
        for q in (self._q, self._dq):
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                futs = ()
                if q is self._q and item[1] is not None:
                    futs = (item[1],)
                elif q is self._dq and item[0] == "batch":
                    futs = item[2]
                elif q is self._dq and item[0] == "legacy":
                    futs = [t[3] for t in item[1]]
                elif q is self._dq and item[0] == "barrier":
                    futs = (item[1],)
                for f in futs:
                    if f is not None and not f.done():
                        f.set_exception(RuntimeError("server stopping"))

    # -- convert stage -------------------------------------------------------

    def _gather(self) -> list:
        """One blocking get, drain everything queued, linger up to the
        controller's window while the batch is small (a barrier or stop in
        hand cancels the linger).  While the hand-off queue is full the
        device stage is still busy: keep WIDENING the current window
        rather than converting a narrow one that would only wait."""
        items = [self._q.get()]
        deadline = 0.0
        window = self.controller.wait_s
        while len(items) < self.MAX_COALESCE:
            tail_ctl = items[-1][0] is _STOP or items[-1][0] is _BARRIER
            if tail_ctl:
                window = 0.0
            try:
                items.append(self._q.get_nowait())
                continue
            except queue.Empty:
                pass
            if not tail_ctl and self._dq.full():
                try:
                    items.append(self._q.get(timeout=0.002))
                    continue
                except queue.Empty:
                    continue            # re-check: dispatch may have drained
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

    def _dq_put(self, item) -> None:
        if self._dq.full():
            self.stalls += 1      # the device stage is the bottleneck now
        self._dq.put(item)

    def _convert_window(self, batch) -> None:
        """Convert one gathered window in a single native call and hand
        the fused batch to the dispatch stage.  A failing batch convert
        (a malformed frame) falls back to per-frame conversion, so one bad
        request fails ITS caller, not the whole window."""
        drv = self._server.driver
        frames = [f for f, _ in batch]
        futs = [fut for _, fut in batch]
        try:
            with drv.convert_lock:
                try:
                    rb = drv.convert_raw_batch(frames)
                except Exception:
                    log.warning("batched convert failed; converting the "
                                "window frame by frame", exc_info=True)
                    rb = None
                if rb is None:
                    convs = []
                    for (m, o), fut in batch:
                        try:
                            convs.append((drv.convert_raw_request(m, o),
                                          m, o, fut))
                        except Exception as e:  # noqa: BLE001 - per caller
                            fut.set_exception(e)
                    self._dq_put(("legacy", convs, None))
                    return
            self._dq_put(("batch", rb, futs))
        except BaseException as e:  # noqa: BLE001 - relay to the callers
            log.warning("ingest convert stage failed: %s", e, exc_info=True)
            for f in futs:
                if not f.done():
                    f.set_exception(e)

    def _convert_loop(self) -> None:
        stop = False
        while not stop:
            items = self._gather()
            batch, trailing = [], []
            for item, fut in items:
                if item is _STOP:
                    stop = True
                elif item is _BARRIER:
                    trailing.append(fut)
                else:
                    batch.append((item, fut))
            if batch:
                self.windows += 1
                self.frames += len(batch)
                self._convert_window(batch)
                self.controller.observe(len(batch), self._q.qsize())
            for fut in trailing:
                self._dq_put(("barrier", fut, None))
        self._dq_put(("stop", None, None))

    # -- dispatch stage ------------------------------------------------------

    def _fused_step(self, futs, run) -> None:
        """One write-lock hold, one device step (`run`), FIFO acks — for
        both the batched and the per-frame dispatch routes."""
        slot = self._server
        try:
            # the journal's write check and the train.step span go here
            with slot.model_lock.write():
                results = run()
                for _ in futs:
                    slot.event_model_updated()
                # the journal record of the fused step goes here
            for f, r in zip(futs, results):
                if not f.done():
                    f.set_result(r)
        except BaseException as e:  # noqa: BLE001 - relay to the callers
            log.warning("ingest dispatch step failed: %s", e, exc_info=True)
            for f in futs:
                if not f.done():
                    f.set_exception(e)

    def _dispatch_batch(self, rb, futs) -> None:
        """Fused step over a native batch; the consumed arena joins the
        list recycled at the next sync fence."""
        try:
            self._fused_step(
                futs, lambda: self._server.driver.train_converted_batch(rb))
        finally:
            if rb.arena is not None:
                self._spent_arenas.append(rb.arena)
                rb.arena = None

    def _dispatch_legacy(self, convs) -> None:
        """Per-frame route (the batched convert failed): the same fused
        step over individually converted frames."""
        self._fused_step(
            [f for _, _, _, f in convs],
            lambda: self._server.driver.train_converted_many(
                [c for c, _, _, _ in convs]))

    def _after_batch(self) -> None:
        # the sync every SYNC_EVERY steps bounds the queued device backlog
        # and fences the copies out of the spent arenas: only after it may
        # they be rewritten
        self._ops_since_sync += 1
        if self._ops_since_sync >= self.SYNC_EVERY:
            self._server.driver.device_sync()
            self._ops_since_sync = 0
            spent, self._spent_arenas = self._spent_arenas, []
            pool = self._server.driver.arena_pool
            for arena in spent:
                pool.release(arena)

    def _dispatch_loop(self) -> None:
        while True:
            kind, a, b = self._dq.get()
            if kind == "stop":
                return
            if kind == "barrier":
                if not a.done():
                    a.set_result(None)
                continue
            if kind == "batch":
                self._dispatch_batch(a, b)
            elif a:                     # "legacy"
                self._dispatch_legacy(a)
            try:
                self._after_batch()
            except BaseException:  # noqa: BLE001 - keep the thread alive
                # device_sync surfaces ASYNC errors of earlier steps whose
                # futures are already resolved: log, as the JAX server
                # does (a dead dispatch thread would hang every later
                # train).  A CUDA error is sticky: the next step fails too.
                log.warning("ingest post-batch sync failed", exc_info=True)
