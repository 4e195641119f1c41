"""The device-dispatch threads of the raw train path and the read lane
(counterpart of jubatus_tpu/framework/dispatch.py: TrainDispatcher,
IngestPipeline and ReadDispatcher).

Two threaded train routes (the server's --ingest_depth picks one):
  * IngestPipeline (depth > 0, the default): raw train frames go straight
    to a CONVERT thread, which converts a whole window in one
    GIL-released C call into a recycled arena (batching/arenas.py); a
    DISPATCH thread runs one fused device step per window.
  * TrainDispatcher (--ingest_depth 0): each request is converted on its
    RPC worker under the driver's convert_lock, and one dispatch thread
    (batching/coalescer.py RequestCoalescer) runs the coalesced requests
    as one fused step; with --batch_max 1 --batch_window_us 0 that is one
    step a request, the per-request route.
Either way the steps stay back to back whatever the number of RPC
workers feeding them, and the RPC reader never waits on the device.

Semantics: a request is acked only after the step holding it has been
dispatched (issued to the device stream; the stream executes steps in
order, so a later read sees every acked train) and, with a journal,
after the window's record is committed.  Order across requests is FIFO.
Paths that change the model outside these queues must call flush()
BEFORE taking the model lock — never while holding it, or they deadlock
against the dispatch thread acquiring that lock; flush() raises
LockDisciplineError when the calling thread holds either side.

The read lane (ReadDispatcher, --read_batch_window_us) gathers
concurrent reads of one method into one read-lock hold and one fused
sweep.

Tracing (obs/trace.py): each fused train step is one `train.step` span
(width `n`, `lock_wait_s`, `dispatch_s`, `journal_s`), each converted
window one `ingest.convert` span, each read sweep one
`read.sweep.<method>` span (`n`, `lock_wait_s`, `device_s`).  Every one
ends on the host clock: a train step's kernel is only enqueued when its
span ends (the route acks after the dispatch, and the periodic
device_sync every SYNC_EVERY steps is the only wait for the card), so
`dispatch_s` is the enqueue; a sweep's span ends after its answers were
copied to the host, so `device_s` covers the card's work.
`--torch_profile` gives the card's own times.  The series:
`batch.train.size`/`batch.train.step` (both routes), `ingest.convert`,
`convert_lock_wait`, `ingest_pipeline_stall_total`,
`ingest_pipeline_depth`, `device_step` (the periodic sync), and the read
lane's `read_batch_size`, `read_lock_wait`, `read_coalesced_total`.
Each model slot has its own dispatcher and read lane (the server passes
the slot); a raw frame's tenant quota is charged before it is submitted
(framework/service.py).  Heat accounting is ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future

from jubatus_tpu_torch.batching import (FixedWindow, RequestCoalescer,
                                        WindowController)
from jubatus_tpu_torch.durability.journal import check_writable
from jubatus_tpu_torch.obs.trace import TRACER as _tracer
from jubatus_tpu_torch.utils import metrics as _metrics
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


class TrainDispatcher(RequestCoalescer):
    """The per-request raw train route (--ingest_depth 0).

    RPC workers convert each request under the driver's convert_lock
    (stage 1, without the model lock, overlapping earlier steps) and
    submit (conv, msg, params_off); the dispatch thread runs the drained
    requests as ONE fused step (train_converted_many) under the model
    write lock, journals them as ONE `train` record of their raw frames
    and acks them in FIFO order once the step was dispatched.  The
    window (--batch_window_us) and the width bound (--batch_max) are
    RequestCoalescer's; flush() enforces the flush()-before-model-lock
    rule."""

    # the JAX server's defaults: --batch_max, --batch_window_us
    MAX_COALESCE = 16
    # raw_train hands it stage-1 conversions, not undecoded frames
    accepts_raw_frames = False
    MAX_WAIT_S = 0.002
    # a device_sync at least every N fused steps (see IngestPipeline)
    SYNC_EVERY = 4

    def __init__(self, server, maxsize: int = 32, max_batch: int = None,
                 max_wait_s: float = None):
        self._server = server
        self._ops_since_sync = 0
        super().__init__(
            self._execute_batch, name="train", maxsize=maxsize,
            max_batch=self.MAX_COALESCE if max_batch is None else max_batch,
            max_wait_s=self.MAX_WAIT_S if max_wait_s is None else max_wait_s)

    def flush(self) -> None:
        """FIFO barrier, with the locking rule enforced."""
        _check_flush_lock_discipline(self._server, "train")
        super().flush()

    def _execute_batch(self, items) -> list:
        """One write-lock hold, one fused device step, one journal
        record.  Items of the raw route are (conv, msg, params_off)
        triples, so the batch journals its raw frames (recovery
        re-converts them into the same step); plain conversions journal
        nothing.  Its `train.step` span ends at the dispatch (the module
        docstring)."""
        slot = self._server
        convs, frames = [], []
        for it in items:
            if type(it) is tuple and len(it) == 3:
                convs.append(it[0])
                frames.append([bytes(it[1]), int(it[2])])
            else:
                convs.append(it)
        journal = getattr(slot, "journal", None)
        span = _tracer.start("train.step") if _tracer.enabled else None
        t0 = time.monotonic() if span is not None else 0.0
        try:
            # fail-stop gate: a stalled journal rejects the batch before
            # the model mutates
            check_writable(journal)
            with slot.model_lock.write():
                if span is not None:
                    t1 = time.monotonic()
                    span.tag("lock_wait_s", round(t1 - t0, 6))
                results = slot.driver.train_converted_many(convs)
                for _ in convs:
                    slot.event_model_updated()
                if span is not None:
                    span.tag("dispatch_s", round(time.monotonic() - t1, 6))
                if journal is not None and frames:
                    journal.append({"k": "train", "f": frames},
                                   slot.current_mix_round())
            if journal is not None and frames:
                t2 = time.monotonic() if span is not None else 0.0
                journal.commit()
                if span is not None:
                    span.tag("journal_s", round(time.monotonic() - t2, 6))
            return results
        except BaseException as e:
            if span is not None:
                span.tag("error", str(e))
            raise
        finally:
            if span is not None:
                span.tag("n", len(convs))
                _tracer.finish(span)

    def _after_batch(self, n: int) -> None:
        # after the batch's futures resolved, so acks never wait on it
        self._ops_since_sync += 1
        if self._ops_since_sync >= self.SYNC_EVERY:
            with _metrics.GLOBAL.time("device_step"):
                self._server.driver.device_sync()
            self._ops_since_sync = 0


_STOP = object()
_BARRIER = object()


class IngestPipeline:
    """The native batched ingest pipeline: decode -> convert -> dispatch
    across dedicated threads with bounded hand-off queues.

    The RPC reader frames messages with the native FrameSplitter and
    submits raw train frames here; the CONVERT thread gathers a window
    (an adaptive linger, batching/controller.py) and converts it in ONE C
    call into an arena from the driver's pool; the DISPATCH thread
    runs one fused step per window under the model write lock, appends
    the window's raw frames to the journal as ONE `train` record under
    that lock, and commits it after releasing the lock, before any
    future of the window resolves.  The bounded convert->dispatch queue
    (DEPTH) is what pipelines: window W+1 converts while window W's step
    runs.  When it fills, the convert thread waits (counted in
    `stalls`), and backpressure reaches the RPC workers through the
    bounded frame queue.

    The periodic device_sync (every SYNC_EVERY steps) bounds the device
    backlog and is the fence after which consumed arenas go back to the
    pool: a pinned arena's copy to the card is asynchronous, so it may
    not be rewritten before then.  `windows` and `frames` count the
    converted windows and the frames in them.  `max_batch`, `max_wait_s`
    and `depth` are the server's --batch_max, --batch_window_us (in
    seconds) and --ingest_depth; each defaults to the class constant.
    """

    # the JAX server's defaults (--batch_max, --batch_window_us,
    # --ingest_depth):
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
    # raw_train hands it the undecoded frames
    accepts_raw_frames = True

    def __init__(self, server, max_batch: int = None,
                 max_wait_s: float = None, depth: int = None):
        self._server = server
        self._registry = _metrics.GLOBAL
        self.max_batch = max(1, int(self.MAX_COALESCE if max_batch is None
                                    else max_batch))
        wait = self.MAX_WAIT_S if max_wait_s is None else max_wait_s
        self.controller = (
            WindowController(max_wait_s=wait,
                             target_batch=max(2, self.max_batch // 2))
            if wait > 0 else FixedWindow(0.0))
        self.depth = max(1, int(self.DEPTH if depth is None else depth))
        self._q: "queue.Queue" = queue.Queue(self.QUEUE_SIZE)
        self._dq: "queue.Queue" = queue.Queue(self.depth)  # converted
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
        dispatched.  Blocks while the pipeline is saturated.  The
        caller's root span rides along, so the convert stage can tag the
        request's stage.convert_s."""
        root = _tracer.current() if _tracer.enabled else None
        fut: Future = Future()
        self._q.put(((msg, params_off, root), fut))
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
        while len(items) < self.max_batch:
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
            # the device stage is the bottleneck now
            self.stalls += 1
            self._registry.inc("ingest_pipeline_stall_total")
        self._dq.put(item)
        self._registry.set_gauge("ingest_pipeline_depth",
                                 float(self._dq.qsize()))

    def _convert_window(self, batch) -> None:
        """Convert one gathered window in a single native call and hand
        the fused batch to the dispatch stage.  A failing batch convert
        (a malformed frame) falls back to per-frame conversion, so one bad
        request fails ITS caller, not the whole window.  One `ingest.convert` span a
        window; every request's root span gets the window's convert time
        (lock wait included) as stage.convert_s."""
        drv = self._server.driver
        reg = self._registry
        frames = [(m, o) for (m, o, _r), _f in batch]
        roots = [r for (_m, _o, r), _f in batch]
        futs = [fut for _, fut in batch]
        span = _tracer.start("ingest.convert") if _tracer.enabled else None
        t0 = time.monotonic()

        def tag_roots():
            dt = round(time.monotonic() - t0, 6)
            for r in roots:
                if r is not None:
                    r.tag("stage.convert_s", dt)

        try:
            with drv.convert_lock:
                t1 = time.monotonic()
                reg.observe("convert_lock_wait", t1 - t0)
                try:
                    rb = drv.convert_raw_batch(frames)
                except Exception:
                    log.warning("batched convert failed; converting the "
                                "window frame by frame", exc_info=True)
                    rb = None
                if rb is None:
                    convs = []
                    for (m, o, _r), fut in batch:
                        try:
                            convs.append((drv.convert_raw_request(m, o),
                                          m, o, fut))
                        except Exception as e:  # noqa: BLE001 - per caller
                            fut.set_exception(e)
                    tag_roots()
                    self._dq_put(("legacy", convs, None))
                    return
            reg.observe("ingest.convert", time.monotonic() - t1)
            tag_roots()
            self._dq_put(("batch", rb, futs))
        except BaseException as e:  # noqa: BLE001 - relay to the callers
            log.warning("ingest convert stage failed: %s", e, exc_info=True)
            for f in futs:
                if not f.done():
                    f.set_exception(e)
        finally:
            if span is not None:
                span.tag("n", len(batch))
                span.tag("convert_s", round(time.monotonic() - t0, 6))
                _tracer.finish(span)

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

    def _fused_step(self, frames, futs, run) -> None:
        """One write-lock hold, one device step (`run`), one journal
        record, FIFO acks, one `train.step` span (ended at the dispatch:
        the module docstring) — for both the batched and the per-frame
        dispatch routes."""
        slot = self._server
        reg = self._registry
        journal = getattr(slot, "journal", None)
        span = _tracer.start("train.step") if _tracer.enabled else None
        t0 = time.monotonic() if span is not None else 0.0
        reg.observe_value("batch.train.size", len(futs))
        t_step = time.perf_counter()
        try:
            # fail-stop gate: a stalled journal rejects the window before
            # the model mutates
            check_writable(journal)
            with slot.model_lock.write():
                if span is not None:
                    t1 = time.monotonic()
                    span.tag("lock_wait_s", round(t1 - t0, 6))
                results = run()
                for _ in futs:
                    slot.event_model_updated()
                if span is not None:
                    span.tag("dispatch_s", round(time.monotonic() - t1, 6))
                if journal is not None and frames:
                    # the request bytes themselves: recovery re-converts
                    # them into the same fused step
                    journal.append(
                        {"k": "train",
                         "f": [[bytes(m), int(o)] for m, o in frames]},
                        slot.current_mix_round())
            if journal is not None and frames:
                # storage wait outside the lock; the acks wait for it
                t2 = time.monotonic() if span is not None else 0.0
                journal.commit()
                if span is not None:
                    span.tag("journal_s", round(time.monotonic() - t2, 6))
            for f, r in zip(futs, results):
                if not f.done():
                    f.set_result(r)
        except BaseException as e:  # noqa: BLE001 - relay to the callers
            if span is not None:
                span.tag("error", str(e))
            log.warning("ingest dispatch step failed: %s", e, exc_info=True)
            for f in futs:
                if not f.done():
                    f.set_exception(e)
        finally:
            reg.observe("batch.train.step", time.perf_counter() - t_step)
            if span is not None:
                span.tag("n", len(futs))
                _tracer.finish(span)

    def _dispatch_batch(self, rb, futs) -> None:
        """Fused step over a native batch; the consumed arena joins the
        list recycled at the next sync fence."""
        try:
            self._fused_step(
                rb.frames, futs,
                lambda: self._server.driver.train_converted_batch(rb))
        finally:
            if rb.arena is not None:
                self._spent_arenas.append(rb.arena)
                rb.arena = None

    def _dispatch_legacy(self, convs) -> None:
        """Per-frame route (the batched convert failed): the same fused
        step over individually converted frames."""
        self._fused_step(
            [(m, o) for _, m, o, _ in convs],
            [f for _, _, _, f in convs],
            lambda: self._server.driver.train_converted_many(
                [c for c, _, _, _ in convs]))

    def _after_batch(self) -> None:
        # the sync every SYNC_EVERY steps bounds the queued device backlog
        # and fences the copies out of the spent arenas: only after it may
        # they be rewritten
        self._ops_since_sync += 1
        if self._ops_since_sync >= self.SYNC_EVERY:
            with _metrics.GLOBAL.time("device_step"):
                self._server.driver.device_sync()
            self._ops_since_sync = 0
            spent, self._spent_arenas = self._spent_arenas, []
            pool = self._server.driver.arena_pool
            for arena in spent:
                pool.release(arena)

    def _dispatch_loop(self) -> None:
        while True:
            kind, a, b = self._dq.get()
            self._registry.set_gauge("ingest_pipeline_depth",
                                     float(self._dq.qsize()))
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


class _Failure:
    """Per-request error marker riding a fused read sweep's result list
    (a raised exception would fail every caller in the sweep)."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class ReadDispatcher:
    """The read lane (--read_batch_window_us).

    Without it every read RPC pays its own convert, host->device copy,
    sweep and readback under its own read-lock hold, so N concurrent
    classify calls cost N sweeps of one datum.  Here concurrent reads of
    the SAME method are gathered for up to the window (adaptively, as
    the ingest pipeline lingers), executed as ONE fused sweep (the
    Method's `many` entry, e.g. driver.classify_many over the
    concatenation) under ONE read-lock hold, and split back per caller.

    One RequestCoalescer per method name, made at its first read.  Reads
    never call flush(), so the lane thread only ever holds the read lock
    while it runs driver code.  Window 0 builds no lane
    (setup_slot_pipelines).  Each sweep records `read_batch_size` (its
    width), `read_lock_wait` and, through the coalescer,
    `batch.read.<method>.size`, and with the tracer on one
    `read.sweep.<method>` span.  Left out of the JAX class: the heat
    accounting of the lock wait (ROADMAP Queue 1 item 7) and the
    candidate-index tags of the span.
    """

    MAX_COALESCE = 64    # fused sweep width bound (padding stays sane)
    QUEUE_SIZE = 128     # reads waiting for a lane

    def __init__(self, server, window_us: float,
                 registry: "_metrics.Registry" = None):
        self._server = server
        self.window_s = max(0.0, float(window_us)) / 1e6
        self._registry = registry if registry is not None else _metrics.GLOBAL
        self._lanes = {}
        self._lock = threading.Lock()

    def _lane(self, m) -> RequestCoalescer:
        lane = self._lanes.get(m.name)
        if lane is None:
            with self._lock:
                lane = self._lanes.get(m.name)
                if lane is None:
                    lane = RequestCoalescer(
                        lambda items, _m=m: self._execute(_m, items),
                        name=f"read.{m.name}", maxsize=self.QUEUE_SIZE,
                        max_batch=self.MAX_COALESCE,
                        max_wait_s=self.window_s, registry=self._registry)
                    self._lanes[m.name] = lane
        return lane

    def submit(self, m, args: tuple) -> Future:
        """Queue one read on its method's lane; the Future resolves with
        this caller's result once its fused sweep has run.  A per-request
        failure (a malformed datum) raises from it, for its own caller
        only.  The RPC loop awaits the Future without blocking, so reads
        of other connections join the sweep meanwhile."""
        out: Future = Future()

        def done(f: Future) -> None:
            try:
                r = f.result()
            except BaseException as e:  # noqa: BLE001 - to this caller
                out.set_exception(e)
                return
            if isinstance(r, _Failure):
                out.set_exception(r.exc)
            else:
                out.set_result(r)

        self._lane(m).submit(tuple(args)).add_done_callback(done)
        return out

    def _execute(self, m, items) -> list:
        """One read-lock hold, one fused sweep, split per caller.  A fused
        sweep that raises falls back to the per-item loop inside the same
        hold, so one bad request fails ITS caller instead of every one
        coalesced with it."""
        slot = self._server
        reg = self._registry
        # one span a fused sweep: its width, lock wait and device time
        # (the answers are host values, so the card's work is in it)
        span = _tracer.start(f"read.sweep.{m.name}") \
            if _tracer.enabled else None
        t0 = time.monotonic()
        t1 = t0
        try:
            with slot.model_lock.read():
                t1 = time.monotonic()
                results = None
                if m.many is not None:
                    try:
                        results = m.many(slot, list(items))
                    except Exception as e:
                        if len(items) == 1:
                            if span is not None:
                                span.tag("error", str(e))
                            raise    # sole caller: the normal error path
                        log.warning("fused %s sweep failed; isolating via "
                                    "per-item fallback", m.name,
                                    exc_info=True)
                if results is None:
                    results = []
                    for a in items:
                        try:
                            results.append(m.fn(slot, *a))
                        except Exception as e:  # noqa: BLE001 - per caller
                            results.append(_Failure(e))
            if len(items) > 1:
                # requests that shared a sweep with another caller
                reg.inc("read_coalesced_total", len(items))
            reg.observe_value("read_batch_size", len(items))
            # the queue an operator cannot otherwise see: a long train
            # step holds every read behind one acquire
            reg.observe("read_lock_wait", t1 - t0)
            return results
        finally:
            if span is not None:
                span.tag("n", len(items))
                span.tag("lock_wait_s", round(t1 - t0, 6))
                span.tag("device_s", round(time.monotonic() - t1, 6))
                _tracer.finish(span)

    def stop(self) -> None:
        with self._lock:
            lanes, self._lanes = list(self._lanes.values()), {}
        for lane in lanes:
            lane.stop()
