"""Low-overhead request-scoped span recorder (the port's copy of
jubatus_tpu/obs/trace.py).

Finished spans go into a bounded ring (deque(maxlen=ring)): O(1) memory,
recording is an append.  Disabled is the default: `TRACER.enabled` is a
single attribute check, `start()` returns None and `span()` yields one
shared null object, so the disabled hot path allocates no spans.  The
active span rides a ContextVar, so nested stages and log records
(utils/logger.py's JSON format) join on its trace id; work that hops a
thread re-attaches the span explicitly with `attach()` (the RPC call
pools, the ingest pipeline's threads).

Timing: CUDA work is asynchronous, so a host clock around a kernel
launch measures the enqueue, not the card's work.  A span that ends
after a host copy of device results (a read sweep's answers) covers the
device time; a train span ends at the dispatch and names its tag
`dispatch_s` for that reason.  `--torch_profile DIR` captures the
device truth (utils/metrics.py start_profiler).

MIX legs are recorded with (round, peer) tags and the round rides the
RPC frame, so one MIX round can be stitched across nodes from each
node's `get_traces` dump.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import logging
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

_slowlog = logging.getLogger("jubatus_tpu_torch.slowop")

# the active span for THIS execution context (logger + nested stages join
# on it); plain threads each see their own context, so attach() is needed
# only when work hops threads mid-request
_current: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "jubatus_span", default=None)


class Span:
    """One finished-or-running span.  `tags` carries the per-stage
    breakdown (`stage.*_s`) and correlation keys (`mix_round`, `peer`)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id",
                 "ts", "t0", "t1", "tags")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: Optional[str]):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.ts = time.time()          # wall clock: cross-node ordering
        self.t0 = time.monotonic()     # monotonic: duration
        self.t1 = 0.0
        self.tags: Dict[str, Any] = {}

    def tag(self, key: str, value) -> "Span":
        self.tags[key] = value
        return self

    @property
    def duration_s(self) -> float:
        return (self.t1 or time.monotonic()) - self.t0

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "ts": round(self.ts, 6),
                "duration_s": round(self.duration_s, 6),
                "tags": dict(self.tags)}


class _NullSpan:
    """The shared do-nothing span the disabled path hands out: tag() is
    a no-op, truthiness is False so `if span:` guards work, and being a
    singleton means the no-op path allocates nothing."""

    __slots__ = ()
    name = ""
    trace_id = ""
    span_id = ""
    parent_id = None
    tags: Dict[str, Any] = {}
    duration_s = 0.0

    def tag(self, key: str, value) -> "_NullSpan":
        return self

    def to_dict(self) -> Dict[str, Any]:
        return {}

    def __bool__(self) -> bool:
        return False


NULL_SPAN = _NullSpan()


class Tracer:
    """Process-global span recorder.  Disabled (ring 0, slow-op off) by
    default; `configure()` is called by the CLIs from `--trace_ring` /
    `--slow_op_ms` and is idempotent."""

    def __init__(self):
        self.enabled = False
        self.ring_size = 0
        self.slow_op_s = 0.0
        self._ring: deque = deque(maxlen=0)
        self._lock = threading.Lock()
        # trace ids: process-random prefix + counter — unique across the
        # cluster's dumps without per-span urandom cost
        self._prefix = os.urandom(4).hex()
        self._ids = itertools.count(1)

    # -- configuration -------------------------------------------------------

    def configure(self, ring: int = 0, slow_op_ms: float = 0.0) -> None:
        """Enable span recording (ring > 0 retains that many finished
        spans) and/or the slow-op log (slow_op_ms > 0).  Both 0 disables
        the plane entirely — the shipped default."""
        ring = max(0, int(ring))
        self.slow_op_s = max(0.0, float(slow_op_ms)) / 1e3
        with self._lock:
            self._ring = deque(self._ring, maxlen=ring)
        self.ring_size = ring
        self.enabled = ring > 0 or self.slow_op_s > 0

    # -- span lifecycle ------------------------------------------------------

    def _next_id(self) -> str:
        return f"{self._prefix}-{next(self._ids)}"

    def start(self, name: str, parent: Optional[Span] = None) -> Optional[Span]:
        """Begin a span (None when disabled — callers on hot paths guard
        with `tracer.enabled` so the disabled cost is one attribute
        check).  With no explicit parent the context's current span is
        the parent; a parentless span is a ROOT (slow-op eligible)."""
        if not self.enabled:
            return None
        if parent is None:
            parent = _current.get()
        sid = self._next_id()
        if parent is not None and parent:
            return Span(name, parent.trace_id, sid, parent.span_id)
        return Span(name, sid, sid, None)

    def finish(self, span: Optional[Span]) -> None:
        if span is None or not span:
            return
        span.t1 = time.monotonic()
        with self._lock:
            self._ring.append(span)
        if (self.slow_op_s and span.parent_id is None
                and span.duration_s >= self.slow_op_s):
            # one structured line per over-threshold request, carrying
            # the per-stage breakdown; joins ordinary logs on trace_id
            # (utils/logger.py --log_format json injects the same key)
            _slowlog.warning("slow_op %s", json.dumps(
                {"name": span.name, "ms": round(span.duration_s * 1e3, 3),
                 "trace_id": span.trace_id, "span_id": span.span_id,
                 "tags": span.tags}, default=str, sort_keys=True))

    def record(self, name: str, seconds: float, **tags) -> None:
        """Append an already-timed span (MIX fan-out legs, proxy
        forwards): the caller measured `seconds` itself."""
        if not self.enabled:
            return
        sid = self._next_id()
        span = Span(name, sid, sid, None)
        now = time.monotonic()
        span.t0, span.t1 = now - seconds, now
        span.ts = time.time() - seconds
        span.tags.update(tags)
        with self._lock:
            self._ring.append(span)

    # -- context propagation -------------------------------------------------

    @contextmanager
    def span(self, name: str, **tags):
        """Start a span as the context's current (children nest under
        it), finish on exit.  Yields NULL_SPAN when disabled so callers
        can `sp.tag(...)` unguarded on cold paths."""
        sp = self.start(name)
        if sp is None:
            yield NULL_SPAN
            return
        sp.tags.update(tags)
        token = _current.set(sp)
        try:
            yield sp
        finally:
            _current.reset(token)
            self.finish(sp)

    @contextmanager
    def attach(self, span: Optional[Span]):
        """Make an EXISTING span current in this thread/context — the
        cross-thread handoff (RPC executor closure runs the handler under
        the root span the event loop started)."""
        if span is None or not span:
            yield span
            return
        token = _current.set(span)
        try:
            yield span
        finally:
            _current.reset(token)

    def current(self) -> Optional[Span]:
        return _current.get()

    def tag_current(self, key: str, value) -> None:
        """Tag the context's active span; silently a no-op with no span
        active (disabled plane, untraced entry point)."""
        sp = _current.get()
        if sp is not None and sp:
            sp.tag(key, value)

    # -- export --------------------------------------------------------------

    def snapshot(self) -> List[Dict[str, Any]]:
        """Finished spans, oldest first (the `get_traces` RPC body and
        the exporter's /traces.json)."""
        with self._lock:
            return [s.to_dict() for s in self._ring]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def __bool__(self) -> bool:
        # __len__ would otherwise make an EMPTY tracer falsy — and every
        # `if tr:` guard in the instrumentation would silently skip its
        # stage tags until the first span landed in the ring
        return True

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


# process-global tracer (one server process = one trace ring), mirroring
# utils/metrics.GLOBAL
TRACER = Tracer()
