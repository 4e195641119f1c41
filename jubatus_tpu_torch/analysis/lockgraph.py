"""Runtime lock-order / deadlock detector, `--debug_locks` (the lock
part of jubatus_tpu/analysis/lockgraph.py; the invariant linter is
ROADMAP Queue 1 item 7).

The serving stack's safety rests on an acquisition order: the model
rwlock before the journal's locks (append under the write lock), the
snapshot publish lock before nothing model-related, fsync, peer RPCs and
device syncs never under the model write lock.  This module checks it
at run time with the lock-order graph (witness) algorithm:

  * every instrumented acquisition pushes (name, mode) onto a per-thread
    held stack and adds the edge held -> acquired to one process-wide
    directed graph; an edge that closes a cycle is a potential deadlock
    and is reported even though this run got lucky;
  * locks carry a declared tier (rwlock -> journal -> snapshot -> pool);
    taking a lower tier while holding a higher one is reported as an
    inversion;
  * blocking operations (fsync, journal commit, peer RPC, device sync)
    call note_blocking(); one that runs while the calling thread holds
    the model WRITE lock is reported (every reader stalls behind it).

Each distinct violation logs one structured JSON ERROR line and counts
`lock_order_violation_total`.  Disabled (the default) the cost is one
attribute check an acquire or release.  `--debug_locks` or
JUBATUS_DEBUG_LOCKS=1 enables it.  A re-acquisition of a name the
thread already holds (nested read holds) counts depth and adds no
self-edge.
"""

from __future__ import annotations

import json
import logging
import threading
import traceback
from typing import Dict, List, Optional, Set, Tuple

log = logging.getLogger("jubatus_tpu_torch.lockgraph")

# the declared global acquisition order: a thread holding a
# lock of tier T may only acquire locks of tier > T.  Unlisted locks
# participate in cycle detection only.
TIERS: Dict[str, int] = {
    "model_lock": 10,        # the per-server rwlock (utils/rwlock.py)
    "journal": 20,           # journal._sync_mutex (commit/rotate/close)
    "journal.state": 22,     # journal._lock (fp/position/pending)
    "snapshot": 30,          # snapshotter._snap_lock (publish serializer)
    "pool": 40,              # batching/arenas.py free-list lock
}


class LockOrderMonitor:
    """Process-global lock-order graph + per-thread held stacks.

    Thread-safe; `enabled` is read unlocked on the hot path (a stale
    read costs one extra no-op call, never a wrong report)."""

    def __init__(self, registry=None):
        self.enabled = False
        self._registry = registry
        self._graph_lock = threading.Lock()
        # adjacency: edge a -> b exists iff some thread acquired b while
        # holding a; the witness stack of the first occurrence is kept
        # for the report
        self._edges: Dict[str, Set[str]] = {}
        self._edge_witness: Dict[Tuple[str, str], str] = {}
        # _report_lock guards _reported/_violations (the once-per-site
        # dedupe must hold when two threads hit the same bad site at
        # once).  Internal order: _graph_lock -> _report_lock (_add_edge
        # reports cycles while holding the graph lock); never reversed.
        self._report_lock = threading.Lock()
        self._reported: Set[Tuple[str, ...]] = set()
        self._violations: List[dict] = []
        self._tls = threading.local()

    # -- configuration -------------------------------------------------------

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Drop the recorded graph and reports (test isolation)."""
        with self._graph_lock:
            self._edges.clear()
            self._edge_witness.clear()
            with self._report_lock:
                self._reported.clear()
                self._violations.clear()

    def _metrics(self):
        if self._registry is not None:
            return self._registry
        from jubatus_tpu_torch.utils.metrics import GLOBAL
        return GLOBAL

    # -- per-thread held stack -----------------------------------------------

    def _held(self) -> List[List]:
        """[name, mode, depth] entries for the calling thread, in
        acquisition order."""
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = []
        return h

    def held_names(self) -> List[str]:
        return [e[0] for e in self._held()]

    # -- events --------------------------------------------------------------

    def note_acquire(self, name: str, mode: str = "x") -> None:
        """Record that the calling thread now holds `name`.  Call AFTER
        the underlying acquire succeeds."""
        if not self.enabled:
            return
        held = self._held()
        for entry in held:
            if entry[0] == name:
                # re-entrant hold of the same lock (rwlock read depth):
                # never a self-edge — see module docstring
                entry[2] += 1
                return
        tier = TIERS.get(name)
        for entry in held:
            self._add_edge(entry[0], name)
            held_tier = TIERS.get(entry[0])
            if (tier is not None and held_tier is not None
                    and tier < held_tier):
                self._report(
                    ("tier", entry[0], name),
                    kind="tier_inversion",
                    detail=f"acquired {name!r} (tier {tier}) while "
                           f"holding {entry[0]!r} (tier {held_tier}); "
                           "declared order is "
                           "rwlock -> journal -> snapshot -> pool")
        held.append([name, mode, 1])

    def note_release(self, name: str) -> None:
        if not self.enabled:
            return
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == name:
                held[i][2] -= 1
                if held[i][2] <= 0:
                    del held[i]
                return
        # release without acquire: CheckedRWLock raises for the model
        # lock; for named mutexes this is a plain bug worth a report
        self._report(("release", name), kind="unmatched_release",
                     detail=f"release of {name!r} on a thread that does "
                            "not hold it")

    def note_blocking(self, op: str) -> None:
        """A blocking operation (fsync, RPC send, device_sync, journal
        commit) is about to run on the calling thread."""
        if not self.enabled:
            return
        for lname, mode, _depth in self._held():
            if lname == "model_lock" and mode == "w":
                self._report(
                    ("blocking", op),
                    kind="blocking_in_write_lock",
                    detail=f"blocking operation {op!r} while holding the "
                           "model WRITE lock: every reader and the "
                           "dispatch thread stall behind it")
                return

    # -- graph ----------------------------------------------------------------

    def _add_edge(self, a: str, b: str) -> None:
        # double-checked fast path: set membership is safe to probe
        # unlocked in CPython; insertion and the cycle scan serialize
        if b in self._edges.get(a, ()):
            return
        with self._graph_lock:
            dests = self._edges.setdefault(a, set())
            if b in dests:
                return
            dests.add(b)
            self._edge_witness[(a, b)] = "".join(
                traceback.format_stack(limit=8)[:-2])
            cycle = self._find_cycle(b, a)
            if cycle is not None:
                self._report(
                    ("cycle",) + tuple(sorted(cycle)),
                    kind="cycle",
                    detail="lock-order cycle (potential deadlock): "
                           + " -> ".join(cycle + [cycle[0]]),
                    cycle=cycle)

    def _find_cycle(self, start: str, target: str) -> Optional[List[str]]:
        """DFS: path start -> ... -> target in the edge graph; the new
        edge target -> start then closes the cycle."""
        stack = [(start, [start])]
        seen = {start}
        while stack:
            node, path = stack.pop()
            if node == target:
                return path
            for nxt in self._edges.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    # -- reporting -------------------------------------------------------------

    def _report(self, key: Tuple, kind: str, detail: str,
                cycle: Optional[List[str]] = None) -> None:
        record = {
            "kind": kind,
            "detail": detail,
            "thread": threading.current_thread().name,
            "held": self.held_names(),
        }
        if cycle:
            record["cycle"] = cycle
            record["witnesses"] = {
                f"{a}->{b}": self._edge_witness.get((a, b), "")
                for a, b in zip(cycle, cycle[1:] + cycle[:1])
                if (a, b) in self._edge_witness}
        with self._report_lock:
            # check-and-add under the lock: two threads racing the same
            # bad site must produce exactly ONE record + counter tick
            if key in self._reported:
                return
            self._reported.add(key)
            self._violations.append(record)
        try:
            self._metrics().inc("lock_order_violation_total")
        except Exception:  # pragma: no cover - registry mid-bootstrap
            log.debug("lock-order violation counter unavailable",
                      exc_info=True)
        log.error("lock_order_violation %s", json.dumps(
            {k: v for k, v in record.items() if k != "witnesses"},
            default=str, sort_keys=True))

    def violations(self) -> List[dict]:
        with self._report_lock:
            return list(self._violations)

    def edges(self) -> Dict[str, Set[str]]:
        with self._graph_lock:
            return {k: set(v) for k, v in self._edges.items()}


# process-global monitor: one server process = one lock-order graph
MONITOR = LockOrderMonitor()


def enable_from_env() -> bool:
    """Honour JUBATUS_DEBUG_LOCKS=1 (the test suite's mode)."""
    import os
    if os.environ.get("JUBATUS_DEBUG_LOCKS") == "1":
        MONITOR.enable()
    return MONITOR.enabled


enable_from_env()


class MonitoredLock:
    """threading.Lock wrapper feeding the monitor under a declared name.

    Used at the NAMED lock sites of the concurrency story (journal,
    snapshot, arena pool).  Disabled cost per acquire: the underlying
    lock op plus one attribute check."""

    __slots__ = ("name", "_lock", "_monitor")

    def __init__(self, name: str, monitor: Optional[LockOrderMonitor] = None):
        self.name = name
        self._lock = threading.Lock()
        # test-local monitors attach per-instance (avoids polluting the
        # process-global graph from deliberate-deadlock drills)
        self._monitor = monitor

    @property
    def monitor(self) -> LockOrderMonitor:
        return self._monitor if self._monitor is not None else MONITOR

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok and self.monitor.enabled:
            self.monitor.note_acquire(self.name)
        return ok

    def release(self) -> None:
        self._lock.release()
        if self.monitor.enabled:
            self.monitor.note_release(self.name)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "MonitoredLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()
