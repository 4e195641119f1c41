"""Readers-writer model lock (the port's copy of
jubatus_tpu/utils/rwlock.py).

Many concurrent read RPCs, exclusive updates; writer-preferring so a
train burst cannot starve behind a stream of classifies.  The lock knows
which thread holds it, so the flush()-before-model-lock rule of the
train dispatchers (framework/dispatch.py) is enforced, not documented.

CheckedRWLock turns lock-discipline bugs into immediate typed errors:
read->write upgrades and re-entrant acquires (deadlocks under load)
raise LockDisciplineError instead of hanging, releases without a
matching acquire raise, and held() names what the calling thread holds.
create_rwlock() returns it under JUBATUS_LOCK_CHECK=1, as the JAX
package does; --debug_locks (analysis/lockgraph.py) reports lock-order
faults without changing the lock.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Optional

# --debug_locks / JUBATUS_DEBUG_LOCKS=1: every model-lock acquisition
# feeds the lock-order graph (analysis/lockgraph.py); disabled cost: one
# attribute check an acquire or release
from jubatus_tpu_torch.analysis.lockgraph import MONITOR as _monitor


class LockDisciplineError(RuntimeError):
    """A lock usage that would deadlock or corrupt under load."""


class RWLock:
    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0
        # the write holder's thread and a per-thread read depth: the
        # dispatchers' flush()-before-model-lock rule is enforced with
        # them (framework/dispatch.py)
        self._writer_thread: Optional[int] = None
        self._local = threading.local()

    def acquire_read(self) -> None:
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
        self._local.read = getattr(self._local, "read", 0) + 1
        if _monitor.enabled:
            _monitor.note_acquire("model_lock", mode="r")

    def release_read(self) -> None:
        self._local.read = getattr(self._local, "read", 1) - 1
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()
        if _monitor.enabled:
            _monitor.note_release("model_lock")

    def acquire_write(self) -> None:
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = True
            self._writer_thread = threading.get_ident()
        if _monitor.enabled:
            _monitor.note_acquire("model_lock", mode="w")

    def release_write(self) -> None:
        with self._cond:
            self._writer = False
            self._writer_thread = None
            self._cond.notify_all()
        if _monitor.enabled:
            _monitor.note_release("model_lock")

    def write_held_by_me(self) -> bool:
        """True iff the calling thread holds the write lock."""
        return self._writer_thread == threading.get_ident()

    def read_held_by_me(self) -> bool:
        """True iff the calling thread holds at least one read hold."""
        return getattr(self._local, "read", 0) > 0

    @contextmanager
    def read(self):
        self.acquire_read()
        try:
            yield
        finally:
            self.release_read()

    @contextmanager
    def write(self):
        self.acquire_write()
        try:
            yield
        finally:
            self.release_write()


class CheckedRWLock(RWLock):
    """RWLock with per-thread ownership tracking and fail-fast
    discipline checks (see module docstring)."""

    def __init__(self):
        super().__init__()
        self._tls = threading.local()

    def _depths(self):
        if not hasattr(self._tls, "read"):
            self._tls.read = 0
            self._tls.write = 0
        return self._tls

    def held(self):
        """-> 'write' | 'read' | None for the calling thread."""
        d = self._depths()
        if d.write:
            return "write"
        if d.read:
            return "read"
        return None

    def acquire_read(self):
        d = self._depths()
        if d.write:
            raise LockDisciplineError(
                "read acquire while holding the write lock: a "
                "writer-preferring RWLock self-deadlocks here under load")
        if d.read:
            raise LockDisciplineError(
                "re-entrant read acquire: deadlocks the moment a writer "
                "queues between the two acquires (writer preference)")
        super().acquire_read()
        d.read += 1

    def release_read(self):
        d = self._depths()
        if not d.read:
            raise LockDisciplineError("read release without a matching "
                                      "acquire on this thread")
        d.read -= 1
        super().release_read()

    def acquire_write(self):
        d = self._depths()
        if d.write:
            raise LockDisciplineError("re-entrant write acquire: "
                                      "self-deadlock")
        if d.read:
            raise LockDisciplineError(
                "read->write upgrade: deadlocks the moment a second "
                "reader or waiting writer exists")
        super().acquire_write()
        d.write += 1

    def release_write(self):
        d = self._depths()
        if not d.write:
            raise LockDisciplineError("write release without a matching "
                                      "acquire on this thread")
        d.write -= 1
        super().release_write()


def create_rwlock() -> RWLock:
    """The model lock: the checked variant under JUBATUS_LOCK_CHECK=1,
    the plain one otherwise."""
    if os.environ.get("JUBATUS_LOCK_CHECK"):
        return CheckedRWLock()
    return RWLock()
