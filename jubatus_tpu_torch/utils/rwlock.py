"""Readers-writer model lock (counterpart of jubatus_tpu/utils/rwlock.py).

Many concurrent read RPCs, exclusive updates; writer-preferring so a
train burst cannot starve behind a stream of classifies.  The lock knows
which thread holds it, so the flush()-before-model-lock rule of the train
dispatchers (framework/dispatch.py) is enforced, not just documented.
The JAX package's lock-order monitor and its checked variant are later
work.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional


class LockDisciplineError(RuntimeError):
    """A lock usage that would deadlock or corrupt under load."""


class RWLock:
    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0
        self._writer_thread: Optional[int] = None
        self._local = threading.local()

    def acquire_read(self) -> None:
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
        self._local.read = getattr(self._local, "read", 0) + 1

    def release_read(self) -> None:
        self._local.read = getattr(self._local, "read", 1) - 1
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

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

    def release_write(self) -> None:
        with self._cond:
            self._writer = False
            self._writer_thread = None
            self._cond.notify_all()

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
