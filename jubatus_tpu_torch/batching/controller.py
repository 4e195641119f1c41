"""Queue-depth-driven batching-window controllers (copy of
jubatus_tpu/batching/controller.py).

Lingering for more requests grows the fused batch (throughput) but delays
the first request's ack (latency).  The window is zero while traffic is
sparse (a lone request dispatches at once) and opens toward `max_wait_s`
as the observed coalesce width and residual backlog grow.
"""

from __future__ import annotations


class WindowController:
    """EWMA-of-load -> linger window in [0, max_wait_s].

    observe() is called once per window from the ingest pipeline's
    convert thread with (drained, backlog): how many requests the step carried
    and how many were still queued behind it.  No locking — one writer,
    and readers of `wait_s` tolerate a stale float.
    """

    def __init__(self, max_wait_s: float = 0.002, target_batch: int = 8,
                 alpha: float = 0.3):
        if max_wait_s < 0:
            raise ValueError("max_wait_s must be >= 0")
        if target_batch < 2:
            raise ValueError("target_batch must be >= 2")
        self.max_wait_s = max_wait_s
        self.target_batch = target_batch
        self.alpha = alpha
        self._ewma = 1.0
        self._wait = 0.0

    @property
    def wait_s(self) -> float:
        """Current linger window for the NEXT gather."""
        return self._wait

    def observe(self, drained: int, backlog: int = 0) -> None:
        load = max(1.0, float(drained + backlog))
        self._ewma += self.alpha * (load - self._ewma)
        # ewma == 1 (steady singles) -> 0 wait; >= target -> full window
        frac = (self._ewma - 1.0) / (self.target_batch - 1.0)
        self._wait = self.max_wait_s * min(max(frac, 0.0), 1.0)


class FixedWindow:
    """A constant window (0: drain what is queued and linger not at
    all), for a coalescer given no window to adapt."""

    def __init__(self, wait_s: float = 0.0):
        self.wait_s = wait_s

    def observe(self, drained: int, backlog: int = 0) -> None:
        pass
