"""Process-wide counters, gauges and histograms (the part of
jubatus_tpu/utils/metrics.py that the cross-process MIX tier, the
durability plane and the read lane feed).

Counters only go up (`inc`); gauges keep the last value (`set_gauge`);
`observe` (a time in seconds) and `observe_value` (a unitless sample,
such as a coalesced batch width) feed bounded log-scale histograms whose
snapshot carries count, mean, p50/p95/p99 and max.  get_status merges
`GLOBAL.snapshot()`, rendered as the JAX registry renders these kinds,
so a key reads the same from either package: mix_bytes_sent_total,
journal_records_total, read_batch_size_mean, read_lock_wait_p99_sec,
batch.read.classify.size_max, ...  The keyed-series cap, the mergeable
raw export and the metrics exporter are later work.
"""

from __future__ import annotations

import math
import threading
import time
from contextlib import contextmanager
from typing import Dict, List

# the JAX registry's histogram geometry: geometric buckets of ratio
# 2^(1/4) from 1e-6, 128 of them (1e-6 s .. over an hour; widths 1..4096);
# values outside clamp into the edge buckets, the exact max is kept apart
_HIST_BASE = 1e-6
_HIST_LOG_RATIO = math.log(2.0) / 4.0
_HIST_NBUCKETS = 128


def _bucket_of(value: float) -> int:
    if value <= _HIST_BASE:
        return 0
    i = int(math.log(value / _HIST_BASE) / _HIST_LOG_RATIO) + 1
    return min(i, _HIST_NBUCKETS - 1)


def _bucket_mid(i: int) -> float:
    if i == 0:
        return _HIST_BASE
    return _HIST_BASE * math.exp((i - 0.5) * _HIST_LOG_RATIO)


class _Hist:
    """count/total/max plus fixed log buckets."""

    __slots__ = ("count", "total", "max", "buckets")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self.buckets: List[int] = [0] * _HIST_NBUCKETS

    def add(self, value: float) -> None:
        self.count += 1
        self.total += value
        self.max = max(self.max, value)
        self.buckets[_bucket_of(value)] += 1

    def percentile(self, q: float) -> float:
        """The q-quantile's bucket midpoint, clamped to the observed max."""
        if not self.count:
            return 0.0
        target = max(1, math.ceil(q * self.count))
        acc = 0
        for i, c in enumerate(self.buckets):
            acc += c
            if acc >= target:
                return min(_bucket_mid(i), self.max)
        return self.max


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._timers: Dict[str, _Hist] = {}
        self._values: Dict[str, _Hist] = {}

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, seconds: float) -> None:
        """One timing sample (seconds) into the histogram `name`."""
        with self._lock:
            rec = self._timers.get(name)
            if rec is None:
                rec = self._timers[name] = _Hist()
            rec.add(seconds)

    def observe_value(self, name: str, value: float) -> None:
        """One unitless sample into the histogram `name` (rendered
        without the _sec suffix timers get)."""
        with self._lock:
            rec = self._values.get(name)
            if rec is None:
                rec = self._values[name] = _Hist()
            rec.add(value)

    @contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def snapshot(self) -> Dict[str, str]:
        """Flatten for get_status (the JAX registry's formatting)."""
        out: Dict[str, str] = {}
        with self._lock:
            for k, v in self._counters.items():
                out[k] = str(int(v) if float(v).is_integer() else v)
            for k, v in self._gauges.items():
                out[k] = str(int(v) if float(v).is_integer() else round(v, 6))
            for k, h in self._timers.items():
                out[f"{k}_count"] = str(h.count)
                out[f"{k}_total_sec"] = f"{h.total:.9g}"
                if h.count:
                    out[f"{k}_mean_sec"] = f"{h.total / h.count:.9g}"
                    out[f"{k}_p50_sec"] = f"{h.percentile(0.50):.9g}"
                    out[f"{k}_p95_sec"] = f"{h.percentile(0.95):.9g}"
                    out[f"{k}_p99_sec"] = f"{h.percentile(0.99):.9g}"
                out[f"{k}_max_sec"] = f"{h.max:.9g}"
            for k, h in self._values.items():
                out[f"{k}_count"] = str(h.count)
                if h.count:
                    out[f"{k}_mean"] = f"{h.total / h.count:.3f}"
                    out[f"{k}_p50"] = f"{h.percentile(0.50):.3f}"
                    out[f"{k}_p95"] = f"{h.percentile(0.95):.3f}"
                    out[f"{k}_p99"] = f"{h.percentile(0.99):.3f}"
                out[f"{k}_max"] = f"{h.max:.3f}"
        return out


GLOBAL = Registry()
