"""Process-wide counters, gauges and histograms (the port's copy of
jubatus_tpu/utils/metrics.py).

Counters only go up (`inc`, and `inc_keyed` for a dynamic-suffix family
whose per-key series are capped); gauges keep the last value
(`set_gauge`); `observe` (a time in seconds) and `observe_value` (a
unitless sample, such as a coalesced batch width) feed bounded log-scale
histograms whose snapshot carries count, mean, p50/p95/p99 and max.
get_status, the get_metrics RPC and the exporter's /metrics all render
`GLOBAL.snapshot()` as the JAX registry renders these kinds, so a key
reads the same from either package: rpc.train_total_sec,
mix_bytes_sent_total, batch.train.size_mean, read_lock_wait_p99_sec, ...
`snapshot_raw` is the mergeable export (raw bucket counts), folded with
`merge_hist_raw` and rendered with `summarize_hist_raw`.

`device_telemetry` reads the card's allocator (torch.cuda) and
`start_profiler`/`stop_profiler` wrap torch.profiler with the CUDA
activity, writing a Chrome trace into a directory: the device truth that
the tracer's host-clock spans cannot see (CUDA work is asynchronous).
"""

from __future__ import annotations

import math
import os
import re as _re
import threading
import time
from contextlib import contextmanager
from typing import Dict, List

# Histogram geometry: geometric buckets of ratio 2^(1/4) (a sub-20% error
# bound on a percentile) from 1e-6, 128 of them (1e-6 s .. over an hour;
# widths 1..4096).  Values outside clamp into the edge buckets; the exact
# max is kept apart so clamping never inflates a percentile past it.
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


def percentile_from_raw(count: int, buckets: List[int], max_: float,
                        q: float) -> float:
    """The quantile estimator of live histograms and of merged raw
    dumps alike, so a percentile of buckets folded across nodes uses the
    same arithmetic as one node's (never a percentile of percentiles)."""
    if not count:
        return 0.0
    target = max(1, math.ceil(q * count))
    acc = 0
    for i, c in enumerate(buckets):
        acc += c
        if acc >= target:
            return min(_bucket_mid(i), max_)
    return max_


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
        return percentile_from_raw(self.count, self.buckets, self.max, q)

    def raw(self) -> Dict[str, object]:
        """The mergeable form: raw bucket counts, never percentiles."""
        return {"count": self.count, "total": self.total,
                "max": self.max, "buckets": list(self.buckets)}


def merge_hist_raw(raws: List[Dict[str, object]]) -> Dict[str, object]:
    """Fold raw histogram dumps bucket-wise.  Pass them in a fixed order
    (sorted member id): the float total then folds identically on every
    merger."""
    out = {"count": 0, "total": 0.0, "max": 0.0,
           "buckets": [0] * _HIST_NBUCKETS}
    for r in raws:
        out["count"] += int(r.get("count", 0))
        out["total"] += float(r.get("total", 0.0))
        out["max"] = max(out["max"], float(r.get("max", 0.0)))
        for i, c in enumerate((r.get("buckets") or [])[:_HIST_NBUCKETS]):
            out["buckets"][i] += int(c)
    return out


def summarize_hist_raw(name: str, raw: Dict[str, object],
                       timer: bool = True) -> Dict[str, str]:
    """One raw histogram in snapshot()'s flat format, the percentiles
    recomputed from its (possibly merged) bucket counts."""
    count = int(raw.get("count", 0))
    buckets = list(raw.get("buckets") or [])
    mx = float(raw.get("max", 0.0))
    total = float(raw.get("total", 0.0))
    sfx = "_sec" if timer else ""
    out = {f"{name}_count": str(count)}
    if timer:
        out[f"{name}_total_sec"] = f"{total:.9g}"
    if count:
        fmt = (lambda v: f"{v:.9g}") if timer else (lambda v: f"{v:.3f}")
        out[f"{name}_mean{sfx}"] = fmt(total / count)
        for q, tag in ((0.50, "p50"), (0.95, "p95"), (0.99, "p99")):
            out[f"{name}_{tag}{sfx}"] = fmt(
                percentile_from_raw(count, buckets, mx, q))
    out[f"{name}_max{sfx}"] = f"{mx:.9g}" if timer else f"{mx:.3f}"
    return out


# the cardinality bound of a dynamic-suffix family (`<base>_total.<key>`,
# keyed by method, peer or site): past the cap new keys collapse into one
# overflow series and the drop is itself counted
DYNAMIC_SERIES_CAP = 64
OVERFLOW_KEY = "__overflow__"
SERIES_DROPPED = "metrics_series_dropped_total"


class Registry:
    def __init__(self, dynamic_series_cap: int = DYNAMIC_SERIES_CAP):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._timers: Dict[str, _Hist] = {}
        self._values: Dict[str, _Hist] = {}
        self._gauges: Dict[str, float] = {}
        self._dyn_cap = max(1, int(dynamic_series_cap))
        self._dyn_keys: Dict[str, set] = {}

    def _capped_series(self, base: str, key: str) -> str:
        """`<base>.<key>`, or `<base>.__overflow__` once the base has
        DYNAMIC_SERIES_CAP distinct keys (caller holds self._lock); each
        collapsed sample also counts metrics_series_dropped_total."""
        keys = self._dyn_keys.setdefault(base, set())
        if key in keys:
            return f"{base}.{key}"
        if len(keys) >= self._dyn_cap:
            self._counters[SERIES_DROPPED] = \
                self._counters.get(SERIES_DROPPED, 0.0) + 1
            return f"{base}.{OVERFLOW_KEY}"
        keys.add(key)
        return f"{base}.{key}"

    def inc_keyed(self, base: str, key, value: float = 1.0) -> None:
        """The capped counter of a dynamic-suffix family."""
        key = str(key) if key is not None and key != "" else "default"
        with self._lock:
            name = self._capped_series(base, key)
            self._counters[name] = self._counters.get(name, 0.0) + value

    def inc(self, name: str, value: float = 1.0) -> None:
        if "_total." in name:
            # a literal dynamic-suffix spelling honours the cap too
            base, _, key = name.partition("_total.")
            self.inc_keyed(base + "_total", key, value)
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def gauge(self, name: str) -> float:
        with self._lock:
            return self._gauges.get(name, 0.0)

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

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

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

    def snapshot_raw(self) -> Dict[str, Dict]:
        """The mergeable export: counters and gauges as they are, every
        histogram's raw bucket counts."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "timers": {k: h.raw() for k, h in self._timers.items()},
                "values": {k: h.raw() for k, h in self._values.items()},
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._timers.clear()
            self._values.clear()
            self._gauges.clear()
            self._dyn_keys.clear()


GLOBAL = Registry()


# -- Prometheus text rendering ----------------------------------------------

_PROM_BAD = _re.compile(r"[^a-zA-Z0-9_:]")


def render_prometheus(flat: Dict[str, str], prefix: str = "jubatus") -> str:
    """A flat {name: value} map as Prometheus text exposition.
    Non-numeric values are skipped (/metrics.json carries the whole
    map).  get_status, get_metrics and /metrics render one map, so a
    counter cannot appear in one surface and not the others."""
    lines = []
    for key in sorted(flat):
        try:
            value = float(flat[key])
        except (TypeError, ValueError):
            continue
        name = f"{prefix}_{_PROM_BAD.sub('_', key)}"
        lines.append(f"{name} {value:.10g}")
    return "\n".join(lines) + "\n"


# -- device telemetry ---------------------------------------------------------


def device_telemetry() -> Dict[str, float]:
    """The card's allocator gauges: the device count (0 without CUDA),
    the caching allocator's live and peak bytes and the device's total
    memory.  A process without a card (or before CUDA is initialised)
    gives no HBM keys; it never raises: it runs inside
    metrics_snapshot()."""
    out: Dict[str, float] = {}
    try:
        import torch
        out["device_count"] = float(torch.cuda.device_count())
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return out
        dev = torch.cuda.current_device()
        out["hbm_bytes_in_use"] = float(torch.cuda.memory_allocated(dev))
        out["hbm_peak_bytes"] = float(torch.cuda.max_memory_allocated(dev))
        out["hbm_bytes_limit"] = float(torch.cuda.mem_get_info(dev)[1])
    except Exception:  # noqa: BLE001 - telemetry is best-effort by contract
        pass
    return out


# -- torch.profiler hooks -------------------------------------------------------

_profiler = {"dir": None, "prof": None}
_profiler_lock = threading.Lock()


def start_profiler(logdir: str) -> bool:
    """Begin a torch.profiler trace of the process's CPU and CUDA work;
    stop_profiler() writes it into `logdir` as a Chrome trace.  The CUDA
    activity (CUPTI) covers every kernel of the process; the CPU ops of
    every thread (the RPC, convert and dispatch threads) are recorded
    where the torch version offers it (profile_all_threads), else those
    of the calling thread only."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with _profiler_lock:  # RPC handlers run on worker pools
        if _profiler["dir"] is not None:
            return False
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        kw = {}
        try:
            from torch._C._profiler import _ExperimentalConfig
            kw["experimental_config"] = _ExperimentalConfig(
                profile_all_threads=True)
        except (ImportError, TypeError):
            pass
        prof = profile(activities=acts, **kw)
        prof.start()
        _profiler["dir"], _profiler["prof"] = logdir, prof
        return True


def stop_profiler() -> str:
    """Stop the trace and export it; returns the file's path ("" when no
    trace was running)."""
    with _profiler_lock:
        logdir, prof = _profiler["dir"], _profiler["prof"]
        if logdir is None:
            return ""
        _profiler["dir"] = _profiler["prof"] = None
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"torch_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return path
