"""Process-wide counters and gauges (the part of
jubatus_tpu/utils/metrics.py that the cross-process MIX tier feeds).

Counters only go up (`inc`); gauges keep the last value (`set_gauge`).
get_status merges `GLOBAL.snapshot()`, rendered as the JAX registry
renders these two kinds, so a key reads the same from either package:
mix_bytes_sent_total, mix_bytes_received_total, mix_compression_ratio,
rpc_retry_total and the breaker_*_total counters.  The histogram
registry and the metrics exporter are later work.
"""

from __future__ import annotations

import threading
from typing import Dict


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def snapshot(self) -> Dict[str, str]:
        """Flatten for get_status (the JAX registry's formatting)."""
        out: Dict[str, str] = {}
        with self._lock:
            for k, v in self._counters.items():
                out[k] = str(int(v) if float(v).is_integer() else v)
            for k, v in self._gauges.items():
                out[k] = str(int(v) if float(v).is_integer() else round(v, 6))
        return out


GLOBAL = Registry()
