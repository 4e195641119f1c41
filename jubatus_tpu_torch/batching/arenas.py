"""Recycled host arenas for the batched ingest path (counterpart of
jubatus_tpu/batching/arenas.py, with a device).

The native batch converter (_fastconv.c convert_raw_batch) fills one
packed [idx | val | aux | mask] blob per coalesced window.  This pool keeps
a small free list of buffers per size class so steady-state ingest
recycles the same few arenas instead of allocating per window.  Size
classes are page multiples; B and K are bucket-rounded, so a workload
produces few of them.

For a cuda driver the arenas are pinned (page-locked) host memory, so the
arena reaches the card in one truly asynchronous host->device copy;
pinning costs far more than a malloc, which is why the pool exists.  For
the CPU they are plain 64-byte-aligned numpy buffers (pinning needs CUDA).
acquire() hands the C side a writable numpy view; for a pinned arena the
view's base is the pinned tensor, which pinned_tensor() returns for the
copy.  Each driver owns one pool (models/classifier.py) of
MAX_PER_SIZE arenas a size class, the JAX server's --arena_pool default;
the server's --arena_pool resizes it (configure).

Recycling rule: the copy of a pinned arena runs asynchronously, and on the
CPU the device step aliases the arena zero-copy, so an arena must not be
rewritten until the step that read it has executed.  Callers release()
only after a device_sync that fences that step — the ingest pipeline
batches releases at its periodic sync points
(framework/dispatch.IngestPipeline._after_batch).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from jubatus_tpu_torch.analysis.lockgraph import MonitoredLock

_ALIGN = 64
_SIZE_QUANTUM = 4096


def _size_class(nbytes: int) -> int:
    """Quantize a request up to its size class (page multiple)."""
    n = max(int(nbytes), 1)
    return ((n + _SIZE_QUANTUM - 1) // _SIZE_QUANTUM) * _SIZE_QUANTUM


class ArenaPool:
    """Bounded per-size free lists of np.uint8 arenas.

    acquire(nbytes) returns a writable contiguous uint8 array of at least
    nbytes (the C side fills only the first nbytes); release() returns it
    for reuse, up to max_per_size arenas a class (0 keeps none).  `hits`
    and `misses` count acquires served from a free list and fresh
    allocations.
    """

    MAX_PER_SIZE = 4

    def __init__(self, max_per_size: int = MAX_PER_SIZE,
                 pinned: bool = False):
        self.max_per_size = max(0, int(max_per_size))
        self.pinned = pinned
        self.hits = 0
        self.misses = 0
        self._free: Dict[int, List[np.ndarray]] = {}
        self._lock = MonitoredLock("pool")

    def configure(self, max_per_size: int) -> None:
        """Resize the per-class bound (0 keeps no arena); a free list
        already above it takes no more releases."""
        self.max_per_size = max(0, int(max_per_size))

    def acquire(self, nbytes: int) -> np.ndarray:
        size = _size_class(nbytes)
        with self._lock:
            lst = self._free.get(size)
            if lst:
                self.hits += 1
                return lst.pop()
            self.misses += 1
        if self.pinned:
            return torch.empty(size, dtype=torch.uint8,
                               pin_memory=True).numpy()
        raw = np.empty(size + _ALIGN, np.uint8)
        off = (-raw.ctypes.data) % _ALIGN
        return raw[off:off + size]        # the view keeps `raw` alive

    def release(self, arena) -> None:
        """Return an arena once the device step that read it has been
        fenced by a device_sync (see the module docstring)."""
        with self._lock:
            lst = self._free.setdefault(arena.nbytes, [])
            if len(lst) < self.max_per_size:
                lst.append(arena)

    def free_arenas(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._free.values())


def pinned_tensor(arena) -> Optional[torch.Tensor]:
    """The pinned host tensor behind an arena of a pinned pool, or None
    for any other buffer."""
    base = getattr(arena, "base", None)
    if isinstance(base, torch.Tensor) and base.is_pinned() \
            and base.data_ptr() == arena.ctypes.data:
        return base
    return None


def arena_to_device(arena: np.ndarray, nbytes: int,
                    device: torch.device) -> torch.Tensor:
    """The first `nbytes` of a packed arena as a uint8 tensor on `device`,
    in one host->device copy: asynchronous from an arena of a pinned pool
    (which must then outlive the copy, see the recycling rule above), and
    a zero-copy view on the CPU.  Caller has `device` current."""
    host = pinned_tensor(arena)
    if host is not None:
        return host[:nbytes].to(device, non_blocking=True)
    return torch.from_numpy(arena[:nbytes]).to(device)
