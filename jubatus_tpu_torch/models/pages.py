"""Paged row store on one torch device (counterpart of the resident half
of jubatus_tpu/models/pages.py).

The row engines' tables are a pool of fixed-size pages of `page_rows`
slots.  The device tensors stay physically contiguous: a column is one
[capacity, *tail] tensor (the flat view of [n_pages, page_rows, *tail]),
so a sweep reads the whole pool in one launch with a validity count.

Inserts take freed slots first (last freed, first reused), then fill
the current page; growth appends whole pages, at least doubling the page
count, and never renumbers a slot.  A drop punches a hole in the
occupancy plane and returns the slot to the free list: the host keeps
the occupancy (mask_host) and the device a bool [capacity] mask
(mask_dev), updated by one index_fill_ on every alloc and free and
rebuilt only when the capacity moves, which the sweeps take where rows
can be dropped (the recommender, anomaly).  The nearest_neighbor engine
never drops a row, so its live rows stay a prefix and its sweeps take
the count.

Slot numbering is the JAX package's exactly, free list included, so a
history of inserts and drops lays its rows out as the JAX store does (a
top-k breaks ties by the lower slot, so reads depend on it), and the
model file's flat table (pack_flat) is byte-identical.  The spill tier (resident_pages > 0, the
host master copy behind a device page pool, jubatus_tpu/ops/paged.py) is
not ported: a config asking for it is refused with the ROADMAP item that
brings it.

Writes are one index_copy_ per column (slots must be unique: the
callers dedupe); the JAX store pads a write to a power of two with
repeats of its last slot to reuse compiled scatters, which eager torch
does not need.  Thread contract: mutations run under the caller's model
write lock.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

DEFAULT_PAGE_ROWS = 128
SPILL_REFUSAL = ("pages.resident_pages > 0 asks for the spill tier "
                 "(host-resident pages behind a device page pool, "
                 "ops/paged.py), which the port does not have yet: "
                 "ROADMAP Queue 1 item 5.4")

# uint32 columns live on the device as int32 bit patterns (torch's uint32
# has few CPU ops); the host side of read/write stays uint32
_TORCH_DTYPES = {np.dtype(np.uint32): torch.int32,
                 np.dtype(np.int32): torch.int32,
                 np.dtype(np.float32): torch.float32}


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class PageSpec:
    """Config-level paging knobs (engine config `"pages": {...}`):
    page_rows (default 128) and resident_pages (0: everything resident;
    more is the spill tier, refused)."""

    __slots__ = ("page_rows", "resident_pages")

    def __init__(self, page_rows: int = DEFAULT_PAGE_ROWS,
                 resident_pages: int = 0):
        self.page_rows = max(int(page_rows), 1)
        self.resident_pages = max(int(resident_pages), 0)
        if self.resident_pages > 0:
            raise NotImplementedError(SPILL_REFUSAL)

    @classmethod
    def from_config(cls, config: Optional[Dict[str, Any]]) -> "PageSpec":
        cfg = dict(config or {})
        return cls(page_rows=int(cfg.get("page_rows", DEFAULT_PAGE_ROWS)),
                   resident_pages=int(cfg.get("resident_pages", 0)))


class PagedRowStore:
    """Fixed-size-page row storage on `device`.

    columns: {name: (tail_shape, numpy dtype)}; each column is one device
    tensor [capacity, *tail]."""

    def __init__(self, columns: Dict[str, Tuple[Tuple[int, ...], Any]],
                 capacity: int, device: torch.device,
                 spec: Optional[PageSpec] = None,
                 grow_cb: Optional[Callable[[int, int], None]] = None):
        self.spec = spec or PageSpec()
        self._dev = device
        self._grow_cb = grow_cb
        self._schema: Dict[str, Tuple[Tuple[int, ...], np.dtype]] = {
            n: (tuple(tail), np.dtype(dt)) for n, (tail, dt) in
            columns.items()}
        self.page_rows = self.spec.page_rows
        self._set_capacity(capacity)
        self._init_state()

    # -- state construction --------------------------------------------------

    def _set_capacity(self, capacity: int) -> None:
        self._cap = int(capacity)
        self.n_pages = max((self._cap + self.page_rows - 1)
                           // self.page_rows, 1)

    def _zeros(self, name: str, rows: int) -> torch.Tensor:
        tail, dt = self._schema[name]
        return torch.zeros((rows,) + tail, dtype=_TORCH_DTYPES[dt],
                           device=self._dev)

    def _init_state(self) -> None:
        self._frontier = 0
        self._occ = np.zeros((self.capacity,), bool)
        self._free: List[int] = []
        self._holes = 0
        self._live = 0
        self._mask_dev: Optional[torch.Tensor] = None
        self._cols = {n: self._zeros(n, self.capacity) for n in self._schema}

    # -- shape facts ---------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self._cap

    @property
    def n_rows(self) -> int:
        """Live rows."""
        return self._live

    @property
    def has_holes(self) -> bool:
        return self._holes > 0

    # -- allocation ----------------------------------------------------------

    def _take_free(self, n: int) -> List[int]:
        out = []
        while len(out) < n and self._free:
            out.append(self._free.pop())
            self._holes -= 1
        return out

    def alloc(self, n: int = 1) -> np.ndarray:
        """n slots: freed slots first (the last freed first), then the
        page-fill frontier (0, 1, 2, ...), growing once to the power of
        two of pages that fits."""
        reused = self._take_free(n)
        end = self._frontier + n - len(reused)
        if end > self.capacity:
            self._grow_to(end)
        out = np.concatenate([np.asarray(reused, np.int64),
                              np.arange(self._frontier, end, dtype=np.int64)])
        self._frontier = end
        self._note_occupy(out)
        return out

    def alloc1(self) -> int:
        return int(self.alloc(1)[0])

    def alloc_seq(self, n: int) -> np.ndarray:
        """The slots of n single-row allocations in a row (alloc1 n
        times), capacity included: each growth doubles the page count at
        least, as one allocation past the end does (alloc(n) grows once,
        to the power of two that fits)."""
        reused = self._take_free(n)
        end = self._frontier + n - len(reused)
        while end > self.capacity:
            self._grow_to(self.capacity + 1)
        out = np.concatenate([np.asarray(reused, np.int64),
                              np.arange(self._frontier, end, dtype=np.int64)])
        self._frontier = end
        self._note_occupy(out)
        return out

    def _note_occupy(self, slots: np.ndarray) -> None:
        if not slots.size:
            return
        self._live += int((~self._occ[slots]).sum())
        self._occ[slots] = True
        self._mask_fill(slots, True)

    def free(self, slots: Sequence[int]) -> int:
        """Punch occupancy holes and return the slots to the free list,
        in the order given (one mask write on the device).  Returns the
        number of pages touched."""
        slots = np.asarray([int(s) for s in slots
                            if 0 <= int(s) < self.capacity], np.int64)
        slots = slots[self._occ[slots]]
        if not slots.size:
            return 0
        self._occ[slots] = False
        self._live -= int(slots.size)
        self._free.extend(int(s) for s in slots)
        self._holes += int(slots.size)
        self._mask_fill(slots, False)
        return int(np.unique(slots // self.page_rows).size)

    def _mask_fill(self, slots: np.ndarray, value: bool) -> None:
        if self._mask_dev is not None:
            self._mask_dev.index_fill_(0, self._dev_slots(slots), value)

    def mask_host(self) -> np.ndarray:
        """Host occupancy, bool [capacity] (a read-only view: callers copy
        before they mutate it)."""
        return self._occ

    def mask_dev(self) -> torch.Tensor:
        """Device occupancy, bool [capacity]: uploaded once, then kept up
        to date by alloc and free; a capacity change rebuilds it."""
        if self._mask_dev is None:
            self._mask_dev = torch.from_numpy(self._occ.copy()).to(self._dev)
        return self._mask_dev

    def _grow_to(self, need_cap: int) -> None:
        """Append pages (at least doubling the page count); rows keep
        their slots."""
        old_cap = self.capacity
        new_pages = max(_pow2((need_cap + self.page_rows - 1)
                              // self.page_rows), self.n_pages * 2)
        new_cap = new_pages * self.page_rows
        for n, col in self._cols.items():
            grown = self._zeros(n, new_cap)
            grown[: col.shape[0]] = col
            self._cols[n] = grown
        self._occ = np.pad(self._occ, (0, new_cap - old_cap))
        self.n_pages = new_pages
        self._cap = new_cap
        self._mask_dev = None          # the capacity moved: rebuilt lazily
        if self._grow_cb is not None:
            self._grow_cb(old_cap, new_cap)

    def widen_column(self, name: str, new_tail0: int) -> None:
        """Grow a column's row width in place (the recommender's and
        anomaly's Kr buckets); pages and slots stay."""
        tail, dt = self._schema[name]
        if new_tail0 <= tail[0]:
            return
        self._schema[name] = ((new_tail0,) + tail[1:], dt)
        col = self._cols[name]
        grown = self._zeros(name, self.capacity)
        grown[:, : tail[0]] = col
        self._cols[name] = grown

    # -- writes / reads ------------------------------------------------------

    def _dev_slots(self, slots) -> torch.Tensor:
        return torch.from_numpy(np.asarray(slots, np.int64)).to(self._dev)

    def _to_dev(self, name: str, vals, n: int) -> torch.Tensor:
        tail, dt = self._schema[name]
        v = np.ascontiguousarray(np.asarray(vals, dt).reshape((n,) + tail))
        if not v.flags.writeable:          # a view of wire or file bytes
            v = v.copy()
        if dt == np.uint32:
            v = v.view(np.int32)
        return torch.from_numpy(v).to(self._dev)

    def write(self, slots, cols: Dict[str, Any]) -> None:
        """Scatter a batch of rows into every named column.  Slots must be
        allocated and unique.  A column value may be host data (numpy, the
        column's dtype) or a device tensor of the stored dtype."""
        slots = np.asarray(slots, np.int64)
        n = int(slots.size)
        if not n:
            return
        if np.unique(slots).size != n:
            raise ValueError("PagedRowStore.write: slots must be unique")
        dev_slots = self._dev_slots(slots)
        for name in self._schema:
            if name not in cols:
                continue
            v = cols[name]
            if not isinstance(v, torch.Tensor):
                v = self._to_dev(name, v, n)
            self._cols[name].index_copy_(0, dev_slots, v.to(self._dev))

    def read(self, name: str, slots) -> np.ndarray:
        """Host gather of stored rows, in the column's numpy dtype."""
        idx = self._dev_slots(slots)
        out = self._cols[name].index_select(0, idx).cpu().numpy()
        dt = self._schema[name][1]
        return out.view(dt) if dt == np.uint32 else out

    def device(self, name: str) -> torch.Tensor:
        """The full flat device column, the sweeps' input."""
        return self._cols[name]

    # -- persistence helpers -------------------------------------------------

    def pack_flat(self, name: str, order_slots: Sequence[int],
                  capacity: int) -> np.ndarray:
        """The legacy flat-table layout: rows gathered in `order_slots`
        order into a zero-padded [capacity, ...] host array (the JAX
        package's model-file bytes)."""
        tail, dt = self._schema[name]
        out = np.zeros((capacity,) + tail, dt)
        slots = np.asarray(list(order_slots), np.int64)
        if slots.size:
            out[: slots.size] = self.read(name, slots)
        return out

    def clear(self, capacity: int) -> None:
        """Reset to an empty store of the given capacity."""
        self._set_capacity(capacity)
        self._init_state()

    # -- status --------------------------------------------------------------

    def get_status(self) -> Dict[str, str]:
        return {
            "page_rows": str(self.page_rows),
            "pages": str(self.n_pages),
            "paged_rows": str(self.n_rows),
            "paged_free_slots": str(self._holes),
            "pages_resident": str(self.n_pages),
        }
