"""Paged row store on one torch device (counterpart of
jubatus_tpu/models/pages.py).

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
model file's flat table (pack_flat) is byte-identical.

The spill tier (spec.resident_pages > 0): the host keeps the master copy
of every page, in pinned memory where the device is a card (a CPU tensor
with a numpy view, so page uploads and streamed chunks are asynchronous
copies), and the device keeps only a pool of resident_pages pages behind
a page table (logical page -> pool page, _page_loc / _phys_page), a bool
pool mask and, during a read, the streamed chunks' buffers.  Writes go
to the master first, then fault their pages into the pool in windows of
at most the budget, each window's pages pinned against the clock;
eviction is the JAX store's clock (second chance) exactly, so
page_spill_in_total, page_spill_out_total and pages_resident follow a
JAX store's after the same history.  Reads (ops/paged.py) sweep the pool
in one launch and stream the absent pages through the same kernels
without touching residency.  device() raises under spill; the runtime
budget (set_resident_budget, the autopilot's actuator) is not ported.

Two allocator modes share the occupancy plane, as in the JAX store:
internal (alloc/free: the page-fill frontier and the freed-slot LIFO)
and external (occupy/free: the sharded layouts, parallel/sharded_rows.py,
pick their slots themselves, shard * shard_cap + local, and keep their
own free lists; a free only punches the occupancy hole).  remap renumbers
every slot wholesale (the sharded regrow, s * cap + r -> s * 2cap + r);
place re-commits the device tensors through a `put`.

Writes are one index_copy_ per column (slots must be unique: the
callers dedupe); the JAX store pads a write to a power of two with
repeats of its last slot to reuse compiled scatters, which eager torch
does not need.  Thread contract: mutations run under the caller's model
write lock (or the recommender's and anomaly's _sync_lock on the read
path); residency changes and the pool sweep's launch take the internal
_spill_lock, so a read's pool sweep is queued before any later upload
into the pool.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from jubatus_tpu_torch.utils.metrics import GLOBAL as _metrics

DEFAULT_PAGE_ROWS = 128

# uint32 columns live on the device as int32 bit patterns (torch's uint32
# has few CPU ops); the host side of read/write stays uint32
_TORCH_DTYPES = {np.dtype(np.uint32): torch.int32,
                 np.dtype(np.int32): torch.int32,
                 np.dtype(np.float32): torch.float32}

_LIVE_STORES: "weakref.WeakSet[PagedRowStore]" = weakref.WeakSet()


def _refresh_gauges() -> None:
    """paged_pages_resident: the resident pages of every live store of
    the process (the JAX package also keeps a paged_rows gauge, whose key
    would shadow the driver's own paged_rows in get_status)."""
    _metrics.set_gauge("paged_pages_resident", float(sum(
        st.resident_pages_now for st in list(_LIVE_STORES))))


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class PageSpec:
    """Config-level paging knobs (engine config `"pages": {...}`):
    page_rows (default 128) and resident_pages (0: everything resident;
    more: the device pool's budget in pages, the spill tier)."""

    __slots__ = ("page_rows", "resident_pages")

    def __init__(self, page_rows: int = DEFAULT_PAGE_ROWS,
                 resident_pages: int = 0):
        self.page_rows = max(int(page_rows), 1)
        self.resident_pages = max(int(resident_pages), 0)

    @classmethod
    def from_config(cls, config: Optional[Dict[str, Any]]) -> "PageSpec":
        cfg = dict(config or {})
        return cls(page_rows=int(cfg.get("page_rows", DEFAULT_PAGE_ROWS)),
                   resident_pages=int(cfg.get("resident_pages", 0)))


class PagedRowStore:
    """Fixed-size-page row storage on `device`.

    columns: {name: (tail_shape, numpy dtype)}; each column is one device
    tensor [capacity, *tail], or under spill a host master [capacity,
    *tail] and a device pool [resident_pages * page_rows, *tail]."""

    def __init__(self, columns: Dict[str, Tuple[Tuple[int, ...], Any]],
                 capacity: int, device: torch.device,
                 spec: Optional[PageSpec] = None,
                 grow_cb: Optional[Callable[[int, int], None]] = None,
                 put: Optional[Callable[[torch.Tensor], torch.Tensor]]
                 = None, external_alloc: bool = False):
        self.spec = spec or PageSpec()
        self._dev = torch.device(device)
        self._grow_cb = grow_cb
        self._put = put or (lambda t: t.to(self._dev))
        self.external_alloc = external_alloc
        self._schema: Dict[str, Tuple[Tuple[int, ...], np.dtype]] = {
            n: (tuple(tail), np.dtype(dt)) for n, (tail, dt) in
            columns.items()}
        self.page_rows = self.spec.page_rows
        self._spill_lock = threading.Lock()
        self._set_capacity(capacity)
        self._init_state()
        _LIVE_STORES.add(self)
        _refresh_gauges()

    # -- state construction --------------------------------------------------

    def _set_capacity(self, capacity: int) -> None:
        """Construction and clear sizing: spill keeps the slot space
        page-aligned, so a page never runs ragged."""
        self._cap = int(capacity)
        if self.spill_mode:
            self._cap = max(-(-self._cap // self.page_rows), 1) \
                * self.page_rows
        self.n_pages = max(-(-self._cap // self.page_rows), 1)

    def _zeros(self, name: str, rows: int) -> torch.Tensor:
        tail, dt = self._schema[name]
        return torch.zeros((rows,) + tail, dtype=_TORCH_DTYPES[dt],
                           device=self._dev)

    def _host_zeros(self, name: str, rows: int) -> None:
        """A zero master column [rows, *tail] (pinned where the device is
        a card) as self._host_t[name], with its numpy view."""
        tail, dt = self._schema[name]
        t = torch.zeros((rows,) + tail, dtype=_TORCH_DTYPES[dt],
                        pin_memory=self._dev.type == "cuda")
        self._host_t[name] = t
        self._host[name] = t.numpy().view(dt)

    def _init_state(self) -> None:
        self._frontier = 0
        self._occ = np.zeros((self.capacity,), bool)
        self._free: List[int] = []
        self._holes = 0
        self._live = 0
        self._mask_dev: Optional[torch.Tensor] = None
        if self.spill_mode:
            self._host_t: Dict[str, torch.Tensor] = {}
            self._host: Dict[str, np.ndarray] = {}
            for n in self._schema:
                self._host_zeros(n, self.capacity)
            b = self.spec.resident_pages * self.page_rows
            self._pool = {n: self._zeros(n, b) for n in self._schema}
            self._page_loc = np.full((self.n_pages,), -1, np.int32)
            self._phys_page = np.full((self.spec.resident_pages,), -1,
                                      np.int32)
            self._ref = np.zeros((self.spec.resident_pages,), bool)
            self._clock = 0
            self._pool_mask = torch.zeros((b,), dtype=torch.bool,
                                          device=self._dev)
        else:
            self._cols = {n: self._zeros(n, self.capacity)
                          for n in self._schema}

    # -- shape and residency facts -------------------------------------------

    @property
    def device_of(self) -> torch.device:
        return self._dev

    @property
    def capacity(self) -> int:
        return self._cap

    @property
    def spill_mode(self) -> bool:
        return self.spec.resident_pages > 0

    @property
    def n_rows(self) -> int:
        """Live rows."""
        return self._live

    @property
    def has_holes(self) -> bool:
        return self._holes > 0

    @property
    def resident_pages_now(self) -> int:
        if not self.spill_mode:
            return self.n_pages
        return int((self._phys_page >= 0).sum())

    def column_schema(self, name: str) -> Tuple[Tuple[int, ...], np.dtype]:
        return self._schema[name]

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

    def occupy(self, slots: Sequence[int]) -> None:
        """The external allocator's entry (sharded layouts): mark slots
        live without consulting the free list."""
        slots = np.asarray(list(slots), np.int64)
        if slots.size:
            if int(slots.max()) >= self.capacity:
                self._grow_to(int(slots.max()) + 1)
            self._note_occupy(slots)

    def _note_occupy(self, slots: np.ndarray) -> None:
        if not slots.size:
            return
        self._live += int((~self._occ[slots]).sum())
        self._occ[slots] = True
        self._mask_fill(slots, True)
        if self.spill_mode:
            # residency is write-allocate: a bare alloc only mirrors the
            # occupancy into the pool mask of pages already resident
            with self._spill_lock:
                self._pool_mask_scatter(slots, True)
        _refresh_gauges()

    def free(self, slots: Sequence[int]) -> int:
        """Punch occupancy holes and return the slots to the free list,
        in the order given (one mask write on the device); under the
        external allocator the caller keeps its own free lists.  Returns
        the number of pages touched."""
        slots = np.asarray([int(s) for s in slots
                            if 0 <= int(s) < self.capacity], np.int64)
        slots = slots[self._occ[slots]]
        if not slots.size:
            return 0
        self._occ[slots] = False
        self._live -= int(slots.size)
        if not self.external_alloc:
            self._free.extend(int(s) for s in slots)
            self._holes += int(slots.size)
        self._mask_fill(slots, False)
        if self.spill_mode:
            with self._spill_lock:
                self._pool_mask_scatter(slots, False)
        _refresh_gauges()
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
        new_pages = max(_pow2(-(-need_cap // self.page_rows)),
                        self.n_pages * 2)
        new_cap = new_pages * self.page_rows
        if self.spill_mode:
            with self._spill_lock:
                for n in self._schema:
                    old = self._host_t[n]
                    self._host_zeros(n, new_cap)
                    self._host_t[n][: old.shape[0]] = old
                self._page_loc = np.pad(self._page_loc,
                                        (0, new_pages - self.n_pages),
                                        constant_values=-1)
        else:
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
        if self.spill_mode:
            with self._spill_lock:
                old = self._host_t[name]
                self._host_zeros(name, self.capacity)
                self._host_t[name][:, : tail[0]] = old
                pool = self._pool[name]
                self._pool[name] = self._zeros(name, pool.shape[0])
                self._pool[name][:, : tail[0]] = pool
            return
        col = self._cols[name]
        grown = self._zeros(name, self.capacity)
        grown[:, : tail[0]] = col
        self._cols[name] = grown

    # -- writes / reads ------------------------------------------------------

    def _dev_slots(self, slots) -> torch.Tensor:
        return torch.from_numpy(np.asarray(slots, np.int64)).to(self._dev)

    def _host_vals(self, name: str, vals, n: int) -> np.ndarray:
        """A column value as host numpy [n, *tail] in the column's dtype
        (a device tensor of the stored dtype comes back once)."""
        tail, dt = self._schema[name]
        if isinstance(vals, torch.Tensor):
            vals = vals.cpu().numpy().view(dt) if dt == np.uint32 \
                else vals.cpu().numpy()
        return np.asarray(vals, dt).reshape((n,) + tail)

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
        column's dtype) or a device tensor of the stored dtype.  Under
        spill the master first, then the pool: the batch's pages are
        faulted in windows of at most the budget, each window's pages
        pinned so the clock cannot evict one before its rows land."""
        slots = np.asarray(slots, np.int64)
        n = int(slots.size)
        if not n:
            return
        if np.unique(slots).size != n:
            raise ValueError("PagedRowStore.write: slots must be unique")
        names = [c for c in self._schema if c in cols]
        if self.spill_mode:
            vals = {c: self._host_vals(c, cols[c], n) for c in names}
            for c in names:
                self._host[c][slots] = vals[c]
            with self._spill_lock:
                spages = slots // self.page_rows
                pages = np.unique(spages)
                budget = max(self.spec.resident_pages, 1)
                for c0 in range(0, len(pages), budget):
                    win = pages[c0: c0 + budget]
                    self._ensure_resident_locked(win, pinned=set())
                    sel = np.isin(spages, win)
                    phys = self._dev_slots(self._phys_slots(slots[sel]))
                    nw = int(sel.sum())
                    for c in names:
                        self._pool[c].index_copy_(
                            0, phys, self._to_dev(c, vals[c][sel], nw))
            return
        dev_slots = self._dev_slots(slots)
        for name in names:
            v = cols[name]
            if not isinstance(v, torch.Tensor):
                v = self._to_dev(name, v, n)
            self._cols[name].index_copy_(0, dev_slots, v.to(self._dev))

    def read(self, name: str, slots) -> np.ndarray:
        """Host gather of stored rows, in the column's numpy dtype (under
        spill from the master)."""
        if self.spill_mode:
            return self._host[name][np.asarray(slots, np.int64)].copy()
        idx = self._dev_slots(slots)
        out = self._cols[name].index_select(0, idx).cpu().numpy()
        dt = self._schema[name][1]
        return out.view(dt) if dt == np.uint32 else out

    def device(self, name: str) -> torch.Tensor:
        """The full flat device column, the sweeps' input.  Undefined
        under spill, where the device holds a pool of pages
        (ops/paged.py sweeps it)."""
        if self.spill_mode:
            raise AssertionError("device() undefined under spill; route "
                                 "queries through ops/paged.py")
        return self._cols[name]

    def set_device(self, name: str, arr) -> None:
        """Adopt a whole replacement column [capacity, *tail] (bulk
        loaders; adopt_capacity first at a new size): under spill into the
        master, and the resident pages of the pool rewritten from it."""
        if self.spill_mode:
            self._host_t[name].copy_(torch.as_tensor(arr).reshape(
                self._host_t[name].shape))
            self._refresh_pool(name)
            return
        self._cols[name] = arr

    def adopt_capacity(self, cap: int) -> None:
        """Bulk loading: the caller is about to install [cap, ...] columns
        holding exactly cap live rows.  Occupancy becomes the full prefix;
        page accounting and residency restart."""
        cap = int(cap)
        aligned = cap
        if self.spill_mode:
            aligned = max(-(-cap // self.page_rows), 1) * self.page_rows
        self.n_pages = max(-(-aligned // self.page_rows), 1)
        self._cap = aligned
        self._occ = np.zeros((aligned,), bool)
        self._occ[:cap] = True
        self._frontier = cap
        self._free = []
        self._holes = 0
        self._live = cap
        self._mask_dev = None
        if self.spill_mode:
            for n in self._schema:
                self._host_zeros(n, aligned)
            self._page_loc = np.full((self.n_pages,), -1, np.int32)
            self._phys_page[:] = -1
            self._ref[:] = False
            self._pool_mask.zero_()
        else:
            self._cols = {n: self._zeros(n, aligned) for n in self._schema}
        _refresh_gauges()

    def adopt_column(self, name: str, arr) -> None:
        """Adopt a whole replacement for one column (numpy in the column's
        dtype, or a tensor of the stored dtype); a new leading size
        re-adopts the capacity first, a short one pads with zeros."""
        n0 = int(arr.shape[0])
        if n0 != self.capacity:
            self.adopt_capacity(n0)
        t = torch.as_tensor(arr.view(np.int32) if isinstance(arr, np.ndarray)
                            and arr.dtype == np.uint32 else arr)
        if self.spill_mode:
            self._host_t[name][:n0] = t
            self._refresh_pool(name)
            return
        self._cols[name][:n0] = t.to(self._dev)

    def _refresh_pool(self, name: str) -> None:
        """Rewrite one column of every resident pool page from the master
        after the master was replaced wholesale, so no read sweeps a stale
        page; residency, the clock and the counters stay as they were."""
        pr = self.page_rows
        nb = self._dev.type == "cuda"
        with self._spill_lock:
            for phys in np.nonzero(self._phys_page >= 0)[0].tolist():
                bl = int(self._phys_page[phys]) * pr
                self._pool[name][phys * pr: (phys + 1) * pr].copy_(
                    self._host_t[name][bl: bl + pr], non_blocking=nb)

    # -- sharded-layout cooperation ------------------------------------------

    def place(self, put: Optional[Callable[[torch.Tensor], torch.Tensor]]
              = None) -> None:
        """Re-commit every device tensor through `put` (kept for later
        calls; default the store's device): the sharded mixin's
        placement after construction or a widening."""
        if put is not None:
            self._put = put
        if self.spill_mode:
            self._pool = {n: self._put(t) for n, t in self._pool.items()}
            self._pool_mask = self._put(self._pool_mask)
            return
        self._cols = {n: self._put(t) for n, t in self._cols.items()}
        if self._mask_dev is not None:
            self._mask_dev = self._put(self._mask_dev)

    def remap(self, dest_rows: np.ndarray, new_capacity: int,
              make_zero: Optional[Callable] = None) -> None:
        """Wholesale slot renumbering (the sharded regrow: s * cap + r ->
        s * 2cap + r): every column lands in a fresh [new_capacity, ...]
        tensor (make_zero(shape, numpy dtype), default zeros on the
        store's device) at dest_rows, one index_copy_ a column, and the
        occupancy follows.  Callers renumber their id maps and
        mark_rebuild() the candidate index: the one paged-layout event
        that still moves slots."""
        if self.spill_mode:
            raise ValueError("a spilled store does not remap (the sharded "
                             "layouts keep every page resident)")
        dest = np.asarray(dest_rows, np.int64)
        nd = self._dev_slots(dest)
        for n, (tail, dt) in self._schema.items():
            if make_zero is not None:
                new = make_zero((new_capacity,) + tail, dt)
            else:
                new = self._zeros(n, new_capacity)
            self._cols[n] = new.index_copy_(0, nd, self._cols[n])
        occ = np.zeros((new_capacity,), bool)
        occ[dest[self._occ[: dest.shape[0]]]] = True
        self._occ = occ
        # an external layout may pick a capacity that is no multiple of
        # the page: its ragged tail counts as a short page
        self.n_pages = -(-new_capacity // self.page_rows)
        self._cap = new_capacity
        self._frontier = new_capacity
        self._free = []
        self._holes = 0
        self._live = int(occ.sum())
        self._mask_dev = None
        _refresh_gauges()

    # -- the spill tier ------------------------------------------------------

    def _pool_mask_scatter(self, slots: np.ndarray, val: bool) -> None:
        """Mirror occupancy changes into the pool mask of the resident
        slots (caller holds _spill_lock)."""
        loc = self._page_loc[slots // self.page_rows]
        res = loc >= 0
        if not res.any():
            return
        phys = loc[res].astype(np.int64) * self.page_rows \
            + slots[res] % self.page_rows
        self._pool_mask.index_fill_(0, self._dev_slots(phys), val)

    def _phys_slots(self, slots: np.ndarray) -> np.ndarray:
        pages = slots // self.page_rows
        return (self._page_loc[pages].astype(np.int64) * self.page_rows
                + slots % self.page_rows)

    def _ensure_resident_locked(self, pages: np.ndarray,
                                pinned: Optional[set] = None) -> None:
        """Fault `pages` in; `pinned` gathers their pool pages so the clock
        never evicts one page of the batch for another (callers keep
        len(pages) <= resident_pages)."""
        for p in pages:
            p = int(p)
            if self._page_loc[p] >= 0:
                self._ref[self._page_loc[p]] = True
                if pinned is not None:
                    pinned.add(int(self._page_loc[p]))
                continue
            phys = self._evict_victim_locked(pinned)
            self._upload_page_locked(p, phys)
            if pinned is not None:
                pinned.add(phys)

    def _evict_victim_locked(self, pinned: Optional[set] = None) -> int:
        """The clock (second chance), the JAX store's: an empty pool page
        first, else referenced pages get one more pass and pinned ones
        are never victims.  Eviction drops the mapping only: the master
        holds every page."""
        b = self.spec.resident_pages
        empty = np.nonzero(self._phys_page < 0)[0]
        if empty.size:
            return int(empty[0])
        for _ in range(3 * b + 1):
            h = self._clock
            self._clock = (self._clock + 1) % b
            if pinned is not None and h in pinned:
                continue
            if self._ref[h]:
                self._ref[h] = False
                continue
            self._page_loc[int(self._phys_page[h])] = -1
            self._phys_page[h] = -1
            base = h * self.page_rows
            self._pool_mask[base: base + self.page_rows] = False
            _metrics.inc("page_spill_out_total")
            return h
        raise AssertionError("clock found no victim")   # pragma: no cover

    def _upload_page_locked(self, page: int, phys: int) -> None:
        """One page of the master into pool page `phys`: an asynchronous
        copy from pinned memory on the card."""
        bl, bp, pr = page * self.page_rows, phys * self.page_rows, \
            self.page_rows
        nb = self._dev.type == "cuda"
        for n in self._schema:
            self._pool[n][bp: bp + pr].copy_(self._host_t[n][bl: bl + pr],
                                              non_blocking=nb)
        self._pool_mask[bp: bp + pr].copy_(
            torch.from_numpy(self._occ[bl: bl + pr]))
        self._page_loc[page] = phys
        self._phys_page[phys] = page
        self._ref[phys] = True
        _metrics.inc("page_spill_in_total")
        _refresh_gauges()

    def sweep_pool(self, names: Sequence[str],
                   launch: Callable[[Dict[str, torch.Tensor],
                                     torch.Tensor], Any]):
        """Under one hold of the spill lock: `launch` the pool sweep on
        the pool columns and the pool mask (queued before any later upload
        into the pool),
        and take the page map and the absent occupied pages (ascending)
        of that same moment -> (launch's result, pool page -> logical
        page, absent pages).  Streamed reads count page_spill_in_total
        per absent page, as the JAX store's do."""
        with self._spill_lock:
            res = launch({n: self._pool[n] for n in names},
                         self._pool_mask)
            phys_page = self._phys_page.copy()
            absent = np.nonzero((self._page_loc < 0)
                                & (self._page_occ_vec() > 0))[0]
        if absent.size:
            _metrics.inc("page_spill_in_total", float(absent.size))
        return res, phys_page, absent

    def host_column(self, name: str) -> torch.Tensor:
        """The master of one column (a CPU tensor, pinned on a card; spill
        only): the streamed chunks' source."""
        return self._host_t[name]

    def _page_occ_vec(self) -> np.ndarray:
        return self._occ.reshape(self.n_pages, self.page_rows).sum(axis=1)

    def device_bytes(self) -> int:
        """Bytes the store holds on its device: the columns, or under
        spill the pool and its mask (and mask_dev where built)."""
        cols = self._pool if self.spill_mode else self._cols
        out = sum(t.numel() * t.element_size() for t in cols.values())
        if self.spill_mode:
            out += self._pool_mask.numel()
        if self._mask_dev is not None:
            out += self._mask_dev.numel()
        return out

    # -- persistence helpers -------------------------------------------------

    def pack_flat(self, name: str, order_slots: Sequence[int],
                  capacity: int) -> np.ndarray:
        """The legacy flat-table layout: rows gathered in `order_slots`
        order into a zero-padded [capacity, ...] host array (the JAX
        package's model-file bytes, under spill too)."""
        tail, dt = self._schema[name]
        out = np.zeros((capacity,) + tail, dt)
        slots = np.asarray(list(order_slots), np.int64)
        if slots.size:
            out[: slots.size] = self.read(name, slots)
        return out

    def clear(self, capacity: int) -> None:
        """Reset to an empty store of the given capacity (the construction
        sizing: every plane sizes off the new capacity)."""
        self._set_capacity(capacity)
        self._init_state()
        _refresh_gauges()

    # -- status --------------------------------------------------------------

    def get_status(self) -> Dict[str, str]:
        st = {
            "page_rows": str(self.page_rows),
            "pages": str(self.n_pages),
            "paged_rows": str(self.n_rows),
            "paged_free_slots": str(self._holes),
            "pages_resident": str(self.resident_pages_now),
        }
        if self.spill_mode:
            st["resident_budget_pages"] = str(self.spec.resident_pages)
        return st
