"""Host-mirrored inverted bucket lists with a device CSR view (counterpart
of jubatus_tpu/index/store.py, numpy only, the same packs, caps, truncation,
delta and version rules).

The source of truth is a small host assignment table: for every row
slot, the bucket it belongs to in each band (-1 = no row).  Writers
(update_row/set_row/drop, running under the model WRITE lock) mutate
assignments in O(bands) and append the row to a bounded DELTA list; the
query path (READ lock) lazily packs the assignments into a CSR layout —
flat row-id array grouped by (band, bucket) + per-group offset/len —
only when the delta overflows or staleness crosses a threshold, so
steady-state updates never pay an O(rows) repack and queries between
packs still see fresh rows via the always-probed delta vector.

Slabs generalize the layout to the sharded driver's [S, cap, W] stack
(parallel/sharded.py): one assignment plane per shard, packed into
stacked [S, ...] CSR arrays with one bucket capacity, so every shard's
K6 launch reads its slab at the same shapes.  A one-slab store's views
come without the slab axis (packed(squeeze=True), the default), the
arrays every unsharded driver and K6 take.
"""

from __future__ import annotations

import threading
from typing import List, Tuple

import numpy as np


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class BucketStore:
    """Inverted lists for `n_bands` bands of `n_buckets` buckets each
    (group id = band * n_buckets + bucket), over `n_slabs` row planes."""

    def __init__(self, n_bands: int, n_buckets: int, n_slabs: int = 1,
                 delta_cap: int = 2048):
        self.n_bands = int(n_bands)
        self.n_buckets = int(n_buckets)
        self.n_groups = self.n_bands * self.n_buckets
        self.n_slabs = int(n_slabs)
        self.delta_cap = max(16, int(delta_cap))
        self.capacity = 0
        self.assign = np.full((self.n_slabs, self.n_bands, 0), -1, np.int32)
        self._delta: List[List[int]] = [[] for _ in range(self.n_slabs)]
        self._stale = 0
        self._live = 0
        self.truncated_rows = 0     # memberships over the bucket-cap bound
        self._needs_pack = True
        self._delta_dirty = True
        self.version = 0            # bumped on every pack/delta change
        self._packed = None         # (flat, offsets, lens, cap) numpy
        self._delta_np = None       # [slabs, Dcap] numpy
        self._lock = threading.Lock()

    # -- write-path maintenance (model write lock held by the caller) -------

    def ensure_capacity(self, capacity: int) -> None:
        if capacity <= self.capacity:
            return
        pad = capacity - self.capacity
        self.assign = np.pad(self.assign, ((0, 0), (0, 0), (0, pad)),
                             constant_values=-1)
        self.capacity = capacity

    def note_rows(self, rows: np.ndarray, buckets: np.ndarray,
                  slab: int = 0) -> None:
        """Upsert rows' bucket assignments: rows [n] slot ids, buckets
        [n_bands, n] values in [0, n_buckets).  Newly indexed rows ride
        the delta until the next pack."""
        rows = np.asarray(rows, np.int64)
        if not rows.size:
            return
        with self._lock:
            self.ensure_capacity(int(rows.max()) + 1)
            prev = self.assign[slab][:, rows]
            self._live += int((prev[0] < 0).sum())
            # a MOVED row's old CSR entry goes stale (it still rescores
            # exactly — only a wasted candidate slot until the next pack)
            self._stale += int(
                ((prev[0] >= 0) & (prev != buckets).any(0)).sum())
            self.assign[slab][:, rows] = buckets
            d = self._delta[slab]
            d.extend(int(r) for r in rows)
            self._delta_dirty = True
            if len(d) > self.delta_cap or self._stale_excessive():
                self._needs_pack = True
            self.version += 1

    def invalidate_rows(self, rows, slab: int = 0) -> None:
        """Row slots freed (drop/clear_row): validity masking already
        hides them from rescore results, so only staleness accounting
        and the assignment plane change — no pack on the write path."""
        rows = [int(r) for r in rows if 0 <= int(r) < self.capacity]
        if not rows:
            return
        with self._lock:
            was = self.assign[slab][0, rows] >= 0
            self._live -= int(was.sum())
            self._stale += int(was.sum())
            self.assign[slab][:, rows] = -1
            if self._stale_excessive():
                self._needs_pack = True
            self.version += 1

    def _stale_excessive(self) -> bool:
        return self._stale > max(1024, self._live // 4)

    def clear(self) -> None:
        with self._lock:
            self.capacity = 0
            self.assign = np.full((self.n_slabs, self.n_bands, 0), -1,
                                  np.int32)
            self._delta = [[] for _ in range(self.n_slabs)]
            self._stale = 0
            self._live = 0
            self._needs_pack = True
            self._delta_dirty = True
            self._packed = None
            self._delta_np = None
            self.version += 1

    @property
    def live_rows(self) -> int:
        return self._live

    # -- query-path views ----------------------------------------------------

    def packed(self, squeeze: bool = True
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                          int]:
        """(flat [S, Fp], offsets [S, G], lens [S, G], delta [S, Dcap],
        bucket_cap) numpy views, packing lazily; at one slab with squeeze
        (flat [Fp], offsets [G], lens [G], delta [Dcap], bucket_cap).
        Serialized under the store lock: concurrent read-lock holders
        pack once."""
        return self.packed_versioned(squeeze)[:5]

    def packed_versioned(self, squeeze: bool = True):
        """packed() plus the version these views correspond to, captured
        UNDER the store lock — a caller stamping a cache must not read
        `version` afterwards, or a write racing between pack and stamp
        would tag stale views with the newer version and hide the fresh
        row until the next mutation."""
        with self._lock:
            if self._packed is None or self._needs_pack:
                self._pack()
            elif self._delta_dirty:
                self._pack_delta()
            flat, offsets, lens, cap = self._packed
            delta = self._delta_np
            if squeeze and self.n_slabs == 1:
                flat, offsets, lens, delta = (flat[0], offsets[0], lens[0],
                                              delta[0])
            return flat, offsets, lens, delta, cap, self.version

    def _pack(self) -> None:
        raw = []
        all_counts = []
        for s in range(self.n_slabs):
            a = self.assign[s]                         # [bands, capacity]
            valid = a >= 0
            g = (a + (np.arange(self.n_bands, dtype=np.int64)
                      * self.n_buckets)[:, None])[valid]
            r = np.broadcast_to(
                np.arange(self.capacity, dtype=np.int64)[None, :],
                a.shape)[valid]
            order = np.argsort(g, kind="stable")
            flat = r[order].astype(np.int32)
            counts = np.bincount(g, minlength=self.n_groups) \
                .astype(np.int32)
            raw.append((flat, counts))
            all_counts.append(counts)
        # bucket-capacity bound: the probe kernel's gather width is the
        # MAX group length, so a handful of pathologically fat buckets
        # (e.g. a popular second-choice IVF cell) would inflate EVERY
        # probe's cost.  Bound at max(p99, 8x mean) of the non-empty
        # groups; truncated rows stay reachable via their other bands
        # (lsh: 7 sibling bands; ivf: the rank-1 cell is never the
        # truncated one for most rows) and via the full-sweep fallback.
        nonempty = np.concatenate(all_counts)
        nonempty = nonempty[nonempty > 0]
        max_count = int(nonempty.max(initial=1)) if nonempty.size else 1
        bound = int(max(np.percentile(nonempty, 99),
                        8.0 * nonempty.mean(), 16)) if nonempty.size else 1
        cap = _pow2(min(max_count, bound))
        self.truncated_rows = 0
        per_slab = []
        max_len = 1
        for flat, counts in raw:
            offsets = np.zeros((self.n_groups,), np.int32)
            np.cumsum(counts[:-1], out=offsets[1:])
            if int(counts.max(initial=0)) > cap:
                pos = np.arange(len(flat), dtype=np.int64) \
                    - np.repeat(offsets.astype(np.int64), counts)
                keep = pos < cap
                self.truncated_rows += int((~keep).sum())
                flat = flat[keep]
                counts = np.minimum(counts, cap)
                offsets = np.zeros((self.n_groups,), np.int32)
                np.cumsum(counts[:-1], out=offsets[1:])
            per_slab.append((flat, offsets, counts))
            max_len = max(max_len, len(flat))
        # tail pad by `cap` so a last-group dynamic_slice never clamps
        fp = _pow2(max_len) + cap
        flat_np = np.full((self.n_slabs, fp), -1, np.int32)
        off_np = np.zeros((self.n_slabs, self.n_groups), np.int32)
        len_np = np.zeros((self.n_slabs, self.n_groups), np.int32)
        for s, (flat, offsets, counts) in enumerate(per_slab):
            flat_np[s, : len(flat)] = flat
            off_np[s] = offsets
            len_np[s] = counts
        self._packed = (flat_np, off_np, len_np, cap)
        self._delta = [[] for _ in range(self.n_slabs)]
        self._stale = 0
        self._needs_pack = False
        self._pack_delta()

    def _pack_delta(self) -> None:
        dcap = _pow2(self.delta_cap)
        d = np.full((self.n_slabs, dcap), -1, np.int32)
        for s, lst in enumerate(self._delta):
            tail = lst[-dcap:]
            if tail:
                d[s, : len(tail)] = np.asarray(tail, np.int32)
        self._delta_np = d
        self._delta_dirty = False

    def get_status(self):
        # report the cached pack only — a status poll must never trigger
        # an O(rows) repack
        with self._lock:
            cap = self._packed[3] if self._packed is not None else 0
            return {
                "index_bucket_cap": str(cap),
                "index_groups": str(self.n_groups),
                "index_live_rows": str(self._live),
                "index_truncated_rows": str(self.truncated_rows),
                "index_delta_pending": str(
                    sum(len(d) for d in self._delta)),
            }
