"""Index spec + shared CandidateIndex behavior (stats, device cache);
counterpart of jubatus_tpu/index/base.py.

An index is DERIVED state: it is never journaled, never packed into the
model file, and never rides a MIX diff — it rebuilds lazily from the row
table (mark_rebuild) after recovery, bootstrap, handoff drops, or
unpack.  Maintenance runs under the model write lock (numpy-only, no
blocking); the query path packs/uploads lazily under the store lock.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from jubatus_tpu_torch.index.store import BucketStore
from jubatus_tpu_torch.utils import metrics as _metrics

INDEX_KINDS = ("off", "lsh_probe", "ivf")


@dataclass
class IndexSpec:
    """--index/--index_probes (+ config-level tuning) for one driver.

    kind       lsh_probe (sig methods) | ivf (exact dense methods)
    probes     buckets probed per query (recall knob; default 4)
    bits       band width in bits -> 2^bits buckets per band (lsh_probe)
    min_rows   full sweep below this row count (an index on a small
               table costs more than it prunes; 0 engages always)
    delta_cap  rows indexed since the last CSR pack that still serve
               from the always-probed delta vector
    embed_dim  count-sketch coarse space width (ivf; power of two)
    centroids  coarse centroid count (ivf; 0 = auto ~ 2*sqrt(rows))
    """

    kind: str = "off"
    probes: int = 4
    bits: int = 8
    min_rows: int = 8192
    delta_cap: int = 2048
    embed_dim: int = 64
    centroids: int = 0

    def __post_init__(self):
        if self.kind not in INDEX_KINDS:
            raise ValueError(f"unknown index kind: {self.kind!r} "
                             f"(have {INDEX_KINDS})")
        if self.probes <= 0:
            raise ValueError("index probes must be > 0")
        if self.bits <= 0 or self.bits > 24:
            raise ValueError("index bits must be in 1..24")
        if self.embed_dim & (self.embed_dim - 1):
            raise ValueError("index embed_dim must be a power of two")


def make_index_spec(kind: str, probes: int = 4, **kw) -> IndexSpec:
    return IndexSpec(kind=kind, probes=int(probes), **kw)


def tie_aware_recall(full, pruned, k: int) -> float:
    """THE recall definition of the golden harness and the bench
    artifact (one implementation so the enforced in-suite bound and the
    emitted sublinear_query_* numbers cannot drift): the fraction of
    the pruned top-k whose EXACT scores reach the full sweep's k-th
    score, on a descending-similarity surface.  A returned row tying
    the boundary score is a hit even when the full sweep's device-order
    tie-break picked a different member of the tie — pruned scores are
    exact, so ties carry identical values."""
    if not full:
        return 1.0
    kth = min(s for _, s in full[:k])
    if not pruned:
        return 0.0
    return sum(1 for _, s in pruned[:k] if s >= kth - 1e-9) / min(
        k, len(full))


class CandidateIndex:
    """Shared plumbing: bucket store, device CSR cache, rebuild flag,
    per-sweep stats for the read.sweep span tags + obs counters."""

    def __init__(self, spec: IndexSpec, n_bands: int, n_buckets: int,
                 n_slabs: int = 1, put=None):
        self.spec = spec
        self.store = BucketStore(n_bands, n_buckets, n_slabs=n_slabs,
                                 delta_cap=spec.delta_cap)
        self._put = put if put is not None else (lambda a: a)
        self.needs_rebuild = True      # built lazily from the row table
        self.rebuild_lock = threading.Lock()   # one query-path rebuilder
        self._dev = None     # ((version, squeeze), flat, offsets, lens, delta)
        self._dev_lock = threading.Lock()
        self._tls = threading.local()

    # -- lifecycle -----------------------------------------------------------

    def mark_rebuild(self) -> None:
        """The row table changed wholesale (recovery/unpack/handoff
        rebuild/clear): re-derive every assignment lazily on the next
        query instead of journaling index state."""
        self.store.clear()
        self.needs_rebuild = True

    ready = True      # IVF overrides: False until centroids trained

    def engaged(self, n_rows: int) -> bool:
        return n_rows >= max(int(self.spec.min_rows), 1)

    def stale(self, n_rows: int) -> bool:
        """Must the driver re-derive this index before the next indexed
        query?  Base: only after a wholesale table change; IVF also
        retrains when the table doubles (_index_for_query consults this
        on every engaged query — the 2x-growth retrain would otherwise
        be unreachable in steady operation)."""
        return self.needs_rebuild

    # -- device CSR cache ----------------------------------------------------

    def device_csr(self, squeeze: bool = True):
        """(flat, offsets, lens, delta, cap) with arrays on the driver's
        torch device (`put`), re-uploaded only when the host pack
        changed: the stacked [S, ...] slabs, or at one slab with squeeze
        the plane's own arrays (BucketStore.packed)."""
        # version captured under the store lock WITH the views: reading
        # it afterwards would let a racing write stamp stale views with
        # the newer version (hiding its row until the next mutation)
        flat, offsets, lens, delta, cap, version = \
            self.store.packed_versioned(squeeze)
        key = (version, squeeze and self.store.n_slabs == 1)
        with self._dev_lock:
            if self._dev is None or self._dev[0] != key:
                self._dev = (key, self._put(flat), self._put(offsets),
                             self._put(lens), self._put(delta))
                _metrics.GLOBAL.set_gauge("index_rows",
                                          float(self.store.live_rows))
            _, f, o, ln, d = self._dev
            return f, o, ln, d, cap

    # -- per-sweep stats (obs plane) -----------------------------------------

    def note_query(self, candidates: int, n_rows: int,
                   fallback: bool = False) -> None:
        reg = _metrics.GLOBAL
        reg.inc("index_probe_total")
        if fallback:
            reg.inc("index_fallback_total")
        if n_rows > 0:
            reg.observe_value("index_candidate_ratio",
                              min(1.0, candidates / n_rows))
        # thread-local: the read lane's sweep runs driver code on ONE
        # thread, so dispatch can pick these up for the span tags
        self._tls.stats = (int(candidates), int(n_rows), bool(fallback))

    def take_stats(self):
        stats = getattr(self._tls, "stats", None)
        self._tls.stats = None
        return stats

    def get_status(self):
        st = {"index": self.spec.kind,
              "index_probes": str(self.spec.probes),
              "index_min_rows": str(self.spec.min_rows),
              "index_needs_rebuild": str(int(self.needs_rebuild))}
        st.update(self.store.get_status())
        return st
