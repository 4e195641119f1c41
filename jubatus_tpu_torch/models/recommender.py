"""Recommender engine over a sparse row table on one torch device
(counterpart of jubatus_tpu/models/recommender.py).

Methods inverted_index and inverted_index_euclid (exact), lsh, minhash and
euclid_lsh (signature estimates), and nearest_neighbor_recommender (an
embedded signature method), each with an optional {unlearner: lru,
unlearner_parameter: {max_size}}.

The row store is a PagedRowStore (models/pages.py) on the driver's device:
indices [R, Kr] int32, values [R, Kr] float32 and norms [R], plus the
signature table of the signature methods.  Kr grows through the JAX
package's buckets (32, 64, ..., 4096, then multiples of 4096).  The host
keeps each row's sparse dict as the source of truth (update_row merges
columns into it, decode_row and complete_row read it); dirty rows reach
the device in one write a batch when a query syncs them, with norms and
signatures computed as the JAX driver computes them (numpy norms; K1/K2
signatures signed as a batch of the dirty rows).  A dropped row (clear_row,
the LRU unlearner) is a hole in the store's occupancy mask, and its slot
is reused in the JAX store's order, so the reads' ties name the same rows.

A query is one sweep of the whole table with its top-k on the card: the
exact methods through K4 dense_topk (the gather-dot in XLA's order, the
cosine or euclid score, the mask, the top kb keys), the signature methods
through K1/K2 and K3 sig_topk with the validity mask; only [Nq, kb] keys
leave the card.  The read lane's similar_row_from_datum_many signs all its
signature queries as one batch padded to round_b, as the JAX driver does.

With --index (configure_index) a table of at least min_rows rows serves
similar_row_from_* through the sublinear candidate index: lsh_probe for
the signature methods (index/lsh_probe.py; a datum read is K1/K2 and one
K6 launch, the read lane's batch one K6 launch), ivf for the exact methods
(index/ivf.py; one K7 launch: the query's count-sketch embedding, its top
centroids, their lists and the delta rescored exactly).  A read whose
candidates under-fill its answer falls back to the full sweep (K3 or K4),
as in the JAX driver.  The index is derived state: the dirty-row write
notes it, a removed row is invalidated in it, unpack marks it for a lazy
rebuild; it is never journaled, packed or mixed.

With a spill config (pages.resident_pages > 0) the store keeps its master
on the host and a pool of resident pages on the card (models/pages.py):
the dirty rows' write faults their pages in, and a read sweeps the pool
and streams the absent pages (ops/paged.py): the exact methods through K4
dense_dots, then the JAX driver's numpy float32 score on the host; the
signature methods through K1/K2 and K5's scores mode; the top-k on the
host.  The read lane's batch reads each query so; an engaged index is
bypassed.

MIX: a row-table union with tombstones (clear_row travels as None), the
revert table, and the converter's weight diff.  Model files (pack) cross
packages unchanged.

The partition plane (framework/partition.py, --routing partition): a
server's resident rows are its hash range, so its ordinary sweep is the
range-restricted leg.  partition_query_fv resolves a row id at its
owner to the stored sparse row, and similar_row_from_fv_partial sweeps
this server's rows with it through _similar (K4 dense_topk, K7 with ivf
engaged, K4 dense_dots over a spilled table; K1/K2 then K3, K6 or K5 for
the signature methods); partition_pack_rows (rows and their revert
entries), partition_apply_rows (resident ids skipped, nothing gossiped)
and partition_drop_rows (no tombstones, one store free) carry the
handoff, and put_diff keeps only the rows this server owns or holds.
The JAX driver's query tier has no counterpart: get_status reports the
driver's device.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from jubatus_tpu_torch.batching.bucketing import round_b
from jubatus_tpu_torch.device import device_context, resolve_device
from jubatus_tpu_torch.fv import (ConverterConfig, Datum, DatumToFVConverter,
                                  SparseBatch)
from jubatus_tpu_torch.fv.weight_manager import WeightManager
from jubatus_tpu_torch.index import IndexSpec, IvfIndex, SigProbeIndex
from jubatus_tpu_torch.models.base import Driver, register_driver
from jubatus_tpu_torch.models.pages import PagedRowStore, PageSpec
from jubatus_tpu_torch.ops import candidates as candops
from jubatus_tpu_torch.ops import lsh as lshops
from jubatus_tpu_torch.ops import paged as pagedops

EXACT_METHODS = ("inverted_index", "inverted_index_euclid")
APPROX_METHODS = ("lsh", "minhash", "euclid_lsh")
METHODS = EXACT_METHODS + APPROX_METHODS + ("nearest_neighbor_recommender",)

_KR_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096)
COMPLETE_ROW_NEIGHBORS = 20
DEFAULT_SEED = 0x1EAF


def _round_kr(k: int) -> int:
    for b in _KR_BUCKETS:
        if k <= b:
            return b
    return ((k + 4095) // 4096) * 4096


def _to_str(x) -> str:
    return x.decode() if isinstance(x, bytes) else x


class SparseRowTable:
    """The row engines' shared host and device row state: ids, host rows
    (the source of truth), the LRU order, the paged store with its Kr
    bucket, and the dirty rows awaiting their device write."""

    INITIAL_ROWS = 128

    def _init_rows(self, config: Dict[str, Any], sig_method: Optional[str],
                   hash_num: int, keep_revert: bool) -> None:
        self.sig_method = sig_method
        self.hash_num = hash_num
        self.converter = DatumToFVConverter(
            ConverterConfig.from_json(config.get("converter")),
            keep_revert=keep_revert)
        self.dim = self.converter.dim
        self.ids: Dict[str, int] = {}
        self.row_ids: List[str] = []
        self.rows: Dict[str, Dict[int, float]] = {}
        self._lru: List[str] = []
        self._page_spec = PageSpec.from_config(config.get("pages"))
        self.kr = _KR_BUCKETS[0]
        self._alloc()
        self._dirty: Dict[str, bool] = {}
        self._pending: Dict[str, Optional[Dict]] = {}
        self._diff_rows = None
        self.index = None   # sublinear query index (configure_index)
        # reads run under the model's read lock, concurrently, and a read
        # writes the dirty rows: one at a time
        self._sync_lock = threading.Lock()

    def _store_columns(self) -> Dict[str, Any]:
        cols = {"indices": ((self.kr,), np.int32),
                "values": ((self.kr,), np.float32),
                "norms": ((), np.float32)}
        if self.sig_method is not None:
            cols["sig"] = ((lshops.sig_width(self.sig_method,
                                             self.hash_num),), np.uint32)
        return cols

    # the hooks the sharded mixin (parallel/sharded_rows.py) overrides:
    # the external allocator (it picks slots shard * shard_cap + local and
    # reports them to the store), the first capacity (a whole number of
    # shards) and the tensors' placement
    PAGES_EXTERNAL_ALLOC = False

    def _initial_capacity(self) -> int:
        return self.INITIAL_ROWS

    def _store_put(self, t):
        return t.to(self.device)

    def _alloc(self) -> None:
        self.pages = PagedRowStore(self._store_columns(),
                                   capacity=self._initial_capacity(),
                                   device=self.device, spec=self._page_spec,
                                   grow_cb=self._on_pages_grow,
                                   put=self._store_put,
                                   external_alloc=self.PAGES_EXTERNAL_ALLOC)

    def _on_pages_grow(self, old_cap: int, new_cap: int) -> None:
        """Host tables that track the store's slot space grow with it."""

    @property
    def capacity(self) -> int:
        return self.pages.capacity

    def _grow_kr(self, need: int) -> None:
        new_kr = _round_kr(need)
        if new_kr <= self.kr:
            return
        self.pages.widen_column("indices", new_kr)
        self.pages.widen_column("values", new_kr)
        self.kr = new_kr

    def _row(self, id_: str) -> int:
        row = self.ids.get(id_)
        if row is None:
            row = self.pages.alloc1()
            self.ids[id_] = row
            while len(self.row_ids) <= row:
                self.row_ids.append("")
            self.row_ids[row] = id_
        return row

    def _dirty_batch(self, dirty: List[str], nb: int):
        """(slots [nb], indices [nb, Kr], values [nb, Kr], norms [nb]) of
        the dirty rows, padded to nb with repeats of the last row; norms
        are the JAX driver's numpy arithmetic."""
        n = len(dirty)
        kmax = max((len(self.rows[i]) for i in dirty), default=1)
        self._grow_kr(kmax)
        rows_np = np.zeros((nb,), np.int64)
        idx_np = np.zeros((nb, self.kr), np.int32)
        val_np = np.zeros((nb, self.kr), np.float32)
        for j, id_ in enumerate(dirty):
            r = self.rows[id_]
            rows_np[j] = self.ids[id_]
            if r:
                idx_np[j, : len(r)] = np.fromiter(r.keys(), np.int32, len(r))
                val_np[j, : len(r)] = np.fromiter(r.values(), np.float32,
                                                  len(r))
        if nb > n:
            rows_np[n:] = rows_np[n - 1]
            idx_np[n:] = idx_np[n - 1]
            val_np[n:] = val_np[n - 1]
        norms = np.sqrt((val_np * val_np).sum(axis=1)).astype(np.float32)
        return rows_np, idx_np, val_np, norms

    def _write_dirty(self, nb_of=lambda n: n):
        """One store write (one index_copy_ a column) of the dirty rows,
        their signatures signed as the JAX driver signs them: a batch of
        nb_of(n) rows (the recommender signs the n rows, anomaly pads
        them to a power of two).  Returns the rows' (slots, norms), or
        None when nothing was dirty."""
        dirty = [i for i in self._dirty if i in self.ids]
        self._dirty.clear()
        if not dirty:
            return None
        n = len(dirty)
        nb = nb_of(n)
        rows_np, idx_np, val_np, norms = self._dirty_batch(dirty, nb)
        cols = {"indices": idx_np[:n], "values": val_np[:n],
                "norms": norms[:n]}
        if self.sig_method is not None:
            with device_context(self.device):
                sig = lshops.host_signature(
                    self.key, idx_np, val_np, self.hash_num,
                    self.sig_method, self.device)
            cols["sig"] = sig[:n]
            if self.index is not None:
                self.index.note_sigs(rows_np[:n], sig[:n])
        elif self.index is not None:
            self.index.note_rows(rows_np[:n], idx_np[:n], val_np[:n])
        self.pages.write(rows_np[:n], cols)
        return rows_np[:n], norms[:n]

    def get_all_rows(self) -> List[str]:
        return [i for i in self.row_ids if i]

    def _index_sig_rebuild(self, slots: np.ndarray) -> None:
        self.index.rebuild_from({0: (slots, self.pages.read("sig", slots))})

    def _clear_rows(self) -> None:
        self.ids.clear()
        self.row_ids = []
        self.rows.clear()
        self._lru = []
        self.kr = _KR_BUCKETS[0]
        self._alloc()
        self._dirty.clear()
        self._pending.clear()
        self.converter.weights.clear()
        if self.index is not None:
            self.index.store.clear()

    def _retire_pending(self) -> None:
        """put_diff retires exactly the rows its round's get_diff took:
        rows written between the two survive to the next round."""
        snap = self._diff_rows
        if snap is not None:
            for k, rec in snap.items():
                cur = self._pending.get(k, False)   # False: absent
                if cur is not False and \
                        (dict(cur) if cur is not None else None) == rec:
                    del self._pending[k]
            self._diff_rows = None

    def _pending_rows(self) -> Dict[str, Optional[Dict]]:
        rows = {k: (dict(v) if v is not None else None)
                for k, v in self._pending.items()}
        self._diff_rows = rows
        return rows

    @staticmethod
    def _host_rows(obj_rows) -> Dict[str, Dict[int, float]]:
        return {_to_str(i): {int(k): float(v) for k, v in row.items()}
                for i, row in obj_rows.items()}


@register_driver("recommender")
class RecommenderDriver(SparseRowTable, Driver):

    def __init__(self, config: Dict[str, Any], device=None):
        Driver.__init__(self, config)
        self.device = resolve_device(device)
        self.method = config.get("method", "inverted_index")
        if self.method not in METHODS:
            raise ValueError(f"unknown recommender method: {self.method}")
        param = dict(config.get("parameter") or {})
        if self.method == "nearest_neighbor_recommender":
            sig_method = param.get("method", "euclid_lsh")
            hash_num = int((param.get("parameter") or {}).get("hash_num",
                                                              64))
        elif self.method in APPROX_METHODS:
            sig_method = self.method
            hash_num = int(param.get("hash_num", 64))
        else:
            sig_method, hash_num = None, 0
        self.seed = int(param.get("seed", DEFAULT_SEED))
        self.key = lshops.prng_key(self.seed)
        self.unlearner = param.get("unlearner")
        up = param.get("unlearner_parameter") or {}
        self.max_size = int(up.get("max_size", 0)) if self.unlearner else 0
        if self.unlearner and self.unlearner != "lru":
            raise ValueError(f"unknown unlearner: {self.unlearner}")
        self._init_rows(config, sig_method, hash_num, keep_revert=True)

    # -- sublinear query index (jubatus_tpu_torch/index/) ---------------------

    def configure_index(self, kind: str, probes: int = 4, **kw) -> bool:
        """--index: the signature methods (and nearest_neighbor_
        recommender's embedded one) take lsh_probe, the exact methods ivf;
        a kind that does not fit, or an ivf `embed_dim` K7 does not take
        (candops.IVF_EMBED_DIMS: above 2^30), returns False, keeps the
        full sweep and names the reason in index_decline_reason."""
        self.index = None
        self.index_decline_reason = None
        if kind == "lsh_probe" and self.sig_method is not None:
            spec = IndexSpec(kind="lsh_probe", probes=int(probes),
                             **self._index_spec_kwargs(kw))
            self.index = SigProbeIndex(self.sig_method, self.hash_num, spec,
                                       put=self._index_put)
            return True
        if kind == "ivf" and self.sig_method is None:
            spec = IndexSpec(kind="ivf", probes=int(probes),
                             **self._index_spec_kwargs(kw))
            if spec.embed_dim not in candops.IVF_EMBED_DIMS:
                self.index_decline_reason = candops.IVF_WIDE_REFUSAL
                return False
            self.index = IvfIndex(self._metric(), spec, put=self._index_put)
            return True
        return False

    def _index_rebuild(self) -> None:
        """Lazy rebuild from the (synced) device table, slots in order."""
        slots = np.array(sorted(self.ids.values()), np.int64)
        if self.sig_method is not None:
            self._index_sig_rebuild(slots)
        else:
            self.index.rebuild_from(slots, self.pages.read("indices", slots),
                                    self.pages.read("values", slots))

    # -- rows ---------------------------------------------------------------

    def _touch(self, id_: str) -> None:
        if not self.max_size:
            return
        if id_ in self._lru:
            self._lru.remove(id_)
        self._lru.append(id_)
        while len(self.ids) > self.max_size:
            self._remove_row(self._lru.pop(0), record_tombstone=False)

    def _remove_row(self, id_: str, record_tombstone: bool = True,
                    free_slot: bool = True) -> bool:
        """Drop a row: a hole in the store's occupancy mask.  A batch
        dropper (partition_drop_rows) frees the slots itself, in one
        store free."""
        row = self.ids.pop(id_, None)
        if row is None:
            return False
        self.rows.pop(id_, None)
        self._dirty.pop(id_, None)
        self.row_ids[row] = ""
        if free_slot:
            self.pages.free([row])
        if self.index is not None:
            self.index.store.invalidate_rows([row])
        if id_ in self._lru:
            self._lru.remove(id_)
        if record_tombstone:
            self._pending[id_] = None
        return True

    def _sync(self) -> Optional[Dict[str, Any]]:
        """Write the dirty rows and return a consistent snapshot of the
        device table (a concurrent read's write may widen its columns);
        None under spill, where reads go through ops/paged.py."""
        with self._sync_lock:
            self._write_dirty()
            p = self.pages
            if p.spill_mode:
                return None
            snap = {n: p.device(n) for n in self._store_columns()}
            snap["mask"] = p.mask_dev()
            snap["rows"] = p.capacity
            return snap

    # -- scoring ------------------------------------------------------------

    def _metric(self) -> str:
        return "cosine" if self.method == "inverted_index" else "euclid"

    def _query_row(self, q: Dict[int, float]) -> Tuple[np.ndarray, float]:
        qd = np.zeros((self.dim,), np.float32)
        if q:
            qd[np.fromiter(q.keys(), np.int64, len(q))] = \
                np.fromiter(q.values(), np.float32, len(q))
        return qd, float(np.sqrt((qd * qd).sum()))

    def _similar(self, q: Dict[int, float], size: int
                 ) -> List[Tuple[str, float]]:
        """One sweep with its top-k on the card (K4, or K1/K2 then K3),
        one copy of the top keys out."""
        if not self.ids or size <= 0:
            return []
        t = self._sync()
        if t is None:
            return self._similar_spill(q, size)
        idx = self._index_for_query()
        with device_context(self.device):
            if idx is not None:
                rows, sc, n = self._similar_pruned(idx, q, t, size)
                out = self._trim_results(rows, sc, size)
                if len(out) >= min(int(size), len(self.ids)):
                    idx.note_query(n, len(self.ids))
                    return out
                idx.note_query(n, len(self.ids), fallback=True)
            if self.sig_method is None:
                qd, qn = self._query_row(q)
                rows, sc = lshops.fused_dense_query(
                    self._metric(), t["indices"], t["values"], t["norms"],
                    t["rows"], t["mask"], qd, qn, int(size))
            else:
                batch = SparseBatch.from_rows([q])
                qn = float(np.sqrt(sum(v * v for v in q.values())))
                rows, sc = lshops.fused_sig_query(
                    self.sig_method, self.key, batch.indices, batch.values,
                    t["sig"], t["norms"], t["rows"], self.hash_num, qn,
                    int(size), mask=t["mask"])
        return self._trim_results(rows, sc, size)

    def _similar_spill(self, q: Dict[int, float], size: int
                       ) -> List[Tuple[str, float]]:
        """A spilled table's read (ops/paged.py): the exact methods' dots
        through K4 with the host's numpy score, the signature methods'
        scores through K5; the top-k on the host."""
        with device_context(self.device):
            if self.sig_method is None:
                qd, qn = self._query_row(q)
                scores = pagedops.dense_scores(self.pages, self._metric(),
                                               qd, qn)
            else:
                batch = SparseBatch.from_rows([q])
                qn = float(np.sqrt(sum(v * v for v in q.values())))
                q_sig = lshops.host_signature(
                    self.key, batch.indices, batch.values, self.hash_num,
                    self.sig_method, self.device)[0]
                scores = pagedops.sig_scores(self.pages, self.sig_method,
                                             self.hash_num, [q_sig], [qn])[0]
        rows, sc = pagedops.topk(scores, self.pages.mask_host(), int(size))
        return self._trim_results(rows, sc, size)

    def _similar_pruned(self, idx, q: Dict[int, float], t, size: int):
        """Candidate-pruned top-k: one K6 launch (after K1/K2) or one K7
        launch -> (rows, scores, n_cand)."""
        batch = SparseBatch.from_rows([q])
        qn = float(np.sqrt(sum(v * v for v in q.values())))
        if self.sig_method is not None:
            return candops.sig_probe_query(
                self.sig_method, self.key, batch.indices, batch.values,
                t["sig"], qn, t["norms"], t["rows"], t["mask"],
                idx.device_csr(), self.hash_num, int(size), idx.plan,
                idx.bits)
        qd, _ = self._query_row(q)
        return candops.ivf_probe_query(
            self._metric(), batch.indices, batch.values, qd, qn,
            idx.device_centroids(), t["indices"], t["values"], t["norms"],
            t["rows"], t["mask"], idx.device_csr(), int(size),
            idx.spec.probes, idx.embed_dim)

    def _trim_results(self, rows, sc, size: int) -> List[Tuple[str, float]]:
        out: List[Tuple[str, float]] = []
        for r, s in zip(rows, sc):
            if not np.isfinite(s) or len(out) >= int(size):
                break
            out.append((self.row_ids[int(r)], float(s)))
        return out

    # -- RPC surface (recommender.idl) ---------------------------------------

    def update_row(self, id_: str, datum: Datum) -> bool:
        delta = self.converter.convert_row(datum, update_weights=True)
        self._row(id_)
        row = self.rows.setdefault(id_, {})
        row.update(delta)     # column merge: new values overwrite same keys
        self._dirty[id_] = True
        self._pending[id_] = dict(row)
        self._touch(id_)
        return True

    def clear_row(self, id_: str) -> bool:
        return self._remove_row(id_)

    def decode_row(self, id_: str) -> Datum:
        if id_ not in self.rows:
            return Datum()
        return self._row_to_datum(self.rows[id_])

    def _row_to_datum(self, row: Dict[int, float]) -> Datum:
        d = Datum()
        for idx, val in sorted(row.items()):
            rev = self.converter.revert_feature(idx)
            if rev is None:
                d.add_number(f"#{idx}", float(val))
            elif rev[1] is None:      # a numeric feature: the value
                d.add_number(rev[0], float(val))
            else:                     # a string feature
                d.add_string(rev[0], str(rev[1]))
        return d

    def complete_row_from_id(self, id_: str) -> Datum:
        if id_ not in self.rows:
            return Datum()
        return self._complete(self.rows[id_])

    def complete_row_from_datum(self, datum: Datum) -> Datum:
        return self._complete(self.converter.convert_row(datum))

    def _complete(self, q: Dict[int, float]) -> Datum:
        sims = self._similar(q, COMPLETE_ROW_NEIGHBORS)
        acc: Dict[int, float] = {}
        total = 0.0
        for id_, score in sims:
            w = max(float(score), 0.0)
            if w <= 0 or id_ not in self.rows:
                continue
            total += w
            for idx, val in self.rows[id_].items():
                acc[idx] = acc.get(idx, 0.0) + w * val
        if total > 0:
            acc = {i: v / total for i, v in acc.items()}
        return self._row_to_datum(acc)

    def similar_row_from_id(self, id_: str, size: int):
        if id_ not in self.rows:
            return []
        return self._similar(self.rows[id_], size)

    def similar_row_from_datum(self, datum: Datum, size: int):
        return self._similar(self.converter.convert_row(datum), size)

    def similar_row_from_datum_many(self, pairs: Sequence[Tuple[Datum, int]]
                                    ) -> List[List[Tuple[str, float]]]:
        """The read lane's entry.  The signature methods sign all N
        queries as one batch padded to round_b(N) (the JAX driver's
        batch) and sweep them in one K3 launch; the exact methods sweep
        each query (a [B, D] dense block is what the JAX driver avoids
        too), under the caller's one read-lock hold."""
        qs = [self.converter.convert_row(d) for d, _ in pairs]
        sizes = [int(s) for _, s in pairs]
        if (self.sig_method is None or not self.ids or max(sizes) <= 0
                or self.pages.spill_mode):
            return [self._similar(q, s) for q, s in zip(qs, sizes)]
        t = self._sync()
        batch = SparseBatch.from_rows(qs)
        qnorms = np.array([np.sqrt(sum(v * v for v in q.values()))
                           for q in qs], np.float32)
        idx = self._index_for_query()
        with device_context(self.device):
            if idx is not None:
                rows_b, sims_b, n_b = candops.sig_probe_query_batch(
                    self.sig_method, self.key, batch.indices, batch.values,
                    t["sig"], qnorms, t["norms"], t["rows"], t["mask"],
                    idx.device_csr(), self.hash_num, max(sizes), idx.plan,
                    idx.bits, round_b(len(qs)))
                out = [self._trim_results(rows_b[i], sims_b[i], s)
                       for i, s in enumerate(sizes)]
                if all(len(o) >= min(s, len(self.ids))
                       for o, s in zip(out, sizes)):
                    for i in range(len(qs)):
                        idx.note_query(int(n_b[i]), len(self.ids))
                    return out
                # an under-filled caller falls the whole batch back
                idx.note_query(int(n_b.max(initial=0)), len(self.ids),
                               fallback=True)
            rows_b, sims_b = lshops.fused_sig_query_batch(
                self.sig_method, self.key, batch.indices, batch.values,
                t["sig"], t["norms"], t["rows"], self.hash_num, qnorms,
                max(sizes), round_b(len(qs)), mask=t["mask"])
        return [self._trim_results(rows_b[i], sims_b[i], s)
                for i, s in enumerate(sizes)]

    # -- partition plane (framework/partition.py) ----------------------------
    # set by the server's PartitionManager: put_diff keeps only the rows
    # this server owns or holds
    partition_owned = None

    def partition_ids(self) -> List[str]:
        return list(self.rows)

    def partition_query_fv(self, id_: str):
        """A row id -> its stored row [[index, value], ...] (the scatter
        legs' query payload) at the id's owner; None when absent, as
        similar_row_from_id answers [] for it."""
        row = self.rows.get(id_)
        if row is None:
            return None
        return [[int(i), float(v)] for i, v in sorted(row.items())]

    def similar_row_from_fv_partial(self, fv, size: int):
        """A scatter leg: this server's sweep with a stored row as the
        query, the kernels and scores of similar_row_from_id."""
        q = {int(i): float(v) for i, v in (fv or [])}
        return self._similar(q, int(size))

    def partition_pack_rows(self, ids: Sequence[str]) -> Dict[str, Any]:
        rows = {i: dict(self.rows[i]) for i in ids if i in self.rows}
        revert = {}
        for row in rows.values():
            for idx in row:
                rev = self.converter.revert_dict.get(idx)
                if rev is not None:
                    revert[idx] = rev
        return {"rows": rows, "revert": revert}

    def partition_apply_rows(self, payload) -> int:
        """The handoff's upsert at the owner.  Resident ids are skipped (a
        client write routed here may supersede the shipped copy, and a
        late or retried ship must never clobber it); _pending is left
        alone: in partition mode rows move by handoff, not by MIX."""
        for idx, name in (payload.get("revert") or {}).items():
            self.converter.revert_dict.setdefault(int(idx), _to_str(name))
        applied = 0
        for id_, row in (payload.get("rows") or {}).items():
            id_ = _to_str(id_)
            if id_ in self.rows:
                continue
            self._row(id_)
            self.rows[id_] = {int(i): float(v) for i, v in row.items()}
            self._dirty[id_] = True
            self._touch(id_)
            applied += 1
        return applied

    def partition_drop_rows(self, ids: Sequence[str]) -> int:
        """The handoff's drop at the losing server, one store free for the
        batch and no tombstones (the rows live on at their owner, where a
        tombstone riding the next MIX round would delete them)."""
        dropped = 0
        victims: List[int] = []
        for id_ in ids:
            id_ = _to_str(id_)
            row = self.ids.get(id_)
            if row is None:
                continue
            self._remove_row(id_, record_tombstone=False, free_slot=False)
            victims.append(row)
            dropped += 1
        if victims:
            self.pages.free(victims)
        return dropped

    def calc_similarity(self, lhs: Datum, rhs: Datum) -> float:
        a = self.converter.convert_row(lhs)
        b = self.converter.convert_row(rhs)
        dot = sum(v * b.get(i, 0.0) for i, v in a.items())
        na = np.sqrt(sum(v * v for v in a.values()))
        nb = np.sqrt(sum(v * v for v in b.values()))
        return float(dot / max(na * nb, 1e-12))

    def calc_l2norm(self, datum: Datum) -> float:
        row = self.converter.convert_row(datum)
        return float(np.sqrt(sum(v * v for v in row.values())))

    def clear(self) -> None:
        self._clear_rows()
        self.converter.revert_dict.clear()

    # -- MIX (a row union with tombstones) -----------------------------------

    def get_diff(self):
        rows = self._pending_rows()
        return {"rows": rows,
                "revert": {i: self.converter.revert_dict[i]
                           for k, v in self._pending.items() if v
                           for i in v},
                "weights": self.converter.weights.get_diff()}

    @classmethod
    def mix(cls, lhs, rhs):
        rows = dict(lhs["rows"])
        rows.update(rhs["rows"])
        revert = dict(lhs.get("revert") or {})
        revert.update(rhs.get("revert") or {})
        return {"rows": rows, "revert": revert,
                "weights": WeightManager.mix(lhs["weights"], rhs["weights"])}

    def put_diff(self, diff) -> bool:
        for idx, name in (diff.get("revert") or {}).items():
            self.converter.revert_dict.setdefault(int(idx), _to_str(name))
        owned = self.partition_owned
        for id_, row in diff["rows"].items():
            id_ = _to_str(id_)
            if owned is not None and id_ not in self.rows \
                    and not owned(id_):
                # partition mode: MIX must not re-replicate another
                # partition's rows (a resident row's tombstone still
                # applies)
                continue
            if row is None:
                self._remove_row(id_, record_tombstone=False)
                continue
            self._row(id_)
            self.rows[id_] = {int(i): float(v) for i, v in row.items()}
            self._dirty[id_] = True
            self._touch(id_)
        self.converter.weights.put_diff(diff["weights"])
        self._retire_pending()
        return True

    # -- persistence ----------------------------------------------------------

    def pack(self) -> Dict[str, Any]:
        return {
            "method": self.method,
            "rows": {i: self.rows[i] for i in self.rows},
            "lru": list(self._lru),
            "revert": dict(self.converter.revert_dict),
            "weights": self.converter.weights.pack(),
        }

    def unpack(self, obj) -> None:
        self.clear()
        self.converter.weights.unpack(obj["weights"])
        self.converter.revert_dict = {int(k): _to_str(v)
                                      for k, v in obj["revert"].items()}
        for id_, row in self._host_rows(obj["rows"]).items():
            self._row(id_)
            self.rows[id_] = row
            self._dirty[id_] = True
        self._lru = [_to_str(i) for i in obj.get("lru", [])]
        self._pending.clear()
        if self.index is not None:
            # model files carry no index state: rebuild lazily from the
            # restored table (ivf re-derives its quantizer too)
            self.index.mark_rebuild()

    def get_status(self) -> Dict[str, str]:
        st = {"method": self.method, "num_rows": str(len(self.ids)),
              "query_tier": self.query_tier_status()}
        st.update(self.pages.get_status())
        if self.index is not None:
            st.update(self.index.get_status())
        return st
