"""Anomaly detection, LOF and light_lof, over a sparse row table on one
torch device (counterpart of jubatus_tpu/models/anomaly.py).

Methods lof and light_lof, each with {nearest_neighbor_num,
reverse_nearest_neighbor_num, ignore_kth_same_point, method, parameter,
unlearner}.  The embedded method is exact (inverted_index,
inverted_index_euclid, euclid) or a signature method (lsh, minhash,
euclid_lsh).

Stored points live in the recommender's row table (models/recommender.py
SparseRowTable: host rows as the source of truth, a paged store on the
device, dirty rows written in one batch padded to a power of two, as the
JAX driver signs them).  The LOF bookkeeping is the JAX driver's, copied as
numpy, so it is bitwise given bitwise distances: each row's exact kNN list
(ids and distances), its k-distance and its lrd; an insert costs one sweep
of the point against the whole table, rows the point enters get a sorted
host insert, and lrd is recomputed for every row in one vectorized pass;
a move or a drop refreshes the rows whose lists reference it in one
batched sweep.

A sweep is one launch on the card and one copy of its [Nq, capacity]
result to the host, where the float64 arithmetic runs as in the JAX
driver:
  * exact methods: K4 dense_dots (the gather-dot of _chunk_dots in XLA's
    order) for up to 8 densified queries a launch, then sqrt(max(qn^2 +
    n^2 - 2 dots, 0)) in float64 on the host (the norms from the host's
    own copy of what it wrote, so no second copy);
  * signature methods: K1/K2 for the queries, then K5 sig_counts (hamming
    or equal counts, or euclid_lsh's estimates) against every row.
With a spill config (pages.resident_pages > 0) the table's master stays
on the host and the card keeps a pool of resident pages: the sweep is
ops/paged.py's, the pool in one launch and the absent pages streamed
(exact: K4 dense_dots with the host's norms; signatures: K5's
scores mode, non-finite scores set to 0, then -sims for euclid_lsh and
1 - sims otherwise in float64), as the JAX driver's spilled arms do.

calc_score(q) = mean(lrd of q's k neighbors) / lrd(q): 1.0 for an empty or
degenerate model; a pile of duplicates gives +inf unless
ignore_kth_same_point (then 1.0).  MIX is the row union with tombstones
and the weight diff; put_diff and unpack rebuild every kNN list.

With --index lsh_probe (signature methods only) calc_score and
calc_score_many find a query's k neighbours through the sublinear
candidate index (index/lsh_probe.py: K1/K2, then one K6 launch), falling
back to the full sweep where the candidates under-fill k, as the JAX
driver does; the write path keeps its exact full-table kNN (an
approximate kNN there would corrupt kdist and lrd for every later
query).  The index is derived state: the dirty-row write notes it, a
removed row is invalidated in it, unpack marks it for a lazy rebuild; a
spilled table bypasses it.

The partition plane (framework/partition.py, --routing partition):
calc_score_partial is one partition's leg of a scattered calc_score, its
nn_num nearest resident rows as [id, dist, lrd, kdist] (through the index
when engaged, else the full sweep, K4 dense_dots or K5 sig_counts), which
the proxy merges and scores (merge_anomaly_score); partition_pack_rows,
partition_apply_rows (resident ids skipped, one batched kNN refresh) and
partition_drop_rows (one store free, one refresh of the rows that
referenced the dropped ones) carry the handoff, and put_diff keeps only
the rows this server owns or holds.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from jubatus_tpu_torch.device import device_context, resolve_device
from jubatus_tpu_torch.fv import Datum, SparseBatch
from jubatus_tpu_torch.fv.weight_manager import WeightManager
from jubatus_tpu_torch.index import IndexSpec, SigProbeIndex
from jubatus_tpu_torch.models.base import Driver, register_driver
from jubatus_tpu_torch.models.recommender import SparseRowTable, _to_str
from jubatus_tpu_torch.ops import candidates as candops
from jubatus_tpu_torch.ops import lsh as lshops
from jubatus_tpu_torch.ops import paged as pagedops

METHODS = ("lof", "light_lof")
EXACT_NN_METHODS = ("inverted_index", "inverted_index_euclid", "euclid")
SIG_NN_METHODS = ("lsh", "minhash", "euclid_lsh")
DEFAULT_SEED = 0x1EAF
_CHUNK = 8          # query rows densified per sweep


def _pow2(n: int) -> int:
    nb = 1
    while nb < n:
        nb *= 2
    return nb


@register_driver("anomaly")
class AnomalyDriver(SparseRowTable, Driver):

    def __init__(self, config: Dict[str, Any], device=None):
        Driver.__init__(self, config)
        self.device = resolve_device(device)
        self.method = config.get("method", "lof")
        if self.method not in METHODS:
            raise ValueError(f"unknown anomaly method: {self.method}")
        param = dict(config.get("parameter") or {})
        self.nn_num = int(param.get("nearest_neighbor_num", 10))
        self.rnn_num = int(param.get("reverse_nearest_neighbor_num", 30))
        self.ignore_kth = bool(param.get("ignore_kth_same_point", False))
        if self.nn_num <= 0:
            raise ValueError("nearest_neighbor_num must be > 0")
        self.nn_method = param.get("method", "inverted_index_euclid")
        nn_param = param.get("parameter") or {}
        if self.nn_method in SIG_NN_METHODS:
            hash_num = int(nn_param.get("hash_num", 64))
        elif self.nn_method in EXACT_NN_METHODS:
            hash_num = 0
        else:
            raise ValueError(f"unknown anomaly nn method: {self.nn_method}")
        self.seed = int(nn_param.get("seed", DEFAULT_SEED))
        self.key = lshops.prng_key(self.seed)
        self.unlearner = param.get("unlearner")
        up = param.get("unlearner_parameter") or {}
        self.max_size = int(up.get("max_size", 0)) if self.unlearner else 0
        if self.unlearner and self.unlearner != "lru":
            raise ValueError(f"unknown unlearner: {self.unlearner}")
        self._init_rows(config, self.nn_method if hash_num else None,
                        hash_num, keep_revert=False)
        self._new_lof_tables(self.capacity)
        self._victim_rows: List[int] = []   # slots freed with refresh=False

    # -- sublinear query index (jubatus_tpu_torch/index/) ---------------------
    # The read side only (calc_score*): the LOF write path keeps its exact
    # full-table kNN.  Exact LOF (dense nn methods) keeps the full sweep.

    def configure_index(self, kind: str, probes: int = 4, **kw) -> bool:
        if kind != "lsh_probe" or not self.hash_num:
            self.index = None
            return False
        spec = IndexSpec(kind="lsh_probe", probes=int(probes),
                         **self._index_spec_kwargs(kw))
        self.index = SigProbeIndex(self.nn_method, self.hash_num, spec,
                                   put=self._index_put)
        return True

    def _index_rebuild(self) -> None:
        self._index_sig_rebuild(np.array(
            [r for r, i in enumerate(self.row_ids) if i], np.int64))

    def _index_neighbors(self, idx, q: Dict[int, float]
                         ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """The query's approximate kNN through the index (K1/K2, one K6
        launch), its similarities turned back into LOF distances; None when
        the candidates under-fill k (the caller sweeps the table)."""
        self._sync()
        batch = SparseBatch.from_rows([q])
        qn = float(np.sqrt(sum(v * v for v in q.values())))
        p = self.pages
        with device_context(self.device):
            rows, sims, n = candops.sig_probe_query(
                self.nn_method, self.key, batch.indices, batch.values,
                p.device("sig"), qn, p.device("norms"), p.capacity,
                p.mask_dev(), idx.device_csr(), self.hash_num, self.nn_num,
                idx.plan, idx.bits)
        fin = np.isfinite(sims)
        rows, sims = rows[fin][: self.nn_num], sims[fin][: self.nn_num]
        if len(rows) < min(self.nn_num, len(self.ids)):
            idx.note_query(n, len(self.ids), fallback=True)
            return None
        idx.note_query(n, len(self.ids))
        dists = -sims if self.nn_method == "euclid_lsh" else 1.0 - sims
        return rows.astype(np.int64), dists.astype(np.float64)

    def _new_lof_tables(self, cap: int) -> None:
        self.kdist = np.zeros((cap,), np.float64)
        self.lrd = np.zeros((cap,), np.float64)
        # exact kNN lists, ascending by distance; -1 / inf pad
        self.knn_rows = np.full((cap, self.nn_num), -1, np.int32)
        self.knn_dists = np.full((cap, self.nn_num), np.inf, np.float64)
        self._norms = np.zeros((cap,), np.float32)   # what the store holds

    def _on_pages_grow(self, old_cap: int, new_cap: int) -> None:
        pad = new_cap - old_cap
        self.kdist = np.pad(self.kdist, (0, pad))
        self.lrd = np.pad(self.lrd, (0, pad))
        self.knn_rows = np.pad(self.knn_rows, ((0, pad), (0, 0)),
                               constant_values=-1)
        self.knn_dists = np.pad(self.knn_dists, ((0, pad), (0, 0)),
                                constant_values=np.inf)
        self._norms = np.pad(self._norms, (0, pad))

    # -- rows ---------------------------------------------------------------

    def _touch(self, id_: str) -> None:
        if not self.max_size:
            return
        if id_ in self._lru:
            self._lru.remove(id_)
        self._lru.append(id_)
        while len(self.ids) > self.max_size:
            self._remove_row(self._lru.pop(0), record_tombstone=False,
                             refresh=False)
        if self._victim_rows:
            # one batched refresh for the whole eviction wave
            self._refresh_referencing(set(self._victim_rows))

    def _remove_row(self, id_: str, record_tombstone: bool = True,
                    refresh: bool = True, free_slot: bool = True) -> bool:
        """Drop a row (a hole in the store's occupancy mask) and refresh
        the rows whose lists referenced it, or leave that to the caller's
        batched refresh; a batch dropper (partition_drop_rows) frees the
        slots itself, in one store free."""
        row = self.ids.pop(id_, None)
        if row is None:
            return False
        self.rows.pop(id_, None)
        self._dirty.pop(id_, None)
        self.row_ids[row] = ""
        if free_slot:
            self.pages.free([row])
        self.kdist[row] = 0.0
        self.lrd[row] = 0.0
        self.knn_rows[row] = -1
        self.knn_dists[row] = np.inf
        if self.index is not None:
            self.index.store.invalidate_rows([row])
        if id_ in self._lru:
            self._lru.remove(id_)
        if record_tombstone:
            self._pending[id_] = None
        if refresh:
            self._refresh_referencing({row})
        else:
            self._victim_rows.append(row)
        return True

    def _refresh_referencing(self, removed_rows: set) -> None:
        """Refresh every row whose kNN list references a removed slot,
        in one batched sweep."""
        self._victim_rows = []
        if not self.ids:
            return
        mask = np.isin(self.knn_rows, list(removed_rows))
        stale = sorted({int(r) for r in np.nonzero(mask.any(axis=1))[0]
                        if self.row_ids[r]})
        self._refresh_rows(stale)

    def _sync(self) -> None:
        with self._sync_lock:
            wrote = self._write_dirty(_pow2)
            if wrote is not None:
                self._norms[wrote[0]] = wrote[1]

    # -- distance sweeps -----------------------------------------------------

    def _distances(self, qrows: List[Dict[int, float]]) -> np.ndarray:
        """Distance of each query row to every slot -> [Nq, capacity]
        float64: one launch a chunk of 8 (exact) or one (signatures), one
        copy of its result each."""
        self._sync()
        p = self.pages
        spilled = p.spill_mode
        out = np.zeros((len(qrows), p.capacity), np.float64)
        with device_context(self.device):
            if self.hash_num == 0:
                # the host's copy of the norms the store holds (the
                # master's bytes under spill)
                norms = self._norms[: p.capacity].astype(np.float64)
                for c0 in range(0, len(qrows), _CHUNK):
                    chunk = qrows[c0: c0 + _CHUNK]
                    qd = np.zeros((len(chunk), self.dim), np.float32)
                    qn = np.zeros((len(chunk),), np.float64)
                    for j, q in enumerate(chunk):
                        if q:
                            qd[j, np.fromiter(q.keys(), np.int64, len(q))] = \
                                np.fromiter(q.values(), np.float32, len(q))
                        qn[j] = math.sqrt(sum(v * v for v in q.values()))
                    if spilled:
                        dots = pagedops.dense_dots(p, qd).astype(np.float64)
                    else:
                        dots = lshops.dense_dots(
                            p.device("indices"), p.device("values"),
                            torch.from_numpy(qd).to(self.device)
                        ).cpu().numpy().astype(np.float64)
                    d2 = np.maximum(qn[:, None] ** 2 + norms[None, :] ** 2
                                    - 2.0 * dots, 0.0)
                    out[c0: c0 + len(chunk)] = np.sqrt(d2)
                return out
            batch = SparseBatch.from_rows(qrows)
            sigs = lshops.signature(
                self.key, torch.from_numpy(batch.indices).to(self.device),
                torch.from_numpy(batch.values).to(self.device),
                self.hash_num, self.nn_method)
            qns = np.array([math.sqrt(sum(v * v for v in q.values()))
                            for q in qrows], np.float32)
            if spilled:
                sims = pagedops.sig_scores(
                    p, self.nn_method, self.hash_num,
                    sigs[: len(qrows)].cpu().numpy().view(np.uint32),
                    qns).astype(np.float64)
                # invalid slots score -inf there: the LOF bookkeeping masks
                # by validity itself and must see finite distances
                sims[~np.isfinite(sims)] = 0.0
            else:
                sims = lshops.table_similarities_batch(
                    self.nn_method, p.device("sig"), sigs[: len(qrows)],
                    self.hash_num, p.device("norms"), qns)
        if self.nn_method == "euclid_lsh":
            out[:] = -sims
        else:
            out[:] = 1.0 - sims
        return out

    def _valid_mask(self) -> np.ndarray:
        return self.pages.mask_host()[: self.capacity]

    def _neighbors(self, dists: np.ndarray, valid: np.ndarray,
                   exclude: int = -1) -> Tuple[np.ndarray, np.ndarray]:
        """k nearest valid rows by distance -> (row indices, distances)."""
        v = valid.copy()
        if exclude >= 0:
            v[exclude] = False
        return lshops.topk_rows(dists, v, self.nn_num, largest=False)

    # -- LOF bookkeeping (incremental, exact kNN tables) ---------------------

    def _set_knn(self, r: int, rows: np.ndarray, sc: np.ndarray) -> None:
        n = min(len(rows), self.nn_num)
        self.knn_rows[r] = -1
        self.knn_dists[r] = np.inf
        self.knn_rows[r, :n] = rows[:n]
        self.knn_dists[r, :n] = sc[:n]
        self.kdist[r] = float(sc[n - 1]) if n else 0.0

    def _refresh_rows(self, affected: List[int],
                      update_lrd: bool = True) -> None:
        """Full kNN lists for `affected` (one batched sweep), then lrd
        for the whole table unless the caller runs its own pass."""
        affected = [r for r in affected if self.row_ids[r]]
        if affected:
            valid = self._valid_mask()
            dists = self._distances([self.rows[self.row_ids[r]]
                                     for r in affected])
            for j, r in enumerate(affected):
                rows, sc = self._neighbors(dists[j], valid, exclude=r)
                self._set_knn(r, rows, sc)
        if update_lrd:
            self._update_all_lrd()

    def _insert_neighbor(self, r: int, p: int, d: float) -> None:
        """Sorted insert of p at distance d into row r's kNN list (exact:
        an insert can only shrink the k-distance)."""
        if (self.knn_rows[r] == p).any():
            return      # a refresh earlier in this write already put p in
        lst_d = self.knn_dists[r]
        pos = int(np.searchsorted(lst_d, d, side="right"))
        if pos >= self.nn_num:
            return
        self.knn_rows[r, pos + 1:] = self.knn_rows[r, pos:-1]
        self.knn_dists[r, pos + 1:] = lst_d[pos:-1].copy()
        self.knn_rows[r, pos] = p
        self.knn_dists[r, pos] = d
        n = int((self.knn_rows[r] >= 0).sum())
        self.kdist[r] = float(self.knn_dists[r, n - 1])

    def _update_all_lrd(self) -> None:
        """lrd(r) = 1 / mean_j max(kdist[nn_j], d(r, nn_j)) for every valid
        row, vectorized over the kNN tables."""
        rows = np.nonzero(self._valid_mask())[0]
        if not len(rows):
            return
        nn = self.knn_rows[rows]
        nd = self.knn_dists[rows]
        has = nn >= 0
        cnt = has.sum(axis=1)
        reach = np.maximum(self.kdist[np.where(has, nn, 0)],
                           np.where(has, nd, 0.0))
        s = (reach * has).sum(axis=1)
        lrd = np.where(s > 0, cnt / np.where(s > 0, s, 1.0), np.inf)
        self.lrd[rows] = np.where(cnt == 0, 0.0, lrd)

    def _score(self, dists: np.ndarray, exclude: int = -1) -> float:
        rows, sc = self._neighbors(dists, self._valid_mask(),
                                   exclude=exclude)
        return self._score_from_neighbors(rows, sc)

    def _score_from_neighbors(self, rows: np.ndarray,
                              sc: np.ndarray) -> float:
        if not len(rows):
            return 1.0
        reach = np.maximum(self.kdist[rows], sc)
        m = float(reach.mean())
        lrd_q = (1.0 / m) if m > 0 else math.inf
        lrd_n = float(np.mean(self.lrd[rows]))
        if not math.isfinite(lrd_q):
            # q sits inside a pile of >= k duplicates
            if math.isinf(lrd_n):
                return 1.0
            return 1.0 if self.ignore_kth else math.inf
        if lrd_q == 0.0:
            return 1.0
        score = lrd_n / lrd_q
        if not math.isfinite(score) and self.ignore_kth:
            return 1.0
        return score

    # -- RPC surface (anomaly.idl) -------------------------------------------

    def _write(self, id_: str, datum: Datum, overwrite: bool) -> float:
        delta = self.converter.convert_row(datum, update_weights=True)
        moved = id_ in self.ids
        row = self._row(id_)
        if overwrite:
            self.rows[id_] = dict(delta)
        else:
            self.rows.setdefault(id_, {}).update(delta)
        self._dirty[id_] = True
        self._pending[id_] = dict(self.rows[id_])
        self._touch(id_)
        valid = self._valid_mask()
        dists = self._distances([self.rows[id_]])[0]
        if moved:
            # rows whose lists reference p hold stale distances: refresh
            # them and p in one sweep (their lists see p's new place)
            mask = (self.knn_rows == row).any(axis=1)
            skip = {int(r) for r in np.nonzero(mask)[0]
                    if self.row_ids[r]} | {row}
            self._refresh_rows(sorted(skip), update_lrd=False)
        else:
            rows, sc = self._neighbors(dists, valid, exclude=row)
            self._set_knn(row, rows, sc)
            skip = {row}
        full = (self.knn_rows >= 0).all(axis=1)
        affected = np.nonzero(valid & ((dists < self.kdist) | ~full))[0]
        for r in affected:
            r = int(r)
            if r not in skip:
                self._insert_neighbor(r, row, float(dists[r]))
        self._update_all_lrd()
        return self._score(dists, exclude=row)

    def add(self, id_: str, datum: Datum) -> float:
        """The driver's half of the add RPC: the service supplies the
        cluster-unique id."""
        return self._write(id_, datum, overwrite=False)

    def update(self, id_: str, datum: Datum) -> float:
        return self._write(id_, datum, overwrite=False)

    def overwrite(self, id_: str, datum: Datum) -> float:
        return self._write(id_, datum, overwrite=True)

    def clear_row(self, id_: str) -> bool:
        return self._remove_row(id_)

    def calc_score(self, datum: Datum) -> float:
        if not self.ids:
            return 1.0
        q = self.converter.convert_row(datum)
        idx = self._index_for_query()
        if idx is not None:
            nb = self._index_neighbors(idx, q)
            if nb is not None:
                return self._score_from_neighbors(*nb)
        return self._score(self._distances([q])[0])

    def calc_score_many(self, datums: Sequence[Datum]) -> List[float]:
        """The read lane's entry: one sweep for all N queries, scored per
        caller with the per-row math of N calc_score calls; with an engaged
        index each query takes its own probe (one K6 launch), as in the
        JAX driver."""
        if not self.ids:
            return [1.0] * len(datums)
        qs = [self.converter.convert_row(d) for d in datums]
        idx = self._index_for_query()
        if idx is not None:
            out: List[float] = []
            for q in qs:
                nb = self._index_neighbors(idx, q)
                out.append(self._score(self._distances([q])[0])
                           if nb is None else self._score_from_neighbors(*nb))
            return out
        dists = self._distances(qs)
        return [self._score(dists[i]) for i in range(len(datums))]

    # -- partition plane (framework/partition.py) ----------------------------
    # set by the server's PartitionManager: put_diff keeps only the rows
    # this server owns or holds
    partition_owned = None

    def partition_ids(self) -> List[str]:
        return list(self.rows)

    def calc_score_partial(self, datum: Datum):
        """One partition's leg of a scattered calc_score: [nn_num,
        ignore_kth, [[id, dist, lrd, kdist], ...]], the nn_num nearest
        resident rows with their LOF bookkeeping (exact for this
        partition's rows; the whole table's with one partition)."""
        items: List[List[Any]] = []
        if self.ids:
            q = self.converter.convert_row(datum)
            rows = sc = None
            idx = self._index_for_query()
            if idx is not None:
                nb = self._index_neighbors(idx, q)
                if nb is not None:
                    rows, sc = nb
            if rows is None:
                dists = self._distances([q])[0]
                rows, sc = self._neighbors(dists, self._valid_mask())
            for r, d in zip(rows, sc):
                r = int(r)
                items.append([self.row_ids[r], float(d),
                              float(self.lrd[r]), float(self.kdist[r])])
        return [int(self.nn_num), bool(self.ignore_kth), items]

    def partition_pack_rows(self, ids) -> Dict[str, Any]:
        return {"rows": {i: dict(self.rows[i]) for i in ids
                         if i in self.rows}}

    def partition_apply_rows(self, payload) -> int:
        """The handoff's upsert at the owner, resident ids skipped (a late
        or retried ship must never clobber a newer write), then one
        batched rebuild of every kNN list, as put_diff does."""
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
        if applied:
            self._victim_rows = []
            self._refresh_rows([r for r, i in enumerate(self.row_ids) if i])
        return applied

    def partition_drop_rows(self, ids) -> int:
        """The handoff's drop at the losing server: one store free for the
        batch, then one refresh of the rows that referenced a dropped
        one."""
        dropped = 0
        victims: List[int] = []
        for id_ in ids:
            id_ = _to_str(id_)
            row = self.ids.get(id_)
            if row is None:
                continue
            self._remove_row(id_, record_tombstone=False, refresh=False,
                             free_slot=False)
            victims.append(row)
            dropped += 1
        if victims:
            self.pages.free(victims)
            self._refresh_referencing(set(victims))
        return dropped

    def clear(self) -> None:
        self._clear_rows()
        self._new_lof_tables(self.capacity)
        self._victim_rows = []

    # -- MIX (a row union with tombstones; kNN lists rebuilt) ----------------

    def get_diff(self):
        return {"rows": self._pending_rows(),
                "weights": self.converter.weights.get_diff()}

    @classmethod
    def mix(cls, lhs, rhs):
        rows = dict(lhs["rows"])
        rows.update(rhs["rows"])
        return {"rows": rows,
                "weights": WeightManager.mix(lhs["weights"], rhs["weights"])}

    def put_diff(self, diff) -> bool:
        owned = self.partition_owned
        for id_, row in diff["rows"].items():
            id_ = _to_str(id_)
            if owned is not None and id_ not in self.rows \
                    and not owned(id_):
                # partition mode: never re-replicate another partition's
                # rows
                continue
            if row is None:
                # the rebuild below resets every list anyway
                self._remove_row(id_, record_tombstone=False, refresh=False)
                continue
            self._row(id_)
            self.rows[id_] = {int(i): float(v) for i, v in row.items()}
            self._dirty[id_] = True
            self._touch(id_)
        self.converter.weights.put_diff(diff["weights"])
        self._victim_rows = []
        self._refresh_rows([r for r, i in enumerate(self.row_ids) if i])
        self._retire_pending()
        return True

    # -- persistence ----------------------------------------------------------

    def pack(self) -> Dict[str, Any]:
        return {
            "method": self.method,
            "rows": {i: self.rows[i] for i in self.rows},
            "lru": list(self._lru),
            "weights": self.converter.weights.pack(),
        }

    def unpack(self, obj) -> None:
        self.clear()
        self.converter.weights.unpack(obj["weights"])
        for id_, row in self._host_rows(obj["rows"]).items():
            self._row(id_)
            self.rows[id_] = row
            self._dirty[id_] = True
        self._lru = [_to_str(i) for i in obj.get("lru", [])]
        self._refresh_rows([r for r, i in enumerate(self.row_ids) if i])
        self._pending.clear()
        if self.index is not None:
            # model files carry no index state: rebuild lazily from the
            # restored signature table
            self.index.mark_rebuild()

    def get_status(self) -> Dict[str, str]:
        st = {"method": self.method, "num_rows": str(len(self.ids)),
              "nn_method": self.nn_method,
              "query_tier": self.query_tier_status()}
        st.update(self.pages.get_status())
        if self.index is not None:
            st.update(self.index.get_status())
        return st
