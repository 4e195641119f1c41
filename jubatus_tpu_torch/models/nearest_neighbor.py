"""Nearest-neighbor engine over a device signature table (counterpart of
jubatus_tpu/models/nearest_neighbor.py).

Methods lsh, minhash and euclid_lsh, each parameterized by hash_num.  The
table is a PagedRowStore (models/pages.py) on the driver's device: [R, W]
packed sign bits for lsh and euclid_lsh, [R, H] minhash slots, and [R]
row norms, plus a host id <-> row dict.  Signatures come from the JAX
package's PRNG (ops/lsh.py: threefry-exact), so a row written here
compares with a query signed by a JAX server, and model files, MIX diffs
and journals cross packages.  On the card an insert is one signature
launch (K1 or K2 of csrc/lsh.cu) and one scatter per column; a query is a
signature launch and one launch of K3, which sweeps the whole table and
keeps each query's top keys (unique, in jax.lax.top_k's order): only
those leave the card, in one copy.

With --index lsh_probe (configure_index) a table of at least min_rows
rows serves its reads through the sublinear candidate index
(index/lsh_probe.py): a datum read is a signature launch and one launch of
K6 (ops/candidates.py sig_probe: the probed buckets' rows and the delta,
rescored exactly, their top keys), a by-row read one K6 launch; a read
whose candidates under-fill its answer falls back to the full sweep (K3),
as in the JAX driver.  The index is derived state: noted on every write
(set_row, set_row_many, put_diff), rebuilt lazily from the signature table
after unpack, never journaled, packed or mixed.

Score conventions (the reference engines'):
  neighbor_row_*  -> ascending distance (lsh: hamming/H; minhash:
                     1 - jaccard; euclid_lsh: LSH-estimated euclidean)
  similar_row_*   -> descending similarity (lsh: 1 - hamming/H; minhash:
                     jaccard; euclid_lsh: -distance)

MIX: a table union.  The diff is the rows written since the last round
(ids -> {"sig": bytes, "norm": float}) plus the converter's weight diff;
mix is a dict union, the later side winning an id; put_diff upserts.

With a spill config (pages.resident_pages > 0) the table's master copy
stays on the host and the card keeps a pool of resident pages
(models/pages.py); set_row writes the master and faults its page in, and
every read goes through ops/paged.py: the query's signature (K1/K2, or
the stored row's from the master), K5's scores mode over the pool and
over each streamed chunk of absent pages, the top-k on the host, as the
JAX driver's _spill_query does; an engaged index is bypassed.

The partition plane (framework/partition.py, --routing partition):
partition_query_sig resolves a row id at its owner to the stored
signature's bytes and norm, and the *_sig_partial legs sweep this
server's rows with them, one launch of K3 with that signature (or of K6
with an engaged index, or K5 over a spilled table); partition_pack_rows,
partition_apply_rows (resident ids skipped) and partition_drop_rows
(holes in the store, the index's slots invalidated) carry the handoff,
and put_diff keeps only the rows this server owns or holds.  Once a drop
has punched holes, every sweep reads the store's occupancy mask, as the
JAX driver's _valid does.  The sharded layout (--shard_devices) is the
subclass in parallel/sharded.py; the JAX driver's query tier has no
counterpart: the table lives on the driver's device, which get_status
reports as query_tier.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from jubatus_tpu_torch.batching.bucketing import round_b
from jubatus_tpu_torch.device import device_context, resolve_device
from jubatus_tpu_torch.fv import ConverterConfig, Datum, DatumToFVConverter
from jubatus_tpu_torch.fv.weight_manager import WeightManager
from jubatus_tpu_torch.index import IndexSpec, SigProbeIndex
from jubatus_tpu_torch.models.base import Driver, register_driver
from jubatus_tpu_torch.models.pages import PagedRowStore, PageSpec
from jubatus_tpu_torch.ops import candidates as candops
from jubatus_tpu_torch.ops import lsh as lshops
from jubatus_tpu_torch.ops import paged as pagedops
from jubatus_tpu_torch.utils import to_bytes as _to_bytes
from jubatus_tpu_torch.utils import to_str as _to_str

METHODS = ("lsh", "minhash", "euclid_lsh")
DEFAULT_SEED = 0x1EAF


@register_driver("nearest_neighbor")
class NearestNeighborDriver(Driver):
    INITIAL_ROWS = 128

    def __init__(self, config: Dict[str, Any], device=None):
        super().__init__(config)
        self.device = resolve_device(device)
        self.method = config.get("method", "lsh")
        if self.method not in METHODS:
            raise ValueError(f"unknown nearest_neighbor method: {self.method}")
        param = config.get("parameter") or {}
        self.hash_num = int(param.get("hash_num", 64))
        if self.hash_num <= 0:
            raise ValueError("hash_num must be > 0")
        self.seed = int(param.get("seed", DEFAULT_SEED))
        self.key = lshops.prng_key(self.seed)
        self.converter = DatumToFVConverter(
            ConverterConfig.from_json(config.get("converter")))
        self.ids: Dict[str, int] = {}
        self.row_ids: List[str] = []
        self._page_spec = PageSpec.from_config(config.get("pages"))
        self._alloc()
        self._pending: Dict[str, Dict[str, Any]] = {}   # rows since last mix
        self._diff_rows = None
        self.index = None   # sublinear query index (configure_index)

    @property
    def _sig_width(self) -> int:
        return lshops.sig_width(self.method, self.hash_num)

    def _alloc(self) -> None:
        self.pages = PagedRowStore(
            {"sig": ((self._sig_width,), np.uint32),
             "norms": ((), np.float32)},
            capacity=self.INITIAL_ROWS, device=self.device,
            spec=self._page_spec)

    @property
    def sig(self):
        """The flat device signature table (int32 bit patterns)."""
        return self.pages.device("sig")

    @property
    def norms(self):
        return self.pages.device("norms")

    def _row(self, id_: str) -> int:
        return int(self._rows([id_])[0])

    def _rows(self, ids: Sequence[str]) -> np.ndarray:
        """The slots of distinct ids, allocating the new ones in order of
        appearance: the slots (and the store's capacity) of one _row call
        per id in the JAX driver, with one allocation."""
        new = [i for i in ids if i not in self.ids]
        if new:
            slots = self.pages.alloc_seq(len(new))
            top = int(slots.max()) + 1
            if len(self.row_ids) < top:
                self.row_ids.extend([""] * (top - len(self.row_ids)))
            for i, s in zip(new, slots.tolist()):
                self.ids[i] = s
                self.row_ids[s] = i
        return np.fromiter((self.ids[i] for i in ids), np.int64, len(ids))

    # -- sublinear query index (jubatus_tpu_torch/index/) ---------------------
    # Derived state: noted wherever a row's signature is written (set_row,
    # _scatter_rows, _bulk_store have the host signature in hand), rebuilt
    # lazily from the signature table after unpack.

    INDEX_SLABS = 1     # the sharded subclass: one slab a shard

    def configure_index(self, kind: str, probes: int = 4, **kw) -> bool:
        """--index: every method is signature-based, so only lsh_probe
        fits; another kind leaves the full sweep and returns False."""
        if kind != "lsh_probe":
            self.index = None
            return False
        spec = IndexSpec(kind="lsh_probe", probes=int(probes),
                         **self._index_spec_kwargs(kw))
        self.index = SigProbeIndex(self.method, self.hash_num, spec,
                                   n_slabs=self.INDEX_SLABS,
                                   put=self._index_put)
        return True

    def _index_note(self, slots, sigs) -> None:
        if self.index is not None:
            self.index.note_sigs(np.asarray(slots, np.int64),
                                 np.asarray(sigs))

    def _index_note_locs(self, locs, sigs) -> None:
        """The sharded layout's notes: (shard, row) locs, each shard's rows
        into its own slab of the index."""
        if self.index is None:
            return
        sigs = np.asarray(sigs)
        by_slab: Dict[int, List[Tuple[int, int]]] = {}
        for j, (s, r) in enumerate(locs):
            by_slab.setdefault(int(s), []).append((int(r), j))
        for s, pairs in by_slab.items():
            self.index.note_sigs(np.asarray([r for r, _ in pairs], np.int64),
                                 sigs[[j for _, j in pairs]], slab=s)

    def _index_rebuild(self) -> None:
        slots = np.array([r for r, i in enumerate(self.row_ids) if i],
                         np.int64)
        self.index.rebuild_from({0: (slots, self.pages.read("sig", slots))})

    def _index_results(self, idx, rows, sims, n_cand: int, size: int,
                       similarity: bool):
        """Candidate-pruned results, or None to fall back to the full
        sweep (too few candidates must not shrink the answer)."""
        out = self._to_results(rows, sims, size, similarity)
        if len(out) >= min(int(size), len(self.ids)):
            idx.note_query(n_cand, len(self.ids))
            return out
        idx.note_query(n_cand, len(self.ids), fallback=True)
        return None

    # -- signatures ---------------------------------------------------------

    def _signature(self, batch, padded_b: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """SparseBatch -> (sig [B, Wsig] uint32, norms [B] f32), signed as
        the JAX driver signs it in a batch of padded_b (it pads the *_many
        routes to round_b; XLA's summation order depends on the batch);
        the norms are the JAX driver's numpy arithmetic."""
        with device_context(self.device):
            sig = lshops.host_signature(self.key, batch.indices,
                                        batch.values, self.hash_num,
                                        self.method, self.device, padded_b)
        norms = np.sqrt((batch.values * batch.values).sum(axis=1))
        return sig, norms.astype(np.float32)

    def _datum_signature(self, datum: Datum, update: bool):
        batch = self.converter.convert_batch([datum], update_weights=update)
        sig, norms = self._signature(batch)
        return sig[0], float(norms[0])

    # -- RPC surface (nearest_neighbor.idl) ---------------------------------

    def set_row(self, id_: str, datum: Datum) -> bool:
        sig, norm = self._datum_signature(datum, update=True)
        row = self._row(id_)
        self.pages.write([row], {"sig": sig[None],
                                 "norms": np.array([norm], np.float32)})
        self._index_note([row], sig[None])
        self._pending[id_] = {"sig": sig.tobytes(), "norm": norm}
        return True

    def set_row_many(self, rows: Sequence[Tuple[str, Datum]]) -> int:
        """Batched upsert: one converter pass, one signature launch and
        one scatter per column.  Duplicate ids resolve last-writer-wins,
        as sequential set_row calls do: only each id's last occurrence
        reaches the scatter, so the table and the pending MIX rows agree."""
        if not rows:
            return 0
        batch = self.converter.convert_batch([d for _, d in rows],
                                             update_weights=True)
        sigs, norms = self._signature(batch, round_b(len(rows)))
        last = {id_: pos for pos, (id_, _) in enumerate(rows)}
        sel = sorted(last.values())
        self._scatter_rows([rows[p][0] for p in sel], sigs[sel], norms[sel])
        for p in sel:
            self._pending[rows[p][0]] = {"sig": sigs[p].tobytes(),
                                         "norm": float(norms[p])}
        return len(rows)

    def _scatter_rows(self, ids, sigs, norms) -> None:
        idx = self._rows(ids)
        self.pages.write(idx, {"sig": np.asarray(sigs),
                               "norms": np.asarray(norms, np.float32)})
        self._index_note(idx, sigs)

    def _valid(self) -> Tuple[int, Optional[Any]]:
        """(n_valid, mask) of a sweep: the live rows' count while they are
        a prefix of the store, its device occupancy mask once a drop has
        punched holes (the JAX driver's _valid)."""
        if self.pages.has_holes:
            return self.pages.capacity, self.pages.mask_dev()
        return len(self.ids), None

    def _to_results(self, rows, sims, size: int, similarity: bool):
        """Top rows + similarities -> wire results, stopping at the first
        non-finite score; neighbor_* maps similarity to distance (lsh,
        minhash 1 - s; euclid_lsh -s)."""
        out: List[Tuple[str, float]] = []
        for r, s in zip(rows, sims):
            if not np.isfinite(s) or len(out) >= int(size):
                break
            if similarity:
                v = float(s)
            else:
                v = float(-s) if self.method == "euclid_lsh" else float(1.0 - s)
            out.append((self.row_ids[int(r)], v))
        return out

    def _query_datum(self, datum: Datum, size: int, similarity: bool):
        if not self.ids or size <= 0:
            return []
        batch = self.converter.convert_batch([datum], update_weights=False)
        qnorm = float(np.sqrt((batch.values * batch.values).sum(axis=1)[0]))
        if self.pages.spill_mode:
            q_sig, _ = self._signature(batch)
            return self._spill_query(q_sig[0], qnorm, size, similarity)
        n_valid, mask = self._valid()
        idx = self._index_for_query()
        with device_context(self.device):
            if idx is not None:
                rows, sims, n = candops.sig_probe_query(
                    self.method, self.key, batch.indices, batch.values,
                    self.sig, qnorm, self.norms, n_valid, mask,
                    idx.device_csr(), self.hash_num, int(size), idx.plan,
                    idx.bits)
                out = self._index_results(idx, rows, sims, n, size,
                                          similarity)
                if out is not None:
                    return out
            rows, sims = lshops.fused_sig_query(
                self.method, self.key, batch.indices, batch.values,
                self.sig, self.norms, n_valid, self.hash_num, qnorm,
                int(size), mask=mask)
        return self._to_results(rows, sims, size, similarity)

    def _spill_query(self, q_sig, qnorm: float, size: int,
                     similarity: bool):
        """A spilled table's read: K5's scores over the pool and the
        streamed pages (ops/paged.py), the top-k on the host."""
        with device_context(self.device):
            scores = pagedops.sig_scores(self.pages, self.method,
                                         self.hash_num, [q_sig], [qnorm])[0]
        rows, sims = pagedops.topk(scores, self.pages.mask_host(), int(size))
        return self._to_results(rows, sims, size, similarity)

    def _query_id(self, id_: str, size: int, similarity: bool):
        if id_ not in self.ids:
            raise KeyError(f"no such row: {id_}")
        if size <= 0:
            return []
        if self.pages.spill_mode:
            loc = self.ids[id_]
            return self._spill_query(
                self.pages.read("sig", [loc])[0],
                float(self.pages.read("norms", [loc])[0]), size, similarity)
        n_valid, mask = self._valid()
        idx = self._index_for_query()
        with device_context(self.device):
            if idx is not None:
                rows, sims, n = candops.sig_probe_query_row(
                    self.method, self.sig, self.ids[id_], self.norms,
                    n_valid, mask, idx.device_csr(), self.hash_num,
                    int(size), idx.plan, idx.bits)
                out = self._index_results(idx, rows, sims, n, size,
                                          similarity)
                if out is not None:
                    return out
            rows, sims = lshops.fused_sig_query_row(
                self.method, self.sig, self.ids[id_], self.norms, n_valid,
                self.hash_num, int(size), mask=mask)
        return self._to_results(rows, sims, size, similarity)

    def _query_datum_many(self, pairs: Sequence[Tuple[Datum, int]],
                          similarity: bool):
        """The read lane's entry: N datum queries as one signature launch
        and one launch of the sweep with its top-k, demuxed per caller
        (the top rows of the largest size hold every smaller size's as a
        prefix)."""
        if not self.ids:
            return [[] for _ in pairs]
        sizes = [int(s) for _, s in pairs]
        kmax = max(sizes)
        if kmax <= 0:
            return [[] for _ in pairs]
        batch = self.converter.convert_batch([d for d, _ in pairs],
                                             update_weights=False)
        qnorms = np.sqrt((batch.values * batch.values).sum(axis=1))
        if self.pages.spill_mode:
            q_sigs, _ = self._signature(batch, round_b(len(pairs)))
            with device_context(self.device):
                scores = pagedops.sig_scores(self.pages, self.method,
                                             self.hash_num, q_sigs, qnorms)
            out = []
            for i, size in enumerate(sizes):
                rows, sims = pagedops.topk(scores[i], self.pages.mask_host(),
                                           size)
                out.append(self._to_results(rows, sims, size, similarity))
            return out
        idx = self._index_for_query()
        with device_context(self.device):
            if idx is not None:
                out = self._index_many(idx, batch, qnorms, sizes, kmax,
                                       similarity)
                if out is not None:
                    return out
            n_valid, mask = self._valid()
            rows_b, sims_b = lshops.fused_sig_query_batch(
                self.method, self.key, batch.indices, batch.values,
                self.sig, self.norms, n_valid, self.hash_num, qnorms, kmax,
                round_b(len(pairs)), mask=mask)
        return [self._to_results(rows_b[i], sims_b[i], sizes[i], similarity)
                for i in range(len(pairs))]

    def _index_many(self, idx, batch, qnorms, sizes, kmax: int,
                    similarity: bool):
        """The batch through the index (one signature launch signed as a
        batch of round_b, one K6 launch), or None when any query
        under-fills: then the whole batch falls back to the full sweep,
        as in the JAX driver."""
        n_valid, mask = self._valid()
        rows_b, sims_b, n_b = candops.sig_probe_query_batch(
            self.method, self.key, batch.indices, batch.values, self.sig,
            qnorms, self.norms, n_valid, mask, idx.device_csr(),
            self.hash_num, kmax, idx.plan, idx.bits,
            round_b(len(sizes)))
        out = [self._to_results(rows_b[i], sims_b[i], s, similarity)
               for i, s in enumerate(sizes)]
        if all(len(o) >= min(s, len(self.ids)) for o, s in zip(out, sizes)):
            for i in range(len(sizes)):
                idx.note_query(int(n_b[i]), len(self.ids))
            return out
        idx.note_query(int(n_b.max(initial=0)), len(self.ids),
                       fallback=True)
        return None

    def neighbor_row_from_id(self, id_: str, size: int):
        return self._query_id(id_, size, similarity=False)

    def neighbor_row_from_datum(self, datum: Datum, size: int):
        return self._query_datum(datum, size, similarity=False)

    def neighbor_row_from_datum_many(self, pairs):
        return self._query_datum_many(pairs, similarity=False)

    def similar_row_from_id(self, id_: str, ret_num: int):
        return self._query_id(id_, ret_num, similarity=True)

    def similar_row_from_datum(self, datum: Datum, ret_num: int):
        return self._query_datum(datum, ret_num, similarity=True)

    def similar_row_from_datum_many(self, pairs):
        return self._query_datum_many(pairs, similarity=True)

    def get_all_rows(self) -> List[str]:
        return [i for i in self.row_ids if i]

    # -- partition plane (framework/partition.py) ----------------------------
    # set by the server's PartitionManager: put_diff keeps only the rows
    # this server owns or holds
    partition_owned = None

    def partition_ids(self) -> List[str]:
        return list(self.ids)

    def partition_query_sig(self, id_: str):
        """A row id -> [its stored signature's bytes, its norm], the
        scatter legs' query payload, resolved at the id's ring owner;
        raises as _query_id does for a missing row."""
        if id_ not in self.ids:
            raise KeyError(f"no such row: {id_}")
        loc = self.ids[id_]
        return [self.pages.read("sig", [loc])[0].tobytes(),
                float(self.pages.read("norms", [loc])[0])]

    def _partial_query_sig(self, sig_bytes, norm: float, size: int,
                           similarity: bool):
        """This partition's sweep with a raw query signature (uint32 on
        the wire, int32 bit patterns on the card): K5 over a spilled
        table, K6 with an engaged index (falling back as every indexed
        read does), else K3."""
        if not self.ids or int(size) <= 0:
            return []
        q_sig = np.frombuffer(_to_bytes(sig_bytes), np.uint32)
        if self.pages.spill_mode:
            return self._spill_query(q_sig, float(norm), size, similarity)
        n_valid, mask = self._valid()
        idx = self._index_for_query()
        with device_context(self.device):
            if idx is not None:
                rows, sims, n = candops.sig_probe_query_sig(
                    self.method, self.sig, q_sig, float(norm), self.norms,
                    n_valid, mask, idx.device_csr(), self.hash_num,
                    int(size), idx.plan, idx.bits)
                out = self._index_results(idx, rows, sims, n, size,
                                          similarity)
                if out is not None:
                    return out
            rows, sims = lshops.fused_sig_query_sig(
                self.method, self.sig, q_sig, float(norm), self.norms,
                n_valid, self.hash_num, int(size), mask=mask)
        return self._to_results(rows, sims, size, similarity)

    def neighbor_row_from_sig_partial(self, sig_bytes, norm, size):
        return self._partial_query_sig(sig_bytes, norm, size,
                                       similarity=False)

    def similar_row_from_sig_partial(self, sig_bytes, norm, size):
        return self._partial_query_sig(sig_bytes, norm, size,
                                       similarity=True)

    def _row_payloads(self, ids) -> Dict[str, Dict[str, Any]]:
        """The handoff's rows: flat slots gathered through the store (a
        spilled page reads from the host master), or (shard, row) locs of
        the sharded [S, cap, W] stack (parallel/sharded.py) gathered from
        it in one copy a column."""
        present = [(i, self.ids[i]) for i in ids if i in self.ids]
        out: Dict[str, Dict[str, Any]] = {}
        if not present:
            return out
        if isinstance(present[0][1], tuple):
            locs = np.array([loc for _, loc in present], np.int64)
            sigs, norms = self._stack_rows(locs)
            for j, (i, _loc) in enumerate(present):
                out[i] = {"sig": sigs[j].tobytes(), "norm": float(norms[j])}
            return out
        slots = np.array([loc for _, loc in present], np.int64)
        sigs = self.pages.read("sig", slots)
        norms = self.pages.read("norms", slots)
        for j, (i, _loc) in enumerate(present):
            out[i] = {"sig": sigs[j].tobytes(), "norm": float(norms[j])}
        return out

    def partition_pack_rows(self, ids) -> Dict[str, Any]:
        return {"rows": {i: [r["sig"], r["norm"]] for i, r in
                         self._row_payloads(ids).items()}}

    def partition_apply_rows(self, payload) -> int:
        """The handoff's upsert at the owner.  Resident ids are skipped:
        a client write routed here may already supersede the shipped
        copy, and a late or retried ship must never clobber it."""
        rows = {_to_str(i): {"sig": _to_bytes(rec[0]),
                             "norm": float(rec[1])}
                for i, rec in (payload.get("rows") or {}).items()}
        rows = {i: rec for i, rec in rows.items() if i not in self.ids}
        self._bulk_store(rows)
        return len(rows)

    def partition_drop_rows(self, ids) -> int:
        """The handoff's drop at the losing server: holes in the store's
        occupancy and its free list (surviving rows keep their slots), the
        dropped slots invalidated in the index.  The ids go in the JAX
        driver's order, so both free lists, and the slots they hand out
        next, agree."""
        drop = {_to_str(i) for i in ids}
        drop &= set(self.ids)
        if not drop:
            return 0
        slots = []
        for i in drop:
            slot = self.ids.pop(i)
            self.row_ids[slot] = ""
            slots.append(slot)
            self._pending.pop(i, None)
        self.pages.free(slots)
        if self.index is not None:
            self.index.store.invalidate_rows(slots)
        return len(drop)

    def clear(self) -> None:
        self.ids.clear()
        self.row_ids = []
        self.pages.clear(self.INITIAL_ROWS)
        self.converter.weights.clear()
        self._pending.clear()
        if self.index is not None:
            self.index.store.clear()

    # -- MIX (row-table union) ----------------------------------------------

    def get_diff(self) -> Dict[str, Any]:
        rows = {k: dict(v) for k, v in self._pending.items()}
        # put_diff retires exactly this set: rows written between get_diff
        # and put_diff survive to the next round
        self._diff_rows = rows
        return {"rows": rows, "weights": self.converter.weights.get_diff()}

    @classmethod
    def mix(cls, lhs: Dict[str, Any], rhs: Dict[str, Any]) -> Dict[str, Any]:
        rows = dict(lhs["rows"])
        rows.update(rhs["rows"])
        return {"rows": rows,
                "weights": WeightManager.mix(lhs["weights"], rhs["weights"])}

    def _bulk_store(self, rows: Dict[str, Dict[str, Any]]) -> None:
        """Upsert many rows with one scatter per column."""
        if not rows:
            return
        idx = self._rows(list(rows))
        sigs = np.stack([np.frombuffer(_to_bytes(r["sig"]), np.uint32)
                         for r in rows.values()])
        norms = np.array([float(r["norm"]) for r in rows.values()],
                         np.float32)
        self.pages.write(idx, {"sig": sigs, "norms": norms})
        self._index_note(idx, sigs)

    def _retire_pending(self) -> None:
        snap = self._diff_rows
        if snap is not None:
            for k, rec in snap.items():
                if k in self._pending and dict(self._pending[k]) == rec:
                    del self._pending[k]
            self._diff_rows = None

    def put_diff(self, diff: Dict[str, Any]) -> bool:
        rows = {_to_str(i): rec for i, rec in diff["rows"].items()}
        owned = self.partition_owned
        if owned is not None:
            # partition mode: never re-replicate another partition's rows
            rows = {i: rec for i, rec in rows.items()
                    if i in self.ids or owned(i)}
        self._bulk_store(rows)
        self.converter.weights.put_diff(diff["weights"])
        self._retire_pending()
        return True

    # -- persistence --------------------------------------------------------

    def pack(self) -> Dict[str, Any]:
        """The JAX driver's model-file layout: the legacy flat table (rows
        compacted in slot order, zero-padded to a power-of-two capacity of
        at least INITIAL_ROWS)."""
        live = self.get_all_rows()
        slots = [self.ids[i] for i in live]
        cap = max(self.INITIAL_ROWS, 1)
        while cap < len(live):
            cap *= 2
        return {
            "method": self.method,
            "hash_num": self.hash_num,
            "seed": self.seed,
            "capacity": cap,
            "row_ids": live,
            "sig": self.pages.pack_flat("sig", slots, cap).tobytes(),
            "norms": self.pages.pack_flat("norms", slots, cap).tobytes(),
            "weights": self.converter.weights.pack(),
        }

    def unpack(self, obj: Dict[str, Any]) -> None:
        self.hash_num = int(obj["hash_num"])
        self.seed = int(obj["seed"])
        self.key = lshops.prng_key(self.seed)
        cap = int(obj["capacity"])
        self.row_ids = [_to_str(r) for r in obj["row_ids"]]
        self.ids = {r: i for i, r in enumerate(self.row_ids)}
        n = len(self.row_ids)
        sig = np.frombuffer(obj["sig"], np.uint32).reshape(
            cap, self._sig_width)
        norms = np.frombuffer(obj["norms"], np.float32)
        self.pages = PagedRowStore(
            {"sig": ((self._sig_width,), np.uint32),
             "norms": ((), np.float32)},
            capacity=max(self.INITIAL_ROWS, n), device=self.device,
            spec=self._page_spec)
        if n:
            slots = self.pages.alloc(n)
            self.pages.write(slots, {"sig": sig[:n], "norms": norms[:n]})
        self.converter.weights.unpack(obj["weights"])
        self._pending.clear()
        self._diff_rows = None
        if self.index is not None:
            # model files carry no index state: rebuild lazily from the
            # restored table
            self.index.mark_rebuild()

    def get_status(self) -> Dict[str, str]:
        st = {"method": self.method, "num_rows": str(len(self.ids)),
              "hash_num": str(self.hash_num),
              "query_tier": self.query_tier_status()}
        pages = getattr(self, "pages", None)
        if pages is not None:    # the sharded NN keeps its own stack
            st.update(pages.get_status())
        if self.index is not None:
            st.update(self.index.get_status())
        return st
