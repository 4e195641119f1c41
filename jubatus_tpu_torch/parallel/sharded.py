"""Key-sharded row tables on one card (counterpart of
jubatus_tpu/parallel/sharded.py): the in-process CHT.

The reference shards row-keyed state across server processes by
consistent hashing (jubatus/server/common/cht.hpp:40-87), and the JAX
package across the devices of a mesh: the signature table is a
[nshard, cap, W] stack partitioned over the `shard` axis, each row keyed
to its shard by a stable hash of its id.  The port keeps the same stack
on ONE torch device: a shard is a slab [cap, W] of it, with its norms
[cap] and its validity mask [cap], and ids place exactly as in the JAX
package (key_shard: crc32 of the id), so both packages lay a history of
writes out alike, (shard, row) for (shard, row).

A read fans out to every shard as the JAX shard_map does, one launch a
shard: K3 (ops/lsh.py sig_topk, csrc/lsh.cu) over slab s with valid[s]
as its mask at kb = _k_bucket(min(size, rows), cap) for the full sweep
(make_sharded_query, sharded.py:53), or K6 (ops/candidates.py sig_probe,
csrc/candidates.cu) over slab s of the index's stacked CSR at the JAX
driver's widened kb for an indexed read (make_sharded_probe_query, :85).
The [S, kb] keys leave the card in one copy, and the host merges as the
JAX driver does (merge_candidates): each shard's finite candidates that
name a live row, shard-major, a stable sort on -score, cut to the size.
Ties therefore come shard-major, then lowest local row, which is not the
unsharded driver's flat-slot order.  An indexed read whose merged list
under-fills its answer falls back to the full sweep, noting the fallback.

Storage follows the paged discipline without a PagedRowStore, as the JAX
driver does: per-shard fill, per-shard free lists (last freed, first
reused), drops punch validity holes; when the fullest shard fills, every
slab doubles (rows keep their (shard, row)).  The model file, MIX diffs
and the handoff payloads are the single-device driver's, so a sharded
server and a plain one (of either package) exchange models and rounds.
The JAX driver ignores a `pages` config on this layout, and so does the
port: the stack is always resident.
"""

from __future__ import annotations

import math
import zlib
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from jubatus_tpu_torch.device import device_context
from jubatus_tpu_torch.models.nearest_neighbor import NearestNeighborDriver
from jubatus_tpu_torch.ops import candidates as candops
from jubatus_tpu_torch.ops import lsh as lshops
from jubatus_tpu_torch.parallel.mesh import Mesh
from jubatus_tpu_torch.utils import to_bytes as _to_bytes
from jubatus_tpu_torch.utils import to_str as _to_str


def key_shard(id_: str, nshard: int) -> int:
    """Stable key -> shard placement (the cht::make_hash successor role):
    crc32, so every process and both packages place ids alike."""
    return zlib.crc32(id_.encode()) % nshard


def _k_bucket(k: int, cap: int) -> int:
    """The JAX driver's top-k width: the power of two at or above k, at
    most cap."""
    b = 1
    while b < k:
        b *= 2
    return min(b, cap)


def merge_candidates(vals: np.ndarray, rows: np.ndarray,
                     shard_row_ids: Sequence[Sequence[str]], k: int,
                     dedupe: bool = False) -> List[Tuple[str, float]]:
    """The JAX driver's host merge (sharded.py:346-362, :389-411) of the
    shards' top lists vals/rows [S, kb]: every finite candidate that names
    a live row of its shard, shard-major (with dedupe, the indexed read's,
    a (shard, row) once), then a stable sort on -score, cut to k."""
    cand: List[Tuple[str, float]] = []
    seen = set()
    for s, ids in enumerate(shard_row_ids):
        for v, r in zip(vals[s].tolist(), rows[s].tolist()):
            if not math.isfinite(v) or not 0 <= r < len(ids) or not ids[r]:
                continue
            if dedupe:
                if (s, r) in seen:
                    continue
                seen.add((s, r))
            cand.append((ids[r], v))
    cand.sort(key=lambda kv: -kv[1])
    return cand[: int(k)]


def shard_topk(kind: str, sig: torch.Tensor, norms: torch.Tensor,
               valid: torch.Tensor, q_sigs: torch.Tensor,
               qnorms: torch.Tensor, hash_num: int, kb: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """The sharded sweep: one K3 launch a shard over sig[s] [cap, W]
    (int32) with norms[s] and valid[s] as its mask, each query's top kb
    -> host (vals [S, kb] float32, rows [S, kb] int64) of the first query,
    one copy."""
    cap = sig.shape[1]
    keys = torch.cat([lshops.sig_topk(
        kind, sig[s], norms[s], cap, q_sigs=q_sigs, qnorms=qnorms,
        hash_num=hash_num, kb=kb, mask=valid[s])
        for s in range(sig.shape[0])])
    rows, vals = lshops.keys_to_host(keys)
    return vals, rows


def shard_probe(kind: str, sig: torch.Tensor, norms: torch.Tensor,
                valid: torch.Tensor, csr, plan, bits: int,
                q_sigs: torch.Tensor, qnorms: torch.Tensor, hash_num: int,
                kb: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The sharded probe: one K6 launch a shard over slab s of the
    stacked CSR (flat [S, Fp], offsets [S, G], lens [S, G], delta
    [S, Dcap], cap) -> host (vals [S, kb] float32, rows [S, kb] int64,
    n_cand [S] int64) of one query, one copy."""
    flat, offsets, lens, delta, cap = csr
    cap_rows = sig.shape[1]
    out = torch.cat([candops.sig_probe(
        kind, sig[s], norms[s], cap_rows, valid[s],
        (flat[s], offsets[s], lens[s], delta[s], cap), plan, bits,
        hash_num, kb, q_sigs=q_sigs, qnorms=qnorms)
        for s in range(sig.shape[0])])
    rows, vals, n = candops.probe_result(out, kb)
    return vals, rows, n


class ShardedNearestNeighborDriver(NearestNeighborDriver):
    """NearestNeighborDriver whose signature table is a [S, cap, W] stack
    of key-hash shards on one device.  The wire surface, the MIX algebra
    (row-set union) and the scores are the single-device driver's; only
    the placement, the fan-out and the tie order of the merge differ."""

    # plain attributes shadow the base driver's store-backed properties:
    # the [S, cap, W] stack owns its layout here
    sig = None
    norms = None
    capacity = None

    def __init__(self, config: Dict[str, Any], mesh: Mesh):
        self.mesh = mesh
        self.nshard = mesh.shape["shard"]
        # one bucket-store slab a shard, packed [S, ...]
        self.INDEX_SLABS = self.nshard
        self.capacity = self.INITIAL_ROWS
        super().__init__(config, device=mesh.device)

    # -- the stack -----------------------------------------------------------

    def _alloc(self) -> None:
        s, c, w = self.nshard, self.capacity, self._sig_width
        dev = self.device
        self.sig = torch.zeros((s, c, w), dtype=torch.int32, device=dev)
        self.norms = torch.zeros((s, c), dtype=torch.float32, device=dev)
        self.valid = torch.zeros((s, c), dtype=torch.bool, device=dev)
        # id -> (shard, row); one row-id list a shard ("" holes); the
        # per-shard free lists of dropped rows
        self.ids: Dict[str, Tuple[int, int]] = {}
        self.shard_row_ids: List[List[str]] = [[] for _ in range(s)]
        self._shard_free: List[List[int]] = [[] for _ in range(s)]

    def _grow(self) -> None:
        """Every slab doubles; rows keep their (shard, row)."""
        c = self.capacity
        for name in ("sig", "norms", "valid"):
            old = getattr(self, name)
            new = torch.zeros((old.shape[0], 2 * c) + tuple(old.shape[2:]),
                              dtype=old.dtype, device=old.device)
            new[:, :c] = old
            setattr(self, name, new)
        self.capacity = 2 * c

    def _row(self, id_: str) -> Tuple[int, int]:
        loc = self.ids.get(id_)
        if loc is None:
            s = key_shard(id_, self.nshard)
            if self._shard_free[s]:
                r = self._shard_free[s].pop()
                self.shard_row_ids[s][r] = id_
            else:
                r = len(self.shard_row_ids[s])
                if r >= self.capacity:
                    # one capacity for every slab keeps the stack
                    # rectangular: grow when the fullest shard fills
                    self._grow()
                self.shard_row_ids[s].append(id_)
            loc = (s, r)
            self.ids[id_] = loc
        return loc

    @property
    def row_ids(self) -> List[str]:
        """Live ids, shard by shard, each in its slab's row order."""
        return [i for rows in self.shard_row_ids for i in rows if i]

    @row_ids.setter
    def row_ids(self, _val) -> None:
        pass    # the base driver's __init__ assigns []; the stack owns it

    def _loc_index(self, locs) -> Tuple[torch.Tensor, torch.Tensor]:
        a = np.asarray(locs, np.int64).reshape(-1, 2)
        return (torch.from_numpy(a[:, 0].copy()).to(self.device),
                torch.from_numpy(a[:, 1].copy()).to(self.device))

    def _write_locs(self, locs, sigs: np.ndarray, norms: np.ndarray) -> None:
        """One scatter a column of rows at distinct (shard, row) locs:
        sigs [N, W] uint32, norms [N] float32."""
        if not len(locs):
            return
        si, ri = self._loc_index(locs)
        w = np.ascontiguousarray(sigs, np.uint32).view(np.int32)
        self.sig.index_put_((si, ri), lshops._host(w, np.int32, self.device))
        self.norms.index_put_((si, ri), lshops._host(norms, np.float32,
                                                     self.device))
        self.valid.index_put_((si, ri), torch.ones(
            len(locs), dtype=torch.bool, device=self.device))

    def _stack_rows(self, locs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Host (sigs [N, W] uint32, norms [N] float32) of (shard, row)
        locs [N, 2], one gather and one copy a column."""
        si, ri = self._loc_index(locs)
        sigs = self.sig[si, ri].cpu().numpy().view(np.uint32)
        return sigs, self.norms[si, ri].cpu().numpy()

    # -- writes --------------------------------------------------------------

    def set_row(self, id_: str, datum) -> bool:
        sig, norm = self._datum_signature(datum, update=True)
        loc = self._row(id_)
        self._write_locs([loc], sig[None], np.array([norm], np.float32))
        self._index_note_locs([loc], sig[None])
        self._pending[id_] = {"sig": sig.tobytes(), "norm": norm}
        return True

    def _scatter_rows(self, ids: Sequence[str], sigs, norms) -> None:
        """Distinct ids' rows (sigs [N, W] uint32, norms [N]) at their
        (shard, row) locs: set_row_many's scatter (the base driver
        converts, signs and dedupes), _bulk_store's and unpack's."""
        locs = [self._row(i) for i in ids]
        sigs = np.asarray(sigs)
        self._write_locs(locs, sigs, np.asarray(norms, np.float32))
        self._index_note_locs(locs, sigs)

    def _bulk_store(self, rows: Dict[str, Any]) -> None:
        """Upsert many rows: one scatter a column."""
        if not rows:
            return
        sigs = np.stack([np.frombuffer(_to_bytes(r["sig"]), np.uint32)
                         for r in rows.values()])
        norms = np.array([float(r["norm"]) for r in rows.values()],
                         np.float32)
        self._scatter_rows(list(rows), sigs, norms)

    # -- the index: one slab a shard -----------------------------------------

    def _index_note(self, slots, sigs) -> None:   # pragma: no cover
        raise AssertionError("the sharded layout notes (shard, row) locs")

    def _index_rebuild(self) -> None:
        sig = self.sig.cpu().numpy().view(np.uint32)
        slabs = {}
        for s in range(self.nshard):
            live = np.array([r for r, i in enumerate(self.shard_row_ids[s])
                             if i], np.int64)
            slabs[s] = (live, sig[s, live])
        self.index.rebuild_from(slabs)

    # -- reads ---------------------------------------------------------------

    def _datum_query(self, datum) -> Tuple[torch.Tensor, torch.Tensor]:
        """A datum's query signature [1, W] (K1/K2 at B 1, as the JAX
        driver signs it) and norm [1], on the device."""
        batch = self.converter.convert_batch([datum], update_weights=False)
        norm = np.sqrt((batch.values * batch.values).sum(axis=1)) \
            .astype(np.float32)
        with device_context(self.device):
            q_sigs = lshops.signature(
                self.key, lshops._host(batch.indices, np.int32, self.device),
                lshops._host(batch.values, np.float32, self.device),
                self.hash_num, self.method)
        return q_sigs, lshops._host(norm, np.float32, self.device)

    def _query_datum(self, datum, size: int, similarity: bool):
        if not self.ids or size <= 0:
            return []
        return self._query(*self._datum_query(datum), size, similarity)

    def _query_id(self, id_: str, size: int, similarity: bool):
        if id_ not in self.ids:
            raise KeyError(f"no such row: {id_}")
        s, r = self.ids[id_]
        # the stored row's signature and norm, read on the device
        return self._query(self.sig[s, r: r + 1], self.norms[s, r: r + 1],
                           size, similarity)

    def partition_query_sig(self, id_: str):
        if id_ not in self.ids:
            raise KeyError(f"no such row: {id_}")
        sigs, norms = self._stack_rows([self.ids[id_]])
        return [sigs[0].tobytes(), float(norms[0])]

    def _partial_query_sig(self, sig_bytes, norm, size: int,
                           similarity: bool):
        """The partition plane's scatter leg: the raw query signature
        rides the same per-shard fan-out as a by-id read."""
        if not self.ids or int(size) <= 0:
            return []
        q_sigs, qnorms = lshops.sig_query_args(
            np.frombuffer(_to_bytes(sig_bytes), np.uint32), float(norm),
            self.device)
        return self._query(q_sigs, qnorms, int(size), similarity)

    def _query_datum_many(self, pairs, similarity: bool):
        """The read lane's entry: each query fans out on its own, bitwise
        the per-request read (the JAX driver's choice), under the caller's
        one read-lock hold."""
        return [self._query_datum(d, int(s), similarity) for d, s in pairs]

    def _results(self, cand, similarity: bool):
        if similarity:
            return cand
        # neighbor_*: ascending distance (1 - sim; euclid_lsh un-negated)
        if self.method == "euclid_lsh":
            return [(i, -v) for i, v in cand]
        return [(i, 1.0 - v) for i, v in cand]

    def _query(self, q_sigs, qnorms, size: int, similarity: bool):
        n_rows = len(self.ids)
        if n_rows == 0 or size <= 0:
            return []
        k = min(int(size), n_rows)
        idx = self._index_for_query()
        with device_context(self.device):
            if idx is not None:
                out = self._query_indexed(idx, q_sigs, qnorms, k)
                if out is not None:
                    return self._results(out, similarity)
            vals, rows = shard_topk(
                self.method, self.sig, self.norms, self.valid, q_sigs,
                qnorms, self.hash_num, _k_bucket(k, self.capacity))
        return self._results(
            merge_candidates(vals, rows, self.shard_row_ids, k), similarity)

    def _query_indexed(self, idx, q_sigs, qnorms, k: int):
        """One K6 launch a shard over its slab, merged as the full sweep
        (the (shard, row) dedupe: a row can surface once a probe and once
        from the delta), or None when the merge under-fills k: the caller
        sweeps in full."""
        n_rows = len(self.ids)
        csr = idx.device_csr(squeeze=False)
        # widened by the duplication bound, at most the candidate width
        kb = _k_bucket(k * (len(idx.plan) + 1),
                       len(idx.plan) * csr[4] + int(csr[3].shape[1]))
        vals, rows, n_cand = shard_probe(
            self.method, self.sig, self.norms, self.valid, csr, idx.plan,
            idx.bits, q_sigs, qnorms, self.hash_num, kb)
        cand = merge_candidates(vals, rows, self.shard_row_ids, k,
                                dedupe=True)
        total = int(n_cand.sum())
        if len(cand) < k:
            idx.note_query(total, n_rows, fallback=True)
            return None
        idx.note_query(total, n_rows)
        return cand

    # -- the partition handoff -----------------------------------------------

    def partition_drop_rows(self, ids) -> int:
        """Holes in the validity mask (one scatter for the batch), the
        slots back on their shards' free lists in the JAX driver's order,
        their index slots invalidated slab by slab."""
        drop = {_to_str(i) for i in ids}
        drop &= set(self.ids)
        if not drop:
            return 0
        locs = []
        for i in drop:
            s, r = self.ids.pop(i)
            self.shard_row_ids[s][r] = ""
            self._shard_free[s].append(r)
            self._pending.pop(i, None)
            locs.append((s, r))
        si, ri = self._loc_index(locs)
        self.valid.index_put_((si, ri), torch.zeros(
            len(locs), dtype=torch.bool, device=self.device))
        if self.index is not None:
            by_slab: Dict[int, List[int]] = {}
            for s, r in locs:
                by_slab.setdefault(s, []).append(r)
            for s, rows in by_slab.items():
                self.index.store.invalidate_rows(rows, slab=s)
        return len(drop)

    def clear(self) -> None:
        self.capacity = self.INITIAL_ROWS
        self._alloc()
        self.converter.weights.clear()
        self._pending.clear()
        if self.index is not None:
            self.index.store.clear()

    # -- persistence: the single-device driver's layout, so models move
    # between sharded and plain servers of either package ---------------------

    def pack(self) -> Dict[str, Any]:
        row_ids = self.row_ids
        cap = max(self.INITIAL_ROWS, 1)
        while cap < len(row_ids):
            cap *= 2
        sig = np.zeros((cap, self._sig_width), np.uint32)
        norms = np.zeros((cap,), np.float32)
        if row_ids:
            sigs, ns = self._stack_rows([self.ids[i] for i in row_ids])
            sig[: len(row_ids)] = sigs
            norms[: len(row_ids)] = ns
        return {
            "method": self.method,
            "hash_num": self.hash_num,
            "seed": self.seed,
            "capacity": cap,
            "row_ids": row_ids,
            "sig": sig.tobytes(),
            "norms": norms.tobytes(),
            "weights": self.converter.weights.pack(),
        }

    def unpack(self, obj) -> None:
        """Every id re-placed by its key in file order (the JAX driver's
        _bulk_store of the file's rows), one scatter a column."""
        self.hash_num = int(obj["hash_num"])
        self.seed = int(obj["seed"])
        self.key = lshops.prng_key(self.seed)
        cap = int(obj["capacity"])
        row_ids = [_to_str(r) for r in obj["row_ids"]]
        n = len(row_ids)
        sig = np.frombuffer(obj["sig"], np.uint32).reshape(
            cap, self._sig_width)
        norms = np.frombuffer(obj["norms"], np.float32)
        self.capacity = self.INITIAL_ROWS
        self._alloc()
        self.converter.weights.unpack(obj["weights"])
        self._pending.clear()
        self._diff_rows = None
        if self.index is not None:
            self.index.store.clear()    # every slot renumbers below
        # the file's rows deduped last-writer-wins, as the JAX driver's
        # dict of them
        last = {rid: j for j, rid in enumerate(row_ids)}
        if len(last) != n:
            order = list(last.values())
            self._scatter_rows(list(last), sig[order], norms[order])
        elif n:
            self._scatter_rows(row_ids, sig[:n], norms[:n])

    def get_status(self) -> Dict[str, str]:
        st = super().get_status()
        st["num_rows"] = str(len(self.ids))
        st["shards"] = str(self.nshard)
        st["rows_per_shard"] = ",".join(
            str(sum(1 for i in r if i)) for r in self.shard_row_ids)
        return st
