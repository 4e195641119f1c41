"""Cross-process row partitioning: scatter-gather top-k serving (the
port's copy of jubatus_tpu/framework/partition.py, host only).

With `--routing partition` the CHT ring is row OWNERSHIP for the three
row engines (nearest_neighbor, recommender, anomaly):

  * point ops (update_row, set_row, update, decode_row, clear_row) go to
    the key's single ring owner (framework/proxy.py routes them with
    one replica), so each server's resident rows are its hash range;
  * top-k reads scatter to every partition.  Each partition sweeps its
    own rows with the card's kernels (K3/K6 for the signature tables,
    K4/K7 for the exact ones, K4/K5 for the LOF sweep) and the proxy
    merges the per-partition (id, score) candidates into the global
    top-k (merge_topk, merge_anomaly_score).  Scores depend only on the
    stored row and the query, so the merge equals one server's sweep
    over the union of the partitions' rows, up to the order of equal
    scores: the merge breaks ties by id, one server by row slot;
  * MIX never re-replicates a row: the drivers' put_diff drops row
    entries the receiver neither owns nor holds (their `partition_owned`
    hook), while weight and revert diffs still reach every server;
  * a membership change hands the moved ranges off through the journal
    (PartitionManager): the losing server packs its out-of-range rows,
    ships them to the owner's partition_accept_rows (a journaled update
    there, committed before the ack) and only then drops them, journaled
    as {"k": "u", "m": "partition_drop_rows", "a": [ids]}.  A kill -9
    anywhere in that order leaves every row on at least one server; a
    row briefly held by two is answered once, since the merge dedupes by
    id and prefers the ring owner's entry.

The record layouts, payloads and counters are the JAX package's, so a
cluster may mix port and JAX servers and proxies, and a journal written
by either package replays in the other.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from jubatus_tpu_torch.utils import to_str
from jubatus_tpu_torch.utils.metrics import GLOBAL as _metrics

log = logging.getLogger("jubatus_tpu_torch.partition")

ROUTING_MODES = ("replicate", "partition")


@dataclass(frozen=True)
class ScatterRead:
    """How a read scatters and merges in partition mode.

    `scatter` names the wire method each partition leg calls (default:
    the public method itself: a partition's table holds only its own
    range, so its ordinary sweep is the range-restricted partial).
    `fetch` (the from_id forms) names the owner-routed method that
    resolves the id to a query payload first; the legs then call
    `scatter` with that payload in the id's place.  `merge`: "topk"
    merges [[id, score], ...] candidates (`ascending`: distances ascend,
    similarities descend); "anomaly" recomputes the LOF score from the
    merged [id, dist, lrd, kdist] candidates (merge_anomaly_score)."""
    ascending: bool = False
    merge: str = "topk"
    fetch: Optional[str] = None
    scatter: Optional[str] = None


def merge_topk(parts: List[Tuple[Any, List[Any]]], k: int, ascending: bool,
               owner_of: Optional[Callable[[str], Any]] = None
               ) -> List[List[Any]]:
    """Per-partition [[id, score], ...] candidate lists -> the global
    top-k.

    Deduped by id: mid-handoff a row may answer from two partitions.
    Its duplicates carry equal scores unless an update raced the
    transfer; on a conflict the ring owner's entry wins (`owner_of(id)
    -> host key`), as a point read would be routed.  The order is total:
    score, then id."""
    best: Dict[str, Tuple[Any, float, Any, Any]] = {}
    for host, items in parts:
        for it in items or []:
            id_raw, score = it[0], float(it[1])
            key = to_str(id_raw)
            cur = best.get(key)
            if cur is None:
                best[key] = (id_raw, score, host, None)
                continue
            if score == cur[1]:
                continue
            # a conflicting duplicate: resolved by ring ownership
            own = owner_of(key) if owner_of is not None else None
            if own is not None and own == host and own != cur[2]:
                best[key] = (id_raw, score, host, None)
            elif own is not None and own == cur[2]:
                continue
            elif (score < cur[1]) == ascending:
                best[key] = (id_raw, score, host, None)
    order = sorted(best.items(),
                   key=lambda kv: ((kv[1][1] if ascending else -kv[1][1]),
                                   kv[0]))
    return [[rec[0], rec[1]] for _, rec in order[: max(int(k), 0)]]


def merge_anomaly_score(parts: List[Tuple[Any, List[Any]]],
                        owner_of: Optional[Callable[[str], Any]] = None
                        ) -> float:
    """The LOF score from per-partition candidate lists.

    Each leg is calc_score_partial's [nn_num, ignore_kth, [[id, dist,
    lrd, kdist], ...]]: the partition's nn_num nearest resident rows with
    their partition-local LOF bookkeeping.  The merged global kNN (ids
    and distances) is exact; the neighbours' lrd and kdist are exact for
    their own partition's rows (with one partition they are the whole
    table's and the score is bitwise calc_score's).  The arithmetic is
    the drivers' _score, edge for edge."""
    nn_num = 0
    ignore_kth = False
    best: Dict[str, Tuple[float, float, float, Any]] = {}
    for host, leg in parts:
        if not leg:
            continue
        nn_num = max(nn_num, int(leg[0]))
        ignore_kth = ignore_kth or bool(leg[1])
        for it in leg[2] or []:
            key = to_str(it[0])
            rec = (float(it[1]), float(it[2]), float(it[3]), host)
            cur = best.get(key)
            if cur is None or rec[:3] == cur[:3]:
                best[key] = cur or rec
                continue
            own = owner_of(key) if owner_of is not None else None
            if own is not None and own == host and own != cur[3]:
                best[key] = rec
            elif own is None and rec[0] < cur[0]:
                best[key] = rec
    cand = sorted(best.items(), key=lambda kv: (kv[1][0], kv[0]))[:nn_num]
    if not cand:
        return 1.0
    sc = np.array([r[0] for _, r in cand], np.float64)
    lrd = np.array([r[1] for _, r in cand], np.float64)
    kdist = np.array([r[2] for _, r in cand], np.float64)
    reach = np.maximum(kdist, sc)
    m = float(reach.mean())
    lrd_q = (1.0 / m) if m > 0 else math.inf
    lrd_n = float(np.mean(lrd))
    if not math.isfinite(lrd_q):
        if math.isinf(lrd_n):
            return 1.0
        return 1.0 if ignore_kth else math.inf
    if lrd_q == 0.0:
        return 1.0
    score = lrd_n / lrd_q
    if not math.isfinite(score) and ignore_kth:
        return 1.0
    return float(score)


class PartitionManager:
    """A server's range reconciler: keeps the driver's resident rows equal
    to the hash ranges this node owns on the CHT ring.

    One background thread (start/stop; tests call step()) watches the
    ring's version.  After a change, once the ring has been stable for
    `grace` seconds, or while an earlier pass left rows behind, it groups
    the resident ids whose ring owner is another node and hands each
    group off in batches of `batch`:

        pack (read lock) -> partition_accept_rows at the owner (a
        journaled write there, committed before the ack) -> one
        journaled partition_drop_rows here for the acked rows.

    Dying before the ack leaves the row here (retried next pass); dying
    after it and before the drop leaves it on both (the merge dedupes,
    the next pass re-ships, which the owner skips, and drops).  The
    manager holds no lock across an RPC."""

    def __init__(self, server, interval: float = 1.0, batch: int = 256,
                 grace: float = 2.0):
        self.server = server
        self.interval = max(float(interval), 0.05)
        self.batch = max(int(batch), 1)
        # rows move only after the ring has been stable for `grace`
        # seconds: every proxy must have refreshed its cached member view
        # of the new ring first, or a scatter against the old view could
        # miss freshly moved rows.  Keep it above the proxies' membership
        # TTL (1 s)
        self.grace = max(float(grace), 0.0)
        self.epoch = 0                 # ring changes observed
        self._last_version: Optional[int] = None
        self._pending_since: Optional[float] = None
        self._retry = False            # the last pass left rows behind
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _self_loc(self) -> Tuple[str, int]:
        return (self.server.ip, self.server.args.rpc_port)

    def owns(self, id_: str) -> bool:
        """Ownership from the cached ring: safe under the model write
        lock (no coordinator round trip; CHT.find_cached)."""
        owners = self.server.cht.find_cached(str(id_), 1)
        return bool(owners) and owners[0] == self._self_loc()

    def range_summary(self) -> str:
        arcs = self.server.cht.arcs_for(*self._self_loc())
        return ",".join(h[:8] for h in sorted(arcs))

    def step(self, force: bool = False) -> int:
        """One reconciliation pass -> rows shipped.  `force` skips the
        ring-settle grace, never the ship-then-drop order."""
        slot = self.server
        cht = slot.cht
        if cht is None:
            return 0
        version = cht.version()       # refreshes the cached ring
        now = time.monotonic()
        if version != self._last_version:
            if self._last_version is not None:
                self.epoch += 1
                _metrics.inc("partition_ring_change_total")
                log.info("partition ring changed (version %s -> %s); "
                         "reconciling resident rows after %.1fs grace",
                         self._last_version, version, self.grace)
            self._last_version = version
            self._pending_since = now
        if self._pending_since is None and not self._retry:
            return 0
        if not force and self._pending_since is not None \
                and now - self._pending_since < self.grace:
            return 0              # the ring is still settling
        self_loc = self._self_loc()
        with slot.model_lock.read():
            ids = list(slot.driver.partition_ids())
        moving: Dict[Tuple[str, int], List[str]] = {}
        for id_ in ids:
            owners = cht.find_cached(id_, 1)
            if owners and owners[0] != self_loc:
                moving.setdefault(owners[0], []).append(id_)
        if not moving:
            self._retry = False
            self._pending_since = None
            return 0
        from jubatus_tpu_torch.framework.service import (_locked_update,
                                                         _peer_call)
        from jubatus_tpu_torch.mix.codec import packb as _packb
        shipped = 0
        failed = False
        acked: List[str] = []     # shipped and acked, to drop here
        for (host, port), move_ids in moving.items():
            for i in range(0, len(move_ids), self.batch):
                chunk = move_ids[i: i + self.batch]
                with slot.model_lock.read():
                    payload = slot.driver.partition_pack_rows(chunk)
                nbytes = len(_packb(payload))
                try:
                    _peer_call(slot, host, port,
                               "partition_accept_rows", payload)
                except Exception as e:  # noqa: BLE001 - retried next pass
                    # the owner is down or slow: keep the rows (a lost
                    # row is the one outcome not allowed)
                    failed = True
                    _metrics.inc("partition_handoff_retry_total")
                    log.warning("partition handoff of %d rows to %s:%d "
                                "failed (%s); retrying next pass",
                                len(chunk), host, port, e)
                    break
                acked.extend(chunk)
                shipped += len(chunk)
                _metrics.inc("partition_handoff_rows_total", len(chunk))
                _metrics.inc("partition_handoff_bytes_total", nbytes)
        if acked:
            # the owners journaled and acked every row in `acked`: now,
            # and only now, the local copies go, in one journaled drop a
            # pass (a drop costs the pages it touches, models/pages.py)
            _locked_update(
                slot, lambda: slot.driver.partition_drop_rows(acked),
                {"k": "u", "m": "partition_drop_rows", "a": [list(acked)]})
        self._retry = failed
        if not failed:
            self._pending_since = None
        return shipped

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.step()
            except Exception:  # noqa: BLE001 - the reconciler outlives faults
                _metrics.inc("partition_handoff_retry_total")
                log.exception("partition reconciliation pass failed; "
                              "retrying in %.1fs", self.interval)
                self._retry = True
            self._stop.wait(self.interval)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="partition-manager")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def get_status(self) -> Dict[str, str]:
        return {
            "partition_ring_version": str(self._last_version),
            "partition_ring_epoch": str(self.epoch),
            "partition_range": self.range_summary(),
        }
