"""Key-sharded global-row tables on one card for the recommender and
anomaly engines (counterpart of jubatus_tpu/parallel/sharded_rows.py).

The reference shards row-keyed recommender and anomaly state across
server processes by consistent hashing (recommender.idl `#@cht` routing;
anomaly_serv.cpp:181-205), and the JAX package over the mesh shard axis.
Each engine keeps its paged row store (models/pages.py) and its global
row numbering, but rows are PLACED so that id -> row = shard * shard_cap
+ local, the shard picked by the stable key hash (parallel/sharded.py
key_shard), as in the JAX package.  On one card the placement is the
whole change: the store's columns are the flat [S * shard_cap, ...] view
of the shards' slabs, every read already takes the occupancy mask, and
K1/K2, K3, K4, K5 and K6/K7 run over the flat table as they do unsharded
(the JAX package lets GSPMD split the same programs over its devices).

The store runs its external allocator: the mixin picks slots (per-shard
fill and per-shard free lists; a drop punches an occupancy hole and
never moves a row), and only _regrow's wholesale renumbering (s * cap + r
-> s * 2cap + r) moves rows: one store remap, the host arrays remapped
alike, and the index marked for a rebuild (its CSR holds slot numbers).
A spilled store does not remap, so a sharded engine refuses a spill
config at construction (the JAX driver fails at its first regrow).

Models cross layouts unchanged: pack/unpack exchange the host row dicts
(the single-device format), and unpack re-places every id through _row.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from jubatus_tpu_torch.models.anomaly import AnomalyDriver
from jubatus_tpu_torch.models.recommender import RecommenderDriver
from jubatus_tpu_torch.parallel.mesh import Mesh
from jubatus_tpu_torch.parallel.sharded import key_shard

SPILL_REFUSAL = ("a sharded row table keeps every page resident: its regrow "
                 "renumbers slots, which a spilled store does not do")


class ShardedRowTableMixin:
    """Key-hash row placement for the drivers built on a paged global-row
    store (plus optional per-row host arrays)."""

    _HOST_ROW_ARRAYS: tuple = ()
    _HOST_ROW_FILL: Dict[str, Any] = {}
    MIN_SHARD_CAP = 16
    PAGES_EXTERNAL_ALLOC = True

    def __init__(self, config: Dict[str, Any], mesh: Mesh):
        self.mesh = mesh
        self.nshard = mesh.shape["shard"]
        if int((config.get("pages") or {}).get("resident_pages", 0)) > 0:
            raise ValueError(SPILL_REFUSAL)
        super().__init__(config, device=mesh.device)

    # -- allocation ----------------------------------------------------------

    def _initial_capacity(self) -> int:
        self.shard_cap = max(-(-self.INITIAL_ROWS // self.nshard),
                             self.MIN_SHARD_CAP)
        return self.shard_cap * self.nshard

    def _alloc(self) -> None:
        super()._alloc()
        self._shard_next = [0] * self.nshard
        self._shard_free = [[] for _ in range(self.nshard)]

    def _grow_kr(self, need: int) -> None:
        old = self.kr
        super()._grow_kr(need)
        if self.kr != old:
            # the widened columns through the store's placement
            self.pages.place()

    # -- placement -----------------------------------------------------------

    def _row(self, id_: str) -> int:
        row = self.ids.get(id_)
        if row is not None:
            return row
        s = key_shard(id_, self.nshard)
        if self._shard_free[s]:
            row = self._shard_free[s].pop()
        else:
            if self._shard_next[s] >= self.shard_cap:
                self._regrow()
            row = s * self.shard_cap + self._shard_next[s]
            self._shard_next[s] += 1
        self.ids[id_] = row
        while len(self.row_ids) <= row:
            self.row_ids.append("")
        self.row_ids[row] = id_
        self.pages.occupy([row])
        return row

    def _remove_row(self, id_: str, record_tombstone: bool = True,
                    **kw) -> bool:
        row = self.ids.get(id_)
        ok = super()._remove_row(id_, record_tombstone, **kw)
        if ok and row is not None:
            # the freed slot back on its shard's list (the store only
            # tracked the occupancy hole)
            self._shard_free[row // self.shard_cap].append(row)
        return ok

    def _regrow(self) -> None:
        """Double every shard's capacity: rows move from s * cap + r to
        s * 2cap + r, in one store remap (one index_copy_ a column) and
        the host arrays alike."""
        old_cap, n = self.shard_cap, self.nshard
        new_cap = old_cap * 2
        s, r = np.divmod(np.arange(n * old_cap), old_cap)
        new_rows = s * new_cap + r
        self.pages.remap(new_rows, n * new_cap)
        for name in self._HOST_ROW_ARRAYS:
            arr = getattr(self, name, None)
            if arr is None:
                continue
            new = np.full((n * new_cap,) + arr.shape[1:],
                          self._HOST_ROW_FILL.get(name, 0), arr.dtype)
            new[new_rows] = arr[: n * old_cap]
            setattr(self, name, new)

        def move(row: int) -> int:
            return (row // old_cap) * new_cap + (row % old_cap)

        self.ids = {k: move(v) for k, v in self.ids.items()}
        row_ids = [""] * (n * new_cap)
        for k, v in self.ids.items():
            row_ids[v] = k
        self.row_ids = row_ids
        self._shard_free = [[move(x) for x in lst] for lst in self._shard_free]
        self.shard_cap = new_cap
        if self.index is not None:
            # every slot moved: the index's CSR and delta hold the old
            # numbers, so the next engaged read rebuilds it
            self.index.mark_rebuild()

    def get_status(self) -> Dict[str, str]:
        st = super().get_status()
        st["shard_devices"] = str(self.nshard)
        st["shard_capacity"] = str(self.shard_cap)
        return st


class ShardedRecommenderDriver(ShardedRowTableMixin, RecommenderDriver):
    """Recommender (every method) with its row store placed by key hash
    (recommender.idl `#@cht` row placement)."""


class ShardedAnomalyDriver(ShardedRowTableMixin, AnomalyDriver):
    """Anomaly (lof, light_lof) with its point table placed by key hash
    (anomaly_serv.cpp:181-205).  Its LOF tables, and the store norms the
    port keeps on the host, are row arrays; the kNN lists hold slot
    numbers, remapped by the regrow too."""

    _HOST_ROW_ARRAYS = ("kdist", "lrd", "knn_rows", "knn_dists", "_norms")
    _HOST_ROW_FILL = {"knn_rows": -1, "knn_dists": np.inf}

    def _regrow(self) -> None:
        old_cap = self.shard_cap
        super()._regrow()
        # the kNN lists' CONTENTS are slots: the same shard move
        nn = self.knn_rows
        pos = nn >= 0
        vals = nn[pos]
        nn[pos] = (vals // old_cap) * self.shard_cap + (vals % old_cap)
