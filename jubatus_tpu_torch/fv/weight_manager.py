"""Global feature weighting (idf / user weights) over the hashed space
(copy of jubatus_tpu/fv/weight_manager.py).

jubatus_core's weight_manager keeps string-keyed tf/df counters and is
itself MIXed between servers (the `weight` service exposes it directly,
Jubatus's server/server/weight_serv.hpp).  Here the
counters live in fixed-width numpy arrays indexed by the hashed feature id,
so the mix diff is an elementwise array sum — an all-reduce-ready layout.
"""

from __future__ import annotations

import numpy as np


class WeightManager:
    def __init__(self, dim: int):
        self.dim = dim
        self.df = np.zeros(dim, dtype=np.uint32)       # document frequency
        self.doc_count = 0
        self.user_weights = np.zeros(dim, dtype=np.float32)
        # deltas since last mix (the get_diff payload)
        self._df_diff = np.zeros(dim, dtype=np.uint32)
        self._doc_diff = 0

    def update(self, unique_indices: np.ndarray) -> None:
        """Record one document's (deduplicated) feature indices."""
        self.df[unique_indices] += 1
        self._df_diff[unique_indices] += 1
        self.doc_count += 1
        self._doc_diff += 1

    def add_weight(self, index: int, weight: float) -> None:
        self.user_weights[index] = weight

    def idf(self, indices: np.ndarray) -> np.ndarray:
        n = max(self.doc_count, 1)
        return np.log((n + 1.0) / (self.df[indices].astype(np.float64) + 1.0)).astype(np.float32)

    def bm25(self, indices: np.ndarray) -> np.ndarray:
        """Okapi BM25 inverse document frequency (the probabilistic idf of
        BM25's term-weighting; SURVEY §2.12 lists idf/bm25 as the consumed
        weighting surface):

            log(1 + (N - df + 0.5) / (df + 0.5))

        The +1 inside the log keeps weights positive for terms appearing
        in over half the corpus (the standard non-negative variant).  The
        tf-saturation half of BM25 is the sample-weight side (bin/tf/
        log_tf) by jubatus's split of per-document vs corpus weighting."""
        n = max(self.doc_count, 1)
        df = self.df[indices].astype(np.float64)
        return np.log1p((n - df + 0.5) / (df + 0.5)).astype(np.float32)

    def global_weight(self, indices: np.ndarray, kind: str) -> np.ndarray:
        if kind == "bin":
            return np.ones(len(indices), dtype=np.float32)
        if kind == "idf":
            return self.idf(indices)
        if kind == "bm25":
            return self.bm25(indices)
        if kind == "weight":
            return self.user_weights[indices]
        raise ValueError(f"unknown global_weight: {kind}")

    # -- mixable algebra (linear: get_diff / mix / put_diff) ---------------

    def get_diff(self):
        # sparse: only features whose document frequency moved since the
        # last round (a dense [dim] uint32 array dominated mix payloads)
        j = np.flatnonzero(self._df_diff).astype(np.int32)
        return {"cols": j, "vals": self._df_diff[j].astype(np.int32),
                "doc_count": self._doc_diff}

    @staticmethod
    def _as_sparse(side):
        if "df" in side:                       # legacy dense diff
            df = np.asarray(side["df"])
            j = np.flatnonzero(df)
            return j.astype(np.int64), df[j].astype(np.int64)
        return (np.asarray(side["cols"], np.int64),
                np.asarray(side["vals"], np.int64))

    @staticmethod
    def mix(lhs, rhs):
        lj, lv = WeightManager._as_sparse(lhs)
        rj, rv = WeightManager._as_sparse(rhs)
        cols = np.union1d(lj, rj)
        vals = np.zeros((cols.size,), np.int64)
        if lj.size:
            vals[np.searchsorted(cols, lj)] += lv
        if rj.size:
            vals[np.searchsorted(cols, rj)] += rv
        return {"cols": cols.astype(np.int32), "vals": vals,
                "doc_count": int(lhs["doc_count"]) + int(rhs["doc_count"])}

    def put_diff(self, diff) -> None:
        # replace local unmixed deltas with the cluster-merged totals
        j, v = self._as_sparse(diff)
        df = self.df.astype(np.int64) - self._df_diff
        if j.size:
            df[j] += v
        self.df = np.maximum(df, 0).astype(np.uint32)
        self.doc_count = self.doc_count - self._doc_diff + int(diff["doc_count"])
        self._df_diff[:] = 0
        self._doc_diff = 0

    def clear(self) -> None:
        self.df[:] = 0
        self.doc_count = 0
        self.user_weights[:] = 0
        self._df_diff[:] = 0
        self._doc_diff = 0

    # -- persistence -------------------------------------------------------

    def pack(self):
        return {
            "df": self.df.tobytes(),
            "doc_count": self.doc_count,
            "user_weights": self.user_weights.tobytes(),
        }

    def unpack(self, obj) -> None:
        self.df = np.frombuffer(obj["df"], dtype=np.uint32).copy()
        self.doc_count = int(obj["doc_count"])
        self.user_weights = np.frombuffer(obj["user_weights"], dtype=np.float32).copy()
        self._df_diff = np.zeros(self.dim, dtype=np.uint32)
        self._doc_diff = 0
