"""IVF-style coarse quantizer for the exact (dense-metric) methods
(counterpart of jubatus_tpu/index/ivf.py, numpy only).

Rows are count-sketch-embedded into a small dense space (E coords,
inner products preserved in expectation — ops/candidates.cs_embed_np)
and clustered by a few deterministic Lloyd iterations; each row's
inverted-list group is its nearest centroid, found with one [N, E] x
[E, C] blocked matmul per maintenance batch.  A query embeds the same
way, probes its top-`probes` centroids, and exact-rescores only their
lists with the full sweep's metric math.

Centroids are trained lazily at the first engaged query and retrained
when the table doubles; training is deterministic (stride sampling, no
RNG) so every replica of a table builds the same quantizer.
"""

from __future__ import annotations

import numpy as np

from jubatus_tpu_torch.index.base import CandidateIndex, IndexSpec
from jubatus_tpu_torch.ops import candidates as candops

_KMEANS_ITERS = 5
_TRAIN_SAMPLE = 16384
_ROWS_PER_CENTROID = 64     # auto-sizing target: coarse enough that a
#                             natural cluster spans few cells (recall at
#                             low probe counts), fine enough to prune


def _auto_centroids(n_rows: int) -> int:
    c = 8
    while c * _ROWS_PER_CENTROID < n_rows and c < 1024:
        c *= 2
    return c


class IvfIndex(CandidateIndex):
    def __init__(self, metric: str, spec: IndexSpec, n_slabs: int = 1,
                 put=None):
        self.metric = metric                      # cosine | euclid
        self.embed_dim = int(spec.embed_dim)
        self.centroids = None                     # np [C, E]
        self._d_centroids = None
        self._trained_rows = 0
        # TWO bands: every row is listed under its nearest AND
        # second-nearest centroid (rank-2 soft assignment) — a query
        # probing its top-`probes` centroids then reaches any row whose
        # top-2 cells intersect them, which is what holds recall at the
        # default probe count when k-means splits a natural cluster
        super().__init__(spec, 2, max(int(spec.centroids), 1),
                         n_slabs=n_slabs, put=put)

    @property
    def ready(self) -> bool:
        return self.centroids is not None

    def stale(self, n_rows: int) -> bool:
        return self.needs_rebuild or self.needs_train(n_rows)

    # -- training ------------------------------------------------------------

    def needs_train(self, n_rows: int) -> bool:
        return self.centroids is None or n_rows >= 2 * self._trained_rows

    def train(self, embeddings: np.ndarray) -> None:
        """Deterministic k-means over a stride sample of row embeddings;
        rebuilds the bucket store for the new centroid count."""
        n = embeddings.shape[0]
        if n > _TRAIN_SAMPLE:
            embeddings = embeddings[:: max(1, n // _TRAIN_SAMPLE)]
        c = int(self.spec.centroids) or _auto_centroids(n)
        c = max(2, min(c, len(embeddings)))
        cent = embeddings[:: max(1, len(embeddings) // c)][:c].copy()
        for _ in range(_KMEANS_ITERS):
            assign = np.argmax(embeddings @ cent.T
                               - 0.5 * (cent * cent).sum(1)[None, :], axis=1)
            for j in range(c):
                sel = assign == j
                if sel.any():
                    cent[j] = embeddings[sel].mean(axis=0)
        from jubatus_tpu_torch.index.store import BucketStore
        new_store = BucketStore(2, c, n_slabs=self.store.n_slabs,
                                delta_cap=self.spec.delta_cap)
        # monotonic across the swap: a racing device_csr holding the
        # OLD store's views must never find its captured version equal
        # to the new store's and re-stamp the cache with stale arrays
        new_store.version = self.store.version + 1
        with self._dev_lock:
            self.centroids = cent.astype(np.float32)
            self._d_centroids = None
            self._trained_rows = n
            self.store = new_store
            self._dev = None

    def device_centroids(self):
        if self._d_centroids is None:
            self._d_centroids = self._put(self.centroids)
        return self._d_centroids

    # -- maintenance ---------------------------------------------------------

    def assign_np(self, emb: np.ndarray) -> np.ndarray:
        """[n, E] embeddings -> [2, n] (nearest, second-nearest)
        centroid ids (the blocked-matmul assignment; argmax of
        dot - |c|^2/2 == argmin of euclidean distance)."""
        scores = emb @ self.centroids.T \
            - 0.5 * (self.centroids * self.centroids).sum(1)[None, :]
        if scores.shape[1] < 2:
            top = np.zeros((len(emb),), np.int64)
            return np.stack([top, top]).astype(np.int32)
        top2 = np.argpartition(-scores, 1, axis=1)[:, :2]
        first_is_best = np.take_along_axis(scores, top2[:, :1], 1) >= \
            np.take_along_axis(scores, top2[:, 1:], 1)
        best = np.where(first_is_best[:, 0], top2[:, 0], top2[:, 1])
        second = np.where(first_is_best[:, 0], top2[:, 1], top2[:, 0])
        return np.stack([best, second]).astype(np.int32)

    def note_rows(self, rows, idx_np: np.ndarray, val_np: np.ndarray,
                  slab: int = 0) -> None:
        """Incremental maintenance from a dirty sync batch's padded
        sparse rows (caller holds the model write/sync discipline)."""
        if self.centroids is None:
            # not trained yet — the first engaged query rebuilds (and
            # assigns) everything, so pre-train deltas would be wasted
            return
        rows = np.asarray(rows)
        if not rows.size:
            return
        emb = candops.cs_embed_np(idx_np, val_np, self.embed_dim)
        self.store.note_rows(rows, self.assign_np(emb), slab=slab)

    def rebuild_from(self, rows: np.ndarray, idx_np: np.ndarray,
                     val_np: np.ndarray) -> None:
        """Train (if due) + assign every live row, in embedding blocks."""
        emb = np.concatenate(
            [candops.cs_embed_np(idx_np[a: a + 8192], val_np[a: a + 8192],
                                 self.embed_dim)
             for a in range(0, max(len(rows), 1), 8192)], axis=0) \
            if len(rows) else np.zeros((0, self.embed_dim), np.float32)
        if self.needs_train(len(rows)):
            if len(rows) < 2:
                self.needs_rebuild = False   # nothing to index yet;
                return                       # ready stays False
            self.train(emb)
        self.store.clear()
        if len(rows):
            # assignment in the same row blocks as the embedding pass:
            # one [N, C] score matrix at 10^6 rows would transiently
            # cost gigabytes on the query path
            assign = np.concatenate(
                [self.assign_np(emb[a: a + 8192])
                 for a in range(0, len(emb), 8192)], axis=1)
            self.store.note_rows(np.asarray(rows), assign, slab=0)
        self.needs_rebuild = False
        from jubatus_tpu_torch.utils import metrics as _metrics
        _metrics.GLOBAL.inc("index_rebuild_total")

    def get_status(self):
        st = super().get_status()
        st["index_centroids"] = str(
            0 if self.centroids is None else len(self.centroids))
        return st
