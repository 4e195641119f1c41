"""Multi-probe bucketed-signature index over the existing LSH tables
(counterpart of jubatus_tpu/index/lsh_probe.py).

Rows are keyed by bands of their signature: `bits` consecutive bits per
band for lsh/euclid_lsh (hash_num // bits bands), one slot folded to
2^bits buckets for minhash.  A query probes its first `probes` bands —
and, past the band count, 1-bit neighbor flips — and rescores only the
probed buckets' rows with the full sweep's exact similarity math
(ops/candidates.py: K6 on the card), so pruning trades recall, never precision.
"""

from __future__ import annotations

import numpy as np

from jubatus_tpu_torch.index.base import CandidateIndex, IndexSpec
from jubatus_tpu_torch.ops import candidates as candops


class SigProbeIndex(CandidateIndex):
    def __init__(self, kind: str, hash_num: int, spec: IndexSpec,
                 n_slabs: int = 1, put=None):
        self.kind = kind
        self.hash_num = int(hash_num)
        self.bits = min(int(spec.bits),
                        32 if kind == "minhash" else self.hash_num)
        self.n_bands = candops.n_bands_for(kind, self.hash_num, self.bits)
        self.plan = candops.band_plan(kind, self.hash_num, self.bits,
                                      int(spec.probes))
        super().__init__(spec, self.n_bands, 1 << self.bits,
                         n_slabs=n_slabs, put=put)

    def note_sigs(self, rows, sigs: np.ndarray, slab: int = 0) -> None:
        """Incremental maintenance: rows' (new) signatures -> band
        buckets.  Caller holds the model write lock; numpy only."""
        rows = np.asarray(rows)
        if not rows.size:
            return
        buckets = candops.bucket_assign_np(self.kind, sigs, self.n_bands,
                                           self.bits)
        self.store.note_rows(rows, buckets, slab=slab)

    def rebuild_from(self, sigs_by_slab) -> None:
        """Lazy rebuild from the row table: {slab: (rows, sigs)} with
        every LIVE row's slot and signature (post-recovery/unpack)."""
        self.store.clear()
        for slab, (rows, sigs) in sigs_by_slab.items():
            self.note_sigs(rows, sigs, slab=slab)
        self.needs_rebuild = False
        from jubatus_tpu_torch.utils import metrics as _metrics
        _metrics.GLOBAL.inc("index_rebuild_total")
