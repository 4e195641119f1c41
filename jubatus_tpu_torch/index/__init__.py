"""Device-resident multi-probe candidate index for the query path
(counterpart of jubatus_tpu/index/).

Turns the row-store engines' full O(rows) top-k sweep into candidate
pruning + exact rescore (ops/candidates.py).  `make_index_spec` parses
the --index/--index_probes knobs; drivers own an index instance via
their configure_index() and keep it maintained incrementally under the
existing write-lock discipline (no new journal record types — the index
is derived state, rebuilt lazily from the row table after recovery or
handoff).
"""

from jubatus_tpu_torch.index.base import (INDEX_KINDS, CandidateIndex,
                                          IndexSpec, make_index_spec,
                                          tie_aware_recall)
from jubatus_tpu_torch.index.ivf import IvfIndex
from jubatus_tpu_torch.index.lsh_probe import SigProbeIndex
from jubatus_tpu_torch.index.store import BucketStore

__all__ = ["INDEX_KINDS", "CandidateIndex", "IndexSpec", "make_index_spec",
           "tie_aware_recall", "BucketStore", "SigProbeIndex", "IvfIndex"]
