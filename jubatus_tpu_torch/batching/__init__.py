"""Micro-batching between the RPC layer and the device (counterpart of
jubatus_tpu/batching):

  bucketing.py  — power-of-two shape buckets and the fused-batch builder
  controller.py — the queue-depth-driven batching-window controller
  coalescer.py  — RequestCoalescer (the per-request train dispatcher's
                  and the read lane's fused steps) and InlineCoalescer
                  (inline dispatch's per-burst fused calls)
  arenas.py     — recycled host arenas (pinned for cuda drivers) for the
                  native batched ingest path
"""

from jubatus_tpu_torch.batching.bucketing import (B_BUCKETS,
                                                  fuse_sparse_batches,
                                                  round_b, split_groups)
from jubatus_tpu_torch.batching.coalescer import (InlineCoalescer,
                                                  RequestCoalescer)
from jubatus_tpu_torch.batching.controller import (FixedWindow,
                                                   WindowController)

__all__ = ["B_BUCKETS", "fuse_sparse_batches", "round_b", "split_groups",
           "FixedWindow", "InlineCoalescer", "RequestCoalescer",
           "WindowController"]
