"""Micro-batching between the RPC layer and the device (counterpart of
jubatus_tpu/batching):

  bucketing.py  — power-of-two shape buckets and the fused-batch builder
  controller.py — the queue-depth-driven batching-window controller
  coalescer.py  — RequestCoalescer, the read lane's fused sweeps
  arenas.py     — recycled host arenas (pinned for cuda drivers) for the
                  native batched ingest path
"""

from jubatus_tpu_torch.batching.bucketing import (B_BUCKETS,
                                                  fuse_sparse_batches,
                                                  round_b, split_groups)
from jubatus_tpu_torch.batching.controller import WindowController

__all__ = ["B_BUCKETS", "fuse_sparse_batches", "round_b", "split_groups",
           "WindowController"]
