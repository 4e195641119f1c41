from jubatus_tpu_torch.batching.bucketing import (B_BUCKETS,
                                                  fuse_sparse_batches,
                                                  round_b, split_groups)

__all__ = ["B_BUCKETS", "fuse_sparse_batches", "round_b", "split_groups"]
