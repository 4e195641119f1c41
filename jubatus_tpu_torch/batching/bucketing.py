"""Shape bucketing for coalesced device steps (copy of
jubatus_tpu/batching/bucketing.py).

The batch axis is padded to the same power-of-two buckets as the JAX
package, so both packages step over identically shaped batches.  The JAX
package's compile-cache counters have no counterpart: PyTorch runs eagerly
and compiles nothing per shape.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# batch-axis buckets.  Beyond the table: power-of-two multiples of 8192.
B_BUCKETS = (8, 32, 128, 512, 2048, 8192)


def round_b(b: int) -> int:
    """Round a batch size up to its bucket."""
    for x in B_BUCKETS:
        if b <= x:
            return x
    x = 8192
    while x < b:
        x *= 2
    return x


def split_groups(flat, groups):
    """Demux a flat per-datum result list back into per-request groups."""
    out, pos = [], 0
    for g in groups:
        out.append(flat[pos: pos + len(g)])
        pos += len(g)
    return out


def fuse_sparse_batches(batches) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray, np.ndarray]:
    """Concatenate per-request padded sparse batches for one device step:
    batches is a list of (indices [B,K], values [B,K], aux [B], mask [B]);
    K is padded to the widest request and the batch axis to its bucket."""
    kmax = max(b[0].shape[1] for b in batches)

    def padk(a):
        return a if a.shape[1] == kmax else np.pad(
            a, ((0, 0), (0, kmax - a.shape[1])))

    indices = np.concatenate([padk(b[0]) for b in batches])
    values = np.concatenate([padk(b[1]) for b in batches])
    aux = np.concatenate([b[2] for b in batches])
    mask = np.concatenate([b[3] for b in batches])
    b_out = round_b(indices.shape[0])
    if b_out != indices.shape[0]:
        pad = b_out - indices.shape[0]
        indices = np.pad(indices, ((0, pad), (0, 0)))
        values = np.pad(values, ((0, pad), (0, 0)))
        aux = np.pad(aux, (0, pad))
        mask = np.pad(mask, (0, pad))
    return indices, values, aux, mask
