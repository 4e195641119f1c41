"""Seeded inputs of the candidate-index tests (test_torch_candidates.py,
test_torch_index.py, test_torch_cuda.py): prototype-clustered signature
tables (ties and duplicates across probes are common there, as in
bench.py's sublinear tables), their bucket store, and sparse row
tables.  numpy and the port only, so the card's tests can use it."""

import numpy as np

from jubatus_tpu_torch.index.store import BucketStore
from jubatus_tpu_torch.ops import candidates as cands
from jubatus_tpu_torch.ops import lsh as tl


def clustered_sigs(kind, h, n, seed, protos=20, flip=0.05):
    """(sig uint32 [n, W], norms float32 [n]): every row a copy of one of
    `protos` prototypes with a few bits (minhash: slots) changed."""
    rng = np.random.default_rng(seed)
    w = tl.sig_width(kind, h)
    if kind == "minhash":
        proto = rng.integers(0, 64, (protos, w)).astype(np.uint32)
    else:
        proto = rng.integers(0, 2 ** 32, (protos, w),
                             dtype=np.uint64).astype(np.uint32)
    sig = proto[rng.integers(0, protos, n)]
    hit = rng.random((n, w)) < flip
    if kind == "minhash":
        sig = np.where(hit, rng.integers(0, 96, (n, w)).astype(np.uint32),
                       sig)
    else:
        noise = rng.integers(0, 2 ** 32, (n, w), dtype=np.uint64)
        sig = sig ^ (hit * noise).astype(np.uint32) & np.uint32(0x01010101)
    norms = (rng.random(n) * 3).astype(np.float32)
    return np.ascontiguousarray(sig, np.uint32), norms


def sig_index(kind, h, sig, probes, bits=8, delta_cap=16, fresh=10,
              seed=0):
    """(store, plan, bits): every row noted and packed, then `fresh`
    random rows noted again, which the delta serves until the next pack
    (0: an empty delta; delta_cap: a full one)."""
    bits = min(bits, 32 if kind == "minhash" else h)
    nb = cands.n_bands_for(kind, h, bits)
    store = BucketStore(nb, 1 << bits, delta_cap=delta_cap)
    buckets = cands.bucket_assign_np(kind, sig, nb, bits)
    n = sig.shape[0]
    store.note_rows(np.arange(n), buckets)
    store.packed()
    if fresh:
        rows = np.random.default_rng(seed).choice(n, fresh, replace=False)
        store.note_rows(rows, buckets[:, rows])
    return store, cands.band_plan(kind, h, bits, probes), bits


def sparse_rows(n, kr, d, seed, nnz=20, centers=0):
    """(indices int32 [n, kr], values float32 [n, kr]): 1 to nnz distinct
    columns a row from [0, d), zero padded; with `centers`, each row the
    columns of one of that many centers with jittered values."""
    rng = np.random.default_rng(seed)
    idx = np.zeros((n, kr), np.int32)
    val = np.zeros((n, kr), np.float32)
    if centers:
        cidx = [rng.choice(d, nnz, replace=False) for _ in range(centers)]
        cval = rng.standard_normal((centers, nnz)).astype(np.float32)
        who = rng.integers(0, centers, n)
        idx[:, :nnz] = np.stack(cidx)[who]
        val[:, :nnz] = cval[who] + 0.05 * rng.standard_normal(
            (n, nnz)).astype(np.float32)
        return idx, val
    for i in range(n):
        k = int(rng.integers(1, nnz + 1))
        idx[i, :k] = rng.choice(d, k, replace=False)
        val[i, :k] = rng.standard_normal(k).astype(np.float32)
    return idx, val
