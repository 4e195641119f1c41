"""The spilled sweeps of the port (jubatus_tpu_torch/ops/paged.py) against
the JAX package's (jubatus_tpu/ops/paged.py), on the CPU: two stores, one
of each package, given the same seeded history of allocations, writes and
drops, then each of sig_scores, dense_dots, dense_scores and topk on the
same queries, bitwise (==), with the streamed pages counted alike.

Covered: the three signature kinds, both exact metrics, a pool with holes
(dropped rows inside resident and absent pages), and a table whose absent
pages end in a partial chunk (the port's chunk cut to a few pages, so a
read streams several chunks, the last one short; the JAX package's chunk
of 16 pages is partial too).  The score of a row depends only on the row
and the query, so the two packages' different chunk widths change no
bit.
"""

import numpy as np
import pytest
import torch

from jubatus_tpu.models.pages import PagedRowStore as JStore
from jubatus_tpu.models.pages import PageSpec as JSpec
from jubatus_tpu.ops import paged as jpaged
from jubatus_tpu.utils.metrics import GLOBAL as JMETRICS
from jubatus_tpu_torch.models.pages import PagedRowStore as TStore
from jubatus_tpu_torch.models.pages import PageSpec as TSpec
from jubatus_tpu_torch.ops import lsh as tlsh
from jubatus_tpu_torch.ops import paged as tpaged
from jubatus_tpu_torch.utils.metrics import GLOBAL as TMETRICS

PAGE_ROWS, BUDGET = 16, 3
KINDS = ("lsh", "minhash", "euclid_lsh")


def _counter(reg, name):
    return reg._counters.get(name, 0.0) if reg is TMETRICS \
        else reg.counter(name)


def _stores(columns, n, holes, seed):
    """A JAX and a port store in spill mode after the same history: n rows
    written in a few batches, `holes` of them dropped, a few re-allocated
    into the freed slots and rewritten.  columns: the schema and, under
    "__gen__", the row generator."""
    rng = np.random.default_rng(seed)
    gen = columns["__gen__"]
    cols = {k: v for k, v in columns.items() if k != "__gen__"}
    j = JStore(cols, capacity=PAGE_ROWS,
               spec=JSpec(page_rows=PAGE_ROWS, resident_pages=BUDGET))
    t = TStore(cols, capacity=PAGE_ROWS, device="cpu",
               spec=TSpec(page_rows=PAGE_ROWS, resident_pages=BUDGET))
    done = 0
    while done < n:
        b = int(min(n - done, rng.integers(5, 40)))
        sj, st = j.alloc(b), t.alloc(b)
        np.testing.assert_array_equal(sj, st)
        vals = gen(rng, b)
        j.write(sj, vals)
        t.write(st, vals)
        done += b
    if holes:
        drop = rng.choice(n, holes, replace=False)
        assert j.free(drop) == t.free(drop)
        sj, st = j.alloc(holes // 3), t.alloc(holes // 3)
        np.testing.assert_array_equal(sj, st)
        vals = gen(rng, holes // 3)
        j.write(sj, vals)
        t.write(st, vals)
    np.testing.assert_array_equal(j.mask_host(), t.mask_host())
    assert j.get_status() == t.get_status()
    return j, t


def _sig_columns(kind, hash_num=64):
    w = tlsh.sig_width(kind, hash_num)

    def gen(rng, b):
        if kind == "minhash":
            sig = rng.integers(0, 5, (b, w)).astype(np.uint32)
        else:
            sig = rng.integers(0, 2 ** 32, (b, w),
                               dtype=np.uint64).astype(np.uint32)
        return {"sig": sig, "norms": (np.abs(rng.standard_normal(b)) * 3)
                .astype(np.float32)}
    return {"sig": ((w,), np.uint32), "norms": ((), np.float32),
            "__gen__": gen}


def _dense_columns(kr=32, dim=64):
    def gen(rng, b):
        idx = rng.integers(0, dim, (b, kr)).astype(np.int32)
        val = rng.standard_normal((b, kr)).astype(np.float32)
        val[:, kr // 2:] = 0.0
        return {"indices": idx, "values": val,
                "norms": np.sqrt((val * val).sum(1)).astype(np.float32)}
    return {"indices": ((kr,), np.int32), "values": ((kr,), np.float32),
            "norms": ((), np.float32), "__gen__": gen}


@pytest.fixture(params=["one_chunk", "partial_chunks"])
def chunking(request, monkeypatch):
    if request.param == "partial_chunks":
        # 3 pages a chunk: the absent pages end in a short chunk
        monkeypatch.setattr(tpaged, "SPILL_CHUNK_ROWS", 3 * PAGE_ROWS)
    return request.param


def _both_counted(fn_j, fn_t):
    j0 = _counter(JMETRICS, "page_spill_in_total")
    t0 = _counter(TMETRICS, "page_spill_in_total")
    a, b = fn_j(), fn_t()
    assert _counter(JMETRICS, "page_spill_in_total") - j0 == \
        _counter(TMETRICS, "page_spill_in_total") - t0
    return a, b


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        a.tobytes() == b.tobytes()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("holes", [0, 30])
def test_sig_scores_equal_jax(kind, holes, chunking):
    j, t = _stores(_sig_columns(kind), 300, holes, seed=len(kind) + holes)
    rng = np.random.default_rng(7)
    w = tlsh.sig_width(kind, 64)
    for nq in (1, 3):
        if kind == "minhash":
            q = rng.integers(0, 5, (nq, w)).astype(np.uint32)
        else:
            q = rng.integers(0, 2 ** 32, (nq, w),
                             dtype=np.uint64).astype(np.uint32)
        qn = (np.abs(rng.standard_normal(nq)) * 3).astype(np.float32)
        a, b = _both_counted(
            lambda: jpaged.sig_scores(j, kind, 64, q, qn),
            lambda: tpaged.sig_scores(t, kind, 64, q, qn))
        assert _same(a, b)
        assert np.isneginf(b[:, ~t.mask_host()]).all()


@pytest.mark.parametrize("holes", [0, 30])
def test_dense_dots_equal_jax(holes, chunking):
    j, t = _stores(_dense_columns(), 300, holes, seed=holes + 1)
    qd = np.random.default_rng(3).standard_normal((5, 64)) \
        .astype(np.float32)
    a, b = _both_counted(lambda: jpaged.dense_dots(j, qd),
                         lambda: tpaged.dense_dots(t, qd))
    assert _same(a, b)


@pytest.mark.parametrize("metric", ["cosine", "euclid"])
@pytest.mark.parametrize("holes", [0, 30])
def test_dense_scores_equal_jax(metric, holes, chunking):
    j, t = _stores(_dense_columns(), 250, holes, seed=holes + 2)
    rng = np.random.default_rng(4)
    for _ in range(2):
        qd = rng.standard_normal(64).astype(np.float32)
        qn = float(np.sqrt((qd * qd).sum()))
        a, b = _both_counted(
            lambda: jpaged.dense_scores(j, metric, qd, qn),
            lambda: tpaged.dense_scores(t, metric, qd, qn))
        assert _same(a, b)


@pytest.mark.parametrize("k", [1, 10, 500])
def test_topk_equal_jax(k):
    """Ties (scores drawn from a few values), masked rows, and k past the
    valid rows."""
    rng = np.random.default_rng(k)
    scores = rng.integers(0, 6, 400).astype(np.float32) / 5
    mask = rng.random(400) > 0.2
    a, b = jpaged.topk(scores, mask, k), tpaged.topk(scores, mask, k)
    assert _same(a[0], b[0]) and _same(a[1], b[1])


def test_a_cpu_store_sweeps_with_the_plain_versions():
    """The sweeps run on the store's device: a store on the CPU takes K5's
    plain version (its scores mode), row for row."""
    t = TStore({"sig": ((2,), np.uint32), "norms": ((), np.float32)},
               capacity=32, device="cpu",
               spec=TSpec(page_rows=8, resident_pages=1))
    s = t.alloc(20)
    t.write(s, {"sig": np.arange(40, dtype=np.uint32).reshape(20, 2),
                "norms": np.ones(20, np.float32)})
    out = tpaged.sig_scores(t, "lsh", 64, np.zeros((1, 2), np.uint32),
                            np.ones(1, np.float32))
    want = tlsh.sig_scores_ref(
        "lsh", torch.from_numpy(t.read("sig", s).view(np.int32)),
        torch.zeros((1, 2), dtype=torch.int32),
        torch.ones(20), torch.ones(1), 64).numpy()
    assert _same(out[:, s], want)
    # the sweep masks from the pool mask and each chunk's occupancy: no
    # capacity-wide mask on the device
    assert t._mask_dev is None and np.isneginf(out[:, 20:]).all()
