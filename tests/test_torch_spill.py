"""The port's spill tier (jubatus_tpu_torch/models/pages.py in spill mode,
ops/paged.py and the engines' spilled routes) against the JAX package's,
on the CPU, mirroring tests/test_paged.py:

- the store: a write wider than the budget, clear after growth, faults
  and evictions, each with the page table, the clock and the spill
  counters equal to a JAX store's after the same history;
- layout parity: nearest_neighbor, the recommender (inverted_index, lsh)
  and anomaly (lof, exact and euclid_lsh) at {"page_rows": 16,
  "resident_pages": 3} against the resident layout: the port's reads
  tie-aware equal to its resident twin's (the JAX package's own spilled
  and resident routes differ in tie order) and bitwise (==) a JAX
  spilled driver's; pack() bytes identical across layouts and packages;
  a save/load round trip from page_rows 8 to a spilled layout; holes
  from clear_row and the LRU unlearner;
- enforced spill: a table of four times its budget answers exactly, the
  counters move, an engaged index is bypassed;
- over the wire: a port server with a spill config answers as a JAX
  driver, its get_status carries the page keys, and a journal replayed
  through recovery restores the spilled table bitwise.
"""

import json
import os
import shutil

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from jubatus_tpu.fv import Datum as JDatum
from jubatus_tpu.models.base import create_driver as jcreate
from jubatus_tpu.models.pages import PagedRowStore as JStore
from jubatus_tpu.models.pages import PageSpec as JSpec
from jubatus_tpu.utils.metrics import GLOBAL as JMETRICS
from jubatus_tpu_torch.fv import Datum as TDatum
from jubatus_tpu_torch.models import create_driver as tcreate
from jubatus_tpu_torch.models.pages import PagedRowStore as TStore
from jubatus_tpu_torch.models.pages import PageSpec as TSpec
from jubatus_tpu_torch.utils.metrics import GLOBAL as TMETRICS
from tests import test_torch_durability as tdur
from tests.test_torch_server import _spawn_port
from tests.test_wire_golden import GoldenConn, datum_wire

NUM_CONV = {"num_rules": [{"key": "*", "type": "num"}]}
SPILL = {"page_rows": 16, "resident_pages": 3}


def nn_cfg(method="lsh", pages=None, index=None):
    cfg = {"method": method, "parameter": {"hash_num": 64},
           "converter": NUM_CONV}
    if pages is not None:
        cfg["pages"] = pages
    if index is not None:
        cfg["index"] = index
    return cfg


def reco_cfg(method="inverted_index", pages=None, max_size=0):
    param = {"hash_num": 64}
    if max_size:
        param.update(unlearner="lru",
                     unlearner_parameter={"max_size": max_size})
    cfg = {"method": method, "parameter": param, "converter": NUM_CONV}
    if pages is not None:
        cfg["pages"] = pages
    return cfg


def anomaly_cfg(nn_method="euclid_lsh", pages=None, max_size=0):
    param = {"nearest_neighbor_num": 4, "method": nn_method,
             "parameter": {"hash_num": 64}}
    if max_size:
        param.update(unlearner="lru",
                     unlearner_parameter={"max_size": max_size})
    cfg = {"method": "lof", "parameter": param, "converter": NUM_CONV}
    if pages is not None:
        cfg["pages"] = pages
    return cfg


def vecs(n, seed, dim=6):
    return np.random.default_rng(seed).standard_normal((n, dim))


def datum(cls, v):
    d = cls()
    for k, x in enumerate(v):
        d.add_number(f"f{k}", float(x))
    return d


def pair(engine, cfg):
    return jcreate(engine, cfg), tcreate(engine, cfg, device="cpu")


def tie_eq(a, b) -> bool:
    """tests/test_paged.py's: scores equal positionally, ids equal above
    the k-th score (a tie at the boundary may name other rows)."""
    sa = [round(float(s), 6) for _, s in a]
    sb = [round(float(s), 6) for _, s in b]
    if sa != sb:
        return False
    if not sa:
        return True
    kth = sa[-1]
    return {i for i, s in a if s > kth} == {i for i, s in b if s > kth}


def packed(drv) -> bytes:
    return msgpack.packb(drv.pack(), use_bin_type=True)


def tcounter(name):
    return TMETRICS._counters.get(name, 0.0)


class Counted:
    """The spill counters' movement in both packages across a block."""

    NAMES = ("page_spill_in_total", "page_spill_out_total")

    def __enter__(self):
        self.j0 = [JMETRICS.counter(n) for n in self.NAMES]
        self.t0 = [tcounter(n) for n in self.NAMES]
        return self

    def __exit__(self, *exc):
        self.jax = [JMETRICS.counter(n) - v
                    for n, v in zip(self.NAMES, self.j0)]
        self.port = [tcounter(n) - v for n, v in zip(self.NAMES, self.t0)]


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

def stores(capacity=16, page_rows=4, budget=2):
    cols = {"x": ((), np.float32)}
    return (JStore(cols, capacity=capacity,
                   spec=JSpec(page_rows=page_rows, resident_pages=budget)),
            TStore(cols, capacity=capacity, device="cpu",
                   spec=TSpec(page_rows=page_rows, resident_pages=budget)))


def same_residency(j, t):
    np.testing.assert_array_equal(j._page_loc, t._page_loc)
    np.testing.assert_array_equal(j._phys_page, t._phys_page)
    np.testing.assert_array_equal(j._ref, t._ref)
    assert j._clock == t._clock
    np.testing.assert_array_equal(np.asarray(j._pool_mask_arr),
                                  t._pool_mask.numpy())
    assert j.get_status() == t.get_status()


def test_spill_write_wider_than_budget_keeps_pool_exact():
    """A write spanning more pages than the budget, the last page first:
    every row lands, the resident pool equals the master page for page,
    and the page table and counters follow the JAX store's."""
    j, t = stores()
    sj, st = j.alloc(16), t.alloc(16)
    np.testing.assert_array_equal(sj, st)
    order = np.concatenate([st[12:], st[:12]])
    with Counted() as c:
        j.write(order, {"x": order.astype(np.float32)})
        t.write(order, {"x": order.astype(np.float32)})
    assert c.jax == c.port
    np.testing.assert_array_equal(t.read("x", st), st.astype(np.float32))
    pool_equals_master(t)
    same_residency(j, t)


def pool_equals_master(t):
    """Every resident pool page of column x holds its master page."""
    pr = t.page_rows
    for phys, logical in enumerate(t._phys_page):
        if logical >= 0:
            np.testing.assert_array_equal(
                t._pool["x"][phys * pr: (phys + 1) * pr].numpy(),
                t.read("x", np.arange(logical * pr, (logical + 1) * pr)))


@pytest.mark.parametrize("budget", [0, 2])
def test_clear_after_growth_resizes_everything(budget):
    j, t = stores(page_rows=8, budget=budget)
    for s in (j, t):
        s.write(s.alloc(1024), {"x": np.arange(1024, dtype=np.float32)})
        assert s.capacity >= 1024
        s.clear(16)
        assert s.capacity == 16 and s.n_pages == 2
        assert s.n_rows == 0 and not s.mask_host().any()
        slots = s.alloc(40)
        s.write(slots, {"x": np.arange(40, dtype=np.float32)})
        np.testing.assert_array_equal(s.read("x", slots),
                                      np.arange(40, dtype=np.float32))
    assert j.get_status() == t.get_status()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spill_pool_faults_and_evicts_as_jax(seed):
    """A seeded history of allocations, writes (some re-touching resident
    pages, which sets their reference bit) and drops through a 3-page
    pool: after every step the page table, the clock, the pool mask, the
    status and the counters' movement equal the JAX store's."""
    j, t = stores(capacity=8, page_rows=4, budget=3)
    rng = np.random.default_rng(seed)
    live = []
    with Counted() as c:
        for _ in range(60):
            op = rng.random()
            if op < 0.2 and live:
                drop = [live.pop(int(rng.integers(0, len(live))))
                        for _ in range(int(rng.integers(1, 3)))
                        if live]
                assert j.free(drop) == t.free(drop)
            elif op < 0.5 or not live:
                n = int(rng.integers(1, 7))
                sj, st = j.alloc(n), t.alloc(n)
                np.testing.assert_array_equal(sj, st)
                vals = rng.standard_normal(n).astype(np.float32)
                j.write(sj, {"x": vals})
                t.write(st, {"x": vals})
                live += st.tolist()
            else:
                k = min(len(live), int(rng.integers(1, 5)))
                sel = rng.choice(live, k, replace=False)
                vals = rng.standard_normal(k).astype(np.float32)
                j.write(sel, {"x": vals})
                t.write(sel, {"x": vals})
            same_residency(j, t)
    assert c.jax == c.port and c.port[1] > 0
    np.testing.assert_array_equal(j.read("x", live), t.read("x", live))
    assert t.resident_pages_now == 3


@pytest.mark.parametrize("budget", [0, 2])
def test_bulk_adoption_follows_jax(budget):
    """adopt_column (a new leading size re-adopts the capacity: spill
    page-aligns it), set_device of a whole column and adopt_capacity, in
    both modes: capacity, pages, occupancy, status and the rows read back
    equal a JAX store's; under spill the pages then fault in on write as
    there, with the same counters."""
    j, t = stores(budget=budget)
    x = np.arange(37, dtype=np.float32)
    j.adopt_column("x", x)
    t.adopt_column("x", x)
    assert (t.capacity, t.n_pages, t.n_rows) == \
        (j.capacity, j.n_pages, j.n_rows)
    np.testing.assert_array_equal(t.mask_host(), j.mask_host())
    np.testing.assert_array_equal(t.read("x", np.arange(37)), x)
    whole = np.arange(t.capacity, dtype=np.float32) * 2
    j.set_device("x", whole if budget else jnp.asarray(whole))
    t.set_device("x", whole if budget else torch.from_numpy(whole))
    np.testing.assert_array_equal(t.read("x", np.arange(37)),
                                  np.asarray(j.read("x", np.arange(37))))
    j.adopt_capacity(20)
    t.adopt_capacity(20)
    assert j.get_status() == t.get_status()
    with Counted() as c:
        sj, st = j.alloc(9), t.alloc(9)
        np.testing.assert_array_equal(sj, st)
        j.write(sj, {"x": sj.astype(np.float32)})
        t.write(st, {"x": st.astype(np.float32)})
    assert c.jax == c.port
    assert j.get_status() == t.get_status()
    np.testing.assert_array_equal(t.read("x", st), st.astype(np.float32))


@pytest.mark.parametrize("how", ["set_device", "adopt_column"])
def test_wholesale_column_rewrites_refresh_the_pool(how):
    """Replacing a spilled column wholesale at the same capacity rewrites
    the resident pool pages from the new master (no read sweeps a stale
    page), and leaves the page table, the clock, the status and the
    counters as the JAX store's after the same history."""
    j, t = stores(capacity=16, page_rows=4, budget=2)
    for s in (j, t):
        slots = s.alloc(16)
        s.write(slots, {"x": slots.astype(np.float32)})
    assert t.resident_pages_now == 2
    new = np.arange(t.capacity, dtype=np.float32) * -3
    with Counted() as c:
        getattr(j, how)("x", new)
        getattr(t, how)("x", new)
    assert c.jax == c.port == [0.0, 0.0]
    np.testing.assert_array_equal(t.read("x", np.arange(16)), new[:16])
    pool_equals_master(t)
    same_residency(j, t)


def test_device_is_undefined_under_spill():
    _, t = stores()
    with pytest.raises(AssertionError, match="ops/paged.py"):
        t.device("x")
    assert t.get_status()["resident_budget_pages"] == "2"


# ---------------------------------------------------------------------------
# layout parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["lsh", "minhash", "euclid_lsh"])
def test_nn_spilled_reads_equal_jax_and_the_resident_twin(method):
    data = vecs(150, seed=1)
    j, t = pair("nearest_neighbor", nn_cfg(method, pages=SPILL))
    _, twin = pair("nearest_neighbor", nn_cfg(method))
    twin_j = jcreate("nearest_neighbor", nn_cfg(method))
    with Counted() as c:
        for i, v in enumerate(data[:20]):
            j.set_row(f"r{i}", datum(JDatum, v))
            t.set_row(f"r{i}", datum(TDatum, v))
        set_rows(j, JDatum, data[20:], "r20_")
        set_rows(t, TDatum, data[20:], "r20_")
        for d in (twin, twin_j):
            cls = TDatum if d is twin else JDatum
            for i, v in enumerate(data[:20]):
                d.set_row(f"r{i}", datum(cls, v))
            set_rows(d, cls, data[20:], "r20_")
        for q in vecs(3, seed=9):
            for m in ("similar_row_from_datum", "neighbor_row_from_datum"):
                a = getattr(j, m)(datum(JDatum, q), 10)
                b = getattr(t, m)(datum(TDatum, q), 10)
                assert a == b
                assert tie_eq(getattr(twin, m)(datum(TDatum, q), 10), b)
        for rid in ("r0", "r20_57", "r20_129"):
            assert j.similar_row_from_id(rid, 10) == \
                t.similar_row_from_id(rid, 10)
        qs = [datum(TDatum, q) for q in vecs(3, seed=10)]
        jq = [datum(JDatum, q) for q in vecs(3, seed=10)]
        assert j.similar_row_from_datum_many([(q, 6) for q in jq]) == \
            t.similar_row_from_datum_many([(q, 6) for q in qs])
    assert c.jax == c.port
    assert packed(t) == packed(j) == packed(twin) == packed(twin_j)


def test_nn_save_load_roundtrip_across_layouts():
    data = vecs(60, seed=2)
    src = tcreate("nearest_neighbor", nn_cfg(pages={"page_rows": 8}),
                  device="cpu")
    for i, v in enumerate(data):
        src.set_row(f"r{i}", datum(TDatum, v))
    blob = src.pack()
    spilled = {"page_rows": 32, "resident_pages": 2}
    j, t = pair("nearest_neighbor", nn_cfg(pages=spilled))
    j.unpack(msgpack.unpackb(msgpack.packb(blob, use_bin_type=True),
                             raw=False))
    t.unpack(blob)
    q = vecs(1, seed=5)[0]
    assert tie_eq(src.similar_row_from_datum(datum(TDatum, q), 8),
                  t.similar_row_from_datum(datum(TDatum, q), 8))
    assert j.similar_row_from_datum(datum(JDatum, q), 8) == \
        t.similar_row_from_datum(datum(TDatum, q), 8)
    assert packed(t) == packed(j) == msgpack.packb(blob, use_bin_type=True)
    assert t.get_status()["resident_budget_pages"] == "2"


def set_rows(drv, cls, data, prefix="r", batch=64):
    """set_row_many in batches (one signature launch a batch; both
    packages sign a batch as the JAX driver pads it)."""
    for b0 in range(0, len(data), batch):
        drv.set_row_many([(f"{prefix}{b0 + i}", datum(cls, v))
                          for i, v in enumerate(data[b0: b0 + batch])])


def assert_near_twin(exact: bool, twin, got):
    """The resident twin's answer against the spilled one: tie-aware
    (signatures), or for the exact methods, whose spilled score is the JAX
    driver's host arithmetic on the dots (not the fused sweep's), within
    rtol 1e-6 with the same top 5, as tests/test_paged.py holds them."""
    if not exact:
        assert tie_eq(twin, got)
        return
    np.testing.assert_allclose([s for _, s in twin], [s for _, s in got],
                               rtol=1e-6)
    assert {i for i, _ in twin[:5]} == {i for i, _ in got[:5]}


def reco_history(drv, cls, data, drops):
    for i, v in enumerate(data):
        drv.update_row(f"r{i}", datum(cls, v))
    for i in drops:
        drv.clear_row(f"r{i}")
    for i, v in enumerate(data[:5]):        # refill the holes
        drv.update_row(f"n{i}", datum(cls, v[::-1]))


@pytest.mark.parametrize("method,max_size", [("inverted_index", 0),
                                             ("inverted_index_euclid", 0),
                                             ("lsh", 0), ("lsh", 90)])
def test_recommender_spilled_reads_equal_jax(method, max_size):
    """Holes from clear_row (and the LRU unlearner at max_size 90)."""
    data = vecs(120, seed=3)
    drops = range(30, 60)
    j, t = pair("recommender", reco_cfg(method, SPILL, max_size))
    twin = tcreate("recommender", reco_cfg(method, None, max_size),
                   device="cpu")
    with Counted() as c:
        reco_history(j, JDatum, data, drops)
        reco_history(t, TDatum, data, drops)
        reco_history(twin, TDatum, data, drops)
        assert t.pages.has_holes
        for q in vecs(3, seed=11):
            a = j.similar_row_from_datum(datum(JDatum, q), 10)
            b = t.similar_row_from_datum(datum(TDatum, q), 10)
            assert a == b
            assert_near_twin(method != "lsh", twin.similar_row_from_datum(
                datum(TDatum, q), 10), b)
        for rid in ("r2", "r100", "n3"):
            assert j.similar_row_from_id(rid, 8) == \
                t.similar_row_from_id(rid, 8)
        qs = vecs(3, seed=12)
        assert j.similar_row_from_datum_many(
            [(datum(JDatum, q), 5) for q in qs]) == \
            t.similar_row_from_datum_many([(datum(TDatum, q), 5) for q in qs])
    assert c.jax == c.port
    assert packed(t) == packed(j) == packed(twin)
    assert t.get_status()["pages_resident"] == \
        j.get_status()["pages_resident"] == "3"


def test_recommender_spill_widens_kr_as_jax():
    """Rows of 40 and then 70 features widen Kr 32 -> 64 -> 128 on the
    master and the pool (widen_column's spill branch); the reads stay
    equal to the JAX spilled driver's."""
    j, t = pair("recommender", reco_cfg("inverted_index", SPILL))
    rng = np.random.default_rng(33)
    for i in range(90):
        nnz = 6 if i < 40 else (40 if i < 70 else 70)
        v = rng.standard_normal(nnz)
        j.update_row(f"r{i}", datum(JDatum, v))
        t.update_row(f"r{i}", datum(TDatum, v))
        if i in (39, 69, 89):
            q = rng.standard_normal(nnz)
            assert j.similar_row_from_datum(datum(JDatum, q), 8) == \
                t.similar_row_from_datum(datum(TDatum, q), 8)
    assert t.kr == j.kr == 128
    assert packed(t) == packed(j)


@pytest.mark.parametrize("nn_method,max_size", [
    ("inverted_index_euclid", 0), ("euclid_lsh", 0), ("euclid_lsh", 30)])
def test_anomaly_spilled_scores_equal_jax(nn_method, max_size):
    """lof over the exact and the euclid_lsh sweep: every add's score and
    calc_score equal to the JAX spilled driver's (==) and to the resident
    twin's within rtol 1e-9; holes from clear_row and the LRU unlearner."""
    data = vecs(40, seed=4)
    j, t = pair("anomaly", anomaly_cfg(nn_method, SPILL, max_size))
    twin = tcreate("anomaly", anomaly_cfg(nn_method, None, max_size),
                   device="cpu")
    with Counted() as c:
        for i, v in enumerate(data):
            a = j.add(f"r{i}", datum(JDatum, v))
            b = t.add(f"r{i}", datum(TDatum, v))
            assert a == b
            np.testing.assert_allclose(
                twin.add(f"r{i}", datum(TDatum, v)), b, rtol=1e-9)
        for i in range(10, 15):
            assert j.clear_row(f"r{i}") == t.clear_row(f"r{i}")
            twin.clear_row(f"r{i}")
        for q in vecs(3, seed=13):
            b = t.calc_score(datum(TDatum, q))
            assert j.calc_score(datum(JDatum, q)) == b
            np.testing.assert_allclose(twin.calc_score(datum(TDatum, q)),
                                       b, rtol=1e-9)
        qs = vecs(3, seed=14)
        assert j.calc_score_many([datum(JDatum, q) for q in qs]) == \
            t.calc_score_many([datum(TDatum, q) for q in qs])
    assert c.jax == c.port
    assert packed(t) == packed(j) == packed(twin)


# ---------------------------------------------------------------------------
# enforced spill
# ---------------------------------------------------------------------------

def test_nn_serves_4x_resident_budget_exactly():
    budget, page_rows = 4, 32
    data = vecs(512, seed=7)
    spill = {"page_rows": page_rows, "resident_pages": budget}
    j, t = pair("nearest_neighbor", nn_cfg(pages=spill))
    full = tcreate("nearest_neighbor", nn_cfg(), device="cpu")
    in0 = tcounter("page_spill_in_total")
    set_rows(j, JDatum, data)
    set_rows(t, TDatum, data)
    set_rows(full, TDatum, data)
    assert t.pages.resident_pages_now == budget
    assert tcounter("page_spill_out_total") > 0
    for q in vecs(4, seed=17):
        b = t.similar_row_from_datum(datum(TDatum, q), 10)
        assert j.similar_row_from_datum(datum(JDatum, q), 10) == b
        assert tie_eq(full.similar_row_from_datum(datum(TDatum, q), 10), b)
        assert tie_eq(full.neighbor_row_from_datum(datum(TDatum, q), 10),
                      t.neighbor_row_from_datum(datum(TDatum, q), 10))
    assert tcounter("page_spill_in_total") > in0
    st = t.get_status()
    assert int(st["pages"]) >= 4 * budget
    assert st["resident_budget_pages"] == str(budget)
    assert st["pages_resident"] == str(budget)
    # the card would hold the pool only: budget pages of the two columns
    assert t.pages.device_bytes() < full.pages.device_bytes()


def test_recommender_exact_method_spill():
    data = vecs(256, seed=8)
    spill = {"page_rows": 32, "resident_pages": 2}
    j, t = pair("recommender", reco_cfg("inverted_index", spill))
    for i, v in enumerate(data):
        j.update_row(f"r{i}", datum(JDatum, v))
        t.update_row(f"r{i}", datum(TDatum, v))
    for q in vecs(4, seed=18):
        assert j.similar_row_from_datum(datum(JDatum, q), 8) == \
            t.similar_row_from_datum(datum(TDatum, q), 8)


@pytest.mark.parametrize("engine", ["nearest_neighbor", "recommender"])
def test_spill_bypasses_the_index_cleanly(engine):
    cfg = (nn_cfg(pages={"page_rows": 16, "resident_pages": 2},
                  index={"min_rows": 0}) if engine == "nearest_neighbor"
           else dict(reco_cfg("lsh", {"page_rows": 16,
                                      "resident_pages": 2}),
                     index={"min_rows": 0}))
    j, t = pair(engine, cfg)
    assert t.configure_index("lsh_probe", probes=4)
    assert j.configure_index("lsh_probe", probes=4)
    data = vecs(128, seed=25)
    if engine == "nearest_neighbor":
        set_rows(j, JDatum, data)
        set_rows(t, TDatum, data)
    else:
        for i, v in enumerate(data):
            j.update_row(f"r{i}", datum(JDatum, v))
            t.update_row(f"r{i}", datum(TDatum, v))
    assert t._index_for_query() is None
    q = vecs(1, seed=26)[0]
    b = t.similar_row_from_datum(datum(TDatum, q), 10)
    assert len(b) == 10
    assert j.similar_row_from_datum(datum(JDatum, q), 10) == b


# ---------------------------------------------------------------------------
# over the wire
# ---------------------------------------------------------------------------

def test_a_spilled_server_answers_as_a_jax_driver(tmp_path):
    cfg = nn_cfg("euclid_lsh", pages={"page_rows": 16, "resident_pages": 2})
    srv, rpc, port = _spawn_port(cfg, tmp_path, "nearest_neighbor")
    conn = GoldenConn(port)
    j = jcreate("nearest_neighbor", cfg)
    try:
        data = vecs(100, seed=30)
        for i, v in enumerate(data):
            nums = [(f"f{k}", float(x)) for k, x in enumerate(v)]
            assert conn.call("set_row", f"w{i}", datum_wire(nums=nums))
            j.set_row(f"w{i}", datum(JDatum, v))
        for q in vecs(3, seed=31):
            nums = [(f"f{k}", float(x)) for k, x in enumerate(q)]
            for m in ("similar_row_from_datum", "neighbor_row_from_datum"):
                got = conn.call(m, datum_wire(nums=nums), 7)
                want = getattr(j, m)(datum(JDatum, q), 7)
                assert [tuple(x) for x in got] == [tuple(x) for x in want]
        got = conn.call("similar_row_from_id", "w5", 7)
        assert [tuple(x) for x in got] == \
            [tuple(x) for x in j.similar_row_from_id("w5", 7)]
        st = next(iter(conn.call("get_status").values()))
        want = j.get_status()
        for k in ("page_rows", "pages", "paged_rows", "pages_resident",
                  "resident_budget_pages"):
            assert st[k] == want[k], k
        for k in ("page_spill_in_total", "page_spill_out_total",
                  "paged_pages_resident"):
            assert float(st[k]) > 0, k
        assert st["resident_budget_pages"] == "2"
    finally:
        conn.close()
        rpc.stop()
        srv.stop()


def spilled_server(pkg, dirpath, cfg):
    base = tdur.SERVER_BASES[pkg]
    kw = {"device": "cpu"} if pkg == "port" else {}
    args = base.ServerArgs(type="nearest_neighbor", name="t",
                           journal_dir=str(dirpath), journal_fsync="always",
                           snapshot_interval_sec=0.0, **kw)
    srv = base.JubatusServer(args, config=json.dumps(cfg))
    srv.init_durability()
    return srv


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_journal_replay_restores_a_spilled_table(tmp_path, writer):
    """set_row records journaled by a spilled server of either package
    replay into a spilled port server through recovery: the table packs
    bitwise as at the crash, and its reads equal the writer's."""
    cfg = nn_cfg(pages={"page_rows": 16, "resident_pages": 2})
    srv = spilled_server(writer, tmp_path / "dur", cfg)
    table = tdur.SERVICE_TABLES[writer]["nearest_neighbor"]
    for i, v in enumerate(vecs(80, seed=40)):
        args = [f"j{i % 70}", datum_wire(
            nums=[(f"f{k}", float(x)) for k, x in enumerate(v)])]
        with srv.model_lock.write():
            table.methods["set_row"].fn(srv, *args)
            srv.event_model_updated()
            srv.journal.append({"k": "u", "m": "set_row", "a": args},
                               srv.current_mix_round())
        srv.journal.commit()
    at_crash = packed(srv.driver)
    q = vecs(1, seed=41)[0]
    cls = JDatum if writer == "jax" else TDatum
    want = srv.driver.similar_row_from_datum(datum(cls, q), 9)
    srv.journal.close()
    os.remove(tmp_path / "dur" / "LOCK")
    shutil.copytree(tmp_path / "dur", tmp_path / "other")
    other = spilled_server("port", tmp_path / "other", cfg)
    try:
        assert other.recovery_info.errors == 0
        assert packed(other.driver) == at_crash
        assert other.driver.pages.spill_mode
        got = other.driver.similar_row_from_datum(datum(TDatum, q), 9)
        assert [tuple(x) for x in got] == [tuple(x) for x in want]
    finally:
        tdur.shut("port", other)
        if writer == "port":
            srv.stop()
