"""The port's key-sharded recommender and anomaly (jubatus_tpu_torch/
parallel/sharded_rows.py, models/pages.py's external allocator and remap)
against the JAX package's ShardedRecommenderDriver / ShardedAnomalyDriver
on the suite's virtual 8-device CPU mesh, counterpart of
tests/test_sharded_rows.py.

Both drivers are fed the same seeded history.  The placement (every id's
row, shard_cap, the free lists), the LOF tables (kNN rows remapped by the
regrow included) and the packs are equal.  Tolerances: the recommender's
reads are equal (==) for every method; anomaly's scores are held to
rtol 1e-6 of the JAX driver's per-request calc_score (never to its
calc_score_many, whose batched float order differs from its own
calc_score, ROADMAP Queue 3 item 3), and equal (==) wherever the LOF
tables hold the same distances: after adds; an update's batched refresh
on the JAX sharded driver lands some euclid_lsh distances an ulp away
(ROADMAP Queue 3 item 18), so there the float tables are held to
rtol 1e-6 and the kNN rows to ==.  The port's *_many reads are bitwise
its per-request reads.
"""

import numpy as np
import pytest

from jubatus_tpu.fv import Datum as JDatum
from jubatus_tpu.models import create_driver as jcreate
from jubatus_tpu.parallel import make_mesh as jmesh
from jubatus_tpu.parallel.sharded_rows import ShardedAnomalyDriver as JAnom
from jubatus_tpu.parallel.sharded_rows import ShardedRecommenderDriver \
    as JReco
from jubatus_tpu_torch.fv import Datum as TDatum
from jubatus_tpu_torch.models import create_driver as tcreate
from jubatus_tpu_torch.parallel.mesh import make_mesh
from jubatus_tpu_torch.parallel.sharded import key_shard
from jubatus_tpu_torch.parallel.sharded_rows import (SPILL_REFUSAL,
                                                     ShardedAnomalyDriver,
                                                     ShardedRecommenderDriver)

CONV = {"num_rules": [{"key": "*", "type": "num"}], "hash_max_size": 512}
RECO_METHODS = ("lsh", "minhash", "euclid_lsh", "inverted_index",
                "inverted_index_euclid")
ANOM_RTOL = 1e-6


def reco_cfg(method="lsh", hash_num=64, unlearner=False):
    c = {"method": method, "parameter": {"hash_num": hash_num},
         "converter": CONV}
    if method in ("inverted_index", "inverted_index_euclid"):
        c["parameter"] = {}
    if unlearner:
        c["parameter"]["unlearner"] = "lru"
        c["parameter"]["unlearner_parameter"] = {"max_size": 8}
    return c


def anomaly_cfg(nn_method="euclid_lsh", method="lof"):
    p = {"nearest_neighbor_num": 4, "reverse_nearest_neighbor_num": 8,
         "method": nn_method}
    if nn_method in ("lsh", "minhash", "euclid_lsh"):
        p["parameter"] = {"hash_num": 64}
    return {"method": method, "parameter": p, "converter": CONV}


def vec(v):
    return [(f"k{k}", float(x)) for k, x in enumerate(v)]


def data(n, seed=0, dim=5):
    rng = np.random.default_rng(seed)
    return [vec(rng.standard_normal(dim) * np.exp(0.5 * rng.standard_normal()))
            for _ in range(n)]


def reco_pair(method="lsh", nshard=4, **kw):
    return (JReco(reco_cfg(method, **kw), jmesh(dp=1, shard=nshard)),
            ShardedRecommenderDriver(reco_cfg(method, **kw),
                                     make_mesh(shard=nshard, device="cpu")))


def anom_pair(nn_method="euclid_lsh", nshard=4, method="lof"):
    c = anomaly_cfg(nn_method, method)
    return (JAnom(c, jmesh(dp=1, shard=nshard)),
            ShardedAnomalyDriver(c, make_mesh(shard=nshard, device="cpu")))


def update(j, t, rows, prefix="r"):
    for i, d in enumerate(rows):
        assert j.update_row(f"{prefix}{i}", JDatum([], d)) == \
            t.update_row(f"{prefix}{i}", TDatum([], d))


def reco_reads(drv, cls, queries, ids, sizes=(3, 50)):
    out = []
    for size in sizes:
        for q in queries:
            out.append(drv.similar_row_from_datum(cls([], q), size))
        for i in ids:
            out.append(drv.similar_row_from_id(i, size))
    return out


def same_layout(j, t):
    assert t.ids == j.ids
    assert t.shard_cap == j.shard_cap
    assert t._shard_next == j._shard_next
    assert t._shard_free == j._shard_free
    assert t.pages.capacity == j.pages.capacity
    assert np.array_equal(t.pages.mask_host(), j.pages.mask_host())


# -- the recommender ----------------------------------------------------------

@pytest.mark.parametrize("method", RECO_METHODS)
def test_recommender_reads_equal_jax(method):
    j, t = reco_pair(method)
    rows = data(40, seed=1)
    update(j, t, rows)
    same_layout(j, t)
    queries = rows[:2] + data(3, seed=2)
    assert reco_reads(t, TDatum, queries, ["r3", "r17"]) == \
        reco_reads(j, JDatum, queries, ["r3", "r17"])


@pytest.mark.parametrize("nshard", [2, 3])
def test_recommender_placement_equals_jax(nshard):
    j, t = reco_pair("minhash", nshard)
    update(j, t, data(30, seed=nshard))
    same_layout(j, t)
    for i, row in t.ids.items():
        assert row // t.shard_cap == key_shard(i, nshard)
        assert t.row_ids[row] == i


@pytest.mark.parametrize("method", ["lsh", "inverted_index"])
def test_regrow_equals_jax(method):
    j, t = reco_pair(method)
    cap0 = t.shard_cap
    n = cap0 * 4 * 2 + 5          # at least one regrow
    rows = data(n, seed=5)
    update(j, t, rows[:20])
    # reads between the writes sync, so the regrow moves synced rows too
    assert t.similar_row_from_datum(TDatum([], rows[0]), 4) == \
        j.similar_row_from_datum(JDatum([], rows[0]), 4)
    for i, d in enumerate(rows[20:], start=20):
        j.update_row(f"r{i}", JDatum([], d))
        t.update_row(f"r{i}", TDatum([], d))
    assert t.shard_cap > cap0
    same_layout(j, t)
    for i in range(n):
        row = t.ids[f"r{i}"]
        assert row // t.shard_cap == key_shard(f"r{i}", 4)
    assert reco_reads(t, TDatum, rows[:3], ["r1", f"r{n - 1}"]) == \
        reco_reads(j, JDatum, rows[:3], ["r1", f"r{n - 1}"])


def test_regrow_rebuilds_the_index():
    j, t = reco_pair("lsh")
    for d in (j, t):
        assert d.configure_index("lsh_probe", probes=4, min_rows=0)
    rows = data(150, seed=7)
    update(j, t, rows[:30])
    q = rows[3]
    assert t.similar_row_from_datum(TDatum([], q), 5) == \
        j.similar_row_from_datum(JDatum([], q), 5)
    assert t.index.take_stats() == j.index.take_stats()
    update(j, t, rows[30:], prefix="m")     # regrows: every slot moves
    assert t.index.needs_rebuild and j.index.needs_rebuild
    for size in (5, 20):
        assert t.similar_row_from_datum(TDatum([], q), size) == \
            j.similar_row_from_datum(JDatum([], q), size)
        assert t.index.take_stats() == j.index.take_stats()
    assert not t.index.needs_rebuild


def test_clear_row_and_slot_reuse_equal_jax():
    j, t = reco_pair("lsh")
    update(j, t, data(12, seed=9))
    assert t.clear_row("r3") is True and j.clear_row("r3") is True
    assert t.clear_row("r3") is False
    assert "r3" not in t.get_all_rows()
    same_layout(j, t)
    # the same id comes back to its shard, into the freed slot
    t.update_row("r3", TDatum([], data(1, seed=99)[0]))
    j.update_row("r3", JDatum([], data(1, seed=99)[0]))
    assert t.ids["r3"] // t.shard_cap == key_shard("r3", 4)
    same_layout(j, t)
    q = data(2, seed=10)
    assert reco_reads(t, TDatum, q, ["r3"]) == reco_reads(j, JDatum, q,
                                                          ["r3"])


def test_lru_unlearner_equals_jax():
    j, t = reco_pair("lsh", unlearner=True)
    update(j, t, data(20, seed=11))
    assert len(t.ids) == 8 and "r19" in t.ids and "r0" not in t.ids
    same_layout(j, t)
    assert t._lru == j._lru
    q = data(2, seed=12)
    assert reco_reads(t, TDatum, q, ["r19"]) == reco_reads(j, JDatum, q,
                                                           ["r19"])


def test_recommender_many_bitwise_per_request():
    _, t = reco_pair("lsh")
    for i, d in enumerate(data(24, seed=13)):
        t.update_row(f"r{i}", TDatum([], d))
    pairs = [(TDatum([], d), 3 + 2 * (k % 2))
             for k, d in enumerate(data(6, seed=14))]
    assert t.similar_row_from_datum_many(pairs) == \
        [t.similar_row_from_datum(d, k) for d, k in pairs]


def test_recommender_pack_equals_jax_and_crosses_layouts():
    j, t = reco_pair("euclid_lsh")
    rows = data(20, seed=15)
    update(j, t, rows)
    t.clear_row("r4")
    j.clear_row("r4")
    tp, jp = t.pack(), j.pack()
    assert tp == jp
    plain = tcreate("recommender", reco_cfg("euclid_lsh"), device="cpu")
    plain.unpack(tp)
    t2 = ShardedRecommenderDriver(reco_cfg("euclid_lsh"),
                                  make_mesh(shard=2, device="cpu"))
    t2.unpack(tp)
    j2 = JReco(reco_cfg("euclid_lsh"), jmesh(dp=1, shard=2))
    j2.unpack(jp)
    same_layout(j2, t2)
    for q in rows[:3]:
        a = t.similar_row_from_datum(TDatum([], q), 19)
        b = plain.similar_row_from_datum(TDatum([], q), 19)
        assert [s for _, s in a] == [s for _, s in b]
        assert sorted(a) == sorted(b)
        assert t2.similar_row_from_datum(TDatum([], q), 19) == \
            j2.similar_row_from_datum(JDatum([], q), 19)


def test_recommender_mix_with_an_unsharded_port_peer():
    _, t = reco_pair("inverted_index")
    peer = tcreate("recommender", reco_cfg("inverted_index"), device="cpu")
    rows = data(12, seed=17)
    for i in range(6):
        t.update_row(f"s{i}", TDatum([], rows[i]))
        peer.update_row(f"p{i}", TDatum([], rows[i + 6]))
    t.clear_row("s0")
    merged = ShardedRecommenderDriver.mix(t.get_diff(), peer.get_diff())
    assert t.put_diff(merged) and peer.put_diff(merged)
    assert sorted(t.get_all_rows()) == sorted(peer.get_all_rows())
    assert "s0" not in t.get_all_rows()
    q = TDatum([], rows[7])
    a, b = t.similar_row_from_datum(q, 11), peer.similar_row_from_datum(q, 11)
    assert [s for _, s in a] == [s for _, s in b]
    assert sorted(a) == sorted(b)


def test_recommender_partition_surface_equals_jax():
    j, t = reco_pair("lsh")
    update(j, t, data(16, seed=19))
    payload = t.partition_pack_rows(["r1", "r2"])
    assert payload == j.partition_pack_rows(["r1", "r2"])
    assert t.partition_drop_rows(["r1", "r2", "zz"]) == \
        j.partition_drop_rows(["r1", "r2", "zz"]) == 2
    same_layout(j, t)
    assert t.partition_apply_rows(payload) == \
        j.partition_apply_rows(payload) == 2
    same_layout(j, t)
    q = data(2, seed=20)
    assert reco_reads(t, TDatum, q, ["r1"]) == reco_reads(j, JDatum, q,
                                                          ["r1"])


def test_status_and_the_spill_refusal():
    j, t = reco_pair("lsh")
    update(j, t, data(5, seed=21))
    st, jst = t.get_status(), j.get_status()
    for key in ("shard_devices", "shard_capacity", "num_rows", "method"):
        assert st[key] == jst[key], key
    assert st["shard_devices"] == "4"
    c = dict(reco_cfg("lsh"), pages={"resident_pages": 2})
    with pytest.raises(ValueError, match="keeps every page resident"):
        ShardedRecommenderDriver(c, make_mesh(shard=2, device="cpu"))
    assert "spilled store" in SPILL_REFUSAL
    t.clear()
    assert t.get_all_rows() == [] and t.shard_cap == j.shard_cap


# -- anomaly ------------------------------------------------------------------

def lof_tables_equal(j, t, exact=True):
    """The LOF tables equal (==), or with exact=False the kNN rows equal
    and the float tables within ANOM_RTOL: the JAX sharded driver's
    batched refresh sweep (a moved row's dependants, _refresh_rows) gives
    some euclid_lsh distances one float32 ulp away from the unsharded
    program's, which the port computes (ROADMAP Queue 3 item 18)."""
    assert np.array_equal(t.knn_rows, np.asarray(j.knn_rows))
    for name in ("kdist", "lrd", "knn_dists"):
        a, b = getattr(t, name), np.asarray(getattr(j, name))
        if exact:
            assert np.array_equal(a, b), name
        else:
            np.testing.assert_allclose(a, b, rtol=ANOM_RTOL, err_msg=name)


@pytest.mark.parametrize("nn_method", ["euclid_lsh", "lsh",
                                       "inverted_index_euclid"])
def test_anomaly_scores_equal_jax(nn_method):
    j, t = anom_pair(nn_method)
    rows = data(24, seed=23)
    for i, d in enumerate(rows):
        a = j.add(f"p{i}", JDatum([], d))
        b = t.add(f"p{i}", TDatum([], d))
        np.testing.assert_allclose(b, a, rtol=ANOM_RTOL)
    same_layout(j, t)
    lof_tables_equal(j, t)
    probe = vec([9.0, 9.0, 9.0, 9.0, 9.0])
    for q in [probe] + rows[:3] + data(3, seed=24):
        np.testing.assert_allclose(t.calc_score(TDatum([], q)),
                                   j.calc_score(JDatum([], q)),
                                   rtol=ANOM_RTOL)
    assert t.calc_score(TDatum([], probe)) > t.calc_score(
        TDatum([], rows[0]))


def test_anomaly_regrow_remaps_the_knn_rows():
    j, t = anom_pair("euclid_lsh")
    cap0 = t.shard_cap
    n = cap0 * 4 * 2 + 3
    rows = data(n, seed=25)
    for i, d in enumerate(rows):
        a = j.add(f"p{i}", JDatum([], d))
        b = t.add(f"p{i}", TDatum([], d))
        np.testing.assert_allclose(b, a, rtol=ANOM_RTOL)
    assert t.shard_cap > cap0
    same_layout(j, t)
    lof_tables_equal(j, t)
    live = t.pages.mask_host()
    nn = t.knn_rows[live]
    assert ((nn == -1) | live[np.clip(nn, 0, None)]).all()
    assert np.isfinite(t.calc_score(TDatum([], rows[1])))


def test_anomaly_update_overwrite_clear_row_equal_jax():
    j, t = anom_pair("euclid_lsh", method="light_lof")
    rows = data(12, seed=27)
    for i, d in enumerate(rows):
        j.add(f"a{i}", JDatum([], d))
        t.add(f"a{i}", TDatum([], d))
    for op, i, d in (("update", 1, rows[5]), ("overwrite", 2, rows[7]),
                     ("update", 3, data(1, seed=28)[0])):
        np.testing.assert_allclose(
            getattr(t, op)(f"a{i}", TDatum([], d)),
            getattr(j, op)(f"a{i}", JDatum([], d)), rtol=ANOM_RTOL)
    assert t.clear_row("a1") is True and j.clear_row("a1") is True
    assert "a1" not in t.get_all_rows()
    same_layout(j, t)
    lof_tables_equal(j, t, exact=False)
    np.testing.assert_allclose(t.add("a1", TDatum([], rows[0])),
                               j.add("a1", JDatum([], rows[0])),
                               rtol=ANOM_RTOL)
    same_layout(j, t)


def test_anomaly_many_bitwise_per_request():
    """The port's calc_score_many is bitwise its own calc_score (the JAX
    driver's is not: Queue 3 item 3)."""
    _, t = anom_pair("euclid_lsh")
    for i, d in enumerate(data(20, seed=29)):
        t.add(f"p{i}", TDatum([], d))
    qs = [TDatum([], d) for d in data(6, seed=30)]
    assert t.calc_score_many(qs) == [t.calc_score(d) for d in qs]


def test_anomaly_pack_equals_jax_and_crosses_layouts():
    j, t = anom_pair("lsh")
    rows = data(16, seed=31)
    for i, d in enumerate(rows):
        j.add(f"p{i}", JDatum([], d))
        t.add(f"p{i}", TDatum([], d))
    tp, jp = t.pack(), j.pack()
    assert tp == jp
    plain = tcreate("anomaly", anomaly_cfg("lsh"), device="cpu")
    plain.unpack(tp)
    jplain = jcreate("anomaly", anomaly_cfg("lsh"))
    jplain.unpack(jp)
    for q in data(4, seed=32):
        assert plain.calc_score(TDatum([], q)) == \
            jplain.calc_score(JDatum([], q))
        np.testing.assert_allclose(t.calc_score(TDatum([], q)),
                                   plain.calc_score(TDatum([], q)),
                                   rtol=ANOM_RTOL)
