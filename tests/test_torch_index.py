"""The port's sublinear query index in its drivers (jubatus_tpu_torch/
index/, models/nearest_neighbor.py, recommender.py, anomaly.py and the
server's --index) against the JAX package's, on the CPU: both drivers
fed the same writes answer every read route alike, bitwise in ids and
scores (==, no tolerance), with the index engaged.  The groups mirror
tests/test_index.py's classes: recall goldens (the port's pruned answers
beside its own full sweep, tie-aware, and equal to the JAX driver's),
parity where the index declines or is below min_rows, maintenance (the
delta, unpack's lazy rebuild, clear_row, the ivf retrain on 2x growth,
the fall back of an under-filled read) and observability (counters and
status).  Anomaly's indexed reads and the server are in
tests/test_torch_index_serving.py.  The partitioned class holds the
merge of indexed partitions (the partition plane's *_partial legs)
against one indexed driver and against the JAX package's legs, and an
indexed table after a handoff's drop; the sharded layout's slabs are
tests/test_torch_sharded.py's.
"""

import msgpack
import numpy as np
import pytest

from jubatus_tpu.fv import Datum as JDatum
from jubatus_tpu.models import create_driver as jcreate
from jubatus_tpu_torch.fv import Datum as TDatum
from jubatus_tpu_torch.index import tie_aware_recall
from jubatus_tpu_torch.models import create_driver as tcreate
from jubatus_tpu_torch.utils.metrics import GLOBAL
from tests import test_torch_durability as tdur

CONV = {"num_rules": [{"key": "*", "type": "num"}], "hash_max_size": 512}
K = 10
FLOOR = 0.95


def _cfg(method, hash_num=64, **index):
    if method == "nearest_neighbor_recommender":
        cfg = {"method": method,
               "parameter": {"method": "euclid_lsh",
                             "parameter": {"hash_num": hash_num}},
               "converter": CONV}
    else:
        cfg = {"method": method, "parameter": {"hash_num": hash_num},
               "converter": CONV}
    if index:
        cfg["index"] = index
    return cfg


def _vec(v):
    return [(f"k{k}", float(x)) for k, x in enumerate(v)]


def _clustered(rng, n_centers=20, dim=8, n=400, jitter=0.02):
    centers = rng.standard_normal((n_centers, dim))
    return centers, [_vec(centers[i % n_centers]
                          + jitter * rng.standard_normal(dim))
                     for i in range(n)]


def _pair(service, cfg, kind=None, probes=4, **kw):
    """(JAX driver, port driver on the CPU), each with the index when
    `kind` is given."""
    j = jcreate(service, cfg)
    t = tcreate(service, cfg, device="cpu")
    if kind is not None:
        assert j.configure_index(kind, probes=probes, **kw)
        assert t.configure_index(kind, probes=probes, **kw)
    return j, t


def _counter(name):
    return float(GLOBAL.snapshot().get(name, "0"))


def _full(drv, read):
    """read() answered by the full sweep: the index set aside."""
    saved, drv.index = drv.index, None
    try:
        return read()
    finally:
        drv.index = saved


def _queries(rng, centers, n=16, jitter=0.02):
    return [_vec(centers[rng.integers(0, len(centers))]
                 + jitter * rng.standard_normal(centers.shape[1]))
            for _ in range(n)]


# ---------------------------------------------------------------------------
# recall goldens: the port's pruned answers are the JAX driver's, and keep
# the tie-aware recall floor against the port's own full sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,kind", [
    ("lsh", "lsh_probe"), ("minhash", "lsh_probe"),
    ("euclid_lsh", "lsh_probe"), ("inverted_index", "ivf"),
    ("inverted_index_euclid", "ivf"),
    ("nearest_neighbor_recommender", "lsh_probe")])
def test_recommender_routes_equal_jax_and_keep_recall(method, kind):
    rng = np.random.default_rng(11)
    j, t = _pair("recommender", _cfg(method), kind, min_rows=0)
    centers, data = _clustered(rng)
    for i, d in enumerate(data):
        j.update_row(f"r{i}", JDatum([], d))
        t.update_row(f"r{i}", TDatum([], d))
    qs = _queries(rng, centers)
    recalls = []
    for q in qs:
        a = j.similar_row_from_datum(JDatum([], q), K)
        b = t.similar_row_from_datum(TDatum([], q), K)
        assert a == b
        recalls.append(tie_aware_recall(_full(
            t, lambda: t.similar_row_from_datum(TDatum([], q), K)), b, K))
    assert np.mean(recalls) >= FLOOR
    for rid in ("r0", "r77", "r399"):
        assert j.similar_row_from_id(rid, K) == t.similar_row_from_id(rid, K)
    pairs = [(q, s) for q, s in zip(qs[:5], (3, 10, 1, 7, 10))]
    assert j.similar_row_from_datum_many([(JDatum([], q), s)
                                          for q, s in pairs]) == \
        t.similar_row_from_datum_many([(TDatum([], q), s) for q, s in pairs])
    assert j.get_status()["index_bucket_cap"] == \
        t.get_status()["index_bucket_cap"]


@pytest.mark.parametrize("method", ["lsh", "minhash", "euclid_lsh"])
def test_nearest_neighbor_routes_equal_jax_and_keep_recall(method):
    rng = np.random.default_rng(13)
    j, t = _pair("nearest_neighbor", _cfg(method), "lsh_probe", min_rows=0)
    centers, data = _clustered(rng)
    for i, d in enumerate(data[:40]):
        j.set_row(f"r{i}", JDatum([], d))
        t.set_row(f"r{i}", TDatum([], d))
    rest = [(f"r{i}", d) for i, d in enumerate(data[40:], 40)]
    j.set_row_many([(i, JDatum([], d)) for i, d in rest])
    t.set_row_many([(i, TDatum([], d)) for i, d in rest])
    qs = _queries(rng, centers, n=12)
    recalls = []
    for q in qs:
        b = t.similar_row_from_datum(TDatum([], q), K)
        assert j.similar_row_from_datum(JDatum([], q), K) == b
        assert j.neighbor_row_from_datum(JDatum([], q), 4) == \
            t.neighbor_row_from_datum(TDatum([], q), 4)
        recalls.append(tie_aware_recall(_full(
            t, lambda: t.similar_row_from_datum(TDatum([], q), K)), b, K))
    assert np.mean(recalls) >= FLOOR
    for rid in ("r0", "r150", "r399"):
        assert j.similar_row_from_id(rid, K) == t.similar_row_from_id(rid, K)
        assert j.neighbor_row_from_id(rid, 3) == t.neighbor_row_from_id(rid, 3)
    for n in (1, 3, 9):
        pairs = [(q, 2 + i % K) for i, q in enumerate(qs[:n])]
        assert j.similar_row_from_datum_many(
            [(JDatum([], q), s) for q, s in pairs]) == \
            t.similar_row_from_datum_many(
                [(TDatum([], q), s) for q, s in pairs])
        assert j.neighbor_row_from_datum_many(
            [(JDatum([], q), s) for q, s in pairs]) == \
            t.neighbor_row_from_datum_many(
                [(TDatum([], q), s) for q, s in pairs])


# ---------------------------------------------------------------------------
# the index off, declined or below min_rows: the full sweep's answers
# ---------------------------------------------------------------------------

def test_index_off_by_default():
    for svc, m in (("recommender", "lsh"), ("nearest_neighbor", "lsh"),
                   ("classifier", "AROW")):
        cfg = _cfg(m) if svc != "classifier" else {
            "method": m, "parameter": {"regularization_weight": 1.0},
            "converter": CONV}
        drv = tcreate(svc, cfg, device="cpu")
        assert drv.index is None
        assert drv.configure_index("ivf") is False


@pytest.mark.parametrize("service,method,kind", [
    ("recommender", "inverted_index", "lsh_probe"),
    ("recommender", "lsh", "ivf"),
    ("nearest_neighbor", "lsh", "ivf")])
def test_mismatched_kind_declines_and_stays_the_full_sweep(service, method,
                                                           kind):
    rng = np.random.default_rng(5)
    plain = tcreate(service, _cfg(method), device="cpu")
    declined = tcreate(service, _cfg(method), device="cpu")
    assert declined.configure_index(kind, probes=4) is False
    assert declined.index is None
    assert "index" not in declined.get_status()
    _, data = _clustered(rng, n=120)
    for drv in (plain, declined):
        if service == "recommender":
            for i, d in enumerate(data):
                drv.update_row(f"r{i}", TDatum([], d))
        else:
            drv.set_row_many([(f"r{i}", TDatum([], d))
                              for i, d in enumerate(data)])
    q = TDatum([], data[7])
    assert plain.similar_row_from_datum(q, 10) == \
        declined.similar_row_from_datum(q, 10)


def test_config_level_index_tuning():
    cfg = _cfg("lsh", min_rows=0, bits=6)
    j, t = _pair("nearest_neighbor", cfg, "lsh_probe")
    assert t.index.spec.min_rows == 0 and t.index.bits == 6
    rng = np.random.default_rng(44)
    _, data = _clustered(rng, n=50)
    for i, d in enumerate(data):
        j.set_row(f"r{i}", JDatum([], d))
        t.set_row(f"r{i}", TDatum([], d))
    before = _counter("index_probe_total")
    out = t.similar_row_from_datum(TDatum([], data[0]), 5)
    assert len(out) == 5
    assert out == j.similar_row_from_datum(JDatum([], data[0]), 5)
    assert _counter("index_probe_total") == before + 1


def test_below_min_rows_serves_the_full_sweep():
    rng = np.random.default_rng(6)
    plain = tcreate("nearest_neighbor", _cfg("lsh"), device="cpu")
    gated = tcreate("nearest_neighbor", _cfg("lsh"), device="cpu")
    assert gated.configure_index("lsh_probe", probes=4, min_rows=10_000)
    _, data = _clustered(rng, n=100)
    plain.set_row_many([(f"r{i}", TDatum([], d)) for i, d in
                        enumerate(data)])
    gated.set_row_many([(f"r{i}", TDatum([], d)) for i, d in
                        enumerate(data)])
    before = _counter("index_probe_total")
    q = TDatum([], data[3])
    assert plain.similar_row_from_datum(q, 10) == \
        gated.similar_row_from_datum(q, 10)
    assert _counter("index_probe_total") == before
    # maintenance still ran: the index is warm for when the table grows
    assert gated.index.store.live_rows == 100


# ---------------------------------------------------------------------------
# maintenance and lazy rebuilds
# ---------------------------------------------------------------------------

def test_updates_visible_via_delta_without_pack():
    rng = np.random.default_rng(8)
    j, t = _pair("nearest_neighbor", _cfg("lsh"), "lsh_probe", min_rows=0,
                 delta_cap=4096)
    _, data = _clustered(rng, n=300)
    j.set_row_many([(f"r{i}", JDatum([], d)) for i, d in enumerate(data)])
    t.set_row_many([(f"r{i}", TDatum([], d)) for i, d in enumerate(data)])
    assert j.similar_row_from_datum(JDatum([], data[0]), 5) == \
        t.similar_row_from_datum(TDatum([], data[0]), 5)   # builds, packs
    pending = int(t.index.get_status()["index_delta_pending"])
    fresh = _vec(rng.standard_normal(8) + 40.0)
    j.set_row("fresh", JDatum([], fresh))
    t.set_row("fresh", TDatum([], fresh))
    out = t.similar_row_from_id("fresh", 3)
    assert out and out[0][0] == "fresh"
    assert out == j.similar_row_from_id("fresh", 3)
    assert int(t.index.get_status()["index_delta_pending"]) > pending


@pytest.mark.parametrize("service,method", [
    ("nearest_neighbor", "lsh"), ("recommender", "minhash"),
    ("recommender", "inverted_index")])
def test_unpack_marks_a_lazy_rebuild(service, method):
    rng = np.random.default_rng(9)
    kind = "ivf" if method == "inverted_index" else "lsh_probe"
    j, t = _pair(service, _cfg(method), kind, min_rows=0)
    _, data = _clustered(rng, n=200)
    if service == "recommender":
        for i, d in enumerate(data):
            j.update_row(f"r{i}", JDatum([], d))
            t.update_row(f"r{i}", TDatum([], d))
    else:
        j.set_row_many([(f"r{i}", JDatum([], d)) for i, d in enumerate(data)])
        t.set_row_many([(f"r{i}", TDatum([], d)) for i, d in enumerate(data)])
    t.similar_row_from_datum(TDatum([], data[0]), 5)
    j.similar_row_from_datum(JDatum([], data[0]), 5)
    before = _counter("index_rebuild_total")
    t.unpack(t.pack())
    j.unpack(j.pack())
    assert t.index.needs_rebuild
    out = t.similar_row_from_id("r0", 5)
    assert out == j.similar_row_from_id("r0", 5)
    assert out[0][0] == "r0"
    assert not t.index.needs_rebuild
    assert _counter("index_rebuild_total") == before + 1


@pytest.mark.parametrize("method", ["lsh", "inverted_index_euclid"])
def test_clear_row_drops_from_results(method):
    rng = np.random.default_rng(10)
    kind = "lsh_probe" if method == "lsh" else "ivf"
    j, t = _pair("recommender", _cfg(method), kind, min_rows=0)
    _, data = _clustered(rng, n=200)
    for i, d in enumerate(data):
        j.update_row(f"r{i}", JDatum([], d))
        t.update_row(f"r{i}", TDatum([], d))
    q = TDatum([], data[0])
    assert t.similar_row_from_datum(q, 5) == \
        j.similar_row_from_datum(JDatum([], data[0]), 5)
    j.clear_row("r0")
    t.clear_row("r0")
    out = t.similar_row_from_datum(q, 60)
    assert "r0" not in {i for i, _ in out}
    assert out == j.similar_row_from_datum(JDatum([], data[0]), 60)
    # the freed slot is reused by the next row, in both stores alike
    j.update_row("new", JDatum([], data[1]))
    t.update_row("new", TDatum([], data[1]))
    assert t.similar_row_from_id("new", 8) == j.similar_row_from_id("new", 8)


def test_an_under_filled_read_falls_back_to_the_full_sweep():
    """Asking for more rows than the probed buckets hold: the index read
    under-fills, both drivers fall back to the full sweep and count it."""
    rng = np.random.default_rng(14)
    j, t = _pair("nearest_neighbor", _cfg("lsh"), "lsh_probe", min_rows=0,
                 probes=1)
    _, data = _clustered(rng, n=300)
    j.set_row_many([(f"r{i}", JDatum([], d)) for i, d in enumerate(data)])
    t.set_row_many([(f"r{i}", TDatum([], d)) for i, d in enumerate(data)])
    before = _counter("index_fallback_total")
    out = t.similar_row_from_datum(TDatum([], data[2]), 250)
    assert len(out) == 250
    assert out == j.similar_row_from_datum(JDatum([], data[2]), 250)
    assert _counter("index_fallback_total") == before + 1
    pairs = [(data[2], 250), (data[3], 2)]
    assert t.similar_row_from_datum_many(
        [(TDatum([], q), s) for q, s in pairs]) == \
        j.similar_row_from_datum_many([(JDatum([], q), s) for q, s in pairs])
    assert _counter("index_fallback_total") == before + 2


def test_ivf_retrains_on_growth_and_after_unpack():
    rng = np.random.default_rng(41)
    j, t = _pair("recommender", _cfg("inverted_index"), "ivf", min_rows=0)
    _, data = _clustered(rng, n=120)
    for i, d in enumerate(data):
        j.update_row(f"r{i}", JDatum([], d))
        t.update_row(f"r{i}", TDatum([], d))
    q = data[0]
    assert t.similar_row_from_datum(TDatum([], q), 5) == \
        j.similar_row_from_datum(JDatum([], q), 5)     # the first train
    trained0 = t.index._trained_rows
    assert trained0 == j.index._trained_rows >= 120
    _, more = _clustered(rng, n=200)
    for i, d in enumerate(more):
        j.update_row(f"g{i}", JDatum([], d))
        t.update_row(f"g{i}", TDatum([], d))          # the table > 2x
    before = _counter("index_rebuild_total")
    assert t.similar_row_from_datum(TDatum([], q), 5) == \
        j.similar_row_from_datum(JDatum([], q), 5)     # the growth retrain
    assert t.index._trained_rows >= 2 * trained0 - 1
    assert np.array_equal(t.index.centroids, j.index.centroids)
    assert _counter("index_rebuild_total") == before + 1
    t.unpack(t.pack())
    j.unpack(j.pack())
    assert t.index.needs_rebuild
    out = t.similar_row_from_datum(TDatum([], q), 5)
    assert len(out) == 5
    assert out == j.similar_row_from_datum(JDatum([], q), 5)
    assert not t.index.needs_rebuild


def test_mix_rows_are_noted_in_the_index():
    """put_diff's rows reach the index (the NN driver's bulk store, the
    recommender's dirty-row write), so a mixed replica probes them."""
    rng = np.random.default_rng(15)
    _, data = _clustered(rng, n=160)
    src = tcreate("nearest_neighbor", _cfg("lsh"), device="cpu")
    src.set_row_many([(f"r{i}", TDatum([], d)) for i, d in enumerate(data)])
    j, t = _pair("nearest_neighbor", _cfg("lsh"), "lsh_probe", min_rows=0)
    diff = src.get_diff()
    t.put_diff(diff)
    j.put_diff(tdur.CODECS["jax"].decode(msgpack.unpackb(
        msgpack.packb(tdur.CODECS["port"].encode(diff), use_bin_type=True),
        raw=False)))
    assert t.index.store.live_rows == 160
    for rid in ("r1", "r80"):
        assert t.similar_row_from_id(rid, 5) == j.similar_row_from_id(rid, 5)


# ---------------------------------------------------------------------------
# observability: counters and status
# ---------------------------------------------------------------------------

def test_counters_and_status():
    rng = np.random.default_rng(31)
    j, t = _pair("recommender", _cfg("lsh"), "lsh_probe", min_rows=0)
    _, data = _clustered(rng, n=200)
    for i, d in enumerate(data):
        j.update_row(f"r{i}", JDatum([], d))
        t.update_row(f"r{i}", TDatum([], d))
    before = _counter("index_probe_total")
    t.similar_row_from_datum(TDatum([], data[0]), 5)
    j.similar_row_from_datum(JDatum([], data[0]), 5)
    assert _counter("index_probe_total") == before + 1
    snap = GLOBAL.snapshot()
    assert float(snap["index_rows"]) >= 200
    assert "index_candidate_ratio_p50" in snap
    st, jst = t.get_status(), j.get_status()
    assert st["index"] == "lsh_probe" and int(st["index_live_rows"]) == 200
    for key in ("index", "index_probes", "index_min_rows",
                "index_needs_rebuild", "index_bucket_cap", "index_groups",
                "index_live_rows", "index_truncated_rows",
                "index_delta_pending"):
        assert st[key] == jst[key], key
    stats = t.take_index_sweep_stats()
    assert stats is not None and stats[1] == 200
    assert t.take_index_sweep_stats() is None


# ---------------------------------------------------------------------------
# the partition plane over indexed partitions (tests/test_index.py
# TestPartitionedIndexedGolden): the merged legs equal one indexed driver,
# tie-aware, and every leg is the JAX package's, bitwise
# ---------------------------------------------------------------------------

def _canon6(items):
    return sorted(((i, round(float(s), 6)) for i, s in items),
                  key=lambda kv: (-kv[1], kv[0]))


def test_recommender_partitioned_merge_golden():
    from jubatus_tpu.framework.partition import merge_topk as jmerge
    from jubatus_tpu_torch.framework.partition import merge_topk
    rng = np.random.default_rng(21)
    cfg = _cfg("lsh")
    single = tcreate("recommender", cfg, device="cpu")
    pairs = [_pair("recommender", cfg, "lsh_probe", min_rows=0)
             for _ in range(2)]
    assert single.configure_index("lsh_probe", probes=4, min_rows=0)
    _, data = _clustered(rng, n=300, jitter=0.1)
    for i, d in enumerate(data):
        single.update_row(f"r{i}", TDatum([], d))
        pairs[i % 2][0].update_row(f"r{i}", JDatum([], d))
        pairs[i % 2][1].update_row(f"r{i}", TDatum([], d))
    for qi in (5, 17, 42):
        fv = single.partition_query_fv(f"r{qi}")
        jlegs = [(p, [[i, s] for i, s in j.similar_row_from_fv_partial(fv, K)])
                 for p, (j, _) in enumerate(pairs)]
        tlegs = [(p, [[i, s] for i, s in t.similar_row_from_fv_partial(fv, K)])
                 for p, (_, t) in enumerate(pairs)]
        assert tlegs == jlegs
        merged = merge_topk(tlegs, K, ascending=False)
        assert merged == jmerge(jlegs, K, ascending=False)
        assert _canon6(merged) == _canon6(single.similar_row_from_id(
            f"r{qi}", K))


def test_nn_partitioned_merge_golden():
    from jubatus_tpu.framework.partition import merge_topk as jmerge
    from jubatus_tpu_torch.framework.partition import merge_topk
    rng = np.random.default_rng(22)
    cfg = _cfg("euclid_lsh")
    single = tcreate("nearest_neighbor", cfg, device="cpu")
    pairs = [_pair("nearest_neighbor", cfg, "lsh_probe", min_rows=0)
             for _ in range(3)]
    assert single.configure_index("lsh_probe", probes=4, min_rows=0)
    _, data = _clustered(rng, n=300, jitter=0.1)
    for i, d in enumerate(data):
        single.set_row(f"r{i}", TDatum([], d))
        pairs[i % 3][0].set_row(f"r{i}", JDatum([], d))
        pairs[i % 3][1].set_row(f"r{i}", TDatum([], d))
    for qi in (3, 99):
        sig, norm = single.partition_query_sig(f"r{qi}")
        jlegs = [(p, [[i, s] for i, s in
                      j.similar_row_from_sig_partial(sig, norm, K)])
                 for p, (j, _) in enumerate(pairs)]
        tlegs = [(p, [[i, s] for i, s in
                      t.similar_row_from_sig_partial(sig, norm, K)])
                 for p, (_, t) in enumerate(pairs)]
        assert tlegs == jlegs
        merged = merge_topk(tlegs, K, ascending=False)
        assert merged == jmerge(jlegs, K, ascending=False)
        assert _canon6(merged) == _canon6(single.similar_row_from_id(
            f"r{qi}", K))


def test_handoff_drop_keeps_the_index_consistent():
    """tests/test_index.py's drop: the dropped half never answers, and
    every read after the drop is the JAX driver's."""
    rng = np.random.default_rng(12)
    j, t = _pair("nearest_neighbor", _cfg("lsh"), "lsh_probe", min_rows=0)
    _, data = _clustered(rng, n=200)
    for i, d in enumerate(data):
        j.set_row(f"r{i}", JDatum([], d))
        t.set_row(f"r{i}", TDatum([], d))
    t.similar_row_from_datum(TDatum([], data[0]), 5)
    j.similar_row_from_datum(JDatum([], data[0]), 5)
    drop = [f"r{i}" for i in range(100)]
    assert t.partition_drop_rows(drop) == j.partition_drop_rows(drop) == 100
    for qi in (150, 7):
        out = t.similar_row_from_datum(TDatum([], data[qi]), 5)
        assert out == j.similar_row_from_datum(JDatum([], data[qi]), 5)
        assert out and all(int(i[1:]) >= 100 for i, _ in out)
        rid = f"r{qi % 100 + 100}"
        assert t.similar_row_from_id(rid, 5) == j.similar_row_from_id(rid, 5)
