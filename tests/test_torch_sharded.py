"""The port's key-sharded nearest_neighbor (jubatus_tpu_torch/parallel/
sharded.py, mesh.py, the index's slabs and the server's --shard_devices)
against the JAX package's ShardedNearestNeighborDriver on the suite's
virtual 8-device CPU mesh, counterpart of tests/test_sharded.py.

Both drivers are fed the same seeded writes.  Tolerances: none.  Every
read (lsh, minhash and euclid_lsh; by datum, by id, by raw signature;
full sweep and lsh_probe) equals the JAX driver's in ids, scores and
order (==), the placement ((shard, row) of every id) and the pack bytes
are equal, and the index's per-read stats (candidates, rows, fallback)
are equal.  Against the port's unsharded driver the scores are equal as
sequences and the ids equal up to ties: the merge puts tied rows
shard-major, then lowest local row, where the flat table names the lower
slot.
"""

import json

import numpy as np
import pytest

from jubatus_tpu.fv import Datum as JDatum
from jubatus_tpu.parallel import make_mesh as jmesh
from jubatus_tpu.parallel.sharded import ShardedNearestNeighborDriver as JNN
from jubatus_tpu.parallel.sharded import key_shard as jkey_shard
from jubatus_tpu_torch.fv import Datum as TDatum
from jubatus_tpu_torch.models import create_driver as tcreate
from jubatus_tpu_torch.parallel.mesh import (GRID_REFUSAL, make_mesh,
                                             resolve_replicas)
from jubatus_tpu_torch.parallel.sharded import ShardedNearestNeighborDriver \
    as TNN
from jubatus_tpu_torch.parallel.sharded import (_k_bucket, key_shard,
                                                merge_candidates)

CONV = {"num_rules": [{"key": "*", "type": "num"}], "hash_max_size": 512}
METHODS = ("lsh", "minhash", "euclid_lsh")


def cfg(method="lsh", hash_num=64):
    return {"method": method, "parameter": {"hash_num": hash_num},
            "converter": CONV}


def vec(v):
    return [(f"k{k}", float(x)) for k, x in enumerate(v)]


def data(n, seed=0, dim=6, dup_every=5):
    """Seeded rows of varied norms; every dup_every-th repeats an earlier
    one, so reads meet exact ties across shards."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if dup_every and i % dup_every == dup_every - 1:
            out.append(out[i // 2])
        else:
            out.append(vec(rng.standard_normal(dim)
                           * np.exp(rng.standard_normal())))
    return out


def pair(method, nshard, cls_j=JNN, cls_t=TNN, hash_num=64):
    return (cls_j(cfg(method, hash_num), jmesh(dp=1, shard=nshard)),
            cls_t(cfg(method, hash_num), make_mesh(shard=nshard,
                                                   device="cpu")))


def fill(j, t, rows, prefix="r", many=True):
    ids = [f"{prefix}{i}" for i in range(len(rows))]
    if many:
        assert j.set_row_many([(i, JDatum([], d)) for i, d in
                               zip(ids, rows)]) == \
            t.set_row_many([(i, TDatum([], d)) for i, d in zip(ids, rows)])
    else:
        for i, d in zip(ids, rows):
            assert j.set_row(i, JDatum([], d)) == t.set_row(i, TDatum([], d))
    return ids


def reads(drv, datum_cls, queries, ids, sizes=(1, 5, 64)):
    out = []
    for size in sizes:
        for q in queries:
            out.append(drv.similar_row_from_datum(datum_cls([], q), size))
            out.append(drv.neighbor_row_from_datum(datum_cls([], q), size))
        for i in ids:
            out.append(drv.similar_row_from_id(i, size))
            out.append(drv.neighbor_row_from_id(i, size))
    return out


# -- placement and the mesh ---------------------------------------------------

@pytest.mark.parametrize("nshard", [1, 2, 3, 4, 8])
def test_key_shard_equals_jax(nshard):
    ids = [f"r{i}" for i in range(2000)] + ["", "é", "row-ü-7", "1", "2"]
    assert [key_shard(i, nshard) for i in ids] == \
        [jkey_shard(i, nshard) for i in ids]


@pytest.mark.parametrize("k,cap", [(1, 128), (3, 128), (8, 128), (9, 16),
                                   (300, 256), (0, 4)])
def test_k_bucket_is_the_jax_drivers(k, cap):
    from jubatus_tpu.parallel.sharded import _k_bucket as jk
    assert _k_bucket(k, cap) == jk(k, cap)


def test_the_mesh_takes_a_shard_axis():
    m = make_mesh(shard=4, device="cpu")
    assert m.shape == {"dp": 1, "shard": 4}
    # above the device count: stacked on the one device, not refused
    assert make_mesh(dp=1, shard=16, device="cpu").nshard == 16
    assert resolve_replicas("shard_devices", 0, "cpu") == 1
    with pytest.raises(ValueError,
                       match="--shard_devices must be >= 0, got -2"):
        resolve_replicas("shard_devices", -2, "cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_mesh(dp=2, shard=2, device="cpu")
    assert "2-D (dp, shard) grid" in GRID_REFUSAL


@pytest.mark.parametrize("nshard", [2, 4])
def test_placement_equals_jax(nshard):
    j, t = pair("lsh", nshard)
    fill(j, t, data(40, seed=nshard))
    assert t.ids == j.ids
    assert t.shard_row_ids == j.shard_row_ids
    assert t.row_ids == j.row_ids
    for i, (s, _) in t.ids.items():
        assert s == key_shard(i, nshard)
    assert t.get_status()["rows_per_shard"] == \
        j.get_status()["rows_per_shard"]


# -- reads --------------------------------------------------------------------

@pytest.mark.parametrize("nshard", [2, 4])
@pytest.mark.parametrize("method", METHODS)
def test_reads_equal_jax_in_order(method, nshard):
    j, t = pair(method, nshard)
    rows = data(48, seed=3 + nshard)
    ids = fill(j, t, rows)
    queries = rows[:3] + data(4, seed=99, dup_every=0)
    assert reads(t, TDatum, queries, ids[:6]) == \
        reads(j, JDatum, queries, ids[:6])


@pytest.mark.parametrize("method", METHODS)
def test_set_row_one_by_one_equals_jax(method):
    j, t = pair(method, 4)
    rows = data(20, seed=11)
    ids = fill(j, t, rows, many=False)
    assert t.ids == j.ids
    assert reads(t, TDatum, rows[:2], ids[:3], sizes=(4, 30)) == \
        reads(j, JDatum, rows[:2], ids[:3], sizes=(4, 30))


@pytest.mark.parametrize("method", METHODS)
def test_partial_sig_reads_equal_jax(method):
    j, t = pair(method, 4)
    ids = fill(j, t, data(30, seed=5))
    for i in ids[:5]:
        sig, norm = t.partition_query_sig(i)
        jsig, jnorm = j.partition_query_sig(i)
        assert (sig, norm) == (jsig, jnorm)
        for size in (3, 40):
            assert t.similar_row_from_sig_partial(sig, norm, size) == \
                j.similar_row_from_sig_partial(jsig, jnorm, size)
            assert t.neighbor_row_from_sig_partial(sig, norm, size) == \
                t.neighbor_row_from_id(i, size)
    assert t.similar_row_from_sig_partial(sig, norm, 0) == []


@pytest.mark.parametrize("method", METHODS)
def test_sharded_equals_unsharded_up_to_ties(method):
    """Equal score sequences; ids equal wherever the score is not tied."""
    _, t = pair(method, 4)
    flat = tcreate("nearest_neighbor", cfg(method), device="cpu")
    rows = data(40, seed=21)
    t.set_row_many([(f"r{i}", TDatum([], d)) for i, d in enumerate(rows)])
    flat.set_row_many([(f"r{i}", TDatum([], d)) for i, d in enumerate(rows)])
    ties = 0
    for q in rows[:6] + data(3, seed=7, dup_every=0):
        every = [s for _, s in flat.similar_row_from_datum(TDatum([], q),
                                                            40)]
        for size in (3, 10, 40):
            a = t.similar_row_from_datum(TDatum([], q), size)
            b = flat.similar_row_from_datum(TDatum([], q), size)
            assert [s for _, s in a] == [s for _, s in b]
            for k in range(len(a)):
                tied = every.count(b[k][1]) > 1
                ties += tied
                if not tied:
                    assert a[k][0] == b[k][0]
                else:   # a row of the table with that very score
                    assert (a[k][0], a[k][1]) in \
                        flat.similar_row_from_datum(TDatum([], q), 40)
    assert ties > 0     # the data's repeats do tie


def test_many_reads_bitwise_per_request():
    for method in METHODS:
        _, t = pair(method, 4)
        rows = data(24, seed=4)
        t.set_row_many([(f"r{i}", TDatum([], d)) for i, d in
                        enumerate(rows)])
        pairs = [(TDatum([], q), 3 + (k % 3) * 4)
                 for k, q in enumerate(rows[:4] + data(3, seed=8))]
        assert t.similar_row_from_datum_many(pairs) == \
            [t.similar_row_from_datum(d, k) for d, k in pairs]
        assert t.neighbor_row_from_datum_many(pairs) == \
            [t.neighbor_row_from_datum(d, k) for d, k in pairs]


# -- growth, drops and slot reuse ---------------------------------------------

class SmallJ(JNN):
    INITIAL_ROWS = 2


class SmallT(TNN):
    INITIAL_ROWS = 2


@pytest.mark.parametrize("method", METHODS)
def test_growth_equals_jax(method):
    j, t = pair(method, 2, SmallJ, SmallT)
    rows = data(27, seed=13)
    ids = fill(j, t, rows, many=False)
    assert t.capacity == j.capacity > 2
    assert tuple(t.sig.shape) == tuple(np.asarray(j.sig).shape)
    assert np.array_equal(t.sig.numpy().view(np.uint32), np.asarray(j.sig))
    assert np.array_equal(t.valid.numpy(), np.asarray(j.valid))
    assert reads(t, TDatum, rows[:2], ids[:4], sizes=(2, 40)) == \
        reads(j, JDatum, rows[:2], ids[:4], sizes=(2, 40))
    assert t.neighbor_row_from_id("r1", 3)[0][1] == 0.0


def test_drop_and_slot_reuse_equal_jax():
    j, t = pair("lsh", 4)
    rows = data(30, seed=17)
    ids = fill(j, t, rows)
    gone = ids[3:12:2]
    assert t.partition_drop_rows(gone) == j.partition_drop_rows(gone) == 5
    assert t.partition_drop_rows(["nope"]) == 0
    assert t.ids == j.ids and t._shard_free == j._shard_free
    fresh = data(8, seed=18)
    fill(j, t, fresh, prefix="n")
    assert t.ids == j.ids and t.shard_row_ids == j.shard_row_ids
    assert np.array_equal(t.valid.numpy(), np.asarray(j.valid))
    assert reads(t, TDatum, fresh[:2], ["n1", "r0"], sizes=(4, 40)) == \
        reads(j, JDatum, fresh[:2], ["n1", "r0"], sizes=(4, 40))


def test_partition_surface_roundtrip():
    """tests/test_sharded_rows.py:217-235 on the port: the scatter leg and
    the handoff pack/apply/drop on the sharded layout, and each equal to
    the JAX driver's."""
    j, t = pair("lsh", 4)
    fill(j, t, data(16, seed=2))
    sig, norm = t.partition_query_sig("r3")
    assert t.similar_row_from_sig_partial(sig, norm, 5) == \
        t.similar_row_from_id("r3", 5)
    q = TDatum([], data(3, seed=2)[2])
    before = t.neighbor_row_from_datum(q, 6)
    payload = t.partition_pack_rows(["r1", "r2", "zz"])
    assert payload == j.partition_pack_rows(["r1", "r2", "zz"])
    assert t.partition_drop_rows(["r1", "r2"]) == 2
    assert "r1" not in t.ids
    assert t.partition_apply_rows(payload) == 2
    assert t.partition_apply_rows(payload) == 0     # resident: skipped
    assert t.neighbor_row_from_datum(q, 6) == before
    with pytest.raises(KeyError):
        t.partition_query_sig("zz")


# -- persistence and MIX ------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
def test_pack_equals_jax_and_loads_into_a_plain_driver(method):
    j, t = pair(method, 4)
    rows = data(26, seed=23)
    ids = fill(j, t, rows)
    t.partition_drop_rows(ids[:2])
    j.partition_drop_rows(ids[:2])
    tp, jp = t.pack(), j.pack()
    for key in ("method", "hash_num", "seed", "capacity", "row_ids", "sig",
                "norms", "weights"):
        assert tp[key] == jp[key], key
    plain = tcreate("nearest_neighbor", cfg(method), device="cpu")
    plain.unpack(tp)
    assert sorted(plain.get_all_rows()) == sorted(t.get_all_rows())
    for q in rows[2:6]:
        a = t.similar_row_from_datum(TDatum([], q), 30)
        b = plain.similar_row_from_datum(TDatum([], q), 30)
        assert [s for _, s in a] == [s for _, s in b]
        assert sorted(a) == sorted(b)


@pytest.mark.parametrize("src_shards,dst_shards", [(4, 2), (1, 4), (4, 4)])
def test_unpack_replaces_rows_as_jax(src_shards, dst_shards):
    j, t = pair("minhash", src_shards)
    rows = data(20, seed=29)
    fill(j, t, rows)
    j2, t2 = pair("minhash", dst_shards)
    t2.unpack(t.pack())
    j2.unpack(j.pack())
    assert t2.ids == j2.ids and t2.shard_row_ids == j2.shard_row_ids
    assert reads(t2, TDatum, rows[:2], ["r4"], sizes=(6,)) == \
        reads(j2, JDatum, rows[:2], ["r4"], sizes=(6,))
    # a plain JAX model into the sharded port driver
    from jubatus_tpu.models import create_driver as jcreate
    single = jcreate("nearest_neighbor", cfg("minhash"))
    for i, d in enumerate(rows[:9]):
        single.set_row(f"s{i}", JDatum([], d))
    t2.unpack(single.pack())
    assert sorted(t2.get_all_rows()) == sorted(single.get_all_rows())
    assert t2.neighbor_row_from_id("s2", 3)[0][1] == 0.0


def test_mix_with_an_unsharded_port_peer():
    _, t = pair("lsh", 4)
    peer = tcreate("nearest_neighbor", cfg("lsh"), device="cpu")
    rows = data(12, seed=31)
    for i in range(6):
        t.set_row(f"s{i}", TDatum([], rows[i]))
    for i in range(6, 12):
        peer.set_row(f"p{i}", TDatum([], rows[i]))
    merged = TNN.mix(t.get_diff(), peer.get_diff())
    assert t.put_diff(merged) and peer.put_diff(merged)
    assert sorted(t.get_all_rows()) == sorted(peer.get_all_rows())
    assert t._pending == {} and peer._pending == {}
    for i in ("p7", "s2"):
        a, b = t.similar_row_from_id(i, 12), peer.similar_row_from_id(i, 12)
        assert [s for _, s in a] == [s for _, s in b]
        assert dict(a)[i] == dict(b)[i] == 1.0


def test_clear_and_status():
    j, t = pair("euclid_lsh", 4)
    fill(j, t, data(9, seed=37))
    st, jst = t.get_status(), j.get_status()
    for key in ("method", "num_rows", "hash_num", "shards",
                "rows_per_shard"):
        assert st[key] == jst[key], key
    assert st["shards"] == "4" and st["num_rows"] == "9"
    t.clear()
    assert t.get_all_rows() == [] and t.capacity == t.INITIAL_ROWS
    assert t.similar_row_from_datum(TDatum([], data(1)[0]), 3) == []
    t.set_row("a", TDatum([], data(1)[0]))
    assert t.similar_row_from_id("a", 2) == [("a", 0.0)]


def test_merge_keeps_jax_tie_order():
    vals = np.array([[1.0, 0.5, -np.inf], [1.0, 0.75, 0.5]], np.float32)
    rows = np.array([[1, 0, 2], [0, 2, 1]], np.int64)
    ids = [["a", "b", ""], ["c", "d", "e"]]
    assert merge_candidates(vals, rows, ids, 9) == \
        [("b", 1.0), ("c", 1.0), ("e", 0.75), ("a", 0.5), ("d", 0.5)]
    assert merge_candidates(vals, rows, ids, 2) == [("b", 1.0), ("c", 1.0)]
    dup = np.array([[1.0, 1.0, 0.5]], np.float32)
    assert merge_candidates(dup, np.array([[0, 0, 1]]), [["x", "y"]], 3,
                            dedupe=True) == [("x", 1.0), ("y", 0.5)]


# -- the index: one slab a shard ----------------------------------------------

def _clustered(n, seed, centers=12, dim=8, jitter=0.03):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, dim))
    return [vec(c[i % centers] + jitter * rng.standard_normal(dim))
            for i in range(n)], c


@pytest.mark.parametrize("method", METHODS)
def test_indexed_reads_equal_jax(method):
    j, t = pair(method, 4)
    for d in (j, t):
        assert d.configure_index("lsh_probe", probes=4, min_rows=0)
    assert t.index.store.n_slabs == 4
    rows, centers = _clustered(160, seed=41)
    ids = fill(j, t, rows)
    rng = np.random.default_rng(42)
    queries = [vec(centers[i] + 0.03 * rng.standard_normal(8))
               for i in range(6)]
    stats_j, stats_t, out_j, out_t = [], [], [], []
    for size in (3, 10):
        for q in queries:
            out_j.append(j.similar_row_from_datum(JDatum([], q), size))
            out_t.append(t.similar_row_from_datum(TDatum([], q), size))
            stats_j.append(j.index.take_stats())
            stats_t.append(t.index.take_stats())
        for i in ids[:4]:
            out_j.append(j.neighbor_row_from_id(i, size))
            out_t.append(t.neighbor_row_from_id(i, size))
            stats_j.append(j.index.take_stats())
            stats_t.append(t.index.take_stats())
    assert out_t == out_j
    assert stats_t == stats_j
    assert any(s is not None and not s[2] for s in stats_t)   # pruned
    # the stacked views: [S, ...], one bucket cap and one Dcap
    flat, off, ln, delta, cap = t.index.device_csr(squeeze=False)
    jf, jo, jl, jd, jcap = j.index.store.packed()
    assert (flat.numpy() == jf).all() and (off.numpy() == jo).all()
    assert (ln.numpy() == jl).all() and (delta.numpy() == jd).all()
    assert cap == jcap and flat.shape[0] == 4


def test_indexed_reads_after_writes_drops_and_fallback():
    j, t = pair("lsh", 4)
    for d in (j, t):
        assert d.configure_index("lsh_probe", probes=2, min_rows=0)
    rows, centers = _clustered(120, seed=43)
    ids = fill(j, t, rows)
    q = TDatum([], vec(centers[1]))
    jq = JDatum([], vec(centers[1]))
    assert t.similar_row_from_datum(q, 8) == j.similar_row_from_datum(jq, 8)
    # new rows ride the delta, drops invalidate slab by slab
    more, _ = _clustered(20, seed=44)
    fill(j, t, more, prefix="m", many=False)
    assert t.partition_drop_rows(ids[::7]) == j.partition_drop_rows(ids[::7])
    for size in (5, 60, 200):     # 200: under-fills, falls back in full
        assert t.similar_row_from_datum(q, size) == \
            j.similar_row_from_datum(jq, size)
        assert t.index.take_stats() == j.index.take_stats()
    assert t.index.get_status()["index_delta_pending"] == \
        j.index.get_status()["index_delta_pending"]


def test_the_one_slab_views_are_unchanged():
    """A one-slab store gives the plane's arrays (the unsharded driver's
    K6 input); squeeze=False gives them with the slab axis."""
    from jubatus_tpu_torch.index.store import BucketStore
    st = BucketStore(2, 8, delta_cap=16)
    st.note_rows(np.arange(20), np.tile(np.arange(20) % 8, (2, 1))
                 .astype(np.int32))
    a = st.packed()
    b = st.packed(squeeze=False)
    assert a[0].ndim == 1 and b[0].ndim == 2 and b[0].shape[0] == 1
    for x, y in zip(a[:4], b[:4]):
        assert x.tobytes() == y[0].tobytes()
    assert a[4] == b[4]
    two = BucketStore(2, 8, n_slabs=2, delta_cap=16)
    two.note_rows(np.arange(5), np.zeros((2, 5), np.int32), slab=1)
    flat, off, ln, delta, cap = two.packed()
    assert flat.shape[0] == 2 and int(ln[1].sum()) == 10 \
        and int(ln[0].sum()) == 0
    two.invalidate_rows([0, 1], slab=1)
    assert two.live_rows == 3


# -- the server ---------------------------------------------------------------

def _server(tmp_path, typ, config, *extra):
    from jubatus_tpu_torch.cli import server as tserver_cli
    path = tmp_path / f"{typ}.json"
    path.write_text(json.dumps(config))
    return tserver_cli.serve(
        ["--type", typ, "--configpath", str(path), "--device", "cpu",
         "--rpc-port", "0", "--listen_addr", "127.0.0.1", *extra])


@pytest.mark.parametrize("index", ["off", "lsh_probe"])
def test_a_sharded_server_answers_as_the_jax_driver(tmp_path, index):
    """--shard_devices 4 over the wire: every read equal to a JAX sharded
    driver's after the same writes (==), the status keys."""
    from tests.test_wire_golden import GoldenConn, datum_wire
    config = dict(cfg("lsh"), index={"min_rows": 0})
    srv, rpc = _server(tmp_path, "nearest_neighbor", config,
                       "--shard_devices", "4", "--index", index)
    conn = GoldenConn(srv.args.rpc_port)
    j = JNN(config, jmesh(dp=1, shard=4))
    if index != "off":
        assert j.configure_index(index, probes=4)
    try:
        rows, centers = _clustered(40, seed=47)
        for i, d in enumerate(rows):
            assert conn.call("set_row", f"r{i}", datum_wire(nums=d)) is True
            j.set_row(f"r{i}", JDatum([], d))
        for q in [vec(c) for c in centers[:3]] + rows[:2]:
            got = conn.call("similar_row_from_datum", datum_wire(nums=q), 6)
            assert [(i, s) for i, s in got] == \
                j.similar_row_from_datum(JDatum([], q), 6)
        got = conn.call("neighbor_row_from_id", "r5", 4)
        assert [(i, s) for i, s in got] == j.neighbor_row_from_id("r5", 4)
        st = next(iter(conn.call("get_status").values()))
        assert st["shards"] == "4" and st["num_rows"] == "40"
        assert st["rows_per_shard"] == j.get_status()["rows_per_shard"]
        assert st["index"] == index
    finally:
        conn.close()
        rpc.stop()
        srv.stop()


@pytest.mark.parametrize("typ", ["recommender", "anomaly"])
def test_row_engines_serve_sharded(tmp_path, typ):
    config = ({"method": "lsh", "parameter": {"hash_num": 64},
               "converter": CONV} if typ == "recommender" else
              {"method": "lof", "parameter": {
                  "nearest_neighbor_num": 4, "method": "euclid_lsh",
                  "parameter": {"hash_num": 64}}, "converter": CONV})
    srv, rpc = _server(tmp_path, typ, config, "--shard_devices", "0")
    try:
        st = next(iter(srv.get_status().values()))
        assert st["shard_devices"] == "1"      # 0: one a local device
        assert type(srv.driver).__name__.startswith("Sharded")
    finally:
        rpc.stop()
        srv.stop()


def test_the_server_refuses_what_jax_refuses(tmp_path):
    from jubatus_tpu_torch.framework.server_base import (JubatusServer,
                                                         ServerArgs)
    clf = {"method": "PA", "converter": CONV}
    with pytest.raises(ValueError, match="--shard_devices supports "
                       "nearest_neighbor/recommender/anomaly "
                       "\\(got 'classifier'\\)"):
        JubatusServer(ServerArgs(type="classifier", device="cpu",
                                 shard_devices=2), config=json.dumps(clf))
    with pytest.raises(ValueError, match="mutually exclusive"):
        JubatusServer(ServerArgs(type="nearest_neighbor", device="cpu",
                                 shard_devices=2, dp_replicas=2),
                      config=json.dumps(cfg()))
    with pytest.raises(ValueError, match="--shard_devices must be >= 0"):
        JubatusServer(ServerArgs(type="nearest_neighbor", device="cpu",
                                 shard_devices=-1), config=json.dumps(cfg()))
