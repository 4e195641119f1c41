"""The port's nearest_neighbor service (jubatus_tpu_torch/models/
nearest_neighbor.py, models/pages.py, its service table and server, on
the CPU) against the JAX package's, on seeded numpy inputs.

- The driver: the same set_row / set_row_many sequence (duplicate ids
  included) gives the same table, byte for byte in pack(), and the same
  answers on every query route, for lsh, minhash and euclid_lsh.
- MIX: get_diff / mix / put_diff of either package applied to the other.
- The server over the wire against the JAX server: set_row and the four
  reads; model files saved by either load in the other.
- Journals: a directory written by either package recovers in the other.
- The paged row store's slot numbering and growth as the JAX store's;
  the refusals of what is not ported, on the wire too.

Tolerances (tests/test_torch_lsh.py states them): signatures and the lsh
and minhash answers bitwise (no signature bit of these inputs falls in
the rounding band); euclid_lsh scores within RTOL relative plus ATOL
absolute, the order differing only between rows whose scores lie within
that bound.
"""

import json
import os
import shutil
import threading

import msgpack
import numpy as np
import pytest
import torch

from jubatus_tpu.fv import Datum as JDatum
from jubatus_tpu.models.nearest_neighbor import \
    NearestNeighborDriver as JNN
from jubatus_tpu.models.pages import PagedRowStore as JStore
from jubatus_tpu.models.pages import PageSpec as JSpec
from jubatus_tpu_torch.cli.server import serve
from jubatus_tpu_torch.fv import Datum as TDatum
from jubatus_tpu_torch.models.nearest_neighbor import \
    NearestNeighborDriver as TNN
from jubatus_tpu_torch.models.pages import PagedRowStore as TStore
from jubatus_tpu_torch.models.pages import PageSpec as TSpec
from tests import test_torch_durability as tdur
from tests.test_torch_lsh import ATOL, RTOL
from tests.test_torch_server import _pair
from tests.test_wire_golden import GoldenConn, datum_wire

METHODS = ("lsh", "minhash", "euclid_lsh")
CONVERTER = {"num_rules": [{"key": "*", "type": "num"}],
             "hash_max_size": 4096}


def config(method, hash_num=64, **param):
    return {"method": method,
            "parameter": {"hash_num": hash_num, **param},
            "converter": CONVERTER}


def rows(seed, n, keys=1024, nnz=16):
    """n datums of nnz numeric features drawn from `keys` names."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ks = rng.choice(keys, nnz, replace=False)
        vs = rng.standard_normal(nnz)
        out.append([(f"f{k}", float(v)) for k, v in zip(ks, vs)])
    return out


def jd(nums):
    return JDatum(num_values=nums)


def td(nums):
    return TDatum(num_values=nums)


def enc(pkg, diff) -> bytes:
    """A diff's bytes on the f32 MIX wire of `pkg`'s codec."""
    return msgpack.packb(tdur.CODECS[pkg].encode(diff), use_bin_type=True)


def assert_same_results(method, a, b):
    """Wire-shaped result lists [(id, score)] of the two packages."""
    assert len(a) == len(b)
    if method != "euclid_lsh":
        assert a == b
        return
    np.testing.assert_allclose([s for _, s in b], [s for _, s in a],
                               rtol=RTOL, atol=ATOL)
    score = dict(a)
    for (ia, sa), (ib, _) in zip(a, b):
        if ia != ib:
            assert ib in score and abs(score[ib] - sa) <= ATOL + RTOL * abs(sa)


def filled(method, seed=1, hash_num=64):
    """A JAX driver and a port driver fed the same history: single
    set_rows, a set_row_many with duplicate and existing ids, an
    overwrite."""
    cfg = config(method, hash_num)
    j, t = JNN(cfg), TNN(cfg, device="cpu")
    data = rows(seed, 200)
    for i, d in enumerate(data[:30]):
        assert j.set_row(f"r{i}", jd(d)) and t.set_row(f"r{i}", td(d))
    batch = [(f"r{(i * 7) % 150}", d) for i, d in enumerate(data[30:190])]
    assert j.set_row_many([(i, jd(d)) for i, d in batch]) == \
        t.set_row_many([(i, td(d)) for i, d in batch]) == len(batch)
    j.set_row("r3", jd(data[195]))
    t.set_row("r3", td(data[195]))
    return j, t, data


@pytest.mark.parametrize("method", METHODS)
def test_same_history_same_table_and_pack(method):
    j, t, _ = filled(method)
    assert j.get_all_rows() == t.get_all_rows()
    assert j.ids == t.ids
    jp, tp = j.pack(), t.pack()
    assert sorted(jp) == sorted(tp)
    for k in jp:
        assert jp[k] == tp[k], k
    assert msgpack.packb(jp, use_bin_type=True) == \
        msgpack.packb(tp, use_bin_type=True)


@pytest.mark.parametrize("method", METHODS)
def test_same_answers_on_every_route(method):
    j, t, data = filled(method, seed=2)
    for q in data[190:200]:
        for size in (1, 10, 33):
            assert_same_results(method,
                                j.similar_row_from_datum(jd(q), size),
                                t.similar_row_from_datum(td(q), size))
            assert_same_results(method,
                                j.neighbor_row_from_datum(jd(q), size),
                                t.neighbor_row_from_datum(td(q), size))
    for rid in ("r0", "r3", "r77", "r149"):
        assert_same_results(method, j.similar_row_from_id(rid, 12),
                            t.similar_row_from_id(rid, 12))
        assert_same_results(method, j.neighbor_row_from_id(rid, 12),
                            t.neighbor_row_from_id(rid, 12))
    pairs = [(q, s) for q, s in zip(data[180:195], [3, 10, 1, 64, 5] * 3)]
    for kind in ("similar_row_from_datum_many",
                 "neighbor_row_from_datum_many"):
        ja = getattr(j, kind)([(jd(q), s) for q, s in pairs])
        ta = getattr(t, kind)([(td(q), s) for q, s in pairs])
        for a, b in zip(ja, ta):
            assert_same_results(method, a, b)


def test_many_equals_one_by_one():
    _, t, data = filled("lsh", seed=3)
    pairs = [(td(q), s) for q, s in zip(data[100:120], range(1, 21))]
    many = t.similar_row_from_datum_many(pairs)
    assert many == [t.similar_row_from_datum(q, s) for q, s in pairs]


def test_queries_on_an_empty_or_tiny_table():
    cfg = config("lsh")
    j, t = JNN(cfg), TNN(cfg, device="cpu")
    q = rows(4, 1)[0]
    assert t.similar_row_from_datum(td(q), 5) == [] == \
        j.similar_row_from_datum(jd(q), 5)
    assert t.similar_row_from_datum_many([(td(q), 5)]) == [[]]
    with pytest.raises(KeyError):
        t.similar_row_from_id("nope", 3)
    for i, d in enumerate(rows(5, 3)):
        j.set_row(f"x{i}", jd(d))
        t.set_row(f"x{i}", td(d))
    assert t.similar_row_from_datum(td(q), 50) == \
        j.similar_row_from_datum(jd(q), 50)
    assert len(t.similar_row_from_datum(td(q), 50)) == 3
    assert t.similar_row_from_id("x1", 0) == []


def test_empty_datum_row():
    """An empty datum signs as JAX's: all ones for lsh, slot 0 for
    minhash."""
    for method in ("lsh", "minhash"):
        j, t = JNN(config(method)), TNN(config(method), device="cpu")
        j.set_row("e", JDatum())
        t.set_row("e", TDatum())
        assert j.pack()["sig"] == t.pack()["sig"]


# A datum whose projection onto hash 35 lies within an ulp of zero: its
# last value was moved by ulps until XLA's two summation orders (eight
# lanes at one datum, k order in a padded batch; ops/lsh.py
# projection_order) gave it opposite signs under the default seed.
BOUNDARY = [
    ("f953", -1.3442145586013794), ("f585", -0.45761576294898987),
    ("f511", -1.9012227058410645), ("f931", -1.289537787437439),
    ("f56", -1.8417350053787231), ("f228", -0.23509113490581512),
    ("f5", -1.267446517944336), ("f786", 0.27126434445381165),
    ("f840", 0.15675108134746552), ("f290", -0.18693093955516815),
    ("f907", -2.5167596340179443), ("f305", -0.5386928915977478),
    ("f846", -0.048500943928956985), ("f631", 0.11330898851156235),
    ("f891", -1.5301357507705688), ("f691", 6.629077434539795)]


@pytest.mark.parametrize("method", ("lsh", "euclid_lsh"))
def test_each_route_signs_in_the_jax_drivers_order(method):
    """The JAX driver signs set_row and a single datum read at one datum
    and pads set_row_many and the *_many reads to round_b (at least 8),
    so one datum near a decision boundary stores and queries different
    bits by route; the port signs each route as the JAX driver does, a
    lone set_row_many and a lone *_many read included."""
    j, t = JNN(config(method)), TNN(config(method), device="cpu")
    for drv, mk in ((j, jd), (t, td)):
        drv.set_row("one", mk(BOUNDARY))
        drv.set_row_many([("many1", mk(BOUNDARY))])
        drv.set_row_many([("many2", mk(BOUNDARY)),
                          ("short", mk(BOUNDARY[:3]))])
    jp, tp = j.pack(), t.pack()
    sigs = np.frombuffer(jp["sig"], np.uint32).reshape(-1, 2)
    assert sigs[j.ids["one"]][1] != sigs[j.ids["many1"]][1]
    assert jp["sig"] == tp["sig"] and jp["norms"] == tp["norms"]
    for size in (2, 4):
        assert_same_results(method, j.similar_row_from_datum(jd(BOUNDARY),
                                                             size),
                            t.similar_row_from_datum(td(BOUNDARY), size))
        for n in (1, 2):
            reads = [(BOUNDARY, size), (BOUNDARY[:3], 3)][:n]
            ja = j.neighbor_row_from_datum_many([(jd(q), s) for q, s in reads])
            ta = t.neighbor_row_from_datum_many([(td(q), s) for q, s in reads])
            for a, b in zip(ja, ta):
                assert_same_results(method, a, b)
    assert j.similar_row_from_datum(jd(BOUNDARY), 1)[0][0] == "one"
    assert j.similar_row_from_datum_many([(jd(BOUNDARY), 1)])[0][0][0] == \
        "many1"


@pytest.mark.parametrize("method", METHODS)
def test_mix_algebra_across_packages(method):
    """Diffs of each package, mixed by either package's mix, applied by
    either package's put_diff, give the same tables."""
    cfg = config(method)
    js = [JNN(cfg), JNN(cfg)]
    ts = [TNN(cfg, device="cpu"), TNN(cfg, device="cpu")]
    for s, (jdrv, tdrv) in enumerate(zip(js, ts)):
        for i, d in enumerate(rows(10 + s, 20)):
            jdrv.set_row(f"s{s}_{i % 15}", jd(d))
            tdrv.set_row(f"s{s}_{i % 15}", td(d))
    jdiffs = [d.get_diff() for d in js]
    tdiffs = [d.get_diff() for d in ts]
    assert [enc("jax", d) for d in jdiffs] == [enc("port", d) for d in tdiffs]
    jm = JNN.mix(jdiffs[0], jdiffs[1])
    tm = TNN.mix(tdiffs[0], tdiffs[1])
    assert enc("jax", jm) == enc("port", tm)
    # each package applies the other's merged diff, as put_diff receives
    # it from the wire
    for d in js:
        d.put_diff(tdur.CODECS["jax"].decode(
            msgpack.unpackb(enc("port", tm), raw=False)))
    for d in ts:
        d.put_diff(tdur.CODECS["port"].decode(
            msgpack.unpackb(enc("jax", jm), raw=False), "cpu"))
    for jdrv, tdrv in zip(js, ts):
        assert enc("jax", jdrv.pack()) == enc("port", tdrv.pack())
        assert jdrv._pending == tdrv._pending == {}
    # rows written between get_diff and put_diff survive to the next round
    t = ts[0]
    t.get_diff()
    t.set_row("late", td(rows(20, 1)[0]))
    t.put_diff({"rows": {}, "weights": t.converter.weights.get_diff()})
    assert list(t._pending) == ["late"]


def test_get_status_reports_the_store():
    _, t, _ = filled("minhash")
    st = t.get_status()
    assert st["method"] == "minhash" and st["hash_num"] == "64"
    assert st["num_rows"] == "150" and st["query_tier"] == "cpu"
    assert st["page_rows"] == "128" and st["paged_rows"] == "150"
    assert st["paged_free_slots"] == "0" and st["pages"] == "2"


# ---------------------------------------------------------------------------
# the paged row store
# ---------------------------------------------------------------------------

def _stores(page_rows=4, cap=8):
    cols = {"sig": ((2,), np.uint32), "norms": ((), np.float32)}
    j = JStore(cols, capacity=cap, spec=JSpec(page_rows=page_rows))
    t = TStore(cols, capacity=cap, device=torch.device("cpu"),
               spec=TSpec(page_rows=page_rows))
    return j, t


def test_store_slots_and_growth_as_jax():
    j, t = _stores()
    rng = np.random.default_rng(0)
    for step in range(6):
        n = int(rng.integers(1, 9))
        a, b = j.alloc(n), t.alloc(n)
        np.testing.assert_array_equal(a, b)
        sig = rng.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(
            np.uint32)
        nrm = rng.random(n).astype(np.float32)
        j.write(a, {"sig": sig, "norms": nrm})
        t.write(b, {"sig": sig, "norms": nrm})
        assert (j.capacity, j.n_pages, j.n_rows) == \
            (t.capacity, t.n_pages, t.n_rows)
        live = np.nonzero(j.mask_host())[0]
        np.testing.assert_array_equal(live, np.arange(t.n_rows))
        np.testing.assert_array_equal(j.read("sig", live),
                                      t.read("sig", live))
        assert j.get_status() == t.get_status()
    np.testing.assert_array_equal(j.pack_flat("norms", live, 64),
                                  t.pack_flat("norms", live, 64))
    j.clear(8)
    t.clear(8)
    assert (j.capacity, j.n_rows) == (t.capacity, t.n_rows) == (8, 0)


@pytest.mark.parametrize("cap, n", [(300, 700), (128, 129), (8, 1)])
def test_alloc_seq_is_alloc1_n_times(cap, n):
    """The driver's bulk allocation gives the slots and the capacity of
    the JAX driver's one alloc1 per new row (a store of 3 pages doubles
    to 6 and 12, where one alloc(n) would jump to a power of two)."""
    j, t = _stores(page_rows=128, cap=cap)
    j.alloc(3)
    t.alloc(3)
    want = [j.alloc1() for _ in range(n)]
    np.testing.assert_array_equal(t.alloc_seq(n), want)
    assert (t.capacity, t.n_pages, t.n_rows) == \
        (j.capacity, j.n_pages, j.n_rows)


def test_store_write_wants_unique_slots():
    _, t = _stores()
    slots = t.alloc(2)
    with pytest.raises(ValueError, match="unique"):
        t.write([slots[0], slots[0]], {"norms": np.ones(2, np.float32)})


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_the_spill_tier_boots_and_reads_as_jax():
    """The spill tier (Queue 1 item 5.4) is served now: the config the
    port refused boots, and with four times its budget written its reads
    on every route equal the JAX spilled driver's, bitwise."""
    cfg = dict(config("lsh"), pages={"page_rows": 32, "resident_pages": 2})
    j, t = JNN(cfg), TNN(cfg, device="cpu")
    rng = np.random.default_rng(3)
    for i in range(256):
        v = rng.standard_normal(6)
        jd, td = JDatum(), TDatum()
        for k, x in enumerate(v):
            jd.add_number(f"f{k}", float(x))
            td.add_number(f"f{k}", float(x))
        j.set_row(f"r{i}", jd)
        t.set_row(f"r{i}", td)
    assert t.pages.resident_pages_now == 2
    for i in ("r0", "r100", "r255"):
        assert j.similar_row_from_id(i, 8) == t.similar_row_from_id(i, 8)
        assert j.neighbor_row_from_id(i, 8) == t.neighbor_row_from_id(i, 8)
    q = rng.standard_normal(6)
    jd, td = JDatum(), TDatum()
    for k, x in enumerate(q):
        jd.add_number(f"f{k}", float(x))
        td.add_number(f"f{k}", float(x))
    assert j.similar_row_from_datum(jd, 8) == t.similar_row_from_datum(td, 8)
    assert j.neighbor_row_from_datum_many([(jd, 5), (jd, 9)]) == \
        t.neighbor_row_from_datum_many([(td, 5), (td, 9)])


def test_the_index_is_refused_with_its_item(tmp_path, capsys):
    """The sublinear index (Queue 1 item 5.3) is served now: --index
    lsh_probe starts a server with the index engaged, and the CLI refuses
    only a kind it does not know, naming the kinds it has."""
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(config("lsh")))
    args = ["--type", "nearest_neighbor", "--configpath", str(path),
            "--rpc-port", "0", "--listen_addr", "127.0.0.1", "--device",
            "cpu", "--index"]
    with pytest.raises(SystemExit):
        serve(args + ["sublinear"])
    err = capsys.readouterr().err
    assert "invalid choice: 'sublinear'" in err
    assert all(k in err for k in ("off", "lsh_probe", "ivf"))
    srv, rpc = serve(args + ["lsh_probe"])
    try:
        assert next(iter(srv.get_status().values()))["index"] == "lsh_probe"
    finally:
        rpc.stop()
        srv.stop()


# ---------------------------------------------------------------------------
# the server over the wire, against the JAX server
# ---------------------------------------------------------------------------

def wire(nums):
    return datum_wire(nums=nums)


@pytest.fixture(params=METHODS)
def nn_pair(request, tmp_path):
    for p in _pair(tmp_path, config(request.param), "nearest_neighbor"):
        yield request.param, p


def test_wire_session_answers_alike(nn_pair):
    method, (conns, _, _) = nn_pair
    data = rows(30, 80)
    for i, d in enumerate(data[:60]):
        assert [c.call("set_row", f"w{i % 50}", wire(d)) for c in conns] \
            == [True, True]
    for q in data[60:70]:
        for m in ("similar_row_from_datum", "neighbor_row_from_datum"):
            a, b = [c.call(m, wire(q), 10) for c in conns]
            assert_same_results(method, [tuple(x) for x in a],
                                [tuple(x) for x in b])
    for rid in ("w0", "w13", "w49"):
        for m in ("similar_row_from_id", "neighbor_row_from_id"):
            a, b = [c.call(m, rid, 10) for c in conns]
            assert_same_results(method, [tuple(x) for x in a],
                                [tuple(x) for x in b])
    a, b = [c.call("get_all_rows") for c in conns]
    assert a == b and len(a) == 50
    st = [next(iter(c.call("get_status").values())) for c in conns]
    for k in ("method", "num_rows", "hash_num", "page_rows", "pages",
              "paged_rows", "paged_free_slots"):
        assert st[0][k] == st[1][k], k
    assert st[1]["query_tier"] == "cpu"
    assert st[1]["kernel_launches.sig_topk"] == "0"


def test_model_files_cross_packages(nn_pair):
    method, (conns, (jsrv, tsrv), _) = nn_pair
    data = rows(31, 40)
    for i, d in enumerate(data[:30]):
        conns[0].call("set_row", f"m{i}", wire(d))
    (jpath,) = conns[0].call("save", "x").values()
    os.replace(jpath, tsrv._model_path("x"))
    assert conns[1].call("load", "x") is True
    for q in data[30:35]:
        a, b = [c.call("similar_row_from_datum", wire(q), 8) for c in conns]
        assert_same_results(method, [tuple(x) for x in a],
                            [tuple(x) for x in b])
    # and back: the port's file loads in the JAX server
    conns[1].call("set_row", "extra", wire(data[36]))
    (tpath,) = conns[1].call("save", "y").values()
    os.replace(tpath, jsrv._model_path("y"))
    assert conns[0].call("load", "y") is True
    assert conns[0].call("get_all_rows") == conns[1].call("get_all_rows")
    for m, arg in (("similar_row_from_id", "extra"),
                   ("neighbor_row_from_datum", wire(data[37]))):
        a, b = [c.call(m, arg, 8) for c in conns]
        assert_same_results(method, [tuple(x) for x in a],
                            [tuple(x) for x in b])


def test_read_lane_answers_as_reads_sent_alone(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(config("lsh")))
    srv, rpc = serve(["--type", "nearest_neighbor", "--configpath",
                      str(path), "--rpc-port", "0", "--listen_addr",
                      "127.0.0.1", "--device", "cpu",
                      "--read_batch_window_us", "20000"])
    try:
        port = srv.args.rpc_port
        data = rows(40, 140)
        setter = GoldenConn(port)
        for i, d in enumerate(data[:100]):
            setter.call("set_row", f"l{i}", wire(d))
        want = {i: [[r, s] for r, s in srv.driver.similar_row_from_datum(
            td(data[100 + i]), 7)] for i in range(16)}
        got = {}
        conns = [GoldenConn(port) for _ in range(16)]
        start = threading.Barrier(16, timeout=60)

        def read(i):
            start.wait()             # every read in flight at once
            got[i] = conns[i].call("similar_row_from_datum",
                                   wire(data[100 + i]), 7)
            conns[i].close()

        threads = [threading.Thread(target=read, args=(i,))
                   for i in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert got == want
        st = next(iter(setter.call("get_status").values()))
        assert float(st["read_batch_size_max"]) > 1
        setter.close()
    finally:
        rpc.stop()
        srv.stop()


# ---------------------------------------------------------------------------
# journals across packages
# ---------------------------------------------------------------------------

NN_CFG = config("lsh")


def nn_server(pkg, dirpath):
    base = tdur.SERVER_BASES[pkg]
    kw = {"device": "cpu"} if pkg == "port" else {}
    args = base.ServerArgs(type="nearest_neighbor", name="t",
                           journal_dir=str(dirpath), journal_fsync="always",
                           snapshot_interval_sec=0.0, **kw)
    srv = base.JubatusServer(args, config=json.dumps(NN_CFG))
    srv.init_durability()
    return srv


def set_row_u(pkg, srv, rid, nums):
    """Apply and journal one set_row the way the update handler does."""
    args = [rid, wire(nums)]
    with srv.model_lock.write():
        tdur.SERVICE_TABLES[pkg]["nearest_neighbor"].methods["set_row"].fn(
            srv, *args)
        srv.event_model_updated()
        srv.journal.append({"k": "u", "m": "set_row", "a": args},
                           srv.current_mix_round())
    srv.journal.commit()


def nn_diff_payload(pkg, data, round_):
    donor = (JNN(NN_CFG) if pkg == "jax" else TNN(NN_CFG, device="cpu"))
    for i, d in enumerate(data):
        donor.set_row(f"d{i}", jd(d) if pkg == "jax" else td(d))
    body = tdur.CODECS[pkg].encode(donor.get_diff())
    return msgpack.unpackb(msgpack.packb(
        {"protocol_version": 2, "round": round_, "diff": body},
        use_bin_type=True), raw=False)


@pytest.mark.parametrize("snapshot", [False, True])
@pytest.mark.parametrize("writer, reader", [("jax", "port"),
                                            ("port", "jax")])
def test_a_journal_directory_recovers_in_the_other_package(
        tmp_path, writer, reader, snapshot):
    data = rows(50, 30)
    srv = nn_server(writer, tmp_path / "dur")
    for i, d in enumerate(data[:8]):
        set_row_u(writer, srv, f"a{i}", d)
    srv.clear()
    for i, d in enumerate(data[8:16]):
        set_row_u(writer, srv, f"b{i % 5}", d)
    tdur.put_diff_record(writer, srv,
                         nn_diff_payload(writer, data[16:24], 1), 1)
    if snapshot:
        srv.snapshotter.snapshot_now()
    for i, d in enumerate(data[24:]):
        set_row_u(writer, srv, f"c{i}", d)
    at_crash = msgpack.packb(srv.driver.pack(), use_bin_type=True)
    srv.journal.close()
    os.remove(tmp_path / "dur" / "LOCK")
    shutil.copytree(tmp_path / "dur", tmp_path / "other")
    other = nn_server(reader, tmp_path / "other")
    try:
        ri = other.recovery_info
        assert ri.errors == 0 and ri.restored == snapshot
        assert msgpack.packb(other.driver.pack(), use_bin_type=True) == \
            at_crash
    finally:
        tdur.shut(reader, other)


def test_the_cli_serves_nearest_neighbor_on_cpu(tmp_path):
    """python -m jubatus_tpu_torch.cli.server --type nearest_neighbor
    --device cpu, as a process: set_row and a read, then SIGTERM."""
    import signal

    from tests.test_torch_server import _cli
    proc = _cli(tmp_path, "cpu", config("minhash"), "nearest_neighbor")
    try:
        line = proc.stdout.readline()
        assert line.startswith("jubatus ready rpc_port="), line
        conn = GoldenConn(int(line.split()[2].split("=")[1]))
        data = rows(70, 3)
        for i, d in enumerate(data):
            assert conn.call("set_row", f"c{i}", wire(d), name="") is True
        out = conn.call("similar_row_from_id", "c1", 2, name="")
        assert out[0] == ["c1", 1.0] and len(out) == 2
        conn.close()
        proc.send_signal(signal.SIGTERM)
        proc.communicate(timeout=60)
        assert proc.returncode == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
