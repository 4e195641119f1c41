"""The recommender and anomaly services of the port over the wire and on
disk (--device cpu), against the JAX package's:

- a JAX server and a port server take the same requests and answer them
  alike, bitwise: update_row / clear_row and every recommender read;
  anomaly's add (server-minted ids), update, overwrite, clear_row,
  calc_score and its partition leg calc_score_partial; a model saved by
  either loads in the other;
- the read lane (--read_batch_window_us) answers each fused read as the
  read sent alone;
- an anomaly server's journal (its `drv` add records) recovers bitwise
  after SIGKILL, either package recovers the other's directory, and a
  recovered standalone server mints its next id above every recovered
  id, which it does not without the id watermark.
"""

import json
import signal
import sys
import threading

import msgpack
import numpy as np
import pytest

from jubatus_tpu.framework import server_base as jserver_base
from jubatus_tpu.framework import service as jservice
from jubatus_tpu.fv import Datum as JDatum
from jubatus_tpu_torch.durability import recovery as trecovery
from jubatus_tpu_torch.framework import server_base as tserver_base
from jubatus_tpu_torch.framework import service as tservice
from jubatus_tpu_torch.fv import Datum as TDatum
from tests.test_torch_cluster_mixed import Proc, call
from tests.test_torch_server import _pair
from tests.test_wire_golden import datum_wire

RECO_CFG = {"method": "inverted_index",
            "parameter": {},
            "converter": {"num_rules": [{"key": "*", "type": "num"}],
                          "string_rules": [{"key": "*", "type": "str",
                                            "sample_weight": "bin",
                                            "global_weight": "bin"}],
                          "hash_max_size": 1 << 11}}
RECO_LSH_CFG = dict(RECO_CFG, method="lsh", parameter={"hash_num": 64})
ANOM_CFG = {"method": "lof",
            "parameter": {"nearest_neighbor_num": 4,
                          "reverse_nearest_neighbor_num": 10,
                          "method": "euclid_lsh",
                          "parameter": {"hash_num": 64}},
            "converter": {"num_rules": [{"key": "*", "type": "num"}],
                          "hash_max_size": 1 << 11}}
ANOM_EXACT_CFG = dict(ANOM_CFG, parameter=dict(
    ANOM_CFG["parameter"], method="inverted_index_euclid"))


def datums(seed, n, keys=150):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ks = rng.choice(keys, int(rng.integers(2, 9)), replace=False)
        out.append(datum_wire(
            strings=[("tag", f"t{int(rng.integers(0, 4))}")],
            nums=[(f"f{k}", float(v)) for k, v in
                  zip(ks, rng.standard_normal(len(ks)))]))
    return out


def both(conns, method, *args):
    out = [c.call(method, *args) for c in conns]
    assert out[0] == out[1], (method, out)
    return out[0]


@pytest.fixture(params=[RECO_CFG, RECO_LSH_CFG], ids=["inverted", "lsh"])
def reco_pair(tmp_path, request):
    yield from _pair(tmp_path, request.param, "recommender")


def test_recommender_wire_answers_as_jax(reco_pair, tmp_path):
    conns, servers, _ = reco_pair
    for i, d in enumerate(datums(1, 40)):
        both(conns, "update_row", f"r{i % 30}", d)
        if i % 7 == 3:
            both(conns, "clear_row", f"r{i - 2}")
    for q in datums(2, 4):
        both(conns, "similar_row_from_datum", q, 8)
        both(conns, "complete_row_from_datum", q)
        both(conns, "calc_l2norm", q)
        both(conns, "calc_similarity", q, datums(3, 1)[0])
    for i in ("r1", "r5", "r29", "missing"):
        both(conns, "similar_row_from_id", i, 6)
        both(conns, "decode_row", i)
        both(conns, "complete_row_from_id", i)
    assert sorted(both(conns, "get_all_rows"))
    assert all(c.call("save", "m1") for c in conns)   # {server_id: path}
    # each server loads the model file the other saved
    jpath, tpath = (s._model_path("m1") for s in servers)
    data = [open(p, "rb").read() for p in (jpath, tpath)]
    open(jpath, "wb").write(data[1])
    open(tpath, "wb").write(data[0])
    assert both(conns, "load", "m1")
    q = datums(4, 1)[0]
    both(conns, "similar_row_from_datum", q, 8)


@pytest.mark.parametrize("cfg", [ANOM_CFG, ANOM_EXACT_CFG],
                         ids=["euclid_lsh", "exact"])
def test_anomaly_wire_answers_as_jax(tmp_path, cfg):
    gen = _pair(tmp_path, cfg, "anomaly")
    conns, servers, _ = next(gen)
    try:
        ids = [both(conns, "add", d)[0] for d in datums(5, 25)]
        assert ids == [str(i) for i in range(1, 26)]
        both(conns, "update", "3", datums(6, 1)[0])
        both(conns, "overwrite", "4", datums(7, 1)[0])
        assert both(conns, "clear_row", "5") is True
        for q in datums(8, 5):
            both(conns, "calc_score", q)
        assert both(conns, "get_all_rows") == \
            [i for i in ids if i != "5"]
        for q in datums(8, 5):
            both(conns, "calc_score_partial", q)
    finally:
        next(gen, None)


def test_the_read_lane_answers_as_the_read_alone(tmp_path):
    """32 concurrent calc_score reads through the lane against the same
    reads sent one at a time; similar_row_from_datum likewise."""
    from jubatus_tpu_torch.cli.server import serve
    from jubatus_tpu_torch.rpc.client import Client
    out = {}
    for service, cfg, method, extra in (
            ("anomaly", ANOM_CFG, "calc_score", ()),
            ("recommender", RECO_LSH_CFG, "similar_row_from_datum", (5,))):
        path = tmp_path / f"{service}.json"
        path.write_text(json.dumps(cfg))
        srv, rpc = serve(["--type", service, "--configpath", str(path),
                          "--rpc-port", "0", "--listen_addr", "127.0.0.1",
                          "--device", "cpu", "--datadir", str(tmp_path),
                          "--read_batch_window_us", "20000"])
        port = srv.args.rpc_port
        try:
            with Client("127.0.0.1", port, name="", timeout=60) as c:
                for i, d in enumerate(datums(9, 30)):
                    if service == "anomaly":
                        c.call_raw("add", "", d)
                    else:
                        c.call_raw("update_row", "", f"r{i}", d)
                qs = datums(10, 32)
                alone = [c.call_raw(method, "", q, *extra) for q in qs]
            got = [None] * len(qs)

            def one(i):
                with Client("127.0.0.1", port, name="", timeout=60) as cc:
                    got[i] = cc.call_raw(method, "", qs[i], *extra)

            ts = [threading.Thread(target=one, args=(i,))
                  for i in range(len(qs))]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            assert got == alone
            st = next(iter(call(port, "get_status", "").values()))
            out[service] = float(st["read_batch_size_max"])
        finally:
            rpc.stop()
            srv.stop()
    assert max(out.values()) > 1


# ---------------------------------------------------------------------------
# durability
# ---------------------------------------------------------------------------

BASES = {"jax": jserver_base, "port": tserver_base}
DATUMS = {"jax": JDatum, "port": TDatum}
ADDS = {"jax": jservice._anomaly_add, "port": tservice._anomaly_add}


def anomaly_server(pkg, dirpath, **kw):
    base = BASES[pkg]
    kw.setdefault("journal_fsync", "always")
    kw.setdefault("snapshot_interval_sec", 0.0)
    if pkg == "port":
        kw.setdefault("device", "cpu")
    srv = base.JubatusServer(
        base.ServerArgs(type="anomaly", name="t", journal_dir=str(dirpath),
                        **kw), config=json.dumps(ANOM_CFG))
    srv.init_durability()
    return srv


def shut(pkg, srv):
    if pkg == "jax":
        srv.shutdown_durability()
    else:
        srv.stop()


def packed(srv) -> bytes:
    return msgpack.packb(srv.driver.pack(), use_bin_type=True)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
def test_an_anomaly_directory_recovers_in_either_package(
        tmp_path, writer, reader):
    """Adds journaled as `drv` records, a snapshot between them, more
    adds: the other package (or the same) recovers the directory to the
    same model and the same scores, and its next id is above them all."""
    w = anomaly_server(writer, tmp_path / "dur")
    ds = datums(11, 12)
    ids = [ADDS[writer](w, d)[0] for d in ds[:7]]
    w.snapshotter.snapshot_now()
    ids += [ADDS[writer](w, d)[0] for d in ds[7:]]
    want = packed(w)
    q = datums(12, 3)
    scores = [w.driver.calc_score(DATUMS[writer].from_msgpack(x)) for x in q]
    shut(writer, w)
    r = anomaly_server(reader, tmp_path / "dur")
    try:
        assert packed(r) == want
        assert r.recovery_info.errors == 0
        assert [r.driver.calc_score(DATUMS[reader].from_msgpack(x))
                for x in q] == scores
        nxt = ADDS[reader](r, datums(13, 1)[0])[0]
        assert int(nxt) > max(int(i) for i in ids)
    finally:
        shut(reader, r)


def test_without_the_watermark_a_recovered_server_mints_an_id_twice(
        tmp_path, monkeypatch):
    w = anomaly_server("port", tmp_path / "dur")
    first = ADDS["port"](w, datums(14, 1)[0])[0]
    ADDS["port"](w, datums(15, 1)[0])
    shut("port", w)
    monkeypatch.setattr(trecovery, "_record_id_watermark", lambda rec: 0)
    r = anomaly_server("port", tmp_path / "dur")
    try:
        # the counter restarts at 0: the fresh add reuses the first id
        # and overwrites that row
        assert ADDS["port"](r, datums(16, 1)[0])[0] == first
    finally:
        shut("port", r)


def test_a_sigkilled_anomaly_server_recovers_bitwise(tmp_path):
    """A CLI anomaly server with --journal takes adds over the wire and is
    SIGKILLed; the restarted server holds the model of an in-process
    driver fed the same adds, and mints the next id above them."""
    from jubatus_tpu_torch.fv import Datum
    from jubatus_tpu_torch.models.anomaly import AnomalyDriver
    cfg = tmp_path / "anom.json"
    cfg.write_text(json.dumps(ANOM_CFG))
    argv = [sys.executable, "-m", "jubatus_tpu_torch.cli.server",
            "--type", "anomaly", "--configpath", str(cfg), "--rpc-port",
            "0", "--listen_addr", "127.0.0.1", "--device", "cpu",
            "--datadir", str(tmp_path), "--journal", str(tmp_path / "dur"),
            "--journal_fsync", "batch", "--snapshot_interval", "0"]
    p = Proc(argv)
    try:
        port = int(p.wait_for("jubatus ready").split()[2].split("=")[1])
        ds = datums(17, 10)
        ids = [call(port, "add", "", d)[0] for d in ds]
    finally:
        p.p.send_signal(signal.SIGKILL)
        p.p.wait(timeout=30)
    twin = AnomalyDriver(ANOM_CFG, device="cpu")
    for i, d in zip(ids, ds):
        twin.add(i, Datum.from_msgpack(d))
    p = Proc(argv)
    try:
        port = int(p.wait_for("jubatus ready").split()[2].split("=")[1])
        assert call(port, "get_all_rows", "") == ids
        q = datums(18, 3)
        assert [call(port, "calc_score", "", x) for x in q] == \
            [twin.calc_score(Datum.from_msgpack(x)) for x in q]
        st = next(iter(call(port, "get_status", "").values()))
        assert st["recovery_errors"] == "0"
        assert int(call(port, "add", "", datums(19, 1)[0])[0]) == 11
    finally:
        p.p.send_signal(signal.SIGKILL)
        p.p.wait(timeout=30)
