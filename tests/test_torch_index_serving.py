"""The sublinear index in anomaly's reads and in the port's server
(jubatus_tpu_torch/models/anomaly.py, framework/server_base.py,
cli/server.py) against the JAX package's, on the CPU: anomaly's indexed
calc_score and calc_score_many bitwise the JAX driver's after the same
adds (==), the server's --index at boot (a kind that does not fit is
declined with index=off), over the wire (every read bitwise a JAX driver
with the same index and writes; the get_status index keys), and the
CLI's refusal of an unknown kind.  Helpers: tests/test_torch_index.py.
"""

import json

import numpy as np
import pytest

from jubatus_tpu.fv import Datum as JDatum
from jubatus_tpu.models import create_driver as jcreate
from jubatus_tpu_torch.fv import Datum as TDatum
from tests.test_torch_index import (CONV, FLOOR, _cfg, _clustered, _full,
                                    _pair, _queries, _vec)


@pytest.mark.parametrize("method", ["light_lof", "lof"])
def test_anomaly_scores_equal_jax(method):
    cfg = {"method": method,
           "parameter": {"nearest_neighbor_num": 6,
                         "method": "euclid_lsh",
                         "parameter": {"hash_num": 64}},
           "converter": CONV}
    rng = np.random.default_rng(17)
    j, t = _pair("anomaly", cfg, "lsh_probe", min_rows=0)
    centers, data = _clustered(rng, n_centers=8, n=64, jitter=0.05)
    for i, d in enumerate(data):
        a = j.add(f"r{i}", JDatum([], d))
        assert a == t.add(f"r{i}", TDatum([], d))
    qs = [_vec(centers[i % 8] + 0.05 * rng.standard_normal(8))
          for i in range(10)]
    hits = 0
    for q in qs:
        b = t.calc_score(TDatum([], q))
        assert j.calc_score(JDatum([], q)) == b
        hits += abs(_full(t, lambda: t.calc_score(TDatum([], q))) - b) \
            < 1e-9
    assert hits / len(qs) >= FLOOR
    assert j.calc_score_many([JDatum([], q) for q in qs[:5]]) == \
        t.calc_score_many([TDatum([], q) for q in qs[:5]])
    j.clear_row("r3")
    t.clear_row("r3")
    assert j.calc_score(JDatum([], data[3])) == \
        t.calc_score(TDatum([], data[3]))


def test_the_server_configures_the_index_at_boot(caplog):
    from jubatus_tpu_torch.framework.server_base import (JubatusServer,
                                                         ServerArgs)
    for kind, method, engaged in (("lsh_probe", "lsh", True),
                                  ("ivf", "inverted_index", True),
                                  ("ivf", "lsh", False),
                                  ("off", "lsh", False)):
        args = ServerArgs(type="recommender", device="cpu", index=kind,
                          index_probes=6)
        srv = JubatusServer(args, config=json.dumps(_cfg(method)))
        try:
            st = next(iter(srv.get_status().values()))
            assert st["index"] == (kind if engaged else "off")
            assert st["index_probes"] == "6"
            assert ("index_live_rows" in st) == engaged
            if engaged:
                assert srv.driver.index.spec.probes == 6
        finally:
            srv.stop()
    assert any("does not fit" in r.getMessage() for r in caplog.records)


@pytest.mark.parametrize("embed_dim,engaged", [
    (1, True), (2, True), (4, True), (8, True), (16, True), (32, True),
    (64, True), (128, True), (256, True), (512, True), (1024, True),
    (2048, True), (4096, True), (8192, True), (131072, True),
    (1 << 31, False)])
def test_ivf_engages_at_every_embed_dim_k7_holds(
        tmp_path, caplog, embed_dim, engaged):
    """Every "index" embed_dim K7 takes (a power of two from 1 to 2^30)
    engages ivf when the server boots, and its reads equal a JAX driver's
    with the index engaged, bitwise.  A wider one (2^31) declines ivf with
    the warning, which names the memory reason, and index=off; its reads
    serve the full sweep, equal to a JAX driver's without the index, and
    never fail at read time."""
    from jubatus_tpu_torch.cli.server import serve
    from tests.test_wire_golden import GoldenConn, datum_wire
    cfg = _cfg("inverted_index", min_rows=0, embed_dim=embed_dim)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    srv, rpc = serve(["--type", "recommender", "--configpath", str(path),
                      "--rpc-port", "0", "--listen_addr", "127.0.0.1",
                      "--datadir", str(tmp_path), "--device", "cpu",
                      "--index", "ivf"])
    conn = GoldenConn(srv.args.rpc_port)
    j = jcreate("recommender", cfg)
    if engaged:
        assert j.configure_index("ivf", probes=4)
    try:
        st = next(iter(srv.get_status().values()))
        assert st["index"] == ("ivf" if engaged else "off")
        assert any("does not fit" in r.getMessage()
                   for r in caplog.records) != engaged
        assert any("16 GiB of float64 a row" in r.getMessage()
                   for r in caplog.records) != engaged
        rng = np.random.default_rng(23)
        centers, data = _clustered(rng, n=40)
        for i, d in enumerate(data):
            assert conn.call("update_row", f"r{i}", datum_wire(nums=d))
            j.update_row(f"r{i}", JDatum([], d))
        for q in _queries(rng, centers, n=3):
            got = conn.call("similar_row_from_datum", datum_wire(nums=q), 5)
            want = j.similar_row_from_datum(JDatum([], q), 5)
            assert [(i, s) for i, s in got] == [(i, s) for i, s in want]
        st = next(iter(conn.call("get_status").values()))
        assert st["index"] == ("ivf" if engaged else "off")
        assert st.get("index_live_rows") == ("40" if engaged else None)
    finally:
        conn.close()
        rpc.stop()
        srv.stop()


@pytest.mark.parametrize("service,method,kind", [
    ("nearest_neighbor", "lsh", "lsh_probe"),
    ("recommender", "inverted_index", "ivf"),
    ("recommender", "minhash", "lsh_probe")])
def test_the_server_serves_indexed_reads_over_the_wire(tmp_path, service,
                                                       method, kind):
    """A port server started with --index answers the reads of a JAX
    driver holding the same index and the same writes, bitwise; its
    get_status shows the index keys."""
    from jubatus_tpu_torch.cli.server import serve
    from tests.test_wire_golden import GoldenConn, datum_wire
    cfg = _cfg(method, min_rows=0)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    srv, rpc = serve(["--type", service, "--configpath", str(path),
                      "--rpc-port", "0", "--listen_addr", "127.0.0.1",
                      "--name", "wiretest", "--datadir", str(tmp_path),
                      "--device", "cpu", "--index", kind,
                      "--index_probes", "4"])
    conn = GoldenConn(srv.args.rpc_port)
    j = jcreate(service, cfg)
    assert j.configure_index(kind, probes=4)
    write = "update_row" if service == "recommender" else "set_row"
    try:
        rng = np.random.default_rng(21)
        centers, data = _clustered(rng, n=80)
        for i, d in enumerate(data):
            assert conn.call(write, f"r{i}", datum_wire(nums=d)) is True
            getattr(j, write)(f"r{i}", JDatum([], d))
        for q in _queries(rng, centers, n=6):
            got = conn.call("similar_row_from_datum", datum_wire(nums=q), 7)
            want = j.similar_row_from_datum(JDatum([], q), 7)
            assert [(i, s) for i, s in got] == [(i, s) for i, s in want]
        got = conn.call("similar_row_from_id", "r5", 6)
        assert [(i, s) for i, s in got] == j.similar_row_from_id("r5", 6)
        st = next(iter(conn.call("get_status").values()))
        assert st["index"] == kind and st["index_probes"] == "4"
        assert int(st["index_live_rows"]) == 80
        assert float(st["index_probe_total"]) >= 7
        assert int(st["index_needs_rebuild"]) == 0
    finally:
        conn.close()
        rpc.stop()
        srv.stop()


def test_the_cli_refuses_an_unknown_kind(tmp_path, capsys):
    from jubatus_tpu_torch.cli.server import serve
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(_cfg("lsh")))
    base = ["--type", "nearest_neighbor", "--configpath", str(path),
            "--rpc-port", "0", "--listen_addr", "127.0.0.1", "--device",
            "cpu"]
    with pytest.raises(SystemExit):
        serve(base + ["--index", "bogus"])
    assert "invalid choice: 'bogus'" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        serve(base + ["--index", "lsh_probe", "--index_probes", "0"])
    # ivf does not fit a signature method: declined, the full sweep serves
    srv, rpc = serve(base + ["--index", "ivf"])
    try:
        st = next(iter(srv.get_status().values()))
        assert st["index"] == "off" and "index_live_rows" not in st
    finally:
        rpc.stop()
        srv.stop()
