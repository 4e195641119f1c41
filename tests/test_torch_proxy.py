"""The port's partition cluster over the wire, on the CPU: the port's
coordinator, port servers (`--routing partition --device cpu`, most of
them journaled) and the port's proxy (jubatus_tpu_torch/framework/
proxy.py), against a local port driver that holds every row and against
the JAX package's proxy and servers in the same cluster.

- point ops go to one owner (the servers' rows are disjoint and cover
  every id); every scatter read (the four nearest_neighbor forms, the
  recommender's from_id and from_datum, anomaly's calc_score) equals the
  local driver, scores exact and ids tie-aware (the merge breaks ties by
  id, one driver by row slot; the exact recommender equal outright); a
  missing row raises (nearest_neighbor) or answers [] (recommender);
  anomaly's two-partition score is bitwise the merge of the partitions'
  legs, its one-partition score bitwise calc_score;
- a third server joins: the handoff leaves disjoint partitions that sum
  to the total, journaled at the joiner, and the reads stay exact;
- a kill -9 between ship and drop loses no row, and the restarted
  server's reconciler completes the handoff; the journal of the server
  that took the rows recovers in the JAX package to the same model;
- `strict` fails a read on a lost partition, `best_effort` serves the
  survivors' merge and counts it degraded;
- mixed clusters: the JAX proxy over port servers, and the port proxy
  over one JAX and one port server, give the port proxy's answers, ==.
"""

import json
import shutil
import sys
import time

import pytest

from jubatus_tpu.cluster.lock_service import CoordLockService as JLock
from jubatus_tpu.framework import server_base as jserver_base
from jubatus_tpu.framework.proxy import Proxy as JProxy
from jubatus_tpu_torch.cli.server import serve
from jubatus_tpu_torch.cluster.coordinator import CoordinatorServer
from jubatus_tpu_torch.framework.partition import (merge_anomaly_score,
                                                   merge_topk)
from jubatus_tpu_torch.framework.proxy import Proxy
from jubatus_tpu_torch.fv import Datum as TDatum
from jubatus_tpu_torch.models import create_driver as tcreate
from jubatus_tpu_torch.rpc.client import Client, RemoteError
from jubatus_tpu_torch.utils.metrics import GLOBAL
from tests.test_partition import partition_server as jax_partition_server
from tests.test_torch_cluster_mixed import Proc
from tests.test_torch_partition import (anomaly_cfg, canon, datum, nn_cfg,
                                        reco_cfg, tie_eq, vecs)
from tests.test_wire_golden import datum_wire

K = 8
WAIT_S = 60


def wire(v):
    return datum_wire(nums=[(f"f{k}", float(x)) for k, x in enumerate(v)])


HANDOFF_INTERVAL_S = 0.2


def wait_until(pred, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what} not within {timeout} s")
        time.sleep(0.1)


def as_str(obj):
    if isinstance(obj, bytes):
        return obj.decode()
    if isinstance(obj, dict):
        return {as_str(k): as_str(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [as_str(x) for x in obj]
    return obj


@pytest.fixture
def coord():
    c = CoordinatorServer()
    port = c.start(0, "127.0.0.1")
    yield port
    c.stop()


class Cluster:
    """Port servers of one engine behind a port proxy, in this process."""

    def __init__(self, cport, engine, cfg, tmp_path, n=2, journaled=False,
                 policy="strict"):
        self.cport, self.engine, self.tmp = cport, engine, tmp_path
        self.cfg_path = tmp_path / f"{engine}.json"
        self.cfg_path.write_text(json.dumps(cfg))
        self.journaled = journaled
        self.servers = []
        for _ in range(n):
            self.add_server()
        self.proxy = Proxy(f"127.0.0.1:{cport}", engine, membership_ttl=0.0,
                           routing="partition", partial_failure=policy,
                           retry=None, breaker_threshold=1000)
        self.pport = self.proxy.start(0, host="127.0.0.1")
        self.client = Client("127.0.0.1", self.pport, name="c", timeout=30)

    def add_server(self):
        argv = ["--type", self.engine, "--configpath", str(self.cfg_path),
                "--rpc-port", "0", "--listen_addr", "127.0.0.1", "--eth",
                "127.0.0.1", "--coordinator", f"127.0.0.1:{self.cport}",
                "--name", "c", "--device", "cpu", "--routing", "partition",
                "--interval_sec", "100000", "--interval_count", "1000000",
                "--partition_handoff_interval", str(HANDOFF_INTERVAL_S),
                "--partition_handoff_grace", "0.5"]
        if self.journaled:
            argv += ["--journal", str(self.tmp / f"j{len(self.servers)}")]
        self.servers.append(serve(argv))
        return self.servers[-1]

    def held(self):
        return [set(s.driver.partition_ids()) for s, _ in self.servers]

    def close(self):
        self.client.close()
        self.proxy.stop()
        for srv, rpc in self.servers:
            rpc.stop()
            srv.stop()


def assert_disjoint_cover(held, ids):
    seen = set()
    for rows in held:
        assert seen.isdisjoint(rows), "a row on two servers"
        seen |= rows
    assert seen == set(ids), "a row lost"


def nn_reads_equal(client, ref, queries, ids):
    for q in queries:
        for kind, asc in (("neighbor_row_from_datum", True),
                          ("similar_row_from_datum", False)):
            got = as_str(client.call(kind, wire(q), K))
            tie_eq(got, getattr(ref, kind)(datum(TDatum, q), K), asc)
    for id_ in ids:
        for kind, asc in (("neighbor_row_from_id", True),
                          ("similar_row_from_id", False)):
            got = as_str(client.call(kind, id_, K))
            tie_eq(got, getattr(ref, kind)(id_, K), asc)


def nn_answers(client, queries, ids):
    out = []
    for q in queries:
        for kind in ("neighbor_row_from_datum", "similar_row_from_datum"):
            out.append(as_str(client.call(kind, wire(q), K)))
    for id_ in ids:
        for kind in ("neighbor_row_from_id", "similar_row_from_id"):
            out.append(as_str(client.call(kind, id_, K)))
    return out


# ---------------------------------------------------------------------------
# the port's cluster
# ---------------------------------------------------------------------------

def test_nn_cluster_serves_exact_reads_and_hands_off_on_a_join(coord,
                                                               tmp_path):
    cfg = nn_cfg("lsh")
    c = Cluster(coord, "nearest_neighbor", cfg, tmp_path, journaled=True)
    try:
        ids = [f"row{i}" for i in range(40)]
        rows = vecs(40, 1)
        ref = tcreate("nearest_neighbor", cfg, device="cpu")
        for id_, v in zip(ids, rows):
            assert c.client.call("set_row", id_, wire(v)) is True
            ref.set_row(id_, datum(TDatum, v))
        assert_disjoint_cover(c.held(), ids)
        assert all(c.held())
        scatter0 = float(GLOBAL.snapshot().get("partition_scatter_total", 0))
        queries = vecs(3, 2)
        nn_reads_equal(c.client, ref, queries, ("row0", "row13", "row39"))
        assert float(GLOBAL.snapshot()["partition_scatter_total"]) > scatter0
        with pytest.raises(RemoteError, match="no such row"):
            c.client.call("similar_row_from_id", "nope", K)
        st = as_str(c.client.call("get_status"))
        assert len(st) == 2
        assert {v["routing"] for v in st.values()} == {"partition"}
        assert sum(int(v["partition_rows"]) for v in st.values()) == 40
        assert all(v["partition_range"] for v in st.values())
        (pst,) = as_str(c.client.call_raw("get_proxy_status")).values()
        assert pst["routing"] == "partition" and pst["type"] == \
            "nearest_neighbor"
        # the join: the reconcilers hand the moved ranges off
        moved0 = float(GLOBAL.snapshot().get(
            "partition_handoff_rows_total", 0))
        c.add_server()

        def covered():
            held = c.held()
            if len(held) != 3 or not all(held):
                return False
            try:
                assert_disjoint_cover(held, ids)
            except AssertionError:      # a row in flight: poll again
                return False
            return True

        def converged():
            st = as_str(c.client.call("get_status"))
            rows = [int(v["partition_rows"]) for v in st.values()]
            if not (len(rows) == 3 and sum(rows) == 40 and all(rows)) \
                    or not covered():
                return False
            # the counts can add up while one range has moved and another
            # is still between its ship and its drop: the cover must hold
            # on two polls more than a handoff interval apart
            time.sleep(2.5 * HANDOFF_INTERVAL_S)
            return covered()
        wait_until(converged, "the handoff after a join")
        assert_disjoint_cover(c.held(), ids)
        snap = GLOBAL.snapshot()
        assert float(snap["partition_handoff_rows_total"]) > moved0
        assert float(snap["partition_handoff_bytes_total"]) > 0
        assert any((tmp_path / "j2").iterdir()), "the joiner journaled nothing"
        nn_reads_equal(c.client, ref, queries, ("row0", "row13", "row39"))
    finally:
        c.close()


def test_recommender_cluster_reads_equal_one_driver(coord, tmp_path):
    cfg = reco_cfg("inverted_index")
    c = Cluster(coord, "recommender", cfg, tmp_path)
    try:
        ids = [f"row{i}" for i in range(30)]
        ref = tcreate("recommender", cfg, device="cpu")
        for id_, v in zip(ids, vecs(30, 3)):
            assert c.client.call("update_row", id_, wire(v)) is True
            ref.update_row(id_, datum(TDatum, v))
        assert_disjoint_cover(c.held(), ids)
        for q in vecs(3, 4):
            got = as_str(c.client.call("similar_row_from_datum", wire(q), K))
            assert canon(got, False) == canon(
                ref.similar_row_from_datum(datum(TDatum, q), K), False)
        for id_ in ("row3", "row29"):
            got = as_str(c.client.call("similar_row_from_id", id_, K))
            assert canon(got, False) == canon(ref.similar_row_from_id(id_, K),
                                              False)
            assert as_str(c.client.call("decode_row", id_)) == \
                as_str(ref.decode_row(id_).to_msgpack())
        assert c.client.call("similar_row_from_id", "nope", K) == []
    finally:
        c.close()


@pytest.mark.parametrize("n", [1, 2])
def test_anomaly_cluster_scores_are_the_merge_of_the_legs(coord, tmp_path,
                                                          n):
    cfg = anomaly_cfg("euclid_lsh")
    c = Cluster(coord, "anomaly", cfg, tmp_path, n=n)
    try:
        ids = [f"row{i}" for i in range(20)]
        rows = vecs(20, 5)
        for id_, v in zip(ids, rows):
            c.client.call("update", id_, wire(v))
        held = c.held()
        assert_disjoint_cover(held, ids)
        # a local driver a partition, fed its rows in the order sent
        local = []
        for mine in held:
            drv = tcreate("anomaly", cfg, device="cpu")
            for id_, v in zip(ids, rows):
                if id_ in mine:
                    drv.update(id_, datum(TDatum, v))
            local.append(drv)
        for q in vecs(3, 6):
            got = c.client.call("calc_score", wire(q))
            legs = [(p, d.calc_score_partial(datum(TDatum, q)))
                    for p, d in enumerate(local)]
            assert got == merge_anomaly_score(legs)
            if n == 1:
                assert got == local[0].calc_score(datum(TDatum, q))
        rid, _score = as_str(c.client.call("add", wire(vecs(1, 7)[0])))
        assert sum(rid in h for h in c.held()) == 1
    finally:
        c.close()


@pytest.mark.parametrize("policy", ["strict", "best_effort"])
def test_a_lost_partition_follows_the_policy(coord, tmp_path, policy):
    cfg = reco_cfg("lsh")
    c = Cluster(coord, "recommender", cfg, tmp_path, n=3, policy=policy)
    try:
        for i, v in enumerate(vecs(24, 8)):
            c.client.call("update_row", f"row{i}", wire(v))
        dead_srv, dead_rpc = c.servers[1]
        dead_rpc.stop()
        q = vecs(1, 9)[0]
        if policy == "strict":
            with pytest.raises(RemoteError, match="policy=strict"):
                c.client.call("similar_row_from_datum", wire(q), K)
            return
        degraded0 = float(GLOBAL.snapshot().get("proxy_degraded_total", 0))
        got = as_str(c.client.call("similar_row_from_datum", wire(q), K))
        legs = [(p, [[i, s] for i, s in srv.driver.similar_row_from_datum(
            datum(TDatum, q), K)])
            for p, (srv, _) in enumerate(c.servers) if srv is not dead_srv]
        assert got == merge_topk(legs, K, False)
        assert float(GLOBAL.snapshot()["proxy_degraded_total"]) > degraded0
    finally:
        c.close()


# ---------------------------------------------------------------------------
# kill -9 between ship and drop
# ---------------------------------------------------------------------------

def server_proc(cport, cfg_path, port, jdir, grace):
    return Proc([sys.executable, "-m", "jubatus_tpu_torch.cli.server",
                 "--type", "recommender", "--configpath", str(cfg_path),
                 "--rpc-port", str(port), "--listen_addr", "127.0.0.1",
                 "--eth", "127.0.0.1", "--coordinator", f"127.0.0.1:{cport}",
                 "--name", "c", "--device", "cpu", "--routing", "partition",
                 "--interval_sec", "100000", "--interval_count", "1000000",
                 "--journal", str(jdir), "--partition_handoff_interval",
                 "0.2", "--partition_handoff_grace", str(grace)])


def test_kill9_between_ship_and_drop_loses_no_row(coord, tmp_path):
    cfg = reco_cfg("inverted_index")
    cfg_path = tmp_path / "reco.json"
    cfg_path.write_text(json.dumps(cfg))
    ids = [f"row{i}" for i in range(16)]
    rows = vecs(16, 10)
    ref = tcreate("recommender", cfg, device="cpu")
    a = server_proc(coord, cfg_path, 0, tmp_path / "ja", 1e9)
    a2 = c = None
    try:
        port_a = int(a.wait_for("jubatus ready").split()[2].split("=")[1])
        with Client("127.0.0.1", port_a, name="c") as ca:
            for id_, v in zip(ids, rows):
                ca.call("update_row", id_, wire(v))
                ref.update_row(id_, datum(TDatum, v))
        # C joins (journaled) and bootstraps A's model, as a JAX joiner
        # does; C's reconciler ships A's range back (A keeps its resident
        # copies) and drops it, while A's waits out its grace forever:
        # C's range is on both servers, the window between ship and drop
        c = Cluster(coord, "recommender", cfg, tmp_path, n=0, journaled=True)
        srv_c, _ = c.add_server()
        srv_c.cht.version()
        moving = [i for i in ids
                  if srv_c.cht.find_cached(i, 1)[0] != ("127.0.0.1", port_a)]
        assert moving, "the ring change moved nothing"
        wait_until(lambda: set(srv_c.driver.partition_ids()) == set(moving),
                   "C's handoff of A's range")
        # a late re-ship through C's journaled RPC is skipped: C's copies
        # are authoritative (A's pack is the local twin's, byte for byte)
        with Client("127.0.0.1", srv_c.args.rpc_port, name="c") as cc:
            assert cc.call("partition_accept_rows",
                           ref.partition_pack_rows(moving)) == 0
        a.p.kill()                                   # kill -9
        a.p.wait(timeout=30)
        a2 = server_proc(coord, cfg_path, port_a, tmp_path / "ja", 5.0)
        a2.wait_for("jubatus ready")
        with Client("127.0.0.1", port_a, name="c") as ca:
            resident = set(as_str(ca.call("get_all_rows")))
        assert set(moving) <= resident, "rows lost across the crash"
        assert set(moving) <= set(srv_c.driver.rows)
        # the merge dedupes the double residency
        for q in vecs(2, 11):
            got = as_str(c.client.call("similar_row_from_datum", wire(q), K))
            assert canon(got, False) == canon(
                ref.similar_row_from_datum(datum(TDatum, q), K), False)

        def settled():
            st = as_str(c.client.call("get_status"))
            return sum(int(v["partition_rows"]) for v in st.values()) == 16
        wait_until(settled, "the restarted server's handoff")
        with Client("127.0.0.1", port_a, name="c") as ca:
            resident = set(as_str(ca.call("get_all_rows")))
        assert_disjoint_cover([resident, set(srv_c.driver.rows)], ids)
        # C's journal (the accepted rows, its own writes) recovers in the
        # JAX package to C's model
        want = srv_c.driver.pack()
        c.close()
        c = None
        shutil.copytree(tmp_path / "j0", tmp_path / "jc")
        (tmp_path / "jc" / "LOCK").unlink()
        jsrv = jserver_base.JubatusServer(
            jserver_base.ServerArgs(type="recommender", name="c",
                                    journal_dir=str(tmp_path / "jc"),
                                    snapshot_interval_sec=0.0),
            config=json.dumps(cfg))
        jsrv.init_durability()
        try:
            assert jsrv.recovery_info.errors == 0
            assert jsrv.driver.pack()["rows"] == want["rows"]
        finally:
            jsrv.shutdown_durability()
    finally:
        if c is not None:
            c.close()
        for p in (a, a2):
            if p is not None:
                p.kill()


# ---------------------------------------------------------------------------
# mixed clusters
# ---------------------------------------------------------------------------

def test_the_jax_proxy_over_port_servers_answers_as_the_port_proxy(
        coord, tmp_path):
    cfg = nn_cfg("lsh")
    c = Cluster(coord, "nearest_neighbor", cfg, tmp_path)
    jls = JLock(f"127.0.0.1:{coord}")
    jproxy = JProxy(jls, "nearest_neighbor", membership_ttl=0.0,
                    routing="partition")
    jport = jproxy.start(0, host="127.0.0.1")
    jclient = Client("127.0.0.1", jport, name="c", timeout=30)
    try:
        ids = [f"row{i}" for i in range(24)]
        for id_, v in zip(ids, vecs(24, 12)):
            assert jclient.call("set_row", id_, wire(v)) is True
        assert_disjoint_cover(c.held(), ids)
        queries, probe = vecs(3, 13), ("row2", "row23")
        assert nn_answers(jclient, queries, probe) == \
            nn_answers(c.client, queries, probe)
    finally:
        jclient.close()
        jproxy.stop()
        jls.close()
        c.close()


def test_the_port_proxy_over_a_jax_and_a_port_server(coord, tmp_path):
    cfg = nn_cfg("lsh")
    jls = JLock(f"127.0.0.1:{coord}")
    jsrv = jax_partition_server(jls, "nearest_neighbor", cfg)
    c = Cluster(coord, "nearest_neighbor", cfg, tmp_path, n=1)
    jproxy = JProxy(jls, "nearest_neighbor", membership_ttl=0.0,
                    routing="partition")
    jclient = Client("127.0.0.1", jproxy.start(0, host="127.0.0.1"),
                     name="c", timeout=30)
    try:
        ids = [f"row{i}" for i in range(24)]
        rows = vecs(24, 14)
        ref = tcreate("nearest_neighbor", cfg, device="cpu")
        for id_, v in zip(ids, rows):
            assert c.client.call("set_row", id_, wire(v)) is True
            ref.set_row(id_, datum(TDatum, v))
        held = [set(jsrv[0].driver.ids)] + c.held()
        assert_disjoint_cover(held, ids)
        assert all(held)
        queries, probe = vecs(3, 15), ("row1", "row22")
        got = nn_answers(c.client, queries, probe)
        assert got == nn_answers(jclient, queries, probe)
        nn_reads_equal(c.client, ref, queries, probe)
    finally:
        jclient.close()
        jproxy.stop()
        c.close()
        jsrv[1].stop()
        jls.close()


def test_proxy_metrics_traces_and_forward_records(coord, tmp_path):
    """The proxy's own get_proxy_metrics / get_proxy_traces, its
    proxy.forward and proxy.partition_merge records, and get_metrics /
    get_traces broadcast to the members and merged by server id."""
    from jubatus_tpu_torch.obs.trace import TRACER
    TRACER.clear()
    TRACER.configure(ring=4096)
    c = Cluster(coord, "recommender", reco_cfg("inverted_index"), tmp_path)
    try:
        for i, v in enumerate(vecs(8, 31)):
            c.client.call("update_row", f"r{i}", wire(v))
        c.client.call("similar_row_from_datum", wire(vecs(1, 32)[0]), K)
        spans = c.client.call_raw("get_proxy_traces")
        fwd = [s for s in spans if s["name"] == "proxy.forward"]
        members = {f"127.0.0.1:{s.args.rpc_port}" for s, _ in c.servers}
        assert {s["tags"]["peer"] for s in fwd} == members
        assert {"update_row", "similar_row_from_datum"} <= \
            {s["tags"]["method"] for s in fwd}
        assert all(s["tags"]["ok"] for s in fwd)
        (merge,) = [s for s in spans if s["name"] == "proxy.partition_merge"]
        assert merge["tags"]["partitions"] == 2
        assert merge["tags"]["method"] == "similar_row_from_datum"
        pm = c.client.call_raw("get_proxy_metrics")
        assert int(pm["proxy_request_count"]) >= 9
        assert int(pm["partition_scatter_total"]) >= 1
        assert int(pm["rpc.similar_row_from_datum_count"]) >= 1
        (pst,) = c.client.call_raw("get_proxy_status").values()
        assert pst["tracing_enabled"] == "1"
        sids = {f"127.0.0.1_{s.args.rpc_port}" for s, _ in c.servers}
        assert set(as_str(c.client.call("get_metrics"))) == sids
        traces = as_str(c.client.call("get_traces"))
        assert set(traces) == sids
        assert all(any(s["name"] == "rpc.update_row" for s in t)
                   for t in traces.values())
    finally:
        c.close()
        TRACER.configure(ring=0, slow_op_ms=0)
        TRACER.clear()


TENANCY_CFG = {"method": "AROW", "parameter": {"regularization_weight": 1.0},
               "converter": {"string_rules": [
                   {"key": "*", "type": "str", "sample_weight": "bin",
                    "global_weight": "bin"}], "hash_max_size": 1024}}


def tenancy_train(i):
    return [[f"l{i % 3}", datum_wire(strings=[("k", f"tok{i}")])]]


def test_the_tenancy_rpcs_and_the_edge_quota_through_the_proxy(coord,
                                                                tmp_path):
    """create_model reaches every member of the cluster, a slot's traffic
    reaches that slot only, list_models merges the members' maps, an
    over-quota tenant is refused at the members and then at the proxy's
    edge (its view warmed through list_models), drop_model reaches every
    member, and a placement directive is refused, naming item 7."""
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps(TENANCY_CFG))
    servers = [serve(["--type", "classifier", "--configpath", str(cfg),
                      "--rpc-port", "0", "--listen_addr", "127.0.0.1",
                      "--eth", "127.0.0.1", "--coordinator",
                      f"127.0.0.1:{coord}", "--name", "c", "--device", "cpu",
                      "--interval_sec", "100000",
                      "--interval_count", "1000000"]) for _ in range(2)]
    proxy = Proxy(f"127.0.0.1:{coord}", "classifier", membership_ttl=0.0)
    pport = proxy.start(0, host="127.0.0.1")
    try:
        with Client("127.0.0.1", pport, timeout=30) as c:
            assert c.call_raw("create_model", "c", {
                "name": "m1", "tenant": "t1",
                "quota": {"train_rps": 2}}) is True
            assert all(set(s.list_models()) == {"c", "m1"}
                       for s, _ in servers)
            assert c.call_raw("train", "m1", tenancy_train(0)) == 1
            for s, _ in servers:
                s.slot_for("m1").dispatcher.flush()
            assert sum(s.slot_for("m1").update_count
                       for s, _ in servers) == 1
            assert sum(s.update_count for s, _ in servers) == 0
            listing = as_str(c.call_raw("list_models", "c"))
            assert set(listing) == {"c", "m1"}
            assert listing["m1"]["quota"]["train_rps"] == 2.0
            with pytest.raises(RemoteError, match="Queue 1 item 7"):
                c.call_raw("create_model", "c",
                           {"name": "m2", "placement": "auto"})
            assert all(set(s.list_models()) == {"c", "m1"}
                       for s, _ in servers)
            # a flood: refused by the members at once, and at the edge
            # once the proxy's background view of m1 has landed
            edge = 0
            deadline = time.monotonic() + WAIT_S
            while not edge and time.monotonic() < deadline:
                try:
                    c.call_raw("train", "m1", tenancy_train(1))
                except RemoteError as e:
                    assert "quota_exceeded" in str(e)
                    edge += "(proxy)" in str(e)
            assert edge
            assert proxy.quota_gate.info_of("m1")["tenant"] == "t1"
            assert c.call_raw("drop_model", "c", "m1") is True
            assert all(set(s.list_models()) == {"c"} for s, _ in servers)
            with pytest.raises(RemoteError, match="Queue 1 item 7"):
                c.call_raw("get_fleet_snapshot", "c")
    finally:
        proxy.stop()
        for s, rpc in servers:
            rpc.stop()
            s.stop()
