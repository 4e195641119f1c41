"""Mixed recommender and anomaly clusters: the JAX package's coordinator,
one JAX server and one port server (--device cpu) of each engine, each
its own process (tests/test_torch_cluster_mixed.py's harness).

- recommender: each server takes its own update_rows; after do_mix both
  hold the union, row for row (decode_row), and answer reads alike; a
  second do_mix changes nothing; on the f32 wire and on v3.
- anomaly: add goes to the id's two CHT owners (here both servers), and
  the port's CHT copy names the same owners as the JAX package's for
  every id; both servers hold every row and score alike, before and after
  do_mix (whose put_diff rebuilds the kNN lists, so the scores move in
  their last bits, on both alike).
"""

import json
import sys
import time

import numpy as np
import pytest

from jubatus_tpu.cluster.cht import CHT as JCHT
from jubatus_tpu.cluster.lock_service import CoordLockService as JLS
from jubatus_tpu_torch.cluster.cht import CHT as TCHT
from jubatus_tpu_torch.cluster.membership import MembershipClient
from tests.test_torch_cluster_mixed import START_S, Proc, call, server_argv
from tests.test_torch_reco_anomaly_server import ANOM_CFG, RECO_CFG, datums

# cluster name -> (engine, config, v3 wire: --mix_quantize)
CLUSTERS = {"reco": ("recommender", RECO_CFG, False),
            "reco_v3": ("recommender", RECO_CFG, True),
            "anomaly": ("anomaly", ANOM_CFG, False)}


@pytest.fixture(scope="module")
def clusters():
    """-> (coordinator address, {cluster: [JAX server port, port's]})."""
    procs = []
    try:
        coord = Proc([sys.executable, "-m", "jubatus_tpu.cluster.coordinator",
                      "--rpc-port", "0", "--listen_addr", "127.0.0.1",
                      "--session_ttl", "5"])
        procs.append(coord)
        addr = coord.wait_for("jubacoordinator").split()[-1]
        setters = {}
        for name, (engine, cfg, _) in CLUSTERS.items():
            m = MembershipClient(addr, engine, name)
            m.set_config(json.dumps(cfg))
            setters[name] = m
        started = {name: [Proc(server_argv(pkg, engine, name, addr, v3))
                          for pkg in ("jubatus_tpu", "jubatus_tpu_torch")]
                   for name, (engine, _, v3) in CLUSTERS.items()}
        for pair in started.values():
            procs.extend(pair)
        ports = {e: [int(p.wait_for("jubatus ready").split()[2]
                         .split("=")[1]) for p in pair]
                 for e, pair in started.items()}
        for e, m in setters.items():
            want = {("127.0.0.1", p) for p in ports[e]}
            deadline = time.monotonic() + START_S
            while set(m.get_all_nodes()) != want:
                assert time.monotonic() < deadline, f"{e} never joined"
                time.sleep(0.2)
            m.close()
        # a JAX master reads its member list from a cache up to a second
        # old (ROADMAP Queue 3 item 6)
        time.sleep(1.2)
        yield addr, ports
    finally:
        for p in procs:
            p.kill()


@pytest.mark.parametrize("name", ["reco", "reco_v3"])
def test_recommender_do_mix_unites_the_rows(clusters, name):
    """On the f32 wire and on v3 (the diff holds no float32 array, so v3
    ships it as it is)."""
    ports = clusters[1][name]
    for s, port in enumerate(ports):
        for i, d in enumerate(datums(70 + s, 15)):
            assert call(port, "update_row", "", f"s{s}r{i}", d) is True
        assert call(port, "clear_row", "", f"s{s}r3") is True
    assert call(ports[1], "do_mix", "") is True
    rows = [sorted(call(p, "get_all_rows", "")) for p in ports]
    assert rows[0] == rows[1] and len(rows[0]) == 28
    for rid in rows[0][::5]:
        assert call(ports[0], "decode_row", "", rid) == \
            call(ports[1], "decode_row", "", rid)
    for q in datums(72, 3):
        a, b = (call(p, "similar_row_from_datum", "", q, 6) for p in ports)
        assert [s for _, s in a] == [s for _, s in b]
    assert call(ports[0], "do_mix", "") is True
    assert [sorted(call(p, "get_all_rows", "")) for p in ports] == rows
    st = next(iter(call(ports[1], "get_status", "").values()))
    assert st["mix_wire_version"] == ("3" if name == "reco_v3" else "2")


def test_anomaly_adds_land_on_the_same_cht_owners(clusters):
    addr, ports = clusters[0], clusters[1]["anomaly"]
    ids = []
    for s, port in enumerate(ports):
        for d in datums(80 + s, 8):
            rid, score = call(port, "add", "", d)
            ids.append(rid if isinstance(rid, str) else rid.decode())
    jls = JLS(addr)
    tm = MembershipClient(addr, "anomaly", "anomaly")
    try:
        jcht = JCHT(jls, "anomaly", "anomaly")
        tcht = TCHT(tm.ls, "anomaly", "anomaly")
        for rid in ids:
            owners = tcht.find(rid, 2)
            assert owners == jcht.find(rid, 2)
            assert sorted(p for _, p in owners) == sorted(ports)
    finally:
        jls.close()
        tm.close()
    rows = [call(p, "get_all_rows", "") for p in ports]
    assert rows[0] == rows[1] == ids
    qs = datums(82, 4)
    before = [[call(p, "calc_score", "", q) for q in qs] for p in ports]
    assert before[0] == before[1]
    assert call(ports[1], "do_mix", "") is True
    # put_diff rebuilds every kNN list, as the JAX driver's does
    after = [[call(p, "calc_score", "", q) for q in qs] for p in ports]
    assert after[0] == after[1]
    np.testing.assert_allclose(after[0], before[0], rtol=1e-6)
