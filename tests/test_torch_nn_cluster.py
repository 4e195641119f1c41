"""A mixed nearest_neighbor cluster: the JAX package's coordinator, one
JAX server and one port server (--device cpu), each its own process,
reconcile their row tables by do_mix, on the f32 wire (v2) and the
blockwise-int8 wire (v3, --mix_quantize).  tests/test_torch_cluster_mixed.py
is the harness; this file runs it for the nearest_neighbor service.

Each server gets its own rows over the wire (set_row), one id written on
both.  After do_mix both servers hold the union: every row's signature
and norm bitwise equal to those of an in-process port driver that
applied the same rows in the master's fold order, on both wires (an NN
diff carries no float32 tensor, so v3 ships it as it is), and a second
do_mix, sent to the other server, changes nothing.  Every wait has its
own timeout."""

import json
import sys
import time

import numpy as np
import pytest

from jubatus_tpu_torch.cluster.membership import MembershipClient
from jubatus_tpu_torch.fv import Datum
from jubatus_tpu_torch.mix import codec as tcodec
from jubatus_tpu_torch.models.nearest_neighbor import NearestNeighborDriver
from tests.test_torch_cluster_mixed import START_S, Proc, call, server_argv
from tests.test_torch_nearest_neighbor import config, rows, wire

CFG = config("lsh", hash_num=64)
CLUSTERS = {"nn_f32_mixed": False, "nn_v3_mixed": True}
# server index -> its rows (the last id of server 0 is written on both)
ROWS = {0: [(f"a{i}", d) for i, d in enumerate(rows(60, 12))],
        1: [(f"b{i}", d) for i, d in enumerate(rows(61, 12))]
        + [("a11", rows(62, 1)[0])]}


@pytest.fixture(scope="module")
def clusters():
    """The JAX coordinator and each cluster's JAX + port servers, started
    at once; -> ({name: [port of the JAX server, port of the port's]},
    {name: server indices in the member list's order})."""
    procs = []
    try:
        coord = Proc([sys.executable, "-m", "jubatus_tpu.cluster.coordinator",
                      "--rpc-port", "0", "--listen_addr", "127.0.0.1",
                      "--session_ttl", "5"])
        procs.append(coord)
        addr = coord.wait_for("jubacoordinator").split()[-1]
        setters = []
        for name in CLUSTERS:
            m = MembershipClient(addr, "nearest_neighbor", name)
            m.set_config(json.dumps(CFG))
            setters.append(m)
        started = {name: [Proc(server_argv(pkg, "nearest_neighbor", name,
                                           addr, quantize))
                          for pkg in ("jubatus_tpu", "jubatus_tpu_torch")]
                   for name, quantize in CLUSTERS.items()}
        for pair in started.values():
            procs.extend(pair)
        ports = {name: [int(p.wait_for("jubatus ready").split()[2]
                            .split("=")[1]) for p in pair]
                 for name, pair in started.items()}
        order = {}
        for m, name in zip(setters, CLUSTERS):
            want = {("127.0.0.1", p) for p in ports[name]}
            deadline = time.monotonic() + START_S
            while set(m.get_all_nodes()) != want:
                assert time.monotonic() < deadline, f"{name} never joined"
                time.sleep(0.2)
            # the master folds the diffs in the member list's order
            order[name] = [ports[name].index(p)
                           for _h, p in m.get_all_nodes(force=True)]
            m.close()
        # a JAX master reads its member list from a cache up to a second
        # old (ROADMAP Queue 3 item 6)
        time.sleep(1.2)
        yield ports, order
    finally:
        for p in procs:
            p.kill()


def table_of(port):
    """The server's rows through the mixer's get_model RPC: {id: (sig
    words, norm bits)}."""
    pack = tcodec.decode(call(port, "get_model", 0))["model"]
    cap, w = int(pack["capacity"]), (int(pack["hash_num"]) + 31) // 32
    sig = np.frombuffer(pack["sig"], np.uint32).reshape(cap, w)
    norms = np.frombuffer(pack["norms"], np.uint32)
    return {(r if isinstance(r, str) else r.decode()):
            (tuple(sig[i]), int(norms[i]))
            for i, r in enumerate(pack["row_ids"])}


def expected(order):
    """The union as a port driver builds it from the rows of the servers
    in the master's fold order (the member list's): the later side of
    mix wins an id written on both."""
    d = NearestNeighborDriver(CFG, device="cpu")
    for s in order:
        for rid, nums in ROWS[s]:
            d.set_row(rid, Datum(num_values=nums))
    pack = d.pack()
    cap, w = int(pack["capacity"]), 2
    sig = np.frombuffer(pack["sig"], np.uint32).reshape(cap, w)
    norms = np.frombuffer(pack["norms"], np.uint32)
    return {r: (tuple(sig[i]), int(norms[i]))
            for i, r in enumerate(pack["row_ids"])}


@pytest.mark.parametrize("name", sorted(CLUSTERS))
def test_do_mix_unites_the_tables(clusters, name):
    ports, order = clusters[0][name], clusters[1][name]
    for port, s in zip(ports, (0, 1)):
        for rid, nums in ROWS[s]:
            assert call(port, "set_row", "", rid, wire(nums)) is True
    # v2 from the port server (index 1), v3 from the JAX server
    master = 0 if CLUSTERS[name] else 1
    assert call(ports[master], "do_mix", "") is True
    tables = [table_of(p) for p in ports]
    assert tables[0] == tables[1]
    assert tables[0] == expected(order)
    assert len(tables[0]) == 24
    assert call(ports[1 - master], "do_mix", "") is True
    assert [table_of(p) for p in ports] == tables
    q = wire(rows(63, 1)[0])
    answers = [call(p, "similar_row_from_datum", "", q, 10) for p in ports]
    # each server lays the rows out in its own slot order (its own rows
    # first), so tied scores may name other rows: the scores agree, and
    # so do the rows above the last score
    assert [s for _, s in answers[0]] == [s for _, s in answers[1]]
    last = answers[0][-1][1]
    assert {r for r, s in answers[0] if s > last} == \
        {r for r, s in answers[1] if s > last}
    st = next(iter(call(ports[1], "get_status", "").values()))
    assert st["mix_wire_version"] == ("3" if CLUSTERS[name] else "2")
    assert st["num_rows"] == "24"
