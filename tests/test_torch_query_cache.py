"""The port's epoch-keyed query cache (jubatus_tpu_torch/framework/
query_cache.py) against the JAX package's, on the CPU:

- QueryCache: one seeded sequence of keys, probes, fills (with byte and
  entry bounds) and bypasses gives the JAX cache's keys, hits,
  evictions, get_status and counters;
- a port server with --query_cache_entries answers a cached get_labels
  with the JAX server's bytes, and a cached classify with the bytes of
  its own uncached answer, the scores within the classifier's tolerance
  of the JAX server's;
- every model mutation bumps model_epoch and the next read is fresh:
  train, set_label, delete_label, clear, load, set_row, update_row,
  clear_row, anomaly's add, the handoff's partition_drop_rows, a MIX
  put_diff, a gossip push fold, a joiner's bootstrap, --model_file and
  journal recovery;
- the port proxy's cache answers a broadcast read from the cache and
  invalidates it on a change of the CHT ring.
"""

import json

import msgpack
import numpy as np
import pytest

from jubatus_tpu.framework import query_cache as jqc
from jubatus_tpu.utils import metrics as jmetrics
from jubatus_tpu_torch.cli.server import serve
from jubatus_tpu_torch.framework import query_cache as tqc
from jubatus_tpu_torch.rpc.client import Client
from jubatus_tpu_torch.utils import metrics as tmetrics
from tests.test_torch_classifier import ATOL, RTOL
from tests.test_torch_dispatch_modes import (CFG, jax_server, send_sequential,
                                             stop_jax, train_frames)
from tests.test_torch_partition import anomaly_cfg, nn_cfg, reco_cfg, vecs
from tests.test_wire_golden import old_pack

# -- the cache alone -------------------------------------------------------------


def drive_cache(mod, metrics_mod, seed, entries, nbytes):
    rng = np.random.default_rng(seed)
    reg = metrics_mod.Registry()
    cache = mod.create_query_cache(entries, nbytes, registry=reg)
    log = []
    for _ in range(300):
        op = int(rng.integers(0, 4))
        args = [f"d{int(rng.integers(0, 12))}", int(rng.integers(0, 3))]
        epoch = int(rng.integers(0, 3))
        key = cache.key("classify", args, epoch,
                        extra=b"x" if rng.random() < 0.2 else b"")
        log.append(key)
        if op == 0:
            log.append(cache.get(key))
        elif op == 1:
            cache.put(key, bytes(rng.integers(0, 256,
                                              int(rng.integers(1, 90)),
                                              dtype=np.uint8)))
        elif op == 2:
            log.append(mod.serve_cached(
                cache, key, lambda: {"a": [1.5, "x"], "n": len(log)}).body)
        else:
            cache.bypass()
        log.append((len(cache), cache.stored_bytes()))
    # arguments that do not pack bypass the cache
    log.append(cache.key("classify", [object()], 0))
    return log, cache.get_status(), reg.snapshot()


@pytest.mark.parametrize("entries,nbytes", [(8, 0), (0, 300), (6, 200)])
def test_query_cache_equals_jax(entries, nbytes):
    j = drive_cache(jqc, jmetrics, 5, entries, nbytes)
    t = drive_cache(tqc, tmetrics, 5, entries, nbytes)
    assert t == j
    assert int(t[2].get("query_cache_evict_total", "0")) > 0
    assert tqc.create_query_cache(0, 0) is None


def test_pack_wire_equals_jax():
    obj = [[["l0", 0.125], ["l1", -3.5]], {"k": b"\xff\x00"}, "s\udcff", 7]
    assert tqc.pack_wire(obj) == jqc.pack_wire(obj)


# -- a cached server against the JAX server ---------------------------------------

def raw_reply(port, method, *args, name="modes", msgid=1):
    """One request on a fresh connection -> the whole reply frame."""
    import socket
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(old_pack([0, msgid, method, [name, *args]]))
        unp = msgpack.Unpacker(raw=False, strict_map_key=False)
        buf = b""
        while True:
            data = s.recv(1 << 16)
            assert data
            buf += data
            unp.feed(data)
            for _ in unp:
                return buf


def test_cached_reads_answer_the_jax_servers_bytes(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jsrv, jrpc, jport = jax_server(tmp_path / "j",
                                   {"query_cache_entries": 64}, False)
    tsrv, trpc = serve([
        "--type", "classifier", "--configpath", write(tmp_path, CFG),
        "--rpc-port", "0", "--listen_addr", "127.0.0.1", "--name", "modes",
        "--device", "cpu", "--query_cache_entries", "64"])
    tport = tsrv.args.rpc_port
    try:
        batches = train_frames(21, n_frames=5)
        for port in (jport, tport):
            send_sequential(port, batches)
        query = [row[1] for row in batches[0][:4]]
        hits0 = tmetrics.GLOBAL.counter("query_cache_hit_total")
        misses0 = tmetrics.GLOBAL.counter("query_cache_miss_total")
        j1, j2 = (raw_reply(jport, "get_labels") for _ in range(2))
        t1, t2 = (raw_reply(tport, "get_labels") for _ in range(2))
        assert t1 == t2 == j1 == j2
        t1, t2 = (raw_reply(tport, "classify", query) for _ in range(2))
        assert t1 == t2
        jc = msgpack.unpackb(raw_reply(jport, "classify", query),
                             raw=False)[3]
        tc = msgpack.unpackb(t2, raw=False)[3]
        assert [[e[0] for e in r] for r in tc] == \
            [[e[0] for e in r] for r in jc]
        np.testing.assert_allclose([[e[1] for e in r] for r in tc],
                                   [[e[1] for e in r] for r in jc],
                                   rtol=RTOL, atol=ATOL)
        # one probe a read: two misses filled, two hits
        assert tmetrics.GLOBAL.counter("query_cache_hit_total") == hits0 + 2
        assert tmetrics.GLOBAL.counter("query_cache_miss_total") == \
            misses0 + 2
        (st,) = tsrv.get_status().values()
        assert st["query_cache_enabled"] == "1"
        assert st["query_cache_entries"] == "2"
    finally:
        stop_jax(jsrv, jrpc)
        trpc.stop()
        tsrv.stop()


# -- every mutation bumps the epoch --------------------------------------------------

def write(tmp_path, cfg, name="c.json"):
    path = tmp_path / name
    path.write_text(json.dumps(cfg))
    return str(path)


def vec_wire(v):
    return [[], [[f"f{k}", float(x)] for k, x in enumerate(v)], []]


def start(tmp_path, service, cfg, *extra):
    return serve(["--type", service, "--configpath", write(tmp_path, cfg),
                  "--rpc-port", "0", "--listen_addr", "127.0.0.1",
                  "--name", "q", "--datadir", str(tmp_path), "--device",
                  "cpu", "--query_cache_entries", "256", *extra])


def classifier_rows(seed, n=8):
    return train_frames(seed, n_frames=1, per=n)[0]


def diff_payload(tmp_path, round_):
    """A MIX diff as it crosses the wire: another classifier's trains."""
    from jubatus_tpu_torch.mix import codec
    srv, rpc = start(tmp_path, "classifier", CFG)
    try:
        Client("127.0.0.1", srv.args.rpc_port, name="q").call(
            "train", classifier_rows(99))
        srv.dispatcher.flush()
        packed = {"protocol_version": 2, "round": round_,
                  "diff": codec.encode(srv.driver.get_diff())}
        return codec.unpackb(codec.packb(packed))
    finally:
        rpc.stop()
        srv.stop()


def m_put_diff(srv, cli, tmp_path):
    from jubatus_tpu_torch.mix.linear_mixer import LinearMixer
    assert LinearMixer(srv, None)._rpc_put_diff(diff_payload(tmp_path, 1))


def m_gossip(srv, cli, tmp_path):
    from jubatus_tpu_torch.mix.push_mixer import PushMixer
    assert PushMixer(srv, None)._rpc_push(diff_payload(tmp_path, None))


def m_load(srv, cli, tmp_path):
    assert cli.call("load", "snap")


def m_bootstrap(srv, cli, tmp_path):
    from jubatus_tpu_torch.mix.linear_mixer import (LinearMixer,
                                                    bootstrap_from_peer)
    peer, prpc = start(tmp_path / "peer", "classifier", CFG)
    # a cluster member's get_model, on a standalone peer
    LinearMixer(peer, None).register_api(prpc)
    try:
        Client("127.0.0.1", peer.args.rpc_port, name="q").call(
            "train", classifier_rows(98))
        peer.dispatcher.flush()
        assert bootstrap_from_peer(srv, "127.0.0.1", peer.args.rpc_port)
    finally:
        prpc.stop()
        peer.stop()


IDS = [f"r{i}" for i in range(12)]
ROWS = vecs(12, 4)
Q = vec_wire(ROWS[0] + 0.05)

# name: (service, config, prepare(cli), read (method, args),
#        mutate(srv, cli, tmp_path), the read's answer changes)
CASES = {
    "train": ("classifier", CFG, None, ("get_labels",),
              lambda s, c, t: c.call("train", classifier_rows(3)), True),
    "set_label": ("classifier", CFG, None, ("get_labels",),
                  lambda s, c, t: c.call("set_label", "fresh"), True),
    "delete_label": ("classifier", CFG, None, ("get_labels",),
                     lambda s, c, t: c.call("delete_label", "l1"), True),
    "clear": ("classifier", CFG, None, ("get_labels",),
              lambda s, c, t: c.call("clear"), True),
    "load": ("classifier", CFG, "save", ("get_labels",), m_load, True),
    "put_diff": ("classifier", CFG, None, ("get_labels",), m_put_diff,
                 True),
    "gossip_push": ("classifier", CFG, None, ("get_labels",), m_gossip,
                    True),
    "bootstrap": ("classifier", CFG, None, ("get_labels",), m_bootstrap,
                  True),
    "set_row": ("nearest_neighbor", nn_cfg("lsh"), "rows",
                ("similar_row_from_datum", Q, 4),
                lambda s, c, t: c.call("set_row", "new", Q), True),
    "update_row": ("recommender", reco_cfg("inverted_index"), "reco",
                   ("similar_row_from_datum", Q, 4),
                   lambda s, c, t: c.call("update_row", "new", Q), True),
    "clear_row": ("recommender", reco_cfg("inverted_index"), "reco",
                  ("get_all_rows",),
                  lambda s, c, t: c.call("clear_row", "r3"), True),
    "partition_drop_rows": ("recommender", reco_cfg("inverted_index"),
                            "reco", ("get_all_rows",),
                            lambda s, c, t: c.call("partition_drop_rows",
                                                   ["r1", "r2"]), True),
    "add": ("anomaly", anomaly_cfg("euclid_lsh"), "adds", ("get_all_rows",),
            lambda s, c, t: c.call("add", Q), True),
}


def prepare(kind, cli):
    if kind is None:
        cli.call("train", classifier_rows(1))
    elif kind == "save":
        cli.call("train", classifier_rows(1))
        cli.call("save", "snap")
        cli.call("train", classifier_rows(2))
    elif kind == "rows":
        for id_, v in zip(IDS, ROWS):
            cli.call("set_row", id_, vec_wire(v))
    elif kind == "reco":
        for id_, v in zip(IDS, ROWS):
            cli.call("update_row", id_, vec_wire(v))
    elif kind == "adds":
        for v in ROWS[:6]:
            cli.call("add", vec_wire(v))


@pytest.mark.parametrize("case", list(CASES))
def test_each_mutation_bumps_the_epoch(case, tmp_path):
    service, cfg, prep, read, mutate, changes = CASES[case]
    (tmp_path / "peer").mkdir()
    srv, rpc = start(tmp_path, service, cfg)
    cli = Client("127.0.0.1", srv.args.rpc_port, name="q", timeout=60)
    try:
        prepare(prep, cli)
        before = cli.call(*read)
        assert cli.call(*read) == before            # a hit
        hits = tmetrics.GLOBAL.counter("query_cache_hit_total")
        assert hits > 0
        epoch = srv.model_epoch
        mutate(srv, cli, tmp_path)
        assert srv.model_epoch > epoch, case
        after = cli.call(*read)
        # the same read with the cache emptied: the answer was fresh
        srv.query_cache.clear()
        assert cli.call(*read) == after, case
        if changes:
            assert after != before, case
    finally:
        cli.close()
        rpc.stop()
        srv.stop()


def test_model_file_and_recovery_bump_the_epoch(tmp_path):
    """A --model_file boot and a journal recovery each leave a fresh
    epoch and the file's (the journal's) answers."""
    srv, rpc = start(tmp_path, "classifier", CFG, "--journal",
                     str(tmp_path / "j"))
    cli = Client("127.0.0.1", srv.args.rpc_port, name="q")
    cli.call("train", classifier_rows(5))
    path = next(iter(cli.call("save", "mf").values()))
    labels = cli.call("get_labels")
    cli.close()
    rpc.stop()
    srv.stop()
    (tmp_path / "b").mkdir()
    for extra in (["--journal", str(tmp_path / "j")],
                  ["--model_file", path]):
        srv, rpc = start(tmp_path / "b", "classifier", CFG, *extra)
        try:
            assert srv.model_epoch == 1
            assert Client("127.0.0.1", srv.args.rpc_port,
                          name="q").call("get_labels") == labels
        finally:
            rpc.stop()
            srv.stop()


# -- the proxy's cache and the ring ---------------------------------------------

def test_proxy_cache_invalidates_on_a_ring_change(tmp_path):
    from jubatus_tpu_torch.cluster.cht import CHT
    from jubatus_tpu_torch.cluster.coordinator import CoordinatorServer
    from jubatus_tpu_torch.cluster.lock_service import CoordLockService
    from jubatus_tpu_torch.framework.proxy import Proxy
    coord = CoordinatorServer()
    cport = coord.start(0, "127.0.0.1")
    srv, rpc = serve([
        "--type", "recommender", "--configpath",
        write(tmp_path, reco_cfg("inverted_index")), "--rpc-port", "0",
        "--listen_addr", "127.0.0.1", "--eth", "127.0.0.1", "--name", "q",
        "--coordinator", f"127.0.0.1:{cport}", "--device", "cpu",
        "--interval_sec", "100000", "--interval_count", "1000000"])
    proxy = Proxy(f"127.0.0.1:{cport}", "recommender", membership_ttl=0.0,
                  query_cache_entries=64)
    pport = proxy.start(0, host="127.0.0.1")
    cli = Client("127.0.0.1", pport, name="q", timeout=30)
    ls = CoordLockService(f"127.0.0.1:{cport}")
    try:
        for id_, v in zip(IDS[:4], ROWS[:4]):
            cli.call("update_row", id_, vec_wire(v))
        g = tmetrics.GLOBAL
        rows = cli.call("get_all_rows")
        hits, misses = (g.counter("query_cache_hit_total"),
                        g.counter("query_cache_miss_total"))
        assert cli.call("get_all_rows") == rows
        assert g.counter("query_cache_hit_total") == hits + 1
        # a write through the proxy bumps its epoch
        cli.call("update_row", "r9", vec_wire(ROWS[9]))
        rows = cli.call("get_all_rows")
        assert len(rows) == 5
        misses = g.counter("query_cache_miss_total")
        bumps = g.counter("proxy_ring_epoch_bump_total")
        # a ring point of another (absent) node: the broadcast's target
        # set is unchanged, the ring is not
        CHT(ls, "recommender", "q").register_node("127.0.0.1", 1)
        assert cli.call("get_all_rows") == rows
        assert g.counter("proxy_ring_epoch_bump_total") == bumps + 1
        assert g.counter("query_cache_miss_total") == misses + 1
        (pst,) = cli.call_raw("get_proxy_status").values()
        assert pst["query_cache_enabled"] == "1"
    finally:
        ls.close()
        cli.close()
        proxy.stop()
        rpc.stop()
        srv.stop()
        coord.stop()


def test_a_read_on_the_lane_fills_the_cache_once(tmp_path):
    """With the read lane, a miss is filled when the lane's sweep
    answers; the next read is a hit with the same bytes."""
    srv, rpc = start(tmp_path, "classifier", CFG,
                     "--read_batch_window_us", "200")
    try:
        port = srv.args.rpc_port
        send_sequential(port, train_frames(41, n_frames=3), name="q")
        query = [train_frames(42, n_frames=1)[0][0][1]]
        g = tmetrics.GLOBAL
        hits, misses = (g.counter("query_cache_hit_total"),
                        g.counter("query_cache_miss_total"))
        first = raw_reply(port, "classify", query, name="q")
        assert raw_reply(port, "classify", query, name="q") == first
        assert (g.counter("query_cache_hit_total"),
                g.counter("query_cache_miss_total")) == (hits + 1,
                                                         misses + 1)
        from jubatus_tpu_torch.fv import Datum
        with srv.model_lock.read():
            want = srv.driver.classify([Datum.from_msgpack(query[0])])
        got = msgpack.unpackb(first, raw=False)[3]
        assert [[e[0] for e in r] for r in got] == \
            [[lbl for lbl, _ in r] for r in want]
    finally:
        rpc.stop()
        srv.stop()
