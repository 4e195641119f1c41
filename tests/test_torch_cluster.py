"""The port's cluster tier against the JAX package's: the coordinator and
the lock-service client (wire-compatible both ways), the gossip mixer's
candidate filter, the in-process LinearMixer rounds of tests/test_mix.py
on port servers (--device cpu), do_mix while raw trains are in flight,
and the CLI's mixer names (collective_mixer served, an unknown one
refused).

Every wait is bounded by its own timeout."""

import json
import random
import socket
import subprocess
import sys
import threading
import time

import msgpack
import pytest

from jubatus_tpu.cluster.coordinator import CoordinatorServer as JCoordinator
from jubatus_tpu.cluster.coordinator import CoordinatorState as JState
from jubatus_tpu.cluster.lock_service import CoordLockService as JLock
from jubatus_tpu.cluster.lock_service import \
    StandaloneLockService as JStandalone
from jubatus_tpu.mix.push_mixer import filter_candidates as jfilter
from jubatus_tpu_torch.cluster.coordinator import \
    CoordinatorServer as TCoordinator
from jubatus_tpu_torch.cluster.coordinator import CoordinatorState as TState
from jubatus_tpu_torch.cluster.lock_service import CoordLockService as TLock
from jubatus_tpu_torch.cluster.lock_service import \
    StandaloneLockService as TStandalone
from jubatus_tpu_torch.cluster.lock_service import create_lock_service
from jubatus_tpu_torch.cluster.membership import MembershipClient
from jubatus_tpu_torch.framework.server_base import JubatusServer, ServerArgs
from jubatus_tpu_torch.framework.service import bind_service
from jubatus_tpu_torch.fv import Datum
from jubatus_tpu_torch.mix.linear_mixer import LinearMixer, bootstrap_from_peer
from jubatus_tpu_torch.mix.mixer_factory import create_mixer
from jubatus_tpu_torch.mix.push_mixer import filter_candidates as tfilter
from jubatus_tpu_torch.rpc.client import Client
from jubatus_tpu_torch.rpc.server import RpcServer
from tests.test_torch_server import REPO
from tests.test_wire_golden import datum_wire

CONFIG = {
    "method": "PA",
    "parameter": {},
    "converter": {
        "string_rules": [{"key": "*", "type": "str", "sample_weight": "bin",
                          "global_weight": "bin"}],
        "hash_max_size": 1024,
    },
}

STATES = {"jax": JState, "port": TState}
COORDINATORS = {"jax": JCoordinator, "port": TCoordinator}
LOCKS = {"jax": JLock, "port": TLock}
STANDALONE = {"jax": JStandalone, "port": TStandalone}


def wait_until(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what} not within {timeout} s")
        time.sleep(0.05)


# ---------------------------------------------------------------------------
# coordinator and lock service
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_coordinator_state_matches_tests_test_mix(pkg):
    """tests/test_mix.py TestCoordinatorState, on each package's state."""
    s = STATES[pkg]()
    assert s.create("/a/b/c", b"v1", None, False) == "/a/b/c"
    assert s.create("/a/b/c", b"x", None, False) is None
    assert s.get("/a/b/c")[0] == b"v1"
    s.set("/a/b/c", b"v2")
    assert s.get("/a/b/c")[0] == b"v2"
    names, ver = s.list("/a/b")
    assert names == ["c"] and ver >= 1
    assert s.delete("/a/b/c") is True and s.get("/a/b/c") is None
    assert s.create("/locks/lock-", b"", None, True) == \
        "/locks/lock-0000000001"
    assert s.create("/locks/lock-", b"", None, True) == \
        "/locks/lock-0000000002"
    _, v0 = s.list("/m")
    s.create("/m/a", b"", None, False)
    assert s.list("/m")[1] != v0
    assert [s.create_id("k") for _ in range(3)] == [1, 2, 3]
    now = [0.0]
    s = STATES[pkg](session_ttl=0.05, clock=lambda: now[0])
    sid, ttl = s.open_session()
    assert ttl == 0.05
    s.create("/nodes/n1", b"", sid, False)
    s.create("/nodes/n2", b"", None, False)
    assert s.list("/nodes")[0] == ["n1", "n2"]
    now[0] = 0.1
    assert s.reap_expired() == [sid]
    assert s.list("/nodes")[0] == ["n2"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_seq_lock_matches_tests_test_mix(pkg):
    """tests/test_mix.py TestSeqLock, on each package's standalone
    lock service."""
    ls = STANDALONE[pkg]()
    l1, l2 = ls.lock("/ml"), ls.lock("/ml")
    assert l1.try_lock() is True
    assert l2.try_lock() is False
    l1.unlock()
    assert l2.try_lock() is True
    assert l2.still_held()
    ls.remove(l2.my_node)
    assert l2.still_held() is False
    l2.unlock()
    assert l2.still_held() is False


@pytest.mark.parametrize("server", ["jax", "port"])
@pytest.mark.parametrize("client", ["jax", "port"])
def test_coordinator_wire_both_ways(client, server):
    """The coordinator and lock-service cases of tests/test_mix.py over
    the wire, for every pairing of the two packages' clients and
    coordinators: nodes, sequence nodes, cversion, ids, the election
    lock, the epoch fence on every call, and ephemerals reaped when a
    session closes or stops heartbeating."""
    coord = COORDINATORS[server](session_ttl=1.0)
    port = coord.start(0, "127.0.0.1")
    addr = f"127.0.0.1:{port}"
    ls = LOCKS[client](addr, timeout=5.0, retry_for=5.0)
    other = LOCKS[client](addr, timeout=5.0, retry_for=5.0)
    try:
        assert ls._epoch == 1          # the open_session handshake
        assert ls.create("/a/b/c", b"v1")
        assert not ls.create("/a/b/c", b"x")
        assert ls.get("/a/b/c") == b"v1"
        ls.set("/a/b/c", b"v2\xff\x00")
        assert ls.get("/a/b/c") == b"v2\xff\x00"
        names, v0 = ls.list_versioned("/a/b")
        assert names == ["c"] and v0 >= 1
        ls.create("/a/b/d")
        assert ls.list_versioned("/a/b")[1] != v0
        assert ls.remove("/a/b/c") and not ls.exists("/a/b/c")
        assert ls.create_seq("/locks/lock-") == "/locks/lock-0000000001"
        assert [ls.create_id("k") for _ in range(3)] == [1, 2, 3]
        assert other.create_id("k") == 4
        l1, l2 = ls.lock("/ml"), other.lock("/ml")
        assert l1.try_lock() and not l2.try_lock()
        assert l1.still_held()
        l1.unlock()
        assert l2.try_lock()
        l2.unlock()
        # ephemerals: gone with a closed session ...
        assert other.create("/eph/closed", ephemeral=True)
        other.close()
        wait_until(lambda: not ls.exists("/eph/closed"), 5, "close reap")
        # ... and with a session that stops heartbeating (TTL 1 s)
        quiet = LOCKS[client](addr, timeout=5.0, retry_for=5.0)
        assert quiet.create("/eph/quiet", ephemeral=True)
        assert ls.exists("/eph/quiet")
        quiet._stop.set()
        quiet._client.close()
        wait_until(lambda: not ls.exists("/eph/quiet"), 10, "ttl reap")
        # a higher fence is refused with the typed error.  The JAX
        # coordinator then stands down; the port's, with no standby to
        # hand over to, stays primary at its epoch for every other caller
        with Client("127.0.0.1", port, timeout=5.0) as c:
            assert c.call_raw("role")[0] == "primary"
            with pytest.raises(Exception, match="fenced"):
                c.call_raw("exists", "/a", 99)
            if server == "jax":
                assert c.call_raw("role")[0] == "standby"
            else:
                assert c.call_raw("role")[::2] == ["primary", 1]
                assert ls.exists("/a/b/d") and ls.create_id("k") == 5
    finally:
        ls.retry_for = 0.5
        ls.close()
        coord.stop()


def test_create_lock_service_kinds():
    assert isinstance(create_lock_service("standalone"), TStandalone)
    coord = TCoordinator()
    port = coord.start(0, "127.0.0.1")
    try:
        ls = create_lock_service("coordinator", f"127.0.0.1:{port}")
        assert isinstance(ls, TLock)
        assert ls.create("/kinds") and coord.state.get("/kinds") is not None
        ls.close()
    finally:
        coord.stop()
    with pytest.raises(ValueError, match="address required"):
        create_lock_service("coordinator")
    with pytest.raises(ValueError, match="unknown lock service"):
        create_lock_service("zookeeper", "127.0.0.1:2181")


# ---------------------------------------------------------------------------
# gossip candidates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["random", "broadcast", "skip"])
@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_filter_candidates_matches_jax(strategy, n):
    members = [("h", p) for p in range(n)]
    for me in members:
        for seed in range(4):
            assert tfilter(strategy, members, me, random.Random(seed)) == \
                jfilter(strategy, members, me, random.Random(seed))
    if n == 8:
        assert tfilter("skip", members, ("h", 0), random.Random()) == \
            [("h", 4), ("h", 2), ("h", 1)]
    if n > 1:
        with pytest.raises(ValueError):
            tfilter("ring", members, members[0], random.Random())


# ---------------------------------------------------------------------------
# in-process LinearMixer (tests/test_mix.py TestLinearMixerInProcess)
# ---------------------------------------------------------------------------


def inproc_server(ls, name="c", mixer_name="linear_mixer", quantize=False):
    """A port server (--device cpu) in a cluster on a shared lock
    service, its trigger out of reach (only mix_now mixes)."""
    args = ServerArgs(type="classifier", name=name, rpc_port=0,
                      eth="127.0.0.1", device="cpu")
    server = JubatusServer(args, config=json.dumps(CONFIG))
    membership = MembershipClient(ls, "classifier", name)
    server.membership = membership
    server.mixer = create_mixer(mixer_name, server, membership,
                                interval_sec=1e9, interval_count=10 ** 9,
                                quantize=quantize)
    rpc = RpcServer()
    bind_service(server, rpc)
    bound = rpc.start(0, host="127.0.0.1")
    args.rpc_port = bound
    membership.register_actor("127.0.0.1", bound)
    server.mixer.register_active("127.0.0.1", bound)
    return server, server.mixer, rpc, bound


@pytest.fixture()
def cluster():
    started = []

    def make(n, **kw):
        ls = TStandalone()
        for _ in range(n):
            started.append(inproc_server(ls, **kw))
        return started[-n:]

    yield make
    for server, _m, rpc, _p in started:
        rpc.stop()
        server.stop()


XA = Datum().add_string("t", "apple")
XB = Datum().add_string("t", "banana")


@pytest.mark.parametrize("quantize", [False, True])
def test_gather_fold_scatter_converges(cluster, quantize):
    (s1, m1, _, _), (s2, _, _, _) = cluster(2, quantize=quantize)
    s1.driver.train([("A", XA), ("B", XB)])
    s2.driver.train([("A", XA), ("B", XB), ("A", XA), ("B", XB)])
    assert m1.mix_now() is True
    assert s1.driver.get_labels() == s2.driver.get_labels() == \
        {"A": 3, "B": 3}
    assert s1.driver.classify([XA]) == s2.driver.classify([XA])
    st = s1.get_status()[s1.server_id]
    assert st["is_standalone"] == "0" and st["mix_round"] == "1"
    assert st["mix_wire_version"] == ("3" if quantize else "2")
    assert int(st["mix_bytes_sent_total"]) > 0


def test_do_mix_right_after_a_join_folds_the_joiner():
    """The master's cached member list predates the second server's
    registration; do_mix right after it, with no wait, still gathers the
    joiner: its trains are folded on both servers, not dropped as a
    straggler's diff and then lost to the catch-up."""
    ls = TStandalone()
    started = [inproc_server(ls, name="j")]
    try:
        s1, m1, _, p1 = started[0]
        assert len(m1.membership.get_all_nodes()) == 1     # now cached
        started.append(inproc_server(ls, name="j"))
        s2, m2, _, _ = started[1]
        s1.driver.train([("A", XA)])
        s2.driver.train([("B", XB), ("B", XB)])
        with Client("127.0.0.1", p1, timeout=60) as c:
            assert c.call_raw("do_mix", "j") is True
            assert c.call_raw("do_mix", "j") is True
        for s in (s1, s2):
            assert s.driver.get_labels() == {"A": 1, "B": 2}
        assert m2._behind is None and m2.round == m1.round == 2
    finally:
        for server, _m, rpc, _p in started:
            rpc.stop()
            server.stop()


def test_idgen_draws_cluster_ids_from_the_coordinator(cluster):
    (s1, _, _, _), (s2, _, _, _) = cluster(2)
    assert [s1.idgen(), s2.idgen(), s1.idgen()] == [1, 2, 3]
    alone = JubatusServer(ServerArgs(type="classifier", name="c",
                                     eth="127.0.0.1", device="cpu"),
                          config=json.dumps(CONFIG))
    assert [alone.idgen(), alone.idgen()] == [1, 2]


def test_master_lock_prevents_concurrent_round(cluster):
    [(s1, m1, _, _)] = cluster(1)
    lock = m1.membership.master_lock()
    assert lock.try_lock()
    assert m1.mix_now() is False
    lock.unlock()
    s1.driver.train([("A", Datum().add_string("t", "a"))])
    assert m1.mix_now() is True


def test_master_stands_down_when_lock_reaped_mid_round(cluster):
    (s1, m1, _, _), _ = cluster(2)
    s1.driver.train([("A", Datum().add_string("t", "a"))])
    lock = m1.membership.master_lock()
    assert lock.try_lock()
    m1.membership.ls.remove(lock.my_node)
    assert m1.mix(lock=lock) is False
    assert m1.mix_count == 0


def test_updated_threshold_triggers():
    ls = TStandalone()
    server = JubatusServer(ServerArgs(type="classifier", name="t",
                                      eth="127.0.0.1", device="cpu"),
                           config=json.dumps(CONFIG))
    mixer = LinearMixer(server, MembershipClient(ls, "classifier", "t"),
                        interval_sec=1e9, interval_count=3)
    server.mixer = mixer
    for _ in range(2):
        server.event_model_updated()
    assert mixer.counter == 2
    server.event_model_updated()
    assert mixer.counter == 3


def test_interval_count_fires_a_round_on_the_mixer_thread(cluster):
    (s1, m1, _, _), (s2, m2, _, _) = cluster(2)
    for m in (m1, m2):
        m.interval_count = 2
        m.start()
    s1.driver.train([("A", XA)])
    s2.driver.train([("B", XB)])
    for s in (s1, s2):
        s.event_model_updated()
        s.event_model_updated()
    wait_until(lambda: s1.driver.get_labels() == s2.driver.get_labels()
               == {"A": 1, "B": 1}, 15, "triggered round")


def test_bootstrap_from_peer(cluster):
    [(s1, _, _, p1)] = cluster(1)
    s1.driver.train([("A", XA), ("B", XB)])
    joiner = JubatusServer(ServerArgs(type="classifier", name="c",
                                      eth="127.0.0.1", device="cpu"),
                           config=json.dumps(CONFIG))
    bootstrap_from_peer(joiner, "127.0.0.1", p1)
    assert joiner.driver.get_labels() == s1.driver.get_labels()
    assert joiner.driver.classify([XA]) == s1.driver.classify([XA])


def test_partial_scatter_does_not_double_fold(cluster):
    (s1, m1, _, _), (s2, m2, _, p2) = cluster(2, name="pf")
    s1.driver.train([("A", XA), ("B", XB)])
    s2.driver.train([("A", XA), ("B", XB)])
    real_fanout = m1._fanout

    def drop_s2_put(members, method, *args):
        if method == "put_diff":
            members = [hp for hp in members if hp[1] != p2]
        return real_fanout(members, method, *args)

    m1._fanout = drop_s2_put
    assert m1.mix_now() is True
    assert s1.driver.get_labels() == {"A": 2, "B": 2}
    m1._fanout = real_fanout
    assert m1.mix_now() is True
    assert s1.driver.get_labels() == {"A": 2, "B": 2}, "double-folded"
    assert m2._behind is not None
    assert m2.catch_up_if_behind() is True
    assert s2.driver.get_labels() == {"A": 2, "B": 2}
    assert m2.round == m1.round


@pytest.mark.parametrize("mixer_name", ["random_mixer", "broadcast_mixer",
                                        "skip_mixer"])
def test_gossip_round_converges(cluster, mixer_name):
    (s1, m1, _, _), (s2, _, _, _) = cluster(2, mixer_name=mixer_name)
    s1.driver.train([("A", XA), ("B", XB)])
    s2.driver.train([("B", XB), ("A", XA)])
    assert m1.mix_now() is True
    # label rows are numbered per server: compare by label
    assert dict(s1.driver.classify([XA])[0]) == \
        dict(s2.driver.classify([XA])[0])


# ---------------------------------------------------------------------------
# do_mix against raw trains in flight
# ---------------------------------------------------------------------------


def _train_frame(msgid, batch):
    return msgpack.packb([0, msgid, "train", ["c", batch]],
                         use_bin_type=False)


def test_do_mix_returns_while_raw_trains_are_in_flight(cluster):
    """do_mix fans get_diff and put_diff out to this server too, on the
    call pool, while another connection keeps the raw pool and the ingest
    pipeline busy: the round returns, every frame is acked, and after a
    second round in the quiet cluster both servers hold the same model.
    (Trains that land between a server's get_diff snapshot and its
    put_diff are overwritten by the fold, in both packages: put_diff sets
    each touched entry to base + merged diff.  So the counts are at most,
    not exactly, the trains sent.)"""
    (s1, _, _, p1), (s2, _, _, p2) = cluster(2)
    assert s1.dispatcher is not None     # the raw route is live
    n_frames, per = 40, 32
    acked = []
    failed = []

    def stream():
        try:
            sock = socket.create_connection(("127.0.0.1", p1), timeout=60)
            for i in range(n_frames):
                batch = [[f"l{j % 3}", datum_wire(strings=[("t", f"w{i}_{j}")])]
                         for j in range(per)]
                sock.sendall(_train_frame(i + 1, batch))
            unp = msgpack.Unpacker(raw=False)
            while len(acked) < n_frames:
                data = sock.recv(1 << 16)
                if not data:
                    break
                unp.feed(data)
                for msg in unp:
                    acked.append(msg)
            sock.close()
        except Exception as e:  # noqa: BLE001 - reported by the test
            failed.append(e)

    t = threading.Thread(target=stream)
    t.start()
    # the round starts while frames are still being converted
    wait_until(lambda: s1.dispatcher.frames > 0, 30, "first frame")
    with Client("127.0.0.1", p1, timeout=60) as c:
        t0 = time.monotonic()
        assert c.call_raw("do_mix", "c") is True
        # a self-call stuck behind the event loop costs a leg its whole
        # deadline budget (interconnect_timeout) before it gives up
        assert time.monotonic() - t0 < s1.args.interconnect_timeout
    t.join(timeout=60)
    assert not t.is_alive() and not failed
    assert len(acked) == n_frames and all(m[2] is None for m in acked)
    # the frames acked after the round land in the next one
    with Client("127.0.0.1", p2, timeout=60) as c:
        assert c.call_raw("do_mix", "c") is True
    labels = s1.driver.get_labels()
    assert labels == s2.driver.get_labels()
    assert 0 < sum(labels.values()) <= n_frames * per
    assert dict(s1.driver.classify([XA])[0]) == \
        dict(s2.driver.classify([XA])[0])


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_cli_refuses_collective_mixer(tmp_path):
    """Since the data-parallel tier the CLI serves collective_mixer (a
    CollectiveMixer around a LinearMixer in a cluster; standalone the
    DummyMixer, as for any mixer name) and refuses only an unknown
    name."""
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps(CONFIG))
    r = subprocess.run(
        [sys.executable, "-m", "jubatus_tpu_torch.cli.server", "--type",
         "classifier", "--configpath", str(cfg), "--rpc-port", "0",
         "--listen_addr", "127.0.0.1", "--device", "cpu",
         "--mixer", "bogus_mixer"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "jubatus ready" not in r.stdout
    assert "unknown mixer: bogus_mixer" in r.stderr
    with pytest.raises(ValueError, match="unknown mixer"):
        create_mixer("bogus_mixer", None, object())
    from jubatus_tpu_torch.mix.collective import CollectiveMixer
    from jubatus_tpu_torch.mix.linear_mixer import DummyMixer, LinearMixer
    assert isinstance(create_mixer("collective_mixer", None, None),
                      DummyMixer)
    mixer = create_mixer("collective_mixer", object(), object())
    assert isinstance(mixer, CollectiveMixer)
    assert isinstance(mixer.inner, LinearMixer)


def test_cli_fails_without_a_reachable_coordinator(tmp_path):
    """No fallback to standalone: a coordinator that does not answer
    fails the start."""
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps(CONFIG))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = s.getsockname()[1]
    s.close()
    r = subprocess.run(
        [sys.executable, "-m", "jubatus_tpu_torch.cli.server", "--type",
         "classifier", "--configpath", str(cfg), "--rpc-port", "0",
         "--listen_addr", "127.0.0.1", "--device", "cpu",
         "--coordinator", f"127.0.0.1:{dead}"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "jubatus ready" not in r.stdout
