"""Per-slot MIX groups across the two packages, and the legacy wire.

  * a mixed cluster (the port's coordinator, one JAX server and one CPU
    port server, in process), each server with its default slot and a
    slot m1: one do_mix of m1 converges m1 on both servers to the tables
    of a single-model mixed cluster fed the same trains (within
    tests/test_torch_classifier.py's tolerance, labels and counts exact)
    and leaves both default slots bitwise as they were; a do_mix of the
    default slot then leaves m1 bitwise as it was;
  * a one-slot port server's MIX frames are the legacy wire: the gather
    argument 0, put_diff one argument, get_model 0, exactly as the
    single-model server sent them; a slot's mixer names its model in
    each (the gather map's "model", put_diff's second argument,
    get_model's {"model"} map).
"""

import json

import msgpack
import numpy as np
import pytest

from jubatus_tpu.cluster.cht import CHT as JCHT
from jubatus_tpu.cluster.lock_service import CoordLockService as JLock
from jubatus_tpu.cluster.membership import MembershipClient as JMembership
from jubatus_tpu.framework import server_base as jserver_base
from jubatus_tpu.framework.service import bind_service as jbind
from jubatus_tpu.mix.mixer_factory import create_mixer as jcreate_mixer
from jubatus_tpu.rpc.server import RpcServer as JRpcServer
from jubatus_tpu.tenancy import ClusterContext as JClusterContext
from jubatus_tpu.tenancy import SlotMixRouter as JSlotMixRouter
from jubatus_tpu_torch.cluster.cht import CHT as TCHT
from jubatus_tpu_torch.cluster.coordinator import CoordinatorServer
from jubatus_tpu_torch.cluster.lock_service import CoordLockService as TLock
from jubatus_tpu_torch.cluster.lock_service import StandaloneLockService
from jubatus_tpu_torch.cluster.membership import \
    MembershipClient as TMembership
from jubatus_tpu_torch.framework import server_base as tserver_base
from jubatus_tpu_torch.framework.service import bind_service as tbind
from jubatus_tpu_torch.mix import linear_mixer as tlinear
from jubatus_tpu_torch.mix.mixer_factory import create_mixer as tcreate_mixer
from jubatus_tpu_torch.rpc import client as tclient
from jubatus_tpu_torch.rpc.client import Client
from jubatus_tpu_torch.rpc.server import RpcServer as TRpcServer
from jubatus_tpu_torch.tenancy import ClusterContext as TClusterContext
from tests.test_torch_tenancy import CONFIG, batch, flush_all, pack_of
from tests.test_torch_tenancy_durability import assert_close

STREAMS = ("east", "west")


def jax_member(ls, name):
    """An in-process JAX server in cluster `name`, wired as its CLI wires
    one (SlotMixRouter, ClusterContext), its trigger out of reach."""
    args = jserver_base.ServerArgs(type="classifier", name=name, rpc_port=0,
                                   eth="127.0.0.1")
    server = jserver_base.JubatusServer(args, config=json.dumps(CONFIG))
    membership = JMembership(ls, "classifier", name)
    server.membership = membership
    server.idgen = membership.create_id
    server.mixer = jcreate_mixer("linear_mixer", server, membership,
                                 interval_sec=1e9, interval_count=10 ** 9)
    server.cluster_ctx = JClusterContext(ls=ls, interval_sec=1e9,
                                         interval_count=10 ** 9)
    rpc = JRpcServer(threads=2)
    JSlotMixRouter(server).register_api(rpc)
    jbind(server, rpc)
    port = rpc.start(0, host="127.0.0.1")
    args.rpc_port = port
    membership.register_actor("127.0.0.1", port)
    cht = JCHT(ls, "classifier", name, cache_ttl=0.0)
    cht.register_node("127.0.0.1", port)
    server.cht = cht
    server.mixer.register_active("127.0.0.1", port)
    return server, rpc, port


def port_member(ls, name):
    """The same for a port server on the CPU (bind_service registers the
    SlotMixRouter for a LinearMixer)."""
    args = tserver_base.ServerArgs(type="classifier", name=name, rpc_port=0,
                                   eth="127.0.0.1", device="cpu")
    server = tserver_base.JubatusServer(args, config=json.dumps(CONFIG))
    membership = TMembership(ls, "classifier", name)
    server.membership = membership
    server.mixer = tcreate_mixer("linear_mixer", server, membership,
                                 interval_sec=1e9, interval_count=10 ** 9)
    server.cluster_ctx = TClusterContext(ls=ls, interval_sec=1e9,
                                         interval_count=10 ** 9)
    rpc = TRpcServer()
    tbind(server, rpc)
    port = rpc.start(0, host="127.0.0.1")
    args.rpc_port = port
    membership.register_actor("127.0.0.1", port)
    cht = TCHT(ls, "classifier", name, cache_ttl=0.0)
    cht.register_node("127.0.0.1", port)
    server.cht = cht
    server.mixer.register_active("127.0.0.1", port)
    return server, rpc, port


def train(port, name, stream, n):
    rng = np.random.default_rng(len(stream) + n)
    with Client("127.0.0.1", port, timeout=120) as c:
        for i in range(n):
            c.call_raw("train", name, batch(stream, i, rng))


def packed(slot) -> bytes:
    return msgpack.packb(pack_of(slot), use_bin_type=True)


@pytest.fixture
def coordinator():
    coord = CoordinatorServer()
    port = coord.start(0, "127.0.0.1")
    yield f"127.0.0.1:{port}"
    coord.stop()


def test_mixed_per_slot_rounds_match_a_single_model_cluster(coordinator):
    jls, tls = JLock(coordinator), TLock(coordinator)
    members = []
    try:
        # the reference: a single-model mixed cluster "ref"
        ref = [jax_member(jls, "ref"), port_member(tls, "ref")]
        members += [("jax",) + ref[0], ("port",) + ref[1]]
        for (srv, _, port), stream in zip(ref, STREAMS):
            train(port, "ref", stream, 6)
            flush_all(srv)
        assert ref[1][0].do_mix("ref") is True
        want = pack_of(ref[0][0])
        assert_close(pack_of(ref[1][0]), want, "ref replicas")

        # two slots a server: the default and m1
        multi = [jax_member(jls, "c"), port_member(tls, "c")]
        members += [("jax",) + multi[0], ("port",) + multi[1]]
        for srv, _, _ in multi:
            srv.create_model({"name": "m1", "tenant": "t1"})
        for (srv, _, port), stream in zip(multi, STREAMS):
            train(port, "m1", stream, 6)
            train(port, "c", "default-" + stream, 3)
            flush_all(srv)
        defaults = [packed(srv) for srv, _, _ in multi]
        # one m1 round, from the port server, over the name-routed wire
        assert multi[1][0].do_mix("m1") is True
        for srv, _, _ in multi:
            assert_close(pack_of(srv.slot_for("m1")), want, "m1 vs ref")
            assert srv.slot_for("m1").mixer.round == 1
            assert srv.mixer.round == 0
        assert [packed(srv) for srv, _, _ in multi] == defaults
        # then the default slot's round, from the JAX server: m1 stays
        m1s = [packed(srv.slot_for("m1")) for srv, _, _ in multi]
        with Client("127.0.0.1", multi[0][2], timeout=120) as c:
            assert c.call_raw("do_mix", "c") is True
        assert_close(pack_of(multi[0][0]), pack_of(multi[1][0]), "defaults")
        assert [packed(srv.slot_for("m1")) for srv, _, _ in multi] == m1s
        assert multi[1][0].mixer.round == 1
    finally:
        for pkg, srv, rpc, _ in members:
            srv.slots.shutdown_all()
            rpc.stop()
            if pkg == "port":
                for plane in (srv.dispatcher, srv.read_dispatch):
                    if plane is not None:
                        plane.stop()
        jls.close()
        tls.close()


class Recorder:
    """The MIX legs' wire arguments, as the senders pass them."""

    def __init__(self, monkeypatch):
        self.calls = []
        rec = self.calls
        # call_each is a loop over call_each_iter
        each_iter = tclient.MClient.call_each_iter
        raw = tclient.Client.call_raw

        def call_each_iter(self_, method, *params, **kw):
            rec.append((method, params))
            return each_iter(self_, method, *params, **kw)

        def call_raw(self_, method, *params):
            if method == "get_model":
                rec.append((method, params))
            return raw(self_, method, *params)

        monkeypatch.setattr(tclient.MClient, "call_each_iter",
                            call_each_iter)
        monkeypatch.setattr(tclient.Client, "call_raw", call_raw)

    def of(self, method):
        return [p for m, p in self.calls if m == method]


def test_mix_frames_are_the_legacy_wire_with_one_slot(monkeypatch):
    rec = Recorder(monkeypatch)
    ls = StandaloneLockService()
    servers = [port_member(ls, "c") for _ in range(2)]
    try:
        for (srv, _, port), stream in zip(servers, STREAMS):
            train(port, "c", stream, 3)
            flush_all(srv)
        assert servers[0][0].do_mix() is True
        [gather] = rec.of("get_diff")
        [scatter] = rec.of("put_diff")
        assert gather == (0,)
        assert len(scatter) == 1
        assert sorted(scatter[0]) == ["diff", "master", "protocol_version",
                                      "round"]
        host, port = "127.0.0.1", servers[1][2]
        assert tlinear.bootstrap_from_peer(servers[0][0], host, port)
        assert rec.of("get_model") == [(0,)]
        # the bytes on the wire: the argument arrays the legacy mixer sent
        assert msgpack.packb(list(gather)) == msgpack.packb([0])

        # a slot's mixer names its model in every frame
        rec.calls.clear()
        ctx = TClusterContext(ls=ls, interval_sec=1e9,
                              interval_count=10 ** 9)
        for srv, _, _ in servers:
            srv.cluster_ctx = ctx
            srv.create_model({"name": "m1"})
        for (srv, _, port), stream in zip(servers, STREAMS):
            train(port, "m1", stream, 3)
            flush_all(srv)
        assert servers[0][0].do_mix("m1") is True
        [gather] = rec.of("get_diff")
        [scatter] = rec.of("put_diff")
        assert gather == ({"r": 0, "model": "m1"},)
        assert len(scatter) == 2 and scatter[1] == "m1"
        assert tlinear.bootstrap_from_peer(servers[0][0].slot_for("m1"),
                                           host, port, model="m1")
        assert rec.of("get_model") == [({"model": "m1"},)]
        m1 = [packed(srv.slot_for("m1")) for srv, _, _ in servers]
        assert m1[0] == m1[1]
    finally:
        for srv, rpc, _ in servers:
            rpc.stop()
            srv.stop()
