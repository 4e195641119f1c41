"""kill -9 drills of the port's durability plane, with real server
processes (python -m jubatus_tpu_torch.cli.server --device cpu).

- A standalone server with --journal acks raw trains over the wire, is
  SIGKILLed and restarted on the same directory: every acked row is
  back, its model bitwise the one of a driver fed the same frames one by
  one through its raw entry, and it serves reads.
- A member of a two-server port cluster (the port's coordinator, v3
  wire) is SIGKILLed after a do_mix, whose applied scatter it journaled,
  and restarted on its directory: it comes back bitwise equal to its
  model before the kill (the scatter replays through the dequantizer),
  rejoins at the recovered round, and after one more do_mix agrees with
  its peer.

Every wait has its own timeout."""

import json
import signal
import sys

import msgpack

from jubatus_tpu_torch.cluster.membership import MembershipClient
from jubatus_tpu_torch.framework.save_load import load_model
from jubatus_tpu_torch.framework.server_base import USER_DATA_VERSION
from jubatus_tpu_torch.mix import codec
from jubatus_tpu_torch.rpc.client import Client
from tests.test_torch_cluster_mixed import Proc
from tests.test_torch_durability import (CONFIGS, Wire, train_frames, twin,
                                         wait_until)

START_S = 60
CALL_S = 30


def server_argv(tmp_path, tag, *extra):
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps(CONFIGS["classifier"]))
    return [sys.executable, "-m", "jubatus_tpu_torch.cli.server", "--type",
            "classifier", "--configpath", str(cfg), "--rpc-port", "0",
            "--listen_addr", "127.0.0.1", "--eth", "127.0.0.1", "--device",
            "cpu", "--datadir", str(tmp_path), "--journal",
            str(tmp_path / f"dur_{tag}"), "--journal_fsync", "batch", *extra]


def port_of(proc):
    return int(proc.wait_for("jubatus ready", START_S).split()[2]
               .split("=")[1])


def sigkill(proc):
    proc.p.send_signal(signal.SIGKILL)
    proc.p.wait(timeout=CALL_S)


def saved_pack(port, tmp_path, mid):
    """The server's model through its save RPC, as the driver's pack."""
    with Client("127.0.0.1", port, timeout=CALL_S) as c:
        (path,) = c.call_raw("save", "", mid).values()
    with open(path, "rb") as fp:
        data = load_model(fp, server_type="classifier",
                          expected_config=json.dumps(CONFIGS["classifier"]),
                          user_data_version=USER_DATA_VERSION)
    return msgpack.packb(data, use_bin_type=True)


def status(port):
    with Client("127.0.0.1", port, timeout=CALL_S) as c:
        return next(iter(c.call_raw("get_status", "").values()))


def test_acked_trains_survive_sigkill_bitwise(tmp_path):
    """Two kills, no snapshot timer: the second boot replays frames 0-4
    and snapshots at once (the re-anchor after a replay), so the third
    boot restores that snapshot and replays frames 5-9 past it."""
    frames = train_frames("classifier", 17, n_frames=10, per=8)
    no_timer = ("--snapshot_interval", "0")
    p = Proc(server_argv(tmp_path, "s", *no_timer))
    try:
        for part in (frames[:5], frames[5:]):
            port = port_of(p)
            w = Wire(port)
            for fr in part:
                assert w.send(fr)[2] is None         # acked
            w.close()
            sigkill(p)
            p = Proc(server_argv(tmp_path, "s", *no_timer))
        port = port_of(p)
        st = status(port)
        assert st["recovery_restored"] == "1"
        assert int(st["recovery_replayed"]) >= 1
        assert st["recovery_errors"] == "0"
        want = msgpack.packb(twin("classifier", frames).pack(),
                             use_bin_type=True)
        assert saved_pack(port, tmp_path, "after") == want
        with Client("127.0.0.1", port, timeout=CALL_S) as c:
            assert sum(c.call_raw("get_labels", "").values()) == 80
    finally:
        p.kill()


def test_a_killed_member_recovers_its_scatter_and_rejoins(tmp_path):
    coord = Proc([sys.executable, "-m", "jubatus_tpu_torch.cluster.coordinator",
                  "--rpc-port", "0", "--listen_addr", "127.0.0.1",
                  "--session_ttl", "2"])
    procs = [coord]
    try:
        addr = coord.wait_for("jubacoordinator", START_S).split()[-1]
        cluster = ["--name", "crash", "--coordinator", addr, "--mix_quantize",
                   "--interval_sec", "100000", "--interval_count", "1000000",
                   "--snapshot_interval", "0"]
        servers = [Proc(server_argv(tmp_path, k, *cluster)) for k in "ab"]
        procs += servers
        ports = [port_of(s) for s in servers]
        members = MembershipClient(addr, "classifier", "crash")
        want = {("127.0.0.1", p) for p in ports}
        wait_until(lambda: set(members.get_all_nodes()) == want,
                   "both members listed", START_S)
        for k, port in enumerate(ports):
            w = Wire(port)
            for fr in train_frames("classifier", 40 + k, n_frames=3):
                assert w.send(fr)[2] is None
            w.close()
        with Client("127.0.0.1", ports[0], timeout=CALL_S) as c:
            assert c.call_raw("do_mix", "crash") is True

        def model(port):
            with Client("127.0.0.1", port, timeout=CALL_S) as c:
                return msgpack.packb(codec.decode(
                    c.call_raw("get_model", 0), "cpu")["model"],
                    use_bin_type=True)

        before = model(ports[1])
        assert before == model(ports[0])
        sigkill(servers[1])
        servers[1] = Proc(server_argv(tmp_path, "b", *cluster))
        procs.append(servers[1])
        ports[1] = port_of(servers[1])
        st = status(ports[1])
        # its train windows and the scatter
        assert int(st["recovery_replayed"]) >= 2
        assert st["recovery_errors"] == "0"
        assert st["mix_round"] == "1"
        assert model(ports[1]) == before
        want = {("127.0.0.1", p) for p in ports}
        wait_until(lambda: set(members.get_all_nodes()) == want,
                   "the restarted member listed", START_S)
        w = Wire(ports[0])
        for fr in train_frames("classifier", 50, n_frames=2):
            assert w.send(fr)[2] is None
        w.close()
        with Client("127.0.0.1", ports[1], timeout=CALL_S) as c:
            assert c.call_raw("do_mix", "crash") is True
        assert model(ports[0]) == model(ports[1])
        assert status(ports[1])["mix_round"] == "2"
        members.close()
    finally:
        for p in procs:
            p.kill()
