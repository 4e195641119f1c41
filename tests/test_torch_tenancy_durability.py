"""Recovery of every model slot, across the two packages.

  * a WAL root a JAX server wrote with two secondary slots recovers in a
    CPU port server (the same slot set, tenants and quotas, each slot's
    tables within tests/test_torch_classifier.py's tolerance, labels and
    counts exact, the catalog untouched), and a root the port wrote
    recovers in a JAX server the same way;
  * a dropped slot stays dropped across a reboot, its namespace gone;
  * kill -9 of a port server process (the CLI, --device cpu) restores
    every slot: each slot's saved model is bitwise an in-process replay
    of its own namespace as the kill left it;
  * a root holding the JAX autopilot's migration record, or a catalog
    entry marked standby, is refused, naming ROADMAP Queue 1 item 7.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import msgpack
import numpy as np
import pytest

from jubatus_tpu_torch.durability.recovery import recover
from jubatus_tpu_torch.framework import server_base as tserver_base
from jubatus_tpu_torch.framework.save_load import load_model
from jubatus_tpu_torch.rpc.client import Client
from jubatus_tpu_torch.tenancy import layout as tlayout
from tests.test_torch_classifier import ATOL, RTOL
from tests.test_torch_durability import tables
from tests.test_torch_server import REPO
from tests.test_torch_tenancy import (CONFIG, PKG, batch, flush_all,
                                      make_server, pack_of, stop_server)

NAMES = ("c", "m1", "m2")


def write_root(pkg, root, datadir):
    """A `pkg` server on `root` with slots m1 and m2 beside the default,
    each trained over the wire; stopped with every record on disk.
    Returns the slots' packs."""
    srv, rpc, port = make_server(pkg, journal_dir=str(root),
                                 journal_fsync="always",
                                 snapshot_interval_sec=0.0,
                                 datadir=str(datadir))
    try:
        srv.create_model({"name": "m1", "tenant": "t1",
                          "quota": {"train_rps": 99}})
        srv.create_model({"name": "m2"})
        rng = np.random.default_rng(7)
        with Client("127.0.0.1", port, timeout=60) as c:
            for name in NAMES:
                for i in range(6):
                    c.call_raw("train", name, batch(name, i, rng))
        flush_all(srv)
        return {n: pack_of(srv.slot_for(n)) for n in NAMES}
    finally:
        stop_server(pkg, srv, rpc)


def boot(pkg, root, datadir):
    base = PKG[pkg][0]
    kw = {"device": "cpu"} if pkg == "port" else {}
    srv = base.JubatusServer(
        base.ServerArgs(type="classifier", name="c", journal_dir=str(root),
                        journal_fsync="always", snapshot_interval_sec=0.0,
                        datadir=str(datadir), **kw),
        config=json.dumps(CONFIG))
    srv.init_durability()
    return srv


def shut(pkg, srv):
    if pkg == "port":
        srv.stop()
    else:
        srv.slots.shutdown_all()
        srv.shutdown_durability()


def assert_close(a, b, what):
    ta, tb = tables("classifier", a), tables("classifier", b)
    assert sorted(ta) == sorted(tb), what
    for k in ta:
        if k.startswith("count:"):
            np.testing.assert_array_equal(ta[k], tb[k], err_msg=what)
        else:
            np.testing.assert_allclose(ta[k], tb[k], rtol=RTOL, atol=ATOL,
                                       err_msg=what)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_a_multi_slot_root_recovers_in_the_other_package(tmp_path, writer,
                                                         reader):
    root = tmp_path / "wal"
    packs = write_root(writer, root, tmp_path)
    catalog = (root / "MODELS.json").read_bytes()
    srv = boot(reader, root, tmp_path)
    try:
        assert set(srv.list_models()) == set(NAMES)
        for name in NAMES:
            assert_close(pack_of(srv.slot_for(name)), packs[name], name)
            assert srv.slot_for(name).recovery_info.replayed > 0
        m1 = srv.slot_for("m1")
        assert m1.tenant == "t1" and m1.quota.train_rps == 99
        assert srv.slot_for("m2").quota is None
        assert (root / "MODELS.json").read_bytes() == catalog
    finally:
        shut(reader, srv)


def test_a_dropped_slot_stays_dropped_across_a_reboot(tmp_path):
    root = tmp_path / "wal"
    srv, rpc, _ = make_server("port", journal_dir=str(root),
                              snapshot_interval_sec=0.0,
                              datadir=str(tmp_path))
    srv.create_model({"name": "m1"})
    srv.create_model({"name": "m2"})
    assert os.path.isdir(tlayout.slot_dir(str(root), "m1"))
    srv.drop_model("m1")
    assert not os.path.exists(tlayout.slot_dir(str(root), "m1"))
    stop_server("port", srv, rpc)
    srv = boot("port", root, tmp_path)
    try:
        assert set(srv.list_models()) == {"c", "m2"}
        assert [m["name"] for m in tlayout.load_catalog(str(root))] == ["m2"]
    finally:
        srv.stop()


def test_a_migration_record_is_refused_naming_item_7(tmp_path):
    root = tmp_path / "wal"
    root.mkdir()
    (root / "MIGRATION.json").write_text(json.dumps(
        {"version": 1, "name": "m1", "state": "catchup"}))
    srv = tserver_base.JubatusServer(
        tserver_base.ServerArgs(type="classifier", name="c", device="cpu",
                                journal_dir=str(root)),
        config=json.dumps(CONFIG))
    with pytest.raises(RuntimeError, match="Queue 1 item 7"):
        srv.init_durability()
    assert srv.journal is None
    srv.stop()


def test_a_standby_slot_in_the_catalog_is_refused_naming_item_7(tmp_path):
    root = tmp_path / "wal"
    tlayout.prepare_root(str(root))
    tlayout.store_catalog(str(root), [{"name": "m1", "tenant": "",
                                       "config": json.dumps(CONFIG),
                                       "quota": None, "standby": True}])
    srv = tserver_base.JubatusServer(
        tserver_base.ServerArgs(type="classifier", name="c", device="cpu",
                                journal_dir=str(root)),
        config=json.dumps(CONFIG))
    try:
        with pytest.raises(RuntimeError, match="Queue 1 item 7"):
            srv.init_durability()
        assert srv.slot_for("m1") is srv
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# kill -9 of a port server process
# ---------------------------------------------------------------------------


def spawn(tmp_path):
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(CONFIG))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    return subprocess.Popen(
        [sys.executable, "-m", "jubatus_tpu_torch.cli.server", "--type",
         "classifier", "--configpath", str(cfg), "--rpc-port", "0",
         "--listen_addr", "127.0.0.1", "--datadir", str(tmp_path),
         "--journal", str(tmp_path / "wal"), "--journal_fsync", "always",
         "--snapshot_interval", "0", "--name", "c", "--device", "cpu"],
        cwd=REPO, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL)


def ready_port(proc, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            raise AssertionError("the server exited before it was ready")
        if line.startswith("jubatus ready"):
            return int(line.split("rpc_port=")[1].split()[0])
    raise TimeoutError("no ready line")


def test_kill_9_restores_every_slot(tmp_path):
    p = spawn(tmp_path)
    try:
        port = ready_port(p)
        rng = np.random.default_rng(11)
        with Client("127.0.0.1", port, timeout=60) as c:
            assert c.call_raw("create_model", "c",
                              {"name": "m1", "tenant": "t1"}) is True
            assert c.call_raw("create_model", "c", {"name": "m2"}) is True
            for name in NAMES:
                for i in range(8):
                    c.call_raw("train", name, batch(name, i, rng))
            # a save flushes each slot's pipeline: every ack is on disk
            for name in NAMES:
                c.call_raw("save", name, "prewarm")
        p.kill()
        p.wait(timeout=30)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)
    # the oracle replays a copy of the root as the kill left it (the
    # restarted server re-anchors it with a snapshot)
    shutil.copytree(tmp_path / "wal", tmp_path / "at_kill")
    p2 = spawn(tmp_path)
    try:
        port2 = ready_port(p2)
        with Client("127.0.0.1", port2, timeout=60) as c:
            models = c.call_raw("list_models", "c")
            assert set(models) == set(NAMES)
            assert models["m1"]["tenant"] == "t1"
            for name in NAMES:
                [path] = c.call_raw("save", name, "postcrash").values()
                with open(path, "rb") as fp:
                    saved = load_model(fp, server_type="classifier",
                                       expected_config=json.dumps(CONFIG),
                                       user_data_version=1)
                ns = str(tmp_path / "at_kill") if name == "c" \
                    else tlayout.slot_dir(str(tmp_path / "at_kill"), name)
                oracle = tserver_base.JubatusServer(
                    tserver_base.ServerArgs(type="classifier", name=name,
                                            device="cpu"),
                    config=json.dumps(CONFIG))
                assert recover(oracle, ns).replayed > 0
                assert msgpack.packb(saved) == \
                    msgpack.packb(oracle.driver.pack()), name
            c.call_raw("train", "m1", batch("post", 0))
            assert c.call_raw("classify", "m1", [[[["k", "x"]], [], []]])
    finally:
        p2.terminate()
        try:
            p2.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p2.kill()
