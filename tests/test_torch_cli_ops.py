"""The port's server and proxy CLIs against the JAX package's, on the CPU:

- every flag the port's server (proxy) shares with jubatus_tpu/cli/
  server.py (cli/proxy.py) has the JAX parser's default, read from both
  parsers;
- the flags of later ROADMAP Queue 1 items are accepted at their
  default and refused otherwise, the message naming the item;
- --logfile with --log_format json writes one JSON object a record with
  the JAX formatter's fields (slow-op lines carry the trace ids), and
  SIGHUP reopens the file after a rotation;
- --model_file loads a model file the JAX server saved;
- --debug_locks: the flush()-under-the-model-lock rule raises
  LockDisciplineError as in JAX, JUBATUS_LOCK_CHECK=1 makes the checked
  lock of both packages raise on the same misuse, and the two lock-order
  monitors report the same violations.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from jubatus_tpu.analysis import lockgraph as jlockgraph
from jubatus_tpu.cli import proxy as jproxy_cli
from jubatus_tpu.cli import server as jserver_cli
from jubatus_tpu.utils import metrics as jmetrics
from jubatus_tpu.utils import rwlock as jrwlock
from jubatus_tpu_torch.analysis import lockgraph as tlockgraph
from jubatus_tpu_torch.cli import proxy as tproxy_cli
from jubatus_tpu_torch.cli import server as tserver_cli
from jubatus_tpu_torch.rpc.client import Client
from jubatus_tpu_torch.utils import metrics as tmetrics
from jubatus_tpu_torch.utils import rwlock as trwlock
from tests.test_torch_classifier import ATOL, RTOL
from tests.test_torch_dispatch_modes import (CFG, jax_server, send_sequential,
                                             stop_jax, train_frames)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def defaults(parser):
    return {a.option_strings[0]: a.default for a in parser._actions
            if a.option_strings and not isinstance(a, argparse._HelpAction)}


@pytest.mark.parametrize("which", ["server", "proxy"])
def test_shared_flags_have_the_jax_defaults(which):
    if which == "server":
        t, j = tserver_cli._parser(), jserver_cli.make_argparser()
    else:
        t, j = tproxy_cli.make_argparser(), jproxy_cli.make_argparser()
    td, jd = defaults(t), defaults(j)
    shared = sorted(set(td) & set(jd))
    assert len(shared) >= (50 if which == "server" else 20)
    assert {f: td[f] for f in shared} == {f: jd[f] for f in shared}
    # this slice's flags are all shared
    ported = {"--thread", "--timeout", "--loglevel", "--log_format",
              "--trace_ring", "--slow_op_ms", "--metrics_port",
              "--query_cache_entries", "--query_cache_bytes",
              "--rpc_retry_max", "--rpc_retry_backoff_ms",
              "--breaker_threshold", "--breaker_cooldown"}
    if which == "server":
        ported |= {"--model_file", "--logfile", "--batch_max",
                   "--batch_window_us", "--ingest_depth", "--arena_pool",
                   "--dispatch", "--debug_locks"}
    assert ported <= set(shared)


def later_cases():
    out = []
    for mod in (tserver_cli, tproxy_cli):
        for flag, kw, item in mod.LATER_FLAGS:
            value = [] if kw.get("action") == "store_true" else \
                ["7" if kw.get("type") in (int, float) else "x"]
            out.append(pytest.param(mod, flag, value, item,
                                    id=f"{mod.__name__.split('.')[-1]}"
                                       f"{flag}"))
    return out


@pytest.mark.parametrize("mod,flag,value,item", later_cases())
def test_later_item_flags_are_refused_with_their_item(mod, flag, value,
                                                      item, capsys,
                                                      tmp_path):
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps(CFG))
    if mod is tserver_cli:
        argv = ["--type", "classifier", "--configpath", str(cfg),
                "--device", "cpu", flag, *value]
        run = tserver_cli.serve
    else:
        argv = ["--type", "classifier", "--coordinator", "127.0.0.1:1",
                flag, *value]
        run = tproxy_cli.build
    with pytest.raises(SystemExit):
        run(argv)
    err = capsys.readouterr().err
    assert f"{flag} is not in the port yet: ROADMAP Queue 1 item {item}" \
        in err


def test_collective_mixer_names_its_item(capsys, tmp_path):
    """collective_mixer is served since the data-parallel tier (Queue 1
    item 4): a standalone --dp_replicas server gets its CollectiveMixer.
    --shard_devices is served since the sharded tier (item 6): a
    nearest_neighbor server shards its table, and a classifier is refused
    with the JAX server's message."""
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps(CFG))
    srv, rpc = tserver_cli.serve(
        ["--type", "classifier", "--configpath", str(cfg), "--device", "cpu",
         "--rpc-port", "0", "--listen_addr", "127.0.0.1", "--mixer",
         "collective_mixer", "--dp_replicas", "2"])
    try:
        st = next(iter(srv.get_status().values()))
        assert st["mixer"] == "collective_mixer"
        assert (st["mix_collective"], st["dp_replicas"]) == ("1", "2")
    finally:
        rpc.stop()
        srv.stop()
    with pytest.raises(ValueError, match="--shard_devices supports "
                       "nearest_neighbor/recommender/anomaly \\(got "
                       "'classifier'\\)"):
        tserver_cli.serve(["--type", "classifier", "--configpath", str(cfg),
                           "--device", "cpu", "--shard_devices", "2"])
    nn = tmp_path / "nn.json"
    nn.write_text(json.dumps({"method": "lsh", "parameter": {"hash_num": 64},
                              "converter": CFG["converter"]}))
    srv, rpc = tserver_cli.serve(
        ["--type", "nearest_neighbor", "--configpath", str(nn), "--device",
         "cpu", "--rpc-port", "0", "--listen_addr", "127.0.0.1",
         "--shard_devices", "2"])
    try:
        assert next(iter(srv.get_status().values()))["shards"] == "2"
    finally:
        rpc.stop()
        srv.stop()


@pytest.mark.parametrize("flag,value,key", [
    ("--dp_replicas", "3", "dp_replicas"), ("--mix_topk", "7", "mix_topk")])
def test_data_parallel_flags_are_served(tmp_path, flag, value, key):
    """The JAX server's --dp_replicas and --mix_topk (Queue 1 item 4),
    served at their JAX defaults and beyond, reported in get_status."""
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps(CFG))
    srv, rpc = tserver_cli.serve(
        ["--type", "classifier", "--configpath", str(cfg), "--device", "cpu",
         "--rpc-port", "0", "--listen_addr", "127.0.0.1", flag, value])
    try:
        st = next(iter(srv.get_status().values()))
        assert st[key] == value
        if flag == "--mix_topk":
            assert srv.driver.mix_topk == 7 and "dp_replicas" not in st
        else:
            assert srv.driver.ndp == 3 and st["mix_topk"] == "0"
    finally:
        rpc.stop()
        srv.stop()


def test_dispatch_auto_follows_the_cores_we_may_use(monkeypatch):
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {3})
    assert tserver_cli.resolve_dispatch("auto") == "inline"
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0, 1})
    assert tserver_cli.resolve_dispatch("auto") == "threaded"
    assert tserver_cli.resolve_dispatch("inline") == "inline"


# -- logging -------------------------------------------------------------------

def test_json_logfile_fields_and_sighup_reopen(tmp_path):
    from jubatus_tpu.utils.logger import JsonFormatter
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps(CFG))
    log = tmp_path / "server.log"
    proc = subprocess.Popen(
        [sys.executable, "-m", "jubatus_tpu_torch.cli.server", "--type",
         "classifier", "--configpath", str(cfg), "--rpc-port", "0",
         "--listen_addr", "127.0.0.1", "--device", "cpu", "--logfile",
         str(log), "--log_format", "json", "--trace_ring", "8",
         "--slow_op_ms", "0.001", "--metrics_port", "-1"],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": REPO},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("jubatus ready rpc_port="), line
        port = int(line.split()[2].split("=")[1])
        assert int(line.split()[3].split("=")[1]) > 0   # the bound port
        send_sequential(port, train_frames(1, n_frames=2), name="")
        rotated = tmp_path / "server.log.1"
        os.rename(log, rotated)
        proc.send_signal(signal.SIGHUP)
        deadline = time.monotonic() + 30
        while not (log.exists() and "log file reopened" in log.read_text()):
            assert time.monotonic() < deadline, "no reopen"
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    import logging
    want = set(json.loads(JsonFormatter().format(logging.LogRecord(
        "x", logging.INFO, "f", 1, "m", (), None))))
    records = [json.loads(x) for x in rotated.read_text().splitlines()]
    assert records and all(set(r) >= want for r in records)
    assert any("listening on 127.0.0.1" in r["msg"] for r in records)
    slow = [json.loads(r["msg"].split(" ", 1)[1]) for r in records
            if r["logger"] == "jubatus_tpu_torch.slowop"]
    # every root span: the requests' and the pipeline threads' steps
    assert all(s["trace_id"] for s in slow)
    assert {"rpc.train", "ingest.convert", "train.step"} <= \
        {s["name"] for s in slow}
    after = [json.loads(x) for x in log.read_text().splitlines()]
    assert all(set(r) >= want for r in after)


# -- --model_file ---------------------------------------------------------------

def test_model_file_loads_a_file_the_jax_server_saved(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jsrv, jrpc, jport = jax_server(tmp_path / "j", {}, False)
    try:
        batches = train_frames(31, n_frames=3)
        send_sequential(jport, batches)
        jcli = Client("127.0.0.1", jport, name="modes")
        (path,) = jcli.call("save", "from_jax").values()
        query = [row[1] for row in batches[1][:4]]
        jlabels, jscores = jcli.call("get_labels"), jcli.call("classify",
                                                               query)
        jcli.close()
    finally:
        stop_jax(jsrv, jrpc)
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps(CFG))
    srv, rpc = tserver_cli.serve([
        "--type", "classifier", "--configpath", str(cfg), "--rpc-port", "0",
        "--listen_addr", "127.0.0.1", "--name", "modes", "--device", "cpu",
        "--datadir", str(tmp_path / "t"), "--model_file", path])
    try:
        cli = Client("127.0.0.1", srv.args.rpc_port, name="modes")
        assert cli.call("get_labels") == jlabels
        got = cli.call("classify", query)
        assert [[e[0] for e in r] for r in got] == \
            [[e[0] for e in r] for r in jscores]
        np.testing.assert_allclose([[e[1] for e in r] for r in got],
                                   [[e[1] for e in r] for r in jscores],
                                   rtol=RTOL, atol=ATOL)
        assert srv.update_count == 0 and srv.model_epoch == 1
        cli.close()
    finally:
        rpc.stop()
        srv.stop()


# -- --debug_locks ---------------------------------------------------------------

def test_flush_under_the_model_lock_raises_in_both(tmp_path):
    (tmp_path / "j").mkdir()
    jsrv, jrpc, _ = jax_server(tmp_path / "j", {"debug_locks": True}, False)
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps(CFG))
    for flags in ([], ["--ingest_depth", "0"]):
        srv, rpc = tserver_cli.serve([
            "--type", "classifier", "--configpath", str(cfg), "--rpc-port",
            "0", "--listen_addr", "127.0.0.1", "--device", "cpu",
            "--debug_locks", *flags])
        try:
            (st,) = srv.get_status().values()
            assert st["debug_locks"] == "1"
            for s, err in ((jsrv, jrwlock.LockDisciplineError),
                           (srv, trwlock.LockDisciplineError)):
                for side in (s.model_lock.write, s.model_lock.read):
                    with side():
                        with pytest.raises(err, match="flush"):
                            s.dispatcher.flush()
        finally:
            rpc.stop()
            srv.stop()
    stop_jax(jsrv, jrpc)


def misuse(mod):
    """The checked lock's refusals, by name."""
    lock = mod.create_rwlock()
    out = [type(lock).__name__]
    for first, second in (("write", "write"), ("read", "write"),
                          ("read", "read"), ("write", "read")):
        with getattr(lock, first)():
            try:
                with getattr(lock, second)():
                    out.append(None)
            except mod.LockDisciplineError as e:
                out.append(str(e))
    try:
        lock.release_write()
    except mod.LockDisciplineError as e:
        out.append(str(e))
    return out


def test_checked_locks_refuse_the_same_misuse(monkeypatch):
    monkeypatch.setenv("JUBATUS_LOCK_CHECK", "1")
    got = misuse(trwlock)
    assert got == misuse(jrwlock)
    assert got[0] == "CheckedRWLock" and None not in got


def monitor_run(mod, metrics_mod):
    """A cycle, a tier inversion, a blocking call under the write lock and
    a nested read hold on a private monitor."""
    reg = metrics_mod.Registry()
    mon = mod.LockOrderMonitor(registry=reg)
    mon.enable()
    a = mod.MonitoredLock("journal", monitor=mon)
    b = mod.MonitoredLock("snapshot", monitor=mon)
    with a:
        with b:
            pass
    with b:
        with a:                   # closes a -> b -> a; and tier 20 < 30
            pass
    mon.note_acquire("model_lock", mode="r")
    mon.note_acquire("model_lock", mode="r")   # nested: no self-edge
    mon.note_release("model_lock")
    mon.note_release("model_lock")
    mon.note_acquire("model_lock", mode="w")
    mon.note_blocking("fsync_file")
    mon.note_release("model_lock")
    mon.note_blocking("fsync_file")            # not under the lock
    return ([{k: v for k, v in r.items() if k != "witnesses"}
             for r in mon.violations()], reg.counter(
                 "lock_order_violation_total"),
            {k: sorted(v) for k, v in mon.edges().items()})


def test_lock_order_monitors_report_alike():
    t = monitor_run(tlockgraph, tmetrics)
    assert t == monitor_run(jlockgraph, jmetrics)
    assert sorted(v["kind"] for v in t[0]) == \
        ["blocking_in_write_lock", "cycle", "tier_inversion"]
    assert t[1] == 3


def test_torch_profile_writes_a_trace_on_sigterm(tmp_path):
    """--torch_profile on the CPU: the Chrome trace is written on SIGTERM
    (on the card it also names the train_scan kernel:
    tests/test_torch_cuda.py)."""
    from tests.test_torch_cuda import profiled_server_trace
    events = profiled_server_trace(tmp_path, "cpu", n_requests=2)
    assert any(e.get("name", "").startswith("aten::") for e in events)
