"""The port's classifier server (jubatus_tpu_torch/cli/server.py on
--device cpu) against the JAX server: both get the same old-spec client
session (the reference's msgpack-c 0.5.9 wire, tests/test_wire_golden.py)
and must answer alike.  Scores agree within rtol 1e-5 / atol 1e-6; every
other response is compared as it is, apart from the fields that name the
process (server ids, paths, pids, uptimes)."""

import json
import os
import signal
import socket
import subprocess
import sys

import msgpack
import numpy as np
import pytest

from tests.test_torch_classifier import ATOL, RTOL
from tests.test_wire_golden import (CLASSIFIER_CFG, GoldenConn, _spawn,
                                    assert_old_spec, datum_wire, old_pack)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spawn_port(cfg, tmp_path):
    from jubatus_tpu_torch.cli.server import serve
    path = tmp_path / "port_cfg.json"
    path.write_text(json.dumps(cfg))
    srv, rpc = serve(["--type", "classifier", "--configpath", str(path),
                      "--rpc-port", "0", "--listen_addr", "127.0.0.1",
                      "--name", "wiretest", "--datadir", str(tmp_path),
                      "--device", "cpu"])
    return srv, rpc, srv.args.rpc_port


@pytest.fixture()
def pair(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jsrv, jrpc, jport = _spawn("classifier", CLASSIFIER_CFG, tmp_path / "jax")
    tsrv, trpc, tport = _spawn_port(CLASSIFIER_CFG, tmp_path / "port")
    conns = (GoldenConn(jport), GoldenConn(tport))
    yield conns, (jsrv, tsrv), (jport, tport)
    for c in conns:
        c.close()
    if getattr(jsrv, "dispatcher", None) is not None:
        jsrv.dispatcher.stop()
    jrpc.stop()
    trpc.stop()


def both(conns, method, *args):
    return [c.call(method, *args) for c in conns]


def assert_same_scores(a, b):
    assert [[e[0] for e in row] for row in a] == \
        [[e[0] for e in row] for row in b]
    np.testing.assert_allclose([[e[1] for e in row] for row in a],
                               [[e[1] for e in row] for row in b],
                               rtol=RTOL, atol=ATOL)


def session_batches(seed=3, n_batches=3, n=24):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        batch = []
        for i in range(n):
            toks = [(f"w{t % 3}", f"tok{t}") for t in rng.integers(0, 90, 4)]
            batch.append([f"l{i % 4}", datum_wire(
                strings=toks, nums=[("x", float(rng.random()))])])
        out.append(batch)
    return out


def test_same_session_same_answers(pair):
    conns = pair[0]
    assert both(conns, "set_label", "l9") == [True, True]
    for batch in session_batches():
        j, t = both(conns, "train", batch)
        assert j == t == len(batch)
    query = [b[1] for b in session_batches(seed=8, n_batches=1, n=6)[0]]
    j, t = both(conns, "classify", query)
    assert_same_scores(j, t)
    j, t = both(conns, "get_labels")
    assert j == t and sum(t.values()) == 72 and t["l9"] == 0
    assert both(conns, "delete_label", "l1") == [True, True]
    assert both(conns, "delete_label", "l1") == [False, False]
    j, t = both(conns, "get_labels")
    assert j == t
    j, t = both(conns, "get_config")
    assert json.loads(j) == json.loads(t) == CLASSIFIER_CFG
    j, t = both(conns, "save", "golden")
    assert len(j) == len(t) == 1
    assert os.path.basename(next(iter(t.values()))).endswith(
        "_jubatus_classifier_wiretest_golden.jubatus")
    j, t = both(conns, "train", session_batches(seed=11, n_batches=1)[0])
    assert both(conns, "load", "golden") == [True, True]
    j, t = both(conns, "classify", query)
    assert_same_scores(j, t)
    j, t = both(conns, "get_status")
    (jst,), (tst,) = j.values(), t.values()
    for key in ("type", "name", "num_classes", "num_features", "method",
                "is_standalone", "version"):
        assert tst[key] == jst[key], key
    assert tst["device"] == "cpu"
    assert int(tst["update_count"]) == int(jst["update_count"]) > 0
    assert both(conns, "clear") == [True, True]
    assert both(conns, "get_labels") == [{}, {}]


def test_binary_and_non_utf8_values(pair):
    conns = pair[0]
    d = datum_wire(strings=[("k", b"\xff\xfe bytes"), ("t", "ok")],
                   binaries=[("payload", bytes(range(256)))])
    assert both(conns, "train", [["b", d], ["a", datum_wire(
        strings=[("t", "no")])]]) == [2, 2]
    j, t = both(conns, "classify", [d])
    assert_same_scores(j, t)


def test_models_saved_by_one_server_load_in_the_other(pair):
    """A file the JAX server saves, copied to the name the port server
    looks for, loads there and classifies the same."""
    conns, (_, tsrv), _ = pair
    for batch in session_batches(seed=5):
        both(conns, "train", batch)
    (jpath,) = conns[0].call("save", "x").values()
    os.replace(jpath, tsrv._model_path("x"))
    conns[1].call("clear")
    assert conns[1].call("load", "x") is True
    query = [b[1] for b in session_batches(seed=6, n_batches=1, n=4)[0]]
    j, t = both(conns, "classify", query)
    assert_same_scores(j, t)


def _raw_call(port, frame):
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(frame)
        unp = msgpack.Unpacker(raw=False, strict_map_key=False)
        buf = b""
        while True:
            data = s.recv(1 << 16)
            assert data, "connection closed"
            buf += data
            unp.feed(data)
            for msg in unp:
                assert_old_spec(buf)
                return msg


@pytest.mark.parametrize("frame", [
    old_pack([0, 7, "no_such_method", ["wiretest"]]),
    old_pack([0, 7, "get_labels", ["wiretest", "extra", "args"]]),
    old_pack([0, 7, "delete_label", ["wiretest", 5]]),
], ids=["no_method", "arity", "app_error"])
def test_errors_answer_alike(pair, frame):
    jport, tport = pair[2]
    jmsg = _raw_call(jport, frame)
    tmsg = _raw_call(tport, frame)
    assert tmsg[:2] == jmsg[:2] == [1, 7]
    assert (tmsg[2] is None) == (jmsg[2] is None)
    if isinstance(jmsg[2], int):
        assert tmsg[2] == jmsg[2]


def _cli(tmp_path, device, **env):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(CLASSIFIER_CFG))
    env = {**os.environ, "PYTHONPATH": REPO, **env}
    return subprocess.Popen(
        [sys.executable, "-m", "jubatus_tpu_torch.cli.server", "--type",
         "classifier", "--configpath", str(cfg), "--rpc-port", "0",
         "--listen_addr", "127.0.0.1", "--datadir", str(tmp_path),
         "--device", device],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def test_cli_serves_on_cpu_and_stops_on_sigterm(tmp_path):
    proc = _cli(tmp_path, "cpu")
    try:
        line = proc.stdout.readline()
        assert line.startswith("jubatus ready rpc_port="), line
        port = int(line.split()[2].split("=")[1])
        conn = GoldenConn(port)
        assert conn.call("train", [["a", datum_wire(strings=[("t", "x")])]],
                         name="") == 1
        assert conn.call("get_labels", name="") == {"a": 1}
        conn.close()
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=30)
        assert proc.returncode == 0
        assert f"listening on 127.0.0.1:{port}" in err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_cli_refuses_cuda_without_a_card(tmp_path):
    """No silent CPU fallback: asking for cuda where there is none (no
    card here, and none visible to the process on a machine with one)
    fails at startup."""
    proc = _cli(tmp_path, "cuda", CUDA_VISIBLE_DEVICES="")
    out, err = proc.communicate(timeout=60)
    assert proc.returncode != 0
    assert "jubatus ready" not in out
    assert "torch.cuda.is_available() is False" in err
