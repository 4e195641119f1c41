"""The port's regression server (jubatus_tpu_torch/cli/server.py --type
regression on --device cpu) against the JAX server: both get the same
old-spec client session and must answer alike.  Train frames take the
native ingest pipeline on both; estimates agree within rtol 1e-5 /
atol 1e-6 (float32 sums in another order); every other response is
compared as it is, apart from the fields that name the process."""

import json
import os
import signal

import msgpack
import numpy as np
import pytest

from tests.test_torch_regression import ATOL, RTOL, config
from tests.test_torch_server import _cli, _pair
from tests.test_wire_golden import GoldenConn, datum_wire, old_pack

CFG = config("PA1", c=0.5)


@pytest.fixture()
def pair(tmp_path):
    yield from _pair(tmp_path, CFG, "regression")


def both(conns, method, *args):
    return [c.call(method, *args) for c in conns]


def scored(seed, n):
    """n wire [score, datum] pairs: the score a fixed linear function of x
    and of one token's parity, plus noise."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, 90, 4)
        x = float(rng.random())
        y = 3.0 * x + (2.0 if toks[0] % 2 else -2.0) + float(rng.normal(0, .1))
        out.append([y, datum_wire(
            strings=[(f"w{t % 3}", f"tok{t}") for t in toks],
            nums=[("x", x)])])
    return out


def assert_same_estimates(a, b):
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_same_session_same_answers(pair):
    conns, (_, tsrv), _ = pair
    batches = [scored(s, n) for s, n in ((1, 24), (2, 7), (3, 40))]
    for batch in batches:
        j, t = both(conns, "train", batch)
        assert j == t == len(batch)
    # pipelined: frames back to back without waiting for acks, then an
    # estimate on the same connection sees every train before it
    more = [scored(10 + i, 16) for i in range(5)]
    query = [d for _, d in scored(20, 6)]
    frames = [old_pack([0, 100 + i, "train", ["wiretest", b]])
              for i, b in enumerate(more)]
    frames.append(old_pack([0, 200, "estimate", ["wiretest", query]]))
    answers = []
    for c in conns:
        c.sock.sendall(b"".join(frames))
        unp = msgpack.Unpacker(raw=False, strict_map_key=False)
        got = []
        while len(got) < len(frames):
            data = c.sock.recv(1 << 16)
            assert data, "connection closed"
            unp.feed(data)
            got.extend(unp)
        answers.append(got)
    for got in answers:
        assert [m[1] for m in got] == [100 + i for i in range(5)] + [200]
        assert [m[3] for m in got[:5]] == [16] * 5
    assert_same_estimates(answers[1][-1][3], answers[0][-1][3])
    est_j, est_t = both(conns, "estimate", query)
    assert_same_estimates(est_t, est_j)
    assert np.abs(est_t).max() > 0.5                # it learned something

    j, t = both(conns, "get_config")
    assert json.loads(j) == json.loads(t) == CFG
    j, t = both(conns, "save", "golden")
    assert len(j) == len(t) == 1
    assert os.path.basename(next(iter(t.values()))).endswith(
        "_jubatus_regression_wiretest_golden.jubatus")
    both(conns, "train", scored(30, 12))
    assert both(conns, "load", "golden") == [True, True]
    assert both(conns, "estimate", query) == [est_j, est_t]  # the saved w

    j, t = both(conns, "get_status")
    (jst,), (tst,) = j.values(), t.values()
    sent = sum(map(len, batches)) + 5 * 16
    for key in ("type", "name", "num_trained", "method", "is_standalone",
                "version"):
        assert tst[key] == jst[key], key
    assert int(tst["num_trained"]) == sent
    assert tst["device"] == "cpu"
    assert int(tst["update_count"]) == int(jst["update_count"]) > 0
    for st in (jst, tst):
        assert (st["fast_path"], st["ingest_pipeline"],
                st["dispatch_mode"]) == ("True", "1", "threaded")
    assert int(tst["ingest_frames"]) == 3 + 5 + 1   # every train frame
    # the wrapper counts kernel launches; on the CPU it runs the plain
    # version, so none
    assert tst["kernel_launches.regression_train_scan"] == "0"
    assert tsrv.dispatcher is not None

    assert both(conns, "clear") == [True, True]
    j, t = both(conns, "estimate", query)
    assert t == j == [0.0] * len(query)
    j, t = both(conns, "get_status")
    assert next(iter(t.values()))["num_trained"] == "0"


def test_models_saved_by_one_server_load_in_the_other(pair):
    conns, (_, tsrv), _ = pair
    both(conns, "train", scored(5, 30))
    query = [d for _, d in scored(6, 4)]
    (jpath,) = conns[0].call("save", "x").values()
    os.replace(jpath, tsrv._model_path("x"))
    conns[1].call("clear")
    assert conns[1].call("load", "x") is True
    j, t = both(conns, "estimate", query)
    assert t == j                                   # the same w, bitwise


def test_cli_serves_regression_on_cpu(tmp_path):
    proc = _cli(tmp_path, "cpu", cfg=CFG, service="regression")
    try:
        line = proc.stdout.readline()
        assert line.startswith("jubatus ready rpc_port="), line
        port = int(line.split()[2].split("=")[1])
        conn = GoldenConn(port)
        assert conn.call("train", scored(7, 3), name="") == 3
        est = conn.call("estimate", [d for _, d in scored(8, 2)], name="")
        assert len(est) == 2 and all(isinstance(v, float) for v in est)
        conn.close()
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=30)
        assert proc.returncode == 0
        assert f"regression server listening on 127.0.0.1:{port}" in err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_cli_refuses_regression_without_a_card(tmp_path):
    """The default device is cuda: without --device, and with no card
    visible, the server does not start."""
    proc = _cli(tmp_path, None, cfg=CFG, service="regression",
                CUDA_VISIBLE_DEVICES="")
    out, err = proc.communicate(timeout=60)
    assert proc.returncode != 0
    assert "jubatus ready" not in out
    assert "torch.cuda.is_available() is False" in err
