"""The port's read lane (jubatus_tpu_torch/framework/dispatch.py
ReadDispatcher, --read_batch_window_us) against per-request reads and
against the JAX package's classify_many / estimate_many, on the CPU.

- Reads of one method queued together run as ONE sweep under one
  read-lock hold; each caller gets what the same read sent alone gets,
  bitwise (a row's scores are reduced over its own K entries whatever
  the sweep's B), and what the JAX driver's *_many gives, within rtol
  1e-5 / atol 1e-6.
- One malformed request fails only its own caller; the others in its
  sweep are answered.
- Window 0 builds no lane.
- Over the wire, concurrent clients get the answers a lane-less server
  gives, and get_status carries the lane's histograms.

Every wait has its own timeout."""

import json
import threading
import time

import numpy as np
import pytest

from jubatus_tpu.fv import Datum as JDatum
from jubatus_tpu.models import create_driver as jcreate
from jubatus_tpu_torch.cli.server import serve
from jubatus_tpu_torch.framework import service as tservice
from jubatus_tpu_torch.framework.dispatch import ReadDispatcher
from jubatus_tpu_torch.framework.server_base import JubatusServer, ServerArgs
from jubatus_tpu_torch.fv import Datum as TDatum
from jubatus_tpu_torch.utils.metrics import Registry
from tests.test_torch_classifier import ATOL, RTOL, config, stream
from tests.test_torch_durability import Wire, train_frames
from tests.test_wire_golden import datum_wire

WAIT_S = 30
REG_CONFIG = {"method": "PA",
              "parameter": {"sensitivity": 0.1, "regularization_weight": 1.0},
              "converter": config()["converter"]}
CONFIGS = {"classifier": config("AROW"), "regression": REG_CONFIG}
METHOD = {"classifier": "classify", "regression": "estimate"}


def servers(service, seed=0, n=64):
    """A port server (cpu) and a JAX driver trained on the same stream."""
    rec = stream(np.random.default_rng(seed), n)
    tsrv = JubatusServer(ServerArgs(type=service, name="t", device="cpu"),
                         config=json.dumps(CONFIGS[service]))
    jdrv = jcreate(service, CONFIGS[service])
    if service == "classifier":
        tsrv.driver.train([(l, TDatum(list(s), list(n_))) for l, s, n_ in rec])
        jdrv.train([(l, JDatum(list(s), list(n_))) for l, s, n_ in rec])
    else:
        tgt = {f"c{i}": float(i) - 2.0 for i in range(5)}
        tsrv.driver.train([(tgt[l], TDatum(list(s), list(n_)))
                           for l, s, n_ in rec])
        jdrv.train([(tgt[l], JDatum(list(s), list(n_))) for l, s, n_ in rec])
    return tsrv, jdrv


def reads(seed, n):
    """n read calls' wire arguments: 1 to 3 datums each."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.append(([datum_wire(strings=[(f"w{t % 4}", f"tok{t}")
                                         for t in rng.integers(0, 200, 5)],
                                nums=[("x", float(rng.random()))])
                     for _ in range(int(rng.integers(1, 4)))],))
    return out


def one_sweep(srv, lane, m, calls):
    """Queue `calls` on the lane while its thread waits for the read lock
    with a first read in hand, so they gather into one sweep after it;
    their Futures."""
    with srv.model_lock.write():
        blocker = lane.submit(m, calls[0])
        q = lane._lanes[m.name]._q
        deadline = time.monotonic() + WAIT_S
        while q.qsize():
            assert time.monotonic() < deadline
            time.sleep(0.001)
        time.sleep(0.05)             # the thread reaches the read lock
        futs = [lane.submit(m, c) for c in calls]
    blocker.result(timeout=WAIT_S)
    return futs


@pytest.mark.parametrize("service", ["classifier", "regression"])
def test_a_sweep_equals_per_request_reads_and_the_jax_many(service):
    srv, jdrv = servers(service)
    reg = Registry()
    lane = ReadDispatcher(srv, 200.0, registry=reg)
    m = tservice.SERVICES[service].methods[METHOD[service]]
    calls = reads(1, 24)
    try:
        got = [f.result(timeout=WAIT_S)
               for f in one_sweep(srv, lane, m, calls)]
    finally:
        lane.stop()
    alone = [m.fn(srv, *c) for c in calls]
    assert got == alone                     # bitwise, wire-encoded
    groups = [[JDatum.from_msgpack(d) for d in data] for (data,) in calls]
    if service == "classifier":
        want = jdrv.classify_many(groups)
        for g, w in zip(got, want):
            for gr, wr in zip(g, w):
                assert [e[0] for e in gr] == [e[0] for e in wr]
                np.testing.assert_allclose([e[1] for e in gr],
                                           [e[1] for e in wr],
                                           rtol=RTOL, atol=ATOL)
    else:
        want = jdrv.estimate_many(groups)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    st = reg.snapshot()
    # the blocker's sweep of 1, then the 24 in one
    assert st["read_batch_size_count"] == "2"
    assert st["read_batch_size_max"] == "24.000"
    assert st["read_coalesced_total"] == "24"
    assert st[f"batch.read.{METHOD[service]}.size_max"] == "24.000"
    assert int(st["read_lock_wait_count"]) == 2


def test_one_bad_request_fails_only_its_caller():
    srv, _ = servers("classifier")
    lane = ReadDispatcher(srv, 200.0, registry=Registry())
    m = tservice.SERVICES["classifier"].methods["classify"]
    good = reads(2, 4)
    calls = good[:2] + [(["not a datum"],)] + good[2:]
    try:
        futs = one_sweep(srv, lane, m, calls)
        for i, f in enumerate(futs):
            if i == 2:
                with pytest.raises(Exception):
                    f.result(timeout=WAIT_S)
            else:
                assert f.result(timeout=WAIT_S) == m.fn(srv, *calls[i])
        # a sole caller's failure takes the plain error path
        with pytest.raises(Exception):
            lane.submit(m, (["not a datum"],)).result(timeout=WAIT_S)
    finally:
        lane.stop()


def test_window_zero_builds_no_lane():
    srv = JubatusServer(ServerArgs(type="classifier", name="t", device="cpu"),
                        config=json.dumps(CONFIGS["classifier"]))
    tservice.setup_slot_pipelines(srv)
    assert srv.read_dispatch is None
    assert srv.get_status()[srv.server_id]["read_batch_window_us"] == "0"
    srv.stop()
    srv = JubatusServer(ServerArgs(type="classifier", name="t", device="cpu",
                                   read_batch_window_us=150.0),
                        config=json.dumps(CONFIGS["classifier"]))
    tservice.setup_slot_pipelines(srv)
    assert srv.read_dispatch is not None
    assert srv.get_status()[srv.server_id]["read_batch_window_us"] == "150.0"
    srv.stop()


@pytest.mark.parametrize("service", ["classifier", "regression"])
def test_concurrent_wire_reads_answer_as_without_the_lane(service, tmp_path):
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps(CONFIGS[service]))
    started = []
    for window in ("0", "300"):
        started.append(serve([
            "--type", service, "--configpath", str(cfg), "--rpc-port", "0",
            "--listen_addr", "127.0.0.1", "--device", "cpu",
            "--read_batch_window_us", window]))
    try:
        frames = train_frames(service, 9, n_frames=4, per=16)
        for srv, _ in started:
            w = Wire(srv.args.rpc_port)
            for fr in frames:
                assert w.send(fr)[2] is None
            w.close()
        calls = reads(3, 8 * 6)
        results = [{}, {}]
        errors = []

        def client(k, idx):
            try:
                w = Wire(started[k][0].args.rpc_port)
                for i in idx:
                    results[k][i] = w.call(METHOD[service], *calls[i])
                w.close()
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

        for k in (0, 1):
            threads = [threading.Thread(target=client,
                                        args=(k, range(t, len(calls), 8)))
                       for t in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT_S)
            assert not any(t.is_alive() for t in threads)
        assert not errors
        assert results[0] == results[1]
        lane_srv = started[1][0]
        st = lane_srv.get_status()[lane_srv.server_id]
        assert st["read_batch_window_us"] == "300.0"
        assert int(st["read_batch_size_count"]) >= 1
        assert float(st["read_batch_size_max"]) >= 1.0
        assert float(st["read_batch_size_mean"]) >= 1.0
    finally:
        for srv, rpc in started:
            rpc.stop()
            srv.stop()
