"""The port's train routes against the JAX server's: the pipelined
IngestPipeline (the default), the batched TrainDispatcher
(--ingest_depth 0), the per-request route (--batch_max 1
--batch_window_us 0 --ingest_depth 0) and inline dispatch (--dispatch
inline).  For each, a CPU port server and a JAX server get the same
seeded train frames, sent back to back on one connection (so the
coalescing routes fuse windows) and then one at a time, and end with the
same model tables: counts, active rows and labels bitwise, the float
tables within tests/test_torch_classifier.py's tolerance.  The four port
servers end bitwise equal to each other (the sequential scan of r1||r2
is r1 then r2).  Then key parity: after the same calls the port's
get_status and get_metrics hold every key of the JAX server's, but for
the keys of later ROADMAP items listed in LATER_KEYS."""

import json
import re

import msgpack
import numpy as np
import pytest

from tests.test_torch_classifier import ATOL, RTOL
from tests.test_wire_golden import GoldenConn, datum_wire, old_pack

CFG = {"method": "AROW", "parameter": {"regularization_weight": 1.0},
       "converter": {
           "string_rules": [{"key": "*", "type": "str",
                             "sample_weight": "bin", "global_weight": "bin"}],
           "num_rules": [{"key": "*", "type": "num"}],
           "hash_max_size": 1 << 12}}

# the four routes: (port CLI flags, JAX ServerArgs knobs, JAX inline)
MODES = {
    "pipelined": ([], {}, False),
    "batched": (["--ingest_depth", "0"], {"ingest_depth": 0}, False),
    "per_request": (["--batch_max", "1", "--batch_window_us", "0",
                     "--ingest_depth", "0"],
                    {"batch_max": 1, "batch_window_us": 0.0,
                     "ingest_depth": 0}, False),
    "inline": (["--dispatch", "inline"], {}, True),
}

# get_status / get_metrics keys of the JAX server that belong to ROADMAP
# Queue 1 items still to port (regular expressions, each with its item)
LATER_KEYS = {
    r"^heat_.*": "7 (obs/heat.py)",
    r"^slo_.*": "7 (obs/health.py SLO burn)",
    r"^health_(state|reasons)$": "7 (obs/health.py)",
    r"^(VIRT|RSS|SHR|loadavg|.*_mem.*|cpu_.*|.*total_memory|"
    r"clock_time|start_time|logdir|progname|.*pid_.*)$":
        "7 (utils/system.py machine status)",
    r"^autopilot.*": "7 (autopilot)",
    # the JAX package's XLA compile cache (batching/bucketing.py
    # BucketCache: a miss is an XLA compile); the port builds each CUDA
    # kernel once (kernels/build.py) and has no shape compile to count
    r"^(batch_bucket_hit_rate|batch\.bucket_(hit|miss)|"
    r"device_compile_cache_(hits|misses))$": "none (XLA compile cache)",
}


def train_frames(seed, n_frames=12, per=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_frames):
        out.append([[f"l{int(rng.integers(0, 5))}", datum_wire(
            strings=[(f"w{t % 3}", f"tok{t}")
                     for t in rng.integers(0, 80, int(rng.integers(3, 9)))],
            nums=[("x", float(rng.random()))])] for _ in range(per)])
    return out


def send_pipelined(port, batches, name="modes"):
    """Every train request sent at once on one connection; the acks."""
    conn = GoldenConn(port)
    frames = [old_pack([0, i + 1, "train", [name, b]])
              for i, b in enumerate(batches)]
    conn.sock.sendall(b"".join(frames))
    unp = msgpack.Unpacker(raw=False, strict_map_key=False)
    got = []
    while len(got) < len(frames):
        data = conn.sock.recv(1 << 16)
        assert data, "connection closed"
        unp.feed(data)
        got.extend(unp)
    conn.close()
    assert [m[2] for m in got] == [None] * len(frames)
    return [m[3] for m in got]


def send_sequential(port, batches, name="modes"):
    conn = GoldenConn(port)
    acks = [conn.call("train", b, name=name) for b in batches]
    conn.close()
    return acks


def port_server(tmp_path, flags, *extra):
    from jubatus_tpu_torch.cli.server import serve
    path = tmp_path / "port.json"
    path.write_text(json.dumps(CFG))
    return serve(["--type", "classifier", "--configpath", str(path),
                  "--rpc-port", "0", "--listen_addr", "127.0.0.1",
                  "--name", "modes", "--datadir", str(tmp_path),
                  "--device", "cpu", *flags, *extra])


def jax_server(tmp_path, knobs, inline):
    from jubatus_tpu.framework.server_base import JubatusServer, ServerArgs
    from jubatus_tpu.framework.service import bind_service
    from jubatus_tpu.rpc.server import RpcServer
    args = ServerArgs(type="classifier", name="modes", rpc_port=0,
                      datadir=str(tmp_path), **knobs)
    srv = JubatusServer(args, config=json.dumps(CFG))
    rpc = RpcServer(threads=2, inline_raw=inline)
    bind_service(srv, rpc)
    port = rpc.start(0, host="127.0.0.1")
    args.rpc_port = port
    return srv, rpc, port


def stop_jax(srv, rpc):
    for d in (getattr(srv, "dispatcher", None), srv.read_dispatch):
        if d is not None:
            d.stop()
    rpc.stop()


def port_tables(drv):
    return {"labels": dict(drv.labels), "counts": drv.counts.numpy().copy(),
            "active": drv.active.numpy().copy(), "w": drv.w.numpy().copy(),
            "cov": drv.cov.numpy().copy()}


def assert_tables_close(jd, t):
    assert t["labels"] == jd.labels
    np.testing.assert_array_equal(t["counts"], np.asarray(jd.counts))
    np.testing.assert_array_equal(t["active"], np.asarray(jd.active))
    np.testing.assert_allclose(t["w"], np.asarray(jd.w), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(t["cov"], np.asarray(jd.cov), rtol=RTOL,
                               atol=ATOL)


def run_mode(tmp_path, mode):
    """Both servers of `mode` fed the same frames -> (port tables, port
    get_status, JAX driver)."""
    flags, knobs, inline = MODES[mode]
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jsrv, jrpc, jport = jax_server(tmp_path / "j", knobs, inline)
    tsrv, trpc = port_server(tmp_path / "t", flags)
    try:
        (st,) = tsrv.get_status().values()
        assert st["dispatch_mode"] == ("inline" if inline else "threaded")
        assert st["ingest_pipeline"] == str(int(mode == "pipelined"))
        pipelined = train_frames(7)
        sequential = train_frames(8, n_frames=6)
        for port in (jport, tsrv.args.rpc_port):
            assert send_pipelined(port, pipelined) == [8] * 12
            assert send_sequential(port, sequential) == [8] * 6
            # a decoded request after the trains: every ack landed
            c = GoldenConn(port)
            assert sum(c.call("get_labels", name="modes").values()) == 144
            c.close()
        with tsrv.model_lock.read():
            tables = port_tables(tsrv.driver)
        (st,) = tsrv.get_status().values()
        return tables, st, jsrv.driver
    finally:
        stop_jax(jsrv, jrpc)
        trpc.stop()
        tsrv.stop()


@pytest.fixture(scope="module")
def outcomes(tmp_path_factory):
    return {mode: run_mode(tmp_path_factory.mktemp(mode), mode)
            for mode in MODES}


@pytest.mark.parametrize("mode", list(MODES))
def test_each_mode_ends_with_the_jax_servers_tables(outcomes, mode):
    tables, st, jdrv = outcomes[mode]
    assert_tables_close(jdrv, tables)
    assert st["update_count"] == "18"
    assert st["model_epoch"] == "18"


def test_the_four_modes_end_bitwise_equal(outcomes):
    ref = outcomes["per_request"][0]
    for mode in MODES:
        tables = outcomes[mode][0]
        assert tables["labels"] == ref["labels"]
        for k in ("counts", "active", "w", "cov"):
            np.testing.assert_array_equal(tables[k], ref[k], err_msg=mode)


def test_each_mode_reports_its_route_series(outcomes):
    """The stage series bench.py's ingest comparison reads."""
    _, st, _ = outcomes["pipelined"]
    for key in ("rpc.train_total_sec", "ingest.convert_total_sec",
                "batch.train.step_total_sec", "batch.train.size_mean",
                "convert_lock_wait_total_sec", "ingest_pipeline"):
        assert key in st, key
    _, st, _ = outcomes["batched"]
    assert float(st["batch.train.size_mean"]) >= 1.0
    assert st["ingest_depth"] == "0"
    _, st, _ = outcomes["per_request"]
    assert (st["batch_max"], st["batch_window_us"]) == ("1", "0.0")
    _, st, _ = outcomes["inline"]
    assert st["read_batch_window_us"] == "0"


def later_key(key):
    return next((item for pat, item in LATER_KEYS.items()
                 if re.match(pat, key)), None)


def test_status_and_metrics_keys_include_the_jax_servers(tmp_path):
    """After the same calls the port's get_status and get_metrics keys
    include the JAX server's, but for LATER_KEYS."""
    from jubatus_tpu.utils.metrics import GLOBAL as JGLOBAL
    from jubatus_tpu_torch.utils.metrics import GLOBAL as TGLOBAL
    JGLOBAL.reset()
    TGLOBAL.reset()
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jsrv, jrpc, jport = jax_server(tmp_path / "j", {}, False)
    tsrv, trpc = port_server(tmp_path / "t", [])
    try:
        batches = train_frames(11, n_frames=4)
        query = [row[1] for row in batches[0][:3]]
        answers = []
        for port in (jport, tsrv.args.rpc_port):
            # one step a request: both reach the periodic device sync
            send_sequential(port, batches)
            c = GoldenConn(port)
            c.call("classify", query, name="modes")
            c.call("get_labels", name="modes")
            c.call("get_status", name="modes")
            answers.append((c.call("get_status", name="modes"),
                            c.call("get_metrics", name="modes")))
            c.close()
        (jst,), (jmet,) = (v.values() for v in answers[0])
        (tst,), (tmet,) = (v.values() for v in answers[1])
        for what, j, t in (("get_status", jst, tst),
                           ("get_metrics", jmet, tmet)):
            missing = sorted(k for k in set(j) - set(t)
                             if later_key(k) is None)
            assert not missing, f"{what} lacks {missing}"
        assert set(tmet) <= set(tst)
    finally:
        stop_jax(jsrv, jrpc)
        trpc.stop()
        tsrv.stop()
