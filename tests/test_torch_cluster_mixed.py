"""A mixed cluster: the JAX package's coordinator, one JAX server and one
port server (--device cpu), each its own process, reconcile by do_mix,
for the classifier (AROW) and the regression (PA) service, on the f32
wire (v2) and the blockwise-int8 wire (v3, --mix_quantize).

Each server trains one labelled pair; both read their config from the
coordinator.  One more mixed classifier cluster runs through the port's
coordinator instead of the JAX one.  After do_mix both servers hold the counts' exact
sum, and a second do_mix, sent to the other server, changes nothing.
On v2 both models are bitwise equal to those of an all-JAX two-server
cluster fed the same pairs; on v3 they are bitwise equal to each other
and within the bound of tests/test_mix_quantized.py of the f32 models:
every element moves at most the round's accumulated quantization error
(the sum of max |x - dq(q(x))| over the round's encodes, taken from the
same round replayed in-process on JAX drivers) + 1e-6.  The v2 round is
driven from the port server (a port master with a JAX peer), the v3
round from the JAX server (the other way round).

The datums carry two features each, so every sum of the update has at
most two terms and the two packages' training is bitwise equal.
Every wait has its own timeout."""

import json
import os
import queue
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from jubatus_tpu.fv import Datum as JDatum
from jubatus_tpu.mix import codec as jcodec
from jubatus_tpu.models import create_driver as jcreate
from jubatus_tpu_torch.cluster.membership import MembershipClient
from jubatus_tpu_torch.mix import codec as tcodec
from jubatus_tpu_torch.rpc.client import Client
from tests.test_torch_server import REPO
from tests.test_wire_golden import datum_wire

CONVERTER = {
    "string_rules": [{"key": "*", "type": "str", "sample_weight": "bin",
                      "global_weight": "bin"}],
    "num_rules": [{"key": "*", "type": "num"}],
    "hash_max_size": 1024,
}
CONFIGS = {
    "classifier": {"method": "AROW",
                   "parameter": {"regularization_weight": 1.0},
                   "converter": CONVERTER},
    "regression": {"method": "PA",
                   "parameter": {"sensitivity": 0.1,
                                 "regularization_weight": 1.0},
                   "converter": CONVERTER},
}
# (target, token, x) per datum; one pair per server
PAIRS = [[("A", "apple", 1.0), ("B", "banana", 2.0)],
         [("A", "cherry", 0.5), ("B", "apple", -1.5)]]
REG_TARGET = {"A": 3.0, "B": -1.0}
START_S = 120
CALL_S = 60


def wire_pair(service, pair):
    if service == "classifier":
        return [[lbl, datum_wire(strings=[("t", tok)], nums=[("x", x)])]
                for lbl, tok, x in pair]
    return [[REG_TARGET[lbl], datum_wire(strings=[("t", tok)],
                                         nums=[("x", x)])]
            for lbl, tok, x in pair]


def jax_pair(service, pair):
    out = []
    for lbl, tok, x in pair:
        d = JDatum().add_string("t", tok).add_number("x", x)
        out.append((lbl if service == "classifier" else REG_TARGET[lbl], d))
    return out


class Proc:
    """A child process whose output is drained by a thread; `wait_for`
    returns the first line starting with a prefix."""

    def __init__(self, argv):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        self.p = subprocess.Popen(argv, cwd=REPO, env=env, text=True,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT)
        self.lines: "queue.Queue" = queue.Queue()
        self.tail = []
        threading.Thread(target=self._drain, daemon=True).start()

    def _drain(self):
        for line in self.p.stdout:
            self.tail = (self.tail + [line])[-60:]
            self.lines.put(line)
        self.lines.put(None)

    def wait_for(self, prefix, timeout=START_S):
        deadline = time.monotonic() + timeout
        while True:
            try:
                line = self.lines.get(timeout=max(
                    0.05, deadline - time.monotonic()))
            except queue.Empty:
                line = ""
            if line is None:
                raise AssertionError("process ended:\n" + "".join(self.tail))
            if line.startswith(prefix):
                return line
            if time.monotonic() > deadline:
                raise TimeoutError(f"no {prefix!r} within {timeout} s:\n"
                                   + "".join(self.tail))

    def kill(self):
        if self.p.poll() is None:
            self.p.kill()
        self.p.wait(timeout=30)


def server_argv(pkg, service, name, coordinator, quantize):
    argv = [sys.executable, "-m", f"{pkg}.cli.server", "--type", service,
            "--name", name, "--rpc-port", "0", "--listen_addr", "127.0.0.1",
            "--eth", "127.0.0.1", "--coordinator", coordinator,
            "--interval_sec", "100000", "--interval_count", "1000000"]
    if pkg == "jubatus_tpu_torch":
        argv += ["--device", "cpu"]
    if quantize:
        argv.append("--mix_quantize")
    return argv


# cluster name -> (service, quantize, (package of server 0, of server 1),
# package of its coordinator)
CLUSTERS = {}
for _svc in ("classifier", "regression"):
    CLUSTERS[f"{_svc}_f32_mixed"] = (_svc, False,
                                     ("jubatus_tpu", "jubatus_tpu_torch"),
                                     "jubatus_tpu")
    CLUSTERS[f"{_svc}_v3_mixed"] = (_svc, True,
                                    ("jubatus_tpu", "jubatus_tpu_torch"),
                                    "jubatus_tpu")
    CLUSTERS[f"{_svc}_f32_jax"] = (_svc, False,
                                   ("jubatus_tpu", "jubatus_tpu"),
                                   "jubatus_tpu")
# the same mixed pair through the port's coordinator
CLUSTERS["classifier_f32_port_coordinator"] = (
    "classifier", False, ("jubatus_tpu", "jubatus_tpu_torch"),
    "jubatus_tpu_torch")


@pytest.fixture(scope="module")
def clusters():
    """Each package's coordinator and every cluster's two servers, all
    started at once; -> {name: [port of server 0, port of server 1]}."""
    procs = []
    try:
        coords = {pkg: Proc([sys.executable, "-m",
                             f"{pkg}.cluster.coordinator", "--rpc-port", "0",
                             "--listen_addr", "127.0.0.1", "--session_ttl",
                             "5"])
                  for pkg in ("jubatus_tpu", "jubatus_tpu_torch")}
        procs.extend(coords.values())
        addrs = {pkg: c.wait_for("jubacoordinator").split()[-1]
                 for pkg, c in coords.items()}
        setters = []
        for name, (svc, _q, _pkgs, cpkg) in CLUSTERS.items():
            m = MembershipClient(addrs[cpkg], svc, name)
            m.set_config(json.dumps(CONFIGS[svc]))
            setters.append(m)
        started = {}
        for name, (svc, quantize, pkgs, cpkg) in CLUSTERS.items():
            started[name] = [Proc(server_argv(pkg, svc, name, addrs[cpkg],
                                              quantize)) for pkg in pkgs]
            procs.extend(started[name])
        ports = {}
        for name, pair in started.items():
            ports[name] = [int(p.wait_for("jubatus ready").split()[2]
                               .split("=")[1]) for p in pair]
        for m, name in zip(setters, CLUSTERS):
            want = {("127.0.0.1", p) for p in ports[name]}
            deadline = time.monotonic() + START_S
            while set(m.get_all_nodes()) != want:
                assert time.monotonic() < deadline, f"{name} never joined"
                time.sleep(0.2)
        for m in setters:
            m.close()
        # a JAX server's round reads its member list from a cache up to
        # a second old, so a round before that cache lists both servers
        # would gather one diff (ROADMAP Queue 3 item 6; the port's
        # master reads the list afresh)
        time.sleep(1.2)
        yield ports
    finally:
        for p in procs:
            p.kill()


def call(port, method, *args):
    with Client("127.0.0.1", port, name="", timeout=CALL_S) as c:
        return c.call_raw(method, *args)


def model_of(port, service):
    """The server's model through the mixer's get_model RPC: the
    driver's pack, tables keyed by label."""
    pack = tcodec.decode(call(port, "get_model", 0))["model"]
    if service == "regression":
        return {"w": np.frombuffer(pack["w"], np.float32)}
    labels = {k if isinstance(k, str) else k.decode(): int(v)
              for k, v in pack["labels"].items()}
    cap, dim = int(pack["capacity"]), int(pack["dim"])
    w = np.frombuffer(pack["w"], np.float32).reshape(cap, dim)
    cov = np.frombuffer(pack["cov"], np.float32).reshape(cap, dim)
    counts = np.frombuffer(pack["counts"], np.int32)
    return {f"{t}:{lbl}": tab[row] for lbl, row in labels.items()
            for t, tab in (("w", w), ("cov", cov))} | {
        f"count:{lbl}": counts[row] for lbl, row in labels.items()}


def assert_models_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def rounds(clusters):
    """name -> both servers' models after that cluster's round (each
    cluster trains and mixes once, whichever test asks first)."""
    done = {}

    def get(name):
        if name not in done:
            done[name] = trained_round(clusters, name)
        return done[name]

    return get


def trained_round(clusters, name):
    """Train each server's pair, do_mix on one, read both models; a
    second do_mix on the other server must change nothing."""
    svc, quantize, _pkgs, _coordinator = CLUSTERS[name]
    ports = clusters[name]
    for port, pair in zip(ports, PAIRS):
        assert call(port, "train", "", wire_pair(svc, pair)) == 2
    # v2 from the port server (index 1), v3 from the JAX server
    master = 0 if quantize else 1
    assert call(ports[master], "do_mix", "") is True
    models = [model_of(p, svc) for p in ports]
    assert call(ports[1 - master], "do_mix", "") is True
    for port, before in zip(ports, models):
        assert_models_equal(model_of(port, svc), before)
    return models


def quantization_bound(svc):
    """The round's accumulated quantization error: the same v3 round on
    two in-process JAX drivers, summing max |x - dq(q(x))| over its
    three encodes (both diffs and the merged one)."""
    drivers = [jcreate(svc, CONFIGS[svc]) for _ in PAIRS]
    for d, pair in zip(drivers, PAIRS):
        d.train(jax_pair(svc, pair))
    caps = []

    def v3(diff):
        q, st = jcodec.quantize_tree(diff)
        caps.append(st["max_abs_err"])
        return jcodec.decode(jcodec.unpackb(jcodec.packb(jcodec.encode(q))))

    diffs = [v3(d.encode_diff(d.get_diff_snapshot())) for d in drivers]
    v3(type(drivers[0]).mix(diffs[0], diffs[1]))
    return sum(caps) + 1e-6


@pytest.mark.parametrize("service", ["classifier", "regression"])
def test_f32_round_is_bitwise_the_all_jax_round(rounds, service):
    mixed = rounds(f"{service}_f32_mixed")
    jax = rounds(f"{service}_f32_jax")
    assert_models_equal(mixed[0], mixed[1])
    assert_models_equal(mixed[0], jax[0])
    assert_models_equal(mixed[1], jax[1])
    if service == "classifier":
        assert {k: int(v) for k, v in mixed[1].items()
                if k.startswith("count:")} == {"count:A": 2, "count:B": 2}


def test_the_port_coordinator_serves_a_mixed_cluster(rounds):
    """A JAX server and a port server reconcile through the port's
    coordinator, bitwise as through the JAX one."""
    assert_models_equal(rounds("classifier_f32_port_coordinator")[0],
                        rounds("classifier_f32_jax")[0])
    assert_models_equal(rounds("classifier_f32_port_coordinator")[1],
                        rounds("classifier_f32_jax")[1])


@pytest.mark.parametrize("service", ["classifier", "regression"])
def test_v3_round_is_within_the_quantization_bound(clusters, rounds,
                                                   service):
    quant = rounds(f"{service}_v3_mixed")
    exact = rounds(f"{service}_f32_jax")
    assert_models_equal(quant[0], quant[1])
    eps = quantization_bound(service)
    drift = max(float(np.max(np.abs(quant[1][k] - exact[1][k])))
                for k in exact[1] if not k.startswith("count:"))
    assert 0.0 < drift <= eps, (drift, eps)
    for k in exact[1]:
        if k.startswith("count:"):
            assert quant[1][k] == exact[1][k] == 2
    status = call(clusters[f"{service}_v3_mixed"][1], "get_status", "")
    st = next(iter(status.values()))
    assert st["mix_wire_version"] == "3" and st["is_standalone"] == "0"
    assert st["mix_round"] == "2"
