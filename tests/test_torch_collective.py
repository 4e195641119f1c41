"""The port's collective MIX tier against the JAX package's, on the CPU.

- ring_all_reduce_int8 (parallel/quantized.py) against the JAX ring inside
  shard_map on the suite's virtual 8-device mesh: n 2-8, an unaligned
  shape, one element, below and above the size floor and with min_elems
  0.  The port computes the written arithmetic (the plain quantize and
  dequantize on the CPU); XLA's CPU code rewrites it in the JAX ring (the
  scale's / 127 as a multiply by its reciprocal, a hop's dequantize-add
  as a fused multiply-add).  So the chunking, the hop order and the
  owner's requantize are held bitwise on inputs whose every scale is a
  whole number, where the rewrite changes no bit, and seeded inputs of
  every magnitude within one quantization step of their 32 x 512 tile.
- make_tree_mix (parallel/collective.py): f32, int and bool leaves
  bitwise, f32 and int8 payloads: the f32 sum across replicas is XLA's
  CPU all-reduce order, x0 + x1 + ... in rank order, and inside the JAX
  fold's program XLA keeps the ring's written arithmetic.
- _sparsify_topk (models/base.py) and note_collective_bytes bitwise.
- A standalone --dp_replicas 4 server of each package (CLI processes)
  fed the same wire frames: the same collective round (get_status), the
  same cmix journal record bytes, models within rtol 1e-5 / atol 1e-6,
  and each package recovering the other's journal root after a SIGKILL.
- Mixed linear-mixer clusters of one port and one JAX --dp_replicas 2
  member (the JAX one on its virtual mesh through XLA_FLAGS): f32, with
  --mix_topk 1, and under --mixer collective_mixer (distinct mix groups,
  so the round takes the wire): both members agree bitwise after the
  rounds.
"""

import json
import shutil
import signal
import sys
import time
from types import SimpleNamespace

import msgpack
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

import jax
from jubatus_tpu.mix import linear_mixer as jlinear
from jubatus_tpu.models import base as jbase
from jubatus_tpu.parallel import collective as jcollective
from jubatus_tpu.parallel import quantized as jquantized
from jubatus_tpu.utils.metrics import GLOBAL as JGLOBAL
from jubatus_tpu_torch.cluster.membership import MembershipClient
from jubatus_tpu_torch.durability.journal import scan_segment_records
from jubatus_tpu_torch.framework.save_load import load_model
from jubatus_tpu_torch.framework.server_base import USER_DATA_VERSION
from jubatus_tpu_torch.mix import linear_mixer as tlinear
from jubatus_tpu_torch.models import base as tbase
from jubatus_tpu_torch.parallel import collective as tcollective
from jubatus_tpu_torch.parallel import quantized as tquantized
from jubatus_tpu_torch.rpc.client import Client
from jubatus_tpu_torch.utils.metrics import GLOBAL as TGLOBAL
from tests.test_torch_cluster_mixed import (CONFIGS as MIXED_CONFIGS, PAIRS,
                                            Proc, model_of, wire_pair)
from tests.test_torch_durability import (CONFIGS, Wire, assert_close_models,
                                         train_frames)

try:
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

torch.set_num_threads(1)

START_S = 120
CALL_S = 60


def jax_ring(x, n, min_elems):
    mesh = JMesh(np.array(jax.devices()[:n]), ("dp",))
    f = jax.jit(shard_map(
        lambda a: jquantized.ring_all_reduce_int8(a[0], "dp", n,
                                                  min_elems=min_elems)[None],
        mesh=mesh, in_specs=P("dp"), out_specs=P("dp")))
    return np.asarray(f(x))


def spread(rng, shape):
    return (rng.standard_normal(shape)
            * np.exp(rng.uniform(-4, 4, shape))).astype(np.float32)


def whole_scales(rng, shape):
    """[n, ...] whole numbers in [-126, 126] with 127 at the first element
    of every 32 x 512 tile of the ring's flat layout, in every rank: after
    t hops a tile's running sum peaks at that element, 127 (t + 1), so
    every scale is the whole number t + 1, which float32(1 / 127) also
    gives, and every product and sum is exact."""
    x = rng.integers(-126, 127, shape).astype(np.float32)
    flat = x.reshape(shape[0], -1)
    flat[:, ::tquantized._BLOCK] = 127.0
    return x


def ring_steps(x, got, want):
    """|got - want| over the quantization step of want's 32 x 512 tile of
    the ring's layout (absmax / 127), the worst element."""
    n, size = x.shape[0], x[0].size
    chunk = tquantized._BLOCK * -(-size // (n * tquantized._BLOCK))
    mag = np.zeros((n, n * chunk), np.float32)
    mag[:, :size] = np.abs(want.reshape(n, size))
    step = np.repeat(mag.reshape(n, -1, tquantized._BLOCK).max(2) / 127.0,
                     tquantized._BLOCK, 1)[:, :size]
    diff = np.abs(got.reshape(n, size).astype(np.float64)
                  - want.reshape(n, size))
    return float((diff / np.maximum(step, np.finfo(np.float32).tiny)).max())


# -- the int8 ring ----------------------------------------------------------------

@pytest.mark.parametrize("shape,min_elems", [
    ((3, 5000), 0), ((7, 4099), -1), ((1,), 0), ((40000,), -1),
    ((33, 1000), 0), ((100,), -1)],
    ids=["small_rings", "unaligned", "one_element", "above_floor",
         "ragged_rows", "below_floor"])
@pytest.mark.parametrize("n", [2, 3, 4, 5, 6, 7, 8])
def test_ring_is_bitwise_the_jax_ring(n, shape, min_elems):
    rng = np.random.default_rng(n * 100 + len(shape))
    x = whole_scales(rng, (n,) + shape)
    got = tquantized.ring_all_reduce_int8(torch.from_numpy(x), min_elems)
    want = jax_ring(x, n, min_elems)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    # every magnitude: one rounding that falls the other way costs one
    # step of the tile; the scales' last bits add under 1e-4 of a step
    # (2e-5 seen)
    x = spread(rng, (n,) + shape)
    got = tquantized.ring_all_reduce_int8(torch.from_numpy(x), min_elems)
    want = jax_ring(x, n, min_elems)
    assert ring_steps(x, got.numpy(), want) <= 1.0 + 1e-4


def test_ring_of_one_rank_is_the_identity():
    x = torch.ones((1, 5))
    assert tquantized.ring_all_reduce_int8(x) is x


def test_ring_below_the_floor_is_the_exact_sum_in_rank_order():
    rng = np.random.default_rng(3)
    x = spread(rng, (3, 10))
    got = tquantized.ring_all_reduce_int8(torch.from_numpy(x)).numpy()
    want = (x[0] + x[1]) + x[2]
    for r in range(3):
        np.testing.assert_array_equal(got[r], want)


# -- the tree fold ----------------------------------------------------------------

@pytest.mark.parametrize("payload", ["f32", "int8"])
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_tree_mix_is_bitwise_the_jax_fold(n, payload):
    rng = np.random.default_rng(n)
    L, D = 4, 8192
    state = {"w": spread(rng, (n, L, D)),
             "counts": rng.integers(-50, 50, (n, L)).astype(np.int32),
             "active": rng.random((n, L)) > 0.6}
    base = {"w": np.repeat(spread(rng, (1, L, D)), n, 0),
            "counts": np.repeat(rng.integers(0, 9, (1, L)).astype(np.int32),
                                n, 0),
            "active": state["active"]}
    mesh = JMesh(np.array(jax.devices()[:n]), ("dp",))
    want = jcollective.make_tree_mix(mesh, payload)(state, base)
    got = tcollective.make_tree_mix(n, payload)(
        {k: torch.from_numpy(v) for k, v in state.items()},
        {k: torch.from_numpy(v) for k, v in base.items()})
    for k in state:
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # every replica holds the folded value
    for r in range(1, n):
        assert torch.equal(got["w"][r], got["w"][0])


def test_tree_mix_refuses_an_unknown_payload():
    with pytest.raises(ValueError, match="unknown mix payload"):
        tcollective.make_tree_mix(2, "bf16")


# -- top-k sparsification and the byte estimate ------------------------------

@pytest.mark.parametrize("k", [0, 1, 3, 40])
@pytest.mark.parametrize("ndim", [1, 2])
def test_sparsify_topk_is_bitwise_jax(k, ndim):
    rng = np.random.default_rng(k + ndim)
    cols = np.sort(rng.choice(1000, 12, replace=False)).astype(np.int32)
    shape = (12,) if ndim == 1 else (3, 12)
    diff = {"labels": ["a", "b", "c"], "cols": cols,
            "w": rng.standard_normal(shape).astype(np.float32),
            "cov": rng.standard_normal(shape).astype(np.float32), "k": 1}
    want = jbase.Driver._sparsify_topk(SimpleNamespace(mix_topk=k), diff)
    got = tbase.Driver._sparsify_topk(SimpleNamespace(mix_topk=k), diff)
    assert list(got) == list(want)
    for key, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[key], v)
            assert got[key].dtype == v.dtype
        else:
            assert got[key] == v
    if 0 < k < 12:
        assert got["cols"].size == k


# -- the tier choice: a port member is its own mix group ------------------------

class _Groups:
    """A coordinator's member list and mix_group entries, in memory."""

    def __init__(self):
        self.nodes, self.groups = [], {}

    def register_mix_group(self, group, ip, port):
        self.groups.setdefault(group, []).append((ip, port))

    def get_all_nodes(self):
        return list(self.nodes)

    def get_mix_groups(self):
        return {g: list(m) for g, m in self.groups.items()}


class _Inner:
    def register_active(self, ip, port):
        pass

    def get_status(self):
        return {}


def test_a_port_member_is_its_own_mix_group(monkeypatch):
    """The port folds only the replicas one process holds, so it takes no
    group name (JAX's JUBATUS_MIX_GROUP is not read): every port member
    registers `<ip>_<port>`, and any peer sends the round over the wire,
    also to and from a JAX member whose group names several processes."""
    from jubatus_tpu.mix.collective import CollectiveMixer as JMixer
    from jubatus_tpu_torch.mix.collective import CollectiveMixer as TMixer
    monkeypatch.setenv("JUBATUS_MIX_GROUP", "podA")
    reg = _Groups()
    port_a, port_b = (TMixer(None, reg, _Inner()) for _ in range(2))
    jax_m = JMixer(None, reg, _Inner())
    for m, loc in ((port_a, ("10.0.0.1", 9001)), (port_b, ("10.0.0.2", 9002)),
                   (jax_m, ("10.0.0.3", 9003))):
        m.register_active(*loc)
    assert (port_a.group_id, port_b.group_id, jax_m.group_id) == \
        ("10.0.0.1_9001", "10.0.0.2_9002", "podA")
    assert port_a.get_status()["mix_group"] == "10.0.0.1_9001"
    reg.nodes = [("10.0.0.1", 9001)]
    assert port_a._cross_group_due() is False      # alone: the fold
    reg.nodes = [("10.0.0.1", 9001), ("10.0.0.2", 9002)]
    assert port_a._cross_group_due() is True
    assert port_b._cross_group_due() is True
    reg.nodes.append(("10.0.0.3", 9003))
    assert jax_m._cross_pod_due() is True
    with pytest.raises(TypeError):
        TMixer(None, reg, _Inner(), mix_group="podA")


@pytest.mark.parametrize("payload", ["f32", "int8"])
@pytest.mark.parametrize("n", [1, 2, 8])
def test_collective_byte_estimate_is_jax_s(n, payload):
    JGLOBAL.reset()
    TGLOBAL.reset()
    args = (32 * (1 << 20) * 2, 64, n)
    assert tlinear.note_collective_bytes(*args, payload=payload) == \
        jlinear.note_collective_bytes(*args, payload=payload)
    for key in ("mix_bytes_sent_total", "mix_bytes_received_total"):
        assert TGLOBAL.snapshot().get(key) == JGLOBAL.snapshot().get(key)
    JGLOBAL.reset()
    TGLOBAL.reset()


# -- a standalone --dp_replicas 4 server of each package, over the wire -----

PKGS = {"jax": "jubatus_tpu", "port": "jubatus_tpu_torch"}


def dp_server(pkg, service, cfg, root, tmp_path, tag):
    argv = [sys.executable, "-m", f"{PKGS[pkg]}.cli.server", "--type",
            service, "--configpath", str(cfg), "--rpc-port", "0",
            "--listen_addr", "127.0.0.1", "--datadir",
            str(tmp_path / f"data_{tag}"), "--journal", str(root),
            "--journal_fsync", "always", "--snapshot_interval", "0",
            "--interval_sec", "100000", "--interval_count", "1000000",
            "--dp_replicas", "4"]
    (tmp_path / f"data_{tag}").mkdir(exist_ok=True)
    if pkg == "port":
        argv += ["--device", "cpu"]
    return Proc(argv)


def port_of(proc):
    line = proc.wait_for("jubatus ready", START_S)
    return int(line.split()[2].split("=")[1])


def status(port):
    with Client("127.0.0.1", port, timeout=CALL_S) as c:
        return next(iter(c.call_raw("get_status", "").values()))


def saved(port, service, cfg_text, mid):
    with Client("127.0.0.1", port, timeout=CALL_S) as c:
        (path,) = c.call_raw("save", "", mid).values()
    with open(path, "rb") as fp:
        return load_model(fp, server_type=service, expected_config=cfg_text,
                          user_data_version=USER_DATA_VERSION)


def cmix_records(root):
    out = []
    for _info, records in scan_segment_records(str(root)):
        out += [r for r in records if isinstance(r, dict)
                and r.get("k") == "cmix"]
    return out


@pytest.mark.parametrize("service", ["classifier", "regression"])
def test_standalone_dp_servers_fold_journal_and_recover_alike(tmp_path,
                                                              service):
    cfg_obj = json.loads(json.dumps(CONFIGS[service]))
    cfg_obj.setdefault("parameter", {})["mix_payload"] = "int8"
    cfg_text = json.dumps(cfg_obj)
    cfg = tmp_path / "c.json"
    cfg.write_text(cfg_text)
    frames = train_frames(service, 7, n_frames=6, per=9)
    roots = {pkg: tmp_path / f"root_{pkg}" for pkg in PKGS}
    procs = {pkg: dp_server(pkg, service, cfg, roots[pkg], tmp_path, pkg)
             for pkg in PKGS}
    models = {}
    try:
        ports = {pkg: port_of(p) for pkg, p in procs.items()}
        for pkg, port in ports.items():
            w = Wire(port)
            for fr in frames[:4]:
                assert w.send(fr)[2] is None
            assert w.call("do_mix") is True
            for fr in frames[4:]:
                assert w.send(fr)[2] is None
            w.close()
        sts = {pkg: status(port) for pkg, port in ports.items()}
        for st in sts.values():
            assert st["dp_replicas"] == "4" and st["mix_collective"] == "1"
            assert st["mixer"] == "collective_mixer"
            assert st["collective_round"] == "1"
            assert int(st["mix_bytes_sent_total"]) > 0
        assert sts["port"]["mix_bytes_sent_total"] == \
            sts["jax"]["mix_bytes_sent_total"]
        assert sts["port"]["updates_since_device_mix"] == \
            sts["jax"]["updates_since_device_mix"]
        for pkg, port in ports.items():
            models[pkg] = saved(port, service, cfg_text, f"m_{pkg}")
        assert_close_models(service, models["port"], models["jax"])
        recs = {pkg: cmix_records(roots[pkg]) for pkg in PKGS}
        assert recs["port"] == recs["jax"] == [{"k": "cmix", "cr": 1}]
        assert msgpack.packb(recs["port"][0], use_bin_type=True) == \
            msgpack.packb(recs["jax"][0], use_bin_type=True)
        for p in procs.values():
            p.p.send_signal(signal.SIGKILL)
            p.p.wait(timeout=CALL_S)
        # each package recovers the other's root, each on its own copy
        crossed = {}
        for reader, writer in (("port", "jax"), ("jax", "port")):
            copy = tmp_path / f"{reader}_reads_{writer}"
            shutil.copytree(roots[writer], copy)
            (copy / "LOCK").unlink(missing_ok=True)
            crossed[reader] = dp_server(reader, service, cfg, copy, tmp_path,
                                        f"x_{reader}")
            procs[f"x_{reader}"] = crossed[reader]
        for reader, writer in (("port", "jax"), ("jax", "port")):
            port = port_of(crossed[reader])
            st = status(port)
            assert st["recovery_errors"] == "0"
            assert int(st["recovery_replayed"]) == 7    # 6 windows, 1 cmix
            assert st["collective_round"] == "1"
            if reader == "port":
                assert st["recovery_collective_round"] == "1"
            assert_close_models(service, saved(port, service, cfg_text,
                                               f"r_{reader}"),
                                models[writer])
    finally:
        for p in procs.values():
            p.kill()


# -- mixed linear-mixer clusters of data-parallel members --------------------------

DP_CLUSTERS = {
    "dp_f32": [],
    "dp_topk": ["--mix_topk", "1"],
    "dp_collective": ["--mixer", "collective_mixer"],
}


@pytest.fixture(scope="module")
def dp_clusters():
    """The port's coordinator and, per cluster, a JAX and a port
    classifier member with --dp_replicas 2; -> {name: [jax port, port
    port]}."""
    procs = []
    try:
        coord = Proc([sys.executable, "-m",
                      "jubatus_tpu_torch.cluster.coordinator", "--rpc-port",
                      "0", "--listen_addr", "127.0.0.1", "--session_ttl",
                      "5"])
        procs.append(coord)
        addr = coord.wait_for("jubacoordinator").split()[-1]
        setters = {}
        for name in DP_CLUSTERS:
            m = MembershipClient(addr, "classifier", name)
            m.set_config(json.dumps(MIXED_CONFIGS["classifier"]))
            setters[name] = m
        started = {}
        for name, extra in DP_CLUSTERS.items():
            started[name] = []
            for pkg in ("jubatus_tpu", "jubatus_tpu_torch"):
                argv = [sys.executable, "-m", f"{pkg}.cli.server", "--type",
                        "classifier", "--name", name, "--rpc-port", "0",
                        "--listen_addr", "127.0.0.1", "--eth", "127.0.0.1",
                        "--coordinator", addr, "--interval_sec", "100000",
                        "--interval_count", "1000000", "--dp_replicas", "2",
                        *extra]
                if pkg == "jubatus_tpu_torch":
                    argv += ["--device", "cpu"]
                started[name].append(Proc(argv))
            procs.extend(started[name])
        ports = {name: [port_of(p) for p in pair]
                 for name, pair in started.items()}
        for name, m in setters.items():
            want = {("127.0.0.1", p) for p in ports[name]}
            deadline = time.monotonic() + START_S
            while set(m.get_all_nodes()) != want:
                assert time.monotonic() < deadline, f"{name} never joined"
                time.sleep(0.2)
            m.close()
        # a JAX master reads its members from a cache up to a second old
        time.sleep(1.2)
        yield ports
    finally:
        for p in procs:
            p.kill()


def call(port, method, *args):
    with Client("127.0.0.1", port, name="", timeout=CALL_S) as c:
        return c.call_raw(method, *args)


@pytest.mark.parametrize("name", sorted(DP_CLUSTERS))
def test_mixed_dp_members_agree_after_rounds(dp_clusters, name):
    ports = dp_clusters[name]
    for port, pair in zip(ports, PAIRS):
        assert call(port, "train", "", wire_pair("classifier", pair)) == 2
    rounds = 0
    models = None
    for rounds in range(1, 9):
        # the port member masters the round
        assert call(ports[1], "do_mix", "") is True
        models = [model_of(p, "classifier") for p in ports]
        if all(np.array_equal(models[0][k], models[1][k])
               for k in models[0]):
            break
    assert sorted(models[0]) == sorted(models[1])
    for k in models[0]:
        np.testing.assert_array_equal(models[0][k], models[1][k], err_msg=k)
    assert {k: int(v) for k, v in models[1].items()
            if k.startswith("count:")} == {"count:A": 2, "count:B": 2}
    if name == "dp_topk":
        assert rounds > 1            # the dropped columns shipped later
    else:
        assert rounds == 1
    for port in ports:
        st = next(iter(call(port, "get_status", "").values()))
        assert st["dp_replicas"] == "2"
        assert st["mix_topk"] == ("1" if name == "dp_topk" else "0")
        if name == "dp_collective":
            assert st["mixer"] == "collective_mixer"
            assert st["dcn_tier"] == "linear_mixer"
    # the second member's do_mix changes nothing
    assert call(ports[0], "do_mix", "") is True
    for port, before in zip(ports, models):
        after = model_of(port, "classifier")
        for k in before:
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)

