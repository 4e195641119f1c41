"""The port's tenancy plane (jubatus_tpu_torch/tenancy/) against the JAX
package's (tests/test_tenancy.py's cases, held side by side).

  * the quota units: TokenBucket, TenantQuotas and QuotaSpec.from_wire
    give the JAX package's results over seeded call sequences on a fake
    clock; ProxyQuotaGate rejects from its cached view and survives a
    fetch failure, as JAX's does;
  * the layout: the LAYOUT stamps, the catalog round trip (across the
    packages) and the slot-name rule are the JAX package's;
  * the registry: resolution, idempotent admission, the slot cap, the
    lock guard (LockDisciplineError), the item-7 refusals;
  * three port slots (CPU) fed the same trains as three single-model JAX
    servers and a JAX server with three slots end in the same tables,
    within tests/test_torch_classifier.py's tolerance (labels and counts
    exact), and classify alike; save and load work per slot, and a file
    a port slot saved loads into the JAX server's slot;
  * a create or drop under traffic on another slot is invisible to it;
  * the train and query rates and the row cap reject as the JAX
    server's do, on a frozen quota clock in both packages;
  * a dropped slot's driver and tensors are freed (weak references).
"""

import gc
import json
import threading
import weakref

import msgpack
import numpy as np
import pytest

from jubatus_tpu.framework import server_base as jserver_base
from jubatus_tpu.framework import service as jservice
from jubatus_tpu.rpc import server as jrpc
from jubatus_tpu.tenancy import layout as jlayout
from jubatus_tpu.tenancy import quotas as jquotas
from jubatus_tpu.tenancy import registry as jregistry
from jubatus_tpu_torch.framework import server_base as tserver_base
from jubatus_tpu_torch.framework import service as tservice
from jubatus_tpu_torch.rpc import server as trpc
from jubatus_tpu_torch.rpc.client import Client, RemoteError
from jubatus_tpu_torch.tenancy import layout as tlayout
from jubatus_tpu_torch.tenancy import quotas as tquotas
from jubatus_tpu_torch.tenancy import registry as tregistry
from jubatus_tpu_torch.utils.metrics import GLOBAL as TMETRICS
from jubatus_tpu_torch.utils.rwlock import LockDisciplineError
from tests.test_torch_classifier import ATOL, RTOL
from tests.test_torch_durability import tables

CONVERTER = {
    "string_rules": [{"key": "*", "type": "str", "sample_weight": "bin",
                      "global_weight": "bin"}],
    "num_rules": [{"key": "*", "type": "num"}],
    "hash_max_size": 4096,
}
CONFIG = {"method": "AROW", "parameter": {"regularization_weight": 1.0},
          "converter": CONVERTER}
RECO = {"method": "inverted_index", "parameter": {}, "converter": CONVERTER}

PKG = {
    "jax": (jserver_base, jservice, jrpc),
    "port": (tserver_base, tservice, trpc),
}
QUOTAS = {"jax": jquotas, "port": tquotas}
LAYOUTS = {"jax": jlayout, "port": tlayout}
STREAMS = {"c": "alpha", "m1": "beta", "m2": "gamma"}


def batch(stream, i, rng=None):
    n = 3 if rng is None else int(rng.integers(2, 6))
    return [[f"l{(i + j) % 3}", [[["k", f"{stream}tok{i}_{j}"]],
                                 [["x", 0.5 + 0.1 * j]], []]]
            for j in range(n)]


def query(stream, i):
    return [[["k", f"{stream}tok{i}_0"]], [["x", 0.7]], []]


def make_server(pkg, cfg=CONFIG, **kw):
    """A server of `pkg` (the port's on the CPU) bound and listening."""
    base, service, rpcmod = PKG[pkg]
    if pkg == "port":
        kw.setdefault("device", "cpu")
    args = base.ServerArgs(type=kw.pop("type", "classifier"),
                           name=kw.pop("name", "c"), rpc_port=0, **kw)
    srv = base.JubatusServer(args, config=json.dumps(cfg))
    srv.init_durability()
    rpc = rpcmod.RpcServer(threads=4)
    service.bind_service(srv, rpc)
    port = rpc.start(0, host="127.0.0.1")
    args.rpc_port = port
    return srv, rpc, port


def stop_server(pkg, srv, rpc):
    rpc.stop()
    if pkg == "port":
        srv.stop()
        return
    srv.slots.shutdown_all()
    for slot in srv.slots.all():
        for lane in (slot.dispatcher, slot.read_dispatch):
            if lane is not None:
                lane.stop()
    srv.shutdown_durability()


def flush_all(srv):
    for slot in srv.slots.all():
        if slot.dispatcher is not None:
            slot.dispatcher.flush()


def pack_of(slot):
    return slot.driver.pack()


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    """One fake monotonic clock for both packages' quota modules."""
    fake = FakeClock()
    for mod in QUOTAS.values():
        monkeypatch.setattr(mod, "time", fake)
    return fake


# ---------------------------------------------------------------------------
# quota units, on a fake clock
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_token_bucket_matches_jax_on_a_fake_clock(clock, seed):
    rng = np.random.default_rng(seed)
    rate = float(rng.choice([0.0, 1.0, 2.5, 5.0]))
    buckets = {p: QUOTAS[p].TokenBucket(rate) for p in QUOTAS}
    seen = {p: [] for p in QUOTAS}
    for _ in range(200):
        clock.t += float(rng.exponential(0.2))
        op = rng.random()
        n = float(rng.choice([1.0, 1.0, 3.0, 12.0]))
        new_rate = float(rng.choice([0.0, 1.5, 4.0, 8.0]))
        for p, b in buckets.items():
            if op < 0.1:
                b.set_rate(new_rate)
                seen[p].append(("rate", b.rate, b._tokens))
            else:
                seen[p].append(("take", b.take(n), b._tokens))
    assert seen["port"] == seen["jax"]
    assert any(t[0] == "take" and t[1] is False for t in seen["port"]) \
        or rate == 0.0


def _outcome(fn):
    try:
        fn()
        return "ok"
    except Exception as e:  # noqa: BLE001 - compared across packages
        return f"{type(e).__name__}: {e}"


@pytest.mark.parametrize("seed", range(3))
def test_tenant_quotas_match_jax_on_a_fake_clock(clock, seed):
    rng = np.random.default_rng(seed)
    max_slots = int(rng.integers(0, 3))
    tqs = {p: QUOTAS[p].TenantQuotas(max_slots=max_slots) for p in QUOTAS}
    seen = {p: [] for p in QUOTAS}
    for _ in range(150):
        clock.t += float(rng.exponential(0.15))
        tenant = f"t{int(rng.integers(3))}"
        op = int(rng.integers(6))
        rows, limit = int(rng.integers(0, 8)), int(rng.integers(0, 6))
        current = int(rng.integers(0, 4))
        spec_args = dict(max_rows=int(rng.integers(0, 5)),
                         train_rps=float(rng.choice([0, 1, 3])),
                         query_rps=float(rng.choice([0, 2])))
        kind = "train" if rng.random() < 0.6 else "query"
        n = int(rng.choice([1, 1, 4]))
        still = bool(rng.random() < 0.5)
        for p, tq in tqs.items():
            q = QUOTAS[p]
            if op == 0:
                spec = q.QuotaSpec(**spec_args)
                out = _outcome(lambda: tq.configure(tenant, spec))
            elif op == 1:
                out = _outcome(lambda: tq.forget(tenant, still))
            elif op == 2:
                out = _outcome(lambda: tq.check_slot_count(tenant, current))
            elif op == 3:
                out = _outcome(lambda: tq.check_rows(tenant, rows, limit))
            else:
                out = _outcome(lambda: tq.allow(tenant, kind, n))
            seen[p].append(out)
    assert seen["port"] == seen["jax"]
    assert any(o.startswith("QuotaExceeded: quota_exceeded")
               for o in seen["port"])


WIRE_QUOTAS = [None, {}, {"train_rps": 0}, {"max_rows": 10, "train_rps": 2.5},
               {b"query_rps": 7, b"max_rows": 3}, {"train_rps": "1.5"},
               {"max_rows": None, "query_rps": 0.25}, [1, 2], "x"]


@pytest.mark.parametrize("obj", WIRE_QUOTAS, ids=repr)
def test_quota_spec_from_wire_matches_jax(obj):
    out = {}
    for p, q in QUOTAS.items():
        try:
            spec = q.QuotaSpec.from_wire(obj)
            out[p] = None if spec is None else spec.to_wire()
        except Exception as e:  # noqa: BLE001 - compared across packages
            out[p] = (type(e).__name__, str(e))
    assert out["port"] == out["jax"]


def test_proxy_gate_rejects_from_cached_view_as_jax(clock):
    view = {"m1": {"tenant": "t9", "quota": {"train_rps": 1.0,
                                             "query_rps": 0}}}
    seen = {}
    for p, q in QUOTAS.items():
        fetches = []

        def fetch(name, _f=fetches):
            _f.append(name)
            return view
        gate = q.ProxyQuotaGate(fetch, submit=None, ttl=60.0)
        out = []
        for step in range(12):
            clock.t += 0.3 if step % 4 == 0 else 0.0
            for model, kind in (("m1", q.TRAIN), ("m1", q.QUERY),
                                ("unknown", q.TRAIN)):
                out.append(_outcome(lambda: gate.admit(model, kind)))
        seen[p] = (out, fetches)
    assert seen["port"] == seen["jax"]
    assert any("exceeded (proxy)" in o for o in seen["port"][0])


def test_proxy_gate_survives_fetch_failure():
    def boom(name):
        raise RuntimeError("membership down")
    for q in QUOTAS.values():
        gate = q.ProxyQuotaGate(boom, submit=None, ttl=0.0)
        gate.admit("m1", q.TRAIN)            # never raises on a fetch error
        assert gate.info_of("m1") is None


def test_quota_rejections_count_per_tenant():
    tq = tquotas.TenantQuotas()
    tq.configure("count-me", tquotas.QuotaSpec(train_rps=1.0))
    before = float(TMETRICS.snapshot().get(
        "tenant_quota_rejected_total.count-me", 0))
    tq.allow("count-me", tquotas.TRAIN)
    with pytest.raises(tquotas.QuotaExceeded, match="^quota_exceeded"):
        tq.allow("count-me", tquotas.TRAIN)
    assert float(TMETRICS.snapshot()[
        "tenant_quota_rejected_total.count-me"]) == before + 1


# ---------------------------------------------------------------------------
# the layout and the catalog
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("legacy", [False, True])
def test_layout_stamps_match_jax(tmp_path, legacy):
    got = {}
    for p, lay in LAYOUTS.items():
        root = tmp_path / p
        root.mkdir()
        if legacy:
            (root / "journal-00000000.wal").write_bytes(b"x")
            (root / "MANIFEST").write_text("{}")
        first = lay.prepare_root(str(root))
        again = lay.prepare_root(str(root))
        got[p] = (first, again, (root / "LAYOUT").read_bytes(),
                  (root / "slots").is_dir(), lay.read_layout_version(str(root)))
    assert got["port"] == got["jax"]
    assert got["port"][0] is legacy
    # either package takes the other's stamped root as stamped
    assert jlayout.prepare_root(str(tmp_path / "port")) is False
    assert tlayout.prepare_root(str(tmp_path / "jax")) is False


def test_newer_layout_is_refused(tmp_path):
    (tmp_path / "LAYOUT").write_text(json.dumps({"layout_version": 99}))
    with pytest.raises(RuntimeError, match="layout_version 99"):
        tlayout.prepare_root(str(tmp_path))


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_catalog_round_trip_across_packages(tmp_path, writer, reader):
    models = [{"name": "m1", "tenant": "t", "config": "{}",
               "quota": {"max_rows": 5, "train_rps": 0.0,
                         "query_rps": 0.0}},
              {"name": "m2", "tenant": "", "config": json.dumps(CONFIG),
               "quota": None}]
    for root in (tmp_path / "a", tmp_path / "b"):
        LAYOUTS[writer].prepare_root(str(root))
    LAYOUTS[writer].store_catalog(str(tmp_path / "a"), models)
    LAYOUTS[reader].store_catalog(str(tmp_path / "b"), models)
    assert (tmp_path / "a" / "MODELS.json").read_bytes() == \
        (tmp_path / "b" / "MODELS.json").read_bytes()
    assert LAYOUTS[reader].load_catalog(str(tmp_path / "a")) == models
    LAYOUTS[writer].store_catalog(str(tmp_path / "a"), [])
    assert LAYOUTS[reader].load_catalog(str(tmp_path / "a")) == []
    assert tlayout.slot_dir("/w", "m1") == jlayout.slot_dir("/w", "m1")


@pytest.mark.parametrize("name", ["", "a/b", "../x", ".hidden", "a" * 200,
                                  "a b", "m1", "cohort-7.v2", "A_b",
                                  "a" * 128, "9", "-x", "x\n"])
def test_slot_name_validation_matches_jax(name):
    out = {p: _outcome(lambda: lay.validate_slot_name(name))
           for p, lay in LAYOUTS.items()}
    assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def test_create_resolve_drop_and_listing_match_jax():
    listings = {}
    for p in ("jax", "port"):
        srv, rpc, _ = make_server(p)
        try:
            assert srv.slots.multi is False
            assert srv.slot_for("anything") is srv
            srv.create_model({"name": "m1", "tenant": "t1",
                              "quota": {"query_rps": 4}})
            assert srv.slots.multi is True
            m1 = srv.slot_for("m1")
            assert m1 is not srv and m1.tenant == "t1"
            assert m1.args.name == "m1"
            for other in ("nope", "c", None, b"c"):
                assert srv.slot_for(other) is srv
            assert srv.slot_for(b"m1") is m1
            listings[p] = srv.list_models()
            srv.drop_model("m1")
            assert srv.slot_for("m1") is srv
            assert set(srv.list_models()) == {"c"}
        finally:
            stop_server(p, srv, rpc)
    assert listings["port"] == listings["jax"]


def test_admission_errors_and_idempotency():
    srv, rpc, _ = make_server("port")
    try:
        with pytest.raises(ValueError, match="invalid model name"):
            srv.create_model({"name": "bad/name"})
        with pytest.raises(ValueError, match="wants a map"):
            srv.create_model(["m1"])
        srv.create_model({"name": "m1", "tenant": "t1"})
        assert srv.create_model({b"name": b"m1", b"tenant": b"t1"}) is True
        assert len(srv.slots) == 2
        with pytest.raises(ValueError, match="already exists"):
            srv.create_model({"name": "m1", "tenant": "other"})
        with pytest.raises(ValueError, match="already exists"):
            srv.create_model({"name": "c"})
        with pytest.raises(ValueError, match="cannot be dropped"):
            srv.drop_model("c")
        assert srv.drop_model("ghost") is True
        assert srv.drop_model("m1") is True
        assert srv.drop_model("m1") is True
    finally:
        stop_server("port", srv, rpc)


def test_the_migration_surface_is_refused_naming_item_7():
    srv, rpc, port = make_server("port")
    try:
        with pytest.raises(ValueError, match="Queue 1 item 7"):
            srv.create_model({"name": "m1", "standby": True})
        assert srv.slot_for("m1") is srv
        with Client("127.0.0.1", port, timeout=30) as c:
            with pytest.raises(RemoteError, match="Queue 1 item 7"):
                c.call_raw("activate_model", "c", "m1")
    finally:
        stop_server("port", srv, rpc)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_max_slots_per_tenant(pkg):
    srv, rpc, _ = make_server(pkg, quota_max_slots=1)
    try:
        srv.create_model({"name": "m1", "tenant": "t1"})
        with pytest.raises(QUOTAS[pkg].QuotaExceeded, match="slot limit"):
            srv.create_model({"name": "m2", "tenant": "t1"})
        srv.create_model({"name": "m2", "tenant": "t2"})
        assert set(srv.list_models()) == {"c", "m1", "m2"}
    finally:
        stop_server(pkg, srv, rpc)


def test_registry_mutation_under_a_write_lock_raises():
    srv, rpc, _ = make_server("port")
    try:
        with srv.model_lock.write():
            with pytest.raises(LockDisciplineError):
                srv.create_model({"name": "m1"})
        assert srv.slot_for("m1") is srv
        srv.create_model({"name": "m1"})
        m1 = srv.slot_for("m1")
        with m1.model_lock.write():
            with pytest.raises(LockDisciplineError):
                srv.drop_model("m1")
        assert srv.slot_for("m1") is m1
    finally:
        stop_server("port", srv, rpc)


# ---------------------------------------------------------------------------
# three slots against three JAX servers and a JAX server with three slots
# ---------------------------------------------------------------------------


def _train(port, name, seed):
    rng = np.random.default_rng(seed)
    with Client("127.0.0.1", port, timeout=60) as c:
        for i in range(10):
            c.call_raw("train", name, batch(STREAMS[name], i, rng))


def _classify(port, name):
    with Client("127.0.0.1", port, timeout=60) as c:
        return [c.call_raw("classify", name, [query(STREAMS[name], i)])
                for i in range(5)]


def _assert_close_answers(a, b):
    for ra, rb in zip(a, b):
        for da, db in zip(ra, rb):
            assert [lbl for lbl, _ in da] == [lbl for lbl, _ in db]
            np.testing.assert_allclose([s for _, s in da], [s for _, s in db],
                                       rtol=RTOL, atol=ATOL)


def test_three_slots_equal_three_jax_servers_and_a_jax_multi_slot_server():
    names = ("c", "m1", "m2")
    multi = {p: make_server(p) for p in ("jax", "port")}
    singles = {}
    try:
        for p, (srv, _, port) in multi.items():
            srv.create_model({"name": "m1", "tenant": "t1"})
            srv.create_model({"name": "m2", "tenant": "t2"})
            for seed, name in enumerate(names):
                _train(port, name, seed)
            flush_all(srv)
        for seed, name in enumerate(names):
            singles[name] = make_server("jax", name=name)
            _train(singles[name][2], name, seed)
            flush_all(singles[name][0])
        port_srv = multi["port"][0]
        for name in names:
            want = tables("classifier", pack_of(singles[name][0]))
            for other in (pack_of(port_srv.slot_for(name)),
                          pack_of(multi["jax"][0].slot_for(name))):
                got = tables("classifier", other)
                assert sorted(got) == sorted(want), name
                for k in want:
                    if k.startswith("count:"):
                        np.testing.assert_array_equal(got[k], want[k])
                    else:
                        np.testing.assert_allclose(got[k], want[k],
                                                   rtol=RTOL, atol=ATOL)
            assert port_srv.slot_for(name).update_count == 10
            _assert_close_answers(_classify(multi["port"][2], name),
                                  _classify(singles[name][2], name))
        # the slots are distinct models, each with its own tables
        assert pack_of(port_srv.slot_for("m1"))["w"] != \
            pack_of(port_srv.slot_for("m2"))["w"]
    finally:
        for p, (srv, rpc, _) in multi.items():
            stop_server(p, srv, rpc)
        for srv, rpc, _ in singles.values():
            stop_server("jax", srv, rpc)


def test_save_and_load_per_slot_and_across_packages(tmp_path):
    port_srv, prpc, pport = make_server("port", datadir=str(tmp_path))
    jax_srv, jrpc_, jport = make_server("jax", datadir=str(tmp_path))
    try:
        for srv in (port_srv, jax_srv):
            srv.create_model({"name": "m1"})
        _train(pport, "c", 0)
        _train(pport, "m1", 1)
        flush_all(port_srv)
        with Client("127.0.0.1", pport, timeout=30) as c:
            [pc] = c.call_raw("save", "c", "gold").values()
            [pm] = c.call_raw("save", "m1", "gold").values()
            assert pc != pm and "_m1_gold" in pm and "_c_gold" in pc
            before = msgpack.packb(pack_of(port_srv.slot_for("m1")))
            default_before = msgpack.packb(pack_of(port_srv))
            assert c.call_raw("clear", "m1") is True
            assert msgpack.packb(pack_of(port_srv.slot_for("m1"))) != before
            assert msgpack.packb(pack_of(port_srv)) == default_before
            assert c.call_raw("load", "m1", "gold") is True
            assert msgpack.packb(pack_of(port_srv.slot_for("m1"))) == before
        # the JAX server's slot m1 loads the file the port's slot saved
        jslot = jax_srv.slot_for("m1")
        jpath = jslot._model_path("gold")
        with open(pm, "rb") as src, open(jpath, "wb") as dst:
            dst.write(src.read())
        assert jslot.load("gold") is True
        want = tables("classifier", pack_of(port_srv.slot_for("m1")))
        got = tables("classifier", pack_of(jslot))
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL)
    finally:
        stop_server("port", port_srv, prpc)
        stop_server("jax", jax_srv, jrpc_)


def test_per_slot_status_and_metrics_keys():
    srv, rpc, port = make_server("port", tenant="acme")
    try:
        srv.create_model({"name": "m1", "tenant": "t1",
                          "quota": {"train_rps": 50}})
        _train(port, "m1", 3)
        flush_all(srv)
        with Client("127.0.0.1", port, timeout=30) as c:
            st = list(c.call_raw("get_status", "c").values())[0]
            mx = list(c.call_raw("get_metrics", "c").values())[0]
        assert st["tenant"] == "acme" and st["tenant_slots"] == "2"
        assert st["slot.c.tenant"] == "acme"
        assert st["slot.m1.tenant"] == "t1"
        assert st["slot.m1.update_count"] == "10"
        assert st["slot.m1.quota"] == "max_rows=0,train_rps=50,query_rps=0"
        assert st["update_count"] == "0"
        assert mx["model_epoch.m1"] == "10" and mx["update_count.m1"] == "10"
        assert float(mx["tenant_slots"]) == 2.0
    finally:
        stop_server("port", srv, rpc)


def test_a_mutation_bumps_only_its_slots_epoch_and_cache():
    srv, rpc, port = make_server("port", query_cache_entries=64)
    try:
        srv.create_model({"name": "m1"})
        _train(port, "c", 0)
        _train(port, "m1", 1)
        flush_all(srv)
        with Client("127.0.0.1", port, timeout=30) as c:
            first = c.call_raw("classify", "c", [query("alpha", 0)])
            epoch_c, epoch_m1 = srv.model_epoch, srv.slot_for("m1").model_epoch
            hits = TMETRICS.counter("query_cache_hit_total")
            c.call_raw("train", "m1", batch("beta", 99))
            flush_all(srv)
            assert srv.slot_for("m1").model_epoch == epoch_m1 + 1
            assert srv.model_epoch == epoch_c
            # the default slot's cached answer is still served
            assert c.call_raw("classify", "c", [query("alpha", 0)]) == first
            assert TMETRICS.counter("query_cache_hit_total") == hits + 1
    finally:
        stop_server("port", srv, rpc)


# ---------------------------------------------------------------------------
# admission under traffic, quotas over the wire
# ---------------------------------------------------------------------------


def test_create_drop_invisible_to_other_slots_under_traffic():
    srv, rpc, port = make_server("port")
    errors = []
    stop = threading.Event()
    done = []

    def hammer(k):
        try:
            with Client("127.0.0.1", port, timeout=60) as c:
                i = 0
                while not stop.is_set():
                    c.call_raw("train", "c", batch(f"h{k}", i))
                    c.call_raw("classify", "c", [query(f"h{k}", i)])
                    i += 1
                done.append(i)
        except Exception as e:  # noqa: BLE001 - the assertion payload
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(k,)) for k in range(3)]
    try:
        for t in threads:
            t.start()
        with Client("127.0.0.1", port, timeout=60) as c:
            for r in range(4):
                assert c.call_raw("create_model", "c",
                                  {"name": f"eph{r}"}) is True
                c.call_raw("train", f"eph{r}", batch("e", r))
                assert c.call_raw("drop_model", "c", f"eph{r}") is True
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        flush_all(srv)
        trained = srv.update_count
        stop_server("port", srv, rpc)
    assert errors == []
    assert trained == sum(done) and set(srv.list_models()) == {"c"}


def _frozen(monkeypatch):
    frozen = FakeClock()
    for mod in QUOTAS.values():
        monkeypatch.setattr(mod, "time", frozen)


@pytest.mark.parametrize("what", ["train", "query"])
def test_rates_reject_as_jax_does(monkeypatch, what):
    """On a frozen quota clock a bucket admits exactly its one-second
    burst: both packages' servers admit and refuse the same calls, with
    the same message, and the other tenant's slot is untouched."""
    _frozen(monkeypatch)
    key = "train_rps" if what == "train" else "query_rps"
    seen = {}
    for p in ("jax", "port"):
        srv, rpc, port = make_server(p)
        try:
            srv.create_model({"name": "limited", "tenant": "t1",
                              "quota": {key: 3}})
            srv.create_model({"name": "free", "tenant": "t2"})
            out = []
            with Client("127.0.0.1", port, timeout=60) as c:
                for i in range(8):
                    try:
                        if what == "train":
                            c.call_raw("train", "limited", batch("x", i))
                        else:
                            c.call_raw("classify", "limited",
                                       [query("x", i)])
                        out.append("ok")
                    except RemoteError as e:
                        out.append(str(e))
                for i in range(8):
                    c.call_raw("train", "free", batch("y", i))
            flush_all(srv)
            assert srv.slot_for("free").update_count == 8
            seen[p] = out
        finally:
            stop_server(p, srv, rpc)
    assert seen["port"] == seen["jax"]
    assert seen["port"][:3] == ["ok"] * 3
    assert all("quota_exceeded" in o for o in seen["port"][3:])


def test_row_cap_rejects_as_jax_does(monkeypatch):
    for mod in (jregistry, tregistry):
        monkeypatch.setattr(mod, "_ROWS_TTL_S", -1.0)
    seen = {}
    datum = [[["k", "v"]], [["x", 1.0]], []]
    for p in ("jax", "port"):
        srv, rpc, port = make_server(p, cfg=RECO, type="recommender")
        try:
            srv.create_model({"name": "m1", "tenant": "t1",
                              "quota": {"max_rows": 4}})
            out = []
            with Client("127.0.0.1", port, timeout=60) as c:
                for i in range(6):
                    try:
                        c.call_raw("update_row", "m1", f"r{i}", datum)
                        out.append("ok")
                    except RemoteError as e:
                        out.append(str(e))
                c.call_raw("update_row", "c", "r-any", datum)
            seen[p] = (out, srv.slot_for("m1").slot_rows(), srv.slot_rows())
        finally:
            stop_server(p, srv, rpc)
    assert seen["port"] == seen["jax"]
    assert seen["port"][0][:4] == ["ok"] * 4
    assert "row limit" in seen["port"][0][4]


# ---------------------------------------------------------------------------
# a dropped slot gives its memory back
# ---------------------------------------------------------------------------


def test_a_dropped_slot_frees_its_driver_and_tensors():
    srv, rpc, port = make_server("port", query_cache_entries=16,
                                 read_batch_window_us=100)
    try:
        srv.create_model({"name": "m1"})
        _train(port, "m1", 2)
        with Client("127.0.0.1", port, timeout=30) as c:
            c.call_raw("classify", "m1", [query("beta", 0)])
        flush_all(srv)
        slot = srv.slot_for("m1")
        refs = [weakref.ref(slot), weakref.ref(slot.driver),
                weakref.ref(slot.driver.w), weakref.ref(slot.driver.cov)]
        del slot
        assert srv.drop_model("m1") is True
        gc.collect()
        assert [r() for r in refs] == [None] * len(refs)
        assert set(srv.list_models()) == {"c"}
    finally:
        stop_server("port", srv, rpc)
