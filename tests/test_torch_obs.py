"""The port's observability plane against the JAX package's, on the CPU:

- the metrics registry (jubatus_tpu_torch/utils/metrics.py): one seeded
  sequence of inc, inc_keyed past the series cap, set_gauge, observe and
  observe_value gives equal snapshot() maps, snapshot_raw() dumps,
  merge_hist_raw / summarize_hist_raw folds and render_prometheus text,
  bitwise;
- the tracer (obs/trace.py): the same nested spans, records, attached
  spans and tags give the same span dicts (names, tags, parent links
  across the ring, the ring's bound) and the same slow-op log payloads;
  disabled, both hand out no span;
- the exporter (obs/exporter.py) serves /metrics, /metrics.json,
  /traces.json and /livez on an ephemeral port, and answers /healthz and
  /fleet.json with 404 naming ROADMAP Queue 1 item 7.
"""

import json
import logging
import urllib.error
import urllib.request

import numpy as np
import pytest

from jubatus_tpu.obs import trace as jtrace
from jubatus_tpu.utils import metrics as jmetrics
from jubatus_tpu_torch.obs import trace as ttrace
from jubatus_tpu_torch.obs.exporter import MetricsExporter
from jubatus_tpu_torch.utils import metrics as tmetrics


def feed(mod, seed, cap=4):
    """One seeded sequence of registry calls on a fresh registry of `mod`."""
    rng = np.random.default_rng(seed)
    reg = mod.Registry(dynamic_series_cap=cap)
    for i in range(200):
        op = int(rng.integers(0, 6))
        if op == 0:
            reg.inc(f"c{int(rng.integers(0, 3))}_total",
                    float(rng.integers(1, 4)))
        elif op == 1:
            # past the cap: keys collapse into __overflow__ and count
            reg.inc_keyed("rpc_error_total", f"m{int(rng.integers(0, 9))}")
        elif op == 2:
            reg.inc(f"legacy_total.k{int(rng.integers(0, 7))}")
        elif op == 3:
            reg.set_gauge(f"g{int(rng.integers(0, 2))}",
                          float(rng.standard_normal()))
        elif op == 4:
            # times from a microsecond to minutes, the edges clamped
            reg.observe(f"rpc.m{int(rng.integers(0, 3))}",
                        float(10.0 ** rng.uniform(-7, 3)))
        else:
            reg.observe_value("batch.train.size",
                              float(rng.integers(1, 64)))
    reg.inc_keyed("rpc_error_total", "")       # the empty key's name
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshots_and_renderings_equal_jax(seed):
    j, t = feed(jmetrics, seed), feed(tmetrics, seed)
    assert t.snapshot() == j.snapshot()
    assert t.snapshot_raw() == j.snapshot_raw()
    assert t.counter(tmetrics.SERIES_DROPPED) == \
        j.counter(jmetrics.SERIES_DROPPED) > 0
    assert tmetrics.render_prometheus(t.snapshot()) == \
        jmetrics.render_prometheus(j.snapshot())
    flat = {**t.snapshot(), "routing": "partition", "x/y": "1.5"}
    assert tmetrics.render_prometheus(flat, prefix="p") == \
        jmetrics.render_prometheus(flat, prefix="p")


def test_merged_raw_histograms_equal_jax():
    raws_t = [feed(tmetrics, s).snapshot_raw() for s in (3, 4, 5)]
    raws_j = [feed(jmetrics, s).snapshot_raw() for s in (3, 4, 5)]
    for kind, timer in (("timers", True), ("values", False)):
        names = sorted(set().union(*(r[kind] for r in raws_t)))
        for name in names:
            mt = tmetrics.merge_hist_raw([r[kind].get(name, {})
                                          for r in raws_t])
            mj = jmetrics.merge_hist_raw([r[kind].get(name, {})
                                          for r in raws_j])
            assert mt == mj
            assert tmetrics.summarize_hist_raw(name, mt, timer) == \
                jmetrics.summarize_hist_raw(name, mj, timer)
            for q in (0.0, 0.5, 0.95, 0.99, 1.0):
                assert tmetrics.percentile_from_raw(
                    mt["count"], mt["buckets"], mt["max"], q) == \
                    jmetrics.percentile_from_raw(
                        mj["count"], mj["buckets"], mj["max"], q)


def test_device_telemetry_without_a_card_names_no_hbm():
    out = tmetrics.device_telemetry()
    assert "device_count" in out
    if out["device_count"] == 0:
        assert not any(k.startswith("hbm_") for k in out)


# -- the tracer ---------------------------------------------------------------

def drive(mod, ring):
    """One fixed sequence of span calls on a fresh tracer of `mod`."""
    tr = mod.Tracer()
    tr.configure(ring=ring, slow_op_ms=1e-6)
    with tr.span("rpc.train", model="m") as root:
        root.tag("stage.queue_wait_s", 0)
        with tr.span("train.step", n=4) as step:
            step.tag("lock_wait_s", 0)
            tr.tag_current("dispatch", True)
        tr.tag_current("stage.encode_s", 0)
    tr.record("mix.get_diff.leg", 0.25, peer="h:1", round=3, ok=True)
    detached = tr.start("rpc.classify")
    with tr.attach(detached):
        inner = tr.start("read.sweep.classify")
        inner.tag("n", 2)
        tr.finish(inner)
        tr.tag_current("cache", "miss")
    tr.finish(detached)
    with tr.span("mix.round") as sp:
        sp.tag("applied", 2)
        with tr.span("proxy.forward", method="train"):
            pass
    assert tr.current() is None
    return tr


def shape(spans):
    """Span dicts with ids replaced by ring positions (the ids carry a
    random process prefix) and times dropped."""
    pos = {s["span_id"]: i for i, s in enumerate(spans)}
    out = []
    for s in spans:
        out.append({"name": s["name"], "tags": s["tags"],
                    "parent": pos.get(s["parent_id"], s["parent_id"]
                                      and "outside the ring"),
                    "root": s["trace_id"] == s["span_id"],
                    "trace": pos.get(s["trace_id"], "outside the ring")})
    return out


@pytest.mark.parametrize("ring", [3, 64])
def test_tracer_span_dicts_equal_jax(ring, caplog):
    with caplog.at_level(logging.WARNING):
        j = drive(jtrace, ring)
        t = drive(ttrace, ring)
    js, ts = j.snapshot(), t.snapshot()
    assert len(ts) == len(js) == min(ring, 7)
    assert shape(ts) == shape(js)
    for s in ts:
        assert set(s) == {"name", "trace_id", "span_id", "parent_id", "ts",
                          "duration_s", "tags"}
    # the slow-op log: one line a finished ROOT span (the attached span's
    # child is not one; a record is never logged), the same payloads
    logs = {}
    for rec in caplog.records:
        if rec.name.endswith(".slowop"):
            payload = json.loads(rec.getMessage().split(" ", 1)[1])
            for k in ("ms", "trace_id", "span_id"):
                payload.pop(k)
            logs.setdefault(rec.name.split(".")[0], []).append(payload)
    assert logs["jubatus_tpu_torch"] == logs["jubatus_tpu"]
    assert [p["name"] for p in logs["jubatus_tpu"]] == \
        ["rpc.train", "rpc.classify", "mix.round"]


def test_disabled_tracers_hand_out_no_span():
    for mod in (jtrace, ttrace):
        tr = mod.Tracer()
        assert not tr.enabled and tr.start("x") is None
        with tr.span("x") as sp:
            assert sp is mod.NULL_SPAN and not sp
            sp.tag("k", 1)
        tr.record("y", 1.0)
        assert tr.snapshot() == [] and len(tr) == 0 and bool(tr)
        tr.configure(ring=2)
        tr.configure(ring=0, slow_op_ms=0)
        assert not tr.enabled


def test_trace_ids_follow_context_into_json_logs():
    """utils/logger.py's JsonFormatter names the active span's ids, as
    the JAX formatter does."""
    from jubatus_tpu.utils.logger import JsonFormatter as JFmt
    from jubatus_tpu_torch.utils.logger import JsonFormatter as TFmt
    rec = logging.LogRecord("x", logging.INFO, "f", 1, "hello %s", ("w",),
                            None)
    outs = []
    for mod, fmt in ((jtrace, JFmt()), (ttrace, TFmt())):
        was = (mod.TRACER.ring_size, mod.TRACER.slow_op_s)
        mod.TRACER.configure(ring=4)
        try:
            with mod.TRACER.span("rpc.x") as sp:
                out = json.loads(fmt.format(rec))
                assert (out["trace_id"], out["span_id"]) == \
                    (sp.trace_id, sp.span_id)
        finally:
            mod.TRACER.configure(ring=was[0], slow_op_ms=was[1] * 1e3)
        outs.append(sorted(out))
    assert outs[0] == outs[1]


# -- the exporter ---------------------------------------------------------------

def get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_exporter_endpoints_answer_on_an_ephemeral_port():
    reg = feed(tmetrics, 9)
    tr = drive(ttrace, 16)
    exp = MetricsExporter(collect=reg.snapshot, tracer=tr, ident="n1",
                          host="127.0.0.1")
    port = exp.start(0)
    try:
        assert port > 0
        code, body = get(port, "/metrics")
        assert code == 200
        assert body == tmetrics.render_prometheus(reg.snapshot())
        assert body == jmetrics.render_prometheus(reg.snapshot())
        code, body = get(port, "/metrics.json")
        assert code == 200 and json.loads(body) == {
            "ident": "n1", "metrics": reg.snapshot()}
        code, body = get(port, "/traces.json?x=1")
        assert code == 200
        assert json.loads(body)["spans"] == tr.snapshot()
        assert get(port, "/livez") == (200, "ok\n")
        for path in ("/healthz", "/fleet.json"):
            code, body = get(port, path)
            assert code == 404 and "ROADMAP Queue 1 item 7" in body
        assert get(port, "/nope")[0] == 404
    finally:
        exp.stop()
