"""A two-replica MIX round in each package, f32 (v2) and blockwise-int8
(v3) wire: get_diff -> encode_wire_diff -> wire -> decode -> mix ->
encode_wire_diff -> wire -> decode -> put_diff on both replicas.

Within a package the replicas end bitwise equal, and label counts are
exact.  Across packages the f32 round agrees within rtol 1e-5 / atol 1e-6
(sums in another order).  The int8 round amplifies those last-bit
differences into at most one quantization step per event, so across
packages it agrees within the round's accumulated quantization bound, the
same bound tests/test_mix_quantized.py holds the JAX round to.
"""

import numpy as np
import pytest

from jubatus_tpu.mix import codec as jcodec
from jubatus_tpu.mix.linear_mixer import encode_wire_diff as jencode
from jubatus_tpu.models.classifier import ClassifierDriver as JDriver
from jubatus_tpu_torch.mix import codec as tcodec
from jubatus_tpu_torch.mix.linear_mixer import encode_wire_diff as tencode
from jubatus_tpu_torch.models.classifier import ClassifierDriver as TDriver
from tests.test_torch_classifier import (ATOL, RTOL, config, jdata, stream,
                                         tdata)


def halves(seed):
    rng = np.random.default_rng(seed)
    return [stream(rng, 48, n_labels=4), stream(rng, 48, n_labels=6)]


def jax_round(method, quantize, seed=1):
    drivers = [JDriver(config(method)) for _ in range(2)]
    for d, half in zip(drivers, halves(seed)):
        d.train(jdata(half))

    def wire(diff):
        return jcodec.decode(jcodec.unpackb(jcodec.packb(
            jencode(diff, quantize))))

    diffs = [wire(d.encode_diff(d.get_diff())) for d in drivers]
    merged = wire(JDriver.mix(diffs[0], diffs[1]))
    for d in drivers:
        d.put_diff(merged)
    return drivers


def torch_round(method, quantize, seed=1, stats=None):
    drivers = [TDriver(config(method), device="cpu") for _ in range(2)]
    for d, half in zip(drivers, halves(seed)):
        d.train(tdata(half))

    def wire(diff):
        return tcodec.decode(tcodec.unpackb(tcodec.packb(
            tencode(diff, quantize, "cpu", stats))), "cpu")

    diffs = [wire(d.encode_diff(d.get_diff())) for d in drivers]
    merged = wire(TDriver.mix(diffs[0], diffs[1]))
    for d in drivers:
        d.put_diff(merged)
    return drivers


def by_label(d, name):
    """{label: row} of a table, as numpy; row numbering is per replica."""
    t = np.asarray(getattr(d, name))
    return {lbl: t[row] for lbl, row in d.labels.items()}


def tables(d):
    return ("w", "cov") if d.method in ("CW", "AROW", "NHERD") else ("w",)


def assert_replicas_bitwise_equal(drivers):
    a, b = drivers
    assert a.get_labels() == b.get_labels()
    for name in tables(a):
        ta, tb = by_label(a, name), by_label(b, name)
        assert sorted(ta) == sorted(tb)
        for lbl in ta:
            np.testing.assert_array_equal(ta[lbl], tb[lbl])


@pytest.mark.parametrize("method", ["AROW", "PA1", "CW"])
@pytest.mark.parametrize("quantize", [False, True])
def test_replicas_bitwise_equal_in_each_package(method, quantize):
    assert_replicas_bitwise_equal(jax_round(method, quantize))
    assert_replicas_bitwise_equal(torch_round(method, quantize))


@pytest.mark.parametrize("method", ["AROW", "PA1", "NHERD"])
def test_f32_round_matches_jax(method):
    jd, td = jax_round(method, False)[0], torch_round(method, False)[0]
    assert td.get_labels() == jd.get_labels()
    for name in tables(td):
        tj, tt = by_label(jd, name), by_label(td, name)
        for lbl in tj:
            np.testing.assert_allclose(tt[lbl], tj[lbl], rtol=RTOL,
                                       atol=ATOL)


@pytest.mark.parametrize("method", ["AROW", "PA1"])
def test_int8_round_matches_jax_within_the_quantization_bound(method):
    stats = {}
    td = torch_round(method, True, stats=stats)[0]
    jd = jax_round(method, True)[0]
    assert td.get_labels() == jd.get_labels()
    eps = 2 * stats["max_abs_err"] + ATOL
    for name in tables(td):
        tj, tt = by_label(jd, name), by_label(td, name)
        for lbl in tj:
            assert np.abs(tt[lbl] - tj[lbl]).max() <= eps


@pytest.mark.parametrize("method", ["AROW", "CW"])
def test_int8_round_drift_from_f32_is_bounded(method):
    """Every element moved at most the accumulated roundtrip error of
    the round's quantization events, and label counts stay exact."""
    stats = {}
    quant = torch_round(method, True, stats=stats)
    exact = torch_round(method, False)
    assert stats["raw"] / stats["wire"] > 3.5
    for q, e in zip(quant, exact):
        assert q.get_labels() == e.get_labels()
        drift = max(np.abs(by_label(q, n)[lbl] - by_label(e, n)[lbl]).max()
                    for n in tables(q) for lbl in q.labels)
        assert 0.0 < drift <= stats["max_abs_err"] + 1e-6


def test_second_round_is_idempotent():
    drivers = torch_round("AROW", True)
    before = [{n: by_label(d, n) for n in ("w", "cov")} for d in drivers]
    diffs = [d.get_diff() for d in drivers]
    assert all(np.asarray(x["cols"]).size == 0 for x in diffs)
    merged = TDriver.mix(diffs[0], diffs[1])
    for d in drivers:
        d.put_diff(merged)
    for d, b in zip(drivers, before):
        for n in ("w", "cov"):
            for lbl, row in by_label(d, n).items():
                np.testing.assert_array_equal(row, b[n][lbl])


def test_mix_with_a_dense_diff_matches_jax():
    """A column-sparse diff mixed with a dense one is promoted to full
    width in both packages."""
    jd = JDriver(config("AROW"))
    td = TDriver(config("AROW"), device="cpu")
    recs = stream(np.random.default_rng(4), 30)
    jd.train(jdata(recs))
    td.train(tdata(recs))
    sj, st = jd.get_diff(), td.get_diff()
    dense = {"labels": ["c0", "zz"], "cols": None, "dim": 1 << 12,
             "w": np.full((2, 1 << 12), 0.25, np.float32),
             "cov": np.full((2, 1 << 12), -0.5, np.float32),
             "counts": np.array([1, 2], np.int32), "k": 1,
             "weights": {"cols": np.zeros(0, np.int32),
                         "vals": np.zeros(0, np.int32), "doc_count": 0}}
    mj, mt = JDriver.mix(sj, dense), TDriver.mix(st, dense)
    assert mt["labels"] == mj["labels"] and mt["cols"] is None
    np.testing.assert_array_equal(mt["counts"], mj["counts"])
    for name in ("w", "cov"):
        np.testing.assert_allclose(mt[name], mj[name], rtol=RTOL, atol=ATOL)
    jd.put_diff(mj)
    td.put_diff(mt)
    assert td.get_labels() == jd.get_labels()
    np.testing.assert_allclose(td.w.numpy(), np.asarray(jd.w), rtol=RTOL,
                               atol=ATOL)
