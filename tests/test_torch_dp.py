"""The port's data-parallel drivers (jubatus_tpu_torch/parallel/dp.py)
against the JAX package's (jubatus_tpu/parallel/dp.py) on the CPU, JAX on
the suite's 8-device virtual mesh, both fed the same seeded streams.

Integer state (counts, active, labels) is bitwise; the float tables agree
within rtol 1e-5 / atol 1e-6, the tolerance of the single-replica drivers'
tests: the sequential scan's plain version sums as XLA does up to the
order of a few reductions (tests/test_torch_classifier.py).  The collective
fold itself is bitwise (tests/test_torch_collective.py): started from the
same diverged replicas (models/carry.py), one device_mix gives the JAX
driver's bits, f32 and int8.
"""

import numpy as np
import pytest
import torch
from jubatus_tpu.fv import Datum as JDatum
from jubatus_tpu.parallel import make_mesh as jmesh
from jubatus_tpu.parallel import dp as jdp
from jubatus_tpu_torch import native as tnative
from jubatus_tpu_torch.fv import Datum as TDatum
from jubatus_tpu_torch.models.carry import (export_reference_state,
                                            load_reference_state)
from jubatus_tpu_torch.parallel import dp as tdp
from jubatus_tpu_torch.parallel.mesh import (make_mesh as tmesh,
                                             resolve_replicas)

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
CONV = {"string_rules": [{"key": "*", "type": "str", "sample_weight": "bin",
                          "global_weight": "bin"}],
        "num_rules": [{"key": "*", "type": "num"}],
        "hash_max_size": 1 << 10}


def cls_config(method, mode="sequential", payload="f32"):
    return {"method": method,
            "parameter": {"regularization_weight": 0.5, "microbatch": mode,
                          "mix_payload": payload},
            "converter": CONV}


def reg_config(method="PA", payload="f32"):
    return {"method": method,
            "parameter": {"sensitivity": 0.1, "regularization_weight": 1.0,
                          "mix_payload": payload},
            "converter": CONV}


def cls_stream(rng, n, n_labels=4):
    out = []
    for i in range(n):
        s = [(f"w{t % 3}", f"tok{t}") for t in rng.integers(0, 60, 4)]
        out.append((f"c{int(rng.integers(n_labels))}", s,
                    [("x", float(rng.random()))]))
    return out


def reg_stream(rng, n):
    out = []
    for _ in range(n):
        toks = rng.integers(0, 60, 4)
        x = float(rng.random())
        y = 3.0 * x + (2.0 if toks[0] % 2 else -2.0)
        out.append((y, [(f"w{t % 3}", f"tok{t}") for t in toks],
                    [("x", x)]))
    return out


def data(Datum, records):
    return [(y, Datum(list(s), list(n))) for y, s, n in records]


def datums(Datum, records):
    return [Datum(list(s), list(n)) for _, s, n in records]


def pair(service, config, ndp):
    if service == "classifier":
        return (jdp.DPClassifierDriver(config, jmesh(dp=ndp, shard=1)),
                tdp.DPClassifierDriver(config, tmesh(dp=ndp, device="cpu")))
    return (jdp.DPRegressionDriver(config, jmesh(dp=ndp, shard=1)),
            tdp.DPRegressionDriver(config, tmesh(dp=ndp, device="cpu")))


def same_stacked(jd, td, bases=True):
    """The stacked state: integers bitwise, floats within tolerance."""
    names = ["w"] + (["w_dbase"] if bases else [])
    if hasattr(td, "counts"):
        assert dict(jd.labels) == dict(td.labels)
        np.testing.assert_array_equal(td.counts.numpy(),
                                      np.asarray(jd.counts))
        np.testing.assert_array_equal(td.active.numpy(),
                                      np.asarray(jd.active))
        if bases:
            np.testing.assert_array_equal(td.counts_dbase.numpy(),
                                          np.asarray(jd.counts_dbase))
        if td.method in ("CW", "AROW", "NHERD"):
            names += ["cov"] + (["cov_dbase"] if bases else [])
    for name in names:
        np.testing.assert_allclose(getattr(td, name).numpy(),
                                   np.asarray(getattr(jd, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


# -- the replica layout -----------------------------------------------------------

def test_dp_replicas_resolve_as_the_jax_server_does():
    assert resolve_replicas("dp_replicas", 0, "cpu") == 1
    assert resolve_replicas("dp_replicas", 4, "cpu") == 4
    # above the device count: stacked on the one device, not refused
    assert tmesh(dp=8, device="cpu").shape == {"dp": 8, "shard": 1}
    with pytest.raises(ValueError, match="--dp_replicas must be >= 0, got -1"):
        resolve_replicas("dp_replicas", -1, "cpu")
    # a (dp, shard) grid: JAX's mutual-exclusion message
    with pytest.raises(ValueError, match="--dp_replicas and --shard_devices "
                       "are mutually exclusive"):
        tmesh(dp=2, shard=2, device="cpu")


def test_dp_clustering_names_its_item():
    with pytest.raises(ValueError, match="item 7.1"):
        tdp.create_dp_driver("clustering", {}, tmesh(dp=2, device="cpu"))
    with pytest.raises(ValueError, match="no data-parallel driver"):
        tdp.create_dp_driver("recommender", {}, tmesh(dp=2, device="cpu"))


# -- train, fold, read --------------------------------------------------------------

@pytest.mark.parametrize("ndp", [2, 4, 8])
@pytest.mark.parametrize("mode", ["sequential", "parallel"])
@pytest.mark.parametrize("method", ["PA", "AROW", "CW"])
def test_classifier_train_fold_and_classify_match_jax(method, mode, ndp):
    rng = np.random.default_rng(ndp * 7 + len(method))
    jd, td = pair("classifier", cls_config(method, mode), ndp)
    for n in (13, 6, 1):
        recs = cls_stream(rng, n)
        assert jd.train(data(JDatum, recs)) == td.train(data(TDatum, recs))
    same_stacked(jd, td)
    assert td.get_status()["dp_replicas"] == str(ndp)
    assert td.get_status()["updates_since_device_mix"] == "20" == \
        jd.get_status()["updates_since_device_mix"]
    q = cls_stream(rng, 5)
    for jrow, trow in zip(jd.classify(datums(JDatum, q)),
                          td.classify(datums(TDatum, q))):
        assert [l for l, _ in jrow] == [l for l, _ in trow]
        np.testing.assert_allclose([s for _, s in trow], [s for _, s in jrow],
                                   rtol=RTOL, atol=ATOL)
    jd.device_mix()
    td.device_mix()
    same_stacked(jd, td)
    assert td.get_labels() == jd.get_labels()
    assert td.get_status()["updates_since_device_mix"] == "0"


@pytest.mark.parametrize("payload", ["f32", "int8"])
@pytest.mark.parametrize("ndp", [2, 4, 8])
def test_fold_from_the_same_diverged_replicas_is_bitwise(ndp, payload):
    """Both drivers start from the same diverged replicas and bases
    (models/carry.py); one device_mix gives the JAX driver's bits."""
    rng = np.random.default_rng(ndp)
    jd, td = pair("classifier", cls_config("AROW", payload=payload), ndp)
    jd.train(data(JDatum, cls_stream(rng, 8 * ndp)))
    L, D = jd.capacity, jd.dim
    arrays = {"labels": dict(jd.labels),
              "w": rng.standard_normal((ndp, L, D)).astype(np.float32),
              "w_dbase": np.repeat(rng.standard_normal((1, L, D)).astype(
                  np.float32), ndp, 0),
              "cov": (1 + rng.random((ndp, L, D))).astype(np.float32),
              "cov_dbase": np.ones((ndp, L, D), np.float32),
              "counts": rng.integers(0, 40, (ndp, L)).astype(np.int32),
              "counts_dbase": np.repeat(rng.integers(0, 5, (1, L)).astype(
                  np.int32), ndp, 0),
              "active": rng.random((ndp, L)) > 0.3,
              "weights": jd.converter.weights.pack()}
    load_reference_state(td, arrays)
    out = export_reference_state(td)
    for k in ("w", "w_dbase", "cov", "cov_dbase", "counts", "counts_dbase",
              "active"):
        np.testing.assert_array_equal(out[k], arrays[k])
    import jax.numpy as jnp
    for k in ("w", "w_dbase", "cov", "cov_dbase", "counts", "counts_dbase",
              "active"):
        setattr(jd, k, jnp.asarray(arrays[k]))
    jd.device_mix()
    td.device_mix()
    for k in ("w", "cov", "counts", "active", "w_dbase", "cov_dbase",
              "counts_dbase"):
        np.testing.assert_array_equal(getattr(td, k).numpy(),
                                      np.asarray(getattr(jd, k)), err_msg=k)


@pytest.mark.parametrize("payload", ["f32", "int8"])
@pytest.mark.parametrize("ndp", [2, 4, 8])
@pytest.mark.parametrize("method", ["PA", "PA1"])
def test_regression_train_fold_and_estimate_match_jax(method, ndp, payload):
    rng = np.random.default_rng(ndp + 3)
    jd, td = pair("regression", reg_config(method, payload), ndp)
    for n in (11, 5):
        recs = reg_stream(rng, n)
        assert jd.train(data(JDatum, recs)) == td.train(data(TDatum, recs))
    same_stacked(jd, td)
    q = reg_stream(rng, 6)
    np.testing.assert_allclose(td.estimate(datums(TDatum, q)),
                               jd.estimate(datums(JDatum, q)),
                               rtol=RTOL, atol=ATOL)
    jd.device_mix()
    td.device_mix()
    same_stacked(jd, td)
    assert td.get_status()["dp_replicas"] == jd.get_status()["dp_replicas"]
    assert td.num_trained == jd.num_trained == 16


# -- the raw ingest path: batches that do not divide -----------------------------

def raw_frames(service, seed, sizes):
    import msgpack
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(sizes):
        recs = cls_stream(rng, n) if service == "classifier" \
            else reg_stream(rng, n)
        rows = [[y, [[list(p) for p in s], [list(p) for p in nn], []]]
                for y, s, nn in recs]
        msg = msgpack.packb([0, i, "train", ["", rows]], use_bin_type=True)
        out.append((msg, tnative.load().parse_envelope(msg, 0)[4]))
    return out


@pytest.mark.parametrize("ndp", [3, 4, 5])
@pytest.mark.parametrize("service", ["classifier", "regression"])
def test_raw_windows_repad_to_the_replicas(service, ndp):
    """A fused window of raw frames whose rows do not divide the replicas
    is re-padded (masked zero rows), as JAX's _repad_raw does."""
    cfg = cls_config("AROW") if service == "classifier" else reg_config()
    jd, td = pair(service, cfg, ndp)
    for sizes in ((5, 2), (9,), (1, 1, 1)):
        frames = raw_frames(service, ndp + len(sizes), sizes)
        assert jd.train_converted_batch(jd.convert_raw_batch(frames)) == \
            td.train_converted_batch(td.convert_raw_batch(frames))
    same_stacked(jd, td)


# -- labels -----------------------------------------------------------------------

@pytest.mark.parametrize("ndp", [2, 4])
def test_set_and_delete_label_in_every_replica(ndp):
    rng = np.random.default_rng(5)
    jd, td = pair("classifier", cls_config("AROW"), ndp)
    recs = cls_stream(rng, 12)
    jd.train(data(JDatum, recs))
    td.train(data(TDatum, recs))
    for d in (jd, td):
        assert d.set_label("fresh") and not d.set_label("fresh")
        assert d.delete_label("c1") and not d.delete_label("c1")
    same_stacked(jd, td)
    assert td.get_labels() == jd.get_labels()
    recs = cls_stream(rng, 6)
    jd.train(data(JDatum, recs))
    td.train(data(TDatum, recs))
    same_stacked(jd, td)


# -- the cross-process MIX on replica 0 -----------------------------------------

def diff_close(jdiff, tdiff):
    assert list(jdiff) == list(tdiff)
    for k, v in jdiff.items():
        if k == "weights":
            continue
        if isinstance(v, np.ndarray) and v.dtype.kind == "f":
            np.testing.assert_allclose(tdiff[k], v, rtol=RTOL, atol=ATOL)
        elif isinstance(v, np.ndarray):
            np.testing.assert_array_equal(tdiff[k], v)
        else:
            assert tdiff[k] == v


@pytest.mark.parametrize("sparse", [True, False], ids=["col_sparse", "dense"])
@pytest.mark.parametrize("ndp", [2, 4, 8])
@pytest.mark.parametrize("service", ["classifier", "regression"])
def test_get_diff_and_put_diff_on_replica_zero(service, ndp, sparse):
    rng = np.random.default_rng(ndp * 11)
    cfg = cls_config("AROW") if service == "classifier" else reg_config()
    make = cls_stream if service == "classifier" else reg_stream
    jd, td = pair(service, cfg, ndp)
    jpeer, tpeer = pair(service, cfg, ndp)
    recs, precs = make(rng, 10), make(rng, 7)
    jd.train(data(JDatum, recs))
    td.train(data(TDatum, recs))
    jpeer.train(data(JDatum, precs))
    tpeer.train(data(TDatum, precs))
    jdiff = jd.encode_diff(jd.get_diff_snapshot())
    tdiff = td.encode_diff(td.get_diff_snapshot())
    diff_close(jdiff, tdiff)
    jm = type(jd).mix(jdiff, jpeer.encode_diff(jpeer.get_diff_snapshot()))
    tm = type(td).mix(tdiff, tpeer.encode_diff(tpeer.get_diff_snapshot()))
    if not sparse:
        jm = type(jd)._to_dense_diff(jm) if service == "classifier" else \
            dict(jm, cols=None, w=type(jd)._to_dense_w(jm, jd.dim))
        tm = type(td)._to_dense_diff(tm) if service == "classifier" else \
            dict(tm, cols=None, w=type(td)._to_dense_w(tm))
    # trains land between the snapshot and the fold
    more = make(rng, 4)
    jd.train(data(JDatum, more))
    td.train(data(TDatum, more))
    assert jd.put_diff(jm) and td.put_diff(tm)
    same_stacked(jd, td)
    if service == "classifier":
        assert td.get_labels() == jd.get_labels()


# -- persistence --------------------------------------------------------------------

@pytest.mark.parametrize("ndp", [2, 4])
@pytest.mark.parametrize("service", ["classifier", "regression"])
def test_pack_folds_then_unpack_replicates(service, ndp):
    rng = np.random.default_rng(ndp + 40)
    cfg = cls_config("CW") if service == "classifier" else reg_config("PA2")
    make = cls_stream if service == "classifier" else reg_stream
    jd, td = pair(service, cfg, ndp)
    recs = make(rng, 14)
    jd.train(data(JDatum, recs))
    td.train(data(TDatum, recs))
    jp, tp = jd.pack(), td.pack()
    assert list(jp) == list(tp)
    for k, v in jp.items():
        if k == "w" or k == "cov":
            np.testing.assert_allclose(np.frombuffer(tp[k], np.float32),
                                       np.frombuffer(v, np.float32),
                                       rtol=RTOL, atol=ATOL)
        elif k != "weights":
            assert tp[k] == v, k
    # a plain (single-replica) driver's model file: the port loads it
    fresh = pair(service, cfg, ndp)[1]
    fresh.unpack(tp)
    for r in range(ndp):
        assert torch.equal(fresh.w[r], td.w[0])
    assert fresh.pack()["w"] == tp["w"]
