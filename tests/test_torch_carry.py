"""State carried across the two packages: a JAX-trained classifier's
tables installed in the port (models/carry.py) classify the same, the
port's exported state installs back into the JAX driver, and a model file
saved by either package loads in the other (framework/save_load.py)."""

import io
import json

import numpy as np
import pytest

from jubatus_tpu.framework import save_load as jsave
from jubatus_tpu.fv import Datum as JDatum
from jubatus_tpu.models.classifier import ClassifierDriver as JDriver
from jubatus_tpu_torch.framework import save_load as tsave
from jubatus_tpu_torch.fv import Datum as TDatum
from jubatus_tpu_torch.models.carry import (export_reference_state,
                                            load_reference_state)
from jubatus_tpu_torch.models.classifier import ClassifierDriver as TDriver
from tests.test_torch_classifier import (ATOL, RTOL, assert_same_classify,
                                         config, jdata, stream, tdata)

METHODS = ("AROW", "PA2", "NHERD", "cosine")


def jax_state(jd):
    wm = jd.converter.weights
    out = {"w": np.asarray(jd.w), "counts": np.asarray(jd.counts),
           "active": np.asarray(jd.active), "labels": dict(jd.labels),
           "weights": {"df": wm.df, "doc_count": wm.doc_count,
                       "user_weights": wm.user_weights}}
    if jd.method in ("CW", "AROW", "NHERD"):
        out["cov"] = np.asarray(jd.cov)
    return out


def queries(seed=5, n=8):
    recs = stream(np.random.default_rng(seed), n)
    return ([JDatum(s, v) for _, s, v in recs],
            [TDatum(s, v) for _, s, v in recs])


def jax_trained(method, n=60, n_labels=11):
    jd = JDriver(config(method))
    jd.train(jdata(stream(np.random.default_rng(3), n, n_labels=n_labels)))
    return jd


@pytest.mark.parametrize("method", METHODS)
def test_jax_state_loads_into_the_port(method):
    jd = jax_trained(method)
    td = TDriver(config(method), device="cpu")
    load_reference_state(td, jax_state(jd))
    assert td.labels == jd.labels and td.capacity == jd.capacity
    assert td.get_labels() == jd.get_labels()
    qj, qt = queries()
    assert_same_classify(jd.classify(qj), td.classify(qt))
    # and it keeps training like the JAX driver
    more = stream(np.random.default_rng(9), 20, n_labels=11)
    jd.train(jdata(more))
    td.train(tdata(more))
    assert_same_classify(jd.classify(qj), td.classify(qt))


@pytest.mark.parametrize("method", METHODS)
def test_port_state_exports_into_the_jax_driver(method):
    td = TDriver(config(method), device="cpu")
    td.train(tdata(stream(np.random.default_rng(4), 50)))
    st = export_reference_state(td)
    np.testing.assert_array_equal(st["w"], td.w.numpy())
    jd = JDriver(config(method))
    obj = {"labels": st["labels"], "capacity": st["w"].shape[0],
           "w": st["w"].tobytes(), "counts": st["counts"].tobytes(),
           "active": st["active"].tobytes(),
           "weights": {k: (v.tobytes() if isinstance(v, np.ndarray) else v)
                       for k, v in st["weights"].items()}}
    if "cov" in st:
        obj["cov"] = st["cov"].tobytes()
    jd.unpack(obj)
    qj, qt = queries()
    assert_same_classify(jd.classify(qj), td.classify(qt))


def test_load_reference_state_rejects_a_foreign_width():
    td = TDriver(config("AROW"), device="cpu")
    st = jax_state(jax_trained("AROW"))
    st["w"] = st["w"][:, :100]
    with pytest.raises(ValueError):
        load_reference_state(td, st)


def _save(mod, driver, cfg):
    buf = io.BytesIO()
    mod.save_model(buf, server_type="classifier", model_id="m",
                   config=json.dumps(cfg), user_data_version=1,
                   driver_data=driver.pack())
    return buf.getvalue()


def _load(mod, raw, cfg):
    return mod.load_model(io.BytesIO(raw), server_type="classifier",
                          expected_config=json.dumps(cfg),
                          user_data_version=1)


@pytest.mark.parametrize("method", ("AROW", "PA1", "euclidean"))
def test_model_files_cross_packages(method):
    cfg = config(method)
    jd = jax_trained(method)
    td = TDriver(cfg, device="cpu")
    td.unpack(_load(tsave, _save(jsave, jd, cfg), cfg))
    qj, qt = queries()
    assert_same_classify(jd.classify(qj), td.classify(qt))

    td.train(tdata(stream(np.random.default_rng(7), 30, n_labels=11)))
    jd2 = JDriver(cfg)
    jd2.unpack(_load(jsave, _save(tsave, td, cfg), cfg))
    assert jd2.get_labels() == td.get_labels()
    assert_same_classify(jd2.classify(qj), td.classify(qt))
    np.testing.assert_allclose(np.asarray(jd2.w), td.w.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_model_file_header_is_the_reference_format():
    """Apart from the timestamp in the system block, a file's bytes do
    not depend on which package wrote it."""
    cfg = config("AROW")
    td = TDriver(cfg, device="cpu")
    raw = _save(tsave, td, cfg)
    assert raw[:8] == b"jubatus\0"
    with pytest.raises(tsave.ModelFileError):
        _load(tsave, raw[:40], cfg)
    with pytest.raises(tsave.ModelFileError):
        _load(tsave, raw, config("PA"))
    bad = bytearray(raw)
    bad[-1] ^= 0xFF
    with pytest.raises(tsave.ModelFileError):
        _load(tsave, bytes(bad), cfg)
