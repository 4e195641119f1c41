"""The port's NN classifier (jubatus_tpu_torch/models/classifier.py
NNClassifierDriver, method "NN", on the CPU through the plain K1/K2 and
K3) against the JAX package's: after the same trains (row ids from a
seeded uuid4 in both packages), classify answers bitwise (labels and
vote scores) for lsh, minhash and euclid_lsh; set_label, delete_label,
MIX and model files cross packages; the classifier factory builds the NN
driver for method "NN"."""

import uuid

import msgpack
import numpy as np
import pytest
import torch

from jubatus_tpu.fv import Datum as JDatum
from jubatus_tpu.mix import codec as jcodec
from jubatus_tpu.models.base import create_driver as jcreate
from jubatus_tpu_torch.fv import Datum as TDatum
from jubatus_tpu_torch.mix import codec as tcodec
from jubatus_tpu_torch.models import create_driver as tcreate
from jubatus_tpu_torch.models.classifier import NNClassifierDriver
from tests.test_torch_recommender import wire

torch.set_num_threads(1)


def config(method="euclid_lsh", hash_num=64, k=16):
    return {"method": "NN",
            "parameter": {"method": method,
                          "parameter": {"hash_num": hash_num},
                          "nearest_neighbor_num": k,
                          "local_sensitivity": 0.5},
            "converter": {"num_rules": [{"key": "*", "type": "num"}],
                          "hash_max_size": 1 << 11}}


@pytest.fixture
def seeded_uuid(monkeypatch):
    """uuid4 from a seeded sequence; reset(seed) restarts it."""
    state = {}

    def reset(seed):
        state["rng"] = np.random.default_rng(seed)

    def fake():
        return uuid.UUID(int=int(state["rng"].integers(0, 2 ** 63)) << 64
                         | int(state["rng"].integers(0, 2 ** 63)))

    reset(0)
    monkeypatch.setattr(uuid, "uuid4", fake)
    return reset


def batch(seed, n, labels=("a", "b", "c")):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ks = rng.choice(300, int(rng.integers(2, 12)), replace=False)
        nums = [(f"f{k}", float(v)) for k, v in
                zip(ks, rng.standard_normal(len(ks)))]
        out.append((labels[int(rng.integers(0, len(labels)))], nums))
    return out


def trained(cfg, seeded_uuid, rounds=3, n=40, first=0):
    j, t = jcreate("classifier", cfg), tcreate("classifier", cfg, "cpu")
    for r in range(first, first + rounds):
        data = batch(r, n)
        seeded_uuid(r)
        j.train([(lbl, JDatum(num_values=x)) for lbl, x in data])
        seeded_uuid(r)
        t.train([(lbl, TDatum(num_values=x)) for lbl, x in data])
    return j, t


def classify_both(j, t, seed, n=9):
    qs = batch(seed, n)
    a = j.classify([JDatum(num_values=x) for _, x in qs])
    b = t.classify([TDatum(num_values=x) for _, x in qs])
    return a, b


@pytest.mark.parametrize("method", ("lsh", "minhash", "euclid_lsh"))
def test_classify_is_bitwise_after_the_same_trains(method, seeded_uuid):
    j, t = trained(config(method), seeded_uuid)
    assert isinstance(t, NNClassifierDriver)
    assert j.row_labels == t.row_labels
    a, b = classify_both(j, t, seed=99)
    assert a == b
    assert j.get_labels() == t.get_labels()
    assert j.get_status() | {"query_tier": ""} == \
        t.get_status() | {"query_tier": ""}
    groups = [[TDatum(num_values=x) for _, x in batch(s, 3)]
              for s in (5, 6)]
    jgroups = [[JDatum(num_values=x) for _, x in batch(s, 3)]
               for s in (5, 6)]
    assert j.classify_many(jgroups) == t.classify_many(groups)


def test_the_default_k_reads_at_kb_128(seeded_uuid):
    """k 128 (the default) over 200 rows: one sweep with kb 128."""
    cfg = config("euclid_lsh", k=128)
    del cfg["parameter"]["nearest_neighbor_num"]
    j, t = trained(cfg, seeded_uuid, rounds=5)
    a, b = classify_both(j, t, seed=7, n=17)
    assert a == b


def test_labels_mix_and_model_files_cross_packages(seeded_uuid):
    cfg = config("lsh")
    j, t = trained(cfg, seeded_uuid)
    assert j.set_label("z") == t.set_label("z")
    assert j.delete_label("c") == t.delete_label("c")
    a, b = classify_both(j, t, seed=3)
    assert a == b
    pj = msgpack.packb(j.pack(), use_bin_type=True)
    assert pj == msgpack.packb(t.pack(), use_bin_type=True)
    t2 = tcreate("classifier", cfg, "cpu")
    t2.unpack(msgpack.unpackb(pj, raw=False, strict_map_key=False))
    assert classify_both(j, t2, seed=3)[1] == a
    # MIX: a JAX replica's and a port replica's diffs, folded both ways
    ja, _ = trained(cfg, seeded_uuid, rounds=1, first=10)
    _, tb = trained(cfg, seeded_uuid, rounds=1, first=20)
    dj, dt = ja.get_diff(), tb.get_diff()
    ja.put_diff(type(ja).mix(wire(dj, jcodec, jcodec),
                             wire(dt, tcodec, jcodec)))
    tb.put_diff(type(tb).mix(wire(dj, jcodec, tcodec),
                             wire(dt, tcodec, tcodec)))
    assert ja.row_labels == tb.row_labels and len(tb.row_labels) == 80
    assert ja.get_labels() == tb.get_labels()
