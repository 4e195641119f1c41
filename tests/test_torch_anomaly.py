"""The port's anomaly driver (jubatus_tpu_torch/models/anomaly.py on the
CPU, through the plain versions of K1, K2, K4 dense_dots and K5) against
the JAX package's: lof and light_lof over the exact methods
(inverted_index, inverted_index_euclid, euclid) and the signature methods
(lsh, minhash, euclid_lsh), after the same seeded history of add, update,
overwrite, clear_row and LRU evictions: bitwise scores (add's and
calc_score(_many)'s), bitwise kNN tables (rows, distances, k-distances,
lrd), model files and MIX diffs across packages.  Small sizes:
hash_max_size 2^10-2^12, a few hundred rows, H 64 and 128.
"""

import msgpack
import numpy as np
import pytest
import torch

from jubatus_tpu.fv import Datum as JDatum
from jubatus_tpu.mix import codec as jcodec
from jubatus_tpu.models.anomaly import AnomalyDriver as JAnom
from jubatus_tpu_torch.fv import Datum as TDatum
from jubatus_tpu_torch.mix import codec as tcodec
from jubatus_tpu_torch.models.anomaly import AnomalyDriver as TAnom
from tests.test_torch_recommender import wire

torch.set_num_threads(1)

NN_METHODS = ("inverted_index", "inverted_index_euclid", "euclid", "lsh",
              "minhash", "euclid_lsh")


def config(method="lof", nn_method="inverted_index_euclid", hash_num=64,
           k=5, max_size=0, hash_max=1 << 11, ignore_kth=False):
    param = {"nearest_neighbor_num": k, "reverse_nearest_neighbor_num": 30,
             "method": nn_method, "parameter": {"hash_num": hash_num}}
    if ignore_kth:
        param["ignore_kth_same_point"] = True
    if max_size:
        param.update(unlearner="lru",
                     unlearner_parameter={"max_size": max_size})
    return {"method": method, "parameter": param,
            "converter": {"num_rules": [{"key": "*", "type": "num"}],
                          "hash_max_size": hash_max}}


def both(seed, nnz=None, keys=200, dup=False):
    rng = np.random.default_rng(seed)
    nnz = nnz or int(rng.integers(1, 10))
    ks = rng.choice(keys, nnz, replace=False)
    vs = np.round(rng.standard_normal(nnz), 1) if dup else \
        rng.standard_normal(nnz)
    nums = [(f"f{k}", float(v)) for k, v in zip(ks, vs)]
    return JDatum(num_values=nums), TDatum(num_values=nums)


def assert_same_tables(j, t):
    assert j.ids == t.ids
    assert j.row_ids == t.row_ids
    for name in ("kdist", "lrd", "knn_dists"):
        np.testing.assert_array_equal(getattr(j, name).view(np.uint64),
                                      getattr(t, name).view(np.uint64))
    np.testing.assert_array_equal(j.knn_rows, t.knn_rows)


def history(cfg, seed, n=60):
    """Both drivers through the same seeded writes; every write's score
    bitwise."""
    j, t = JAnom(cfg), TAnom(cfg, device="cpu")
    rng = np.random.default_rng(seed)
    for step in range(n):
        op = rng.random()
        rid = f"p{int(rng.integers(0, n // 2 + 5))}"
        a, b = both(seed * 1000 + step, dup=step % 3 == 0)
        if op < 0.12 and j.ids:
            assert j.clear_row(rid) == t.clear_row(rid)
            continue
        if op < 0.25:
            s = (j.overwrite(rid, a), t.overwrite(rid, b))
        elif op < 0.4:
            s = (j.update(rid, a), t.update(rid, b))
        else:
            rid = f"a{step}"
            s = (j.add(rid, a), t.add(rid, b))
        assert np.float64(s[0]).view(np.uint64) == \
            np.float64(s[1]).view(np.uint64), (step, s)
    return j, t


def assert_same_scores(j, t, seed):
    qs = [both(seed * 17 + i) for i in range(6)]
    for a, b in qs:
        assert np.float64(j.calc_score(a)).view(np.uint64) == \
            np.float64(t.calc_score(b)).view(np.uint64)
    many_j = j.calc_score_many([a for a, _ in qs])
    many_t = t.calc_score_many([b for _, b in qs])
    np.testing.assert_array_equal(np.float64(many_j).view(np.uint64),
                                  np.float64(many_t).view(np.uint64))


@pytest.mark.parametrize("method", ("lof", "light_lof"))
@pytest.mark.parametrize("nn_method", NN_METHODS)
def test_a_seeded_history_scores_bitwise(method, nn_method):
    cfg = config(method, nn_method)
    j, t = history(cfg, seed=NN_METHODS.index(nn_method) + 3 * len(method))
    assert_same_tables(j, t)
    assert_same_scores(j, t, seed=4)
    assert j.get_all_rows() == t.get_all_rows()
    assert j.get_status() | {"query_tier": ""} == \
        t.get_status() | {"query_tier": ""}


@pytest.mark.parametrize("nn_method,hash_num", [("euclid_lsh", 128),
                                                ("lsh", 128),
                                                ("inverted_index_euclid", 64)])
def test_lru_eviction_refreshes_as_jax(nn_method, hash_num):
    cfg = config("lof", nn_method, hash_num, k=4, max_size=25,
                 hash_max=1 << 12)
    j, t = history(cfg, seed=41, n=70)
    assert len(t.ids) <= 25
    assert_same_tables(j, t)
    assert_same_scores(j, t, seed=8)


def test_ignore_kth_same_point_on_duplicates():
    cfg = config("lof", "inverted_index_euclid", k=3, ignore_kth=True)
    j, t = JAnom(cfg), TAnom(cfg, device="cpu")
    a, b = both(5)
    for i in range(6):
        assert j.add(f"d{i}", a) == t.add(f"d{i}", b)
    assert j.calc_score(a) == t.calc_score(b) == 1.0
    assert_same_tables(j, t)


@pytest.mark.parametrize("nn_method", ("euclid", "minhash"))
def test_model_files_load_across_packages(nn_method):
    cfg = config("light_lof", nn_method)
    j, t = history(cfg, seed=51)
    pj = msgpack.packb(j.pack(), use_bin_type=True)
    assert pj == msgpack.packb(t.pack(), use_bin_type=True)
    j2, t2 = JAnom(cfg), TAnom(cfg, device="cpu")
    t2.unpack(msgpack.unpackb(pj, raw=False, strict_map_key=False))
    j2.unpack(msgpack.unpackb(pj, raw=False, strict_map_key=False))
    assert_same_tables(j2, t2)
    assert_same_scores(j2, t2, seed=2)


@pytest.mark.parametrize("nn_method", ("inverted_index", "euclid_lsh"))
def test_mix_diffs_cross_packages(nn_method):
    cfg = config("lof", nn_method)
    (j, _), (_, t) = history(cfg, seed=61), history(cfg, seed=62)
    dj, dt = j.get_diff(), t.get_diff()
    j.put_diff(JAnom.mix(wire(dj, jcodec, jcodec), wire(dt, tcodec, jcodec)))
    t.put_diff(TAnom.mix(wire(dj, jcodec, tcodec), wire(dt, tcodec, tcodec)))
    assert j.rows == t.rows
    assert sorted(j.ids) == sorted(t.ids)
    assert not j._pending and not t._pending
    assert_same_scores(j, t, seed=3)
