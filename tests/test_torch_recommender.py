"""The port's recommender (jubatus_tpu_torch/models/recommender.py on the
CPU, through the plain versions of K1-K4) against the JAX package's, on
seeded histories of update_row (column merges), clear_row, re-inserts
and LRU evictions: every read of all six methods answers bitwise as the
JAX driver does (ids, scores, datums), model files and MIX diffs cross
packages, and the store reuses freed slots in the JAX store's order.
Small sizes: hash_max_size 2^10-2^12, a few hundred rows, H 64 and 128.
"""

import msgpack
import numpy as np
import pytest
import torch

from jubatus_tpu.fv import Datum as JDatum
from jubatus_tpu.mix import codec as jcodec
from jubatus_tpu.models.pages import PagedRowStore as JStore
from jubatus_tpu.models.recommender import RecommenderDriver as JReco
from jubatus_tpu_torch.fv import Datum as TDatum
from jubatus_tpu_torch.mix import codec as tcodec
from jubatus_tpu_torch.models.pages import PagedRowStore as TStore
from jubatus_tpu_torch.models.recommender import RecommenderDriver as TReco

torch.set_num_threads(1)

METHODS = ("inverted_index", "inverted_index_euclid", "lsh", "minhash",
           "euclid_lsh", "nearest_neighbor_recommender")


def config(method, hash_num=64, hash_max=1 << 11, max_size=0):
    conv = {"num_rules": [{"key": "*", "type": "num"}],
            "string_rules": [{"key": "*", "type": "str",
                              "sample_weight": "bin",
                              "global_weight": "bin"}],
            "hash_max_size": hash_max}
    if method == "nearest_neighbor_recommender":
        param = {"method": "euclid_lsh",
                 "parameter": {"hash_num": hash_num}}
    elif method in ("lsh", "minhash", "euclid_lsh"):
        param = {"hash_num": hash_num}
    else:
        param = {}
    if max_size:
        param.update(unlearner="lru",
                     unlearner_parameter={"max_size": max_size})
    return {"method": method, "parameter": param, "converter": conv}


def datum(rng, pkg, nnz=None, keys=300):
    nnz = nnz or int(rng.integers(1, 12))
    ks = rng.choice(keys, nnz, replace=False)
    nums = [(f"f{k}", float(v)) for k, v in
            zip(ks, rng.standard_normal(nnz))]
    strs = [("tag", f"t{int(rng.integers(0, 5))}")]
    cls = JDatum if pkg == "j" else TDatum
    return cls(string_values=strs, num_values=nums)


def both(seed, **kw):
    rng = np.random.default_rng(seed)
    state = rng.bit_generator.state
    out = []
    for pkg in ("j", "t"):
        rng.bit_generator.state = state
        out.append(datum(rng, pkg, **kw))
    return out


def history(method, seed=0, n=120, hash_num=64, max_size=0, hash_max=1 << 11):
    """Both drivers after the same seeded history: inserts, column-merge
    updates, clears and re-inserts (and evictions at max_size)."""
    cfg = config(method, hash_num, hash_max, max_size)
    j, t = JReco(cfg), TReco(cfg, device="cpu")
    rng = np.random.default_rng(seed)
    for step in range(n):
        op = rng.random()
        rid = f"r{int(rng.integers(0, n // 2 + 10))}"
        if op < 0.15 and j.ids:
            assert j.clear_row(rid) == t.clear_row(rid)
            continue
        dj, dt = both(seed * 1000 + step)
        assert j.update_row(rid, dj) == t.update_row(rid, dt)
        if op > 0.9:        # a read in the middle syncs the dirty rows
            a, b = both(seed * 7919 + step)
            assert (j.similar_row_from_datum(a, 5)
                    == t.similar_row_from_datum(b, 5))
    return j, t, rng


def same_datum(a, b):
    assert a.string_values == b.string_values
    assert [(k, np.float64(v)) for k, v in a.num_values] == \
        [(k, np.float64(v)) for k, v in b.num_values]


def assert_same_reads(j, t, seed, k=10):
    ids = j.get_all_rows()
    assert ids == t.get_all_rows()
    assert j.get_status()["num_rows"] == t.get_status()["num_rows"]
    for i in ids[:6] + ["missing"]:
        assert j.similar_row_from_id(i, k) == t.similar_row_from_id(i, k)
        same_datum(j.decode_row(i), t.decode_row(i))
        same_datum(j.complete_row_from_id(i), t.complete_row_from_id(i))
    for q in range(4):
        a, b = both(seed * 31 + q)
        for size in (1, k, 40):
            assert (j.similar_row_from_datum(a, size)
                    == t.similar_row_from_datum(b, size))
        same_datum(j.complete_row_from_datum(a),
                   t.complete_row_from_datum(b))
        c, d = both(seed * 37 + q)
        assert j.calc_similarity(a, c) == t.calc_similarity(b, d)
        assert j.calc_l2norm(a) == t.calc_l2norm(b)
    pairs = [both(seed * 41 + q) for q in range(5)]
    sizes = [3, 10, 1, 25, 8]
    assert (j.similar_row_from_datum_many([(p[0], s) for p, s in
                                           zip(pairs, sizes)])
            == t.similar_row_from_datum_many([(p[1], s) for p, s in
                                              zip(pairs, sizes)]))


def packed(drv) -> bytes:
    return msgpack.packb(drv.pack(), use_bin_type=True)


@pytest.mark.parametrize("method", METHODS)
def test_a_seeded_history_answers_bitwise(method):
    j, t, _ = history(method, seed=METHODS.index(method))
    assert packed(j) == packed(t)
    assert_same_reads(j, t, seed=5)
    st = t.get_status()
    assert st["query_tier"] == "cpu"
    assert st["paged_free_slots"] == j.get_status()["paged_free_slots"]


@pytest.mark.parametrize("method", ("inverted_index", "lsh"))
def test_lru_eviction_and_slot_reuse_follow_jax(method):
    j, t, _ = history(method, seed=11, n=160, max_size=30)
    assert len(j.ids) == len(t.ids) == 30
    assert j.ids == t.ids
    assert packed(j) == packed(t)
    assert_same_reads(j, t, seed=6)


@pytest.mark.parametrize("method,hash_num,hash_max", [
    ("lsh", 128, 1 << 12), ("euclid_lsh", 128, 1 << 10),
    ("inverted_index_euclid", 64, 1 << 12)])
def test_wide_rows_grow_kr_and_stay_bitwise(method, hash_num, hash_max):
    """Rows of up to 200 features grow Kr through 64, 128 and 256."""
    cfg = config(method, hash_num, hash_max)
    j, t = JReco(cfg), TReco(cfg, device="cpu")
    for i in range(60):
        a, b = both(400 + i, nnz=[3, 40, 90, 200][i % 4], keys=1000)
        j.update_row(f"w{i}", a)
        t.update_row(f"w{i}", b)
        if i % 9 == 4:
            j.clear_row(f"w{i - 2}")
            t.clear_row(f"w{i - 2}")
    assert_same_reads(j, t, seed=9)
    assert j.kr == t.kr == 256


@pytest.mark.parametrize("method", ("inverted_index", "minhash"))
def test_model_files_load_across_packages(method):
    j, t, _ = history(method, seed=21)
    j2, t2 = JReco(config(method)), TReco(config(method), device="cpu")
    t2.unpack(msgpack.unpackb(packed(j), raw=False, strict_map_key=False))
    j2.unpack(msgpack.unpackb(packed(t), raw=False, strict_map_key=False))
    assert packed(j2) == packed(t2) == packed(j)
    assert_same_reads(j2, t2, seed=3)


def wire(diff, enc, dec):
    """A diff through one package's MIX codec and msgpack, decoded by
    the other's (or the same)."""
    raw = msgpack.packb(enc.encode(diff), use_bin_type=True)
    obj = msgpack.unpackb(raw, raw=False, strict_map_key=False)
    return dec.decode(obj, "cpu") if dec is tcodec else dec.decode(obj)


@pytest.mark.parametrize("method", ("inverted_index_euclid", "euclid_lsh"))
def test_mix_diffs_cross_packages(method):
    """A port replica and a JAX replica fold each other's diffs
    (tombstones included) through their own mix; both end with the same
    rows, and the same answers."""
    (j, _, _), (_, t, _) = history(method, seed=31), history(method, seed=32)
    dj, dt = j.get_diff(), t.get_diff()
    assert any(v is None for v in dt["rows"].values())
    merged_j = JReco.mix(wire(dj, jcodec, jcodec), wire(dt, tcodec, jcodec))
    merged_t = TReco.mix(wire(dj, jcodec, tcodec), wire(dt, tcodec, tcodec))
    j.put_diff(merged_j)
    t.put_diff(merged_t)
    assert j.rows and j.rows == t.rows
    assert j.ids.keys() == t.ids.keys()
    assert not j._pending and not t._pending
    for q in range(3):
        a, b = both(77 + q)
        assert j.similar_row_from_datum(a, 12) == \
            t.similar_row_from_datum(b, 12)


def test_the_store_reuses_freed_slots_in_the_jax_order():
    """A drop-then-insert history: slots, holes and the device mask as
    the JAX store's."""
    cols = {"x": ((2,), np.int32)}
    js, ts = JStore(cols, 8, spec=None), TStore(cols, 8, torch.device("cpu"))
    rng = np.random.default_rng(3)
    live = []
    for _ in range(200):
        if live and rng.random() < 0.4:
            k = int(rng.integers(1, min(len(live), 4) + 1))
            drop = [live.pop(int(rng.integers(0, len(live))))
                    for _ in range(k)]
            assert js.free(drop) == ts.free(drop)
        else:
            n = int(rng.integers(1, 4))
            a, b = js.alloc(n), ts.alloc(n)
            np.testing.assert_array_equal(a, b)
            live += a.tolist()
        assert js.capacity == ts.capacity
        assert js.has_holes == ts.has_holes and js.n_rows == ts.n_rows
        np.testing.assert_array_equal(js.mask_host(), ts.mask_host())
        np.testing.assert_array_equal(np.asarray(js.mask_dev()),
                                      ts.mask_dev().numpy())
    assert js.get_status() == ts.get_status()


def test_refusals_name_their_roadmap_items():
    """The spill tier (Queue 1 item 5.4) is served now: a config with
    pages.resident_pages boots, and after the seeded history its reads
    equal the JAX spilled driver's, bitwise.  An unknown method is still
    refused."""
    cfg = dict(config("lsh"), pages={"resident_pages": 2, "page_rows": 8})
    j, t = JReco(cfg), TReco(cfg, device="cpu")
    for step in range(60):
        a, b = both(step)
        assert j.update_row(f"r{step % 40}", a) == \
            t.update_row(f"r{step % 40}", b)
    assert t.get_status()["resident_budget_pages"] == "2"
    assert_same_reads(j, t, seed=9)
    with pytest.raises(ValueError):
        TReco(config("nope"), device="cpu")
