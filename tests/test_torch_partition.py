"""The port's partition plane (jubatus_tpu_torch/framework/partition.py and
the row engines' partition_* methods) against the JAX package's, on the
CPU, over the same seeded numpy inputs.  The tolerance is none: every
comparison with the JAX package is == (ids, scores, order, bytes).

- merge_topk and merge_anomaly_score against the JAX merges on seeded
  candidate lists, duplicates, conflicts and ring owners included;
- the partial legs (nearest_neighbor's *_from_datum and *_sig_partial,
  the recommender's similar_row_from_datum and similar_row_from_fv_partial,
  anomaly's calc_score_partial) at 1, 2 and 4 partitions, on resident,
  indexed (lsh_probe, ivf) and spilled tables: each leg and each merge
  bitwise the JAX package's; on the exact layouts the merge also equals
  one port driver holding every row, scores exact and ids tie-aware (the
  merge breaks ties by id, one driver by row slot); one partition's
  anomaly merge is bitwise calc_score;
- the from_id payloads (partition_query_sig, partition_query_fv)
  bitwise, a signature also after the old-spec wire (a str with
  surrogate escapes);
- partition_pack_rows msgpack-byte-equal across packages; a JAX pack
  applied by the port and the reverse; drops leave equal stores whose
  next writes reuse the same slots; a late ship never clobbers a newer
  write; put_diff's owned-row filter;
- a journal holding partition_accept_rows (bytes in its payload) and
  partition_drop_rows records recovers to the same model in both
  packages, whichever wrote it;
- the CHT's find_cached, version and arcs_for equal to the JAX CHT's
  over one in-process coordinator;
- every port Method's routing spec equal to the JAX table's.
"""

import dataclasses
import json
import os
import random
import shutil

import msgpack
import numpy as np
import pytest

from jubatus_tpu.cluster.cht import CHT as JCHT
from jubatus_tpu.cluster.lock_service import CoordLockService as JLock
from jubatus_tpu.framework import server_base as jserver_base
from jubatus_tpu.framework.partition import merge_anomaly_score as jmerge_a
from jubatus_tpu.framework.partition import merge_topk as jmerge
from jubatus_tpu.framework.service import SERVICES as JSERVICES
from jubatus_tpu.fv import Datum as JDatum
from jubatus_tpu.models import create_driver as jcreate
from jubatus_tpu_torch.cluster.cht import CHT as TCHT
from jubatus_tpu_torch.cluster.coordinator import CoordinatorServer
from jubatus_tpu_torch.cluster.lock_service import CoordLockService as TLock
from jubatus_tpu_torch.framework import server_base as tserver_base
from jubatus_tpu_torch.framework.partition import (ScatterRead,
                                                   merge_anomaly_score,
                                                   merge_topk)
from jubatus_tpu_torch.framework.service import SERVICES as TSERVICES
from jubatus_tpu_torch.fv import Datum as TDatum
from jubatus_tpu_torch.models import create_driver as tcreate

CONV = {"num_rules": [{"key": "*", "type": "num"}], "hash_max_size": 512}
SPILL = {"page_rows": 4, "resident_pages": 2}
N_ROWS = 40
K = 8


def nn_cfg(method, pages=None):
    cfg = {"method": method, "parameter": {"hash_num": 64},
           "converter": CONV}
    if pages:
        cfg["pages"] = pages
    return cfg


def reco_cfg(method, pages=None):
    cfg = {"method": method,
           "parameter": {} if method.startswith("inverted")
           else {"hash_num": 64},
           "converter": CONV}
    if pages:
        cfg["pages"] = pages
    return cfg


def anomaly_cfg(nn_method, pages=None):
    cfg = {"method": "lof",
           "parameter": {"nearest_neighbor_num": 4,
                         "reverse_nearest_neighbor_num": 8,
                         "method": nn_method,
                         "parameter": {"hash_num": 64}},
           "converter": CONV}
    if pages:
        cfg["pages"] = pages
    return cfg


def vecs(n, seed, dim=6):
    """Clustered rows: the index's probes find real neighbours."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((5, dim))
    return centers[rng.integers(0, 5, n)] + 0.3 * rng.standard_normal(
        (n, dim))


def datum(cls, v):
    d = cls()
    for k, x in enumerate(v):
        d.add_number(f"f{k}", float(x))
    return d


def owner(id_, n_parts):
    return sum(id_.encode()) % n_parts


def canon(items, ascending):
    return sorted(([i, float(s)] for i, s in items),
                  key=lambda t: ((t[1] if ascending else -t[1]), t[0]))


def tie_eq(got, want, ascending):
    """Scores equal in order; ids equal away from the k-th score (a tie
    there may name another member of the tie)."""
    got, want = canon(got, ascending), canon(want, ascending)
    assert [s for _, s in got] == [s for _, s in want]
    if want:
        kth = want[-1][1]
        inner = (lambda s: s < kth) if ascending else (lambda s: s > kth)
        assert [t for t in got if inner(t[1])] == \
            [t for t in want if inner(t[1])]


def wire_str(payload):
    """A payload after the old-spec wire: binary as raw, decoded to str
    with surrogate escapes, as the RPC layer hands it to a handler."""
    return msgpack.unpackb(
        msgpack.packb(payload, use_bin_type=False,
                      unicode_errors="surrogateescape"),
        raw=False, strict_map_key=False, unicode_errors="surrogateescape")


class Cluster:
    """n_parts JAX drivers and n_parts port drivers holding the same rows,
    each row on partition owner(id), plus one port driver with every row."""

    def __init__(self, engine, cfg, n_parts, index=None, seed=3,
                 n_rows=N_ROWS):
        self.engine = engine
        self.j = [jcreate(engine, cfg) for _ in range(n_parts)]
        self.t = [tcreate(engine, cfg, device="cpu")
                  for _ in range(n_parts)]
        # one partition holds every row, in the order written
        self.full = self.t[0] if n_parts == 1 else \
            tcreate(engine, cfg, device="cpu")
        if index is not None:
            kind, kw = index
            for drv in {id(d): d for d in self.j + self.t
                        + [self.full]}.values():
                assert drv.configure_index(kind, probes=4, min_rows=0, **kw)
        self.ids = [f"row{i}" for i in range(n_rows)]
        self.rows = vecs(n_rows, seed)
        self.owner = {i: owner(i, n_parts) for i in self.ids}
        if engine == "nearest_neighbor":
            # one batched write a driver (set_row_many signs as a batch in
            # both packages alike)
            for p in range(n_parts):
                mine = [(i, v) for i, v in zip(self.ids, self.rows)
                        if self.owner[i] == p]
                self.j[p].set_row_many([(i, datum(JDatum, v))
                                        for i, v in mine])
                self.t[p].set_row_many([(i, datum(TDatum, v))
                                        for i, v in mine])
            if n_parts > 1:
                self.full.set_row_many([(i, datum(TDatum, v))
                                        for i, v in zip(self.ids,
                                                        self.rows)])
            return
        write = {"recommender": "update_row", "anomaly": "update"}[engine]
        for id_, v in zip(self.ids, self.rows):
            p = self.owner[id_]
            getattr(self.j[p], write)(id_, datum(JDatum, v))
            getattr(self.t[p], write)(id_, datum(TDatum, v))
            if n_parts > 1:
                getattr(self.full, write)(id_, datum(TDatum, v))

    def legs(self, fn):
        """fn(driver, datum_class) on every partition of both packages;
        each port leg == its JAX twin.  -> the port's [(p, leg)]."""
        out = []
        for p, (jd, td) in enumerate(zip(self.j, self.t)):
            a = fn(jd, JDatum)
            b = fn(td, TDatum)
            assert _wire(a) == _wire(b), (p, a, b)
            out.append((p, _wire(b)))
        return out


def _wire(res):
    if isinstance(res, list) and res and isinstance(res[0], tuple):
        return [[i, s] for i, s in res]
    return res


def queries(seed=9, n=3):
    return vecs(n, seed)


# ---------------------------------------------------------------------------
# the merges
# ---------------------------------------------------------------------------

def _cands(rng, n_parts, n_ids=12, per=6, scores=(0.0, 0.25, 0.5, 1.0)):
    """Seeded legs with shared ids: equal-score duplicates, conflicting
    duplicates and ties."""
    out = []
    for p in range(n_parts):
        ids = rng.choice(n_ids, size=per, replace=False)
        out.append((f"h{p}", [[f"id{i}", float(rng.choice(scores))]
                              for i in ids]))
    return out


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("ascending", [False, True])
def test_merge_topk_equals_jax(seed, ascending):
    rng = np.random.default_rng(seed)
    parts = _cands(rng, 1 + seed % 4)
    own = {f"id{i}": f"h{rng.integers(0, 4)}" for i in range(12)}
    for k in (0, 1, 5, 30):
        for owner_of in (None, own.get, lambda _i: None):
            assert merge_topk(parts, k, ascending, owner_of) == \
                jmerge(parts, k, ascending, owner_of)


def test_merge_topk_conflict_and_owner_cases():
    """tests/test_partition.py's merge units, on both packages."""
    cases = [
        (([("a", [["x", 0.9], ["y", 0.5]]), ("b", [["z", 0.7], ["w", 0.1]])],
          3, False, None), [["x", 0.9], ["z", 0.7], ["y", 0.5]]),
        (([("a", [["x", 0.9], ["y", 0.5]]), ("b", [["z", 0.7], ["w", 0.1]])],
          3, True, None), [["w", 0.1], ["y", 0.5], ["z", 0.7]]),
        (([("a", []), ("b", None)], 5, False, None), []),
        (([("a", [["x", 1.0]])], 0, False, None), []),
        (([("a", [["x", 0.9]]), ("b", [["x", 0.9], ["y", 0.2]])], 5, False,
          None), [["x", 0.9], ["y", 0.2]]),
        (([("a", [["x", 0.9]]), ("b", [["x", 0.4]])], 5, False,
          lambda i: "b"), [["x", 0.4]]),
        (([("a", [["x", 0.9]]), ("b", [["x", 0.4]])], 5, False,
          lambda i: "a"), [["x", 0.9]]),
    ]
    for args, want in cases:
        assert merge_topk(*args) == want == jmerge(*args)


@pytest.mark.parametrize("seed", range(6))
def test_merge_anomaly_score_equals_jax(seed):
    rng = np.random.default_rng(seed)
    legs = []
    for p in range(1 + seed % 3):
        items = [[f"id{i}", float(rng.choice([0.0, 0.5, 1.0, 2.0])),
                  float(rng.choice([0.0, 0.5, 1.0, np.inf])),
                  float(rng.choice([0.0, 0.5, 1.5]))]
                 for i in rng.choice(8, size=4, replace=False)]
        legs.append((f"h{p}", [4, bool(seed % 2), items]))
    own = {f"id{i}": f"h{rng.integers(0, 3)}" for i in range(8)}
    for owner_of in (None, own.get):
        a = merge_anomaly_score(legs, owner_of)
        b = jmerge_a(legs, owner_of)
        assert a == b or (np.isnan(a) and np.isnan(b))


def test_merge_anomaly_score_edges():
    pile = [["x", 0.0, np.inf, 0.0], ["y", 0.0, np.inf, 0.0]]
    ones = [["x", 0.0, 1.0, 0.0], ["y", 0.0, 1.0, 0.0]]
    for legs, want in (([], 1.0), ([("a", [4, False, []])], 1.0),
                       ([("a", [2, False, pile])], 1.0),
                       ([("a", [2, False, ones])], float("inf")),
                       ([("a", [2, True, ones])], 1.0)):
        assert merge_anomaly_score(legs) == want == jmerge_a(legs)


# ---------------------------------------------------------------------------
# the partial legs and their merges, port against JAX
# ---------------------------------------------------------------------------

LAYOUTS = ["resident", "indexed", "spilled"]


def _layout(layout, kind):
    pages = SPILL if layout == "spilled" else None
    index = (kind, {}) if layout == "indexed" else None
    return pages, index


@pytest.mark.parametrize("n_parts", [1, 2, 4])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("method", ["lsh", "minhash", "euclid_lsh"])
def test_nn_legs_and_merges_equal_jax(method, layout, n_parts):
    pages, index = _layout(layout, "lsh_probe")
    c = Cluster("nearest_neighbor", nn_cfg(method, pages), n_parts, index)
    for q in queries():
        for kind, asc in (("neighbor_row_from_datum", True),
                          ("similar_row_from_datum", False)):
            legs = c.legs(lambda d, cls: getattr(d, kind)(datum(cls, q), K))
            got = merge_topk(legs, K, asc)
            assert got == jmerge(legs, K, asc)
            if layout != "indexed":
                tie_eq(got, getattr(c.full, kind)(datum(TDatum, q), K), asc)
    for id_ in ("row0", "row17", "row39"):
        o = c.owner[id_]
        payload = c.t[o].partition_query_sig(id_)
        assert payload == c.j[o].partition_query_sig(id_)
        for kind, pub, asc in (
                ("neighbor_row_from_sig_partial", "neighbor_row_from_id",
                 True),
                ("similar_row_from_sig_partial", "similar_row_from_id",
                 False)):
            legs = c.legs(lambda d, cls: getattr(d, kind)(*payload, K))
            got = merge_topk(legs, K, asc)
            assert got == jmerge(legs, K, asc)
            # the signature's bytes after the old-spec wire
            sig_s, norm = wire_str(payload)
            assert isinstance(sig_s, str)
            assert [[i, s] for i, s in getattr(c.t[0], kind)(sig_s, norm,
                                                             K)] == legs[0][1]
            if layout != "indexed":
                tie_eq(got, getattr(c.full, pub)(id_, K), asc)
    with pytest.raises(KeyError):
        c.t[0].partition_query_sig("nope")


@pytest.mark.parametrize("n_parts", [1, 2, 4])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("method", ["inverted_index", "lsh"])
def test_recommender_legs_and_merges_equal_jax(method, layout, n_parts):
    kind = "ivf" if method == "inverted_index" else "lsh_probe"
    pages, index = _layout(layout, kind)
    c = Cluster("recommender", reco_cfg(method, pages), n_parts, index)
    for q in queries():
        legs = c.legs(lambda d, cls: d.similar_row_from_datum(
            datum(cls, q), K))
        got = merge_topk(legs, K, False)
        assert got == jmerge(legs, K, False)
        if layout != "indexed":
            tie_eq(got, c.full.similar_row_from_datum(datum(TDatum, q), K),
                   False)
    for id_ in ("row0", "row17", "row39"):
        o = c.owner[id_]
        fv = c.t[o].partition_query_fv(id_)
        assert fv == c.j[o].partition_query_fv(id_)
        legs = c.legs(lambda d, cls: d.similar_row_from_fv_partial(fv, K))
        got = merge_topk(legs, K, False)
        assert got == jmerge(legs, K, False)
        if layout != "indexed":
            tie_eq(got, c.full.similar_row_from_id(id_, K), False)
    assert c.t[0].partition_query_fv("nope") is None


@pytest.mark.parametrize("n_parts", [1, 2, 4])
@pytest.mark.parametrize("method,layout", [
    ("euclid_lsh", "resident"), ("euclid_lsh", "indexed"),
    ("euclid_lsh", "spilled"), ("inverted_index_euclid", "resident"),
    ("inverted_index_euclid", "spilled")])
def test_anomaly_legs_and_merges_equal_jax(method, layout, n_parts):
    pages, index = _layout(layout, "lsh_probe")
    c = Cluster("anomaly", anomaly_cfg(method, pages), n_parts, index,
                n_rows=24)
    for q in queries(n=2):
        legs = c.legs(lambda d, cls: d.calc_score_partial(datum(cls, q)))
        got = merge_anomaly_score(legs)
        assert got == jmerge_a(legs)
        full = c.full.calc_score_partial(datum(TDatum, q))
        merged = sorted((it for _, leg in legs for it in leg[2]),
                        key=lambda t: (t[1], t[0]))[:full[0]]
        if layout != "indexed":
            # the global kNN's ids and distances are exact
            assert [c_[1] for c_ in merged] == [c_[1] for c_ in full[2]]
        if n_parts == 1:
            assert got == c.t[0].calc_score(datum(TDatum, q)) == \
                c.j[0].calc_score(datum(JDatum, q))


# ---------------------------------------------------------------------------
# the handoff: pack, apply, drop, across packages
# ---------------------------------------------------------------------------

ENGINES = {
    "nearest_neighbor": (nn_cfg("lsh"), "set_row"),
    "recommender": (reco_cfg("inverted_index"), "update_row"),
    "anomaly": (anomaly_cfg("euclid_lsh"), "update"),
}


def _fill(drv, cls, engine, ids, rows):
    write = ENGINES[engine][1]
    for id_, v in zip(ids, rows):
        getattr(drv, write)(id_, datum(cls, v))


def _reads(drv, engine, cls):
    out = []
    for q in queries(seed=21):
        if engine == "nearest_neighbor":
            out.append(_wire(drv.similar_row_from_datum(datum(cls, q), K)))
        elif engine == "recommender":
            out.append(_wire(drv.similar_row_from_datum(datum(cls, q), K)))
        else:
            out.append(drv.calc_score_partial(datum(cls, q)))
    return out


def _packed(drv):
    return msgpack.packb(drv.pack(), use_bin_type=True)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_pack_rows_are_byte_equal_and_apply_across_packages(engine):
    cfg = ENGINES[engine][0]
    ids = [f"r{i}" for i in range(24)]
    rows = vecs(24, 5)
    src_j, src_t = jcreate(engine, cfg), tcreate(engine, cfg, device="cpu")
    _fill(src_j, JDatum, engine, ids, rows)
    _fill(src_t, TDatum, engine, ids, rows)
    move = ids[::3] + ["absent"]
    pj = src_j.partition_pack_rows(move)
    pt = src_t.partition_pack_rows(move)
    assert msgpack.packb(pj, use_bin_type=True) == \
        msgpack.packb(pt, use_bin_type=True)
    # each target holds other rows, then takes the other package's pack
    # (as the wire hands it over: the old spec's raw strings)
    dst_j, dst_t = jcreate(engine, cfg), tcreate(engine, cfg, device="cpu")
    others = [f"o{i}" for i in range(10)]
    _fill(dst_j, JDatum, engine, others, vecs(10, 6))
    _fill(dst_t, TDatum, engine, others, vecs(10, 6))
    assert dst_t.partition_apply_rows(wire_str(pj)) == len(ids[::3])
    assert dst_j.partition_apply_rows(wire_str(pt)) == len(ids[::3])
    assert _reads(dst_t, engine, TDatum) == _reads(dst_j, engine, JDatum)
    assert _packed(dst_t) == _packed(dst_j)
    # the loser drops what it shipped; the next writes reuse the freed
    # slots in the same order in both packages
    assert src_t.partition_drop_rows(move) == len(ids[::3]) == \
        src_j.partition_drop_rows(move)
    assert sorted(src_t.partition_ids()) == sorted(src_j.partition_ids())
    assert set(src_t.partition_ids()).isdisjoint(ids[::3])
    assert _reads(src_t, engine, TDatum) == _reads(src_j, engine, JDatum)
    new = [f"n{i}" for i in range(5)]
    _fill(src_j, JDatum, engine, new, vecs(5, 7))
    _fill(src_t, TDatum, engine, new, vecs(5, 7))
    assert _reads(src_t, engine, TDatum) == _reads(src_j, engine, JDatum)
    assert _packed(src_t) == _packed(src_j)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_a_late_ship_never_clobbers_a_newer_write(engine):
    cfg = ENGINES[engine][0]
    old, new = vecs(2, 8)
    for create, cls in ((jcreate, JDatum),
                        (lambda e, c: tcreate(e, c, device="cpu"), TDatum)):
        a, b = create(engine, cfg), create(engine, cfg)
        _fill(a, cls, engine, ["r"], [old])
        payload = a.partition_pack_rows(["r"])
        _fill(b, cls, engine, ["r"], [new])
        before = _packed(b)
        assert b.partition_apply_rows(payload) == 0
        assert _packed(b) == before


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_put_diff_keeps_only_owned_or_resident_rows(engine):
    """tests/test_partition.py's filter, the port beside the JAX driver."""
    cfg = ENGINES[engine][0]
    src = jcreate(engine, cfg)
    _fill(src, JDatum, engine, ["foreign", "mine", "owned"], vecs(3, 4))
    diff = src.get_diff()
    out = []
    for create, cls in ((jcreate, JDatum),
                        (lambda e, c: tcreate(e, c, device="cpu"), TDatum)):
        drv = create(engine, cfg)
        _fill(drv, cls, engine, ["mine"], vecs(1, 2))
        drv.partition_owned = lambda id_: id_ == "owned"
        drv.put_diff(diff)
        assert sorted(drv.partition_ids()) == ["mine", "owned"]
        out.append(_packed(drv))
    assert out[0] == out[1]


def test_put_diff_tombstone_of_a_resident_row_still_applies():
    drv = tcreate("recommender", reco_cfg("lsh"), device="cpu")
    drv.update_row("mine", datum(TDatum, vecs(1, 0)[0]))
    drv.partition_owned = lambda id_: id_ == "mine"
    drv.put_diff({"rows": {"foreign": {1: 1.0}, "mine": None},
                  "revert": {}, "weights": drv.converter.weights.get_diff()})
    assert "foreign" not in drv.rows and "mine" not in drv.rows
    nn = tcreate("nearest_neighbor", nn_cfg("lsh"), device="cpu")
    nn.partition_owned = lambda id_: False
    nn.put_diff({"rows": {"foreign": {"sig": b"\0" * 8, "norm": 1.0}},
                 "weights": nn.converter.weights.get_diff()})
    assert "foreign" not in nn.ids


# ---------------------------------------------------------------------------
# a journal with partition records recovers in both packages
# ---------------------------------------------------------------------------

SERVER_BASES = {"jax": jserver_base, "port": tserver_base}
SERVICE_TABLES = {"jax": JSERVICES, "port": TSERVICES}


def _server(pkg, engine, dirpath):
    base = SERVER_BASES[pkg]
    kw = {"device": "cpu"} if pkg == "port" else {}
    args = base.ServerArgs(type=engine, name="t", journal_dir=str(dirpath),
                           journal_fsync="always", snapshot_interval_sec=0.0,
                           **kw)
    srv = base.JubatusServer(args,
                             config=json.dumps(ENGINES[engine][0]))
    srv.init_durability()
    return srv


def _shut(pkg, srv):
    if pkg == "jax":
        srv.shutdown_durability()
    else:
        srv.stop()


def _journaled(pkg, srv, method, *args):
    """Apply and journal one update as the service's wrap() does."""
    with srv.model_lock.write():
        SERVICE_TABLES[pkg][srv.args.type].methods[method].fn(srv, *args)
        srv.event_model_updated()
        srv.journal.append({"k": "u", "m": method, "a": list(args)},
                           srv.current_mix_round())
    srv.journal.commit()


def _datum_wire(v):
    return [[], [[f"f{k}", float(x)] for k, x in enumerate(v)], []]


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("writer, reader", [("jax", "port"),
                                            ("port", "jax")])
def test_a_partition_journal_recovers_in_the_other_package(tmp_path, engine,
                                                           writer, reader):
    write = ENGINES[engine][1]
    src = jcreate(engine, ENGINES[engine][0])
    shipped_ids = [f"s{i}" for i in range(6)]
    _fill(src, JDatum, engine, shipped_ids, vecs(6, 12))
    payload = wire_str(src.partition_pack_rows(shipped_ids))
    srv = _server(writer, engine, tmp_path / "dur")
    for i, v in enumerate(vecs(10, 13)):
        _journaled(writer, srv, write, f"r{i}", _datum_wire(v))
    _journaled(writer, srv, "partition_accept_rows", payload)
    _journaled(writer, srv, "partition_drop_rows", ["r1", "r4", "s2"])
    _journaled(writer, srv, write, "r11", _datum_wire(vecs(1, 14)[0]))
    at_crash = _packed(srv.driver)
    srv.journal.close()
    for name in ("own", "other"):
        shutil.copytree(tmp_path / "dur", tmp_path / name)
        os.remove(tmp_path / name / "LOCK")
    own = _server(writer, engine, tmp_path / "own")
    other = _server(reader, engine, tmp_path / "other")
    try:
        for s in (own, other):
            assert s.recovery_info.replayed == 13
            assert s.recovery_info.errors == 0
        assert _packed(own.driver) == at_crash == _packed(other.driver)
        assert sorted(other.driver.partition_ids()) == sorted(
            [f"r{i}" for i in range(10) if i not in (1, 4)]
            + ["r11"] + [i for i in shipped_ids if i != "s2"])
    finally:
        _shut(writer, own)
        _shut(reader, other)


# ---------------------------------------------------------------------------
# the ring's readers over one coordinator
# ---------------------------------------------------------------------------

def test_cht_readers_equal_jax_over_one_coordinator():
    coord = CoordinatorServer()
    port = coord.start(0, "127.0.0.1")
    tls, jls = TLock(f"127.0.0.1:{port}"), JLock(f"127.0.0.1:{port}")
    try:
        t = TCHT(tls, "recommender", "c", cache_ttl=0.0)
        j = JCHT(jls, "recommender", "c", cache_ttl=0.0)
        nodes = [("127.0.0.1", 9000 + i) for i in range(4)]
        rng = random.Random(0)
        keys = [f"k{rng.getrandbits(32)}" for _ in range(300)]
        for i, node in enumerate(nodes):
            (t if i % 2 else j).register_node(*node)
            assert t.version() == j.version()
            for key in keys:
                assert t.find_cached(key, 1) == j.find_cached(key, 1)
                assert t.find_cached(key, 3) == j.find_cached(key, 3)
            for node_ in nodes:
                assert t.arcs_for(*node_) == j.arcs_for(*node_)
        assert sorted(h for n in nodes for h in t.arcs_for(*n)) == \
            sorted(h for h, _ in t._ring)
        owners = {t.find_cached(k, 1)[0] for k in keys}
        assert owners == set(nodes)
    finally:
        tls.close()
        jls.close()
        coord.stop()


def test_find_cached_reads_the_last_refresh_only():
    coord = CoordinatorServer()
    port = coord.start(0, "127.0.0.1")
    ls = TLock(f"127.0.0.1:{port}")
    try:
        t = TCHT(ls, "nearest_neighbor", "c", cache_ttl=0.0)
        assert t.find_cached("x", 1) == []
        t.register_node("127.0.0.1", 9001)
        assert t.find_cached("x", 1) == []       # no refresh yet
        v1 = t.version()
        assert t.find_cached("x", 1) == [("127.0.0.1", 9001)]
        t.register_node("127.0.0.1", 9002)
        assert t.version() != v1
    finally:
        ls.close()
        coord.stop()


# ---------------------------------------------------------------------------
# the service tables' routing specs
# ---------------------------------------------------------------------------

SPEC_FIELDS = ("update", "nolock", "routing", "aggregator", "cht_replicas")


@pytest.mark.parametrize("service", sorted(TSERVICES))
def test_every_method_carries_the_jax_routing_spec(service):
    tm, jm = TSERVICES[service].methods, JSERVICES[service].methods
    assert list(tm) == list(jm)
    for name, m in tm.items():
        assert [getattr(m, f) for f in SPEC_FIELDS] == \
            [getattr(jm[name], f) for f in SPEC_FIELDS], name
        if jm[name].partition is None:
            assert m.partition is None, name
        else:
            assert isinstance(m.partition, ScatterRead)
            assert dataclasses.astuple(m.partition) == \
                dataclasses.astuple(jm[name].partition), name
