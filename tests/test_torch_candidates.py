"""The port's candidate-index ops (jubatus_tpu_torch/ops/candidates.py and
index/store.py) against the JAX package's (jubatus_tpu/ops/candidates.py,
index/store.py), on seeded numpy inputs, on the CPU.

- The host planes bitwise: band_plan, bucket_assign_np, cs_embed_np, and
  BucketStore's packs (flat, offsets, lens, delta, cap, truncation and
  version) after a note / invalidate / overflow sequence whose fat bucket
  forces a truncating cap.
- K6's plain version (sig_probe_ref) bitwise JAX's _sig_probe_from_row in
  rows, scores and n_cand for lsh, minhash and euclid_lsh at H 64 and 512
  (minhash 256), on prototype-clustered signatures (ties and duplicates
  across probes), with an empty and a full delta, a count and a bool
  mask, and a kb above 1,024; the datum routes (K1/K2's plain versions
  at B 1, then K6's) bitwise _sig_probe_from_datum and the batch route
  (signed as a batch of round_b) bitwise _sig_probe_batch, on a datum
  within an ulp of a signature boundary.
- K7's plain version (ivf_probe_ref) bitwise _ivf_probe_query for cosine
  and euclid at probes 1 to 8, with colliding count-sketch coordinates,
  and with centroids whose scores tie or lie an ulp apart at the probe
  boundary, and at every embed_dim from 2 to 8,192; its stages
  (cs_embed_ref, centroid_scores_ref) bitwise XLA's at E 2 to 65,536.
Every comparison is ==: no tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jubatus_tpu.fv import Datum as JDatum
from jubatus_tpu.index.base import IndexSpec as JSpec
from jubatus_tpu.index.base import tie_aware_recall as j_recall
from jubatus_tpu.index.ivf import IvfIndex as JIvf
from jubatus_tpu.index.store import BucketStore as JStore
from jubatus_tpu.models.nearest_neighbor import NearestNeighborDriver as JNN
from jubatus_tpu.ops import candidates as jc
from jubatus_tpu_torch.fv import Datum as TDatum
from jubatus_tpu_torch.index.base import tie_aware_recall as t_recall
from jubatus_tpu_torch.index.store import BucketStore as TStore
from jubatus_tpu_torch.models.nearest_neighbor import \
    NearestNeighborDriver as TNN
from jubatus_tpu_torch.ops import candidates as tc
from jubatus_tpu_torch.ops import lsh as tl
from tests.test_torch_nearest_neighbor import BOUNDARY, config, rows
from torch_index_inputs import clustered_sigs, sig_index, sparse_rows

SIG_CASES = [("lsh", 64), ("minhash", 64), ("euclid_lsh", 64), ("lsh", 512),
             ("euclid_lsh", 512), ("minhash", 256)]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# host planes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["lsh", "minhash", "euclid_lsh"])
def test_plans_and_bucket_assignment_equal_jax(kind):
    for h, bits, probes in ((64, 8, 4), (64, 8, 12), (512, 8, 80),
                            (8, 8, 5), (64, 3, 40), (256, 24, 2)):
        assert tc.band_plan(kind, h, bits, probes) == \
            jc.band_plan(kind, h, bits, probes)
        assert tc.n_bands_for(kind, h, bits) == jc.n_bands_for(kind, h, bits)
    sig, _ = clustered_sigs(kind, 96, 500, seed=4)
    for bits in (1, 5, 8, 24):
        nb = tc.n_bands_for(kind, 96, bits)
        assert _same(tc.bucket_assign_np(kind, sig, nb, bits),
                     jc.bucket_assign_np(kind, sig, nb, bits))


def test_count_sketch_equals_jax():
    idx, val = sparse_rows(300, 32, 1 << 20, seed=2)
    for e in (1, 2, 4, 8, 64, 1024, 2048, 16384, 65536, 131072):
        assert _same(tc.cs_embed_np(idx, val, e), jc.cs_embed_np(idx, val, e))


@pytest.mark.parametrize("e", [1 << b for b in range(0, 18)])
def test_query_count_sketch_equals_xla(e):
    """The query's embedding (cs_embed_ref) bitwise XLA's scatter at the
    widths K7 takes from 1 (a shift by 32: every feature at coordinate 0)
    to 2^17, with features that share a coordinate and values of wide
    range."""
    rng = np.random.default_rng(e)
    qi = rng.integers(0, 1 << 20, (1, 200)).astype(np.int32)
    qi[0, 100:] = qi[0, :100]             # every coordinate hit twice
    qv = (rng.standard_normal((1, 200))
          * np.exp(3 * rng.standard_normal((1, 200)))).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b: jc._cs_embed_traced(a, b, e))(
        qi, qv))[0]
    assert _same(tc.cs_embed_ref(_t(qi[0]), _t(qv[0]), e).numpy(), want)


def _store_sequence(cls):
    """A note / invalidate / overflow history: a fat bucket of 600 rows
    (band 0, bucket 3) beside small ones forces a cap below its length."""
    rng = np.random.default_rng(7)
    st = cls(2, 64, delta_cap=16)
    snaps = []
    b = rng.integers(0, 64, (2, 1000)).astype(np.int32)
    b[0, :600] = 3
    st.note_rows(np.arange(1000), b)
    snaps.append(st.packed_versioned())
    st.note_rows(np.arange(1000, 1010), rng.integers(0, 64, (2, 10))
                 .astype(np.int32))
    snaps.append(st.packed_versioned())        # served by the delta
    st.invalidate_rows([5, 1003, 999999])
    st.note_rows(np.arange(1010, 1040), rng.integers(0, 64, (2, 30))
                 .astype(np.int32))             # delta overflow: a pack
    snaps.append(st.packed_versioned())
    st.invalidate_rows(np.arange(0, 1030, 1))   # stale past the bound
    snaps.append(st.packed_versioned())
    st.clear()
    st.note_rows(np.arange(3), np.zeros((2, 3), np.int32))
    snaps.append(st.packed_versioned())
    return st, snaps


def test_bucket_store_packs_equal_jax():
    """The port's store holds one plane: its views are the JAX store's
    at one slab, without the leading slab axis."""
    (js, jsnap), (ts, tsnap) = _store_sequence(JStore), _store_sequence(TStore)
    assert len(jsnap) == len(tsnap)
    for a, b in zip(jsnap, tsnap):
        assert len(a) == len(b) == 6
        for x, y in zip(a[:4], b[:4]):
            assert np.asarray(x).shape[0] == 1
            assert _same(np.asarray(x)[0], y)
        assert a[4:] == b[4:]
    first = tsnap[0]
    assert first[4] < 600          # the fat bucket was cut
    assert js.get_status() == ts.get_status()
    assert js.truncated_rows == ts.truncated_rows
    _, snaps = _store_sequence(TStore)
    assert int(snaps[0][2].max()) == snaps[0][4]


def test_tie_aware_recall_equals_jax():
    rng = np.random.default_rng(1)
    for _ in range(20):
        full = [(f"r{i}", float(s)) for i, s in
                enumerate(np.sort(rng.integers(0, 5, 12))[::-1])]
        pruned = [full[i] for i in sorted(rng.choice(12, 8, replace=False))]
        for k in (1, 5, 10):
            assert t_recall(full, pruned, k) == j_recall(full, pruned, k)
    assert t_recall([], [], 3) == j_recall([], [], 3) == 1.0


# ---------------------------------------------------------------------------
# K6's plain version against the JAX programs
# ---------------------------------------------------------------------------

def _sig_case(kind, h, fresh, seed, n=3000):
    sig, norms = clustered_sigs(kind, h, n, seed=seed)
    store, plan, bits = sig_index(kind, h, sig, probes=4, fresh=fresh,
                                  delta_cap=16)
    return sig, norms, store.packed(), plan, bits


def _valid(which, n, seed):
    if which == "mask":
        m = np.random.default_rng(seed).random(n) > 0.2
        return jnp.asarray(m), n, _t(m)
    return np.int32(n - 7), n - 7, None


@pytest.mark.parametrize("kind,h", SIG_CASES)
@pytest.mark.parametrize("valid", ["count", "mask"])
@pytest.mark.parametrize("k,fresh", [(10, 10), (10, 0), (10, 16),
                                     (200, 16)])
def test_sig_probe_ref_equals_jax_from_row(kind, h, valid, k, fresh):
    n = 3000
    sig, norms, csr, plan, bits = _sig_case(kind, h, fresh, seed=h + 1)
    flat, off, ln, dl, cap = csr
    jvalid, n_valid, mask = _valid(valid, n, h)
    kb = tc._kb(k, plan, cap, dl)
    assert kb == jc._kb(k, plan, cap, dl)
    if k == 200:
        assert kb > 1024
    table, tn = _t(sig.view(np.int32)), _t(norms)
    tcsr = [_t(x) for x in (flat, off, ln, dl)]
    for q in np.random.default_rng(5).integers(0, n, 4):
        r, s, c = jc._sig_probe_from_row(
            kind, jnp.asarray(sig), np.int32(q), jnp.asarray(norms), jvalid,
            flat, off, ln, dl, h, kb, plan, bits, cap)
        out = tc.sig_probe_ref(kind, table, tn, n_valid, mask,
                               table[q:q + 1], tn[q:q + 1], *tcsr, cap, plan,
                               bits, h, kb)
        rr, ss, cc = tc.probe_result(out, kb)
        assert _same(rr[0], np.asarray(r).astype(np.int64))
        assert _same(ss[0], np.asarray(s))
        assert int(cc[0]) == int(c)
        # the wrapper's CPU route is the plain version
        assert torch.equal(out, tc.sig_probe(
            kind, table, tn, n_valid, mask, (*tcsr, cap), plan, bits, h, kb,
            q_rows=torch.tensor([int(q)])))


def _keys(method):
    return JNN(config(method)).key, TNN(config(method), device="cpu").key


def _batches(method, datums):
    """(JAX batch, port batch) of the datums, each package's converter."""
    j = JNN(config(method))
    t = TNN(config(method), device="cpu")
    jb = j.converter.convert_batch([JDatum([], d) for d in datums],
                                   update_weights=False)
    tb = t.converter.convert_batch([TDatum([], d) for d in datums],
                                   update_weights=False)
    assert _same(jb.indices, tb.indices) and _same(jb.values, tb.values)
    return jb, tb


@pytest.mark.parametrize("kind", ["lsh", "minhash", "euclid_lsh"])
def test_datum_and_batch_routes_equal_jax(kind):
    """K1/K2 sign a datum read at B 1 and the batch route as a batch of
    round_b, as the JAX programs sign inside _sig_probe_from_datum and
    _sig_probe_batch (XLA's projection order depends on the batch): the
    boundary datum gets other bits by route, and both match."""
    h, n = 64, 2000
    jkey, tkey = _keys(kind)
    jn = JNN(config(kind))
    datums = rows(31, n)
    jb = jn.converter.convert_batch([JDatum([], d) for d in datums],
                                    update_weights=False)
    sig = np.asarray(jax.device_get(__import__(
        "jubatus_tpu.ops.lsh", fromlist=["signature"]).signature(
            jkey, jb.indices, jb.values, h, kind)))
    norms = np.sqrt((jb.values * jb.values).sum(1)).astype(np.float32)
    store, plan, bits = sig_index(kind, h, sig, probes=4, fresh=12)
    csr = store.packed()
    flat, off, ln, dl, cap = csr
    tcsr = (*[_t(x) for x in (flat, off, ln, dl)], cap)
    table, tn = _t(sig.view(np.int32)), _t(norms)
    queries = [BOUNDARY, datums[3], datums[700], BOUNDARY[:5]]
    qb, tb = _batches(kind, queries)
    qn = np.sqrt((qb.values * qb.values).sum(1)).astype(np.float32)
    for size in (3, 10):
        for i in range(len(queries)):
            a = jc.sig_probe_query(kind, jkey, qb.indices[i:i + 1],
                                   qb.values[i:i + 1], jnp.asarray(sig),
                                   float(qn[i]), jnp.asarray(norms), n,
                                   csr, h, size, plan, bits)
            b = tc.sig_probe_query(kind, tkey, tb.indices[i:i + 1],
                                   tb.values[i:i + 1], table, float(qn[i]),
                                   tn, n, None, tcsr, h, size, plan, bits)
            assert _same(a[0], b[0]) and _same(a[1], b[1]) and a[2] == b[2]
        from jubatus_tpu.batching.bucketing import round_b
        pb = qb.pad_to(round_b(len(queries)))
        pn = np.zeros(pb.batch_size, np.float32)
        pn[:len(queries)] = qn
        ja = jc.sig_probe_query_batch(kind, jkey, pb.indices, pb.values,
                                      jnp.asarray(sig), pn,
                                      jnp.asarray(norms), n, csr, h, size,
                                      plan, bits)
        ta = tc.sig_probe_query_batch(kind, tkey, tb.indices, tb.values,
                                      table, qn, tn, n, None, tcsr, h, size,
                                      plan, bits, round_b(len(queries)))
        for i in range(len(queries)):
            assert _same(ja[0][i], ta[0][i]) and _same(ja[1][i], ta[1][i])
            assert int(ja[2][i]) == int(ta[2][i])


def test_boundary_datum_signs_differently_by_route():
    """The premise of the route test above: at B 1 and in a padded batch
    the boundary datum's lsh bits differ."""
    _, tkey = _keys("lsh")
    _, tb = _batches("lsh", [BOUNDARY])
    one = tl.host_signature(tkey, tb.indices, tb.values, 64, "lsh", "cpu")
    many = tl.host_signature(tkey, tb.indices, tb.values, 64, "lsh", "cpu",
                             8)
    assert not _same(one, many)


# ---------------------------------------------------------------------------
# K7's plain version against _ivf_probe_query
# ---------------------------------------------------------------------------

def _ivf_case(metric, probes, seed, n=3000, d=512, embed_dim=64):
    idx, val = sparse_rows(n, 32, d, seed, centers=30)
    ix = JIvf(metric, JSpec(kind="ivf", probes=probes, min_rows=0,
                            embed_dim=embed_dim))
    ix.rebuild_from(np.arange(n), idx, val)
    norms = np.sqrt((val * val).sum(1)).astype(np.float32)
    flat, off, ln, dl, cap = ix.store.packed()
    return idx, val, norms, ix.centroids, (flat[0], off[0], ln[0], dl[0],
                                           cap)


def _colliding_query(rng, d, e=64):
    """A query of 12 features, three of them hashed to one coordinate (as
    many as share column 7's where fewer do)."""
    cols = np.arange(d, dtype=np.uint32)
    h = (cols * np.uint32(0x9E3779B1)) >> np.uint32(32 - int(np.log2(e)))
    same = np.flatnonzero(h == h[7])[:3]
    rest = rng.choice(np.setdiff1d(np.arange(d), same), 12 - len(same),
                      replace=False)
    qi = np.zeros((1, 16), np.int32)
    qv = np.zeros((1, 16), np.float32)
    qi[0, :12] = np.concatenate([same, rest])
    qv[0, :12] = rng.standard_normal(12).astype(np.float32)
    return qi, qv


def _ivf_both(metric, qi, qv, d, cent, idx, val, norms, valid, csr, probes,
              k=10, embed_dim=64):
    flat, off, ln, dl, cap = csr
    qd = np.zeros(d, np.float32)
    qd[qi[0]] += qv[0]
    qn = np.float32(np.sqrt((qd * qd).sum()))
    kb = tc._ivf_kb(k, probes, cap, dl)
    jvalid, n_valid, mask = valid
    r, s, c = jc._ivf_probe_query(metric, qi, qv, qd, qn, cent, idx, val,
                                  norms, jvalid, flat, off, ln, dl, kb,
                                  probes, cap, embed_dim)
    out = tc.ivf_probe_ref(metric, _t(qi[0]), _t(qv[0]), _t(qd), _t(qn),
                           _t(cent), _t(idx), _t(val), _t(norms), n_valid,
                           mask, *[_t(x) for x in (flat, off, ln, dl)], cap,
                           probes, embed_dim, kb)
    rr, ss, cc = tc.probe_result(out, kb)
    assert _same(rr[0], np.asarray(r).astype(np.int64))
    assert _same(ss[0], np.asarray(s))
    assert int(cc[0]) == int(c)
    return out


@pytest.mark.parametrize("metric", ["cosine", "euclid"])
@pytest.mark.parametrize("probes", [1, 2, 4, 8])
def test_ivf_probe_ref_equals_jax(metric, probes):
    n, d = 3000, 512
    idx, val, norms, cent, csr = _ivf_case(metric, probes, seed=probes)
    rng = np.random.default_rng(probes + 10)
    valid = _valid("mask" if probes % 2 else "count", n, probes)
    for _ in range(4):
        qi, qv = _colliding_query(rng, d)
        _ivf_both(metric, qi, qv, d, cent, idx, val, norms, valid, csr,
                  probes)
    # a stored row as the query (its own row scores the extreme)
    qi = np.zeros((1, 32), np.int32)
    qv = np.zeros((1, 32), np.float32)
    qi[0], qv[0] = idx[11], val[11]
    _ivf_both(metric, qi, qv, d, cent, idx, val, norms, valid, csr, probes)


@pytest.mark.parametrize("metric", ["cosine", "euclid"])
@pytest.mark.parametrize("embed_dim", [1 << b for b in range(0, 14)])
def test_ivf_probe_ref_equals_jax_at_every_embed_dim(metric, embed_dim):
    """K7's plain version bitwise _ivf_probe_query at every count-sketch
    width from 1 to 8,192: at 1 one fused multiply-add a centroid, below 8
    the gemv's epilogue chain and the fused squares' sum, from 2,048 up the
    squares' windows windowed again."""
    n, d = 1200, 512
    idx, val, norms, cent, csr = _ivf_case(metric, 4, seed=embed_dim, n=n,
                                           d=d, embed_dim=embed_dim)
    assert cent.shape[1] == embed_dim
    rng = np.random.default_rng(embed_dim + 1)
    valid = _valid("mask" if embed_dim % 3 else "count", n, embed_dim)
    for _ in range(3):
        qi, qv = _colliding_query(rng, d, e=max(embed_dim, 2))
        _ivf_both(metric, qi, qv, d, cent, idx, val, norms, valid, csr, 4,
                  embed_dim=embed_dim)


def _centroid_scores_jax(cent, e_q):
    return np.asarray(jax.jit(
        lambda c, e: c @ e - 0.5 * jnp.sum(c * c, axis=1))(cent, e_q))


@pytest.mark.parametrize("metric", ["cosine", "euclid"])
@pytest.mark.parametrize("gap", ["tie", "ulp"])
def test_ivf_probe_boundary_centroids_equal_jax(metric, gap):
    """Two centroids whose scores tie, or lie one ulp apart, at the probe
    boundary: the top-`probes` pick, and so the candidates, follow XLA's
    exact scores and lax.top_k's lower-index tie."""
    n, d = 3000, 512
    idx, val, norms, cent, csr = _ivf_case(metric, 1, seed=21)
    rng = np.random.default_rng(3)
    qi, qv = _colliding_query(rng, d)
    e_q = np.asarray(jax.jit(lambda a, b: jc._cs_embed_traced(a, b, 64))(
        qi, qv))[0]
    sc = _centroid_scores_jax(cent, e_q)
    top = int(np.argmax(sc))
    other = (top + 5) % len(cent)
    cent = cent.copy()
    cent[other] = cent[top]
    if gap == "ulp":
        # move one coordinate of the copy by a few ulps until its score
        # lands one ulp from the top's, on either side
        tries = np.random.default_rng(4)
        for _ in range(2000):
            trial = cent.copy()
            j = int(tries.integers(0, 64))
            x = trial[other, j]
            for _ in range(int(tries.integers(1, 9))):
                x = np.nextafter(x, np.float32(tries.choice([-1, 1])
                                               * np.inf))
            trial[other, j] = x
            s2 = _centroid_scores_jax(trial, e_q)
            if s2[other] in (np.nextafter(s2[top], np.float32(np.inf)),
                             np.nextafter(s2[top], np.float32(-np.inf))):
                cent = trial
                break
        else:
            pytest.fail("no centroid an ulp from the top found")
    sc = _centroid_scores_jax(cent, e_q)
    assert (sc[other] == sc[top]) == (gap == "tie")
    assert _same(tc.centroid_scores_ref(_t(cent), _t(e_q)).numpy(), sc)
    assert _same(tc.cs_embed_ref(_t(qi[0]), _t(qv[0]), 64).numpy(), e_q)
    for probes in (1, 2):
        _ivf_both(metric, qi, qv, d, cent, idx, val, norms,
                  _valid("count", n, 0), csr, probes)


@pytest.mark.parametrize("c,e", [(1024, 64), (37, 64), (5, 64), (64, 32),
                                 (16, 8), (16, 16), (8, 512), (37, 2),
                                 (1024, 2), (5, 4), (64, 4), (37, 2048),
                                 (5, 4096), (16, 8192), (13, 16384),
                                 (8, 32768), (3, 65536), (5, 8), (13, 8),
                                 (37, 8), (1024, 8), (20, 8), (68, 8),
                                 (2, 1), (37, 1), (1024, 1), (3, 131072),
                                 (2, 1 << 20)])
def test_centroid_scores_equal_xla(c, e):
    """At E 8 a configured centroid count leaves some rows to the
    squares' scalar loop (5, 13, 37: ssq_vector_rows); E 1 is one fused
    multiply-add; E 2^17 and 2^20 window the squares' sums three levels
    deep."""
    rng = np.random.default_rng(c * e)
    cent = rng.standard_normal((c, e)).astype(np.float32)
    e_q = rng.standard_normal(e).astype(np.float32)
    assert _same(tc.centroid_scores_ref(_t(cent), _t(e_q)).numpy(),
                 _centroid_scores_jax(cent, e_q))
